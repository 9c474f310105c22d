// What tgmm.cu, the last grouped kernel on the mma.sync main loop, shares
// with the grouped kernels' conventions: the 128-row tile (ALIGN) and where
// an mma.sync m16n8k16 accumulator lands in a 256-thread block of 8 warps
// as 2 (rows) x 4 (columns), warp w owning rows 64 * (w / 4) .. +63 and
// columns (BN / 4) * (w % 4) .. of the block tile. gmm.cu and
// swiglu_gmm.cu run on grouped_sm90.cuh.

#pragma once

#include "flash_common.cuh"

namespace gmm {

constexpr int kBM = 128;  // rows of a block tile: ALIGN

// Global row and column of accumulator element e (0..3) of n8 tile ni in
// m16 tile mi; e and e + 1 (e even) are neighbouring columns of one row.
__device__ __forceinline__ int acc_row(int m0, int mi, int e) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  return m0 + (warp >> 2) * 64 + mi * 16 + (lane >> 2) + (e >= 2 ? 8 : 0);
}

template <int BN>
__device__ __forceinline__ int acc_col(int n0, int ni) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  return n0 + (warp & 3) * (BN / 4) + ni * 8 + 2 * (lane & 3);
}

}  // namespace gmm
