// Shared main loop of the grouped-matmul kernels (gmm.cu, swiglu_gmm.cu):
// bf16 rows times an expert bank, int8 or bf16, mma.sync m16n8k16 with f32
// accumulators, one 128-row tile of one expert per block.
//
// Contract (checked by the Python wrappers, ops/grouped_matmul.py):
//   lhs     bf16 [M, K] row-major, M % 128 == 0, K % 16 == 0;
//   bank    W = int8_t or bf16, [E, K, N] (TRANS = false) or [E, N, K]
//           (TRANS = true), N % 16 == 0;
//   offsets int32 [E + 1], offsets[0] = 0, offsets[E] = M, every entry a
//           multiple of 128, nondecreasing. So each 128-row tile lies in
//           exactly one expert's group (empty groups own no tile), and the
//           block finds that expert itself: _group_of_tile's search.
//
// Block: 256 threads, 8 warps as 2 (rows) x 4 (columns); warp w owns rows
// 64 * (w / 4) .. +63 and columns (BN / 4) * (w % 4) .. of the block tile.
// K runs in chunks of 64 through a 3-stage cp.async ring of the lhs and
// bank tiles. An int8 bank tile arrives as raw bytes (16 weights a copy)
// and is widened to bf16 in shared memory (exact: |q| <= 127) once per
// chunk; a bf16 bank tile is copied straight into its padded stage (8
// weights a copy) and read there, with no widening pass. Either way the
// tensor cores read bf16 by ldmatrix.

#pragma once

#include "flash_common.cuh"

namespace gmm {

using flash::bf16;

constexpr int kBM = 128;      // rows of a block tile: ALIGN
constexpr int kBK = 64;       // contraction chunk
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kPad = 8;        // bf16 elements of row padding (16 bytes)
constexpr int kLDA = kBK + kPad;

// expert of the 128-row tile starting at row m0: the number of group ends
// offsets[1..E-1] at or before m0 (searchsorted, side "right")
__device__ __forceinline__ int tile_expert(const int* offsets, int E, int m0) {
  int e = 0;
  for (int i = 1; i < E; ++i) e += __ldg(offsets + i) <= m0 ? 1 : 0;
  return e;
}

// W: the bank's element type, int8_t (widened in shared memory) or bf16
template <int BN, bool TRANS, typename W>
struct Tiles {
  static constexpr bool kWiden = sizeof(W) == 1;
  static constexpr int kLDB = TRANS ? kBK + kPad : BN + kPad;      // bf16 pitch
  static constexpr int kRowsB = TRANS ? BN : kBK;
  static constexpr int kConvB = kRowsB * kLDB;                     // bf16 elements
  // bytes of one bank tile in a stage: raw int8, or the padded bf16 tile
  static constexpr int kStageB = kWiden ? kBK * BN : kConvB * 2;
  static constexpr int kWN = BN / 4;                               // warp columns
  static constexpr int kNT = kWN / 8;                              // n8 tiles a warp
  static_assert(kNT % 2 == 0, "a warp takes its columns 16 at a time");
};

// Dynamic shared memory of a kernel with NB bank operands.
template <int BN, int NB, bool TRANS, typename W>
constexpr int smem_bytes() {
  using T = Tiles<BN, TRANS, W>;
  return kStages * (kBM * kLDA * 2 + NB * T::kStageB) + (T::kWiden ? NB * T::kConvB * 2 : 0);
}

template <typename W>
struct Operand {
  const W* q;      // this expert's [K, N] or [N, K] matrix
};

// Start the cp.async copies of chunk k0 into one stage.
template <int BN, int NB, bool TRANS, typename W>
__device__ __forceinline__ void load_chunk(bf16* sA, unsigned char* sB, const bf16* lhs,
                                           const Operand<W> (&b)[NB], int m0, int n0, int k0,
                                           int K, int N) {
  using T = Tiles<BN, TRANS, W>;
  // lhs: 128 rows x 64 columns, 8 bf16 (16 bytes) per copy
#pragma unroll
  for (int i = threadIdx.x; i < kBM * (kBK / 8); i += kThreads) {
    const int r = i / (kBK / 8);
    const int c = (i % (kBK / 8)) * 8;
    const bool valid = k0 + c < K;
    const bf16* src = lhs + static_cast<long long>(m0 + r) * K + (valid ? k0 + c : 0);
    flash::cp_async16(sA + r * kLDA + c, src, valid);
  }
  // bank: 16 bytes per copy (16 int8 or 8 bf16 weights)
  constexpr int kPer = 16 / sizeof(W);
  constexpr int kCols = TRANS ? kBK : BN;  // weights per tile row
  // an int8 tile lands unpadded, a bf16 tile at its padded pitch
  constexpr int kPitch = T::kWiden ? kCols : T::kLDB;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    W* dst = reinterpret_cast<W*>(sB + j * T::kStageB);
#pragma unroll
    for (int i = threadIdx.x; i < T::kRowsB * (kCols / kPer); i += kThreads) {
      const int r = i / (kCols / kPer);
      const int c = (i % (kCols / kPer)) * kPer;
      // TRANS: rows n, 64 weights of k each; else rows k, BN weights of n
      const int row = (TRANS ? n0 : k0) + r, col = (TRANS ? k0 : n0) + c;
      const bool valid = TRANS ? (row < N && col < K) : (row < K && col < N);
      const long long ld = TRANS ? K : N;
      const W* src = b[j].q + (valid ? static_cast<long long>(row) * ld + col : 0);
      flash::cp_async16(dst + r * kPitch + c, src, valid);
    }
  }
}

// Widen one stage's int8 bank tiles to bf16, same layout, padded pitch.
template <int BN, int NB, bool TRANS>
__device__ __forceinline__ void widen(bf16* sBc, const unsigned char* sB) {
  using T = Tiles<BN, TRANS, int8_t>;
  constexpr int kCols = TRANS ? kBK : BN;  // bytes per raw row
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int i = threadIdx.x; i < T::kStageB / 16; i += kThreads) {
      const int r = (i * 16) / kCols;
      const int c = (i * 16) % kCols;
      const int4 raw = *reinterpret_cast<const int4*>(sB + j * T::kStageB + r * kCols + c);
      const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
      uint32_t w[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        w[x] = flash::pack_bf16(static_cast<float>(v[2 * x]), static_cast<float>(v[2 * x + 1]));
      }
      bf16* dst = sBc + j * T::kConvB + r * T::kLDB + c;
      *reinterpret_cast<int4*>(dst) = make_int4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<int4*>(dst + 8) = make_int4(w[4], w[5], w[6], w[7]);
    }
  }
}

// acc[j][mi][ni][4] += lhs[m0.., :] @ bank_j[:, n0..] over the whole K.
// sm: the kernel's dynamic shared memory.
template <int BN, int NB, bool TRANS, typename W>
__device__ __forceinline__ void mainloop(float (&acc)[NB][4][Tiles<BN, TRANS, W>::kNT][4],
                                         unsigned char* sm, const bf16* lhs,
                                         const Operand<W> (&b)[NB], int m0, int n0, int K,
                                         int N) {
  using T = Tiles<BN, TRANS, W>;
  constexpr int kStageBytes = kBM * kLDA * 2 + NB * T::kStageB;
  bf16* sBc = reinterpret_cast<bf16*>(sm + kStages * kStageBytes);  // int8 only
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * T::kWN;

#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::kNT; ++ni) acc[j][mi][ni][0] = acc[j][mi][ni][1] =
          acc[j][mi][ni][2] = acc[j][mi][ni][3] = 0.f;

  auto stage_a = [&](int s) { return reinterpret_cast<bf16*>(sm + s * kStageBytes); };
  auto stage_b = [&](int s) { return sm + s * kStageBytes + kBM * kLDA * 2; };

  const int nk = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) {
      load_chunk<BN, NB, TRANS, W>(stage_a(s), stage_b(s), lhs, b, m0, n0, s * kBK, K, N);
    }
    flash::cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    flash::cp_async_wait<kStages - 2>();  // chunk kc has landed
    __syncthreads();                      // and chunk kc - 1 is consumed
    const int next = kc + kStages - 1;
    if (next < nk) {
      load_chunk<BN, NB, TRANS, W>(stage_a(next % kStages), stage_b(next % kStages), lhs, b,
                                   m0, n0, next * kBK, K, N);
    }
    flash::cp_async_commit();
    bf16* sA = stage_a(kc % kStages);
    const bf16* tiles;
    if constexpr (T::kWiden) {
      widen<BN, NB, TRANS>(sBc, stage_b(kc % kStages));
      __syncthreads();
      tiles = sBc;
    } else {
      tiles = reinterpret_cast<const bf16*>(stage_b(kc % kStages));
    }

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) flash::frag_a<kLDA>(a[mi], sA, wm + mi * 16, kk);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const bf16* tile = tiles + j * T::kConvB;
#pragma unroll
        for (int nj = 0; nj < T::kNT / 2; ++nj) {
          uint32_t bf[4];
          if (TRANS) {
            flash::frag_b_nk<T::kLDB>(bf, tile, wn + nj * 16, kk);
          } else {
            flash::frag_b_kn<T::kLDB>(bf, tile, kk, wn + nj * 16);
          }
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            flash::mma(acc[j][mi][2 * nj], a[mi], bf[0], bf[1]);
            flash::mma(acc[j][mi][2 * nj + 1], a[mi], bf[2], bf[3]);
          }
        }
      }
    }
  }
  flash::cp_async_wait<0>();
}

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
