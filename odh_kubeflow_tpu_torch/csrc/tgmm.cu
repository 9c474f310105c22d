// Per-expert weight gradient of the grouped matmul for Hopper (sm_90a).
//
// Replaces _tgmm_kernel of odh_kubeflow_tpu/ops/pallas_grouped_matmul.py
// (pallas_call in _tgmm): for every expert e,
//
//   out[e] = lhs[rows_e]^T @ dout[rows_e]      rows_e = [offsets[e], offsets[e+1])
//
// lhs bf16 [M, K], dout bf16 [M, N], out bf16 [E, K, N], f32 sums, zeros for
// an expert that owns no row. offsets as in gmm.cu: int32 [E + 1],
// offsets[0] = 0, offsets[E] = M, every entry a multiple of 128, so the
// tail past the last real group belongs to expert E-1, as in the TPU
// kernel's mask rows < offsets[e+1].
//
// Bound: tensor-core operations. At the Mixtral-8x1B training shape (M
// 17,408 sorted rows, K 2048 / N 8192 or K 8192 / N 2048, E 8) one launch
// is 2 M K N = 5.84e11 flops, 0.59 ms at 989 TFLOP/s bf16 dense, against
// 0.62 GB moved (0.19 ms at 3.35 TB/s).
//
// Design. The TPU kernel walked 512-row tiles x groups as "span pairs" in
// grid order, masking rows of other groups, carrying an f32 scratch across
// grid steps, with a singleton pair for an empty group and inert pads. Here
// blocks run in no order, so a block owns one 128 x 128 tile of one
// expert's [K, N] (grid K/128 x N/128 x E) and carries the sum over that
// expert's rows itself: it walks [offsets[e], offsets[e+1]) in 64-row
// chunks through a 3-stage cp.async ring, both operands stored row-major
// as they lie in memory ([rows, K] and [rows, N]). The rows are the
// contraction: lhs^T is the A operand, read from the [rows, K] stage by
// ldmatrix.trans; dout is the B operand, read as gmm reads a [K, N] bank.
// Group starts are 128-aligned, so a chunk never straddles two experts and
// no row is masked. An empty group's blocks write zeros. No atomics: every
// output element is written once, by one block. With a skewed routing most
// blocks find an empty group and the few of the busy expert walk all M rows.

#include "gmm_common.cuh"

namespace {

using flash::bf16;

constexpr int kBT = 128;          // output tile: 128 of K by 128 of N
constexpr int kRows = 64;         // rows (the contraction) per chunk
constexpr int kLD = kBT + 8;      // padded pitch, bf16 elements
constexpr int kThreads = 256;     // 8 warps as 2 (K) x 4 (N), 64 x 32 each
constexpr int kStages = 3;
constexpr int kTile = kRows * kLD;                 // bf16 elements of one operand
constexpr int kSmem = kStages * 2 * kTile * 2;     // bytes
constexpr int kNT = 4;                              // n8 tiles a warp

// A fragment of rows m0..m0+15, columns k0..k0+15 of A = S^T, from a tile S
// stored [k][m] (row-major in the contraction), by transposing loads
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4], const bf16* s, int m0, int k0) {
  const int l = threadIdx.x & 31;
  flash::ldsm_x4_t(a, s + (k0 + (l & 7) + (l >> 4) * 8) * kLD + m0 + ((l >> 3) & 1) * 8);
}

// 64 rows x 128 columns of a row-major [M, C] operand, from column c0;
// columns at or past C are zeros
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0, int c0, int C) {
#pragma unroll
  for (int i = threadIdx.x; i < kRows * (kBT / 8); i += kThreads) {
    const int r = i / (kBT / 8);
    const int c = (i % (kBT / 8)) * 8;
    const bool valid = c0 + c < C;
    const bf16* p = src + static_cast<long long>(r0 + r) * C + (valid ? c0 + c : 0);
    flash::cp_async16(dst + r * kLD + c, p, valid);
  }
}

__global__ void __launch_bounds__(kThreads)
    tgmm_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ dout,
                const int* __restrict__ offsets, bf16* __restrict__ out, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sm = reinterpret_cast<bf16*>(smem);
  const int k0 = blockIdx.x * kBT;
  const int n0 = blockIdx.y * kBT;
  const int e = blockIdx.z;
  const int start = __ldg(offsets + e);
  const int end = __ldg(offsets + e + 1);
  const int nc = end > start ? (end - start) / kRows : 0;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;

  auto stage_l = [&](int s) { return sm + s * 2 * kTile; };
  auto stage_d = [&](int s) { return sm + s * 2 * kTile + kTile; };
  auto load = [&](int s, int chunk) {
    const int r0 = start + chunk * kRows;
    load_rows(stage_l(s), lhs, r0, k0, K);
    load_rows(stage_d(s), dout, r0, n0, N);
  };

  float acc[4][kNT][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] =
        acc[mi][ni][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nc) load(s, s);
    flash::cp_async_commit();
  }
  for (int c = 0; c < nc; ++c) {
    flash::cp_async_wait<kStages - 2>();  // chunk c has landed
    __syncthreads();                      // and chunk c - 1 is consumed
    const int next = c + kStages - 1;
    if (next < nc) load(next % kStages, next);
    flash::cp_async_commit();
    const bf16* sl = stage_l(c % kStages);
    const bf16* sd = stage_d(c % kStages);
#pragma unroll
    for (int kk = 0; kk < kRows; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) frag_a_t(a[mi], sl, wm + mi * 16, kk);
#pragma unroll
      for (int nj = 0; nj < kNT / 2; ++nj) {
        uint32_t b[4];
        flash::frag_b_kn<kLD>(b, sd, kk, wn + nj * 16);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          flash::mma(acc[mi][2 * nj], a[mi], b[0], b[1]);
          flash::mma(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  flash::cp_async_wait<0>();

  bf16* o = out + static_cast<long long>(e) * K * N;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      const int col = gmm::acc_col<kBT>(n0, ni);
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = gmm::acc_row(k0, mi, 2 * h);
        if (row < K) {
          flash::store2(o + static_cast<long long>(row) * N + col, acc[mi][ni][2 * h],
                        acc[mi][ni][2 * h + 1]);
        }
      }
    }
  }
}

}  // namespace

// Returns a CUDA error code (0 on success). The caller has checked dtypes,
// shapes (M % 128, K % 16, N % 16), contiguity, one device and 16-byte
// aligned bases.
extern "C" int tgmm_launch(const void* lhs, const void* dout, const void* offsets, void* out,
                           int M, int K, int N, int E, void* stream) {
  if (K <= 0 || N <= 0 || E <= 0) return 0;
  if (M < 0 || M % gmm::kBM || K % 16 || N % 16 || E > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int attr = flash::set_smem(tgmm_kernel, kSmem);
  if (attr != 0) return attr;
  const dim3 grid(flash::ceil_div(K, kBT), flash::ceil_div(N, kBT), E);
  tgmm_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(lhs), static_cast<const bf16*>(dout),
      static_cast<const int*>(offsets), static_cast<bf16*>(out), K, N);
  return static_cast<int>(cudaGetLastError());
}
