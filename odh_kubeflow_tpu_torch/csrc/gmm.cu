// Grouped matmul over an expert bank for Hopper (sm_90a), bf16 rows; the
// bank int8 with a per-channel scale, or bf16.
//
// Replaces three kernels of odh_kubeflow_tpu/ops/pallas_grouped_matmul.py
// with one: _gmm_a_kernel (bf16 bank) and _gmm_a_kernel_q (int8 bank), both
// pallas_call in _gmm_a (K <= MAX_K_A, one 128-row tile per grid step, the
// expert's weight block resident), and _gmm_b_kernel, scaled or not
// (pallas_call in _gmm_b; K split into a grid axis, 512-row tiles walking
// tile x group "span pairs" with masked rows, an f32 scratch carried across
// grid steps, inert pad pairs and a dummy output row block). The TPU needed
// kernel A and kernel B only because a large K does not fit VMEM beside
// the weight block; here K always runs in 64-wide chunks through shared
// memory, so one kernel takes every K. Same function:
//
//   rows [offsets[e], offsets[e+1]) of lhs [M, K] go through expert e:
//   out[r] = lhs[r] @ w[e]                   (bf16 bank, w [E, K, N], or
//                                             [E, N, K] read transposed)
//   out[r] = lhs[r] @ q[e] * scale[e]        (int8, TRANS = false, q [E, K,
//                                             N], scale [E, 1, N]: on the
//                                             f32 accumulator, one rounding)
//   out[r] = bf16(lhs[r] * bf16(scale[e])) @ q[e]^T
//                                            (int8, TRANS = true, q [E, N,
//                                             K], scale [E, 1, K]: the
//                                             scaled axis is the contraction)
//   in bf16, f32 accumulation.
//
// Bound: tensor-core operations. At the Mixtral-8x1B training shape
// (M 17,408 sorted rows, K 8192 / N 2048 or K 2048 / N 8192) one launch is
// 2 M K N = 5.84e11 flops, 0.59 ms at the H100 SXM's 989 TFLOP/s bf16 dense,
// against 0.49 GB moved with an int8 bank, 0.76 GB with a bf16 one (0.15 and
// 0.23 ms at 3.35 TB/s). At the serving prefill (M 3,072) a bf16 product is
// 1.03e11 flops (0.104 ms) against 0.33 GB (0.099 ms): nearly balanced.
//
// Design. The TPU's span pairs, masks, pad pairs and dummy row exist because
// its grid runs in order on one core with a large VMEM. Here every group
// start is 128-aligned and offsets[E] = M, so each 128-row tile belongs to
// exactly one expert: a block takes one 128 x 128 output tile, finds its
// expert from offsets, and loops over the whole K inside the block (the
// in-block loop replaces kernel B's K grid axis). Every tile of every row is
// written, the tail past the last real group with expert E-1's weights (the
// caller scales it by w = 0: 0 * finite). Empty groups own no tile. The int8
// bank is read at one byte a weight and widened in shared memory; a bf16
// bank goes straight from its cp.async stage to ldmatrix; nothing is
// dequantized in device memory. With an int8 bank and TRANS the scale
// multiplies the lhs: a first pass writes bf16(lhs * bf16(scale[e])) once
// per row (the rounding of the TPU kernels) into a buffer the caller
// provides, which the GEMM then reads; done inside the GEMM it was redone by
// every column block and cost 1.5x the product's time (PERF.md). wgmma, TMA
// and a persistent grid are left to later work.

#include "gmm_common.cuh"

namespace {

using gmm::bf16;

constexpr int kBN = 128;

// scaled[r, k] = bf16(lhs[r, k] * bf16(scale[e(r), k])), 8 values a thread.
// The product of two bf16 values is exact in f32, so the bf16x2 multiply's
// one round-to-nearest-even gives the bits of JAX's lhs *
// scale.astype(lhs.dtype). Rows take their 128-row tile's expert.
__global__ void __launch_bounds__(256)
    prescale_kernel(const bf16* __restrict__ lhs, const float* __restrict__ scale,
                    const int* __restrict__ offsets, bf16* __restrict__ scaled, int M, int K,
                    int E) {
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 8;
  if (i >= static_cast<long long>(M) * K) return;
  const int r = static_cast<int>(i / K);
  const int k = static_cast<int>(i % K);
  const int e = gmm::tile_expert(offsets, E, r - r % gmm::kBM);
  int4 raw = *reinterpret_cast<const int4*>(lhs + i);
  __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);
  const float4* sp = reinterpret_cast<const float4*>(scale + static_cast<long long>(e) * K + k);
  const float4 s4[2] = {__ldg(sp), __ldg(sp + 1)};
  const float* s = reinterpret_cast<const float*>(s4);
#pragma unroll
  for (int x = 0; x < 4; ++x) v[x] = __hmul2(v[x], __floats2bfloat162_rn(s[2 * x], s[2 * x + 1]));
  *reinterpret_cast<int4*>(scaled + i) = raw;
}

// W = int8_t: scale [E, 1, N] multiplies the accumulator (non-trans; with
// TRANS the lhs was prescaled). W = bf16: no scale.
template <bool TRANS, typename W>
__global__ void __launch_bounds__(gmm::kThreads)
    gmm_kernel(const bf16* __restrict__ lhs, const W* __restrict__ q,
               const float* __restrict__ scale, const int* __restrict__ offsets,
               bf16* __restrict__ out, int K, int N, int E) {
  using T = gmm::Tiles<kBN, TRANS, W>;
  constexpr bool kScaled = sizeof(W) == 1 && !TRANS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * gmm::kBM;
  const int e = gmm::tile_expert(offsets, E, m0);
  const long long bank = static_cast<long long>(K) * N;
  const float* s = kScaled ? scale + static_cast<long long>(e) * N : nullptr;
  const gmm::Operand<W> b[1] = {{q + e * bank}};

  float acc[1][4][T::kNT][4];
  gmm::mainloop<kBN, 1, TRANS, W>(acc, smem, lhs, b, m0, n0, K, N);

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < T::kNT; ++ni) {
      const int col = gmm::acc_col<kBN>(n0, ni);
      if (col >= N) continue;
      const float s0 = kScaled ? __ldg(s + col) : 1.f;
      const float s1 = kScaled ? __ldg(s + col + 1) : 1.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = gmm::acc_row(m0, mi, 2 * h);
        flash::store2(out + static_cast<long long>(row) * N + col,
                      acc[0][mi][ni][2 * h] * s0, acc[0][mi][ni][2 * h + 1] * s1);
      }
    }
  }
}

template <bool TRANS, typename W>
int launch_gemm(const bf16* lhs, const W* q, const float* scale, const int* offsets, bf16* out,
                int M, int K, int N, int E, cudaStream_t stream) {
  constexpr int kSmem = gmm::smem_bytes<kBN, 1, TRANS, W>();
  static int attr = flash::set_smem(gmm_kernel<TRANS, W>, kSmem);
  if (attr != 0) return attr;
  const dim3 grid(flash::ceil_div(N, kBN), M / gmm::kBM);
  gmm_kernel<TRANS, W><<<grid, gmm::kThreads, kSmem, stream>>>(lhs, q, scale, offsets, out, K,
                                                               N, E);
  return static_cast<int>(cudaGetLastError());
}

int check(int M, int K, int N, int E) {
  if (E <= 0 || K <= 0 || M % gmm::kBM || K % 16 || N % 16 || M / gmm::kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// Both return a CUDA error code (0 on success). The caller has checked
// dtypes, shapes (M % 128, K % 16, N % 16), contiguity, one device and
// 16-byte aligned bases.

// int8 bank q with its f32 scale; with trans, scaled is a bf16 [M, K]
// buffer for the prescaled lhs.
extern "C" int gmm_launch(const void* lhs, const void* q, const void* scale, const void* offsets,
                          void* out, void* scaled, int M, int K, int N, int E, int trans,
                          void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (int rc = check(M, K, N, E)) return rc;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const bf16*>(lhs);
  const auto* w = static_cast<const int8_t*>(q);
  const auto* s = static_cast<const float*>(scale);
  const auto* o = static_cast<const int*>(offsets);
  auto* y = static_cast<bf16*>(out);
  if (!trans) return launch_gemm<false>(l, w, s, o, y, M, K, N, E, st);
  auto* p = static_cast<bf16*>(scaled);
  if (p == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long vecs = static_cast<long long>(M) * K / 8;
  prescale_kernel<<<static_cast<unsigned>((vecs + 255) / 256), 256, 0, st>>>(l, s, o, p, M, K, E);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  return launch_gemm<true>(p, w, s, o, y, M, K, N, E, st);
}

// bf16 bank w, [E, K, N], or [E, N, K] with trans; no scale.
extern "C" int gmm_bf16_launch(const void* lhs, const void* w, const void* offsets, void* out,
                               int M, int K, int N, int E, int trans, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (int rc = check(M, K, N, E)) return rc;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const bf16*>(lhs);
  const auto* b = static_cast<const bf16*>(w);
  const auto* o = static_cast<const int*>(offsets);
  auto* y = static_cast<bf16*>(out);
  return trans ? launch_gemm<true>(l, b, nullptr, o, y, M, K, N, E, st)
               : launch_gemm<false>(l, b, nullptr, o, y, M, K, N, E, st);
}
