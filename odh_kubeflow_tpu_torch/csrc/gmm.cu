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
// exactly one expert. gmm_kernel is grouped_sm90.cuh's persistent,
// warp-specialised product (TMA ring, int8 widened in shared memory,
// wgmma, setmaxnreg) with a 128 x BW output tile, BW 256 or 128 by the
// shape (tile_width), and an epilogue that scales (int8, non-trans) and
// stores bf16 pairs from registers. Every tile of every row is written, the
// tail past the last real group with expert E-1's weights (the caller
// scales it by w = 0: 0 * finite). Empty groups own no tile. With an int8
// bank and TRANS the scale multiplies the lhs: a first pass writes
// bf16(lhs * bf16(scale[e])) once per row (the rounding of the TPU
// kernels) into a buffer the caller provides, which the product then reads;
// done inside the product it would be redone by every column block.

#include "grouped_sm90.cuh"

namespace {

using grouped::bf16;

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
  const int e = grouped::tile_expert(offsets, E, r - r % grouped::kBM);
  int4 raw = *reinterpret_cast<const int4*>(lhs + i);
  __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);
  const float4* sp = reinterpret_cast<const float4*>(scale + static_cast<long long>(e) * K + k);
  const float4 s4[2] = {__ldg(sp), __ldg(sp + 1)};
  const float* s = reinterpret_cast<const float*>(s4);
#pragma unroll
  for (int x = 0; x < 4; ++x) v[x] = __hmul2(v[x], __floats2bfloat162_rn(s[2 * x], s[2 * x + 1]));
  *reinterpret_cast<int4*>(scaled + i) = raw;
}

// gmm_kernel's epilogue: out = acc (* scale[e, col], int8 non-trans) in
// bf16, 16 bytes a store (quad_transpose), columns past N not stored.
// Consumer thread t fetches the scale of the tile's column t (load) as
// the tile starts.
template <int BN, bool SCALED>
struct GmmEpi {
  bf16* out;
  const float* scale;

  __device__ __forceinline__ float load(int t, int n0, int e, int N) const {
    if (!SCALED || t >= BN || n0 + t >= N) return 1.f;
    return __ldg(scale + static_cast<long long>(e) * N + n0 + t);
  }

  __device__ __forceinline__ void operator()(const float (&acc)[BN / 2], int m0, int n0, int e,
                                             int N, float v, float* cols) const {
    const grouped::Frag f = grouped::frag();
    if (SCALED) grouped::share_cols(cols, v);
    bf16* rows = out + static_cast<long long>(m0 + f.row0) * N;
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += 4) {
      uint32_t w[2][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + jj;
        const float2 sc = SCALED ? *reinterpret_cast<const float2*>(cols + 8 * j + 2 * f.quad)
                                 : make_float2(1.f, 1.f);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          w[r][jj] = sm90::pack_bf16(acc[4 * j + 2 * r] * sc.x, acc[4 * j + 2 * r + 1] * sc.y);
        }
      }
      const int col = n0 + 8 * (j0 + f.quad);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint4 v4 = grouped::quad_transpose(w[r]);
        if (col < N) *reinterpret_cast<uint4*>(rows + static_cast<long long>(8 * r) * N + col) = v4;
      }
    }
  }
};

// W = int8_t: scale [E, 1, N] multiplies the accumulator (non-trans; with
// TRANS the lhs was prescaled). W = bf16: no scale. BW: the output tile's
// width, 256 or 128 (tile_width).
template <int BW, bool TRANS, typename W>
__global__ void __launch_bounds__(grouped::kThreads, 1)
    gmm_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
               const GmmEpi<BW, sizeof(W) == 1 && !TRANS> epi, const int* __restrict__ offsets,
               grouped::Sched sched, int K, int N, int E) {
  const grouped::BankOps<BW, TRANS, W, 1> ops{&tx, &tb, &tb, offsets, sched, K, N, E};
  grouped::persistent_product(ops, epi);
}

template <int BW, bool TRANS, typename W>
int launch_width(const bf16* lhs, const W* q, const float* scale, const int* offsets, bf16* out,
                 int M, int K, int N, int E, cudaStream_t stream) {
  constexpr int kSmem = grouped::BankOps<BW, TRANS, W, 1>::C::kSmem;
  static int attr = sm90::set_smem(gmm_kernel<BW, TRANS, W>, kSmem);
  if (attr != 0) return attr;
  CUtensorMap tx, tb;
  if (int rc = grouped::rows_map(&tx, lhs, M, K)) return rc;
  if (int rc = grouped::bank_map<BW, BW, TRANS, W>(&tb, q, K, N, E)) return rc;
  const GmmEpi<BW, sizeof(W) == 1 && !TRANS> epi{out, scale};
  const grouped::Sched sched = grouped::schedule(M, N, BW);
  gmm_kernel<BW, TRANS, W><<<grouped::launch_grid(sched), grouped::kThreads, kSmem, stream>>>(
      tx, tb, epi, offsets, sched, K, N, E);
  return static_cast<int>(cudaGetLastError());
}

template <bool TRANS, typename W>
int launch_gemm(const bf16* lhs, const W* q, const float* scale, const int* offsets, bf16* out,
                int M, int K, int N, int E, cudaStream_t stream) {
  return grouped::tile_width(M, N, grouped::sm_count()) == 256
             ? launch_width<256, TRANS, W>(lhs, q, scale, offsets, out, M, K, N, E, stream)
             : launch_width<128, TRANS, W>(lhs, q, scale, offsets, out, M, K, N, E, stream);
}

int launch_prescale(const bf16* lhs, const float* scale, const int* offsets, bf16* scaled, int M,
                    int K, int E, cudaStream_t stream) {
  const long long vecs = static_cast<long long>(M) * K / 8;
  prescale_kernel<<<static_cast<unsigned>((vecs + 255) / 256), 256, 0, stream>>>(
      lhs, scale, offsets, scaled, M, K, E);
  return static_cast<int>(cudaGetLastError());
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
  if (int rc = grouped::check_shape(M, K, N, E)) return rc;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const bf16*>(lhs);
  const auto* w = static_cast<const int8_t*>(q);
  const auto* s = static_cast<const float*>(scale);
  const auto* o = static_cast<const int*>(offsets);
  auto* y = static_cast<bf16*>(out);
  if (!trans) return launch_gemm<false>(l, w, s, o, y, M, K, N, E, st);
  auto* p = static_cast<bf16*>(scaled);
  if (p == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (int rc = launch_prescale(l, s, o, p, M, K, E, st)) return rc;
  return launch_gemm<true>(p, w, s, o, y, M, K, N, E, st);
}

// bf16 bank w, [E, K, N], or [E, N, K] with trans; no scale.
extern "C" int gmm_bf16_launch(const void* lhs, const void* w, const void* offsets, void* out,
                               int M, int K, int N, int E, int trans, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (int rc = grouped::check_shape(M, K, N, E)) return rc;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const bf16*>(lhs);
  const auto* b = static_cast<const bf16*>(w);
  const auto* o = static_cast<const int*>(offsets);
  auto* y = static_cast<bf16*>(out);
  return trans ? launch_gemm<true>(l, b, nullptr, o, y, M, K, N, E, st)
               : launch_gemm<false>(l, b, nullptr, o, y, M, K, N, E, st);
}

// The schedule gmm_launch takes, for its Python mirror's test on the card:
// the output tile width of an [M, N] result on `sms` SMs, and the
// persistent tile order, (row tile, column tile) of tile t at out[2t..].
extern "C" int gmm_tile_width(int M, int N, int sms) { return grouped::tile_width(M, N, sms); }

extern "C" void gmm_tile_order(int m_tiles, int n_tiles, int* out) {
  const grouped::Sched sched{m_tiles, n_tiles};
  for (int t = 0; t < sched.count(); ++t) sched.coords(t, out[2 * t], out[2 * t + 1]);
}

// The first pass of an int8 trans launch alone, for its own time: scaled =
// bf16(lhs * bf16(scale[e])), [M, K].
extern "C" int gmm_prescale_launch(const void* lhs, const void* scale, const void* offsets,
                                   void* scaled, int M, int K, int E, void* stream) {
  if (M <= 0) return 0;
  if (int rc = grouped::check_shape(M, K, 16, E)) return rc;
  return launch_prescale(static_cast<const bf16*>(lhs), static_cast<const float*>(scale),
                         static_cast<const int*>(offsets), static_cast<bf16*>(scaled), M, K, E,
                         static_cast<cudaStream_t>(stream));
}
