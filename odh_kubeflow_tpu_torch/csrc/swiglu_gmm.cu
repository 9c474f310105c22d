// Fused grouped SwiGLU over int8 expert banks for Hopper (sm_90a).
//
// Replaces two kernels of odh_kubeflow_tpu/ops/pallas_grouped_matmul.py:
//
// _swiglu_fwd_kernel (pallas_call in _swiglu_fwd_impl): for rows r of expert
//   e's group, g = (x[r] @ Wg[e]) * sg[e] and u = (x[r] @ Wu[e]) * su[e] in
//   f32, h = silu(g) * u; writes h and g in bf16 (u never reaches memory).
// _swiglu_bwd_kernel (pallas_call in _swiglu_bwd_impl): recomputes
//   u = (x[r] @ Wu[e]) * su[e]; with g and dh read back,
//   dg = dh * u * sig(g) * (1 + g * (1 - sig(g))) and du = dh * g * sig(g),
//   written in bf16.
// x bf16 [M, K], Wg/Wu int8 [E, K, N], sg/su f32 [E, 1, N], offsets as in
// gmm.cu (128-aligned, offsets[E] = M).
//
// Bound: tensor-core operations. At the Mixtral-8x1B training shape (M
// 17,408, K 2048, N 8192) the forward is two products, 1.17e12 flops, 1.18
// ms at 989 TFLOP/s, against 0.91 GB moved (0.27 ms at 3.35 TB/s); the
// backward one product, 5.84e11 flops (0.59 ms), against 1.35 GB (0.40 ms).
//
// Design. The main loop is gmm.cu's (gmm_common.cuh): one 128-row tile of
// one expert per block, the whole K in the block, the int8 tiles widened in
// shared memory. The forward carries two accumulators, gate and up, over a
// 64-column tile so both stay in registers (64 f32 a thread); the epilogue
// runs in f32 on the accumulators and writes h and g. The backward carries
// one accumulator over a 128-column tile and reads g and dh only in its
// epilogue. The two dlhs products after the backward are gmm.cu launches.

#include "gmm_common.cuh"

namespace {

using gmm::bf16;

constexpr int kBNFwd = 64;
constexpr int kBNBwd = 128;

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(gmm::kThreads)
    swiglu_fwd_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ wg,
                      const int8_t* __restrict__ wu, const float* __restrict__ sg,
                      const float* __restrict__ su, const int* __restrict__ offsets,
                      bf16* __restrict__ h, bf16* __restrict__ g, int K, int N, int E) {
  using T = gmm::Tiles<kBNFwd, false, int8_t>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * kBNFwd;
  const int m0 = blockIdx.y * gmm::kBM;
  const int e = gmm::tile_expert(offsets, E, m0);
  const long long bank = static_cast<long long>(e) * K * N;
  const gmm::Operand<int8_t> b[2] = {{wg + bank}, {wu + bank}};
  const float* sge = sg + static_cast<long long>(e) * N;
  const float* sue = su + static_cast<long long>(e) * N;

  float acc[2][4][T::kNT][4];
  gmm::mainloop<kBNFwd, 2, false, int8_t>(acc, smem, x, b, m0, n0, K, N);

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < T::kNT; ++ni) {
      const int col = gmm::acc_col<kBNFwd>(n0, ni);
      if (col >= N) continue;
      const float gs[2] = {__ldg(sge + col), __ldg(sge + col + 1)};
      const float us[2] = {__ldg(sue + col), __ldg(sue + col + 1)};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long at = static_cast<long long>(gmm::acc_row(m0, mi, 2 * r)) * N + col;
        float gv[2], hv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          gv[c] = acc[0][mi][ni][2 * r + c] * gs[c];
          const float uv = acc[1][mi][ni][2 * r + c] * us[c];
          hv[c] = gv[c] * sigmoid(gv[c]) * uv;
        }
        flash::store2(h + at, hv[0], hv[1]);
        flash::store2(g + at, gv[0], gv[1]);
      }
    }
  }
}

__global__ void __launch_bounds__(gmm::kThreads)
    swiglu_bwd_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ wu,
                      const float* __restrict__ su, const int* __restrict__ offsets,
                      const bf16* __restrict__ g, const bf16* __restrict__ dh,
                      bf16* __restrict__ dg, bf16* __restrict__ du, int K, int N, int E) {
  using T = gmm::Tiles<kBNBwd, false, int8_t>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * kBNBwd;
  const int m0 = blockIdx.y * gmm::kBM;
  const int e = gmm::tile_expert(offsets, E, m0);
  const gmm::Operand<int8_t> b[1] = {{wu + static_cast<long long>(e) * K * N}};
  const float* sue = su + static_cast<long long>(e) * N;

  float acc[1][4][T::kNT][4];
  gmm::mainloop<kBNBwd, 1, false, int8_t>(acc, smem, x, b, m0, n0, K, N);

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < T::kNT; ++ni) {
      const int col = gmm::acc_col<kBNBwd>(n0, ni);
      if (col >= N) continue;
      const float us[2] = {__ldg(sue + col), __ldg(sue + col + 1)};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long at = static_cast<long long>(gmm::acc_row(m0, mi, 2 * r)) * N + col;
        const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g + at));
        const float2 dv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dh + at));
        const float gg[2] = {gv.x, gv.y};
        const float dd[2] = {dv.x, dv.y};
        float dgv[2], duv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float u = acc[0][mi][ni][2 * r + c] * us[c];
          const float sig = sigmoid(gg[c]);
          dgv[c] = dd[c] * u * (sig * (1.f + gg[c] * (1.f - sig)));
          duv[c] = dd[c] * (gg[c] * sig);
        }
        flash::store2(dg + at, dgv[0], dgv[1]);
        flash::store2(du + at, duv[0], duv[1]);
      }
    }
  }
}

int check(int M, int K, int N, int E) {
  if (E <= 0 || K <= 0 || M % gmm::kBM || K % 16 || N % 16 || M / gmm::kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// Both return a CUDA error code (0 on success). The caller has checked
// dtypes, shapes, contiguity, one device and 16-byte aligned bases.
extern "C" int swiglu_fwd_launch(const void* x, const void* wg, const void* wu, const void* sg,
                                 const void* su, const void* offsets, void* h, void* g, int M,
                                 int K, int N, int E, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (int rc = check(M, K, N, E)) return rc;
  constexpr int kSmem = gmm::smem_bytes<kBNFwd, 2, false, int8_t>();
  static int attr = flash::set_smem(swiglu_fwd_kernel, kSmem);
  if (attr != 0) return attr;
  const dim3 grid(flash::ceil_div(N, kBNFwd), M / gmm::kBM);
  swiglu_fwd_kernel<<<grid, gmm::kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(wg),
      static_cast<const int8_t*>(wu), static_cast<const float*>(sg),
      static_cast<const float*>(su), static_cast<const int*>(offsets), static_cast<bf16*>(h),
      static_cast<bf16*>(g), K, N, E);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int swiglu_bwd_launch(const void* x, const void* wu, const void* su,
                                 const void* offsets, const void* g, const void* dh, void* dg,
                                 void* du, int M, int K, int N, int E, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (int rc = check(M, K, N, E)) return rc;
  constexpr int kSmem = gmm::smem_bytes<kBNBwd, 1, false, int8_t>();
  static int attr = flash::set_smem(swiglu_bwd_kernel, kSmem);
  if (attr != 0) return attr;
  const dim3 grid(flash::ceil_div(N, kBNBwd), M / gmm::kBM);
  swiglu_bwd_kernel<<<grid, gmm::kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(wu),
      static_cast<const float*>(su), static_cast<const int*>(offsets),
      static_cast<const bf16*>(g), static_cast<const bf16*>(dh), static_cast<bf16*>(dg),
      static_cast<bf16*>(du), K, N, E);
  return static_cast<int>(cudaGetLastError());
}
