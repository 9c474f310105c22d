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
// Design. Both kernels are warp-specialised on wgmma, TMA and mbarrier
// rings (sm90_common.cuh, grouped_sm90.cuh) and own 128-row tiles of one
// expert each. The forward is grouped_sm90.cuh's persistent product with
// one B of 256 columns, [gate 128 | up 128] of the same output columns: the
// two raw int8 chunks load side by side into a stage and widen into one
// 64 x 256 bf16 operand, so one wgmma m64n256k16 a k16 step gives each
// consumer thread the gate and up sums of the same rows and columns
// (accumulator pairs j and j + 16, 128 columns apart). Its epilogue runs in
// f32 on the accumulators and writes h and g from registers; u never
// reaches memory. The backward (namespace swb below) carries one
// accumulator over a 256-column tile and takes g and dh from shared memory
// in its epilogue. The two dlhs products after the backward are gmm.cu
// launches.

#include "grouped_sm90.cuh"

namespace {

using grouped::bf16;

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// The forward's epilogue: g = acc_g sg, u = acc_u su, h = g sigmoid(g) u
// in f32; h and g stored in bf16, 16 bytes a store (quad_transpose),
// columns past N not stored. Consumer thread t fetches the gate (t < 128)
// or up scale of the tile's column t % 128 (load) as the tile starts.
struct SwigluFwdEpi {
  static constexpr int kBN = 128;  // output columns of a tile
  bf16* h;
  bf16* g;
  const float* sg;
  const float* su;

  __device__ __forceinline__ float load(int t, int n0, int e, int N) const {
    const int col = n0 + t % kBN;
    if (col >= N) return 0.f;
    return __ldg((t < kBN ? sg : su) + static_cast<long long>(e) * N + col);
  }

  __device__ __forceinline__ void operator()(const float (&acc)[2 * kBN / 2], int m0, int n0,
                                             int e, int N, float v, float* cols) const {
    constexpr int kPairs = kBN / 8;  // accumulator groups of the gate half
    const grouped::Frag f = grouped::frag();
    grouped::share_cols(cols, v);
    const long long r0 = static_cast<long long>(m0 + f.row0) * N;
#pragma unroll
    for (int j0 = 0; j0 < kPairs; j0 += 4) {
      uint32_t hw[2][4], gw[2][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + jj;
        const float2 gs = *reinterpret_cast<const float2*>(cols + 8 * j + 2 * f.quad);
        const float2 us = *reinterpret_cast<const float2*>(cols + kBN + 8 * j + 2 * f.quad);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float g0 = acc[4 * j + 2 * r] * gs.x, g1 = acc[4 * j + 2 * r + 1] * gs.y;
          const float u0 = acc[4 * (j + kPairs) + 2 * r] * us.x;
          const float u1 = acc[4 * (j + kPairs) + 2 * r + 1] * us.y;
          hw[r][jj] = sm90::pack_bf16(g0 * sigmoid(g0) * u0, g1 * sigmoid(g1) * u1);
          gw[r][jj] = sm90::pack_bf16(g0, g1);
        }
      }
      const int col = n0 + 8 * (j0 + f.quad);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint4 hv = grouped::quad_transpose(hw[r]);
        const uint4 gv = grouped::quad_transpose(gw[r]);
        const long long at = r0 + static_cast<long long>(8 * r) * N + col;
        if (col < N) {
          *reinterpret_cast<uint4*>(h + at) = hv;
          *reinterpret_cast<uint4*>(g + at) = gv;
        }
      }
    }
  }
};

__global__ void __launch_bounds__(grouped::kThreads, 1)
    swiglu_fwd_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tg,
                      const __grid_constant__ CUtensorMap tu, const SwigluFwdEpi epi,
                      const int* __restrict__ offsets, grouped::Sched sched, int K, int N,
                      int E) {
  const grouped::BankOps<2 * SwigluFwdEpi::kBN, false, int8_t, 2> ops{&tx, &tg, &tu, offsets,
                                                                       sched, K, N, E};
  grouped::persistent_product(ops, epi);
}

int swiglu_fwd(const void* x, const void* wg, const void* wu, const void* sg, const void* su,
               const void* offsets, void* h, void* g, int M, int K, int N, int E,
               cudaStream_t stream) {
  constexpr int kBN = SwigluFwdEpi::kBN;
  constexpr int kSmem = grouped::BankOps<2 * kBN, false, int8_t, 2>::C::kSmem;
  static int attr = sm90::set_smem(swiglu_fwd_kernel, kSmem);
  if (attr != 0) return attr;
  CUtensorMap tx, tg, tu;
  if (int rc = grouped::rows_map(&tx, x, M, K)) return rc;
  if (int rc = grouped::bank_map<2 * kBN, kBN, false, int8_t>(&tg, wg, K, N, E)) return rc;
  if (int rc = grouped::bank_map<2 * kBN, kBN, false, int8_t>(&tu, wu, K, N, E)) return rc;
  const SwigluFwdEpi epi{static_cast<bf16*>(h), static_cast<bf16*>(g),
                         static_cast<const float*>(sg), static_cast<const float*>(su)};
  const grouped::Sched sched = grouped::schedule(M, N, kBN);
  swiglu_fwd_kernel<<<grouped::launch_grid(sched), grouped::kThreads, kSmem, stream>>>(
      tx, tg, tu, epi, static_cast<const int*>(offsets), sched, K, N, E);
  return static_cast<int>(cudaGetLastError());
}

// The backward on Hopper's own machinery (sm90_common.cuh). One block owns
// a 128-row tile of one expert (ALIGN: tile_expert finds it, as in gmm.cu)
// and 256 columns, in three warpgroups:
//   - warp 0's first thread TMA-loads the x chunk (128 x 64 bf16, swizzled)
//     and the raw int8 bank chunk (64 x 256 bytes) into a ring of kStages
//     stages of 32 KB with full and empty mbarriers; after the last chunk it
//     goes round the ring once more and loads the tile's g and dh (128 x 256
//     bf16 each, swizzled panels of 64 columns) into the stages as the last
//     chunks free them, so the epilogue finds them in shared memory;
//   - warps 1-3 load the tile's column scales into shared memory, then
//     widen each int8 chunk (exact: |q| <= 127, by byte permutes and one
//     float subtraction, no conversion instruction) into the swizzled bf16
//     layout wgmma reads, one of kWiden buffers with their own full and
//     empty mbarriers, running ahead of the products; each thread fences
//     its generic stores to the async proxy before it arrives;
//   - two consumer warpgroups of 64 rows issue wgmma m64n256k16 (x from
//     shared memory K-major, the widened bank MN-major) with one chunk in
//     flight behind the next, then the epilogue reads g and dh in the
//     accumulator layout, writes dg and du over them, and one thread
//     TMA-stores both.
// TMA zero-fills x past K and the bank past K and N, and the store skips
// columns past N, so no edge needs a mask. 256 columns (not 128) halve how
// often the x chunk is read again for each column block.
namespace swb {

constexpr int kBM = 128, kBN = 256, kBK = 64;
// A producer warpgroup and two consumer ones. ptxas compiles every path
// within the launch's 168 registers a thread (65,536 / 384); setmaxnreg
// then hands the producer's unused share to the consumers at run time.
// A fourth warpgroup for widening would leave 128, fewer than one
// m64n256k16 product's 154.
constexpr int kThreads = 384;
constexpr int kWidenThreads = 96;  // warps 1-3
constexpr int kPieces = 1024;        // 16-byte pieces of a raw chunk (64 x 256 int8)
constexpr int kConsumerPieces = 512;  // the consumers' share: 2 a thread
constexpr int kStages = 4;          // x + raw bank chunks in flight
constexpr int kWiden = 3;           // widened chunks in flight
constexpr int kX = kBM * kBK * 2;   // 16 KB: one swizzled 128-row panel
constexpr int kW = kBK * kBN;       // 16 KB of int8
constexpr int kStage = kX + kW;     // 32 KB; later two 16 KB panels of g or dh
constexpr int kWPanel = kBK * 128;  // 8 KB: 64 rows x 64 bf16 columns
constexpr int kWB = 4 * kWPanel;    // the widened chunk: four column panels
constexpr int kEpiPanel = kBM * 128;  // 16 KB: 128 rows x 64 bf16 columns of g or dh
constexpr int kOffWB = kStages * kStage;
constexpr int kSmem = kOffWB + kWiden * kWB + 1024;  // + slack to align the base to 1024 bytes
static_assert(kStages * kStage == 8 * kEpiPanel, "g and dh fill the ring");

// where panel `panel` (0..3) of g (t = 0) or dh (t = 1) lies in the ring:
// panel pair i = (4t + panel) / 2 goes into the stage of fill nk + i
__device__ __forceinline__ uint32_t epi_offset(int t, int panel, int nk) {
  const int box = 4 * t + panel;
  return ((nk + box / 2) % kStages) * kStage + (box % 2) * kEpiPanel;
}

__device__ __forceinline__ float fast_sigmoid(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

__global__ void __launch_bounds__(kThreads, 1)
    swiglu_bwd_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tw,
                      const __grid_constant__ CUtensorMap tg,
                      const __grid_constant__ CUtensorMap tdh,
                      const __grid_constant__ CUtensorMap tdg,
                      const __grid_constant__ CUtensorMap tdu, const float* __restrict__ su,
                      const int* __restrict__ offsets, int K, int N, int E) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], wfull[kWiden], wempty[kWiden],
      su_full;
  __shared__ __align__(16) float su_tile[kBN];  // this expert's scale over the tile's columns
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int e = grouped::tile_expert(offsets, E, m0);
  const int nk = sm90::ceil_div(K, kBK);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      // consumer warps (x) and widening warps (raw)
      sm90::mbar_init(&empty[s], 8 + kWidenThreads / 32);
    }
#pragma unroll
    for (int b = 0; b < kWiden; ++b) {
      sm90::mbar_init(&wfull[b], kWidenThreads + 256);  // every widening thread
      sm90::mbar_init(&wempty[b], 8);
    }
    sm90::mbar_init(&su_full, kWidenThreads);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = sm90::warpgroup_idx();
  const int lane = threadIdx.x & 31;
  if (wg == 0) {
    sm90::setmaxnreg_dec<56>();
    if (threadIdx.x == 0) {  // TMA
      sm90::prefetch_map(tx);
      sm90::prefetch_map(tw);
      for (int f = 0; f < nk + kStages; ++f) {
        const int s = f % kStages;
        unsigned char* stage = smem + s * kStage;
        if (f >= kStages) sm90::mbar_wait(&empty[s], ((f / kStages) - 1) & 1);
        if (f < nk) {
          sm90::mbar_expect_tx(&full[s], kStage);
          sm90::tma_load_2d(stage, tx, &full[s], f * kBK, m0);
          sm90::tma_load_3d(stage + kX, tw, &full[s], n0, f * kBK, e);
        } else {  // two panels of g or dh: boxes 2i and 2i + 1
          const int i = f - nk;
          int bytes = 0;
#pragma unroll
          for (int x = 0; x < 2; ++x) bytes += n0 + 64 * ((2 * i + x) % 4) < N ? kEpiPanel : 0;
          sm90::mbar_expect_tx(&full[s], bytes);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int box = 2 * i + x;
            const int col = n0 + 64 * (box % 4);
            if (col < N) {
              sm90::tma_load_2d(stage + x * kEpiPanel, box < 4 ? tg : tdh, &full[s], col, m0);
            }
          }
        }
      }
    } else if (threadIdx.x >= 32) {  // widening: the pieces past the consumers' share
      const int wt = threadIdx.x - 32;
      for (int c = wt; c < kBN; c += kWidenThreads) {
        su_tile[c] = n0 + c < N ? __ldg(su + static_cast<long long>(e) * N + n0 + c) : 0.f;
      }
      sm90::mbar_arrive(&su_full);
      for (int kc = 0; kc < nk; ++kc) {
        const int s = kc % kStages;
        const int b = kc % kWiden;
        const unsigned char* raw = smem + s * kStage + kX;
        unsigned char* wb = smem + kOffWB + b * kWB;
        sm90::mbar_wait(&full[s], (kc / kStages) & 1);
        if (kc >= kWiden) sm90::mbar_wait(&wempty[b], ((kc / kWiden) - 1) & 1);
        grouped::widen_strided<kBN, false, 1>(raw, wb, kConsumerPieces + wt, kWidenThreads,
                                              kPieces);
        sm90::fence_proxy_async();
        sm90::mbar_arrive(&wfull[b]);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[s]);  // this warp's raw reads are done
      }
    }
  } else {  // two consumer warpgroups of 64 rows
    sm90::setmaxnreg_inc<224>();
    const int cw = wg - 1;
    const int t = threadIdx.x - 128;  // 0..255 over both consumer warpgroups
    const int warp = (threadIdx.x >> 5) & 3;
    const int quad = lane & 3;

    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;

    // the consumers' share of chunk c's widening, done while chunk c - 1's
    // products run
    auto widen_share = [&](int c) {
      const int s = c % kStages;
      const int b = c % kWiden;
      sm90::mbar_wait(&full[s], (c / kStages) & 1);
      if (c >= kWiden) sm90::mbar_wait(&wempty[b], ((c / kWiden) - 1) & 1);
      grouped::widen_strided<kBN, false, 1>(smem + s * kStage + kX, smem + kOffWB + b * kWB, t,
                                            256, kConsumerPieces);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&wfull[b]);
    };
    widen_share(0);
    for (int kc = 0; kc < nk; ++kc) {
      const int s = kc % kStages;
      const int b = kc % kWiden;
      const unsigned char* stage = smem + s * kStage;
      const unsigned char* wb = smem + kOffWB + b * kWB;
      sm90::mbar_wait(&wfull[b], (kc / kWiden) & 1);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < kBK / 16; ++k16) {
        sm90::wgmma_ss_n256<1>(acc, sm90::desc128(stage + cw * 64 * 128 + k16 * 32, 16, 1024),
                               sm90::desc128(wb + k16 * 16 * 128, kWPanel, 1024), 1);
      }
      sm90::wgmma_commit();
      if (kc + 1 < nk) widen_share(kc + 1);
      sm90::wgmma_wait<1>();  // chunk kc - 1's products are done
      sm90::fence_regs(acc);
      if (kc > 0 && lane == 0) {
        sm90::mbar_arrive(&empty[(kc - 1) % kStages]);
        sm90::mbar_arrive(&wempty[(kc - 1) % kWiden]);
      }
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    if (lane == 0) sm90::mbar_arrive(&empty[(nk - 1) % kStages]);

    // epilogue: u = acc * su; dg = dh u sig(g) (1 + g (1 - sig(g))),
    // du = dh g sig(g), written over g and dh
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      sm90::mbar_wait(&full[(nk + i) % kStages], ((nk + i) / kStages) & 1);
    }
    sm90::mbar_wait(&su_full, 0);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int ct = 8 * j + 2 * quad;  // column within the tile
      const float2 us2 = *reinterpret_cast<const float2*>(su_tile + ct);
      const float us[2] = {us2.x, us2.y};
      const uint32_t gbase = epi_offset(0, ct >> 6, nk);
      const uint32_t dbase = epi_offset(1, ct >> 6, nk);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rt = cw * 64 + warp * 16 + (lane >> 2) + 8 * r;  // row within the tile
        const uint32_t off = sm90::swz128(rt, (ct & 63) >> 3) + (ct & 7) * 2;
        __nv_bfloat162* gp = reinterpret_cast<__nv_bfloat162*>(smem + gbase + off);
        __nv_bfloat162* dp = reinterpret_cast<__nv_bfloat162*>(smem + dbase + off);
        const float2 gv = __bfloat1622float2(*gp);
        const float2 dv = __bfloat1622float2(*dp);
        const float gg[2] = {gv.x, gv.y};
        const float dd[2] = {dv.x, dv.y};
        float dgv[2], duv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float u = acc[4 * j + 2 * r + c] * us[c];
          const float sig = fast_sigmoid(gg[c]);
          dgv[c] = dd[c] * u * (sig * (1.f + gg[c] * (1.f - sig)));
          duv[c] = dd[c] * (gg[c] * sig);
        }
        *gp = __floats2bfloat162_rn(dgv[0], dgv[1]);
        *dp = __floats2bfloat162_rn(duv[0], duv[1]);
      }
    }
    sm90::fence_proxy_async();
    sm90::named_sync(1, 256);
    if (t == 0) {
      for (int panel = 0; panel < 4 && n0 + 64 * panel < N; ++panel) {
        sm90::tma_store_2d(tdg, smem + epi_offset(0, panel, nk), n0 + 64 * panel, m0);
        sm90::tma_store_2d(tdu, smem + epi_offset(1, panel, nk), n0 + 64 * panel, m0);
      }
      sm90::tma_store_commit();
      sm90::tma_store_wait_read();
    }
  }
}

int launch(const void* x, const void* wu, const void* su, const void* offsets, const void* g,
           const void* dh, void* dg, void* du, int M, int K, int N, int E, cudaStream_t stream) {
  CUtensorMap tx, tw, tg, tdh, tdg, tdu;
  if (int rc = grouped::rows_map(&tx, x, M, K)) return rc;
  {  // the int8 bank [E, K, N] as {N, K, E}, raw 256 x 64 boxes
    const uint64_t dims[3] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K),
                              static_cast<uint64_t>(E)};
    const uint64_t strides[2] = {static_cast<uint64_t>(N),
                                 static_cast<uint64_t>(K) * static_cast<uint64_t>(N)};
    const uint32_t box[3] = {kBN, kBK, 1};
    if (int rc = sm90::make_map<3>(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, wu, dims, strides, box,
                                   CU_TENSOR_MAP_SWIZZLE_NONE)) {
      return rc;
    }
  }
  if (int rc = grouped::rows_map(&tg, g, M, N)) return rc;
  if (int rc = grouped::rows_map(&tdh, dh, M, N)) return rc;
  if (int rc = grouped::rows_map(&tdg, dg, M, N)) return rc;
  if (int rc = grouped::rows_map(&tdu, du, M, N)) return rc;
  static int attr = sm90::set_smem(swiglu_bwd_kernel, kSmem);
  if (attr != 0) return attr;
  const dim3 grid(sm90::ceil_div(N, kBN), M / kBM);
  swiglu_bwd_kernel<<<grid, kThreads, kSmem, stream>>>(
      tx, tw, tg, tdh, tdg, tdu, static_cast<const float*>(su),
      static_cast<const int*>(offsets), K, N, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swb

}  // namespace

// Both return a CUDA error code (0 on success). The caller has checked
// dtypes, shapes, contiguity, one device and 16-byte aligned bases.
extern "C" int swiglu_fwd_launch(const void* x, const void* wg, const void* wu, const void* sg,
                                 const void* su, const void* offsets, void* h, void* g, int M,
                                 int K, int N, int E, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (int rc = grouped::check_shape(M, K, N, E)) return rc;
  return swiglu_fwd(x, wg, wu, sg, su, offsets, h, g, M, K, N, E,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int swiglu_bwd_launch(const void* x, const void* wu, const void* su,
                                 const void* offsets, const void* g, const void* dh, void* dg,
                                 void* du, int M, int K, int N, int E, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (int rc = grouped::check_shape(M, K, N, E)) return rc;
  return swb::launch(x, wu, su, offsets, g, dh, dg, du, M, K, N, E,
                     static_cast<cudaStream_t>(stream));
}
