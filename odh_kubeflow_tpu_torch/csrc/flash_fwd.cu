// Flash-attention forward for Hopper (sm_90a), bf16, head dim 64 or 128.
//
// Replaces odh_kubeflow_tpu/ops/pallas_attention.py:_fwd_kernel (pallas_call
// in _fwd). Same function:
//
//   q [B, Sq, Hq, hd], k/v [B, Sk, Hkv, hd] (GQA: Hq % Hkv == 0, query head
//   h reads kv head h / (Hq / Hkv)); optional int32 segment ids qseg [B, Sq],
//   kseg [B, Sk]. Key k is live for query q when k < Sk, (not causal or
//   q + q_offset >= k) and qseg[q] == kseg[k].
//   s = (q . k) * hd^-0.5 * log2(e), a base-2 online softmax with f32 m, l
//   and accumulator; masked scores are -1e30 and their p is 0.
//   out = acc / l in bf16 (0 where l == 0: a row with no live key),
//   lse2 [B, Hq, Sq] f32 = m + log2(l), the backward's residual.
//
// Bound: tensor-core operations. Per query head, 4 * hd flops per live
// (query, key) pair (q.k and p.v); at the Llama-3-8B training shape
// (B 2, S 4096, Hq 32, hd 128, causal) that is 2.75e11 flops a layer, 0.28 ms
// at the H100 SXM's 989 TFLOP/s bf16 dense, against 0.13 GB moved (0.04 ms
// at 3.35 TB/s).
//
// Design. The TPU kernel walked a host-made table of live (q-block, k-block)
// pairs in order on one core, carrying m/l/acc in VMEM between grid steps.
// Here a block owns 128 queries of one (batch, head) and loops over the
// K/V tiles of 128 keys it can see: the causal limit is the loop bound, so
// dead tiles are never visited, and the grid walks the heaviest (last)
// query tiles of every head first. The block is warp-specialised
// (sm90_common.cuh):
//   - a producer warpgroup, cut to 24 registers, whose one thread TMA-loads
//     the Q tile once and the K and V tiles into rings of kStages stages
//     (2 at hd 128, 3 at hd 64) with full and empty mbarriers, K's and V's
//     apart: a K stage is free once its scores are done, a V stage once
//     its P.V is. TMA reads the [B, S, H, hd] tensors through their strides
//     (no copy) and fills rows past Sq or Sk with zeros; an hd-128 row
//     arrives as two 64-wide swizzled panels.
//   - two consumer warpgroups of 64 queries each, grown to 240 registers:
//     S = Q.K^T by wgmma m64n128k16 with both operands in shared memory; the
//     mask only on tiles that need it (ragged end, diagonal, more than one
//     document, the counterpart of _block_full/_dispatch_body); the online softmax in
//     base 2 on the accumulators; P rounded to bf16 in registers and
//     O += P.V by wgmma with A from registers and V (keys x hd, hd
//     contiguous) by a transposed-B descriptor. The loop is software-
//     pipelined as in FlashAttention-3: tile j's scores are issued together
//     with tile j-1's P.V, and tile j's softmax runs while that P.V is in
//     flight. The two warpgroups take turns issuing (ping-pong on two named
//     barriers), so one's softmax runs under the other's products.
// Rows at or past Sq are never written.

#include <math_constants.h>

#include "sm90_common.cuh"

namespace {

using sm90::bf16;

constexpr float kNegInf = -1e30f;  // the masked score, as in the TPU kernel
constexpr int kBQ = 128;           // queries of a block: two warpgroups of 64
constexpr int kBK = 128;           // keys of a K/V tile
constexpr int kThreads = 384;      // producer warpgroup + 2 consumer warpgroups
constexpr int kPanel = 128 * 128;  // bytes of a 128-row x 64-column bf16 panel

template <int HD>
struct Cfg {
  static constexpr int kPanels = HD / 64;
  static constexpr int kTile = kPanels * kPanel;  // bytes of a 128-row tile
  static constexpr int kStages = HD == 128 ? 2 : 3;
  // Q, kStages x (K, V), and slack to align the base to 1024 bytes
  static constexpr int kSmem = kTile * (1 + 2 * kStages) + 1024;
};

struct FwdParams {
  const int* qseg;  // null without segment ids
  const int* kseg;
  bf16* out;
  float* lse;
  long long os_b, os_s, os_h;  // element strides of out
  int Sq, Sk, Hq, Hkv;
  int causal, q_offset;
  float scale_log2;  // hd^-0.5 * log2(e)
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S = Q K^T for one warpgroup: 64 queries x 128 keys, f32, issued and
// committed (the caller waits)
template <int HD>
__device__ __forceinline__ void issue_scores(float (&sc)[64], const unsigned char* qrows,
                                             const unsigned char* kt) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
    const int off = (kc / 4) * kPanel + (kc % 4) * 32;
    sm90::wgmma_ss_n128<0>(sc, sm90::desc128(qrows + off, 16, 1024),
                           sm90::desc128(kt + off, 16, 1024), kc > 0);
  }
  sm90::wgmma_commit();
}

// O += P V, issued and committed. V is keys x hd with hd contiguous:
// MN-major, hd panels kPanel bytes apart, a 16-key step 16 rows on.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&pa)[8][4],
                                         const unsigned char* vt) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    const uint64_t dv = sm90::desc128(vt + kc * 16 * 128, kPanel, 1024);
    if constexpr (HD == 128) {
      sm90::wgmma_rs_n128<1>(o, pa[kc], dv, 1);
    } else {
      sm90::wgmma_rs_n64<1>(o, pa[kc], dv, 1);
    }
  }
  sm90::wgmma_commit();
}

// keep P's registers untouched until the P V product that reads them is done
__device__ __forceinline__ void hold(uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(pa[kc][i])::"memory");
  }
}

// The per-thread view of a warpgroup's rows: accumulator element 4n + e is
// row row[e >> 1], key k0 + 8n + 2 quad + (e & 1).
struct Rows {
  int row[2];
  int qseg[2];
  const int* kseg;  // this batch row's key segment ids, or null
  const int* ks;    // with segment ids: the tile's key ids, staged in shared memory
  int quad;
};

// dead (query, key) pairs of the tile at k0 to -inf (raw scores); seg:
// compare segment ids too
__device__ __forceinline__ void mask_tile(float (&sc)[64], int k0, const Rows& w,
                                          const FwdParams& p, bool seg) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int col = k0 + n * 8 + 2 * w.quad + (e & 1);
      bool live = col < p.Sk;
      if (live && p.causal) live = w.row[r] + p.q_offset >= col;
      if (live && seg) live = w.qseg[r] == w.ks[col - k0];
      if (!live) sc[4 * n + e] = -CUDART_INF_F;
    }
  }
}

// Online softmax in base 2 on raw scores: m is kept scaled (the running max
// of s * scale_log2, -1e30 while a row has seen no live key), p =
// 2^(s * scale_log2 - m) by one fma, so a masked (-inf) score gives p = 0
// with no test; alpha rescales what was summed before.
__device__ __forceinline__ void softmax(float (&sc)[64], float (&m)[2], float (&l)[2],
                                        float (&alpha)[2], float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < 16; ++n) mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
    const float m_new = fmaxf(m[r], quad_max(mx) * scale);
    alpha[r] = sm90::exp2_approx(m[r] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float pe = sm90::exp2_approx(fmaf(sc[4 * n + e], scale, -m_new));
        sc[4 * n + e] = pe;
        sum += pe;
      }
    }
    l[r] = l[r] * alpha[r] + sum;  // this lane's share of the row sum
    m[r] = m_new;
  }
}

template <int HD>
__device__ __forceinline__ void rescale(float (&o)[HD / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * n + e] *= alpha[e >> 1];
  }
}

// P in bf16: the A operand of the 8 k-steps of P V
__device__ __forceinline__ void to_bf16(uint32_t (&pa)[8][4], const float (&sc)[64]) {
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kc][i] = sm90::pack_bf16(sc[8 * kc + 2 * i], sc[8 * kc + 2 * i + 1]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const FwdParams p) {
  using C = Cfg<HD>;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[S], v_full[S], k_empty[S], v_empty[S];
  __shared__ int ks_tile[2][2][kBK];  // key segment ids: consumer warpgroup x 2 buffers
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  auto sK = [&](int s) { return smem + C::kTile * (1 + 2 * s); };
  auto sV = [&](int s) { return smem + C::kTile * (2 + 2 * s); };

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const int b = blockIdx.x / p.Hq;
  const int h = blockIdx.x % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, q0 + kBQ + p.q_offset);
  const int n_tiles = kv_end > 0 ? sm90::ceil_div(kv_end, kBK) : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&k_empty[s], 8);  // one arrival per consumer warp
      sm90::mbar_init(&v_empty[s], 8);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = sm90::warpgroup_idx();
  if (wg == 0) {  // producer warpgroup: one thread issues every copy
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      sm90::prefetch_map(tq);
      sm90::prefetch_map(tk);
      sm90::prefetch_map(tv);
      sm90::mbar_expect_tx(&q_full, C::kTile);
#pragma unroll
      for (int c = 0; c < C::kPanels; ++c) {
        sm90::tma_load_4d(sQ + c * kPanel, tq, &q_full, c * 64, q0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        const uint32_t ph = ((j / S) - 1) & 1;  // the phase that frees the stage
        if (j >= S) sm90::mbar_wait(&k_empty[s], ph);
        sm90::mbar_expect_tx(&k_full[s], C::kTile);
#pragma unroll
        for (int c = 0; c < C::kPanels; ++c) {
          sm90::tma_load_4d(sK(s) + c * kPanel, tk, &k_full[s], c * 64, j * kBK, hk, b);
        }
        if (j >= S) sm90::mbar_wait(&v_empty[s], ph);
        sm90::mbar_expect_tx(&v_full[s], C::kTile);
#pragma unroll
        for (int c = 0; c < C::kPanels; ++c) {
          sm90::tma_load_4d(sV(s) + c * kPanel, tv, &v_full[s], c * 64, j * kBK, hk, b);
        }
      }
    }
  } else {  // two consumer warpgroups of 64 queries
    sm90::setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const int qlo = q0 + cw * 64;
    Rows w;
    w.quad = lane & 3;
    w.row[0] = qlo + warp * 16 + (lane >> 2);
    w.row[1] = w.row[0] + 8;
    w.kseg = nullptr;
    w.ks = nullptr;
    w.qseg[0] = w.qseg[1] = 0;
    if (p.qseg != nullptr) {
      w.kseg = p.kseg + static_cast<long long>(b) * p.Sk;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        w.qseg[r] = w.row[r] < p.Sq ? __ldg(p.qseg + static_cast<long long>(b) * p.Sq + w.row[r])
                                    : -1;
      }
    }
    // With segment ids, each warpgroup stages the tile's 128 key ids in
    // shared memory (two buffers, so the barrier of tile j + 1 also frees
    // tile j's) before its mask reads them; issued before the scores are
    // waited for. The same barrier finds the tiles whose keys and rows all
    // lie in the warpgroup's first row's document (in packed batches,
    // most of them): those need no segment mask. Returns whether tile j
    // needs one.
    const int doc = w.kseg != nullptr && qlo < p.Sq
                        ? __ldg(p.qseg + static_cast<long long>(b) * p.Sq + qlo)
                        : -1;
    const bool rows_one_doc = w.kseg != nullptr &&
        sm90::named_sync_and(4 + cw, 128, w.qseg[0] == doc && w.qseg[1] == doc);
    auto stage_kseg = [&](int j) {
      if (w.kseg == nullptr) return false;
      const int t = threadIdx.x & 127;
      const int col = j * kBK + t;
      int* buf = ks_tile[cw][j & 1];
      const int id = col < p.Sk ? __ldg(w.kseg + col) : -2;
      buf[t] = id;
      w.ks = buf;
      return !sm90::named_sync_and(4 + cw, 128, rows_one_doc && id == doc);
    };
    // a tile needs the mask when it holds a key past Sk, a key above this
    // warpgroup's first row's diagonal, or more than one document
    auto masked = [&](int k0, bool seg) {
      return seg || k0 + kBK > p.Sk || (p.causal && k0 + kBK - 1 > qlo + p.q_offset);
    };
    // Ping-pong: the two warpgroups take turns issuing their products
    // (named barriers 2 and 3), so one's softmax runs under the other's
    // wgmma; warpgroup 1 lets warpgroup 0 go first.
    auto my_turn = [&] { sm90::named_sync(2 + cw, 256); };
    auto your_turn = [&](int j) {
      if (cw == 0 || j + 1 < n_tiles) sm90::named_arrive(3 - cw, 256);
    };

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
    float alpha[2];
    float sc[64];
    uint32_t pa[8][4];
    const unsigned char* qrows = sQ + cw * 64 * 128;  // this warpgroup's rows of each panel

    if (n_tiles > 0) {
      if (cw == 1) sm90::named_arrive(2, 256);
      sm90::mbar_wait(&q_full, 0);
      // tile 0: scores and softmax; its P V waits for the next iteration
      sm90::mbar_wait(&k_full[0], 0);
      my_turn();
      issue_scores<HD>(sc, qrows, sK(0));
      your_turn(0);
      const bool seg0 = stage_kseg(0);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      if (lane == 0) sm90::mbar_arrive(&k_empty[0]);
      if (masked(0, seg0)) mask_tile(sc, 0, w, p, seg0);
      softmax(sc, m, l, alpha, p.scale_log2);
      to_bf16(pa, sc);
      // tile j: S_j = Q K_j runs beside P_{j-1} V_{j-1}; the softmax of S_j
      // runs while P_{j-1} V_{j-1} is still in flight
      for (int j = 1; j < n_tiles; ++j) {
        const int s = j % S;
        const int sp = (j - 1) % S;
        sm90::mbar_wait(&k_full[s], (j / S) & 1);
        my_turn();
        issue_scores<HD>(sc, qrows, sK(s));
        rescale<HD>(o, alpha);
        sm90::mbar_wait(&v_full[sp], ((j - 1) / S) & 1);
        issue_pv<HD>(o, pa, sV(sp));
        your_turn(j);
        const bool seg = stage_kseg(j);
        sm90::wgmma_wait<1>();  // S_j is done
        sm90::fence_regs(sc);
        if (lane == 0) sm90::mbar_arrive(&k_empty[s]);
        if (masked(j * kBK, seg)) mask_tile(sc, j * kBK, w, p, seg);
        softmax(sc, m, l, alpha, p.scale_log2);
        sm90::wgmma_wait<0>();  // P_{j-1} V_{j-1} is done
        sm90::fence_regs(o);
        hold(pa);
        if (lane == 0) sm90::mbar_arrive(&v_empty[sp]);
        to_bf16(pa, sc);
      }
      const int sl = (n_tiles - 1) % S;
      rescale<HD>(o, alpha);
      sm90::mbar_wait(&v_full[sl], ((n_tiles - 1) / S) & 1);
      issue_pv<HD>(o, pa, sV(sl));
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      hold(pa);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lt = quad_sum(l[r]);
      const float l_safe = lt == 0.f ? 1.f : lt;
      const float inv = 1.f / l_safe;
      if (w.row[r] < p.Sq) {
        bf16* dst = p.out + b * p.os_b + static_cast<long long>(w.row[r]) * p.os_s + h * p.os_h;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          *reinterpret_cast<__nv_bfloat162*>(dst + n * 8 + 2 * w.quad) =
              __floats2bfloat162_rn(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
        }
        if (w.quad == 0) {
          p.lse[(static_cast<long long>(b) * p.Hq + h) * p.Sq + w.row[r]] = m[r] + log2f(l_safe);
        }
      }
    }
  }
}

// the [B, S, H, hd] tensor as a 4-d map {hd, S, H, B}, boxes of 64 x 128
template <int HD>
int qkv_map(CUtensorMap* map, const void* base, const long long* st, int B, int S, int H) {
  const uint64_t dims[4] = {HD, static_cast<uint64_t>(S), static_cast<uint64_t>(H),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(st[1]) * 2, static_cast<uint64_t>(st[2]) * 2,
                               static_cast<uint64_t>(st[0]) * 2};
  const uint32_t box[4] = {64, 128, 1, 1};
  return sm90::make_map<4>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const long long* strides,
           const FwdParams& p, int B, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (int rc = qkv_map<HD>(&tq, q, strides, B, p.Sq, p.Hq)) return rc;
  if (int rc = qkv_map<HD>(&tk, k, strides + 3, B, p.Sk, p.Hkv)) return rc;
  if (int rc = qkv_map<HD>(&tv, v, strides + 6, B, p.Sk, p.Hkv)) return rc;
  static int attr = sm90::set_smem(flash_fwd_kernel<HD>, Cfg<HD>::kSmem);
  if (attr != 0) return attr;
  const dim3 grid(B * p.Hq, sm90::ceil_div(p.Sq, kBQ));
  flash_fwd_kernel<HD><<<grid, kThreads, Cfg<HD>::kSmem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) of q, k, v and out.
// Returns a CUDA error code (0 on success). The caller has checked dtypes
// (bf16), shapes, devices, unit stride on hd, 16-byte aligned bases and
// strides that are multiples of 8 elements (TMA's 16 bytes).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, const void* qseg,
                                const void* kseg, void* out, void* lse,
                                const long long* strides, int B, int Sq, int Sk, int Hq,
                                int Hkv, int hd, int causal, int q_offset, float scale_log2,
                                void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || sm90::ceil_div(Sq, kBQ) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FwdParams p;
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.os_b = strides[9];
  p.os_s = strides[10];
  p.os_h = strides[11];
  p.Sq = Sq;
  p.Sk = Sk;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.causal = causal;
  p.q_offset = q_offset;
  p.scale_log2 = scale_log2;
  auto st = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch<128>(q, k, v, strides, p, B, st);
  if (hd == 64) return launch<64>(q, k, v, strides, p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
