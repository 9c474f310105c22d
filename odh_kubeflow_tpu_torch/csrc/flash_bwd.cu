// Flash-attention backward for Hopper (sm_90a), bf16, head dim 64 or 128:
// two kernels, dQ and dK/dV.
//
// Replaces odh_kubeflow_tpu/ops/pallas_attention.py:_dq_kernel and
// _dkv_kernel (both pallas_calls in _bwd). Same functions, given the
// forward's inputs, its base-2 residual lse2 [B, Hq, Sq] and
// delta = rowsum(dO * O) [B, Hq, Sq] (f32, a plain torch op, as JAX leaves
// it to XLA):
//
//   p  = exp2((q . k) * hd^-0.5 * log2(e) - lse2), 0 where (q, k) is not live
//   dp = dO . v
//   ds = p * (dp - delta)
//   dQ = hd^-0.5 * sum_k ds k            (per query head)
//   dK = hd^-0.5 * sum_q ds q, dV = sum_q p dO   (per KV head, summed over
//                                                 its whole GQA group)
// P and dS are rounded to bf16 before their products, as the TPU kernel
// rounds them to the operand dtype. Outputs are bf16.
//
// Bound: tensor-core operations. Per query head and live (query, key) pair,
// dQ does 6 * hd flops (q.k, dO.v, ds.k) and dK/dV 8 * hd (q.k, p.dO,
// dO.v, ds.q); at the Llama-3-8B training shape (B 2, S 4096, Hq 32, hd 128,
// causal) that is 4.1e11 and 5.5e11 flops a layer, 0.42 ms and 0.56 ms at
// the H100 SXM's 989 TFLOP/s bf16 dense.
//
// Design. Two kernels, each output written once by one block, no atomics:
// the result is deterministic, as the TPU kernel's VMEM accumulation is.
// Both are warp-specialised on sm90_common.cuh: two consumer warpgroups
// (warps 0-7) grown to 232 registers by setmaxnreg (the dK/dV accumulators
// alone take 128 at hd 128) and a producer warpgroup cut to 40, of which
// warp 8 works; 384 threads at one block an SM. The producer's lane 0
// TMA-loads a block's own 128-row tiles once and 64-row tiles into a ring
// of kStages stages (3 at hd 128, 4 at hd 64) with full and empty
// mbarriers; TMA reads the [B, S, H, hd] tensors through their strides and
// fills rows past Sq or Sk with zeros; an hd-128 row arrives as two 64-wide
// 128-byte-swizzled panels. Each consumer warpgroup owns 64 of the block's
// rows and runs every product by wgmma (m64, f32 accumulators): the two
// score-shaped products with both operands in shared memory, the two
// gradient products with P or dS from registers and the ring tile read
// through the transposed-B descriptor, so one loaded tile is both operands.
//   - dQ: a block owns 128 queries of one (batch, query head), holds Q and
//     dO, and walks the 64-key K/V tiles it can see (the causal limit is
//     the loop bound; with segment ids, the range of tiles whose documents
//     its rows share, found before the loop); the heaviest (last) query
//     tiles of every head go first. Per tile: S = Q K^T and dP = dO V^T,
//     P and dS in registers, dQ += dS K. The loop is software-pipelined: tile j's S and dP are
//     issued together with tile j-1's dS K, and tile j's exp2 and dS run
//     while that product is in flight; the two warpgroups take turns
//     issuing (ping-pong, as in the forward).
//   - dK/dV: a block owns 128 keys of one (batch, KV head), holds K and V,
//     and walks every query head of the GQA group and every live 64-query
//     Q/dO tile from the causal first one (with segment ids, within the
//     range of tiles whose documents its keys share); the first key
//     tiles, which see the most queries, go first. Producer warp 8 stages
//     each tile's lse2, delta and segment ids in shared memory. Per tile:
//     S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q;
//     dK and dV stay in registers across the group and are written once.
//     A warpgroup waits for its own products (128 accumulators leave no
//     room for the next tile's S^T and dP^T in flight); the other
//     warpgroup's products fill the tensor cores meanwhile. A warpgroup
//     skips a tile whose queries all lie above its keys' causal diagonal,
//     or lie in one document and its keys in another.
// The mask runs only on tiles that need it (a key past Sk, the causal
// diagonal, more than one document), as in the forward. A row past Sq or
// with no live key (lse2 = -1e30) has its lse2 replaced by +inf when it is
// loaded, so its P is exactly 0 on every tile, masked or not: a zero-filled
// row past Sq adds nothing to dK and dV, and exp2 never overflows.

#include <math_constants.h>

#include "sm90_common.cuh"

namespace {

using sm90::bf16;

constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kBig = 128;                  // a block's own rows: queries (dQ), keys (dK/dV)
constexpr int kSmall = 64;                 // rows of a ring tile: keys (dQ), queries (dK/dV)
constexpr int kBigPanel = kBig * 128;      // bytes of a 128-row x 64-column bf16 panel
constexpr int kSmallPanel = kSmall * 128;
constexpr float kDeadLse = -1e29f;  // lse2 at or below: a row with no live key (-1e30)

template <int HD>
struct Cfg {
  static constexpr int kPanels = HD / 64;
  static constexpr int kBigTile = kPanels * kBigPanel;
  static constexpr int kSmallTile = kPanels * kSmallPanel;
  static constexpr int kStages = HD == 128 ? 3 : 4;
  // two 128-row tiles, kStages x two 64-row tiles, and slack to align the
  // base to 1024 bytes
  static constexpr int kSmem = 2 * kBigTile + 2 * kStages * kSmallTile + 1024;
};

struct Out {
  bf16* p;
  long long b, s, h;  // element strides
};

struct BwdParams {
  const float* lse;
  const float* delta;
  const int* qseg;  // null without segment ids
  const int* kseg;
  Out o0, o1;  // dQ; or dK and dV
  int Sq, Sk, Hq, Hkv;
  int causal, q_offset;
  float scale_log2;  // hd^-0.5 * log2(e)
  float scale;       // hd^-0.5
};

// d = A B^T for one warpgroup, 64 x 64 in f32: a is the warpgroup's 64 rows
// of a 128-row tile, b a 64-row ring tile, both hd contiguous (K-major)
template <int HD>
__device__ __forceinline__ void issue_nt(float (&d)[32], const unsigned char* a,
                                         const unsigned char* b) {
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
    const int k = (kc % 4) * 32;
    sm90::wgmma_ss_n64<0>(d, sm90::desc128(a + (kc / 4) * kBigPanel + k, 16, 1024),
                          sm90::desc128(b + (kc / 4) * kSmallPanel + k, 16, 1024), kc > 0);
  }
}

// d += A B: A (64 x 64 bf16) from registers, B a 64-row ring tile read
// MN-major (rows are the contraction, hd contiguous; hd panels kSmallPanel
// bytes apart, a 16-row step 2048 bytes)
template <int HD>
__device__ __forceinline__ void issue_nn(float (&d)[HD / 2], const uint32_t (&a)[4][4],
                                         const unsigned char* b) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint64_t db = sm90::desc128(b + kc * 16 * 128, kSmallPanel, 1024);
    if constexpr (HD == 128) {
      sm90::wgmma_rs_n128<1>(d, a[kc], db, 1);
    } else {
      sm90::wgmma_rs_n64<1>(d, a[kc], db, 1);
    }
  }
}

// 64 x 64 f32 accumulators rounded to bf16: the A operand of the 4 k-steps
// of the next product
__device__ __forceinline__ void to_bf16(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kc][i] = sm90::pack_bf16(x[8 * kc + 2 * i], x[8 * kc + 2 * i + 1]);
  }
}

// keep A's registers untouched until the product that reads them is done
__device__ __forceinline__ void hold(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kc][i])::"memory");
  }
}

// A row past Sq or with no live key: +inf, so that exp2(s c - lse2) is 0.
__device__ __forceinline__ float live_lse(float lse, bool in) {
  return in && lse > kDeadLse ? lse : CUDART_INF_F;
}

// The per-thread view of a warpgroup's 64 x 64 accumulators: element 4n + e
// is row row[e >> 1] (of the warpgroup's rows), column 8n + 2 quad + (e & 1)
// of the ring tile.

// ---------------------------------------------------------------------------
// dQ

// P = 2^(s c - lse2) in place, per row (a masked score is -inf: P = 0)
__device__ __forceinline__ void dq_probs(float (&s)[32], const float (&lse)[2], float c) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = sm90::exp2_approx(fmaf(s[i], c, -lse[(i >> 1) & 1]));
}

// dS = P (dP - delta) in place of dP, per row
__device__ __forceinline__ void dq_dscores(float (&dp)[32], const float (&pr)[32],
                                           const float (&delta)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) dp[i] = pr[i] * (dp[i] - delta[(i >> 1) & 1]);
}

// dead (query, key) pairs of the key tile at k0 to -inf (raw scores); seg:
// compare segment ids too (ks: the tile's key ids in shared memory)
__device__ __forceinline__ void dq_mask(float (&s)[32], int k0, const int (&row)[2],
                                        const int (&qseg)[2], const int* ks, int quad,
                                        const BwdParams& p, bool seg) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int col = n * 8 + 2 * quad + (e & 1);
      bool live = k0 + col < p.Sk;
      if (live && p.causal) live = row[r] + p.q_offset >= k0 + col;
      if (live && seg) live = qseg[r] == ks[col];
      if (!live) s[4 * n + e] = -CUDART_INF_F;
    }
  }
}

// SEG: with segment ids (an instance apart, so the path without them
// carries none of their code)
template <int HD, bool SEG>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const BwdParams p) {
  using C = Cfg<HD>;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[S], empty[S];
  __shared__ int ks_tile[2][2][kSmall];  // key segment ids: consumer warpgroup x 2 buffers
  __shared__ int k_range[kThreads / 32][2];  // with segment ids: each warp's live key tiles
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  unsigned char* sdO = smem + C::kBigTile;
  auto sK = [&](int s) { return smem + 2 * C::kBigTile + 2 * s * C::kSmallTile; };
  auto sV = [&](int s) { return sK(s) + C::kSmallTile; };

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBig;  // heaviest tiles first
  const int b = blockIdx.x / p.Hq;
  const int h = blockIdx.x % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, q0 + kBig + p.q_offset);
  int kt0 = 0;  // the block walks key tiles kt0 .. kt0 + n_tiles - 1
  int n_tiles = kv_end > 0 ? sm90::ceil_div(kv_end, kSmall) : 0;
  if constexpr (SEG) {
    // The key tiles that may hold a live pair, as one range: a tile whose
    // keys all lie in one document that none of the block's rows is in
    // (its rows lying in at most two, the first's and the last's) holds
    // none. With documents packed back to back the rest is one range; a
    // tile inside it with no live pair is masked whole.
    const int* qs = p.qseg + static_cast<long long>(b) * p.Sq;
    const int* ks = p.kseg + static_cast<long long>(b) * p.Sk;
    const int d0 = __ldg(qs + q0);  // q0 < Sq
    const int d1 = __ldg(qs + min(q0 + kBig, p.Sq) - 1);
    const int q = q0 + static_cast<int>(threadIdx.x);
    bool in_two = true;
    if (threadIdx.x < kBig && q < p.Sq) {
      const int d = __ldg(qs + q);
      in_two = d == d0 || d == d1;
    }
    const bool two_docs = __syncthreads_and(in_two);
    const int lane = threadIdx.x & 31;
    int lo = n_tiles, hi = 0;  // this warp's live tiles
    for (int j = threadIdx.x >> 5; j < n_tiles; j += kThreads / 32) {
      const int k0 = j * kSmall;  // < Sk
      const int first = __ldg(ks + k0);
      const int a = k0 + lane < p.Sk ? __ldg(ks + k0 + lane) : first;
      const int c = k0 + 32 + lane < p.Sk ? __ldg(ks + k0 + 32 + lane) : first;
      const bool dead = two_docs && first != d0 && first != d1 &&
                        __all_sync(0xffffffffu, a == first && c == first);
      if (!dead) {
        lo = min(lo, j);
        hi = j + 1;
      }
    }
    if (lane == 0) {
      k_range[threadIdx.x >> 5][0] = lo;
      k_range[threadIdx.x >> 5][1] = hi;
    }
    __syncthreads();
    if (threadIdx.x < 32) {  // warp 0 merges the warps' ranges
      const bool w = lane < kThreads / 32;
      lo = __reduce_min_sync(0xffffffffu, w ? k_range[lane][0] : lo);
      hi = __reduce_max_sync(0xffffffffu, w ? k_range[lane][1] : 0);
      if (lane == 0) {
        k_range[0][0] = lo;
        k_range[0][1] = hi;
      }
    }
    __syncthreads();
    kt0 = k_range[0][0];
    n_tiles = max(k_range[0][1] - kt0, 0);
  }

  if (threadIdx.x == 0) {
    sm90::mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = sm90::warpgroup_idx();
  if (wg == 2) {  // the producer warpgroup: one thread issues every copy
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers && n_tiles > 0) {
      sm90::prefetch_map(tq);
      sm90::prefetch_map(tdo);
      sm90::prefetch_map(tk);
      sm90::prefetch_map(tv);
      sm90::mbar_expect_tx(&q_full, 2 * C::kBigTile);
#pragma unroll
      for (int c = 0; c < C::kPanels; ++c) {
        sm90::tma_load_4d(sQ + c * kBigPanel, tq, &q_full, c * 64, q0, h, b);
        sm90::tma_load_4d(sdO + c * kBigPanel, tdo, &q_full, c * 64, q0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        if (j >= S) sm90::mbar_wait(&empty[s], ((j / S) - 1) & 1);
        sm90::mbar_expect_tx(&full[s], 2 * C::kSmallTile);
        const int k0 = (kt0 + j) * kSmall;
#pragma unroll
        for (int c = 0; c < C::kPanels; ++c) {
          sm90::tma_load_4d(sK(s) + c * kSmallPanel, tk, &full[s], c * 64, k0, hk, b);
          sm90::tma_load_4d(sV(s) + c * kSmallPanel, tv, &full[s], c * 64, k0, hk, b);
        }
      }
    }
  } else {  // two consumer warpgroups of 64 queries
    sm90::setmaxnreg_inc<232>();
    const int cw = wg;
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const int quad = lane & 3;
    const int qlo = q0 + cw * 64;
    const int row[2] = {qlo + warp * 16 + (lane >> 2), qlo + warp * 16 + (lane >> 2) + 8};
    const long long rowbase = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
    float lse[2], delta[2];
    int qseg[2] = {0, 0};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row[r] < p.Sq;
      lse[r] = live_lse(in ? __ldg(p.lse + rowbase + row[r]) : 0.f, in);
      delta[r] = in ? __ldg(p.delta + rowbase + row[r]) : 0.f;
      if (SEG) qseg[r] = in ? __ldg(p.qseg + static_cast<long long>(b) * p.Sq + row[r]) : -1;
    }
    // With segment ids, each warpgroup stages the tile's 64 key ids in
    // shared memory (two buffers, so the barrier of tile j + 1 also frees
    // tile j's); the same barrier finds the tiles whose keys and rows all
    // lie in the warpgroup's first row's document, which need no segment
    // mask. Returns whether tile j needs one.
    const int* kseg = SEG ? p.kseg + static_cast<long long>(b) * p.Sk : nullptr;
    const int doc = SEG && qlo < p.Sq
                        ? __ldg(p.qseg + static_cast<long long>(b) * p.Sq + qlo)
                        : -1;
    const bool rows_one_doc =
        SEG && sm90::named_sync_and(1 + cw, 128, qseg[0] == doc && qseg[1] == doc);
    const int* ks = nullptr;
    auto stage_kseg = [&](int j) {
      if (!SEG) return false;
      const int t = threadIdx.x & 127;
      const int col = (kt0 + j) * kSmall + t;
      int* buf = ks_tile[cw][j & 1];
      const int id = t < kSmall && col < p.Sk ? __ldg(kseg + col) : -2;
      if (t < kSmall) buf[t] = id;
      ks = buf;
      return !sm90::named_sync_and(1 + cw, 128, rows_one_doc && (t >= kSmall || id == doc));
    };
    // a tile needs the mask when it holds a key past Sk, a key above this
    // warpgroup's first row's diagonal, or more than one document
    auto masked = [&](int k0, bool seg) {
      return seg || k0 + kSmall > p.Sk || (p.causal && k0 + kSmall - 1 > qlo + p.q_offset);
    };

    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
    float st[32], dp[32];
    uint32_t dsa[4][4];
    const unsigned char* qrows = sQ + cw * 64 * 128;  // this warpgroup's rows of each panel
    const unsigned char* dorows = sdO + cw * 64 * 128;
    // tile j's S and dP, issued and committed as one group
    auto issue_sdp = [&](int s) {
      sm90::wgmma_fence();
      issue_nt<HD>(st, qrows, sK(s));
      issue_nt<HD>(dp, dorows, sV(s));
      sm90::wgmma_commit();
    };
    // Ping-pong: the two warpgroups take turns issuing their products
    // (named barriers 3 and 4), so one's exp2 and dS run under the other's
    // wgmma; warpgroup 1 lets warpgroup 0 go first.
    auto my_turn = [&] { sm90::named_sync(3 + cw, 256); };
    auto your_turn = [&](int j) {
      if (cw == 0 || j + 1 < n_tiles) sm90::named_arrive(4 - cw, 256);
    };
    // tile j's P and dS, once its S and dP are done
    auto grads = [&](int j, bool seg) {
      const int k0 = (kt0 + j) * kSmall;
      sm90::fence_regs(st);
      sm90::fence_regs(dp);
      if (masked(k0, seg)) dq_mask(st, k0, row, qseg, ks, quad, p, seg);
      dq_probs(st, lse, p.scale_log2);
      dq_dscores(dp, st, delta);
    };

    if (n_tiles > 0) {
      if (cw == 1) sm90::named_arrive(3, 256);
      sm90::mbar_wait(&q_full, 0);
      sm90::mbar_wait(&full[0], 0);
      my_turn();
      issue_sdp(0);
      your_turn(0);
      const bool seg0 = stage_kseg(0);
      sm90::wgmma_wait<0>();
      grads(0, seg0);
      to_bf16(dsa, dp);
      // tile j: S_j and dP_j run beside dS_{j-1} K_{j-1}; tile j's P and dS
      // are computed while that product is still in flight
      for (int j = 1; j < n_tiles; ++j) {
        const int s = j % S;
        const int sp = (j - 1) % S;
        sm90::mbar_wait(&full[s], (j / S) & 1);
        my_turn();
        issue_sdp(s);
        sm90::wgmma_fence();
        issue_nn<HD>(dq, dsa, sK(sp));
        sm90::wgmma_commit();
        your_turn(j);
        const bool seg = stage_kseg(j);
        sm90::wgmma_wait<1>();  // S_j and dP_j are done
        grads(j, seg);
        sm90::wgmma_wait<0>();  // dS_{j-1} K_{j-1} is done
        sm90::fence_regs(dq);
        hold(dsa);
        if (lane == 0) sm90::mbar_arrive(&empty[sp]);
        to_bf16(dsa, dp);
      }
      const int sp = (n_tiles - 1) % S;
      sm90::wgmma_fence();
      issue_nn<HD>(dq, dsa, sK(sp));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      hold(dsa);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= p.Sq) continue;
      bf16* dst = p.o0.p + b * p.o0.b + static_cast<long long>(row[r]) * p.o0.s + h * p.o0.h;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8 + 2 * quad) = __floats2bfloat162_rn(
            dq[4 * n + 2 * r] * p.scale, dq[4 * n + 2 * r + 1] * p.scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV: the accumulators are transposed, rows are keys and columns queries

// P^T = 2^(s c - lse2[column]) in place (lse: the tile's staged rows)
__device__ __forceinline__ void dkv_probs(float (&s)[32], const float* lse, int quad, float c) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 l = *reinterpret_cast<const float2*>(lse + n * 8 + 2 * quad);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * n + e] = sm90::exp2_approx(fmaf(s[4 * n + e], c, -((e & 1) ? l.y : l.x)));
    }
  }
}

// dS^T = P^T (dP^T - delta[column]) in place of dP^T
__device__ __forceinline__ void dkv_dscores(float (&dp)[32], const float (&pr)[32],
                                            const float* delta, int quad) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 d = *reinterpret_cast<const float2*>(delta + n * 8 + 2 * quad);
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[4 * n + e] = pr[4 * n + e] * (dp[4 * n + e] - ((e & 1) ? d.y : d.x));
  }
}

// dead (key, query) pairs of the query tile at q0 to -inf (raw scores);
// seg: compare segment ids too (qs: the tile's staged query ids)
__device__ __forceinline__ void dkv_mask(float (&s)[32], int q0, const int (&krow)[2],
                                         const int (&kseg)[2], const int* qs, int quad,
                                         const BwdParams& p, bool seg) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int col = n * 8 + 2 * quad + (e & 1);
      bool live = krow[r] < p.Sk;
      if (live && p.causal) live = q0 + col + p.q_offset >= krow[r];
      if (live && seg) live = qs[col] == kseg[r];
      if (!live) s[4 * n + e] = -CUDART_INF_F;
    }
  }
}

template <int HD, bool SEG>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const BwdParams p) {
  using C = Cfg<HD>;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t kv_full, full[S], empty[S];
  // each stage's rows: lse2 (+inf where dead), delta, segment ids, the
  // first row's document and whether every row lies in it
  __shared__ __align__(16) float s_lse[S][kSmall];
  __shared__ __align__(16) float s_delta[S][kSmall];
  __shared__ int s_qseg[S][kSmall];
  __shared__ int s_qdoc[S];
  __shared__ bool s_qone[S];
  __shared__ int q_range[kThreads / 32][2];  // with segment ids: each warp's live Q tiles
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sK = smem;
  unsigned char* sV = smem + C::kBigTile;
  auto sQ = [&](int s) { return smem + 2 * C::kBigTile + 2 * s * C::kSmallTile; };
  auto sdO = [&](int s) { return sQ(s) + C::kSmallTile; };

  const int k0 = blockIdx.y * kBig;  // the first key tiles see the most queries: first
  const int b = blockIdx.x / p.Hkv;
  const int hk = blockIdx.x % p.Hkv;
  const int group = p.Hq / p.Hkv;
  // queries q see keys up to q + q_offset: the first live Q tile
  const int q_first = p.causal ? max(0, k0 - p.q_offset) : 0;
  int qt_begin = q_first / kSmall;  // the block walks Q tiles qt_begin .. + qt_count - 1
  int qt_count = q_first < p.Sq ? sm90::ceil_div(p.Sq, kSmall) - qt_begin : 0;
  if constexpr (SEG) {
    // The Q tiles that may hold a live pair, as one range, as in dQ: a Q
    // tile whose rows all lie in one document that none of the block's
    // keys is in (its keys lying in at most two) holds none.
    const int* qs = p.qseg + static_cast<long long>(b) * p.Sq;
    const int* ks = p.kseg + static_cast<long long>(b) * p.Sk;
    const int d0 = __ldg(ks + k0);  // k0 < Sk
    const int d1 = __ldg(ks + min(k0 + kBig, p.Sk) - 1);
    const int k = k0 + static_cast<int>(threadIdx.x);
    bool in_two = true;
    if (threadIdx.x < kBig && k < p.Sk) {
      const int d = __ldg(ks + k);
      in_two = d == d0 || d == d1;
    }
    const bool two_docs = __syncthreads_and(in_two);
    const int lane = threadIdx.x & 31;
    int lo = qt_begin + qt_count, hi = 0;  // this warp's live Q tiles
    for (int qt = qt_begin + (threadIdx.x >> 5); qt < qt_begin + qt_count; qt += kThreads / 32) {
      const int q0 = qt * kSmall;  // < Sq
      const int first = __ldg(qs + q0);
      const int a = q0 + lane < p.Sq ? __ldg(qs + q0 + lane) : first;
      const int c = q0 + 32 + lane < p.Sq ? __ldg(qs + q0 + 32 + lane) : first;
      const bool dead = two_docs && first != d0 && first != d1 &&
                        __all_sync(0xffffffffu, a == first && c == first);
      if (!dead) {
        lo = min(lo, qt);
        hi = qt + 1;
      }
    }
    if (lane == 0) {
      q_range[threadIdx.x >> 5][0] = lo;
      q_range[threadIdx.x >> 5][1] = hi;
    }
    __syncthreads();
    if (threadIdx.x < 32) {  // warp 0 merges the warps' ranges
      const bool w = lane < kThreads / 32;
      lo = __reduce_min_sync(0xffffffffu, w ? q_range[lane][0] : lo);
      hi = __reduce_max_sync(0xffffffffu, w ? q_range[lane][1] : 0);
      if (lane == 0) {
        q_range[0][0] = lo;
        q_range[0][1] = hi;
      }
    }
    __syncthreads();
    qt_begin = q_range[0][0];
    qt_count = max(q_range[0][1] - qt_begin, 0);
  }
  const int n_tiles = group * qt_count;  // (head, Q tile) pairs, head-major

  if (threadIdx.x == 0) {
    sm90::mbar_init(&kv_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1 + 32);  // the copies' and every producer lane's
      sm90::mbar_init(&empty[s], 8);      // one arrival per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = sm90::warpgroup_idx();
  if (wg == 2) {  // the producer warpgroup: warp 8 copies (lane 0) and stages rows
    sm90::setmaxnreg_dec<40>();
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < kConsumers + 32 && n_tiles > 0) {
      if (lane == 0) {
        sm90::prefetch_map(tq);
        sm90::prefetch_map(tdo);
        sm90::prefetch_map(tk);
        sm90::prefetch_map(tv);
        sm90::mbar_expect_tx(&kv_full, 2 * C::kBigTile);
#pragma unroll
        for (int c = 0; c < C::kPanels; ++c) {
          sm90::tma_load_4d(sK + c * kBigPanel, tk, &kv_full, c * 64, k0, hk, b);
          sm90::tma_load_4d(sV + c * kBigPanel, tv, &kv_full, c * 64, k0, hk, b);
        }
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % S;
        const int h = hk * group + i / qt_count;
        const int q0 = (qt_begin + i % qt_count) * kSmall;
        if (i >= S) sm90::mbar_wait(&empty[s], ((i / S) - 1) & 1);
        if (lane == 0) {
          sm90::mbar_expect_tx(&full[s], 2 * C::kSmallTile);
#pragma unroll
          for (int c = 0; c < C::kPanels; ++c) {
            sm90::tma_load_4d(sQ(s) + c * kSmallPanel, tq, &full[s], c * 64, q0, h, b);
            sm90::tma_load_4d(sdO(s) + c * kSmallPanel, tdo, &full[s], c * 64, q0, h, b);
          }
        }
        const long long rowbase = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
        const int* qseg = SEG ? p.qseg + static_cast<long long>(b) * p.Sq : nullptr;
        const int first = SEG ? __ldg(qseg + q0) : 0;  // q0 < Sq
        bool same = true;
#pragma unroll
        for (int r = lane; r < kSmall; r += 32) {
          const int q = q0 + r;
          const bool in = q < p.Sq;
          s_lse[s][r] = live_lse(in ? __ldg(p.lse + rowbase + q) : 0.f, in);
          s_delta[s][r] = in ? __ldg(p.delta + rowbase + q) : 0.f;
          if (SEG) {
            // a row past Sq has P = 0: it takes the tile's first id
            const int id = in ? __ldg(qseg + q) : first;
            s_qseg[s][r] = id;
            same = same && id == first;
          }
        }
        const bool one_doc = __all_sync(0xffffffffu, same);
        if (lane == 0) {
          s_qdoc[s] = first;
          s_qone[s] = one_doc;
        }
        sm90::mbar_arrive(&full[s]);
      }
    }
  } else {  // two consumer warpgroups of 64 keys
    sm90::setmaxnreg_inc<232>();
    const int cw = wg;
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const int quad = lane & 3;
    const int kw = k0 + cw * 64;  // this warpgroup's first key
    const int krow[2] = {kw + warp * 16 + (lane >> 2), kw + warp * 16 + (lane >> 2) + 8};
    int kseg[2] = {0, 0};
    int kdoc = -2;
    bool keys_one_doc = false;
    if (SEG) {
      const int* ks = p.kseg + static_cast<long long>(b) * p.Sk;
#pragma unroll
      for (int r = 0; r < 2; ++r) kseg[r] = krow[r] < p.Sk ? __ldg(ks + krow[r]) : -2;
      kdoc = kw < p.Sk ? __ldg(ks + kw) : -2;
      keys_one_doc = sm90::named_sync_and(1 + cw, 128, kseg[0] == kdoc && kseg[1] == kdoc);
    }

    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
    float st[32], dp[32];
    uint32_t pa[4][4], dsa[4][4];
    const unsigned char* krows = sK + cw * 64 * 128;  // this warpgroup's rows of each panel
    const unsigned char* vrows = sV + cw * 64 * 128;

    if (n_tiles > 0) sm90::mbar_wait(&kv_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % S;
      const int q0 = (qt_begin + i % qt_count) * kSmall;
      sm90::mbar_wait(&full[s], (i / S) & 1);
      // the queries and these keys all in one document each
      const bool one_doc = SEG && keys_one_doc && s_qone[s];
      // no live pair: every key past Sk, every query above the keys'
      // causal diagonal, or the queries and the keys in two documents
      if (kw >= p.Sk || (p.causal && q0 + kSmall - 1 + p.q_offset < kw) ||
          (one_doc && s_qdoc[s] != kdoc)) {
        if (lane == 0) sm90::mbar_arrive(&empty[s]);
        continue;
      }
      sm90::wgmma_fence();
      issue_nt<HD>(st, krows, sQ(s));  // S^T = K Q^T
      issue_nt<HD>(dp, vrows, sdO(s));  // dP^T = V dO^T
      sm90::wgmma_commit();
      // a tile needs the mask when it holds a key past Sk, a pair above the
      // causal diagonal, or more than one document
      const bool seg = SEG && !one_doc;
      const bool masked =
          seg || kw + 64 > p.Sk || (p.causal && q0 + p.q_offset < kw + 63);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(st);
      sm90::fence_regs(dp);
      if (masked) dkv_mask(st, q0, krow, kseg, s_qseg[s], quad, p, seg);
      dkv_probs(st, s_lse[s], quad, p.scale_log2);
      dkv_dscores(dp, st, s_delta[s], quad);
      to_bf16(pa, st);
      to_bf16(dsa, dp);
      sm90::wgmma_fence();
      issue_nn<HD>(dv, pa, sdO(s));  // dV += P^T dO
      issue_nn<HD>(dk, dsa, sQ(s));  // dK += dS^T Q
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
      hold(pa);
      hold(dsa);
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (krow[r] >= p.Sk) continue;
      bf16* dkp = p.o0.p + b * p.o0.b + static_cast<long long>(krow[r]) * p.o0.s + hk * p.o0.h;
      bf16* dvp = p.o1.p + b * p.o1.b + static_cast<long long>(krow[r]) * p.o1.s + hk * p.o1.h;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dkp + n * 8 + 2 * quad) = __floats2bfloat162_rn(
            dk[4 * n + 2 * r] * p.scale, dk[4 * n + 2 * r + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvp + n * 8 + 2 * quad) =
            __floats2bfloat162_rn(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
      }
    }
  }
}

// the [B, S, H, hd] tensor as a 4-d map {hd, S, H, B}, boxes of 64 x rows
template <int HD>
int qkv_map(CUtensorMap* map, const void* base, const long long* st, int B, int S, int H,
            int rows) {
  const uint64_t dims[4] = {HD, static_cast<uint64_t>(S), static_cast<uint64_t>(H),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(st[1]) * 2, static_cast<uint64_t>(st[2]) * 2,
                               static_cast<uint64_t>(st[0]) * 2};
  const uint32_t box[4] = {64, static_cast<uint32_t>(rows), 1, 1};
  return sm90::make_map<4>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

// dq: the dQ kernel (q and dO in 128-row boxes, k and v in 64-row ones), or
// the dK/dV kernel (the other way round)
template <int HD, bool SEG>
int launch(bool dq, const void* q, const void* k, const void* v, const void* dout,
           const long long* st, const BwdParams& p, int B, cudaStream_t stream) {
  using C = Cfg<HD>;
  const int qrows = dq ? kBig : kSmall;
  const int krows = dq ? kSmall : kBig;
  CUtensorMap tq, tdo, tk, tv;
  if (int rc = qkv_map<HD>(&tq, q, st, B, p.Sq, p.Hq, qrows)) return rc;
  if (int rc = qkv_map<HD>(&tk, k, st + 3, B, p.Sk, p.Hkv, krows)) return rc;
  if (int rc = qkv_map<HD>(&tv, v, st + 6, B, p.Sk, p.Hkv, krows)) return rc;
  if (int rc = qkv_map<HD>(&tdo, dout, st + 9, B, p.Sq, p.Hq, qrows)) return rc;
  if (dq) {
    static int attr = sm90::set_smem(flash_dq_kernel<HD, SEG>, C::kSmem);
    if (attr != 0) return attr;
    const dim3 grid(B * p.Hq, sm90::ceil_div(p.Sq, kBig));
    flash_dq_kernel<HD, SEG><<<grid, kThreads, C::kSmem, stream>>>(tq, tdo, tk, tv, p);
  } else {
    static int attr = sm90::set_smem(flash_dkv_kernel<HD, SEG>, C::kSmem);
    if (attr != 0) return attr;
    const dim3 grid(B * p.Hkv, sm90::ceil_div(p.Sk, kBig));
    flash_dkv_kernel<HD, SEG><<<grid, kThreads, C::kSmem, stream>>>(tq, tdo, tk, tv, p);
  }
  return static_cast<int>(cudaGetLastError());
}

int run(bool dq, const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, const void* qseg, const void* kseg, Out o0, Out o1,
        const long long* st, int B, int Sq, int Sk, int Hq, int Hkv, int hd, int causal,
        int q_offset, float scale_log2, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || sm90::ceil_div(dq ? Sq : Sk, kBig) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdParams p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.o0 = o0;
  p.o1 = o1;
  p.Sq = Sq;
  p.Sk = Sk;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.causal = causal;
  p.q_offset = q_offset;
  p.scale_log2 = scale_log2;
  p.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  const bool seg = p.qseg != nullptr;
  if (hd == 128) {
    return seg ? launch<128, true>(dq, q, k, v, dout, st, p, B, s)
               : launch<128, false>(dq, q, k, v, dout, st, p, B, s);
  }
  if (hd == 64) {
    return seg ? launch<64, true>(dq, q, k, v, dout, st, p, B, s)
               : launch<64, false>(dq, q, k, v, dout, st, p, B, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// strides: 15 element strides, (batch, seq, head) of q, k, v, dO and dQ.
// Returns a CUDA error code (0 on success). The caller has checked dtypes
// (bf16 tensors, f32 lse/delta [B, Hq, Sq] contiguous), shapes, devices,
// unit stride on hd, 16-byte aligned bases and strides that are multiples
// of 8 elements (TMA's 16 bytes).
extern "C" int flash_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, const void* qseg,
                               const void* kseg, void* dq, const long long* strides, int B,
                               int Sq, int Sk, int Hq, int Hkv, int hd, int causal,
                               int q_offset, float scale_log2, float scale, void* stream) {
  const Out o{static_cast<bf16*>(dq), strides[12], strides[13], strides[14]};
  return run(true, q, k, v, dout, lse, delta, qseg, kseg, o, o, strides, B, Sq, Sk, Hq, Hkv, hd,
             causal, q_offset, scale_log2, scale, stream);
}

// strides: 18 element strides, (batch, seq, head) of q, k, v, dO, dK and dV.
extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, const void* qseg,
                                const void* kseg, void* dk, void* dv, const long long* strides,
                                int B, int Sq, int Sk, int Hq, int Hkv, int hd, int causal,
                                int q_offset, float scale_log2, float scale, void* stream) {
  const Out ok{static_cast<bf16*>(dk), strides[12], strides[13], strides[14]};
  const Out ov{static_cast<bf16*>(dv), strides[15], strides[16], strides[17]};
  return run(false, q, k, v, dout, lse, delta, qseg, kseg, ok, ov, strides, B, Sq, Sk, Hq, Hkv,
             hd, causal, q_offset, scale_log2, scale, stream);
}
