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
// Design. dQ: a block owns 64 queries of one (batch, query head), keeps
// their Q and dO tiles in shared memory and loops over the live K/V tiles
// (the causal limit is the loop bound), accumulating dQ in f32 registers.
// dK/dV: a block owns 64 keys of one (batch, KV head), keeps their K and V
// tiles in shared memory and loops over every query head of the GQA group
// and every live Q tile, accumulating dK and dV in f32 registers; it writes
// each once, with no atomics, so the result is deterministic, as the TPU
// kernel's VMEM accumulation across its (k-block, group, q-block) walk is.
// Each warp owns 16 rows; products are mma.sync m16n8k16 (bf16 in, f32
// accumulate) on ldmatrix fragments; tiles arrive by cp.async; the mask is
// evaluated only on tiles that need it. wgmma, TMA and warp specialisation
// are left to later work.

#include "flash_common.cuh"

namespace {

using flash::bf16;
using flash::kRows;
using flash::kThreads;

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  const int* qseg;  // null without segment ids
  const int* kseg;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  flash::Strides qs, ks, vs, ds, dqs, dks, dvs;
  int Sq, Sk, Hq, Hkv;
  int causal, q_offset;
  float scale_log2;  // hd^-0.5 * log2(e)
  float scale;       // hd^-0.5
};

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const BwdParams p) {
  constexpr int LD = HD + flash::kPad;
  constexpr int NT = kRows / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + kRows * LD;
  bf16* sK = sdO + kRows * LD;
  bf16* sV = sK + kRows * LD;
  __shared__ int sKseg[kRows];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest tiles first
  const int b = blockIdx.y / p.Hq;
  const int h = blockIdx.y % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int row[2] = {q0 + warp * 16 + (lane >> 2), q0 + warp * 16 + (lane >> 2) + 8};
  const bool has_seg = p.qseg != nullptr;
  const long long rowbase = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
  float lse[2], delta[2];
  int qseg[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < p.Sq;
    lse[r] = in ? p.lse[rowbase + row[r]] : 0.f;
    delta[r] = in ? p.delta[rowbase + row[r]] : 0.f;
    if (has_seg) qseg[r] = in ? p.qseg[b * p.Sq + row[r]] : -1;
  }

  const bf16* K = p.k + b * p.ks.b + hk * p.ks.h;
  const bf16* V = p.v + b * p.vs.b + hk * p.vs.h;
  flash::load_tile<HD>(sQ, p.q + b * p.qs.b + h * p.qs.h, p.qs.s, q0, p.Sq);
  flash::load_tile<HD>(sdO, p.dout + b * p.ds.b + h * p.ds.h, p.ds.s, q0, p.Sq);
  flash::cp_async_commit();

  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, q0 + kRows + p.q_offset);
  const int n_tiles = kv_end > 0 ? flash::ceil_div(kv_end, kRows) : 0;

  float dq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kRows;
    __syncthreads();
    flash::load_tile<HD>(sK, K, p.ks.s, k0, p.Sk);
    flash::cp_async_commit();
    flash::load_tile<HD>(sV, V, p.vs.s, k0, p.Sk);
    flash::cp_async_commit();
    if (has_seg && threadIdx.x < kRows) {
      const int kk = k0 + threadIdx.x;
      sKseg[threadIdx.x] = kk < p.Sk ? p.kseg[b * p.Sk + kk] : -2;
    }
    flash::cp_async_wait<1>();  // Q, dO and K have landed
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t a[4];
      flash::frag_a<LD>(a, sQ, warp * 16, kc * 16);
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t bk[4];
        flash::frag_b_nk<LD>(bk, sK, nn * 16, kc * 16);
        flash::mma(s[2 * nn], a, bk[0], bk[1]);
        flash::mma(s[2 * nn + 1], a, bk[2], bk[3]);
      }
    }
    const bool masked = has_seg || k0 + kRows > p.Sk ||
                        (p.causal && k0 + kRows - 1 > q0 + p.q_offset);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        bool on = true;
        if (masked) {
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          on = flash::live(row[r], col, p.Sq, p.Sk, p.causal, p.q_offset, qseg[r],
                           has_seg ? sKseg[col - k0] : 0, has_seg);
        }
        s[n][e] = on ? exp2f(s[n][e] * p.scale_log2 - lse[r]) : 0.f;
      }
    }

    flash::cp_async_wait<0>();  // V has landed
    __syncthreads();
    float dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t a[4];
      flash::frag_a<LD>(a, sdO, warp * 16, kc * 16);
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t bv[4];
        flash::frag_b_nk<LD>(bv, sV, nn * 16, kc * 16);
        flash::mma(dp[2 * nn], a, bv[0], bv[1]);
        flash::mma(dp[2 * nn + 1], a, bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= dp[n][e] - delta[e >> 1];  // ds
    }
#pragma unroll
    for (int kc = 0; kc < kRows / 16; ++kc) {
      uint32_t a[4];
      flash::acc_to_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int nn = 0; nn < HD / 16; ++nn) {
        uint32_t bk[4];
        flash::frag_b_kn<LD>(bk, sK, kc * 16, nn * 16);
        flash::mma(dq[2 * nn], a, bk[0], bk[1]);
        flash::mma(dq[2 * nn + 1], a, bk[2], bk[3]);
      }
    }
  }
  flash::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.Sq) continue;
    bf16* dst = p.dq + b * p.dqs.b + static_cast<long long>(row[r]) * p.dqs.s + h * p.dqs.h;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      flash::store2(dst + n * 8 + 2 * t, dq[n][2 * r] * p.scale, dq[n][2 * r + 1] * p.scale);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(const BwdParams p) {
  constexpr int LD = HD + flash::kPad;
  constexpr int QH = 32;  // queries per inner step (keeps scores at 16 registers)
  constexpr int NT = QH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kRows * LD;
  bf16* sQ = sV + kRows * LD;
  bf16* sdO = sQ + kRows * LD;
  __shared__ float sLse[kRows];
  __shared__ float sDelta[kRows];
  __shared__ int sQseg[kRows];

  const int k0 = blockIdx.x * kRows;  // the first key tiles see the most queries
  const int b = blockIdx.y / p.Hkv;
  const int hk = blockIdx.y % p.Hkv;
  const int group = p.Hq / p.Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int krow[2] = {k0 + warp * 16 + (lane >> 2), k0 + warp * 16 + (lane >> 2) + 8};
  const bool has_seg = p.qseg != nullptr;
  int kseg[2] = {0, 0};
  if (has_seg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) kseg[r] = krow[r] < p.Sk ? p.kseg[b * p.Sk + krow[r]] : -2;
  }

  flash::load_tile<HD>(sK, p.k + b * p.ks.b + hk * p.ks.h, p.ks.s, k0, p.Sk);
  flash::load_tile<HD>(sV, p.v + b * p.vs.b + hk * p.vs.h, p.vs.s, k0, p.Sk);
  flash::cp_async_commit();

  // queries q see keys up to q + q_offset: the first live Q tile
  const int q_first = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int qt_begin = q_first / kRows;
  const int qt_end = q_first < p.Sq ? flash::ceil_div(p.Sq, kRows) : 0;

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const bf16* Q = p.q + b * p.qs.b + h * p.qs.h;
    const bf16* dO = p.dout + b * p.ds.b + h * p.ds.h;
    const long long rowbase = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kRows;
      __syncthreads();  // the previous tile's reads are done
      flash::load_tile<HD>(sQ, Q, p.qs.s, q0, p.Sq);
      flash::load_tile<HD>(sdO, dO, p.ds.s, q0, p.Sq);
      flash::cp_async_commit();
      if (threadIdx.x < kRows) {
        const int qq = q0 + threadIdx.x;
        const bool in = qq < p.Sq;
        sLse[threadIdx.x] = in ? p.lse[rowbase + qq] : 0.f;
        sDelta[threadIdx.x] = in ? p.delta[rowbase + qq] : 0.f;
        if (has_seg) sQseg[threadIdx.x] = in ? p.qseg[b * p.Sq + qq] : -1;
      }
      flash::cp_async_wait<0>();
      __syncthreads();
      const bool masked = has_seg || k0 + kRows > p.Sk || q0 + kRows > p.Sq ||
                          (p.causal && k0 + kRows - 1 > q0 + p.q_offset);

#pragma unroll 1
      for (int qh = 0; qh < kRows / QH; ++qh) {
        const int c0 = qh * QH;  // first query column of this step in the tile
        // P^T: 16 keys (rows) by 32 queries (columns) per warp
        float s[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kc = 0; kc < HD / 16; ++kc) {
          uint32_t a[4];
          flash::frag_a<LD>(a, sK, warp * 16, kc * 16);
#pragma unroll
          for (int nn = 0; nn < NT / 2; ++nn) {
            uint32_t bq[4];
            flash::frag_b_nk<LD>(bq, sQ, c0 + nn * 16, kc * 16);
            flash::mma(s[2 * nn], a, bq[0], bq[1]);
            flash::mma(s[2 * nn + 1], a, bq[2], bq[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ql = c0 + n * 8 + 2 * t + (e & 1);
            bool on = true;
            if (masked) {
              on = flash::live(q0 + ql, krow[e >> 1], p.Sq, p.Sk, p.causal, p.q_offset,
                               has_seg ? sQseg[ql] : 0, kseg[e >> 1], has_seg);
            }
            s[n][e] = on ? exp2f(s[n][e] * p.scale_log2 - sLse[ql]) : 0.f;
          }
        }
        // dV += P^T dO
#pragma unroll
        for (int kc = 0; kc < QH / 16; ++kc) {
          uint32_t a[4];
          flash::acc_to_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
          for (int nn = 0; nn < HD / 16; ++nn) {
            uint32_t bo[4];
            flash::frag_b_kn<LD>(bo, sdO, c0 + kc * 16, nn * 16);
            flash::mma(dv[2 * nn], a, bo[0], bo[1]);
            flash::mma(dv[2 * nn + 1], a, bo[2], bo[3]);
          }
        }
        // dP^T = V dO^T, then dS^T = P^T (dP^T - delta)
        float dp[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
        for (int kc = 0; kc < HD / 16; ++kc) {
          uint32_t a[4];
          flash::frag_a<LD>(a, sV, warp * 16, kc * 16);
#pragma unroll
          for (int nn = 0; nn < NT / 2; ++nn) {
            uint32_t bo[4];
            flash::frag_b_nk<LD>(bo, sdO, c0 + nn * 16, kc * 16);
            flash::mma(dp[2 * nn], a, bo[0], bo[1]);
            flash::mma(dp[2 * nn + 1], a, bo[2], bo[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] *= dp[n][e] - sDelta[c0 + n * 8 + 2 * t + (e & 1)];
          }
        }
        // dK += dS^T Q
#pragma unroll
        for (int kc = 0; kc < QH / 16; ++kc) {
          uint32_t a[4];
          flash::acc_to_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
          for (int nn = 0; nn < HD / 16; ++nn) {
            uint32_t bq[4];
            flash::frag_b_kn<LD>(bq, sQ, c0 + kc * 16, nn * 16);
            flash::mma(dk[2 * nn], a, bq[0], bq[1]);
            flash::mma(dk[2 * nn + 1], a, bq[2], bq[3]);
          }
        }
      }
    }
  }
  flash::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= p.Sk) continue;
    bf16* dkp = p.dk + b * p.dks.b + static_cast<long long>(krow[r]) * p.dks.s + hk * p.dks.h;
    bf16* dvp = p.dv + b * p.dvs.b + static_cast<long long>(krow[r]) * p.dvs.s + hk * p.dvs.h;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      flash::store2(dkp + n * 8 + 2 * t, dk[n][2 * r] * p.scale, dk[n][2 * r + 1] * p.scale);
      flash::store2(dvp + n * 8 + 2 * t, dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* qseg, const void* kseg,
                      void* dq, void* dk, void* dv, const long long* st, int Sq, int Sk,
                      int Hq, int Hkv, int causal, int q_offset, float scale_log2,
                      float scale) {
  BwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.qs = {st[0], st[1], st[2]};
  p.ks = {st[3], st[4], st[5]};
  p.vs = {st[6], st[7], st[8]};
  p.ds = {st[9], st[10], st[11]};
  p.dqs = {st[12], st[13], st[14]};  // dq, or dk for the dK/dV kernel
  p.dks = {st[12], st[13], st[14]};
  p.dvs = {st[15], st[16], st[17]};
  p.Sq = Sq;
  p.Sk = Sk;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.causal = causal;
  p.q_offset = q_offset;
  p.scale_log2 = scale_log2;
  p.scale = scale;
  return p;
}

template <int HD>
int launch_dq(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr int kSmem = 4 * kRows * (HD + flash::kPad) * sizeof(bf16);
  static int attr = flash::set_smem(flash_dq_kernel<HD>, kSmem);
  if (attr != 0) return attr;
  const dim3 grid(flash::ceil_div(p.Sq, kRows), B * p.Hq);
  flash_dq_kernel<HD><<<grid, kThreads, kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dkv(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr int kSmem = 4 * kRows * (HD + flash::kPad) * sizeof(bf16);
  static int attr = flash::set_smem(flash_dkv_kernel<HD>, kSmem);
  if (attr != 0) return attr;
  const dim3 grid(flash::ceil_div(p.Sk, kRows), B * p.Hkv);
  flash_dkv_kernel<HD><<<grid, kThreads, kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int Hq, int Hkv) {
  return Hkv <= 0 || Hq % Hkv != 0 || B * Hq > 65535;
}

}  // namespace

// strides: 15 element strides, (batch, seq, head) of q, k, v, dO and dQ.
// Returns a CUDA error code (0 on success). The caller has checked dtypes
// (bf16 tensors, f32 lse/delta [B, Hq, Sq] contiguous), shapes, devices and
// 16-byte alignment.
extern "C" int flash_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, const void* qseg,
                               const void* kseg, void* dq, const long long* strides, int B,
                               int Sq, int Sk, int Hq, int Hkv, int hd, int causal,
                               int q_offset, float scale_log2, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (bad_shape(B, Hq, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  long long st[18];
  for (int i = 0; i < 15; ++i) st[i] = strides[i];
  st[15] = st[16] = st[17] = 0;
  const BwdParams p = make_params(q, k, v, dout, lse, delta, qseg, kseg, dq, nullptr, nullptr,
                                  st, Sq, Sk, Hq, Hkv, causal, q_offset, scale_log2, scale);
  auto s = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_dq<128>(p, B, s);
  if (hd == 64) return launch_dq<64>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// strides: 18 element strides, (batch, seq, head) of q, k, v, dO, dK and dV.
extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, const void* qseg,
                                const void* kseg, void* dk, void* dv, const long long* strides,
                                int B, int Sq, int Sk, int Hq, int Hkv, int hd, int causal,
                                int q_offset, float scale_log2, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (bad_shape(B, Hq, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p = make_params(q, k, v, dout, lse, delta, qseg, kseg, nullptr, dk, dv,
                                  strides, Sq, Sk, Hq, Hkv, causal, q_offset, scale_log2, scale);
  auto s = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_dkv<128>(p, B, s);
  if (hd == 64) return launch_dkv<64>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
