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
// Here a block of 4 warps owns 64 queries of one (batch, head) and loops
// over the K/V tiles of 64 keys it can see: the causal limit is the loop
// bound, so dead tiles are never visited. Each warp holds its 16 rows' Q
// fragments, scores, and output accumulator in registers; K and V tiles are
// staged in shared memory by cp.async (V lands while the scores are being
// computed) and read by ldmatrix. Products are mma.sync m16n8k16 (bf16 in,
// f32 accumulate); P goes from the score accumulators straight into the
// A fragments of P.V. The mask is evaluated only on tiles that need it
// (ragged end, diagonal, segment ids), the counterpart of
// _block_full/_dispatch_body. Strides come from the tensors, so no
// transposition or padding copy is made; the grid walks the heaviest
// (last) query tiles first. wgmma, TMA and warp specialisation are left to
// later work.

#include "flash_common.cuh"

namespace {

using flash::bf16;
using flash::kRows;
using flash::kThreads;

struct FwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* qseg;  // null without segment ids
  const int* kseg;
  bf16* out;
  float* lse;
  flash::Strides qs, ks, vs, os;
  int Sq, Sk, Hq, Hkv;
  int causal, q_offset;
  float scale_log2;  // hd^-0.5 * log2(e)
};

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FwdParams p) {
  constexpr int LD = HD + flash::kPad;
  constexpr int NT = kRows / 8;  // n-tiles of scores per warp row block
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kRows * LD;
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
  int qseg[2] = {0, 0};
  if (has_seg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) qseg[r] = row[r] < p.Sq ? p.qseg[b * p.Sq + row[r]] : -1;
  }

  const bf16* Q = p.q + b * p.qs.b + h * p.qs.h;
  const bf16* K = p.k + b * p.ks.b + hk * p.ks.h;
  const bf16* V = p.v + b * p.vs.b + hk * p.vs.h;

  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, q0 + kRows + p.q_offset);
  const int n_tiles = kv_end > 0 ? flash::ceil_div(kv_end, kRows) : 0;

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {flash::kNegInf, flash::kNegInf};
  float l[2] = {0.f, 0.f};
  uint32_t qa[HD / 16][4];

  flash::load_tile<HD>(sQ, Q, p.qs.s, q0, p.Sq);
  flash::cp_async_commit();

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kRows;
    __syncthreads();  // the previous tile's K/V reads are done
    flash::load_tile<HD>(sK, K, p.ks.s, k0, p.Sk);
    flash::cp_async_commit();
    flash::load_tile<HD>(sV, V, p.vs.s, k0, p.Sk);
    flash::cp_async_commit();
    if (has_seg && threadIdx.x < kRows) {
      const int kk = k0 + threadIdx.x;
      sKseg[threadIdx.x] = kk < p.Sk ? p.kseg[b * p.Sk + kk] : -2;
    }
    flash::cp_async_wait<1>();  // Q (first tile) and K have landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) flash::frag_a<LD>(qa[kc], sQ, warp * 16, kc * 16);
    }

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t bk[4];
        flash::frag_b_nk<LD>(bk, sK, nn * 16, kc * 16);
        flash::mma(s[2 * nn], qa[kc], bk[0], bk[1]);
        flash::mma(s[2 * nn + 1], qa[kc], bk[2], bk[3]);
      }
    }

    const bool masked = has_seg || k0 + kRows > p.Sk ||
                        (p.causal && k0 + kRows - 1 > q0 + p.q_offset);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * p.scale_log2;
        if (masked) {
          const int r = e >> 1;
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          const int ks = has_seg ? sKseg[col - k0] : 0;
          if (!flash::live(row[r], col, 0x7fffffff, p.Sk, p.causal, p.q_offset, qseg[r], ks,
                           has_seg))
            x = flash::kNegInf;
        }
        s[n][e] = x;
      }
    }

    // online softmax, base 2; a masked score gives p = 0 even on a row
    // whose running max is still the mask value
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = flash::kNegInf;
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      const float m_new = fmaxf(m[r], flash::quad_max(mx));
      const float alpha = exp2f(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float x = s[n][e];
          const float pe = x == flash::kNegInf ? 0.f : exp2f(x - m_new);
          s[n][e] = pe;
          sum += pe;
        }
      }
      l[r] = l[r] * alpha + sum;  // this lane's share of the row sum
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

    flash::cp_async_wait<0>();  // V has landed
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < kRows / 16; ++kc) {
      uint32_t pa[4];
      flash::acc_to_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int nn = 0; nn < HD / 16; ++nn) {
        uint32_t bv[4];
        flash::frag_b_kn<LD>(bv, sV, kc * 16, nn * 16);
        flash::mma(o[2 * nn], pa, bv[0], bv[1]);
        flash::mma(o[2 * nn + 1], pa, bv[2], bv[3]);
      }
    }
  }
  flash::cp_async_wait<0>();  // a block with no live tile still drains Q

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lt = flash::quad_sum(l[r]);
    const float l_safe = lt == 0.f ? 1.f : lt;
    const float inv = 1.f / l_safe;
    if (row[r] < p.Sq) {
      bf16* dst = p.out + b * p.os.b + static_cast<long long>(row[r]) * p.os.s + h * p.os.h;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        flash::store2(dst + n * 8 + 2 * t, o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
      }
      if (t == 0) {
        p.lse[(static_cast<long long>(b) * p.Hq + h) * p.Sq + row[r]] = m[r] + log2f(l_safe);
      }
    }
  }
}

template <int HD>
int launch(const FwdParams& p, int B, cudaStream_t stream) {
  constexpr int kSmem = 3 * kRows * (HD + flash::kPad) * sizeof(bf16);
  static int attr = flash::set_smem(flash_fwd_kernel<HD>, kSmem);
  if (attr != 0) return attr;
  const dim3 grid(flash::ceil_div(p.Sq, kRows), B * p.Hq);
  flash_fwd_kernel<HD><<<grid, kThreads, kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) of q, k, v and out.
// Returns a CUDA error code (0 on success). The caller has checked dtypes
// (bf16), shapes, devices and 16-byte alignment.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, const void* qseg,
                                const void* kseg, void* out, void* lse,
                                const long long* strides, int B, int Sq, int Sk, int Hq,
                                int Hkv, int hd, int causal, int q_offset, float scale_log2,
                                void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B * Hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.qs = {strides[0], strides[1], strides[2]};
  p.ks = {strides[3], strides[4], strides[5]};
  p.vs = {strides[6], strides[7], strides[8]};
  p.os = {strides[9], strides[10], strides[11]};
  p.Sq = Sq;
  p.Sk = Sk;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.causal = causal;
  p.q_offset = q_offset;
  p.scale_log2 = scale_log2;
  auto st = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch<128>(p, B, st);
  if (hd == 64) return launch<64>(p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
