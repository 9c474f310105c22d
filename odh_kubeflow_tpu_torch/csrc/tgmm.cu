// Per-expert weight gradient of the grouped matmul for Hopper (sm_90a).
//
// Replaces _tgmm_kernel of odh_kubeflow_tpu/ops/pallas_grouped_matmul.py
// (pallas_call in _tgmm): for every expert e,
//
//   out[e] = lhs[rows_e]^T @ dout[rows_e]      rows_e = [offsets[e], offsets[e+1])
//
// lhs bf16 [M, K], dout bf16 [M, N], out bf16 [E, K, N], f32 sums rounded
// once, zeros for an expert that owns no row. offsets as in gmm.cu: int32
// [E + 1], offsets[0] = 0, offsets[E] = M, every entry a multiple of 128,
// so the tail past the last real group belongs to expert E-1, as in the TPU
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
// the kernel is grouped_sm90.cuh's persistent product (TMA ring, wgmma,
// setmaxnreg; TgmmOps below): an output tile is 128 rows (of K) x BW
// columns (of N, 256 or 128 by tile_width) of one expert's [K, N], and its
// contraction is that expert's rows, (offsets[e+1] - offsets[e]) / 64
// chunks of 64 rows, which the producer and the consumers each count from
// offsets. A chunk is the lhs rows' 128 columns of the tile, two 64 x 64
// TMA boxes, each an MN-major A panel of one consumer warpgroup (lhs^T
// through wgmma's transposed A), and the dout rows' BW columns, 64-column
// panels as gmm's bf16 bank (an MN-major B). Tiles are walked expert by
// expert, each expert's in Sched's order (groups of 8 K-tiles, column block
// by column block), so the blocks sweep one expert's rows of lhs and dout
// while they sit in L2. An empty expert's tiles issue no product and
// write zeros. No rows split across blocks and no atomics: every output
// element is written once, by one block, so two launches agree bit for bit.
// With all rows on one expert, that expert's K/128 x N/BW tiles still
// spread over every SM.

#include "grouped_sm90.cuh"

namespace {

using grouped::bf16;

// The operands: lhs^T (A, MN-major) and dout (B, MN-major) chunks of one
// expert's rows; tiles expert-major, then Sched over (K-tiles, N-tiles).
template <int BW>
struct TgmmOps {
  using C = grouped::Cfg<BW, false, bf16>;
  static constexpr bool kTransA = true, kTransB = false;
  const CUtensorMap* tl;  // lhs [M, K] in 64 x 64 boxes
  const CUtensorMap* td;  // dout [M, N] in 64 x 64 boxes
  const int* offsets;
  grouped::Sched sched;  // K-tiles x N-tiles of one expert
  int K, N, E;

  __device__ __forceinline__ int tiles() const { return E * sched.count(); }

  __device__ __forceinline__ grouped::Tile tile(int t) const {
    const int per = sched.count();
    const int e = t / per;
    int kt, nt;
    sched.coords(t - e * per, kt, nt);
    const int start = __ldg(offsets + e);
    return {kt * grouped::kBM, nt * BW, e, (__ldg(offsets + e + 1) - start) / grouped::kBK,
            start};
  }

  __device__ __forceinline__ void prefetch() const {
    sm90::prefetch_map(*tl);
    sm90::prefetch_map(*td);
  }

  // rows first + 64 kc ..: lhs columns m0.. (panels past K left out) and
  // dout columns n0.. (panels past N left out); the products of a missing
  // panel land in rows or columns the epilogue never stores
  __device__ __forceinline__ void load(unsigned char* st, uint64_t* bar, const grouped::Tile& t,
                                       int kc) const {
    const int r0 = t.first + kc * grouped::kBK;
    int bytes = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) bytes += t.m0 + 64 * h < K ? grouped::kPanel : 0;
#pragma unroll
    for (int p = 0; p < BW / 64; ++p) bytes += t.n0 + 64 * p < N ? grouped::kPanel : 0;
    sm90::mbar_expect_tx(bar, bytes);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (t.m0 + 64 * h < K) sm90::tma_load_2d(st + h * grouped::kPanel, *tl, bar, t.m0 + 64 * h, r0);
    }
#pragma unroll
    for (int p = 0; p < BW / 64; ++p) {
      if (t.n0 + 64 * p < N) {
        sm90::tma_load_2d(st + C::kX + p * grouped::kPanel, *td, bar, t.n0 + 64 * p, r0);
      }
    }
  }
};

// out[e][m0 + row][n0 + col] = bf16(acc), 16 bytes a store
// (quad_transpose), or zeros for an expert with no row (load tells, as the
// tile starts: its accumulators were never written); rows past K and
// columns past N not stored.
template <int BN>
struct TgmmEpi {
  bf16* out;
  const int* offsets;
  int K;

  __device__ __forceinline__ float load(int, int, int e, int) const {
    return __ldg(offsets + e + 1) > __ldg(offsets + e) ? 1.f : 0.f;
  }

  __device__ __forceinline__ void operator()(const float (&acc)[BN / 2], int m0, int n0, int e,
                                             int N, float rows_in, float*) const {
    const grouped::Frag f = grouped::frag();
    const int row = m0 + f.row0;
    const bool empty = rows_in == 0.f;
    bf16* rows = out + (static_cast<long long>(e) * K + row) * N;
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += 4) {
      uint32_t w[2][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + jj;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          w[r][jj] = empty ? 0u : sm90::pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        }
      }
      const int col = n0 + 8 * (j0 + f.quad);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint4 v4 = grouped::quad_transpose(w[r]);
        if (col < N && row + 8 * r < K) {
          *reinterpret_cast<uint4*>(rows + static_cast<long long>(8 * r) * N + col) = v4;
        }
      }
    }
  }
};

template <int BW>
__global__ void __launch_bounds__(grouped::kThreads, 1)
    tgmm_kernel(const __grid_constant__ CUtensorMap tl, const __grid_constant__ CUtensorMap td,
                const TgmmEpi<BW> epi, const int* __restrict__ offsets, grouped::Sched sched,
                int K, int N, int E) {
  const TgmmOps<BW> ops{&tl, &td, offsets, sched, K, N, E};
  grouped::persistent_product(ops, epi);
}

// K-tiles x N-tiles of one expert's [K, N] in 128 x BW tiles
grouped::Sched schedule(int K, int N, int BW) {
  return {sm90::ceil_div(K, grouped::kBM), sm90::ceil_div(N, BW)};
}

// the tile width: gmm's rule over the E stacked [K, N] results
int tile_width(int K, int N, int E, int sms) {
  return grouped::tile_width(E * sm90::ceil_div(K, grouped::kBM) * grouped::kBM, N, sms);
}

template <int BW>
int launch(const bf16* lhs, const bf16* dout, const int* offsets, bf16* out, int M, int K, int N,
           int E, cudaStream_t stream) {
  constexpr int kSmem = TgmmOps<BW>::C::kSmem;
  static int attr = sm90::set_smem(tgmm_kernel<BW>, kSmem);
  if (attr != 0) return attr;
  CUtensorMap tl, td;
  if (int rc = grouped::rows_map(&tl, lhs, M, K, grouped::kBK)) return rc;
  if (int rc = grouped::rows_map(&td, dout, M, N, grouped::kBK)) return rc;
  const grouped::Sched sched = schedule(K, N, BW);
  tgmm_kernel<BW><<<grouped::launch_grid(E * sched.count()), grouped::kThreads, kSmem, stream>>>(
      tl, td, TgmmEpi<BW>{out, offsets, K}, offsets, sched, K, N, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a CUDA error code (0 on success). The caller has checked dtypes,
// shapes (M % 128, K % 16, N % 16), contiguity, one device and 16-byte
// aligned bases.
extern "C" int tgmm_launch(const void* lhs, const void* dout, const void* offsets, void* out,
                           int M, int K, int N, int E, void* stream) {
  if (K <= 0 || N <= 0 || E <= 0) return 0;
  if (M < 0 || M % grouped::kBM || K % 16 || N % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (M == 0) {  // every expert empty
    return static_cast<int>(
        cudaMemsetAsync(out, 0, static_cast<size_t>(E) * K * N * sizeof(bf16), st));
  }
  const auto* l = static_cast<const bf16*>(lhs);
  const auto* d = static_cast<const bf16*>(dout);
  const auto* o = static_cast<const int*>(offsets);
  auto* y = static_cast<bf16*>(out);
  return tile_width(K, N, E, grouped::sm_count()) == 256
             ? launch<256>(l, d, o, y, M, K, N, E, st)
             : launch<128>(l, d, o, y, M, K, N, E, st);
}

// The schedule tgmm_launch takes, for its Python mirror's test on the card:
// the output tile width on `sms` SMs, and the persistent tile order,
// (expert, K-tile, N-tile) of tile t at out[3t..].
extern "C" int tgmm_tile_width(int K, int N, int E, int sms) { return tile_width(K, N, E, sms); }

extern "C" void tgmm_tile_order(int E, int k_tiles, int n_tiles, int* out) {
  const grouped::Sched sched{k_tiles, n_tiles};
  const int per = sched.count();
  for (int t = 0; t < E * per; ++t) {
    out[3 * t] = t / per;
    sched.coords(t % per, out[3 * t + 1], out[3 * t + 2]);
  }
}
