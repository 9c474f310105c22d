// The grouped product on Hopper's own machinery (sm90_common.cuh): one
// persistent, warp-specialised wgmma product, f32 accumulators in
// registers, shared by
//   gmm.cu        (gmm_kernel, four instances: bf16 rows times an expert
//                  bank, int8 or bf16, in either orientation; BankOps),
//   swiglu_gmm.cu (the forward, BankOps; the backward uses widen_strided
//                  and tile_expert),
//   tgmm.cu       (the expert weight gradient lhs^T . dout: TgmmOps, an
//                  MN-major A operand).
// Each caller describes its operands with an Ops type (BankOps below) and
// its epilogue with an Epi type; the ring, the roles and the products are
// here. int4_matmul.cu's forward uses Sched, rows_map and the launch
// helpers.
//
// Contract of BankOps (checked by the Python wrappers, ops/grouped_matmul.py):
//   x       bf16 [M, K] row-major, M % 128 == 0, K % 16 == 0;
//   bank    W = int8_t or bf16, [E, K, N] (TRANS = false) or [E, N, K]
//           (TRANS = true), N % 16 == 0;
//   offsets int32 [E + 1], offsets[0] = 0, offsets[E] = M, every entry a
//           multiple of 128, nondecreasing. So each 128-row tile lies in
//           exactly one expert's group (empty groups own no tile), and a
//           block finds that expert itself (tile_expert).
//
// Work. An output tile is 128 rows by BN columns. The B operand of one
// tile is BW = NB * BN columns wide: NB = 1, or 2 for the SwiGLU forward,
// whose B is [gate BN | up BN] of the same columns, so one product gives
// every thread the gate and the up sums of the same outputs. The grid is
// persistent: min(tiles, SMs) blocks walk the tiles in an order the Ops
// give (Sched, or tgmm's expert-major walk), so one tile's epilogue runs
// while the next tile's chunks load. A tile's contraction runs in 64-deep
// chunks; their number may differ by tile (tgmm: an expert's rows) and may
// be 0 (an empty expert's tile: no product; its epilogue writes zeros).
//
// Block: 384 threads, three warpgroups.
//   - warp 0's first thread TMA-loads, for each chunk, the A chunk (128 x
//     64 bf16, 128-byte swizzle) and the B chunk into a ring of kStages
//     stages with full and empty mbarriers (Ops::load). A bf16 B lands in
//     the swizzled layout wgmma reads; an int8 B lands raw;
//   - int8 only: warps 1-3 and the consumers, half each, widen each raw
//     chunk (exact: |q| <= 127, by byte permutes and one float
//     subtraction) into the swizzled bf16 layout, one of kWiden buffers
//     with their own full and empty mbarriers; each thread fences its
//     generic stores to the async proxy, and each warp arrives once;
//   - two consumer warpgroups of 64 rows issue wgmma m64nBWk16 with one
//     chunk in flight behind the next, then run the kernel's epilogue on
//     the accumulators in registers, whose column scales they fetched as
//     the tile started.
// Operands. A K-major A chunk (x: 128 rows x 64 k) is one panel of 128
// rows; an MN-major A chunk (tgmm's lhs^T: 64 k-rows x 128 m) is two
// 64-column panels, one a consumer warpgroup (wgmma with tnspA). A
// non-trans B chunk (64 k-rows x BW columns) is MN-major, BW / 64 column
// panels of 8 KB; a trans B chunk (BW n-rows x 64 k) is K-major, one panel
// of BW rows: wgmma's native B.
//
// Registers: ptxas compiles every path within the launch's 168 a thread
// (65,536 / 384); setmaxnreg then gives the producer warpgroup 56 and each
// consumer 224. One m64n256 accumulator is 128 f32 a thread.

#pragma once

#include "sm90_common.cuh"

namespace grouped {

using sm90::bf16;

constexpr int kBM = 128;              // rows of a grouped tile: ALIGN
constexpr int kBK = 64;               // contraction chunk
constexpr int kThreads = 384;         // a producer warpgroup and two consumer ones
constexpr int kWidenThreads = 96;     // warps 1-3
constexpr int kPanel = kBK * 128;     // 8 KB: 64 k-rows x 64 bf16 columns (MN-major)
// Rows of tiles walked together before the next column block: a group's
// x rows (8 row tiles) and the bank's columns its tiles read stay in L2
// while the persistent blocks sweep them.
constexpr int kGroupM = 8;

// Ring geometry of a 128-row tile with a B operand BW columns wide of
// element type W (int8: widened in shared memory).
template <int BW, bool TRANS, typename W>
struct Cfg {
  static constexpr int kBW = BW;
  static constexpr bool kRaw = sizeof(W) == 1;
  static constexpr int kX = kBM * kBK * 2;                   // A bytes a stage
  static constexpr int kB = kBK * BW * static_cast<int>(sizeof(W));  // B bytes a stage
  static constexpr int kStage = kX + kB;
  static constexpr int kWB = kRaw ? kBK * BW * 2 : 0;  // one widened chunk
  // 4 x 32 + 3 x 32 (int8, BW 256), 6 x 24 + 4 x 16 (int8, 128),
  // 4 x 48 (bf16, 256), 6 x 32 (bf16, 128) KB
  static constexpr int kStages = BW == 256 ? 4 : 6;
  static constexpr int kWiden = kRaw ? (BW == 256 ? 3 : 4) : 1;
  static constexpr int kOffWB = kStages * kStage;
  // + slack to align the base to 1024 bytes
  static constexpr int kSmem = kOffWB + (kRaw ? kWiden * kWB : 0) + 1024;
  static constexpr int kPieces = kBK * BW / 16;  // 16-byte pieces of a raw int8 chunk
  static constexpr int kAcc = BW / 2;            // f32 accumulators a consumer thread
  // arrivals that free a stage: 8 consumer warps (A, and a bf16 B), and
  // the widening warps (a raw int8 chunk)
  static constexpr int kEmptyCount = kRaw ? 8 + kWidenThreads / 32 : 8;
  static_assert(kSmem <= 227 * 1024, "one block an SM");
  static_assert(kStage % 1024 == 0 && kWB % 1024 == 0, "swizzled tiles are 1024-aligned");
};

// The persistent tile order: groups of kGroupM row tiles, each walked row
// tile fastest, one column block after the other. Mirrored by
// ops/grouped_matmul.py tile_order, which the CPU tests hold.
struct Sched {
  int m_tiles, n_tiles;
  __host__ __device__ int count() const { return m_tiles * n_tiles; }
  __host__ __device__ void coords(int t, int& mt, int& nt) const {
    const int per_group = kGroupM * n_tiles;
    const int group = t / per_group;
    const int first = group * kGroupM;
    const int rows = m_tiles - first < kGroupM ? m_tiles - first : kGroupM;
    const int in = t - group * per_group;
    mt = first + in % rows;
    nt = in / rows;
  }
};

// One output tile as the Ops describe it: its first row and column, its
// expert, its number of 64-deep chunks and where its contraction starts
// (tgmm: the expert's first row)
struct Tile {
  int m0, n0, e, chunks, first;
};

// expert of the 128-row tile starting at row m0: the number of group ends
// offsets[1..E-1] at or before m0 (searchsorted, side "right")
__device__ __forceinline__ int tile_expert(const int* offsets, int E, int m0) {
  int e = 0;
  for (int i = 1; i < E; ++i) e += __ldg(offsets + i) <= m0 ? 1 : 0;
  return e;
}

// the wrappers' shape contract, and a grid the kernels can index
inline int check_shape(int M, int K, int N, int E) {
  if (E <= 0 || K <= 0 || M % kBM || K % 16 || N % 16 || M / kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// The output tile width of an [M, N] result of 128-row tiles on `sms` SMs:
// 256 columns (A read again half as often), unless the grid of such tiles
// would run under three waves; then 128, so more SMs have work. Mirrored
// by ops/grouped_matmul.py gmm_tile_width (and tgmm_tile_width, which
// passes E stacked [K, N] results as M = E * K).
inline int tile_width(int M, int N, int sms) {
  const long long tiles256 = static_cast<long long>(M / kBM) * ((N + 255) / 256);
  return tiles256 < 3LL * sms ? 128 : 256;
}

inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 0;
  }
  return n;
}

// a row-major bf16 [rows, cols] matrix in boxes of box_rows rows x 64
// columns, 128-byte swizzled
inline int rows_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows = kBM) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(cols) * 2};
  const uint32_t box[2] = {64, static_cast<uint32_t>(box_rows)};
  return sm90::make_map<2>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

// A bank [E, K, N] (non-trans) or [E, N, K] (trans) as a 3-D map, in the
// box one stage takes of it: raw int8 {BN, 64} (non-trans, one map a
// bank) or {64, BW} (trans); bf16 {64, 64} panels (non-trans) or {64, BW}
// swizzled (trans).
template <int BW, int BN, bool TRANS, typename W>
int bank_map(CUtensorMap* map, const void* base, int K, int N, int E) {
  constexpr bool kInt8 = sizeof(W) == 1;
  const uint64_t inner = TRANS ? K : N, outer = TRANS ? N : K;
  const uint64_t dims[3] = {inner, outer, static_cast<uint64_t>(E)};
  const uint64_t strides[2] = {inner * sizeof(W), inner * outer * sizeof(W)};
  const uint32_t box[3] = {static_cast<uint32_t>(TRANS ? 64 : (kInt8 ? BN : 64)),
                           static_cast<uint32_t>(TRANS ? BW : 64), 1};
  return sm90::make_map<3>(map,
                           kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                           base, dims, strides, box,
                           kInt8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
}

// four int8 (one word) to two bf16x2 words, exactly: each byte, biased to
// unsigned, becomes the low mantissa byte of 2^23; subtracting 2^23 + 128
// leaves the value, whose upper 16 bits are its bf16
__device__ __forceinline__ void widen4(uint32_t q, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = q ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
  }
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// Widen piece i of one raw int8 chunk into its swizzled bf16 layout.
// Non-trans: NB sub-banks side by side, each 64 k-rows x BW / NB bytes;
// piece i is 16 columns of one row, and lands in the MN-major panel of its
// column (sub-bank b's columns follow b - 1's). Trans: BW n-rows x 64
// bytes of k; piece i is row i / 4, k 16 (i % 4).., and lands in the one
// K-major panel.
template <int BW, bool TRANS, int NB>
__device__ __forceinline__ void widen_piece(const unsigned char* raw, unsigned char* wb,
                                            unsigned i) {
  constexpr unsigned kPer = BW / NB / 16;  // pieces a row of one sub-bank
  const uint4 q = *reinterpret_cast<const uint4*>(raw + i * 16u);
  uint4 w0, w1;
  widen4(q.x, w0.x, w0.y);
  widen4(q.y, w0.z, w0.w);
  widen4(q.z, w1.x, w1.y);
  widen4(q.w, w1.z, w1.w);
  unsigned r, c;  // row, and 16-column (non-trans) or 16-k (trans) group
  if constexpr (TRANS) {  // c < 4: the one panel
    r = i / 4u;
    c = i % 4u;
  } else if constexpr (NB == 1) {
    r = i / kPer;
    c = i % kPer;
  } else {
    const unsigned j = i % (kBK * kPer);
    r = j / kPer;
    c = i / (kBK * kPer) * kPer + j % kPer;  // the group within B
  }
  wb += (c / 4u) * kPanel;
  *reinterpret_cast<uint4*>(wb + sm90::swz128(r, (c % 4u) * 2)) = w0;
  *reinterpret_cast<uint4*>(wb + sm90::swz128(r, (c % 4u) * 2 + 1)) = w1;
}

// Widen pieces first, first + step, ... below end
template <int BW, bool TRANS, int NB>
__device__ __forceinline__ void widen_strided(const unsigned char* raw, unsigned char* wb,
                                              int first, int step, int end) {
  for (int i = first; i < end; i += step) widen_piece<BW, TRANS, NB>(raw, wb, i);
}

// Lane q of each quad holds word jj (jj = 0..3) of 8-column groups j0 +
// jj of one row: two bf16 columns 2q, 2q + 1 of each. Returns the four
// words of group j0 + q, in column order, so that each lane stores 16
// bytes and a quad 64 contiguous bytes of its row.
__device__ __forceinline__ uint4 quad_transpose(uint32_t (&a)[4]) {
  const unsigned q = threadIdx.x & 3;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, q & 2 ? a[0] : a[2], 2);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, q & 2 ? a[1] : a[3], 2);
  if (q & 2) {
    a[0] = r0;
    a[1] = r1;
  } else {
    a[2] = r0;
    a[3] = r1;
  }
  r0 = __shfl_xor_sync(0xffffffffu, q & 1 ? a[0] : a[1], 1);
  r1 = __shfl_xor_sync(0xffffffffu, q & 1 ? a[2] : a[3], 1);
  if (q & 1) {
    a[0] = r0;
    a[2] = r1;
  } else {
    a[1] = r0;
    a[3] = r1;
  }
  return make_uint4(a[0], a[1], a[2], a[3]);
}

// acc (+)= A chunk . B chunk for consumer warpgroup cw: four k16 steps
// of wgmma m64nBWk16. A K-major: the stage's rows cw * 64..; MN-major: the
// stage's A panel cw.
template <class Ops>
__device__ __forceinline__ void issue_chunk(float (&acc)[Ops::C::kAcc], const unsigned char* as,
                                            int cw, const unsigned char* bs, bool accumulate) {
  constexpr int TA = Ops::kTransA ? 1 : 0, TB = Ops::kTransB ? 0 : 1;
  sm90::wgmma_fence();
#pragma unroll
  for (int k16 = 0; k16 < kBK / 16; ++k16) {
    const uint64_t da = Ops::kTransA
                            ? sm90::desc128(as + cw * kPanel + k16 * 16 * 128, kPanel, 1024)
                            : sm90::desc128(as + cw * 64 * 128 + k16 * 32, 16, 1024);
    const uint64_t db = Ops::kTransB ? sm90::desc128(bs + k16 * 32, 16, 1024)
                                     : sm90::desc128(bs + k16 * 16 * 128, kPanel, 1024);
    const int scale_d = accumulate || k16 > 0;
    if constexpr (Ops::C::kBW == 256) {
      sm90::wgmma_ss_n256<TB, TA>(acc, da, db, scale_d);
    } else {
      sm90::wgmma_ss_n128<TB, TA>(acc, da, db, scale_d);
    }
  }
  sm90::wgmma_commit();
}

// Where a consumer thread's accumulators land in a 128-row tile: element
// 4j + e holds row row0 + 8 (e >= 2), column 8j + 2 quad + (e & 1).
struct Frag {
  int row0;  // row within the tile
  int quad;
};

__device__ __forceinline__ Frag frag() {
  const int t = threadIdx.x;
  const int cw = t / 128 - 1;
  return {cw * 64 + ((t >> 5) & 3) * 16 + ((t & 31) >> 2), t & 3};
}

// The operands of gmm and the SwiGLU forward: 128-row x tiles of one
// expert times that expert's bank, int8 or bf16, either orientation. tb0,
// tb1 are the bank maps (tb1: the up bank of the SwiGLU forward, else
// unused).
template <int BW, bool TRANS, typename W, int NB>
struct BankOps {
  using C = Cfg<BW, TRANS, W>;
  static constexpr bool kTransA = false, kTransB = TRANS;
  static_assert(!TRANS || NB == 1, "a trans bank is one operand");
  const CUtensorMap* tx;
  const CUtensorMap* tb0;
  const CUtensorMap* tb1;
  const int* offsets;
  Sched sched;
  int K, N, E;

  __device__ __forceinline__ int tiles() const { return sched.count(); }

  __device__ __forceinline__ Tile tile(int t) const {
    int mt, nt;
    sched.coords(t, mt, nt);
    return {mt * kBM, nt * (BW / NB), tile_expert(offsets, E, mt * kBM),
            sm90::ceil_div(K, kBK), 0};
  }

  __device__ __forceinline__ void prefetch() const {
    sm90::prefetch_map(*tx);
    sm90::prefetch_map(*tb0);
    if (NB > 1) sm90::prefetch_map(*tb1);
  }

  __device__ __forceinline__ void load(unsigned char* st, uint64_t* bar, const Tile& tl,
                                       int kc) const {
    const int k0 = kc * kBK;
    if constexpr (!C::kRaw && !TRANS) {
      // 64-column panels, the ones wholly past N left out: their products
      // land in columns the epilogue never stores
      int bytes = C::kX;
#pragma unroll
      for (int p = 0; p < BW / 64; ++p) bytes += tl.n0 + 64 * p < N ? kPanel : 0;
      sm90::mbar_expect_tx(bar, bytes);
      sm90::tma_load_2d(st, *tx, bar, k0, tl.m0);
#pragma unroll
      for (int p = 0; p < BW / 64; ++p) {
        if (tl.n0 + 64 * p < N) {
          sm90::tma_load_3d(st + C::kX + p * kPanel, *tb0, bar, tl.n0 + 64 * p, k0, tl.e);
        }
      }
    } else {
      sm90::mbar_expect_tx(bar, C::kStage);
      sm90::tma_load_2d(st, *tx, bar, k0, tl.m0);
      if constexpr (TRANS) {
        sm90::tma_load_3d(st + C::kX, *tb0, bar, k0, tl.n0, tl.e);
      } else {  // raw int8, one box a bank
        sm90::tma_load_3d(st + C::kX, *tb0, bar, tl.n0, k0, tl.e);
        if constexpr (NB > 1) {
          sm90::tma_load_3d(st + C::kX + C::kB / NB, *tb1, bar, tl.n0, k0, tl.e);
        }
      }
    }
  }

  // int8 pieces first, first + step, ... below end (the scale goes on the
  // accumulator, in the epilogue)
  __device__ __forceinline__ void widen(const unsigned char* raw, unsigned char* wb, int first,
                                        int step, int end) const {
    widen_strided<BW, TRANS, NB>(raw, wb, first, step, end);
  }
};

// The persistent product, the body of a kernel launched with kThreads
// threads, Ops::C::kSmem bytes of dynamic shared memory and min(tiles,
// SMs) blocks. Ops gives the tiles (tiles(), tile(t)), loads a chunk
// (load), and for an int8 B widens it (widen); epi is the kernel's
// epilogue. Each consumer thread t (0..255) calls
//   const float v = epi.load(t, n0, e, N);
// as a tile starts, so the value (a column scale) arrives while the
// tile's products run, and at its end
//   epi(acc, m0, n0, e, N, v, cols);
// with the tile's f32 sums in the accumulator layout above; a tile of no
// chunk (tgmm's empty expert) leaves them unset, and its epilogue writes
// zeros without reading them. cols is 256 floats of shared memory through
// which the consumers exchange their v (share_cols).
template <class Ops, typename Epi>
__device__ __forceinline__ void persistent_product(const Ops& ops, const Epi& epi) {
  using C = typename Ops::C;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[C::kStages], empty[C::kStages], wfull[C::kWiden],
      wempty[C::kWiden];
  __shared__ __align__(16) float cols[256];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);

  const int tiles = ops.tiles();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], C::kEmptyCount);
    }
#pragma unroll
    for (int b = 0; b < C::kWiden; ++b) {
      sm90::mbar_init(&wfull[b], kWidenThreads / 32 + 8);  // every widening warp
      sm90::mbar_init(&wempty[b], 8);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  auto stage = [&](int it) { return smem + (it % C::kStages) * C::kStage; };
  auto widened = [&](int it) { return smem + C::kOffWB + (it % C::kWiden) * C::kWB; };

  const int wg = sm90::warpgroup_idx();
  const int lane = threadIdx.x & 31;
  // one thread's pieces of chunk it widening: the consumers take the
  // first half, warps 1-3 the rest; one arrival a warp
  auto widen = [&](int it, int first, int step, int end) {
    if constexpr (C::kRaw) {
      const int s = it % C::kStages;
      const int b = it % C::kWiden;
      sm90::mbar_wait(&full[s], (it / C::kStages) & 1);
      if (it >= C::kWiden) sm90::mbar_wait(&wempty[b], ((it / C::kWiden) - 1) & 1);
      ops.widen(stage(it) + C::kX, widened(it), first, step, end);
      sm90::fence_proxy_async();
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&wfull[b]);
    }
  };

  if (wg == 0) {
    sm90::setmaxnreg_dec<56>();
    if (threadIdx.x == 0) {  // TMA
      ops.prefetch();
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tl = ops.tile(t);
        for (int kc = 0; kc < tl.chunks; ++kc, ++it) {
          const int s = it % C::kStages;
          if (it >= C::kStages) sm90::mbar_wait(&empty[s], ((it / C::kStages) - 1) & 1);
          ops.load(stage(it), &full[s], tl, kc);
        }
      }
    } else if (C::kRaw && threadIdx.x >= 32) {  // widening warps
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int chunks = ops.tile(t).chunks;
        for (int kc = 0; kc < chunks; ++kc, ++it) {
          widen(it, C::kPieces / 2 + threadIdx.x - 32, kWidenThreads, C::kPieces);
          if (lane == 0) sm90::mbar_arrive(&empty[it % C::kStages]);  // raw reads done
        }
      }
    }
  } else {  // two consumer warpgroups of 64 rows
    sm90::setmaxnreg_inc<224>();
    const int cw = wg - 1;
    const int t256 = threadIdx.x - 128;  // 0..255 over both consumer warpgroups
    auto release = [&](int it) {
      if (lane == 0) {
        sm90::mbar_arrive(&empty[it % C::kStages]);
        if (C::kRaw) sm90::mbar_arrive(&wempty[it % C::kWiden]);
      }
    };

    float acc[C::kAcc];
    if (C::kRaw && static_cast<int>(blockIdx.x) < tiles) widen(0, t256, 256, C::kPieces / 2);
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tl = ops.tile(t);
      const float v = epi.load(t256, tl.n0, tl.e, ops.N);
      for (int kc = 0; kc < tl.chunks; ++kc, ++it) {
        const unsigned char* bs;
        if constexpr (C::kRaw) {
          sm90::mbar_wait(&wfull[it % C::kWiden], (it / C::kWiden) & 1);
          bs = widened(it);
        } else {
          sm90::mbar_wait(&full[it % C::kStages], (it / C::kStages) & 1);
          bs = stage(it) + C::kX;
        }
        sm90::fence_regs(acc);
        issue_chunk<Ops>(acc, stage(it), cw, bs, kc > 0);
        // the consumers' share of the next chunk's widening (this tile's,
        // or the next tile's first: an int8 bank's tiles all have chunks),
        // while this one is in the tensor cores
        if (C::kRaw && (kc + 1 < tl.chunks || t + static_cast<int>(gridDim.x) < tiles)) {
          widen(it + 1, t256, 256, C::kPieces / 2);
        }
        sm90::wgmma_wait<1>();  // chunk it - 1's products are done
        sm90::fence_regs(acc);
        if (kc > 0) release(it - 1);
      }
      // unconditional, so no branch decides whether the epilogue may read
      // the accumulators; a tile of no chunk has nothing in flight
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (tl.chunks > 0) release(it - 1);
      epi(acc, tl.m0, tl.n0, tl.e, ops.N, v, cols);
    }
  }
}

// The consumers' exchange of one float each through cols (shared
// memory): the barrier before the write keeps a fast warp from
// overwriting the last tile's values while a slow one still reads them.
__device__ __forceinline__ void share_cols(float* cols, float v) {
  sm90::named_sync(1, 256);
  cols[threadIdx.x - 128] = v;
  sm90::named_sync(1, 256);
}

// the schedule of an [M, N] result in 128 x BN tiles, and its persistent
// grid: one block an SM, or one a tile when there are fewer
inline Sched schedule(int M, int N, int BN) { return {M / kBM, (N + BN - 1) / BN}; }

inline int launch_grid(int tiles) {
  const int sms = sm_count();
  return tiles < sms ? tiles : sms;
}

inline int launch_grid(const Sched& sched) { return launch_grid(sched.count()); }

}  // namespace grouped
