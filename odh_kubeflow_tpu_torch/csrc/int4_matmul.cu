// int4 fused-dequant matmul and its input gradient for Hopper (sm_90a): the
// weights stay packed in device memory and are widened chunk by chunk
// straight into the tensor cores' registers.
//
// Replaces two kernels of odh_kubeflow_tpu/ops/pallas_int4.py, both behind
// int4_matmul (:268-297, a jax.custom_vjp differentiable in x only):
//   _int4_mm_kernel   (:119, pallas_call at :175)  out = x @ W
//   _int4_dlhs_kernel (:193, pallas_call at :244)  dx  = dout @ W^T
// where W [K, N] is held as
//   q4     uint8 [K/2, N], split halves (models/quant.py:75-80): weight row
//          k < K/2 is the low nibble of packed row k, row k >= K/2 the high
//          nibble of packed row k - K/2; nibbles are stored + 8;
//   scale  f32 [K/group, N], one scale per group of rows and column.
// Same function as the Pallas kernels' _unpack_scaled (:104-116): each weight
// is bf16((nibble - 8) * scale[k / group, n]), computed in f32 and rounded
// once, so the tensor cores see the exact bits int4_dequant writes; then one
// product with f32 accumulation, rounded once to bf16. The scale goes on the
// weight, not on the accumulator (the note at :88-92 says otherwise; the
// kernel does this, see :122-125).
//
// Contract (checked by ops/int4.py, which raises NotImplementedError where
// _int4_mm_impl (:155-165) and _int4_dlhs_impl (:226-237) do): x / dout bf16
// row-major, K % 2048 == 0, group a power of two <= 1024, M and N of any size
// up to 512 and multiples of 512 above. The kernels themselves take any M >=
// 1 and N >= 1 with K % 256 == 0 and mask their ragged edges.
//
// Bound. At the QLoRA training shape (M 8,192) operations: 2 M K N flops,
// 0.278 ms for an 8B wq (K = N = 4096) at the H100 SXM's 989 TFLOP/s, against
// 0.16 GB moved (0.05 ms at 3.35 TB/s). At decode (M 1..4) bytes: the packed
// weights, 0.5 byte a weight (+ 4/group of scale), 2.66 us for wq.
//
// Both directions run, at every shape TMA can map (N % 16 == 0 and 16-byte
// aligned bases, which ops/int4.py checks before it calls them), one form:
// a persistent, warp-specialised wgmma RS product whose A operand is the
// weights, widened from packed nibbles into registers, never back in shared
// memory (a first forward widened them into shared memory for an SS
// product, as gmm.cu widens int8; its shared-memory traffic, ~1.3x the
// tensor time a chunk at 256 x 128 tiles, held it to 0.66 ms at wq/wo
// against this form's 0.48 on an H100, PERF.md). The activations are a
// K-major B, TMA-loaded 128-byte swizzled, rows past M zero-filled. A block
// of 384 threads: one producer thread keeps a ring of chunks in flight (full
// and empty mbarriers), two consumer warpgroups widen and multiply. A nibble
// becomes f32 exactly (the magic-number trick of widen4), one f32 multiply
// by its group scale, one rounding to bf16. Fragments are double-buffered by
// chunk: the widening of chunk kc + 1 runs under chunk kc's products, and a
// buffer is rewritten only after the wgmma_wait<0> that ends the products
// reading it. A tile covers BT tokens: 128, or 16 at decode (tile_rows).
//
// The forward (int4_mm_launch), out^T = W^T x^T: a tile is 256 weight
// columns; the contraction K runs in 64-deep chunks, each 64 packed rows of
// one nibble half (K % 128 == 0) as two 128-byte-swizzled panels and, at
// group >= 64, the chunk's one row of scales. A thread's A fragment rows are
// four neighbouring weight columns, so one 32-bit load of a packed row
// serves them. The epilogue stores bf16 from registers, four columns of a
// token a store, rows past M and columns past N masked.
//
// The input gradient (int4_dlhs_launch), dx^T = W dout^T: a tile is 128
// packed rows, so 256 weight rows in two runs of 128 columns of dx (rows p0..
// and K/2 + p0..); the contraction N runs in 64-deep chunks (an even count:
// dlhs_chunks; TMA reads zeros past N). A consumer warpgroup owns 64 packed
// rows and both m64 blocks of them: block 0 their low nibbles, block 1 their
// high, so one 16-bit load of a packed row (64-byte swizzled) gives a
// column pair's nibbles for both. The scales vary along the contraction: at
// group >= 64 a warpgroup's 64 low rows share one scale row and so do its
// high rows (p0 % 64 == 0, K/2 % group == 0), and TMA stages those four rows
// of 64 scales with the chunk; smaller groups are read by __ldg, in an
// instance of their own (one kernel choosing at run time ran 8-10% slower
// at decode on an H100, PERF.md). The accumulators hold dx^T: the epilogue transposes them into shared memory
// by stmatrix, four 64-column panels of [tokens][k], 128-byte swizzled, and
// TMA stores the two runs, clipping rows past M. No atomics: two launches
// are bitwise equal.
//
// At shapes TMA cannot map, both directions take the first design's
// element-by-element kernel (int4_mm_generic_launch, int4_dlhs_generic_launch:
// int4_mm_kernel below): one block owns one [128, 128] output tile and loops
// over the contraction in 64-wide chunks, each loaded and unpacked straight
// from device memory into bf16 tiles in shared memory that ldmatrix feeds to
// mma.sync m16n8k16 with f32 accumulators. Known weakness: at decode (M
// 1..4) the forward has N / 256 tiles and the input gradient K / 256, 16 for
// a 4096-wide weight, which leaves most of the 132 SMs idle; split-K is
// later work.

#include "flash_common.cuh"
#include "grouped_sm90.cuh"

namespace {

using flash::bf16;

// ---------------------------------------------------------------------------
// the first design, for shapes TMA cannot map

constexpr int kBM = 128;       // rows of x / dout per block
constexpr int kBN = 128;       // output columns per block
constexpr int kBK = 64;        // contraction chunk
constexpr int kThreads = 256;  // 8 warps, 2 (rows) x 4 (columns)
constexpr int kPad = 8;        // bf16 row padding (16 bytes)
constexpr int kLDA = kBK + kPad;  // pitch of the x / dout tile [128][64]
constexpr int kABytes = kBM * kLDA * 2;

// Geometry of one kernel: weight rows and columns of a chunk's tile.
// mm: [64 k][128 n] per K chunk; dlhs: [128 k][64 n] per N chunk.
template <bool kDlhs>
struct Geo {
  static constexpr int kRowsW = kDlhs ? kBN : kBK;  // weight rows k in a tile
  static constexpr int kColsW = kDlhs ? kBK : kBN;  // weight columns n in a tile
  static constexpr int kLDW = kColsW + kPad;
  static constexpr int kSmem = kABytes + kRowsW * kLDW * 2;  // under 48 KB
};

struct Args {
  const bf16* a;         // x [M, K] (mm) or dout [M, N] (dlhs)
  const uint8_t* q4;     // [K/2, N]
  const float* scale;    // [K/group, N]
  bf16* out;             // [M, N] (mm) or [M, K] (dlhs)
  int M, K, N, group;
};

__device__ __forceinline__ float weight(uint32_t byte, bool hi, float s) {
  const int nib = static_cast<int>(hi ? byte >> 4 : byte & 0xFu);
  return static_cast<float>(nib - 8) * s;
}

// Load one chunk's x / dout tile and unpack its weights straight from
// device memory, element by element, zeros outside the operands. mm:
// x[m0.., k0..k0+63] and weight rows k0..k0+63 x columns n0..n0+127; dlhs:
// dout[m0.., n0..n0+63] and weight rows k0..k0+127 x columns n0..n0+63.
template <bool kDlhs>
__device__ __forceinline__ void load_direct(bf16* sA, bf16* sW, const Args& g, int m0, int k0,
                                            int p0, int n0, bool hi) {
  using G = Geo<kDlhs>;
  const int lda = kDlhs ? g.N : g.K;
  const int a_col0 = kDlhs ? n0 : k0;
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
    const int r = i / kBK;
    const int c = i % kBK;
    const bool valid = m0 + r < g.M && a_col0 + c < lda;
    sA[r * kLDA + c] = valid ? g.a[static_cast<long long>(m0 + r) * lda + a_col0 + c] : zero;
  }
  for (int i = threadIdx.x; i < G::kRowsW * G::kColsW; i += kThreads) {
    const int r = i / G::kColsW;
    const int c = i % G::kColsW;
    float v = 0.f;
    if (n0 + c < g.N) {
      const uint32_t b = g.q4[static_cast<long long>(p0 + r) * g.N + n0 + c];
      v = weight(b, hi, g.scale[static_cast<long long>((k0 + r) / g.group) * g.N + n0 + c]);
    }
    sW[r * G::kLDW + c] = __float2bfloat16_rn(v);
  }
}

// acc += sA[.., 0..63] @ weight tile, this warp's 64 x 32 of the block tile
template <bool kDlhs>
__device__ __forceinline__ void mma_chunk(float (&acc)[4][4][4], const bf16* sA, const bf16* sW) {
  using G = Geo<kDlhs>;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) flash::frag_a<kLDA>(a[mi], sA, wm + mi * 16, kk);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t b[4];
      if (kDlhs) {
        flash::frag_b_nk<G::kLDW>(b, sW, wn + nj * 16, kk);  // tile [k out][n contracted]
      } else {
        flash::frag_b_kn<G::kLDW>(b, sW, kk, wn + nj * 16);  // tile [k contracted][n out]
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        flash::mma(acc[mi][2 * nj], a[mi], b[0], b[1]);
        flash::mma(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// One [128, 128] output tile. mm: blockIdx.x walks N, the block loops over
// K. dlhs: blockIdx.x walks K (the weight rows), the block loops over N.
// Two blocks an SM, so at most 128 registers a thread: unbounded, ptxas gave
// the mm kernel 174 and it ran 1.3x slower at one block an SM (H100).
template <bool kDlhs>
__global__ void __launch_bounds__(kThreads, 2) int4_mm_kernel(Args g) {
  using G = Geo<kDlhs>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sW = reinterpret_cast<bf16*>(smem + kABytes);
  const int m0 = blockIdx.y * kBM;
  const int c0 = blockIdx.x * kBN;  // first output column: n (mm) or k (dlhs)
  const int K2 = g.K / 2;
  const int nk = kDlhs ? (g.N + kBK - 1) / kBK : g.K / kBK;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] =
        acc[mi][ni][3] = 0.f;

  for (int kc = 0; kc < nk; ++kc) {
    // the chunk's first weight row k, packed row and nibble half; a dlhs
    // block keeps its 128 weight rows through the loop (K/2 % 128 == 0)
    const int k0 = kDlhs ? c0 : kc * kBK;
    __syncthreads();  // the previous chunk is consumed
    load_direct<kDlhs>(sA, sW, g, m0, k0, k0 < K2 ? k0 : k0 - K2, kDlhs ? kc * kBK : c0,
                       k0 >= K2);
    __syncthreads();
    mma_chunk<kDlhs>(acc, sA, sW);
  }

  // epilogue: one rounding to bf16; rows past M and columns past the output
  // width are not written
  const int width = kDlhs ? g.K : g.N;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool pairs = (width & 1) == 0;  // then (col, col + 1) is 4-byte aligned
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = c0 + (warp & 3) * 32 + ni * 8 + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + (warp >> 2) * 64 + mi * 16 + (lane >> 2) + 8 * h;
        if (row >= g.M || col >= width) continue;
        bf16* dst = g.out + static_cast<long long>(row) * width + col;
        const float v0 = acc[mi][ni][2 * h];
        const float v1 = acc[mi][ni][2 * h + 1];
        if (pairs) {
          flash::store2(dst, v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (col + 1 < width) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <bool kDlhs>
int launch_generic(const Args& g, cudaStream_t stream) {
  const int width = kDlhs ? g.K : g.N;
  const dim3 grid(flash::ceil_div(width, kBN), flash::ceil_div(g.M, kBM));
  int4_mm_kernel<kDlhs><<<grid, kThreads, Geo<kDlhs>::kSmem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// Both directions' checks: K % 256 (whole 128-row dlhs tiles in each
// nibble half); group a power of two dividing 1024, so a chunk's scale
// rows are whole; M within the generic grid's y limit.
bool valid_shape(long long M, long long K, long long N, long long group) {
  return K % 256 == 0 && group > 0 && group <= 1024 && 1024 % group == 0 &&
         M <= 65535LL * kBM && K < (1LL << 31) && N < (1LL << 31);
}

// the shapes the Hopper kernels take: what TMA can map
bool tma_shape(const Args& g) {
  return g.N % 16 == 0 && aligned16(g.a) && aligned16(g.q4) && aligned16(g.scale) &&
         aligned16(g.out);
}

Args make_args(const void* a, const void* q4, const void* scale, void* out, long long M,
               long long K, long long N, long long group) {
  return {static_cast<const bf16*>(a), static_cast<const uint8_t*>(q4),
          static_cast<const float*>(scale), static_cast<bf16*>(out), static_cast<int>(M),
          static_cast<int>(K), static_cast<int>(N), static_cast<int>(group)};
}

int group_shift(int group) {
  int s = 0;
  while ((1 << s) < group) ++s;
  return s;
}

// ---------------------------------------------------------------------------
// the forward on Hopper (int4_mm_launch): out^T = W^T x^T, W widened into
// wgmma's A registers

constexpr int kRN = 256;  // weight columns of a tile: 2 consumer warpgroups x 2 m64 blocks

// Tokens of an output tile (the product's N) for M rows of x or dout, in
// both directions: 16 at decode (M <= 16: an m64n16 product), else 128.
// Mirrored by ops/int4.py int4_mm_tile_rows, which the CPU tests hold.
int tile_rows(int M) { return M <= 16 ? 16 : 128; }

// Ring geometry of a tile of BT tokens: a stage holds the x chunk (BT
// tokens x 64 k, 128-byte swizzle: wgmma's K-major B), the packed chunk (64
// packed rows x 256 bytes as two 128-byte-wide swizzled panels, one a
// consumer warpgroup) and one row of 256 f32 scales.
template <int BT>
struct Rs {
  static constexpr int kX = BT * 128;
  static constexpr int kQ = grouped::kBK * 128;  // 8 KB: one packed panel
  static constexpr int kStage = kX + 2 * kQ + kRN * 4;
  static constexpr int kStages = BT == 128 ? 6 : 10;
  static constexpr int kSmem = kStages * kStage + 1024;
  static_assert(kSmem <= 227 * 1024 && kStage % 1024 == 0, "one block an SM, aligned stages");
};

struct RsArgs {
  bf16* out;
  const float* scale;  // [K/group, N]
  grouped::Sched sched;
  int M, K, N, gshift;  // group = 1 << gshift
};

// A fragments of one 64-deep chunk: [k16 step][m64 block][register]
using Frags = uint32_t[4][2][4];

// Keep registers an asynchronous wgmma reads from being reused until here.
__device__ __forceinline__ void hold(Frags& a) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][h][i])::"memory");
    }
  }
}

// The A fragments of k16 step j for both m64 blocks of this thread's
// warpgroup: rows 16w + g (+ 8) of block h are weight columns 32w + 4g + 2h
// (+ 1) of the warpgroup's packed panel, so one 32-bit load of a packed row
// gives the thread its four columns; the contraction rows are the chunk's
// 16j + 2q, + 1, + 8, + 9 (mma.sync m16n8k16's A layout). Each weight is
// bf16((nibble - 8) * scale), the nibble made f32 exactly by the magic-number
// trick of widen4 and its column's scale from `sc` (row r's: sc[r]).
__device__ __forceinline__ void widen_frag(uint32_t (&a)[2][4], const unsigned char* panel, int j,
                                           int q, int col, int sh, const float4 (&sc)[4]) {
  float f[4][4];  // [row r][column b]
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 16 * j + 2 * q + (r & 1) + 8 * (r >> 1);
    const uint32_t word =
        *reinterpret_cast<const uint32_t*>(panel + sm90::swz128(row, col >> 4) + (col & 15));
    const uint32_t nib = (word >> sh) & 0x0F0F0F0Fu;
    const float s[4] = {sc[r].x, sc[r].y, sc[r].z, sc[r].w};
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      f[r][b] = (__uint_as_float(__byte_perm(nib, 0x4B000000u, 0x7540 + b)) - 8388616.f) * s[b];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // (row half i & 1: column 2h + (i & 1); k half i >> 1)
      const int b = 2 * h + (i & 1), r = 2 * (i >> 1);
      a[h][i] = sm90::pack_bf16(f[r][b], f[r + 1][b]);
    }
  }
}

template <int BT>
__device__ __forceinline__ void issue_rs(float (&acc0)[BT / 2], float (&acc1)[BT / 2],
                                         const uint32_t (&a)[2][4], uint64_t db, int scale_d) {
  if constexpr (BT == 128) {
    sm90::wgmma_rs_n128<0>(acc0, a[0], db, scale_d);
    sm90::wgmma_rs_n128<0>(acc1, a[1], db, scale_d);
  } else {
    sm90::wgmma_rs_n16<0>(acc0, a[0], db, scale_d);
    sm90::wgmma_rs_n16<0>(acc1, a[1], db, scale_d);
  }
}

// Block: 384 threads. Warp 0's first thread TMA-loads each chunk into a
// ring of full and empty mbarriers; two consumer warpgroups of 128 weight
// columns each widen their packed panel into A registers and issue wgmma
// m64nBTk16 RS for both m64 blocks. The A fragments are double-buffered by
// chunk: chunk kc + 1 is widened into one buffer while chunk kc's products
// read the other, and a buffer is written again only after the wgmma_wait<0>
// that ends the products reading it (so ptxas need not serialize the
// products around the widening). The tile's end stores bf16 from
// registers: a thread holds four neighbouring weight columns of a token,
// 8 bytes, per token it holds.
template <int BT>
__global__ void __launch_bounds__(grouped::kThreads, 1)
    int4_rs_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap ts, const RsArgs p) {
  using R = Rs<BT>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[R::kStages], empty[R::kStages];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const int tiles = p.sched.count();
  const int nk = p.K / grouped::kBK;
  const int half = p.K / 2;
  // group >= 64: a chunk's 64 rows share one scale row, which TMA stages
  // with the chunk; smaller groups are read by __ldg
  const bool staged = p.gshift >= 6;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < R::kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // the consumer warps
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  auto stage = [&](int it) { return smem + (it % R::kStages) * R::kStage; };
  const int wg = sm90::warpgroup_idx();

  if (wg == 0) {
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {  // TMA
      sm90::prefetch_map(tx);
      sm90::prefetch_map(tq);
      if (staged) sm90::prefetch_map(ts);
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int mt, nt;
        p.sched.coords(t, mt, nt);
        const int m0 = mt * BT, n0 = nt * kRN;
        const bool two = n0 + 128 < p.N;  // the second panel holds a column
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % R::kStages;
          if (it >= R::kStages) sm90::mbar_wait(&empty[s], ((it / R::kStages) - 1) & 1);
          unsigned char* st = stage(it);
          const int k0 = kc * grouped::kBK;
          const int p0 = k0 < half ? k0 : k0 - half;
          sm90::mbar_expect_tx(&full[s], R::kX + (two ? 2 : 1) * R::kQ + (staged ? kRN * 4 : 0));
          sm90::tma_load_2d(st, tx, &full[s], k0, m0);
          sm90::tma_load_2d(st + R::kX, tq, &full[s], n0, p0);
          if (two) sm90::tma_load_2d(st + R::kX + R::kQ, tq, &full[s], n0 + 128, p0);
          if (staged) sm90::tma_load_2d(st + R::kX + 2 * R::kQ, ts, &full[s], n0, k0 >> p.gshift);
        }
      }
    }
  } else {  // two consumer warpgroups of 128 weight columns
    sm90::setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, q = lane & 3;
    const int col = 32 * w + 4 * g;  // the thread's first column in its panel
    float acc0[BT / 2], acc1[BT / 2];
    Frags fa, fb;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int mt, nt;
      p.sched.coords(t, mt, nt);
      const int m0 = mt * BT, n0 = nt * kRN;
      const int n = n0 + cw * 128 + col;  // the thread's first weight column
      // chunk kc of this tile (ring slot it + kc) into a
      auto widen = [&](Frags& a, int kc) {
        const int c = it + kc;
        sm90::mbar_wait(&full[c % R::kStages], (c / R::kStages) & 1);
        const unsigned char* st = stage(c);
        const int k0 = kc * grouped::kBK;
        const int sh = k0 >= half ? 4 : 0;  // the high nibbles hold rows K/2..
        float4 sc[4];
        if (staged) {
          const float4 v =
              *reinterpret_cast<const float4*>(st + R::kX + 2 * R::kQ + (cw * 128 + col) * 4);
          sc[0] = sc[1] = sc[2] = sc[3] = v;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!staged) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int row = (k0 + 16 * j + 2 * q + (r & 1) + 8 * (r >> 1)) >> p.gshift;
              sc[r] = n < p.N ? __ldg(reinterpret_cast<const float4*>(
                                    p.scale + static_cast<long long>(row) * p.N + n))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
            }
          }
          widen_frag(a[j], st + R::kX + cw * R::kQ, j, q, col, sh, sc);
        }
      };
      // chunk kc's products from a: four k16 steps, one commit group
      auto issue = [&](Frags& a, int kc) {
        const unsigned char* st = stage(it + kc);
        sm90::wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          issue_rs<BT>(acc0, acc1, a[j], sm90::desc128(st + j * 32, 16, 1024), kc > 0 || j > 0);
        }
        sm90::wgmma_commit();
      };
      // after chunk kc's products: its stage is free, and so is a
      auto retire = [&](Frags& a, int kc) {
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc0);
        sm90::fence_regs(acc1);
        hold(a);
        if (lane == 0) sm90::mbar_arrive(&empty[(it + kc) % R::kStages]);
      };
      widen(fa, 0);
      for (int kc = 0; kc < nk; kc += 2) {  // nk is a multiple of 4 (K % 256 == 0)
        issue(fa, kc);
        widen(fb, kc + 1);
        retire(fa, kc);
        issue(fb, kc + 1);
        if (kc + 2 < nk) widen(fa, kc + 2);
        retire(fb, kc + 1);
      }
      it += nk;
      // acc_h element 4jj + e: weight column n + 2h + (e >> 1), token
      // m0 + 8jj + 2q + (e & 1)
      if (n < p.N) {
#pragma unroll
        for (int jj = 0; jj < BT / 8; ++jj) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int tok = m0 + 8 * jj + 2 * q + u;
            if (tok < p.M) {
              *reinterpret_cast<uint2*>(p.out + static_cast<long long>(tok) * p.N + n) =
                  make_uint2(sm90::pack_bf16(acc0[4 * jj + u], acc0[4 * jj + 2 + u]),
                             sm90::pack_bf16(acc1[4 * jj + u], acc1[4 * jj + 2 + u]));
            }
          }
        }
      }
    }
  }
}

template <int BT>
int launch_rs(const Args& g, cudaStream_t stream) {
  constexpr int kSmem = Rs<BT>::kSmem;
  static int attr = sm90::set_smem(int4_rs_kernel<BT>, kSmem);
  if (attr != 0) return attr;
  CUtensorMap tx, tq, ts;
  if (int rc = grouped::rows_map(&tx, g.a, g.M, g.K, BT)) return rc;
  const uint64_t n = g.N;
  const uint64_t qdims[2] = {n, static_cast<uint64_t>(g.K / 2)}, qstrides[1] = {n};
  const uint32_t qbox[2] = {128, grouped::kBK};
  if (int rc = sm90::make_map<2>(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, g.q4, qdims, qstrides, qbox,
                                 CU_TENSOR_MAP_SWIZZLE_128B)) {
    return rc;
  }
  const uint64_t sdims[2] = {n, static_cast<uint64_t>(g.K / g.group)}, sstrides[1] = {n * 4};
  const uint32_t sbox[2] = {kRN, 1};
  if (int rc = sm90::make_map<2>(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, g.scale, sdims, sstrides,
                                 sbox, CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return rc;
  }
  const RsArgs p{g.out, g.scale, {sm90::ceil_div(g.M, BT), sm90::ceil_div(g.N, kRN)}, g.M, g.K,
                 g.N, group_shift(g.group)};
  int4_rs_kernel<BT><<<grouped::launch_grid(p.sched), grouped::kThreads, kSmem, stream>>>(
      tx, tq, ts, p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the input gradient on Hopper (int4_dlhs_launch): dx^T = W dout^T, W
// widened into wgmma's A registers

constexpr int kDK = 256;  // weight rows of a tile: 128 packed rows, both nibble halves

// 64-deep chunks of a dX tile's contraction N, rounded up to an even count:
// the consumers take them two at a time, and a chunk wholly past N reads
// zeros (TMA fills what lies outside an operand). Mirrored by ops/int4.py
// int4_dlhs_chunks, which the CPU tests hold.
__host__ __device__ int dlhs_chunks(int N) { return 2 * ((N + 127) / 128); }

// Ring geometry of a dX tile of BT tokens: a stage holds the dout chunk (BT
// tokens x 64 n, 128-byte swizzle: wgmma's K-major B), the packed chunk
// (128 packed rows x 64 bytes, 64-byte swizzle) and four rows of 64 scales
// (the low and the high rows of each consumer warpgroup); after the ring,
// the epilogue's four panels of dx (BT tokens x 64 k, 128-byte swizzle).
template <int BT>
struct Dl {
  static constexpr int kD = BT * 128;
  static constexpr int kQ = 128 * grouped::kBK;  // 8 KB
  static constexpr int kS = 4 * grouped::kBK * 4;
  static constexpr int kStage = kD + kQ + kS;
  static constexpr int kStages = BT == 128 ? 6 : 16;
  static constexpr int kPanel = BT * 128;
  static constexpr int kSmem = kStages * kStage + 4 * kPanel + 1024;
  static_assert(kSmem <= 227 * 1024 && kStage % 1024 == 0, "one block an SM, aligned stages");
};

struct DlArgs {
  const float* scale;    // [K/group, N]
  grouped::Sched sched;  // token tiles x tiles of 128 packed rows
  int M, K, N, gshift;   // group = 1 << gshift
};

// byte offset of (row, 16-byte chunk) in a panel of 64-byte rows as TMA
// writes it under CU_TENSOR_MAP_SWIZZLE_64B: address bits 4-5 XOR bits 7-8
__device__ __forceinline__ uint32_t swz64(int row, int chunk) {
  return row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// Four 8 x 8 bf16 matrices from registers to shared memory, transposed:
// register i holds matrix i as mma.sync's C fragment (lane l: row l / 4,
// columns 2 (l % 4), + 1); lane l gives the address of the 16 bytes that
// receive column l % 8 of matrix l / 8.
__device__ __forceinline__ void stmatrix_t(void* p, uint32_t r0, uint32_t r1, uint32_t r2,
                                           uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   sm90::smem_addr(p)),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// The A fragments of k16 step j for both m64 blocks of this thread's
// warpgroup. A row r of either block is the warpgroup's packed row r:
// block 0 its low nibbles (weight row p), block 1 its high (row p + K/2);
// the contraction is the chunk's columns n. A thread holds rows row (+ 8)
// at columns 16j + 2q (+ 1) and 16j + 2q + 8 (+ 9) (mma.sync m16n8k16's A
// layout), so one 16-bit load of a packed row gives a column pair's four
// nibbles, two for each block. Each weight is bf16((nibble - 8) * scale);
// sc(rh, c) gives the scales of row half rh at chunk columns c and c + 1,
// {low row's two, high row's two}.
template <typename Scales>
__device__ __forceinline__ void widen_dlhs(uint32_t (&a)[2][4], const unsigned char* packed,
                                           int j, int q, int row, const Scales& sc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // row half i & 1, column half i >> 1
    const int rh = i & 1, c = 16 * j + 2 * q + 8 * (i >> 1);
    const uint32_t pair =
        *reinterpret_cast<const uint16_t*>(packed + swz64(row + 8 * rh, j) + (c & 15));
    // bytes: low nibble of n, of n + 1, high nibble of n, of n + 1
    const uint32_t nib = (pair | (pair << 12)) & 0x0F0F0F0Fu;
    const float4 s4 = sc(rh, c);
    const float s[4] = {s4.x, s4.y, s4.z, s4.w};
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      f[b] = (__uint_as_float(__byte_perm(nib, 0x4B000000u, 0x7540 + b)) - 8388616.f) * s[b];
    }
    a[0][i] = sm90::pack_bf16(f[0], f[1]);
    a[1][i] = sm90::pack_bf16(f[2], f[3]);
  }
}

// Block: 384 threads, as int4_rs_kernel. Warp 0's first thread TMA-loads
// each chunk into the ring; two consumer warpgroups of 64 packed rows each
// widen them into A registers (both nibble halves) and issue wgmma
// m64nBTk16 RS for both m64 blocks, with the forward's double-buffered
// fragments. At a tile's end each warpgroup transposes its accumulators
// into its two panels by stmatrix and one of its threads TMA-stores them:
// 64 columns of dx in the low run and 64 in the high.
template <int BT, bool kStaged>
__global__ void __launch_bounds__(grouped::kThreads, 1)
    int4_dlhs_kernel(const __grid_constant__ CUtensorMap td, const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap ts, const __grid_constant__ CUtensorMap tdx,
                     const DlArgs p) {
  using D = Dl<BT>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[D::kStages], empty[D::kStages];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const int tiles = p.sched.count();
  const int nk = dlhs_chunks(p.N);
  const int half = p.K / 2;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < D::kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // the consumer warps
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  auto stage = [&](int it) { return smem + (it % D::kStages) * D::kStage; };
  const int wg = sm90::warpgroup_idx();

  if (wg == 0) {
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {  // TMA
      sm90::prefetch_map(td);
      sm90::prefetch_map(tq);
      if (kStaged) sm90::prefetch_map(ts);
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int mt, kt;
        p.sched.coords(t, mt, kt);
        const int m0 = mt * BT, p0 = kt * 128;
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % D::kStages;
          if (it >= D::kStages) sm90::mbar_wait(&empty[s], ((it / D::kStages) - 1) & 1);
          unsigned char* st = stage(it);
          const int n0 = kc * grouped::kBK;
          sm90::mbar_expect_tx(&full[s], D::kD + D::kQ + (kStaged ? D::kS : 0));
          sm90::tma_load_2d(st, td, &full[s], n0, m0);
          sm90::tma_load_2d(st + D::kD, tq, &full[s], n0, p0);
          if (kStaged) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {  // warpgroup r / 2's low (r even) or high rows
              const int k = p0 + 64 * (r >> 1) + (r & 1) * half;
              sm90::tma_load_2d(st + D::kD + D::kQ + r * grouped::kBK * 4, ts, &full[s], n0,
                                k >> p.gshift);
            }
          }
        }
      }
    }
  } else {  // two consumer warpgroups of 64 packed rows
    sm90::setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, q = lane & 3;
    const int row = 64 * cw + 16 * w + g;  // the thread's first packed row in the tile
    const bool leader = (threadIdx.x & 127) == 0;
    // the warpgroup's panels: 64 columns of the low run, then of the high
    unsigned char* panel0 = smem + D::kStages * D::kStage + cw * D::kPanel;
    unsigned char* panel1 = panel0 + 2 * D::kPanel;
    float acc0[BT / 2], acc1[BT / 2];
    Frags fa, fb;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int mt, kt;
      p.sched.coords(t, mt, kt);
      const int m0 = mt * BT, p0 = kt * 128;
      // chunk kc of this tile (ring slot it + kc) into a
      auto widen = [&](Frags& a, int kc) {
        const int c = it + kc;
        sm90::mbar_wait(&full[c % D::kStages], (c / D::kStages) & 1);
        const unsigned char* st = stage(c);
        if constexpr (kStaged) {
          const float* ss = reinterpret_cast<const float*>(st + D::kD + D::kQ) + cw * 128;
          auto sc = [&](int, int col) {
            const float2 lo = *reinterpret_cast<const float2*>(ss + col);
            const float2 hi = *reinterpret_cast<const float2*>(ss + 64 + col);
            return make_float4(lo.x, lo.y, hi.x, hi.y);
          };
#pragma unroll
          for (int j = 0; j < 4; ++j) widen_dlhs(a[j], st + D::kD, j, q, row, sc);
        } else {
          const int n0 = kc * grouped::kBK;
          auto sc = [&](int rh, int col) {
            const int n = n0 + col;
            if (n >= p.N) return make_float4(0.f, 0.f, 0.f, 0.f);
            const int k = p0 + row + 8 * rh;
            const float2 lo = __ldg(reinterpret_cast<const float2*>(
                p.scale + static_cast<long long>(k >> p.gshift) * p.N + n));
            const float2 hi = __ldg(reinterpret_cast<const float2*>(
                p.scale + static_cast<long long>((k + half) >> p.gshift) * p.N + n));
            return make_float4(lo.x, lo.y, hi.x, hi.y);
          };
#pragma unroll
          for (int j = 0; j < 4; ++j) widen_dlhs(a[j], st + D::kD, j, q, row, sc);
        }
      };
      // chunk kc's products from a: four k16 steps, one commit group
      auto issue = [&](Frags& a, int kc) {
        const unsigned char* st = stage(it + kc);
        sm90::wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          issue_rs<BT>(acc0, acc1, a[j], sm90::desc128(st + j * 32, 16, 1024), kc > 0 || j > 0);
        }
        sm90::wgmma_commit();
      };
      // after chunk kc's products: its stage is free, and so is a
      auto retire = [&](Frags& a, int kc) {
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc0);
        sm90::fence_regs(acc1);
        hold(a);
        if (lane == 0) sm90::mbar_arrive(&empty[(it + kc) % D::kStages]);
      };
      widen(fa, 0);
      for (int kc = 0; kc < nk; kc += 2) {  // nk is even (dlhs_chunks)
        issue(fa, kc);
        widen(fb, kc + 1);
        retire(fa, kc);
        issue(fb, kc + 1);
        if (kc + 2 < nk) widen(fa, kc + 2);
        retire(fb, kc + 1);
      }
      it += nk;
      // Epilogue. acc_h element 4jj + e: A row 16w + g + 8 (e >> 1) (weight
      // row h K/2 + p0 + 64 cw + that row), token m0 + 8jj + 2q + (e & 1).
      // Matrix i of a store is the warp's rows 8 (i & 1) .. + 7 at tokens
      // 8 (jj + i / 2) ..; a panel row is a token, and its 16-byte chunk
      // 2w + (i & 1) receives those 8 weight rows.
      if (leader) sm90::tma_store_wait_read();  // the last tile's stores have read the panels
      sm90::named_sync(1 + cw, 128);
      const int mi = lane >> 3;
#pragma unroll
      for (int jj = 0; jj < BT / 8; jj += 2) {
        const uint32_t off = sm90::swz128(8 * (jj + (mi >> 1)) + (lane & 7), 2 * w + (mi & 1));
        stmatrix_t(panel0 + off, sm90::pack_bf16(acc0[4 * jj], acc0[4 * jj + 1]),
                   sm90::pack_bf16(acc0[4 * jj + 2], acc0[4 * jj + 3]),
                   sm90::pack_bf16(acc0[4 * jj + 4], acc0[4 * jj + 5]),
                   sm90::pack_bf16(acc0[4 * jj + 6], acc0[4 * jj + 7]));
        stmatrix_t(panel1 + off, sm90::pack_bf16(acc1[4 * jj], acc1[4 * jj + 1]),
                   sm90::pack_bf16(acc1[4 * jj + 2], acc1[4 * jj + 3]),
                   sm90::pack_bf16(acc1[4 * jj + 4], acc1[4 * jj + 5]),
                   sm90::pack_bf16(acc1[4 * jj + 6], acc1[4 * jj + 7]));
      }
      sm90::fence_proxy_async();
      sm90::named_sync(1 + cw, 128);
      if (leader) {
        sm90::tma_store_2d(tdx, panel0, p0 + 64 * cw, m0);
        sm90::tma_store_2d(tdx, panel1, half + p0 + 64 * cw, m0);
        sm90::tma_store_commit();
      }
    }
    if (leader) sm90::tma_store_wait_read();
  }
}

template <int BT, bool kStaged>
int launch_dlhs(const Args& g, cudaStream_t stream) {
  constexpr int kSmem = Dl<BT>::kSmem;
  static int attr = sm90::set_smem(int4_dlhs_kernel<BT, kStaged>, kSmem);
  if (attr != 0) return attr;
  CUtensorMap td, tq, ts, tdx;
  if (int rc = grouped::rows_map(&td, g.a, g.M, g.N, BT)) return rc;     // dout [M, N]
  if (int rc = grouped::rows_map(&tdx, g.out, g.M, g.K, BT)) return rc;  // dx [M, K]
  const uint64_t n = g.N;
  const uint64_t qdims[2] = {n, static_cast<uint64_t>(g.K / 2)}, qstrides[1] = {n};
  const uint32_t qbox[2] = {grouped::kBK, 128};
  if (int rc = sm90::make_map<2>(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, g.q4, qdims, qstrides, qbox,
                                 CU_TENSOR_MAP_SWIZZLE_64B)) {
    return rc;
  }
  const uint64_t sdims[2] = {n, static_cast<uint64_t>(g.K / g.group)}, sstrides[1] = {n * 4};
  const uint32_t sbox[2] = {grouped::kBK, 1};
  if (int rc = sm90::make_map<2>(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, g.scale, sdims, sstrides,
                                 sbox, CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return rc;
  }
  const DlArgs p{g.scale, {sm90::ceil_div(g.M, BT), g.K / kDK}, g.M, g.K, g.N,
                 group_shift(g.group)};
  int4_dlhs_kernel<BT, kStaged>
      <<<grouped::launch_grid(p.sched), grouped::kThreads, kSmem, stream>>>(td, tq, ts, tdx, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each returns a CUDA error code (0 on success). The caller has checked
// dtypes (bf16 x / dout, uint8 q4, f32 scale), shapes, contiguity and one
// device, and allocated the output.

// out [M, N] = x [M, K] @ dequant(q4, scale), on the persistent product.
// Only shapes TMA can map: N % 16 == 0 and 16-byte aligned bases (the
// caller takes int4_mm_generic_launch for the others); else an error.
extern "C" int int4_mm_launch(const void* x, const void* q4, const void* scale, void* out,
                              long long M, long long K, long long N, long long group,
                              void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  const Args g = make_args(x, q4, scale, out, M, K, N, group);
  if (!valid_shape(M, K, N, group) || !tma_shape(g)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return tile_rows(g.M) == 16 ? launch_rs<16>(g, st) : launch_rs<128>(g, st);
}

// dx [M, K] = dout [M, N] @ dequant(q4, scale)^T, on the persistent product.
// Only shapes TMA can map, as int4_mm_launch (else int4_dlhs_generic_launch).
extern "C" int int4_dlhs_launch(const void* dout, const void* q4, const void* scale, void* dx,
                                long long M, long long K, long long N, long long group,
                                void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  const Args g = make_args(dout, q4, scale, dx, M, K, N, group);
  if (!valid_shape(M, K, N, group) || !tma_shape(g)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  // group >= 64: each warpgroup's low rows share a scale row, and so do its
  // high rows, and TMA stages the four with the chunk; smaller groups are
  // read by __ldg (an instance of their own: the staged one carries no
  // registers for it)
  const bool scales_staged = g.group >= 64;
  if (tile_rows(g.M) == 16) {
    return scales_staged ? launch_dlhs<16, true>(g, st) : launch_dlhs<16, false>(g, st);
  }
  return scales_staged ? launch_dlhs<128, true>(g, st) : launch_dlhs<128, false>(g, st);
}

// The same two functions at any shape the contract takes, on the first
// design's element-by-element kernel: for the shapes TMA cannot map.
extern "C" int int4_mm_generic_launch(const void* x, const void* q4, const void* scale,
                                      void* out, long long M, long long K, long long N,
                                      long long group, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (!valid_shape(M, K, N, group)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_generic<false>(make_args(x, q4, scale, out, M, K, N, group),
                               static_cast<cudaStream_t>(stream));
}

extern "C" int int4_dlhs_generic_launch(const void* dout, const void* q4, const void* scale,
                                        void* dx, long long M, long long K, long long N,
                                        long long group, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (!valid_shape(M, K, N, group)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_generic<true>(make_args(dout, q4, scale, dx, M, K, N, group),
                              static_cast<cudaStream_t>(stream));
}

// The tiles' rules, for their Python mirrors' test on the card: tokens a
// tile (both directions), and the dX's chunks of its contraction.
extern "C" int int4_mm_tile_rows(long long M) { return tile_rows(static_cast<int>(M)); }
extern "C" int int4_dlhs_chunks(long long N) { return dlhs_chunks(static_cast<int>(N)); }
