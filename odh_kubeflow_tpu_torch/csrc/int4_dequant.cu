// int4 → bf16/f32 weight dequantization for Hopper (sm_90a).
//
// Replaces odh_kubeflow_tpu/ops/pallas_int4.py:_dequant_kernel (launched by
// int4_dequant). Same function, bit for bit:
//
//   packed  uint8 [K/2, N], split halves: the low nibble of packed[r, n] is
//           row r of the weight, the high nibble row r + K/2
//   scale   f32   [g, N], group = K / g rows share one scale per column
//   out     [K, N] bf16 or f32,
//           out[r, n] = float(nibble(r, n) - 8) * scale[r / group, n],
//           computed in f32 and rounded once (round to nearest even).
//
// Bound: bytes. The kernel does one multiply per 2.5 bytes moved; per weight
// it reads 0.5 byte of nibbles and 4/group bytes of scale and writes 2 bytes
// of bf16 (2.53 bytes at group 128), so at 3.35 TB/s an H100 SXM needs at
// least bytes / 3.35e12 seconds, about 5.7 ms for the 7.5 G weights of one
// Llama-3-8B forward.
//
// Design. The Pallas kernel walked (nibble half, row block, column block)
// in order on one core. Here every thread owns 16 columns (one 16-byte
// load of packed bytes) of up to kMaxRows consecutive packed rows, and
// writes both halves of each byte it reads: 16 values to row r and 16 to
// row r + K/2. So each packed byte is read once, loads and stores are
// 16 bytes wide with neighbouring threads on neighbouring addresses, and a
// thread's row loads are all issued before any is used (kMaxRows loads in
// flight per thread). A thread reloads a scale row only when its row
// crosses a group boundary. The host picks the rows per thread so the grid
// keeps at least kMinBlocks blocks for the small projections. Any N and
// K/2 work: when N is not a multiple of 16, or a pointer is not 16-byte
// aligned, a one-byte-per-thread kernel does the same arithmetic. The
// kernel allocates nothing; the caller passes the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 16;       // packed bytes, and output columns, per thread
constexpr int kMaxRows = 8;     // packed rows per thread, at most
constexpr int kThreads = 256;   // threads per block
constexpr int64_t kMinBlocks = 512;  // ~4 blocks per SM on a 132-SM H100

__device__ __forceinline__ void put(float* dst, float v) { *dst = v; }

__device__ __forceinline__ void put(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
          << 16);
}

__device__ __forceinline__ void store16(float* dst, const float (&v)[kCols]) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    d[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

__device__ __forceinline__ void store16(__nv_bfloat16* dst,
                                        const float (&v)[kCols]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    d[i] = make_uint4(bf16x2(v[8 * i], v[8 * i + 1]),
                      bf16x2(v[8 * i + 2], v[8 * i + 3]),
                      bf16x2(v[8 * i + 4], v[8 * i + 5]),
                      bf16x2(v[8 * i + 6], v[8 * i + 7]));
  }
}

__device__ __forceinline__ void load16(float (&s)[kCols], const float* src) {
  const float4* p = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = __ldg(p + i);
    s[4 * i] = v.x;
    s[4 * i + 1] = v.y;
    s[4 * i + 2] = v.z;
    s[4 * i + 3] = v.w;
  }
}

// N % 16 == 0 and all pointers 16-byte aligned.
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    dequant_vec(const uint8_t* __restrict__ packed,
                const float* __restrict__ scale, OutT* __restrict__ out,
                int64_t K2, int64_t N, int64_t group, int64_t col_chunks,
                int rows) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t rb = t / col_chunks;
  const int64_t r0 = rb * rows;
  if (r0 >= K2) return;
  const int64_t c0 = (t - rb * col_chunks) * kCols;
  const int n = static_cast<int>(K2 - r0 < rows ? K2 - r0 : rows);

  uint4 p[kMaxRows];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    if (i < n) {
      p[i] = __ldg(reinterpret_cast<const uint4*>(packed + (r0 + i) * N + c0));
    }
  }

  float s_lo[kCols];
  float s_hi[kCols];
  int64_t g_lo = -1;
  int64_t g_hi = -1;
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    if (i >= n) break;
    const int64_t r = r0 + i;
    const int64_t gl = r / group;
    const int64_t gh = (r + K2) / group;
    if (gl != g_lo) {
      load16(s_lo, scale + gl * N + c0);
      g_lo = gl;
    }
    if (gh != g_hi) {
      load16(s_hi, scale + gh * N + c0);
      g_hi = gh;
    }
    const uint32_t w[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
    float lo[kCols];
    float hi[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const uint32_t b = (w[j >> 2] >> (8 * (j & 3))) & 0xFFu;
      lo[j] = static_cast<float>(static_cast<int>(b & 0xFu) - 8) * s_lo[j];
      hi[j] = static_cast<float>(static_cast<int>(b >> 4) - 8) * s_hi[j];
    }
    store16(out + r * N + c0, lo);
    store16(out + (r + K2) * N + c0, hi);
  }
}

// Any N and alignment: one packed byte per thread.
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    dequant_scalar(const uint8_t* __restrict__ packed,
                   const float* __restrict__ scale, OutT* __restrict__ out,
                   int64_t K2, int64_t N, int64_t group) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= K2 * N) return;
  const int64_t r = t / N;
  const int64_t c = t - r * N;
  const uint32_t b = packed[t];
  put(out + t,
      static_cast<float>(static_cast<int>(b & 0xFu) - 8) *
          scale[(r / group) * N + c]);
  put(out + t + K2 * N,
      static_cast<float>(static_cast<int>(b >> 4) - 8) *
          scale[((r + K2) / group) * N + c]);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename OutT>
void launch(const uint8_t* packed, const float* scale, OutT* out, int64_t K2,
            int64_t N, int64_t group, cudaStream_t stream) {
  if (N % kCols == 0 && aligned16(packed) && aligned16(scale) &&
      aligned16(out)) {
    const int64_t col_chunks = N / kCols;
    int rows = kMaxRows;
    auto blocks_for = [&](int r) {
      const int64_t threads = (K2 + r - 1) / r * col_chunks;
      return (threads + kThreads - 1) / kThreads;
    };
    while (rows > 1 && blocks_for(rows) < kMinBlocks) rows /= 2;
    dequant_vec<OutT><<<static_cast<unsigned>(blocks_for(rows)), kThreads, 0,
                         stream>>>(packed, scale, out, K2, N, group,
                                   col_chunks, rows);
  } else {
    const int64_t blocks = (K2 * N + kThreads - 1) / kThreads;
    dequant_scalar<OutT><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(packed, scale, out, K2, N, group);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). The caller has
// checked shapes, dtypes, devices and contiguity.
extern "C" int int4_dequant_launch(const void* packed, const void* scale,
                                   void* out, long long K2, long long N,
                                   long long group, int out_bf16,
                                   void* stream) {
  if (K2 <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (group <= 0 || (2 * K2) % group != 0 ||
      K2 * N / kThreads + 1 > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* s = static_cast<const float*>(scale);
  auto st = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    launch(p, s, static_cast<__nv_bfloat16*>(out), K2, N, group, st);
  } else {
    launch(p, s, static_cast<float*>(out), K2, N, group, st);
  }
  return static_cast<int>(cudaGetLastError());
}
