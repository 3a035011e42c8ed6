// Shared definitions for the port's hand-written Hopper kernels.
//
// Every kernel library is a plain C interface loaded with ctypes
// (risingwave_tpu_torch/_kernels.py). Each entry point launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError()
// so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Lane dtype codes; _kernels.DTYPE_CODES holds the same table.
enum RwDType : int {
  RW_BOOL = 0,
  RW_I32 = 1,
  RW_I64 = 2,
  RW_F32 = 3,
  RW_F64 = 4,
};

// Most lanes a kernel takes in one descriptor struct (passed by value).
#define RW_MAX_LANES 8

#define RW_EXPORT extern "C" __attribute__((visibility("default")))

// Most reads of a decoupled look-back's word before a kernel gives up
// (__trap: a launch error, not a hung card); a tile publishes within
// microseconds of starting, so this is never reached by a correct pass.
#define RW_SPIN_LIMIT (1ll << 26)

static inline int rw_blocks(int64_t n, int threads) {
  return (int)((n + threads - 1) / threads);
}

// Float total-order keys as the port stores them (ops/agg.py): float32
// keys are the reference's uint32 key held in an int64; float64 keys are
// the reference's uint64 key with its top bit flipped, read as int64.
// Both keep the order of the reference's unsigned keys.
__device__ __forceinline__ int64_t rw_order_key_f32(float v) {
  uint32_t b = __float_as_uint(v);
  if ((b & 0x7FFFFFFFu) == 0u) b = 0u;  // -0.0 -> +0.0
  if ((b & 0x7F800000u) == 0x7F800000u && (b & 0x007FFFFFu)) b = 0x7FC00000u;
  uint32_t k = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (int64_t)k;
}

__device__ __forceinline__ int64_t rw_order_key_f64(double v) {
  uint64_t b = (uint64_t)__double_as_longlong(v);
  if ((b & 0x7FFFFFFFFFFFFFFFull) == 0ull) b = 0ull;
  if ((b & 0x7FF0000000000000ull) == 0x7FF0000000000000ull &&
      (b & 0x000FFFFFFFFFFFFFull))
    b = 0x7FF8000000000000ull;
  uint64_t k = (b & 0x8000000000000000ull) ? ~b : (b | 0x8000000000000000ull);
  return (int64_t)(k ^ 0x8000000000000000ull);
}

__device__ __forceinline__ float rw_order_key_to_f32(int64_t key) {
  uint32_t k = (uint32_t)key;
  uint32_t b = (k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k;
  return __uint_as_float(b);
}

__device__ __forceinline__ double rw_order_key_to_f64(int64_t key) {
  uint64_t k = (uint64_t)key ^ 0x8000000000000000ull;
  uint64_t b = (k & 0x8000000000000000ull) ? (k & 0x7FFFFFFFFFFFFFFFull) : ~k;
  return __longlong_as_double((long long)b);
}

// Exclusive block scan of one int per thread; returns the block total.
template <int THREADS>
__device__ __forceinline__ int rw_block_exclusive_scan(int v, int* excl) {
  __shared__ int warp_sums[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int ws = lane < THREADS / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xFFFFFFFFu, ws, d);
      if (lane >= d) ws += y;
    }
    if (lane < THREADS / 32) warp_sums[lane] = ws;  // inclusive
  }
  __syncthreads();
  const int warp_base = warp > 0 ? warp_sums[warp - 1] : 0;
  *excl = warp_base + x - v;
  const int total = warp_sums[THREADS / 32 - 1];
  __syncthreads();
  return total;
}
