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

// A decoupled look-back over two counts (kernels AF's diff, M, W): a
// tile's published word holds a flag in its top two bits (RW_LB_AGG: the
// tile's own counts; RW_LB_INC: those of this tile and every earlier
// one), count a in bits 31-61 and count b in bits 0-30. Tiles take their
// index from an atomic counter, so a tile only ever waits on tiles that
// are running or done.
#define RW_LB_AGG (1ull << 62)
#define RW_LB_INC (2ull << 62)
#define RW_LB_COUNT 0x7FFFFFFFull

__device__ __forceinline__ unsigned long long rw_lb_word(unsigned long long flag, uint32_t a,
                                                         uint32_t b) {
  return flag | ((unsigned long long)a << 31) | (unsigned long long)b;
}

// Warp 0 of a tile: the counts of every earlier tile (*ea, *eb), by a
// look-back over their published words 32 at a time; the tile's own
// counts (ta, tb) are published first, then its inclusive counts. A word
// that never publishes traps after RW_SPIN_LIMIT reads rather than hang.
__device__ __forceinline__ void rw_lookback(unsigned long long* status, unsigned tile, uint32_t ta,
                                            uint32_t tb, uint32_t* ea, uint32_t* eb) {
  const int lane = threadIdx.x & 31;
  volatile unsigned long long* mine = status + tile;
  uint32_t a = 0, b = 0;
  if (tile == 0) {
    if (lane == 0) *mine = rw_lb_word(RW_LB_INC, ta, tb);
  } else {
    if (lane == 0) *mine = rw_lb_word(RW_LB_AGG, ta, tb);
    for (int64_t q = (int64_t)tile - 1 - lane;; q -= 32) {
      unsigned long long v = RW_LB_INC;  // before tile 0: nothing
      if (q >= 0) {
        const volatile unsigned long long* w = status + q;
        int64_t spins = 0;
        do {
          v = *w;
          if (++spins > RW_SPIN_LIMIT) __trap();  // a tile that never published: fail, not hang
        } while ((v >> 62) == 0ull);
      }
      const unsigned inc = __ballot_sync(0xFFFFFFFFu, (v >> 62) == 2ull);
      const int stop = inc ? __ffs(inc) - 1 : 31;  // the nearest inclusive word
      uint32_t ca = lane <= stop ? (uint32_t)((v >> 31) & RW_LB_COUNT) : 0u;
      uint32_t cb = lane <= stop ? (uint32_t)(v & RW_LB_COUNT) : 0u;
      for (int x = 16; x > 0; x >>= 1) {
        ca += __shfl_xor_sync(0xFFFFFFFFu, ca, x);
        cb += __shfl_xor_sync(0xFFFFFFFFu, cb, x);
      }
      a += ca;
      b += cb;
      if (inc) break;
    }
    if (lane == 0) *mine = rw_lb_word(RW_LB_INC, a + ta, b + tb);
  }
  *ea = a;
  *eb = b;
}

// Spin until status[tile] holds a tile's inclusive counts; returns them
// as (a << 32) | b. For a block that comes after every tile.
__device__ __forceinline__ unsigned long long rw_lb_inclusive(const unsigned long long* status,
                                                              int64_t tile) {
  const volatile unsigned long long* w = status + tile;
  unsigned long long v;
  int64_t spins = 0;
  do {
    v = *w;
    if (++spins > RW_SPIN_LIMIT) __trap();
  } while ((v >> 62) != 2ull);
  return (((v >> 31) & RW_LB_COUNT) << 32) | (v & RW_LB_COUNT);
}

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
