// Kernel H: the order-insensitive state digest.
//
// Replaces risingwave_tpu/integrity.py:device_digest (:329), bit-exact
// with its numpy twin host_digest. Per slot, a uint32 running hash folds
// each lane in sorted-name order: first the lane's seed crc32(name),
// then each little-endian uint32 word of the slot's row (a bool byte
// counts as one word of value 0/1), with h = (h ^ w) * 0x9E3779B1;
// h ^= h >> 15. Slots outside the mask (the OR of up to two bool lanes)
// count as 0. The slots reduce to a wrapping uint32 sum and an xor,
// packed (sum << 32) | xor and stored as one int64.
//
// What bounds it on the card: bytes. Every lane is read once, coalesced
// (about 43 bytes per slot for q5's agg state, 25 for its MV); the mix
// is a few integer operations per word.
//
// Design: a fixed grid of SD_BLOCKS blocks walks the slots (grid
// stride); each thread keeps a private sum and xor, a block reduces
// them with warp shuffles and writes one partial pair; a second
// one-block launch reduces the partials and writes the packed result.
// Sum and xor commute, so the result does not depend on the order.
#include "common.cuh"

#define SD_MAX_LANES 24
#define SD_THREADS 256
#define SD_FINAL_THREADS 1024

struct DigestLanes {
  const void* ptr[SD_MAX_LANES];
  int words[SD_MAX_LANES];    // uint32 words (or bytes) per slot
  int is_byte[SD_MAX_LANES];  // 1: bool lane, one byte per word
  uint32_t seed[SD_MAX_LANES];
  int n;
};

__device__ __forceinline__ uint32_t sd_mix(uint32_t h, uint32_t w) {
  h = (h ^ w) * 0x9E3779B1u;
  return h ^ (h >> 15);
}

__device__ __forceinline__ void sd_block_reduce(uint32_t& s, uint32_t& x) {
  __shared__ uint32_t ws[SD_FINAL_THREADS / 32], wx[SD_FINAL_THREADS / 32];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    s += __shfl_down_sync(0xFFFFFFFFu, s, d);
    x ^= __shfl_down_sync(0xFFFFFFFFu, x, d);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    ws[warp] = s;
    wx[warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x / 32;
    s = lane < nw ? ws[lane] : 0u;
    x = lane < nw ? wx[lane] : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      s += __shfl_down_sync(0xFFFFFFFFu, s, d);
      x ^= __shfl_down_sync(0xFFFFFFFFu, x, d);
    }
  }
}

__global__ void digest_partial_kernel(DigestLanes L, int64_t cap, const uint8_t* m0,
                                      const uint8_t* m1, uint32_t* partials) {
  uint32_t s = 0u, x = 0u;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; slot < cap; slot += stride) {
    if (m0 != nullptr) {
      const bool keep = m0[slot] != 0 || (m1 != nullptr && m1[slot] != 0);
      if (!keep) continue;
    }
    uint32_t h = 0u;
    for (int l = 0; l < L.n; ++l) {
      h = sd_mix(h, L.seed[l]);
      const int nw = L.words[l];
      if (L.is_byte[l]) {
        const uint8_t* p = (const uint8_t*)L.ptr[l] + slot * nw;
        for (int j = 0; j < nw; ++j) h = sd_mix(h, p[j] ? 1u : 0u);
      } else {
        const uint32_t* p = (const uint32_t*)L.ptr[l] + slot * nw;
        for (int j = 0; j < nw; ++j) h = sd_mix(h, p[j]);
      }
    }
    s += h;
    x ^= h;
  }
  sd_block_reduce(s, x);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = s;
    partials[2 * blockIdx.x + 1] = x;
  }
}

__global__ void digest_final_kernel(const uint32_t* partials, int n_blocks, long long* out) {
  uint32_t s = 0u, x = 0u;
  for (int b = threadIdx.x; b < n_blocks; b += blockDim.x) {
    s += partials[2 * b];
    x ^= partials[2 * b + 1];
  }
  sd_block_reduce(s, x);
  if (threadIdx.x == 0) *out = (long long)(((unsigned long long)s << 32) | (unsigned long long)x);
}

// lanes: n_lanes rows of (ptr, words per slot, is_byte, seed), int64, in
// sorted-name order; m0/m1: bool masks or null; partials: 2*n_blocks
// uint32 scratch; out: one int64.
RW_EXPORT int rw_state_digest(const int64_t* lanes, int n_lanes, int64_t cap, const void* m0,
                              const void* m1, void* partials, int n_blocks, void* out,
                              void* stream) {
  if (n_lanes < 1 || n_lanes > SD_MAX_LANES || n_blocks < 1) return (int)cudaErrorInvalidValue;
  DigestLanes L;
  L.n = n_lanes;
  for (int l = 0; l < n_lanes; ++l) {
    L.ptr[l] = (const void*)lanes[4 * l];
    L.words[l] = (int)lanes[4 * l + 1];
    L.is_byte[l] = (int)lanes[4 * l + 2];
    L.seed[l] = (uint32_t)lanes[4 * l + 3];
  }
  if (m0 == nullptr && m1 != nullptr) {
    m0 = m1;
    m1 = nullptr;
  }
  cudaStream_t st = (cudaStream_t)stream;
  digest_partial_kernel<<<n_blocks, SD_THREADS, 0, st>>>(L, cap, (const uint8_t*)m0,
                                                         (const uint8_t*)m1, (uint32_t*)partials);
  digest_final_kernel<<<1, SD_FINAL_THREADS, 0, st>>>((const uint32_t*)partials, n_blocks,
                                                      (long long*)out);
  return (int)cudaGetLastError();
}
