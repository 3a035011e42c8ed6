// Kernel H: the order-insensitive state digest.
//
// Replaces risingwave_tpu/integrity.py:device_digest (:329), bit-exact
// with its numpy twin host_digest. Per slot, a uint32 running hash folds
// each lane in sorted-name order: first the lane's seed crc32(name),
// then each little-endian uint32 word of the slot's row (a bool byte
// counts as one word of value 0/1), with h = (h ^ w) * 0x9E3779B1;
// h ^= h >> 15. Slots outside the mask (the OR of up to two bool lanes)
// count as 0. The slots reduce to a wrapping uint32 sum and an xor,
// packed (sum << 32) | xor and stored as one int64. A lane may carry a
// per-entry mask (a join side's (capacity, fanout) row_valid): an
// entry it clears folds zero words, as the reference folds
// where(row_valid, lane, 0) (integrity.py:join_side_lanes :426),
// without the masked copy being written and read back. On request the
// same pass also counts the slots where the first mask or a further
// bool lane is set (the survivors live | sdirty of a rebuild, which the
// fused program's scalar lane carries), so that count takes no pass of
// its own.
//
// What bounds it on the card: bytes. Every lane is read once, coalesced
// (about 43 bytes per slot for q5's agg state, 25 for its MV, 21 + 8
// per bucket entry for q8's join sides); the mix is a few integer
// operations per word.
//
// Design: a fixed grid of SD_BLOCKS blocks walks the slots (grid
// stride); each thread keeps a private sum and xor, a block reduces
// them with warp shuffles and writes one partial pair; a second
// one-block launch reduces the partials and writes the packed result.
// Sum and xor commute, so the result does not depend on the order. The
// entry mask and the survivor count are template parameters, chosen at
// the entry point from its arguments: a call with neither (q5's tables)
// runs the plain per-slot loop, without their tests.
#include "common.cuh"

#define SD_MAX_LANES 40  // = integrity.DIGEST_LANES
#define SD_THREADS 256
#define SD_FINAL_THREADS 1024

struct DigestLanes {
  const void* ptr[SD_MAX_LANES];
  int words[SD_MAX_LANES];    // uint32 words (or bytes) per slot
  int is_byte[SD_MAX_LANES];  // 1: bool lane, one byte per word
  uint32_t seed[SD_MAX_LANES];
  const uint8_t* emask[SD_MAX_LANES];  // per-entry mask, or null
  int entry_words[SD_MAX_LANES];       // words per masked entry
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

template <bool MASKED, bool COUNT>
__global__ void digest_partial_kernel(DigestLanes L, int64_t cap, const uint8_t* m0,
                                      const uint8_t* m1, const uint8_t* c0, uint32_t* partials,
                                      uint32_t* counts) {
  uint32_t s = 0u, x = 0u, c = 0u;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; slot < cap; slot += stride) {
    if (COUNT) c += (m0[slot] != 0 || c0[slot] != 0) ? 1u : 0u;
    if (m0 != nullptr) {
      const bool keep = m0[slot] != 0 || (m1 != nullptr && m1[slot] != 0);
      if (!keep) continue;
    }
    uint32_t h = 0u;
    for (int l = 0; l < L.n; ++l) {
      h = sd_mix(h, L.seed[l]);
      const int nw = L.words[l];
      const uint8_t* em = MASKED ? L.emask[l] : nullptr;
      if (em == nullptr) {  // the whole row of the slot
        if (L.is_byte[l]) {
          const uint8_t* p = (const uint8_t*)L.ptr[l] + slot * nw;
          for (int j = 0; j < nw; ++j) h = sd_mix(h, p[j] ? 1u : 0u);
        } else {
          const uint32_t* p = (const uint32_t*)L.ptr[l] + slot * nw;
          for (int j = 0; j < nw; ++j) h = sd_mix(h, p[j]);
        }
        continue;
      }
      // entry e of the slot folds its ew words, or ew zero words
      const int ew = L.entry_words[l];
      const uint8_t* erow = em + slot * (nw / ew);
      for (int e = 0, j = 0; j < nw; ++e) {
        const bool on = erow[e] != 0;
        for (int k = 0; k < ew; ++k, ++j) {
          uint32_t w = 0u;
          if (on) {
            w = L.is_byte[l] ? (((const uint8_t*)L.ptr[l])[slot * nw + j] ? 1u : 0u)
                             : ((const uint32_t*)L.ptr[l])[slot * nw + j];
          }
          h = sd_mix(h, w);
        }
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
  if (COUNT) {  // the block's survivor count (a slot count fits 32 bits)
    __syncthreads();
    uint32_t unused = 0u;
    sd_block_reduce(c, unused);
    if (threadIdx.x == 0) counts[blockIdx.x] = c;
  }
}

__global__ void digest_final_kernel(const uint32_t* partials, const uint32_t* counts,
                                    int n_blocks, long long* out, long long* count_out) {
  uint32_t s = 0u, x = 0u, c = 0u;
  for (int b = threadIdx.x; b < n_blocks; b += blockDim.x) {
    s += partials[2 * b];
    x ^= partials[2 * b + 1];
    if (counts != nullptr) c += counts[b];
  }
  sd_block_reduce(s, x);
  if (threadIdx.x == 0) *out = (long long)(((unsigned long long)s << 32) | (unsigned long long)x);
  if (counts != nullptr) {
    __syncthreads();
    uint32_t unused = 0u;
    sd_block_reduce(c, unused);
    if (threadIdx.x == 0) *count_out = (long long)c;
  }
}

// lanes: n_lanes rows of (ptr, words per slot, is_byte, seed, entry mask
// or 0, words per entry), int64, in sorted-name order; m0/m1: bool masks
// or null; c0: a bool lane whose OR with m0 is counted into count_out
// (one int64), or null; partials: 3*n_blocks uint32 scratch; out: one
// int64.
RW_EXPORT int rw_state_digest(const int64_t* lanes, int n_lanes, int64_t cap, const void* m0,
                              const void* m1, const void* c0, void* partials, int n_blocks,
                              void* out, void* count_out, void* stream) {
  if (n_lanes < 1 || n_lanes > SD_MAX_LANES || n_blocks < 1 ||
      (c0 != nullptr && (m0 == nullptr || count_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  DigestLanes L;
  L.n = n_lanes;
  bool masked = false;
  for (int l = 0; l < n_lanes; ++l) {
    const int64_t* r = lanes + 6 * l;
    L.ptr[l] = (const void*)r[0];
    L.words[l] = (int)r[1];
    L.is_byte[l] = (int)r[2];
    L.seed[l] = (uint32_t)r[3];
    L.emask[l] = (const uint8_t*)r[4];
    L.entry_words[l] = (int)r[5];
    if (L.emask[l] != nullptr && (L.entry_words[l] < 1 || L.words[l] % L.entry_words[l] != 0))
      return (int)cudaErrorInvalidValue;
    masked |= L.emask[l] != nullptr;
  }
  if (m0 == nullptr && m1 != nullptr) {
    m0 = m1;
    m1 = nullptr;
  }
  uint32_t* part = (uint32_t*)partials;
  uint32_t* counts = c0 != nullptr ? part + 2 * n_blocks : nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  auto partial = masked ? (counts != nullptr ? digest_partial_kernel<true, true>
                                              : digest_partial_kernel<true, false>)
                        : (counts != nullptr ? digest_partial_kernel<false, true>
                                             : digest_partial_kernel<false, false>);
  partial<<<n_blocks, SD_THREADS, 0, st>>>(L, cap, (const uint8_t*)m0, (const uint8_t*)m1,
                                           (const uint8_t*)c0, part, counts);
  digest_final_kernel<<<1, SD_FINAL_THREADS, 0, st>>>(part, counts, n_blocks, (long long*)out,
                                                      (long long*)count_out);
  return (int)cudaGetLastError();
}
