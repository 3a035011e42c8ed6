// A stable LSD radix sort of 64-bit keys with an int32 payload, one
// launch per 8-bit pass (a single sweep): kernel AE's order
// (csrc/window.cuh), kernel W's candidates (csrc/topn_rank.cu) and
// kernel F's fingerprints (csrc/reduce_by_key.cu, its own histogram
// launch and these passes). radix.cuh's three-launch pass stays with its
// users (X, AC's emit, AD).
//
// Before the passes, one launch counts every sorted byte's digits over
// all keys (a histogram is the same in any order of the keys; each block
// counts into four copies in shared memory, a quarter of its warps each,
// so that keys of one digit contend less), so each pass knows where each
// digit's run starts in the output. A pass then
// takes its tile (OS_TILE keys) from an atomic counter, so a tile never
// waits on one that is not yet running; ranks each key among the tile's
// keys of its digit with warp matching (__match_any_sync: the peers of
// a digit in one round of 32 keys, their count added once per warp and
// round), which keeps input order within a digit; publishes the tile's
// digit counts at once and finds the counts of all earlier tiles by a
// decoupled look-back (each digit's thread walks back over the earlier
// tiles' published words until one holds its inclusive prefix); then
// stages the tile in shared memory in digit order and writes it out, so
// neighbouring threads write neighbouring places of a digit's run.
//
// What bounds it on the card: bytes. A pass reads and writes a 12-byte
// (key, payload) pair per key; the histogram reads each key once.
#pragma once

#include "common.cuh"

#define OS_THREADS 256
#define OS_WARPS (OS_THREADS / 32)
#define OS_ITEMS 8
#define OS_TILE (OS_THREADS * OS_ITEMS)  // keys per tile; = _kernels.OS_TILE
#define OS_RADIX 256
#define OS_HIST_BLOCKS (132 * 8)
#define OS_HIST_COPIES 4  // shared copies of a block's digit counts
// a tile's published word for one digit: a flag and a count below 2^30
#define OS_AGG 0x40000000u  // the tile's own count
#define OS_INC 0x80000000u  // the count of this tile and every earlier one
#define OS_COUNT 0x3FFFFFFFu
#define OS_MAX_KEYS ((int64_t)OS_COUNT)

// hist[b * 256 + d] += keys whose byte b (a set bit of mask) is d
static __global__ void os_hist_kernel(const unsigned long long* __restrict__ keys, int64_t n,
                                      unsigned mask, uint32_t* hist) {
  __shared__ uint32_t h[OS_HIST_COPIES][8 * OS_RADIX];
  for (int i = threadIdx.x; i < OS_HIST_COPIES * 8 * OS_RADIX; i += blockDim.x) (&h[0][0])[i] = 0;
  __syncthreads();
  uint32_t* mine = h[(threadIdx.x >> 5) & (OS_HIST_COPIES - 1)];
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const unsigned long long k = keys[i];
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if ((mask >> b) & 1u) atomicAdd(&mine[b * OS_RADIX + ((k >> (8 * b)) & 0xFFull)], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * OS_RADIX; i += blockDim.x) {
    uint32_t c = 0;
    for (int j = 0; j < OS_HIST_COPIES; ++j) c += h[j][i];
    if (c) atomicAdd(hist + i, c);
  }
}

// One pass: (keys_in, pay_in) stably by the digit at `shift` into
// (keys_out, pay_out). pay_in == nullptr stands for 0, 1, 2, ...
// `hist` is this byte's 256 digit counts; `status` holds tiles * 256
// words and then the tile counter, all zero.
static __global__ void __launch_bounds__(OS_THREADS)
    os_pass_kernel(const unsigned long long* __restrict__ keys_in,
                   const int32_t* __restrict__ pay_in, unsigned long long* __restrict__ keys_out,
                   int32_t* __restrict__ pay_out, int64_t n, int shift,
                   const uint32_t* __restrict__ hist, uint32_t* status, uint32_t* counter) {
  __shared__ uint32_t s_tile;
  __shared__ uint32_t whist[OS_WARPS][OS_RADIX];  // per warp: counts, then offsets
  __shared__ uint32_t tstart[OS_RADIX];           // a digit's first place in the tile
  __shared__ uint32_t gbase[OS_RADIX];            // ... and in the output
  __shared__ unsigned long long skey[OS_TILE];
  __shared__ int32_t spay[OS_TILE];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(counter, 1u);
  for (int i = t; i < OS_WARPS * OS_RADIX; i += OS_THREADS) (&whist[0][0])[i] = 0;
  __syncthreads();
  const uint32_t tile = s_tile;
  const int64_t tile_base = (int64_t)tile * OS_TILE;
  // warp w holds the tile's keys [256 w, 256 w + 256), round j its 32 keys
  // from 256 w + 32 j: (round, lane) is input order
  const int64_t base = tile_base + (int64_t)warp * (32 * OS_ITEMS);
  const unsigned below = (1u << lane) - 1u;
  unsigned long long k[OS_ITEMS];
  int32_t p[OS_ITEMS];
  uint32_t rank[OS_ITEMS];
#pragma unroll
  for (int j = 0; j < OS_ITEMS; ++j) {
    const int64_t i = base + j * 32 + lane;
    const bool ok = i < n;
    k[j] = ok ? keys_in[i] : 0ull;
    p[j] = ok ? (pay_in != nullptr ? pay_in[i] : (int32_t)i) : 0;
    const unsigned d = ok ? (unsigned)((k[j] >> shift) & 0xFFull) : OS_RADIX;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    const uint32_t before = ok ? whist[warp][d] : 0u;
    __syncwarp();
    if (ok && (peers & below) == 0u) whist[warp][d] = before + (uint32_t)__popc(peers);
    __syncwarp();
    rank[j] = before + (uint32_t)__popc(peers & below);
  }
  __syncthreads();
  // thread t owns digit t: the warps' offsets, the tile's count
  uint32_t count = 0;
  for (int w = 0; w < OS_WARPS; ++w) {
    const uint32_t c = whist[w][t];
    whist[w][t] = count;
    count += c;
  }
  volatile uint32_t* mine = status + (int64_t)tile * OS_RADIX + t;
  *mine = (tile == 0 ? OS_INC : OS_AGG) | count;
  int g_excl, t_excl;
  rw_block_exclusive_scan<OS_THREADS>((int)hist[t], &g_excl);
  rw_block_exclusive_scan<OS_THREADS>((int)count, &t_excl);
  uint32_t prefix = 0;
  if (tile > 0) {
    for (int64_t q = (int64_t)tile - 1; q >= 0; --q) {
      const volatile uint32_t* w = status + q * OS_RADIX + t;
      uint32_t v;
      int64_t spins = 0;
      do {
        v = *w;
        if (++spins > RW_SPIN_LIMIT) __trap();  // a tile that never published: fail, not hang
      } while ((v & (OS_AGG | OS_INC)) == 0u);
      prefix += v & OS_COUNT;
      if (v & OS_INC) break;
    }
    *mine = OS_INC | (prefix + count);
  }
  tstart[t] = (uint32_t)t_excl;
  gbase[t] = (uint32_t)g_excl + prefix;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < OS_ITEMS; ++j) {
    if (base + j * 32 + lane >= n) continue;
    const unsigned d = (unsigned)((k[j] >> shift) & 0xFFull);
    const uint32_t at = tstart[d] + whist[warp][d] + rank[j];
    skey[at] = k[j];
    spay[at] = p[j];
  }
  __syncthreads();
  const int64_t left = n - tile_base;
  const int cnt = left < OS_TILE ? (int)left : OS_TILE;
  for (int i = t; i < cnt; i += OS_THREADS) {
    const unsigned long long key = skey[i];
    const unsigned d = (unsigned)((key >> shift) & 0xFFull);
    const int64_t dst = (int64_t)gbase[d] + (i - (int)tstart[d]);
    keys_out[dst] = key;
    pay_out[dst] = spay[i];
  }
}

static inline int os_tiles(int64_t n) { return (int)((n + OS_TILE - 1) / OS_TILE); }

// the sort's scratch: two (key, payload) buffers of n each, 8 * 256
// digit counts, os_tiles(n) * 256 + 1 status words
struct OsScratch {
  unsigned long long* ka;
  unsigned long long* kb;
  int32_t* pa;
  int32_t* pb;
  uint32_t* hist;
  uint32_t* status;
};

// (keys, pay) sorted stably by the bytes of `mask` (bit b: byte b); the
// result's place in *keys_out, *pay_out (the inputs when no byte is
// sorted). The inputs are not written; neither may be s.ka/s.pa and
// s.kb/s.pb at once.
static inline void os_sort(const unsigned long long* keys, const int32_t* pay, int64_t n,
                           unsigned mask, const OsScratch& s, const unsigned long long** keys_out,
                           const int32_t** pay_out, cudaStream_t st) {
  const unsigned long long* ck = keys;
  const int32_t* cp = pay;
  if (n > 1 && (mask & 0xFFu)) {
    cudaMemsetAsync(s.hist, 0, sizeof(uint32_t) * 8 * OS_RADIX, st);
    const int hb = rw_blocks(n, OS_THREADS);
    os_hist_kernel<<<hb < OS_HIST_BLOCKS ? hb : OS_HIST_BLOCKS, OS_THREADS, 0, st>>>(keys, n, mask,
                                                                                   s.hist);
    const int tiles = os_tiles(n);
    for (int b = 0; b < 8; ++b) {
      if (!((mask >> b) & 1u)) continue;
      unsigned long long* ok = ck == s.ka ? s.kb : s.ka;
      int32_t* op = cp == s.pa ? s.pb : s.pa;
      cudaMemsetAsync(s.status, 0, sizeof(uint32_t) * ((size_t)tiles * OS_RADIX + 1), st);
      os_pass_kernel<<<tiles, OS_THREADS, 0, st>>>(ck, cp, ok, op, n, 8 * b,
                                                   s.hist + b * OS_RADIX, s.status,
                                                   s.status + (size_t)tiles * OS_RADIX);
      ck = ok;
      cp = op;
    }
  }
  *keys_out = ck;
  *pay_out = cp;
}

// out[i] = word[pay[i]] (pay == nullptr: word[i])
static __global__ void os_gather_word_kernel(const unsigned long long* __restrict__ word,
                                             const int32_t* __restrict__ pay, int64_t m,
                                             unsigned long long* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m) out[i] = word[pay != nullptr ? pay[i] : i];
}

// m keys of `words` 64-bit words each (word w of key i at
// packed[w * stride + i], word 0 most significant), sorted stably by the
// bytes of mask[w], least significant word first, each earlier word
// gathered in the order so far (kernels AE and W). *key: the sorted first
// words (nullptr: no word); *pay: each sorted key's ent (one word or none)
// or its place among the m (more; nullptr: the places in order).
static inline void os_sort_words(const unsigned* mask, int words, int64_t m, int64_t stride,
                                 const unsigned long long* packed, const int32_t* ent,
                                 const OsScratch& s, const unsigned long long** key,
                                 const int32_t** pay, cudaStream_t st) {
  const unsigned long long* ck = nullptr;
  const int32_t* cp = words > 1 ? nullptr : ent;
  for (int w = words - 1; w >= 0; --w) {
    const unsigned long long* kin = packed + w * stride;
    if (w < words - 1) {
      unsigned long long* g = ck == s.ka ? s.kb : s.ka;
      os_gather_word_kernel<<<rw_blocks(m, OS_THREADS), OS_THREADS, 0, st>>>(kin, cp, m, g);
      kin = g;
    }
    os_sort(kin, cp, m, mask[w], s, &ck, &cp, st);
  }
  *key = ck;
  *pay = cp;
}
