// Kernel AI: the vnode hash exchange of a stacked chunk (K31).
//
// Replaces risingwave_tpu/parallel/exchange.py: dest_shard (:47),
// pack_buckets (:69) and exchange_chunk (:111), whose all_to_all moves
// bucket d of shard s to slot s of shard d. Every shard of the mesh is
// stacked on one card, so one launch takes the whole (n, cap) chunk and
// writes each row where the all_to_all lands it:
//
//   dest(s, r) = hash_columns(keys(s, r), seed 0xC0FFEE) % 256 % n
//   pos(s, r)  = #{r' < r : valid(s, r') && dest(s, r') == dest(s, r)}
//   out[d][s * bucket_cap + pos] = lane(s, r) for every lane, when
//                                  valid(s, r), d = dest(s, r) and
//                                  pos < bucket_cap
//   counts[s][d] = #{r : valid(s, r) && dest(s, r) == d}
//   overflow[s]  = any_d counts[s][d] > bucket_cap
//
// Unfilled output slots are zero in every lane (the reference's
// jnp.zeros buckets); a row past bucket_cap writes nothing.
//
// What bounds it on the card: bytes (every input lane read once, every
// output slot of every lane written once, filled or zero).
//
// Design: one memset, then one launch routes, places and writes. The
// memset zeroes one buffer that holds every output lane, valid and the
// look-back words (the wrapper views it per lane): a fill at the card's
// full rate, which the bound counts anyway (every output slot written
// once). The counts and flags are written whole, so they need no fill. Tiles of EX_TILE rows take their
// index from one atomic counter, source by source. A tile hashes its
// rows with hashing.cuh's chain (AH's) and ranks each among the tile's
// rows of its destination by warp matching (__match_any_sync on the
// destination, as csrc/onesweep.cuh does with its digits: input order
// kept), publishes its count per destination at once and finds the
// counts of the same source's earlier tiles by a decoupled look-back (a
// thread per destination; a word that never publishes traps after 2^26
// reads rather than hang). A row's place is then the reference's cumsum,
// slot for slot. The tile stages its rows in shared memory in
// destination order and writes each lane as runs, neighbouring threads
// on neighbouring slots of a bucket. The last tile of a source writes
// its counts and flag.
//
// A lane is (src, dst, element size, shard stride): rows of a shard are
// contiguous, shards sit `stride` elements apart (0 for a lane broadcast
// to every shard). Elements of 1, 4 or 8 bytes.
#include "hashing.cuh"

#define EX_THREADS 256
#define EX_WARPS (EX_THREADS / 32)
#define EX_ITEMS 8
#define EX_TILE (EX_THREADS * EX_ITEMS)  // = parallel/exchange.py EX_TILE
#define EX_MAX_SHARDS 64
#define EX_MAX_LANES 64
#define EX_MAX_KEYS 8
#define EX_SEED 0xC0FFEEu
#define EX_VNODES 256u
// a tile's published word for one destination: a flag and a count below 2^30
#define EX_AGG 0x40000000u  // the tile's own count
#define EX_INC 0x80000000u  // the count of this tile and every earlier one of its source
#define EX_COUNT 0x3FFFFFFFu

struct ExKeys {
  const void* p[EX_MAX_KEYS];
  int64_t stride[EX_MAX_KEYS];
  int dt[EX_MAX_KEYS];
  int n;
};

struct ExLanes {
  const void* src[EX_MAX_LANES];
  void* dst[EX_MAX_LANES];
  int64_t stride[EX_MAX_LANES];
  int esize[EX_MAX_LANES];
  int n;
};

__device__ __forceinline__ int ex_dest(const ExKeys& k, int64_t s, int64_t r, int n_shards) {
  uint32_t h = RW_HASH_INIT ^ EX_SEED, unused = 0u;
  for (int l = 0; l < k.n; ++l) rw_hash_lane(k.p[l], k.dt[l], s * k.stride[l] + r, h, unused);
  return (int)((rw_mix32(h) % EX_VNODES) % (uint32_t)n_shards);
}

// dst[o[m]] = src[row[m]] where o[m] >= 0
template <typename E>
__device__ __forceinline__ void ex_copy(void* dst, const void* src, const int64_t* o,
                                        const int* row) {
#pragma unroll
  for (int m = 0; m < EX_ITEMS; ++m)
    if (o[m] >= 0) ((E*)dst)[o[m]] = __ldg((const E*)src + row[m]);
}

__global__ void __launch_bounds__(EX_THREADS)
    ex_kernel(ExKeys k, ExLanes L, int n_shards, int64_t cap, int64_t bucket_cap, int tiles,
              const uint8_t* __restrict__ valid, int64_t valid_stride,
              uint8_t* __restrict__ out_valid, int32_t* counts, uint8_t* overflow, uint32_t* status,
              uint32_t* counter) {
  __shared__ uint32_t s_q;
  __shared__ int s_over;
  __shared__ uint32_t whist[EX_WARPS][EX_MAX_SHARDS];  // per warp: counts, then offsets
  __shared__ uint32_t tstart[EX_MAX_SHARDS];           // a destination's first staged place
  __shared__ int64_t gpos[EX_MAX_SHARDS];              // ... its first bucket place
  __shared__ uint16_t srow[EX_TILE];                   // staged rows, in destination order
  __shared__ uint8_t sdst[EX_TILE];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n = n_shards;
  if (t == 0) {
    s_q = atomicAdd(counter, 1u);
    s_over = 0;
  }
  for (int i = t; i < EX_WARPS * EX_MAX_SHARDS; i += EX_THREADS) (&whist[0][0])[i] = 0;
  __syncthreads();
  const int64_t width = (int64_t)n * bucket_cap;
  const int64_t q = s_q;
  const int64_t s = q / tiles, tile = q % tiles;
  const int64_t tile_base = tile * EX_TILE;
  uint32_t* words = status + s * tiles * n;  // this source's words, [tile][destination]
  // warp w holds rows [256 w, 256 w + 256) of the tile, round j its 32
  // rows from 256 w + 32 j: (round, lane) is row order
  const unsigned below = (1u << lane) - 1u;
  int d_of[EX_ITEMS];
  uint32_t rank[EX_ITEMS];
#pragma unroll
  for (int j = 0; j < EX_ITEMS; ++j) {
    const int64_t r = tile_base + warp * (32 * EX_ITEMS) + j * 32 + lane;
    const bool ok = r < cap && valid[s * valid_stride + r];
    const int d = ok ? ex_dest(k, s, r, n) : EX_MAX_SHARDS;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    const uint32_t before = ok ? whist[warp][d] : 0u;
    __syncwarp();
    if (ok && (peers & below) == 0u) whist[warp][d] = before + (uint32_t)__popc(peers);
    __syncwarp();
    rank[j] = before + (uint32_t)__popc(peers & below);
    d_of[j] = d;
  }
  __syncthreads();
  // thread d < n owns destination d: the warps' offsets, the tile's count
  uint32_t count = 0;
  if (t < n) {
    for (int w = 0; w < EX_WARPS; ++w) {
      const uint32_t c = whist[w][t];
      whist[w][t] = count;
      count += c;
    }
    *(volatile uint32_t*)(words + tile * n + t) = (tile == 0 ? EX_INC : EX_AGG) | count;
  }
  int excl;
  const int staged = rw_block_exclusive_scan<EX_THREADS>(t < n ? (int)count : 0, &excl);
  if (t < n) {
    uint32_t prefix = 0;
    if (tile > 0) {
      for (int64_t qq = tile - 1; qq >= 0; --qq) {
        const volatile uint32_t* w = words + qq * n + t;
        uint32_t v;
        int64_t spins = 0;
        do {
          v = *w;
          if (++spins > RW_SPIN_LIMIT) __trap();
        } while ((v & (EX_AGG | EX_INC)) == 0u);
        prefix += v & EX_COUNT;
        if (v & EX_INC) break;
      }
      *(volatile uint32_t*)(words + tile * n + t) = EX_INC | (prefix + count);
    }
    tstart[t] = (uint32_t)excl;
    gpos[t] = prefix;
    if (tile == tiles - 1) {
      counts[s * n + t] = (int32_t)(prefix + count);
      if ((int64_t)(prefix + count) > bucket_cap) s_over = 1;
    }
  }
  __syncthreads();
  if (tile == tiles - 1 && t == 0) overflow[s] = s_over ? 1 : 0;
#pragma unroll
  for (int j = 0; j < EX_ITEMS; ++j) {
    const int d = d_of[j];
    if (d >= n) continue;
    const uint32_t at = tstart[d] + whist[warp][d] + rank[j];
    srow[at] = (uint16_t)(warp * (32 * EX_ITEMS) + j * 32 + lane);
    sdst[at] = (uint8_t)d;
  }
  __syncthreads();
  // this thread's staged places i = t + 256 m: a run of one destination
  // lies on neighbouring threads and neighbouring bucket slots
  int64_t o[EX_ITEMS];
  int row[EX_ITEMS];
#pragma unroll
  for (int m = 0; m < EX_ITEMS; ++m) {
    const int i = t + m * EX_THREADS;
    o[m] = -1;
    row[m] = 0;
    if (i < staged) {
      const int d = sdst[i];
      const int64_t pos = gpos[d] + (i - (int)tstart[d]);
      if (pos < bucket_cap) {
        o[m] = d * width + s * bucket_cap + pos;
        row[m] = srow[i];
      }
    }
  }
  for (int l = 0; l < L.n; ++l) {
    const void* src = (const char*)L.src[l] + (s * L.stride[l] + tile_base) * L.esize[l];
    switch (L.esize[l]) {
      case 1: ex_copy<uint8_t>(L.dst[l], src, o, row); break;
      case 4: ex_copy<uint32_t>(L.dst[l], src, o, row); break;
      default: ex_copy<unsigned long long>(L.dst[l], src, o, row); break;
    }
  }
#pragma unroll
  for (int m = 0; m < EX_ITEMS; ++m)
    if (o[m] >= 0) out_valid[o[m]] = 1;
}

// keys: n_keys rows of (pointer, dtype code, shard stride); lanes: n_lanes
// rows of (src, dst, element size, shard stride), each dst (n, n *
// bucket_cap); valid: (n, cap) bool at valid_stride per shard; out_valid:
// (n, n * bucket_cap) bool; counts: (n, n) int32 and overflow: (n,) bool,
// every element written;
// scratch: n * tiles * n + 1 int32, tiles = max(1, ceil(cap / EX_TILE));
// zero: zero_bytes bytes zeroed first, holding every output lane,
// out_valid and scratch (parallel/exchange.py lays it out).
RW_EXPORT int rw_exchange(const int64_t* keys, int n_keys, const int64_t* lanes, int n_lanes,
                          int n_shards, int64_t cap, int64_t bucket_cap, const void* valid,
                          int64_t valid_stride, void* out_valid, void* counts, void* overflow,
                          void* scratch, void* zero, int64_t zero_bytes, void* stream) {
  if (n_keys < 1 || n_keys > EX_MAX_KEYS || n_lanes < 0 || n_lanes > EX_MAX_LANES ||
      n_shards < 1 || n_shards > EX_MAX_SHARDS || cap < 0 || cap > (int64_t)EX_COUNT ||
      bucket_cap < 0 || zero_bytes < 0)
    return (int)cudaErrorInvalidValue;
  ExKeys k;
  k.n = n_keys;
  for (int l = 0; l < n_keys; ++l) {
    k.p[l] = (const void*)keys[3 * l];
    k.dt[l] = (int)keys[3 * l + 1];
    k.stride[l] = keys[3 * l + 2];
    if (k.dt[l] < RW_BOOL || k.dt[l] > RW_F64) return (int)cudaErrorInvalidValue;
  }
  ExLanes t;
  t.n = n_lanes;
  for (int l = 0; l < n_lanes; ++l) {
    t.src[l] = (const void*)lanes[4 * l];
    t.dst[l] = (void*)lanes[4 * l + 1];
    t.esize[l] = (int)lanes[4 * l + 2];
    t.stride[l] = lanes[4 * l + 3];
    if (t.esize[l] != 1 && t.esize[l] != 4 && t.esize[l] != 8) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = cap > 0 ? (int)((cap + EX_TILE - 1) / EX_TILE) : 1;
  const size_t words = (size_t)n_shards * tiles * n_shards;
  cudaMemsetAsync(zero, 0, (size_t)zero_bytes, st);
  ex_kernel<<<n_shards * tiles, EX_THREADS, 0, st>>>(
      k, t, n_shards, cap, bucket_cap, tiles, (const uint8_t*)valid, valid_stride,
      (uint8_t*)out_valid, (int32_t*)counts, (uint8_t*)overflow, (uint32_t*)scratch,
      (uint32_t*)scratch + words);
  return (int)cudaGetLastError();
}
