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
// Three passes on one stream, no atomics deciding a position:
//   1. count: one block per (tile of EX_TILE rows, source shard) hashes
//      its rows with hashing.cuh's chain (AH's), keeps each row's
//      destination (-1 if invalid) in `dest` and the tile's count per
//      destination in `part`;
//   2. scan: one block per source shard turns its tiles' counts into
//      exclusive offsets per destination, writes counts[s][*] and
//      overflow[s];
//   3. scatter: each block ranks its rows per destination with block
//      scans in row order (thread t holds rows t*EX_ITEMS...), so a
//      row's position is its tile's offset plus the valid rows before
//      it: the reference's cumsum, slot for slot.
// The outputs are zeroed first (cudaMemsetAsync per lane).
//
// What bounds it on the card: bytes (every input lane read once, every
// output lane written once, plus the zero fill of unfilled slots).
//
// A lane is (src, dst, element size, shard stride): rows of a shard are
// contiguous, shards sit `stride` elements apart (0 for a lane broadcast
// to every shard). Elements of 1, 4 or 8 bytes.
#include "hashing.cuh"

#define EX_THREADS 256
#define EX_ITEMS 8
#define EX_TILE (EX_THREADS * EX_ITEMS)  // = parallel/exchange.py EX_TILE
#define EX_MAX_SHARDS 64
#define EX_MAX_LANES 64
#define EX_MAX_KEYS 8
#define EX_SEED 0xC0FFEEu
#define EX_VNODES 256u

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

__global__ void ex_count_kernel(ExKeys k, int n_shards, int64_t cap, const uint8_t* valid,
                                int64_t valid_stride, int32_t* dest, int32_t* part) {
  __shared__ int cnt[EX_MAX_SHARDS];
  const int tile = blockIdx.x, tiles = gridDim.x;
  const int64_t s = blockIdx.y;
  for (int d = threadIdx.x; d < n_shards; d += blockDim.x) cnt[d] = 0;
  __syncthreads();
  const int64_t base = (int64_t)tile * EX_TILE + (int64_t)threadIdx.x * EX_ITEMS;
  for (int j = 0; j < EX_ITEMS; ++j) {
    const int64_t r = base + j;
    if (r >= cap) break;
    int d = -1;
    if (valid[s * valid_stride + r]) {
      d = ex_dest(k, s, r, n_shards);
      atomicAdd(&cnt[d], 1);  // a count only: positions come from the scans
    }
    dest[s * cap + r] = d;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < n_shards; d += blockDim.x)
    part[((int64_t)s * tiles + tile) * n_shards + d] = cnt[d];
}

__global__ void ex_scan_kernel(int n_shards, int tiles, int64_t bucket_cap, int32_t* part,
                               int32_t* counts, uint8_t* overflow) {
  __shared__ int over;
  const int64_t s = blockIdx.x;
  if (threadIdx.x == 0) over = 0;
  __syncthreads();
  for (int d = threadIdx.x; d < n_shards; d += blockDim.x) {
    int run = 0;
    for (int t = 0; t < tiles; ++t) {
      int32_t* c = part + ((int64_t)s * tiles + t) * n_shards + d;
      const int v = *c;
      *c = run;
      run += v;
    }
    counts[s * n_shards + d] = run;
    if ((int64_t)run > bucket_cap) over = 1;
  }
  __syncthreads();
  if (threadIdx.x == 0) overflow[s] = (uint8_t)over;
}

__device__ __forceinline__ void ex_copy(void* dst, const void* src, int esize, int64_t o,
                                        int64_t i) {
  switch (esize) {
    case 1: ((uint8_t*)dst)[o] = ((const uint8_t*)src)[i]; break;
    case 4: ((uint32_t*)dst)[o] = ((const uint32_t*)src)[i]; break;
    case 8: ((unsigned long long*)dst)[o] = ((const unsigned long long*)src)[i]; break;
  }
}

__global__ void ex_scatter_kernel(ExLanes lanes, int n_shards, int64_t cap, int64_t bucket_cap,
                                  const int32_t* dest, const int32_t* part, uint8_t* out_valid) {
  const int tile = blockIdx.x, tiles = gridDim.x;
  const int64_t s = blockIdx.y;
  const int64_t base = (int64_t)tile * EX_TILE + (int64_t)threadIdx.x * EX_ITEMS;
  int d_of[EX_ITEMS];
  for (int j = 0; j < EX_ITEMS; ++j) d_of[j] = base + j < cap ? dest[s * cap + base + j] : -1;
  const int32_t* offs = part + ((int64_t)s * tiles + tile) * n_shards;
  const int64_t width = (int64_t)n_shards * bucket_cap;
  for (int d = 0; d < n_shards; ++d) {
    int mine = 0;
    for (int j = 0; j < EX_ITEMS; ++j) mine += d_of[j] == d;
    int excl;
    const int total = rw_block_exclusive_scan<EX_THREADS>(mine, &excl);
    if (total == 0 || mine == 0) continue;
    int64_t pos = (int64_t)offs[d] + excl;
    for (int j = 0; j < EX_ITEMS; ++j) {
      if (d_of[j] != d) continue;
      if (pos < bucket_cap) {
        const int64_t o = (int64_t)d * width + s * bucket_cap + pos;
        const int64_t r = base + j;
        for (int l = 0; l < lanes.n; ++l)
          ex_copy(lanes.dst[l], lanes.src[l], lanes.esize[l], o, s * lanes.stride[l] + r);
        out_valid[o] = 1;
      }
      ++pos;
    }
  }
}

// keys: n_keys rows of (pointer, dtype code, shard stride); lanes: n_lanes
// rows of (src, dst, element size, shard stride), each dst (n, n *
// bucket_cap); valid: (n, cap) bool at valid_stride per shard; out_valid:
// (n, n * bucket_cap) bool; counts: (n, n) int32; overflow: (n,) bool;
// dest: n * cap int32 and part: n * tiles * n int32 scratch, tiles =
// ceil(cap / EX_TILE).
RW_EXPORT int rw_exchange(const int64_t* keys, int n_keys, const int64_t* lanes, int n_lanes,
                          int n_shards, int64_t cap, int64_t bucket_cap, const void* valid,
                          int64_t valid_stride, void* out_valid, void* counts, void* overflow,
                          void* dest, void* part, void* stream) {
  if (n_keys < 1 || n_keys > EX_MAX_KEYS || n_lanes < 0 || n_lanes > EX_MAX_LANES ||
      n_shards < 1 || n_shards > EX_MAX_SHARDS || cap < 0 || bucket_cap < 0)
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
  const int64_t out_rows = (int64_t)n_shards * n_shards * bucket_cap;
  for (int l = 0; l < n_lanes; ++l)
    cudaMemsetAsync(t.dst[l], 0, (size_t)(out_rows * t.esize[l]), st);
  cudaMemsetAsync(out_valid, 0, (size_t)out_rows, st);
  const int tiles = cap > 0 ? (int)((cap + EX_TILE - 1) / EX_TILE) : 1;
  if (cap > 0) {
    dim3 grid(tiles, n_shards);
    ex_count_kernel<<<grid, EX_THREADS, 0, st>>>(k, n_shards, cap, (const uint8_t*)valid,
                                                 valid_stride, (int32_t*)dest, (int32_t*)part);
  } else {
    cudaMemsetAsync(part, 0, (size_t)n_shards * n_shards * sizeof(int32_t), st);
  }
  ex_scan_kernel<<<n_shards, EX_MAX_SHARDS, 0, st>>>(n_shards, tiles, bucket_cap,
                                                     (int32_t*)part, (int32_t*)counts,
                                                     (uint8_t*)overflow);
  if (cap > 0) {
    dim3 grid(tiles, n_shards);
    ex_scatter_kernel<<<grid, EX_THREADS, 0, st>>>(t, n_shards, cap, bucket_cap,
                                                   (const int32_t*)dest, (const int32_t*)part,
                                                   (uint8_t*)out_valid);
  }
  return (int)cudaGetLastError();
}
