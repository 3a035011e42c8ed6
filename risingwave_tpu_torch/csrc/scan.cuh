// A device-wide exclusive scan of int32 counts, shared by kernels U and X.
//
// Three launches on one stream: per tile of SCAN_TILE elements its sum;
// one block scans the tile sums (and writes the grand total after them);
// per tile the exclusive scan of its elements plus its tile's offset.
// `in` and `out` may be the same array. `part` holds tiles + 1 words.
#pragma once

#include "common.cuh"

#define SCAN_THREADS 256
#define SCAN_ITEMS 8
#define SCAN_TILE (SCAN_THREADS * SCAN_ITEMS)  // = _kernels.SCAN_TILE
#define SCAN_TOP_THREADS 1024

static __global__ void scan_tile_sum_kernel(const int32_t* in, int64_t n, int32_t* part) {
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE + (int64_t)threadIdx.x * SCAN_ITEMS;
  int local = 0;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j)
    if (base + j < n) local += in[base + j];
  int excl;
  const int total = rw_block_exclusive_scan<SCAN_THREADS>(local, &excl);
  if (threadIdx.x == 0) part[blockIdx.x] = total;
}

static __global__ void scan_top_kernel(int32_t* part, int n_tiles) {
  const int per = (n_tiles + SCAN_TOP_THREADS - 1) / SCAN_TOP_THREADS;
  const int lo = threadIdx.x * per;
  int local = 0;
  for (int t = lo; t < lo + per && t < n_tiles; ++t) local += part[t];
  int excl;
  const int total = rw_block_exclusive_scan<SCAN_TOP_THREADS>(local, &excl);
  int run = excl;
  for (int t = lo; t < lo + per && t < n_tiles; ++t) {
    const int c = part[t];
    part[t] = run;
    run += c;
  }
  if (threadIdx.x == 0) part[n_tiles] = total;
}

static __global__ void scan_apply_kernel(const int32_t* in, int64_t n, const int32_t* part,
                                         int32_t* out) {
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE + (int64_t)threadIdx.x * SCAN_ITEMS;
  int v[SCAN_ITEMS];
  int local = 0;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    v[j] = base + j < n ? in[base + j] : 0;
    local += v[j];
  }
  int excl;
  rw_block_exclusive_scan<SCAN_THREADS>(local, &excl);
  int run = part[blockIdx.x] + excl;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    if (base + j < n) out[base + j] = run;
    run += v[j];
  }
}

static inline int scan_tiles(int64_t n) {
  return n > 0 ? (int)((n + SCAN_TILE - 1) / SCAN_TILE) : 1;
}

// out[i] = in[0] + ... + in[i - 1]; the total lands in part[scan_tiles(n)].
static inline void rw_exclusive_scan(const int32_t* in, int64_t n, int32_t* part, int32_t* out,
                                     cudaStream_t st) {
  const int tiles = scan_tiles(n);
  scan_tile_sum_kernel<<<tiles, SCAN_THREADS, 0, st>>>(in, n, part);
  scan_top_kernel<<<1, SCAN_TOP_THREADS, 0, st>>>(part, tiles);
  scan_apply_kernel<<<tiles, SCAN_THREADS, 0, st>>>(in, n, part, out);
}
