// The stable LSD radix pass of 64-bit keys with an int32 payload, shared
// by kernel X (csrc/topn_rank.cu), AC's emit (csrc/arena.cu) and AD
// (csrc/over_step.cu).
//
// One pass sorts (key, payload) pairs by the 8-bit digit (key >> shift)
// & 0xFF in three launches: per-tile digit counts; per digit, an
// exclusive scan of its counts over the tiles; a scatter in which each
// tile first sorts its RBK_TILE keys by the digit locally with eight
// stable 1-bit splits in shared memory, so ranks within a digit keep the
// input order (an atomic counter would lose it) and the pass is stable.
// `hist` holds RBK_RADIX * tiles counts followed by the RBK_RADIX digit
// totals.
#pragma once

#include "common.cuh"

#define RBK_THREADS 256
#define RBK_ITEMS 8
#define RBK_TILE (RBK_THREADS * RBK_ITEMS)  // keys per block; = _kernels.RBK_TILE
#define RBK_RADIX 256
#define RBK_SCAN_THREADS 1024

static __global__ void rbk_hist_kernel(const unsigned long long* keys, int64_t n, int shift, int n_tiles,
                                int32_t* hist) {
  __shared__ int cnt[RBK_RADIX];
  for (int d = threadIdx.x; d < RBK_RADIX; d += blockDim.x) cnt[d] = 0;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * RBK_TILE;
#pragma unroll
  for (int j = 0; j < RBK_ITEMS; ++j) {
    const int64_t p = base + j * RBK_THREADS + threadIdx.x;
    if (p < n) atomicAdd(&cnt[(keys[p] >> shift) & 0xFF], 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < RBK_RADIX; d += blockDim.x)
    hist[(int64_t)d * n_tiles + blockIdx.x] = cnt[d];
}

// One block per digit: exclusive scan of its per-tile counts, in place,
// and the digit's total.
static __global__ void rbk_digit_scan_kernel(int32_t* hist, int n_tiles, int32_t* digit_total) {
  int32_t* row = hist + (int64_t)blockIdx.x * n_tiles;
  const int per = (n_tiles + RBK_SCAN_THREADS - 1) / RBK_SCAN_THREADS;
  const int lo = threadIdx.x * per;
  int local = 0;
  for (int t = lo; t < lo + per && t < n_tiles; ++t) local += row[t];
  int excl;
  const int total = rw_block_exclusive_scan<RBK_SCAN_THREADS>(local, &excl);
  int run = excl;
  for (int t = lo; t < lo + per && t < n_tiles; ++t) {
    const int c = row[t];
    row[t] = run;
    run += c;
  }
  if (threadIdx.x == 0) digit_total[blockIdx.x] = total;
}

static __global__ void rbk_scatter_kernel(const unsigned long long* keys_in, const int32_t* idx_in,
                                   unsigned long long* keys_out, int32_t* idx_out, int64_t n,
                                   int shift, int n_tiles, const int32_t* hist,
                                   const int32_t* digit_total) {
  __shared__ unsigned long long sk[RBK_TILE];
  __shared__ int32_t si[RBK_TILE];
  __shared__ int cnt[RBK_RADIX];
  __shared__ int tile_start[RBK_RADIX];
  __shared__ int digit_base[RBK_RADIX];
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * RBK_TILE;
  unsigned long long k[RBK_ITEMS];
  int32_t v[RBK_ITEMS];
  for (int d = t; d < RBK_RADIX; d += RBK_THREADS) cnt[d] = 0;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < RBK_ITEMS; ++j) {  // blocked: local position t * ITEMS + j
    const int64_t p = base + t * RBK_ITEMS + j;
    if (p < n) {
      k[j] = keys_in[p];
      v[j] = idx_in[p];
      atomicAdd(&cnt[(k[j] >> shift) & 0xFF], 1);
    } else {  // past the end: digit 255 at every pass, after every real row
      k[j] = ~0ull;
      v[j] = -1;
    }
  }
  // stable local sort by the digit: eight 1-bit splits, low bit first
  for (int b = 0; b < 8; ++b) {
    int zeros = 0;
#pragma unroll
    for (int j = 0; j < RBK_ITEMS; ++j) zeros += ((k[j] >> (shift + b)) & 1ull) ? 0 : 1;
    int excl;
    const int total_zeros = rw_block_exclusive_scan<RBK_THREADS>(zeros, &excl);
    int seen = 0;
#pragma unroll
    for (int j = 0; j < RBK_ITEMS; ++j) {
      const int local = t * RBK_ITEMS + j;
      int pos;
      if ((k[j] >> (shift + b)) & 1ull) {
        pos = total_zeros + (local - excl - seen);
      } else {
        pos = excl + seen;
        ++seen;
      }
      sk[pos] = k[j];
      si[pos] = v[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < RBK_ITEMS; ++j) {
      k[j] = sk[t * RBK_ITEMS + j];
      v[j] = si[t * RBK_ITEMS + j];
    }
    __syncthreads();
  }
  // where each digit's run starts in the tile, and in the output
  int e1, e2;
  const int c1 = t < RBK_RADIX ? cnt[t] : 0;
  const int d1 = t < RBK_RADIX ? digit_total[t] : 0;
  rw_block_exclusive_scan<RBK_THREADS>(c1, &e1);
  rw_block_exclusive_scan<RBK_THREADS>(d1, &e2);
  if (t < RBK_RADIX) {
    tile_start[t] = e1;
    digit_base[t] = e2 + hist[(int64_t)t * n_tiles + blockIdx.x];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < RBK_ITEMS; ++j) {
    if (v[j] < 0) continue;
    const int d = (int)((k[j] >> shift) & 0xFF);
    const int64_t dst = (int64_t)digit_base[d] + (t * RBK_ITEMS + j - tile_start[d]);
    keys_out[dst] = k[j];
    idx_out[dst] = v[j];
  }
}

static inline int rbk_tiles(int64_t n) { return (int)((n + RBK_TILE - 1) / RBK_TILE); }

// One pass: (keys_in, idx_in) sorted by the digit at `shift` into
// (keys_out, idx_out).
static inline void rbk_radix_pass(const unsigned long long* keys_in, const int32_t* idx_in,
                                  unsigned long long* keys_out, int32_t* idx_out, int64_t n,
                                  int shift, int32_t* hist, cudaStream_t st) {
  const int tiles = rbk_tiles(n);
  int32_t* digit_total = hist + (int64_t)RBK_RADIX * tiles;
  rbk_hist_kernel<<<tiles, RBK_THREADS, 0, st>>>(keys_in, n, shift, tiles, hist);
  rbk_digit_scan_kernel<<<RBK_RADIX, RBK_SCAN_THREADS, 0, st>>>(hist, tiles, digit_total);
  rbk_scatter_kernel<<<tiles, RBK_THREADS, 0, st>>>(keys_in, idx_in, keys_out, idx_out, n,
                                                        shift, tiles, hist, digit_total);
}
