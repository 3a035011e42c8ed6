// Kernel C: per-barrier flush of the dirty aggregation groups.
//
// Replaces risingwave_tpu/ops/agg.py:flush (:600).
//
// What it computes: the first out_cap dirty slots in ascending slot
// order, each emitted as an interleaved (old, new) row pair (U-/U+, D or
// I), with status = [n_take, overflow]; for those slots the emitted
// snapshot lanes are refreshed and dirty is cleared. Positions past
// n_take are zero-filled and invalid. Slots beyond out_cap stay dirty for
// the next round, so repeated rounds give the reference's union. On
// request the scan also writes the round's total of dirty groups (the
// fused program's dirty_groups counter, taken from its first round).
//
// What bounds it on the card: the dirty lane (one byte per slot, 16 MiB
// at 2^24 slots) is read twice, once to count and once to compact; the
// taken slots' lanes are gathered at random (8-byte accesses per lane)
// and the 2*out_cap delta rows are written coalesced.
//
// Design: stream compaction in three launches, no atomics, so the order
// is the reference's (ascending slot) without a sort:
//   1. count: each block counts the dirty slots of its 4096-slot tile,
//      16 per thread read as one 16-byte vector (bools are 0/1 bytes, so
//      popcount of each 32-bit word counts them);
//   2. scan: one block turns the per-tile counts into exclusive offsets
//      and writes status;
//   3. write: each block re-reads its tile, scans the per-thread counts
//      in shared memory and writes each dirty slot's row pair at its
//      global position, if that position is below out_cap; the same
//      launch zero-fills the unused tail of the delta.
#include "common.cuh"

#define FL_THREADS 256
#define FL_ITEMS 16
#define FL_TILE (FL_THREADS * FL_ITEMS)
#define FL_SCAN_THREADS 1024
#define FL_MAX_GATHER 16

enum FlushXform : int {
  X_COPY = 0,       // raw copy of esize bytes
  X_F32_KEY = 1,    // int64 order key -> float32
  X_F64_KEY = 2,    // int64 order key -> float64
  X_ISNULL = 3,     // old: bool copy; new: int64 non-null counter == 0
};

struct GatherLanes {
  const void* old_src[FL_MAX_GATHER];  // read at the slot for the old row
  const void* new_src[FL_MAX_GATHER];  // read at the slot for the new row
  void* out[FL_MAX_GATHER];            // (2 * out_cap,) delta lane
  int esize[FL_MAX_GATHER];            // bytes per element of out
  int xform[FL_MAX_GATHER];
  int n;
};

struct SnapLanes {  // emitted[s] = f(src[s]) for every taken slot
  const void* src[FL_MAX_GATHER];
  void* dst[FL_MAX_GATHER];
  int esize[FL_MAX_GATHER];
  int is_null_of_count[FL_MAX_GATHER];  // dst bool = (int64 src == 0)
  int n;
};

__device__ __forceinline__ int rw_dirty_flags(const uint8_t* dirty, int64_t cap, int64_t base,
                                              uint8_t* flags) {
  int cnt = 0;
  if (base + FL_ITEMS <= cap) {
    uint4 v = *(const uint4*)(dirty + base);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int b = 0; b < 4; ++b) flags[4 * q + b] = (w[q] >> (8 * b)) & 0xFFu ? 1 : 0;
      cnt += __popc(w[q]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < FL_ITEMS; ++j) {
      flags[j] = (base + j < cap && dirty[base + j]) ? 1 : 0;
      cnt += flags[j];
    }
  }
  return cnt;
}

__global__ void flush_count_kernel(const uint8_t* dirty, int64_t cap, int32_t* tile_counts) {
  uint8_t flags[FL_ITEMS];
  const int64_t base = (int64_t)blockIdx.x * FL_TILE + (int64_t)threadIdx.x * FL_ITEMS;
  int excl;
  const int total =
      rw_block_exclusive_scan<FL_THREADS>(rw_dirty_flags(dirty, cap, base, flags), &excl);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// One block: exclusive offsets of the per-tile counts, and status (and,
// if asked for, the round's dirty-group total).
__global__ void flush_scan_kernel(int32_t* tile_counts, int n_tiles, int32_t out_cap,
                                  int32_t* status, long long* dirty_total) {
  const int per = (n_tiles + FL_SCAN_THREADS - 1) / FL_SCAN_THREADS;
  const int lo = threadIdx.x * per;
  int local = 0;
  for (int j = lo; j < lo + per && j < n_tiles; ++j) local += tile_counts[j];
  int excl;
  const int total = rw_block_exclusive_scan<FL_SCAN_THREADS>(local, &excl);
  int run = excl;
  for (int j = lo; j < lo + per && j < n_tiles; ++j) {
    const int c = tile_counts[j];
    tile_counts[j] = run;
    run += c;
  }
  if (threadIdx.x == 0) {
    status[0] = total < out_cap ? total : out_cap;
    status[1] = total > out_cap ? 1 : 0;
    if (dirty_total != nullptr) *dirty_total = total;
  }
}

__device__ __forceinline__ void rw_copy_elem(void* dst, int64_t d, const void* src, int64_t s,
                                             int esize) {
  switch (esize) {
    case 1: ((uint8_t*)dst)[d] = ((const uint8_t*)src)[s]; break;
    case 4: ((uint32_t*)dst)[d] = ((const uint32_t*)src)[s]; break;
    case 8: ((unsigned long long*)dst)[d] = ((const unsigned long long*)src)[s]; break;
  }
}

__device__ __forceinline__ void rw_zero_elem(void* dst, int64_t d, int esize) {
  switch (esize) {
    case 1: ((uint8_t*)dst)[d] = 0; break;
    case 4: ((uint32_t*)dst)[d] = 0; break;
    case 8: ((unsigned long long*)dst)[d] = 0; break;
  }
}

__device__ __forceinline__ void rw_gather(const GatherLanes& g, int k, const void* src,
                                          int64_t s, int64_t d, bool is_old) {
  switch (g.xform[k]) {
    case X_COPY: rw_copy_elem(g.out[k], d, src, s, g.esize[k]); break;
    case X_F32_KEY:
      ((float*)g.out[k])[d] = rw_order_key_to_f32(((const long long*)src)[s]);
      break;
    case X_F64_KEY:
      ((double*)g.out[k])[d] = rw_order_key_to_f64(((const long long*)src)[s]);
      break;
    case X_ISNULL:
      ((uint8_t*)g.out[k])[d] = is_old ? (((const uint8_t*)src)[s] ? 1 : 0)
                                       : (((const long long*)src)[s] == 0 ? 1 : 0);
      break;
  }
}

__global__ void flush_write_kernel(GatherLanes g, SnapLanes snap, uint8_t* dirty, int64_t cap,
                                   const int32_t* tile_offsets, const int32_t* status,
                                   int32_t out_cap, const long long* row_count,
                                   uint8_t* emitted_valid, int32_t* ops, uint8_t* valid) {
  uint8_t flags[FL_ITEMS];
  const int64_t base = (int64_t)blockIdx.x * FL_TILE + (int64_t)threadIdx.x * FL_ITEMS;
  int excl;
  rw_block_exclusive_scan<FL_THREADS>(rw_dirty_flags(dirty, cap, base, flags), &excl);
  int64_t pos = (int64_t)tile_offsets[blockIdx.x] + excl;
#pragma unroll 1
  for (int j = 0; j < FL_ITEMS; ++j) {
    if (!flags[j]) continue;
    if (pos >= out_cap) break;
    const int64_t s = base + j;
    const bool live = row_count[s] > 0;
    const bool was = emitted_valid[s] != 0;
    const int64_t d0 = 2 * pos, d1 = 2 * pos + 1;
    ops[d0] = live ? 2 : 1;  // UPDATE_DELETE : DELETE
    ops[d1] = was ? 3 : 0;   // UPDATE_INSERT : INSERT
    valid[d0] = was ? 1 : 0;
    valid[d1] = live ? 1 : 0;
    for (int k = 0; k < g.n; ++k) {
      rw_gather(g, k, g.old_src[k], s, d0, true);
      rw_gather(g, k, g.new_src[k], s, d1, false);
    }
    for (int k = 0; k < snap.n; ++k) {
      if (snap.is_null_of_count[k])
        ((uint8_t*)snap.dst[k])[s] = ((const long long*)snap.src[k])[s] == 0 ? 1 : 0;
      else
        rw_copy_elem(snap.dst[k], s, snap.src[k], s, snap.esize[k]);
    }
    emitted_valid[s] = live ? 1 : 0;
    dirty[s] = 0;
    ++pos;
  }
  // zero-fill the delta rows past n_take
  const int64_t n_take = status[0];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x + n_take; p < out_cap;
       p += stride) {
    for (int64_t d = 2 * p; d < 2 * p + 2; ++d) {
      ops[d] = 0;
      valid[d] = 0;
      for (int k = 0; k < g.n; ++k) rw_zero_elem(g.out[k], d, g.esize[k]);
    }
  }
}

// gather: n_gather rows of (old_src, new_src, out, esize, xform), int64.
// snap: n_snap rows of (src, dst, esize, is_null_of_count), int64.
// tile_counts: ceil(cap / 4096) int32 scratch. dirty_total: an int64
// that receives the number of dirty groups before this round, or null.
RW_EXPORT int rw_agg_flush(const int64_t* gather, int n_gather, const int64_t* snapv,
                           int n_snap, void* dirty, int64_t cap, void* tile_counts,
                           void* status, int out_cap, const void* row_count,
                           void* emitted_valid, void* ops, void* valid, void* dirty_total,
                           void* stream) {
  if (n_gather < 0 || n_gather > FL_MAX_GATHER || n_snap < 0 || n_snap > FL_MAX_GATHER)
    return (int)cudaErrorInvalidValue;
  GatherLanes g;
  g.n = n_gather;
  for (int k = 0; k < n_gather; ++k) {
    const int64_t* r = gather + 5 * k;
    g.old_src[k] = (const void*)r[0];
    g.new_src[k] = (const void*)r[1];
    g.out[k] = (void*)r[2];
    g.esize[k] = (int)r[3];
    g.xform[k] = (int)r[4];
  }
  SnapLanes sn;
  sn.n = n_snap;
  for (int k = 0; k < n_snap; ++k) {
    const int64_t* r = snapv + 4 * k;
    sn.src[k] = (const void*)r[0];
    sn.dst[k] = (void*)r[1];
    sn.esize[k] = (int)r[2];
    sn.is_null_of_count[k] = (int)r[3];
  }
  const int n_tiles = (int)((cap + FL_TILE - 1) / FL_TILE);
  cudaStream_t st = (cudaStream_t)stream;
  flush_count_kernel<<<n_tiles, FL_THREADS, 0, st>>>((const uint8_t*)dirty, cap,
                                                     (int32_t*)tile_counts);
  flush_scan_kernel<<<1, FL_SCAN_THREADS, 0, st>>>((int32_t*)tile_counts, n_tiles,
                                                   (int32_t)out_cap, (int32_t*)status,
                                                   (long long*)dirty_total);
  flush_write_kernel<<<n_tiles, FL_THREADS, 0, st>>>(
      g, sn, (uint8_t*)dirty, cap, (const int32_t*)tile_counts, (const int32_t*)status,
      (int32_t)out_cap, (const long long*)row_count, (uint8_t*)emitted_valid,
      (int32_t*)ops, (uint8_t*)valid);
  return (int)cudaGetLastError();
}
