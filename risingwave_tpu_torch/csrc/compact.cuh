// A stream compaction of slot lanes, shared by kernel R's stage select
// (csrc/checkpoint.cu), kernel Z's right-value diff (csrc/dyn_general.cu)
// and, in its coalesced form (compact_warp_place), kernel X's live rows
// (csrc/topn_rank.cu).
//
// Three launches on one stream: each block evaluates its COMPACT_TILE-slot
// tile through a flag functor and writes the tile's count; one block turns
// the tile counts into exclusive offsets (scan.cuh's top scan, the total
// after them); each block re-evaluates its tile and writes its selected
// slots at their global positions, with one payload byte each. No atomics
// decide a position, so the order is ascending slot without a sort.
//
// The functor F gives:
//   int flags(int64_t cap, int64_t base, uint8_t* f, int* aux): for the
//     COMPACT_ITEMS slots from base, f[j] bit 0 = selected, bit 1 = the
//     payload byte written beside the slot; returns the selected count.
//     With F::kAux, *aux is a second count summed into status[1].
//   void on_select(int64_t s, uint8_t f): the side writes of a selected
//     slot (only the thread that evaluated s touches it).
//   void on_total(long long* status): after status[0] = the selected
//     count, once.
#pragma once

#include "common.cuh"
#include "scan.cuh"

#define COMPACT_THREADS 256
#define COMPACT_ITEMS 16
#define COMPACT_TILE (COMPACT_THREADS * COMPACT_ITEMS)  // = _kernels.COMPACT_TILE

template <class F>
__global__ void compact_count_kernel(F fn, int64_t cap, int32_t* part,
                                     unsigned long long* status) {
  uint8_t f[COMPACT_ITEMS];
  const int64_t base =
      (int64_t)blockIdx.x * COMPACT_TILE + (int64_t)threadIdx.x * COMPACT_ITEMS;
  int aux = 0, excl;
  const int total = rw_block_exclusive_scan<COMPACT_THREADS>(fn.flags(cap, base, f, &aux), &excl);
  if (F::kAux) {
    const int total_aux = rw_block_exclusive_scan<COMPACT_THREADS>(aux, &excl);
    if (threadIdx.x == 0 && total_aux) atomicAdd(status + 1, (unsigned long long)total_aux);
  }
  if (threadIdx.x == 0) part[blockIdx.x] = total;
}

template <class F>
__global__ void compact_write_kernel(F fn, int64_t cap, const int32_t* part, int n_tiles,
                                     int32_t* sel, uint8_t* payload, long long* status) {
  uint8_t f[COMPACT_ITEMS];
  const int64_t base =
      (int64_t)blockIdx.x * COMPACT_TILE + (int64_t)threadIdx.x * COMPACT_ITEMS;
  int aux, excl;
  rw_block_exclusive_scan<COMPACT_THREADS>(fn.flags(cap, base, f, &aux), &excl);
  int64_t pos = (int64_t)part[blockIdx.x] + excl;
#pragma unroll
  for (int j = 0; j < COMPACT_ITEMS; ++j) {
    if (!(f[j] & 1)) continue;
    const int64_t s = base + j;
    sel[pos] = (int32_t)s;
    payload[pos] = (f[j] >> 1) & 1;
    fn.on_select(s, f[j]);
    ++pos;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    status[0] = part[n_tiles];
    fn.on_total(status);
  }
}

static inline int compact_tiles(int64_t cap) {
  return (int)((cap + COMPACT_TILE - 1) / COMPACT_TILE);
}

// A coalesced form of the write pass, for a kernel that walks its tile
// itself (kernel X's live rows): each warp takes COMPACT_ITEMS rounds of
// 32 consecutive slots (compact_round_slot), so every round reads 32
// neighbouring slots. compact_warp_place gives the place in slot order of
// the first selected slot of the calling warp's rounds (sel: bit r set
// where the thread's slot of round r is selected), from the tile's offset
// (part[] after scan_top_kernel): the warps' counts by ballots, then one
// pass over them in shared memory. Every thread of the block calls it; a
// round's selected slot then lands at place + popc(ballot & lanes below),
// and place moves on by popc(ballot).
__device__ __forceinline__ int64_t compact_round_slot(int64_t tile, int r) {
  return tile * COMPACT_TILE + (int64_t)(threadIdx.x >> 5) * (32 * COMPACT_ITEMS) + 32 * r +
         (threadIdx.x & 31);
}

__device__ __forceinline__ int64_t compact_warp_place(unsigned sel, int64_t tile_off) {
  __shared__ int warp_count[COMPACT_THREADS / 32];
  const int warp = threadIdx.x >> 5;
  int count = 0;
#pragma unroll
  for (int r = 0; r < COMPACT_ITEMS; ++r)
    count += __popc(__ballot_sync(0xFFFFFFFFu, (sel >> r) & 1u));
  if ((threadIdx.x & 31) == 0) warp_count[warp] = count;
  __syncthreads();
  int64_t off = tile_off;
  for (int w = 0; w < warp; ++w) off += warp_count[w];
  return off;
}

// sel: (cap,) int32 and payload: (cap,) bytes, their first status[0]
// entries written; part: compact_tiles(cap) + 1 int32 scratch; status:
// (2,) int64, zeroed first.
template <class F>
static inline void rw_compact(const F& fn, int64_t cap, int32_t* part, int32_t* sel,
                              uint8_t* payload, long long* status, cudaStream_t st) {
  cudaMemsetAsync(status, 0, 2 * sizeof(long long), st);
  if (cap <= 0) return;
  const int tiles = compact_tiles(cap);
  compact_count_kernel<<<tiles, COMPACT_THREADS, 0, st>>>(fn, cap, part,
                                                          (unsigned long long*)status);
  scan_top_kernel<<<1, SCAN_TOP_THREADS, 0, st>>>(part, tiles);
  compact_write_kernel<<<tiles, COMPACT_THREADS, 0, st>>>(fn, cap, part, tiles, sel, payload,
                                                          status);
}
