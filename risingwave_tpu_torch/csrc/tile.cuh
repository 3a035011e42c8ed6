// Row tiling shared by kernel E (hop_expand.cu) and kernel AA
// (tile_expand.cu): the by-value lane table, the raw element copy and the
// grid rule. Both lay copy i of row r of a chunk of capacity C at output
// row i * C + r (E per chunk of a stacked epoch).
#pragma once
#include "common.cuh"

#define RW_TILE_MAX_LANES 32
#define RW_TILE_THREADS 256
#define RW_TILE_MAX_BLOCKS (132 * 32)

// lane modes
#define RW_TILE_COPY 0    // the element copied as it is
#define RW_TILE_SUBSET 1  // a null lane: copy i keeps the row's null bit (0
                          // without a source) where bit i of keep is set,
                          // and sets 1 elsewhere

struct RwTileLanes {
  const void* src[RW_TILE_MAX_LANES];  // input lane; a subset lane may have none
  void* dst[RW_TILE_MAX_LANES];        // output lane
  unsigned long long keep[RW_TILE_MAX_LANES];
  int esize[RW_TILE_MAX_LANES];
  int mode[RW_TILE_MAX_LANES];
  int n;
};

__device__ __forceinline__ void rw_tile_copy(void* dst, const void* src, int esize, int64_t o,
                                             int64_t r) {
  switch (esize) {
    case 1: ((uint8_t*)dst)[o] = ((const uint8_t*)src)[r]; break;
    case 4: ((uint32_t*)dst)[o] = ((const uint32_t*)src)[r]; break;
    case 8: ((unsigned long long*)dst)[o] = ((const unsigned long long*)src)[r]; break;
  }
}

// Every lane of the table for copy i: input row r to output row o.
__device__ __forceinline__ void rw_tile_row(const RwTileLanes& lanes, int i, int64_t o,
                                            int64_t r) {
  for (int l = 0; l < lanes.n; ++l) {
    if (lanes.mode[l] == RW_TILE_COPY) {
      rw_tile_copy(lanes.dst[l], lanes.src[l], lanes.esize[l], o, r);
    } else {
      const bool kept = (lanes.keep[l] >> i) & 1ull;
      const uint8_t base = lanes.src[l] != nullptr ? ((const uint8_t*)lanes.src[l])[r] : 0;
      ((uint8_t*)lanes.dst[l])[o] = kept ? base : 1;
    }
  }
}

// rows: n_lanes rows of int64, (src, dst, esize) when width is 3, or
// (src or 0, dst, esize, mode, keep) when it is 5. 0 on a bad table.
static int rw_tile_lanes(const int64_t* rows, int n_lanes, int width, RwTileLanes* t) {
  if (n_lanes < 0 || n_lanes > RW_TILE_MAX_LANES || (width != 3 && width != 5)) return 0;
  t->n = n_lanes;
  for (int l = 0; l < n_lanes; ++l) {
    const int64_t* r = rows + width * l;
    t->src[l] = (const void*)r[0];
    t->dst[l] = (void*)r[1];
    t->esize[l] = (int)r[2];
    t->mode[l] = width == 5 ? (int)r[3] : RW_TILE_COPY;
    t->keep[l] = width == 5 ? (unsigned long long)r[4] : 0ull;
    if (t->esize[l] != 1 && t->esize[l] != 4 && t->esize[l] != 8) return 0;
    if (t->mode[l] == RW_TILE_COPY ? t->src[l] == nullptr
                                   : (t->mode[l] != RW_TILE_SUBSET || t->esize[l] != 1))
      return 0;
  }
  return 1;
}

// Blocks of RW_TILE_THREADS for a grid-stride loop over total items.
static inline int rw_tile_blocks(int64_t total) {
  int64_t blocks = (total + RW_TILE_THREADS - 1) / RW_TILE_THREADS;
  return (int)(blocks > RW_TILE_MAX_BLOCKS ? RW_TILE_MAX_BLOCKS : blocks);
}
