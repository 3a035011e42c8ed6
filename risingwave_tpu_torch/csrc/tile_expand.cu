// Kernel AA: tiled row expansion of a chunk (ProjectSet and Expand).
//
// Replaces, one launch per chunk each:
//   rw_unnest: risingwave_tpu/executors/project_set.py:_unnest_step (:31)
//   rw_series: risingwave_tpu/executors/project_set.py:_series_step (:54)
//   rw_expand: risingwave_tpu/executors/expand.py:_expand_step (:29)
// All three turn a chunk of capacity C into one of capacity C * k: copy i
// of row r sits at output row i * C + r, so copy i is the i-th contiguous
// block of C rows and U-/U+ pairs stay adjacent (as kernel E's hop). Every
// output lane of the chunk is written by the one launch:
//   - the tiled lanes: value and null lanes copied as raw 1-, 4- or 8-byte
//     elements (mode 0), or, for Expand's grouping-set columns, a null lane
//     that copy i keeps (the row's null bit, 0 without a lane) where bit i
//     of the lane's keep mask is set and sets to 1 elsewhere (mode 1);
//   - ops (tiled) and valid: unnest keeps copy i where i < the list's
//     length, series where start + i <= stop and neither bound is NULL,
//     expand every copy of a valid row;
//   - the new columns: unnest's value (element lane i of the list, the
//     list's own lanes dropped by the wrapper), series' value (start + i,
//     int64), and the copy index i as int64 (projected_row_id, or Expand's
//     flag), where asked.
//
// What bounds it on the card: bytes. Each input lane is read k times (the
// k reads of a row fall in k blocks of the output and mostly hit L2) and
// every output lane written once, all coalesced; there is no arithmetic
// to speak of.
//
// The truncation latch: copy 0 of a valid row whose list is longer than
// k (unnest), or whose non-NULL bounds span more than k (series), sets a
// device byte to 1 (a plain store; every writer writes the same value).
//
// Design: one thread per output row, grid-stride; for a fixed copy the
// threads of a warp read and write neighbouring addresses. The lane table
// (tile.cuh, shared with kernel E) and unnest's element pointers are
// passed by value.
#include "tile.cuh"

#define TE_MAX_COPIES 64

#define TE_UNNEST 0
#define TE_SERIES 1
#define TE_EXPAND 2

struct TileElems {
  const void* src[TE_MAX_COPIES];  // unnest: element lane i of the list, (cap,)
};

// What varies between the three entries.
struct TileSpec {
  int kind;
  int esize;             // unnest: the element size of value
  const void* a;         // unnest: the length lane; series: start
  int a_esize;           // 4 or 8 (signed)
  const void* b;         // series: stop
  int b_esize;
  const uint8_t* a_null; // series: start's null lane or null
  const uint8_t* b_null; // series: stop's null lane or null
  void* value;           // unnest / series: the output column
  long long* index;      // the copy index as int64, or null
  uint8_t* latch;        // unnest / series: the truncation latch, or null
};

__device__ __forceinline__ long long te_int(const void* p, int esize, int64_t r) {
  return esize == 4 ? (long long)((const int32_t*)p)[r] : ((const long long*)p)[r];
}

__global__ void tile_expand_kernel(RwTileLanes lanes, TileElems elems, TileSpec sp, int64_t cap,
                                   int k, const uint8_t* valid, const int32_t* ops,
                                   uint8_t* valid_out, int32_t* ops_out) {
  const int64_t total = cap * (int64_t)k;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; o < total; o += stride) {
    const int i = (int)(o / cap);
    const int64_t r = o - (int64_t)i * cap;
    const bool row = valid[r] != 0;
    bool v = row;
    bool over = false;
    ops_out[o] = ops[r];
    if (sp.kind == TE_UNNEST) {
      const long long len = te_int(sp.a, sp.a_esize, r);
      v = v && (long long)i < len;
      over = len > (long long)k;
      rw_tile_copy(sp.value, elems.src[i], sp.esize, o, r);
    } else if (sp.kind == TE_SERIES) {
      const long long start = te_int(sp.a, sp.a_esize, r);
      const long long stop = te_int(sp.b, sp.b_esize, r);
      const long long val = start + (long long)i;
      const bool bounds_ok = !(sp.a_null != nullptr && sp.a_null[r]) &&
                             !(sp.b_null != nullptr && sp.b_null[r]);
      v = v && bounds_ok && val <= stop;
      // stop - start + 1 as the reference's int64 lanes wrap
      const long long span =
          (long long)((unsigned long long)stop - (unsigned long long)start + 1ull);
      over = bounds_ok && span > (long long)k;
      ((long long*)sp.value)[o] = val;
    }
    if (i == 0 && row && over && sp.latch != nullptr) *sp.latch = 1;
    valid_out[o] = v ? 1 : 0;
    if (sp.index != nullptr) sp.index[o] = (long long)i;
    rw_tile_row(lanes, i, o, r);
  }
}

static int te_launch(const RwTileLanes& lanes, const TileElems& elems, const TileSpec& sp,
                     int64_t cap, int k, const void* valid, const void* ops, void* valid_out,
                     void* ops_out, void* stream) {
  const int64_t total = cap * (int64_t)k;
  if (total > 0)
    tile_expand_kernel<<<rw_tile_blocks(total), RW_TILE_THREADS, 0, (cudaStream_t)stream>>>(
        lanes, elems, sp, cap, k, (const uint8_t*)valid, (const int32_t*)ops,
        (uint8_t*)valid_out, (int32_t*)ops_out);
  return (int)cudaGetLastError();
}

static TileSpec te_spec(int kind) {
  TileSpec sp;
  sp.kind = kind;
  sp.esize = 0;
  sp.a = sp.b = nullptr;
  sp.a_esize = sp.b_esize = 0;
  sp.a_null = sp.b_null = nullptr;
  sp.value = nullptr;
  sp.index = nullptr;
  sp.latch = nullptr;
  return sp;
}

// elems: k element lane pointers (int64); elem_esize 1, 4 or 8; len: the
// (cap,) length lane of len_esize 4 or 8; value: (k * cap,) of elem_esize;
// index: (k * cap,) int64 or null; valid_out, ops_out: (k * cap,);
// latch: a device byte set to 1 where a valid row's length exceeds k, or null.
RW_EXPORT int rw_unnest(const int64_t* lanes, int n_lanes, const int64_t* elems, int k,
                        int elem_esize, int64_t cap, const void* valid, const void* ops,
                        const void* len, int len_esize, void* value, void* index,
                        void* valid_out, void* ops_out, void* latch, void* stream) {
  RwTileLanes t;
  if (!rw_tile_lanes(lanes, n_lanes, 5, &t) || k < 1 || k > TE_MAX_COPIES || cap < 0 ||
      (elem_esize != 1 && elem_esize != 4 && elem_esize != 8) ||
      (len_esize != 4 && len_esize != 8))
    return (int)cudaErrorInvalidValue;
  TileElems e;
  for (int i = 0; i < k; ++i) e.src[i] = (const void*)elems[i];
  TileSpec sp = te_spec(TE_UNNEST);
  sp.esize = elem_esize;
  sp.a = len;
  sp.a_esize = len_esize;
  sp.value = value;
  sp.index = (long long*)index;
  sp.latch = (uint8_t*)latch;
  return te_launch(t, e, sp, cap, k, valid, ops, valid_out, ops_out, stream);
}

// start, stop: (cap,) lanes of 4 or 8 bytes (signed); start_null,
// stop_null: their null lanes or null; value: (k * cap,) int64; latch: a
// device byte set to 1 where a valid row's non-NULL bounds span more than
// k, or null.
RW_EXPORT int rw_series(const int64_t* lanes, int n_lanes, int k, int64_t cap,
                        const void* valid, const void* ops, const void* start,
                        int start_esize, const void* stop, int stop_esize,
                        const void* start_null, const void* stop_null, void* value,
                        void* index, void* valid_out, void* ops_out, void* latch,
                        void* stream) {
  RwTileLanes t;
  if (!rw_tile_lanes(lanes, n_lanes, 5, &t) || k < 1 || k > TE_MAX_COPIES || cap < 0 ||
      (start_esize != 4 && start_esize != 8) || (stop_esize != 4 && stop_esize != 8))
    return (int)cudaErrorInvalidValue;
  TileElems e;
  TileSpec sp = te_spec(TE_SERIES);
  sp.a = start;
  sp.a_esize = start_esize;
  sp.b = stop;
  sp.b_esize = stop_esize;
  sp.a_null = (const uint8_t*)start_null;
  sp.b_null = (const uint8_t*)stop_null;
  sp.value = value;
  sp.index = (long long*)index;
  sp.latch = (uint8_t*)latch;
  return te_launch(t, e, sp, cap, k, valid, ops, valid_out, ops_out, stream);
}

// flag: (k * cap,) int64, the subset ordinal.
RW_EXPORT int rw_expand(const int64_t* lanes, int n_lanes, int k, int64_t cap,
                        const void* valid, const void* ops, void* flag, void* valid_out,
                        void* ops_out, void* stream) {
  RwTileLanes t;
  if (!rw_tile_lanes(lanes, n_lanes, 5, &t) || k < 1 || k > TE_MAX_COPIES || cap < 0)
    return (int)cudaErrorInvalidValue;
  TileElems e;
  TileSpec sp = te_spec(TE_EXPAND);
  sp.index = (long long*)flag;
  return te_launch(t, e, sp, cap, k, valid, ops, valid_out, ops_out, stream);
}
