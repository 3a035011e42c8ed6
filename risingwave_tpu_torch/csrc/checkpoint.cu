// Kernel R: checkpoint staging and restore of slot-indexed state.
//
// Replaces the device half of a checkpoint pull and of a restore:
// - the staging marks of every Checkpointable executor
//   (risingwave_tpu/storage/state_table.py:stage_marks (:102) over the
//   sdirty / alive / stored lanes the executors pull to the host in
//   full: executors/hash_agg.py:1289-1297, hash_join.py:915-920,
//   dedup.py:315-319, dynamic_filter.py:361-365, materialize.py:841-846);
// - K32 storage/state_table.py:_gather (:165), the one device read of a
//   checkpoint pull;
// - K30's checkpoint half, executors/hash_agg.py:_mark_checkpointed
//   (:1262) and executors/hash_join.py:_side_mark_checkpointed (:893),
//   with the same flips of dedup, the dynamic max filter and the MV;
// - the restores' eager `.at[slots].set` of every lane (hash_agg.py
//   :1367-1403, hash_join.py:982-1000, dynamic_filter.py:386), which
//   here is one launch for all lanes.
//
// Four entry points:
//   rw_stage_select: upsert = dirty & alive, tomb = dirty & stored &
//     ~alive (dirty = sdirty, or sdirty | ddirty for a join side whose
//     degrees moved; alive = the OR of up to three lanes); the selected slots
//     (upsert | tomb) compacted in ascending slot order into sel, with
//     tomb[sel]; status = [selected, sdirty] as int64 on the card.
//   rw_gather_rows: for each lane (a (cap, ...) lane of any dtype seen
//     as rows of row_bytes), out[r] = lane[sel[r]] for r < n, packed
//     lane after lane into one buffer; one launch for all lanes. A lane
//     marked direct is already compacted (n rows, the select's tomb) and
//     is copied as it is, so it rides the same buffer and host copy.
//   rw_mark_checkpointed: stored[sel[r]] = !tomb[r] for r < n, and every
//     sdirty (and ddirty) slot clears. Equal to the reference's (stored | upsert) &
//     ~tomb: upsert and tomb are disjoint and both lie inside sel.
//   rw_scatter_rows: the inverse of the gather: lane[slots[r]] = in[r]
//     for every lane, rows whose slot is < 0 dropped (the reference's
//     scatter with mode="drop").
//
// What bounds it on the card: the select reads the sdirty, alive and
// stored bytes of every slot twice (count, then write) and writes 5 bytes
// per selected slot; the gather and scatter move each selected row's
// bytes once (a random row read or write against a coalesced packed
// write or read); the mark writes one byte per selected slot and clears
// the sdirty lane. All are bound by bytes; the copy to or from the host
// that follows a gather or precedes a scatter is bound by PCIe.
//
// Design: the select is csrc/compact.cuh's stream compaction (count per
// 4096-slot tile, scan the tile counts in one block, re-read and write),
// each tile read with 16-byte vector loads. No atomics decide a
// position, so the order is ascending slot without a sort. The gather
// and scatter walk every lane's rows in one launch (grid y = lane), each
// thread moving one unit of 1, 2, 4, 8 or 16 bytes, consecutive threads
// on consecutive bytes of the packed buffer.
#include "compact.cuh"

#define CK_THREADS 256
#define CK_MAX_ALIVE 3
#define CK_MAX_LANES 32
#define CK_MAX_ROW_BLOCKS 4096

struct SelectLanes {
  const uint8_t* sdirty;
  const uint8_t* ddirty;  // or null
  const uint8_t* alive[CK_MAX_ALIVE];
  int n_alive;
  const uint8_t* stored;
};

__device__ __forceinline__ void ck_load16(const uint8_t* p, int64_t base, int64_t cap,
                                          uint8_t* out) {
  if (base + COMPACT_ITEMS <= cap) {
    const uint4 v = *(const uint4*)(p + base);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int b = 0; b < 4; ++b) out[4 * q + b] = (uint8_t)((w[q] >> (8 * b)) & 0xFFu);
    }
  } else {
#pragma unroll
    for (int j = 0; j < COMPACT_ITEMS; ++j) out[j] = base + j < cap ? p[base + j] : 0;
  }
}

// flags[j]: bit 0 = selected (upsert or tomb), bit 1 = tomb. Returns the
// selected count; *n_sd receives the dirty count.
__device__ __forceinline__ int ck_flags(const SelectLanes& L, int64_t cap, int64_t base,
                                        uint8_t* flags, int* n_sd) {
  uint8_t sd[COMPACT_ITEMS], al[COMPACT_ITEMS], st[COMPACT_ITEMS], tmp[COMPACT_ITEMS];
  ck_load16(L.sdirty, base, cap, sd);
  ck_load16(L.stored, base, cap, st);
  if (L.ddirty != nullptr) {
    ck_load16(L.ddirty, base, cap, tmp);
#pragma unroll
    for (int j = 0; j < COMPACT_ITEMS; ++j) sd[j] |= tmp[j];
  }
#pragma unroll
  for (int j = 0; j < COMPACT_ITEMS; ++j) al[j] = 0;
  for (int a = 0; a < L.n_alive; ++a) {
    ck_load16(L.alive[a], base, cap, tmp);
#pragma unroll
    for (int j = 0; j < COMPACT_ITEMS; ++j) al[j] |= tmp[j];
  }
  int cnt = 0, nsd = 0;
#pragma unroll
  for (int j = 0; j < COMPACT_ITEMS; ++j) {
    const bool s = sd[j] != 0, alive = al[j] != 0;
    const bool tomb = s && st[j] != 0 && !alive;
    const bool sel = (s && alive) || tomb;
    flags[j] = (uint8_t)((sel ? 1 : 0) | (tomb ? 2 : 0));
    cnt += sel ? 1 : 0;
    nsd += s ? 1 : 0;
  }
  *n_sd = nsd;
  return cnt;
}

// The select as compact.cuh's flag functor: bit 0 = selected, bit 1 =
// tomb (the payload); the dirty count rides as the aux count.
struct SelectFlags {
  static constexpr bool kAux = true;
  SelectLanes L;
  __device__ int flags(int64_t cap, int64_t base, uint8_t* f, int* aux) const {
    return ck_flags(L, cap, base, f, aux);
  }
  __device__ void on_select(int64_t, uint8_t) const {}
  __device__ void on_total(long long*) const {}
};

// sdirty, ddirty (or null), alive0..2 (null past n_alive), stored: (cap,)
// bool lanes, each 16-byte aligned. tile_counts: ceil(cap / 4096) + 1
// int32 scratch. sel: (cap,) int32, tomb: (cap,) bool; the first status[0]
// entries are written. status: (2,) int64.
RW_EXPORT int rw_stage_select(const void* sdirty, const void* ddirty, const void* alive0,
                              const void* alive1, const void* alive2, int n_alive,
                              const void* stored, int64_t cap, void* tile_counts, void* sel,
                              void* tomb, void* status, void* stream) {
  if (n_alive < 0 || n_alive > CK_MAX_ALIVE || cap < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  SelectLanes L;
  L.sdirty = (const uint8_t*)sdirty;
  L.ddirty = (const uint8_t*)ddirty;
  L.alive[0] = (const uint8_t*)alive0;
  L.alive[1] = (const uint8_t*)alive1;
  L.alive[2] = (const uint8_t*)alive2;
  L.n_alive = n_alive;
  L.stored = (const uint8_t*)stored;
  rw_compact(SelectFlags{L}, cap, (int32_t*)tile_counts, (int32_t*)sel, (uint8_t*)tomb,
             (long long*)status, st);
  return (int)cudaGetLastError();
}

struct RowLanes {
  uint8_t* lane[CK_MAX_LANES];    // (cap, ...) state lane
  uint8_t* packed[CK_MAX_LANES];  // this lane's n rows in the packed buffer
  int64_t row_bytes[CK_MAX_LANES];
  int unit[CK_MAX_LANES];         // bytes a thread moves: 1, 2, 4, 8 or 16
  int direct[CK_MAX_LANES];       // 1: lane row r is row r (already compacted)
  int n;
};

__device__ __forceinline__ void ck_move(uint8_t* d, const uint8_t* s, int unit) {
  switch (unit) {
    case 16: *(uint4*)d = *(const uint4*)s; break;
    case 8: *(unsigned long long*)d = *(const unsigned long long*)s; break;
    case 4: *(uint32_t*)d = *(const uint32_t*)s; break;
    case 2: *(uint16_t*)d = *(const uint16_t*)s; break;
    default: *d = *s; break;
  }
}

// to_packed: the gather (packed[r] = lane[rows[r]]); else the scatter
// (lane[rows[r]] = packed[r], rows[r] < 0 dropped).
template <bool to_packed>
__global__ void ck_rows_kernel(RowLanes L, const int32_t* rows, int64_t n) {
  const int k = blockIdx.y;
  const int64_t rb = L.row_bytes[k];
  const int unit = L.unit[k];
  const int64_t per_row = rb / unit;
  const int64_t total = n * per_row;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total; t += stride) {
    const int64_t r = per_row == 1 ? t : t / per_row;
    const int64_t off = (t - r * per_row) * unit;
    const int64_t slot = L.direct[k] ? r : (int64_t)rows[r];
    if (slot < 0) continue;
    uint8_t* lane = L.lane[k] + slot * rb + off;
    uint8_t* packed = L.packed[k] + r * rb + off;
    if (to_packed)
      ck_move(packed, lane, unit);
    else
      ck_move(lane, packed, unit);
  }
}

static int ck_rows(const int64_t* lanes, int n_lanes, const void* rows, int64_t n, void* stream,
                   bool to_packed) {
  if (n_lanes < 0 || n_lanes > CK_MAX_LANES || n < 0) return (int)cudaErrorInvalidValue;
  RowLanes L;
  L.n = n_lanes;
  int64_t most = 0;
  for (int k = 0; k < n_lanes; ++k) {
    const int64_t* r = lanes + 5 * k;
    L.lane[k] = (uint8_t*)r[0];
    L.packed[k] = (uint8_t*)r[1];
    L.row_bytes[k] = r[2];
    L.unit[k] = (int)r[3];
    L.direct[k] = (int)r[4];
    if (L.unit[k] <= 0 || L.row_bytes[k] <= 0 || L.row_bytes[k] % L.unit[k])
      return (int)cudaErrorInvalidValue;
    const int64_t units = n * (L.row_bytes[k] / L.unit[k]);
    if (units > most) most = units;
  }
  if (n_lanes > 0 && most > 0) {
    int64_t blocks = (most + CK_THREADS - 1) / CK_THREADS;
    if (blocks > CK_MAX_ROW_BLOCKS) blocks = CK_MAX_ROW_BLOCKS;
    const dim3 grid((unsigned)blocks, (unsigned)n_lanes);
    if (to_packed)
      ck_rows_kernel<true><<<grid, CK_THREADS, 0, (cudaStream_t)stream>>>(
          L, (const int32_t*)rows, n);
    else
      ck_rows_kernel<false><<<grid, CK_THREADS, 0, (cudaStream_t)stream>>>(
          L, (const int32_t*)rows, n);
  }
  return (int)cudaGetLastError();
}

// lanes: n_lanes rows of (lane, packed, row_bytes, unit, direct), int64;
// sel: (n,) int32 slots, each in range.
RW_EXPORT int rw_gather_rows(const int64_t* lanes, int n_lanes, const void* sel, int64_t n,
                             void* stream) {
  return ck_rows(lanes, n_lanes, sel, n, stream, true);
}

// lanes as the gather's (direct 0); slots: (n,) int32, a slot < 0 drops
// its row.
RW_EXPORT int rw_scatter_rows(const int64_t* lanes, int n_lanes, const void* slots, int64_t n,
                              void* stream) {
  return ck_rows(lanes, n_lanes, slots, n, stream, false);
}

__global__ void ck_mark_kernel(const int32_t* sel, const uint8_t* tomb, int64_t n,
                               uint8_t* stored, uint8_t* sdirty, uint8_t* ddirty, int64_t cap) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t end = n > cap ? n : cap;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < end; i += stride) {
    if (i < n) stored[sel[i]] = tomb[i] ? 0 : 1;
    if (i < cap) {
      sdirty[i] = 0;
      if (ddirty != nullptr) ddirty[i] = 0;
    }
  }
}

// sel: (n,) int32 slots, tomb: (n,) bool; stored, sdirty, ddirty (or
// null): (cap,) bool.
RW_EXPORT int rw_mark_checkpointed(const void* sel, const void* tomb, int64_t n, void* stored,
                                   void* sdirty, void* ddirty, int64_t cap, void* stream) {
  if (n < 0 || cap < 0) return (int)cudaErrorInvalidValue;
  const int64_t end = n > cap ? n : cap;
  if (end > 0) {
    int64_t blocks = (end + CK_THREADS - 1) / CK_THREADS;
    if (blocks > CK_MAX_ROW_BLOCKS) blocks = CK_MAX_ROW_BLOCKS;
    ck_mark_kernel<<<(unsigned)blocks, CK_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)sel, (const uint8_t*)tomb, n, (uint8_t*)stored, (uint8_t*)sdirty,
        (uint8_t*)ddirty, cap);
  }
  return (int)cudaGetLastError();
}
