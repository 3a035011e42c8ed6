// Kernel AF: the general over-window's chunk apply and emission diff.
//
// Replaces the two ends of risingwave_tpu/executors/over_window.py:
// _general_over_step (:927) (K28) around kernel AE's recompute:
//
// rw_over_apply (:962-1011), after kernel A found or inserted each valid
// row's pk: the first and the last valid row of each slot found by
// atomicMin/atomicMax of the row index into two per-slot int32 lanes (kept
// at their sentinels between calls: kernel V's last-row rule); the first
// launch also reads each row's pre-chunk presence, so a DELETE that is not
// a repeat of an earlier row of its pk and finds no present row latches
// bad_delete; the second lets the last row write every lane, `present`,
// `live` and `seq = seq_base + row`, and marks the ghost entry of a row
// that moves its emitted partition (a same-chunk partition move: the old
// partition's rows must be recomputed); every valid row with a slot marks
// its slot touched and sdirty; the third resets the two lanes. A valid row
// without a slot latches dropped.
//
// rw_over_diff (:1217-1292): one pass over the slots, one a thread, in
// tiles of 256. A dirty slot computes `changed` (values compared only
// where both sides are non-NULL, NULL flags compared), then retract =
// emitted & (gone | changed) and insert = present & (new | changed); each
// tile's retract and insert counts are scanned, published at once, and
// the counts of every earlier tile found by a decoupled look-back (tiles
// take their order from an atomic counter, so none waits on one not yet
// running); then the same thread writes the slot's retract row (its
// emitted values) and insert row (its current values) at their places in
// slot order (the reference's stable argsort(~mask) at :1246), and the
// current values over the emitted values that differ, em_valid and
// sdirty: a slot both retracted and inserted reads its emitted row
// before it is overwritten. A second launch sets both chunks' valid
// lanes from the two totals.
//
// What bounds it on the card: bytes. The apply reads the chunk once and
// touches each written slot's lanes at random; the diff reads three flag
// bytes per slot of the arena (2^24), the lanes of dirty slots, and
// writes the retracted and inserted rows, the emitted values that change
// and both valid lanes once, in two launches and a memset: no slot list,
// no second pass over the rows. Its writes cost most (an emitted lane is
// written in part of each sector), so an emitted value that stays is not
// rewritten. A changed slot's compared lanes are read again for its rows,
// from the cache the thread just filled: holding them in registers
// instead measured slower (fewer threads in flight).
#include "common.cuh"

#define OD_MAX_LANES 32  // = over_window.DIFF_LANES
#define OD_THREADS 256
#define OD_FIRST_SENTINEL 0x7FFFFFFF

struct OdApplyLanes {
  const void* src[OD_MAX_LANES];  // (n,) chunk lanes (values and null lanes)
  void* dst[OD_MAX_LANES];        // (cap,) arena lanes, same dtypes
  int esize[OD_MAX_LANES];
  int n;
};

struct OdKeys {
  const long long* chunk[OD_MAX_LANES];  // (n,) partition key as int64
  const long long* em[OD_MAX_LANES];     // (cap,) its emitted lane
  int n;
};

__global__ void od_first_last_kernel(int64_t n, const int32_t* slots, const uint8_t* valid,
                                     const uint8_t* found, const uint8_t* present,
                                     int32_t* first, int32_t* last, uint8_t* pre_ok,
                                     uint8_t* dropped) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const int32_t s = slots[i];
  if (s < 0) {
    *dropped = 1;
    return;
  }
  atomicMin(first + s, (int)i);
  atomicMax(last + s, (int)i);
  pre_ok[i] = found[i] && present[s];
}

__global__ void od_write_kernel(OdApplyLanes lanes, OdKeys keys, int64_t n, int64_t cap,
                                const int32_t* slots, const uint8_t* valid, const int32_t* ops,
                                const int32_t* first, const int32_t* last, uint8_t* present,
                                long long* seq, long long seq_base, const uint8_t* em_valid,
                                uint8_t* live, uint8_t* sdirty, uint8_t* touched,
                                uint8_t* ghost, int32_t* gslots, uint8_t* bad_delete) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t s = slots[i];
  gslots[i] = s < 0 ? 0 : (s > cap - 1 ? (int32_t)(cap - 1) : s);
  // ghost holds the first launch's pre-chunk presence until it is set here
  const bool pre_ok = ghost[i] != 0;
  ghost[i] = 0;
  if (!valid[i] || s < 0) return;
  const bool ins = !(ops[i] == 1 || ops[i] == 2);  // not DELETE | UPDATE_DELETE
  const bool dup = first[s] != (int32_t)i;
  if (!ins && !dup && !pre_ok) *bad_delete = 1;
  touched[s] = 1;
  sdirty[s] = 1;
  if (last[s] != (int32_t)i) return;
  bool moved = false;
  for (int k = 0; k < keys.n; ++k) moved |= keys.em[k][s] != keys.chunk[k][i];
  ghost[i] = ins && em_valid[s] && moved;
  present[s] = ins;
  live[s] = ins;
  for (int l = 0; l < lanes.n; ++l) {
    switch (lanes.esize[l]) {
      case 1: ((uint8_t*)lanes.dst[l])[s] = ((const uint8_t*)lanes.src[l])[i]; break;
      case 4: ((uint32_t*)lanes.dst[l])[s] = ((const uint32_t*)lanes.src[l])[i]; break;
      default:
        ((unsigned long long*)lanes.dst[l])[s] = ((const unsigned long long*)lanes.src[l])[i];
    }
  }
  seq[s] = seq_base + i;
}

__global__ void od_reset_kernel(int64_t n, const int32_t* slots, const uint8_t* valid,
                                int32_t* first, int32_t* last) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i] || slots[i] < 0) return;
  first[slots[i]] = OD_FIRST_SENTINEL;
  last[slots[i]] = -1;
}

RW_EXPORT int rw_over_apply(const int64_t* lane_rows, int n_lanes, const int64_t* key_rows,
                            int n_keys, int64_t n, int64_t cap, const int32_t* slots,
                            const uint8_t* found, const uint8_t* valid, const int32_t* ops,
                            uint8_t* present, long long* seq, int64_t seq_base,
                            const uint8_t* em_valid, uint8_t* live, uint8_t* sdirty,
                            uint8_t* touched, uint8_t* ghost, int32_t* gslots, int32_t* first,
                            int32_t* last, uint8_t* dropped, uint8_t* bad_delete,
                            cudaStream_t stream) {
  if (n_lanes < 0 || n_lanes > OD_MAX_LANES || n_keys < 0 || n_keys > OD_MAX_LANES)
    return (int)cudaErrorInvalidValue;
  OdApplyLanes lanes;
  lanes.n = n_lanes;
  for (int l = 0; l < n_lanes; ++l) {
    lanes.src[l] = (const void*)lane_rows[3 * l];
    lanes.dst[l] = (void*)lane_rows[3 * l + 1];
    lanes.esize[l] = (int)lane_rows[3 * l + 2];
    if (lanes.esize[l] != 1 && lanes.esize[l] != 4 && lanes.esize[l] != 8)
      return (int)cudaErrorInvalidValue;
  }
  OdKeys keys;
  keys.n = n_keys;
  for (int k = 0; k < n_keys; ++k) {
    keys.chunk[k] = (const long long*)key_rows[3 * k];
    keys.em[k] = (const long long*)key_rows[3 * k + 1];
  }
  cudaMemsetAsync(touched, 0, (size_t)cap, stream);
  if (n <= 0) return (int)cudaGetLastError();
  cudaMemsetAsync(ghost, 0, (size_t)n, stream);
  const int blocks = rw_blocks(n, OD_THREADS);
  od_first_last_kernel<<<blocks, OD_THREADS, 0, stream>>>(n, slots, valid, found, present, first,
                                                          last, ghost, dropped);
  od_write_kernel<<<blocks, OD_THREADS, 0, stream>>>(lanes, keys, n, cap, slots, valid, ops,
                                                     first, last, present, seq, seq_base,
                                                     em_valid, live, sdirty, touched, ghost,
                                                     gslots, bad_delete);
  od_reset_kernel<<<blocks, OD_THREADS, 0, stream>>>(n, slots, valid, first, last);
  return (int)cudaGetLastError();
}

// ---- the diff -------------------------------------------------------------------
struct OdCol {
  const void* cur;
  int dt;
  const uint8_t* cnull;
  long long* em;
  uint8_t* enull;
  long long* ret;
  uint8_t* ret_null;
  long long* ins;
  uint8_t* ins_null;
};

struct OdCols {
  OdCol c[OD_MAX_LANES];
  int n;
};

__device__ __forceinline__ long long od_load(const void* p, int dt, int64_t s) {
  switch (dt) {
    case RW_BOOL: return ((const uint8_t*)p)[s] ? 1 : 0;
    case RW_I32: return (long long)((const int32_t*)p)[s];
    default: return ((const long long*)p)[s];
  }
}

// One pass over the slots, one slot a thread, OD_THREADS slots a tile
// (the tile from a counter): the slot's flags (retract = emitted & (gone
// | changed), insert = present & (new | changed), in a dirty slot); both
// counts scanned over the block and the tile's place among the retract
// and insert rows found by the look-back (common.cuh rw_lookback: the
// retract count is its count a, the insert count b); then the slot's rows, lane by
// lane: the retract row from the emitted value, the insert row from the
// current value, which also becomes the emitted value where it differs
// (a slot both retracted and inserted reads its emitted value first);
// em_valid, sdirty. totals: both counts, by the last tile.
__global__ void __launch_bounds__(OD_THREADS)
    od_diff_kernel(OdCols cols, int64_t cap, const uint8_t* present, uint8_t* em_valid,
                   const uint8_t* dirty, uint8_t* sdirty, unsigned long long* status,
                   unsigned* counter, long long* totals, unsigned tiles) {
  __shared__ unsigned s_tile;
  __shared__ uint32_t s_er, s_ei;
  if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1u);
  __syncthreads();
  const unsigned tile = s_tile;
  const int64_t s = (int64_t)tile * OD_THREADS + threadIdx.x;
  bool ret = false, ins = false;
  if (s < cap && dirty[s]) {
    const bool p = present[s], e = em_valid[s];
    bool changed = false;
    if (p && e) {
      for (int k = 0; k < cols.n && !changed; ++k) {
        const OdCol& c = cols.c[k];
        const bool cn = c.cnull != nullptr && c.cnull[s];
        const bool en = c.enull[s] != 0;
        changed = cn != en || (!cn && !en && od_load(c.cur, c.dt, s) != c.em[s]);
      }
    }
    ret = e && (!p || changed);
    ins = p && (!e || changed);
  }
  int xr, xi;
  const uint32_t tr = (uint32_t)rw_block_exclusive_scan<OD_THREADS>(ret ? 1 : 0, &xr);
  const uint32_t ti = (uint32_t)rw_block_exclusive_scan<OD_THREADS>(ins ? 1 : 0, &xi);
  if (threadIdx.x < 32) {
    uint32_t er, ei;
    rw_lookback(status, tile, tr, ti, &er, &ei);
    if (threadIdx.x == 0) {
      s_er = er;
      s_ei = ei;
      if (tile == tiles - 1) {
        totals[0] = er + tr;
        totals[1] = ei + ti;
      }
    }
  }
  __syncthreads();
  if (!(ret || ins)) return;
  const int64_t at_r = (int64_t)s_er + xr, at_i = (int64_t)s_ei + xi;
  for (int k = 0; k < cols.n; ++k) {
    const OdCol& c = cols.c[k];
    long long ev = 0;
    uint8_t en = 0;
    if (ret) {  // the emitted row, read before the insert overwrites it
      ev = c.em[s];
      en = c.enull[s];
      c.ret[at_r] = ev;
      if (c.ret_null != nullptr) c.ret_null[at_r] = en;
    }
    if (ins) {
      const long long v = od_load(c.cur, c.dt, s);
      const uint8_t vn = c.cnull != nullptr ? c.cnull[s] : 0;
      c.ins[at_i] = v;
      if (c.ins_null != nullptr) c.ins_null[at_i] = vn;
      if (!ret || v != ev || vn != en) {  // an unchanged emitted value stays
        c.em[s] = v;
        c.enull[s] = vn;
      }
    }
  }
  if (!(ret && ins)) em_valid[s] = ins ? 1 : 0;  // retracted and inserted: stays 1
  sdirty[s] = 1;
}

// both chunks' valid lanes: a prefix of the totals
__global__ void od_valid_kernel(int64_t cap, const long long* totals, uint8_t* ret_valid,
                                uint8_t* ins_valid) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  ret_valid[i] = i < totals[0];
  ins_valid[i] = i < totals[1];
}

// status: od_tiles(cap) + 3 words (the tiles' words, the tile counter,
// the two totals), zeroed here.
RW_EXPORT int rw_over_diff(const int64_t* col_rows, int n_cols, int64_t cap,
                           const uint8_t* present, uint8_t* em_valid, const uint8_t* dirty,
                           uint8_t* sdirty, long long* status, uint8_t* ret_valid,
                           uint8_t* ins_valid, cudaStream_t stream) {
  if (n_cols < 0 || n_cols > OD_MAX_LANES) return (int)cudaErrorInvalidValue;
  OdCols cols;
  cols.n = n_cols;
  for (int k = 0; k < n_cols; ++k) {
    const int64_t* r = col_rows + 9 * k;
    OdCol& c = cols.c[k];
    c.cur = (const void*)r[0];
    c.dt = (int)r[1];
    c.cnull = (const uint8_t*)r[2];
    c.em = (long long*)r[3];
    c.enull = (uint8_t*)r[4];
    c.ret = (long long*)r[5];
    c.ret_null = (uint8_t*)r[6];
    c.ins = (long long*)r[7];
    c.ins_null = (uint8_t*)r[8];
    if (c.cur == nullptr || c.em == nullptr || c.enull == nullptr || c.ret == nullptr ||
        c.ins == nullptr)
      return (int)cudaErrorInvalidValue;
  }
  if (cap <= 0) return (int)cudaGetLastError();
  const int tiles = rw_blocks(cap, OD_THREADS);
  cudaMemsetAsync(status, 0, sizeof(long long) * ((size_t)tiles + 3), stream);
  od_diff_kernel<<<tiles, OD_THREADS, 0, stream>>>(
      cols, cap, present, em_valid, dirty, sdirty, (unsigned long long*)status,
      (unsigned*)(status + tiles), status + tiles + 1, (unsigned)tiles);
  od_valid_kernel<<<rw_blocks(cap, OD_THREADS), OD_THREADS, 0, stream>>>(
      cap, status + tiles + 1, ret_valid, ins_valid);
  return (int)cudaGetLastError();
}
