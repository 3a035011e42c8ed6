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
// rw_over_diff (:1217-1292): per slot of a dirty partition, `changed`
// (values compared only where both sides are non-NULL, NULL flags
// compared), then retract = emitted & (gone | changed) and insert =
// present & (new | changed) into one flag byte, sdirty marked; the two
// sets compacted in slot order (csrc/compact.cuh, the reference's stable
// argsort(~mask) at :1246), both chunks gathered (retract rows from the
// emitted lanes, insert rows from the current ones) with their valid
// lanes, then the emitted lanes updated: retracted slots leave, inserted
// slots take their new values.
//
// What bounds it on the card: bytes. The apply reads the chunk once and
// touches each written slot's lanes at random; the diff reads one flag
// byte per slot of the arena (2^24), every lane only of dirty slots, and
// moves the retracted and inserted rows once each.
#include "compact.cuh"

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

// flags[s]: bit 0 retract, bit 1 insert
__global__ void od_flags_kernel(OdCols cols, int64_t cap, const uint8_t* present,
                                const uint8_t* em_valid, const uint8_t* dirty, uint8_t* sdirty,
                                uint8_t* flags) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= cap) return;
  uint8_t f = 0;
  if (dirty[s]) {
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
    const bool retract = e && (!p || changed);
    const bool insert = p && (!e || changed);
    f = (retract ? 1 : 0) | (insert ? 2 : 0);
    if (f) sdirty[s] = 1;
  }
  flags[s] = f;
}

template <int BIT>
struct OdPick {
  static constexpr bool kAux = false;
  const uint8_t* lane;  // the flag bytes
  __device__ int flags(int64_t cap, int64_t base, uint8_t* f, int*) const {
    int c = 0;
#pragma unroll
    for (int j = 0; j < COMPACT_ITEMS; ++j) {
      const bool sel = base + j < cap && (lane[base + j] & BIT);
      f[j] = sel;
      c += sel;
    }
    return c;
  }
  __device__ void on_select(int64_t, uint8_t) const {}
  __device__ void on_total(long long*) const {}
};

// ret rows from the emitted lanes, ins rows from the current ones; both
// chunks' valid lanes for every row
__global__ void od_gather_kernel(OdCols cols, int64_t cap, const int32_t* sel_r,
                                 const int32_t* sel_i, const long long* status,
                                 uint8_t* ret_valid, uint8_t* ins_valid) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  const int64_t nr = status[0], ni = status[2];
  ret_valid[i] = i < nr;
  ins_valid[i] = i < ni;
  if (i < nr) {
    const int64_t s = sel_r[i];
    for (int k = 0; k < cols.n; ++k) {
      const OdCol& c = cols.c[k];
      c.ret[i] = c.em[s];
      if (c.ret_null != nullptr) c.ret_null[i] = c.enull[s];
    }
  }
  if (i < ni) {
    const int64_t s = sel_i[i];
    for (int k = 0; k < cols.n; ++k) {
      const OdCol& c = cols.c[k];
      c.ins[i] = od_load(c.cur, c.dt, s);
      if (c.ins_null != nullptr) c.ins_null[i] = c.cnull != nullptr ? c.cnull[s] : 0;
    }
  }
}

__global__ void od_retire_kernel(int64_t cap, const int32_t* sel_r, const long long* status,
                                 uint8_t* em_valid) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < cap && i < status[0]) em_valid[sel_r[i]] = 0;
}

__global__ void od_emit_kernel(OdCols cols, int64_t cap, const int32_t* sel_i,
                               const long long* status, uint8_t* em_valid) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap || i >= status[2]) return;
  const int64_t s = sel_i[i];
  for (int k = 0; k < cols.n; ++k) {
    const OdCol& c = cols.c[k];
    c.em[s] = od_load(c.cur, c.dt, s);
    c.enull[s] = c.cnull != nullptr ? c.cnull[s] : 0;
  }
  em_valid[s] = 1;
}

RW_EXPORT int rw_over_diff(const int64_t* col_rows, int n_cols, int64_t cap,
                           const uint8_t* present, uint8_t* em_valid, const uint8_t* dirty,
                           uint8_t* sdirty, uint8_t* flags, int32_t* sel_r, int32_t* sel_i,
                           uint8_t* payload, int32_t* part, long long* status,
                           uint8_t* ret_valid, uint8_t* ins_valid, cudaStream_t stream) {
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
  const int blocks = rw_blocks(cap, OD_THREADS);
  od_flags_kernel<<<blocks, OD_THREADS, 0, stream>>>(cols, cap, present, em_valid, dirty, sdirty,
                                                     flags);
  rw_compact(OdPick<1>{flags}, cap, part, sel_r, payload, status, stream);
  rw_compact(OdPick<2>{flags}, cap, part, sel_i, payload, status + 2, stream);
  od_gather_kernel<<<blocks, OD_THREADS, 0, stream>>>(cols, cap, sel_r, sel_i, status, ret_valid,
                                                      ins_valid);
  od_retire_kernel<<<blocks, OD_THREADS, 0, stream>>>(cap, sel_r, status, em_valid);
  od_emit_kernel<<<blocks, OD_THREADS, 0, stream>>>(cols, cap, sel_i, status, em_valid);
  return (int)cudaGetLastError();
}
