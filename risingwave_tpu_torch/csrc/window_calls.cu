// Kernel AE: window functions over sorted complete partitions.
//
// Replaces risingwave_tpu/executors/over_window.py:_eowc_over_emit (:403)
// and the recompute half of _general_over_step (:1013-1216) (K28); the
// body both share is csrc/window.cuh.
//
// rw_window_order: the members of a domain (the closed arena slots at a
// watermark; or the present-or-emitted slots plus the ghost entries of a
// chunk) in the order of a key table, the entries in idx[0, m); m is
// written to the host (the one read a watermark or a chunk takes).
// rw_window_calls: every call's output and null lane over the m sorted
// members, written at the sorted position (EOWC: with every emission lane
// gathered there, the emission's valid lane set, the closed slots freed)
// or at the member's slot (general: with dirty_slot, whether the slot's
// partition holds a touched entry).
//
// What bounds it on the card: bytes. The order reads every key lane of
// the domain once to compact and fold the varying bits, then per varying
// byte a stable radix pass moves a 12-byte (key, entry) pair per member;
// the calls gather each key and input lane at random once per scan lane
// and call, and write each output lane once.
#include "window.cuh"

static int win_keys(const int64_t* rows, int n_keys, WinKeys* k) {
  if (n_keys < 1 || n_keys > WIN_MAX_KEYS) return 0;
  k->n = n_keys;
  for (int l = 0; l < n_keys; ++l) {
    const int64_t* r = rows + 4 * l;
    k->lane[l] = (const void*)r[0];
    k->dt[l] = (int)r[1];
    k->fallback[l] = (const long long*)r[2];
    k->mode[l] = (int)r[3];
    if (k->mode[l] == WIN_KEY_VALUE && k->lane[l] == nullptr) return 0;
  }
  return 1;
}

static int win_calls(const int64_t* rows, int n_calls, WinCalls* c) {
  if (n_calls < 0 || n_calls > WIN_MAX_CALLS) return 0;
  c->n = n_calls;
  for (int i = 0; i < n_calls; ++i) {
    const int64_t* r = rows + 10 * i;
    WinCall& w = c->c[i];
    w.kind = (int)r[0];
    w.has_frame = (int)r[1];
    w.lo = (int)r[2];
    w.hi = (int)r[3];
    w.offset = (int)r[4];
    w.val = (const void*)r[5];
    w.dt = (int)r[6];
    w.vnull = (const uint8_t*)r[7];
    w.out = (long long*)r[8];
    w.onull = (uint8_t*)r[9];
    if (w.out == nullptr || w.kind < WK_ROW_NUMBER || w.kind > WK_DENSE_RANK) return 0;
    if (w.val == nullptr && w.kind != WK_ROW_NUMBER && w.kind != WK_COUNT) return 0;
  }
  return 1;
}

RW_EXPORT int rw_window_order(int64_t cap, int64_t n_ghost, const uint8_t* m1, const uint8_t* m2,
                              const long long* win, int64_t cutoff, const uint8_t* present,
                              const uint8_t* ghost, const int32_t* gslot, const int64_t* key_rows,
                              int n_keys, int32_t* sel, uint8_t* payload, int32_t* part,
                              long long* status, unsigned long long* keys, int32_t* idx,
                              int32_t* hist, unsigned long long* bits, int64_t* count,
                              cudaStream_t stream) {
  WinKeys k;
  if (!win_keys(key_rows, n_keys, &k) || m1 == nullptr) return (int)cudaErrorInvalidValue;
  if (n_ghost > 0 && (ghost == nullptr || gslot == nullptr)) return (int)cudaErrorInvalidValue;
  WinDomain d{cap, n_ghost, m1, m2, win, cutoff, present, ghost, gslot};
  const int64_t m = win_order(k, d, sel, payload, part, status, keys, idx, hist, bits, stream);
  if (m < 0) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? (int)err : (int)cudaErrorUnknown;
  }
  *count = m;
  return (int)cudaGetLastError();
}

RW_EXPORT int rw_window_calls(int64_t cap, int64_t n_ghost, const uint8_t* present,
                              const int32_t* gslot, const int64_t* key_rows, int n_keys,
                              int n_part, int order_key, const int64_t* call_rows, int n_calls,
                              int64_t m, int unsort, const int32_t* idx, long long* scan, long long* carry, uint8_t* segmark,
                              const uint8_t* touched, uint8_t* dirty_slot,
                              const int64_t* gather_rows, int n_gather, uint8_t* out_valid,
                              int64_t out_cap, uint8_t* clear_valid, cudaStream_t stream) {
  WinView v;
  if (!win_keys(key_rows, n_keys, &v.k) || !win_calls(call_rows, n_calls, &v.calls))
    return (int)cudaErrorInvalidValue;
  if (n_part < 0 || n_part > n_keys || order_key < 0 || order_key >= n_keys)
    return (int)cudaErrorInvalidValue;
  WinOut o;
  if (!rw_tile_lanes(gather_rows, n_gather, 3, &o.gather)) return (int)cudaErrorInvalidValue;
  if (dirty_slot != nullptr && touched == nullptr) return (int)cudaErrorInvalidValue;
  v.d = WinDomain{cap, n_ghost, nullptr, nullptr, nullptr, 0, present, nullptr, gslot};
  v.idx = idx;
  v.m = m;
  v.n_part = n_part;
  v.order_key = order_key;
  SegPlan plan;
  win_plan(v, plan);
  if (dirty_slot != nullptr) cudaMemsetAsync(dirty_slot, 0, (size_t)cap, stream);
  if (m > 0) {
    rw_seg_scan(v, plan, m, carry, scan, stream);
    if (dirty_slot != nullptr) {
      cudaMemsetAsync(segmark, 0, (size_t)m, stream);
      win_mark_kernel<<<rw_blocks(m, WIN_THREADS), WIN_THREADS, 0, stream>>>(v, scan, touched,
                                                                            segmark);
    }
    o.unsort = unsort;
    o.scan = scan;
    o.segmark = segmark;
    o.dirty_slot = dirty_slot;
    o.clear_valid = clear_valid;
    win_calls_kernel<<<rw_blocks(m, WIN_THREADS), WIN_THREADS, 0, stream>>>(v, o);
  }
  if (out_valid != nullptr && out_cap > 0)
    win_valid_kernel<<<rw_blocks(out_cap, WIN_THREADS), WIN_THREADS, 0, stream>>>(out_cap, m,
                                                                                  out_valid);
  return (int)cudaGetLastError();
}
