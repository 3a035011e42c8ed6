// Kernel AE: window functions over sorted complete partitions.
//
// Replaces risingwave_tpu/executors/over_window.py:_eowc_over_emit (:403)
// and the recompute half of _general_over_step (:1013-1216) (K28); the
// body both share is csrc/window.cuh.
//
// rw_window_fold: the member count of a domain (the closed arena slots at
// a watermark; or the present-or-emitted slots plus the ghost entries of a
// chunk) and each key lane's OR, AND, MIN and MAX over the members, both
// copied to the host (the one read a watermark or a chunk takes), from
// which the host plans the packed key (over_window.window_pack_plan).
// rw_window_order: each member's packed words written once in entry order
// beside its entry, then sorted by csrc/onesweep.cuh's single-sweep
// passes; where the result lies goes back to the host (no copy, no sync).
// rw_window_calls: the sorted members laid out (entry, flags, inputs),
// then every call's output and null lane, written at the sorted position
// (EOWC: with every emission lane gathered there, the emission's valid
// lane set, the closed slots freed) or at the member's slot (general:
// each member's outputs as one record in sorted order, then one pass in
// slot order lands the records of dirty partitions' members, which alone
// are read, by each slot's sorted place; dirty_slot is 1 there, and every
// other slot's outputs and dirty_slot are 0).
// rw_onesweep_sort: the sort alone, on given keys (for timing it).
//
// What bounds it on the card: bytes, and random reads most of all. So no
// key lane is gathered through a permutation: the fold and the write each
// read the domain's membership and key lanes once, coalesced; a pass
// moves a 12-byte (key, entry) pair per member in one launch, over only
// the bytes that vary; segment heads come from neighbouring keys; the
// layout is the one random read of each call input (and, in the general
// step, the one random write: the slot's sorted place); the scan and the
// calls read only laid-out lanes; the general step's outputs reach their
// slots by a gather of whole records in slot order, not by a scatter of
// each output lane.
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

static bool win_reads_input(int kind) {
  return kind == WK_LAG || kind == WK_LEAD || kind == WK_SUM || kind == WK_MIN || kind == WK_MAX;
}

// The calls, and their distinct inputs (by lane, dtype and null lane).
static int win_calls(const int64_t* rows, int n_calls, WinCalls* c, WinInputs* in) {
  if (n_calls < 0 || n_calls > WIN_MAX_CALLS) return 0;
  c->n = n_calls;
  in->n = 0;
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
    w.in = -1;
    if (w.out == nullptr || w.kind < WK_ROW_NUMBER || w.kind > WK_DENSE_RANK) return 0;
    if (w.val == nullptr && w.kind != WK_ROW_NUMBER && w.kind != WK_COUNT) return 0;
    if (!win_reads_input(w.kind)) continue;
    for (int j = 0; j < in->n && w.in < 0; ++j)
      if (in->val[j] == w.val && in->dt[j] == w.dt && in->vnull[j] == w.vnull) w.in = j;
    if (w.in < 0) {
      w.in = in->n++;
      in->val[w.in] = w.val;
      in->dt[w.in] = w.dt;
      in->vnull[w.in] = w.vnull;
    }
  }
  return 1;
}

static int win_plan_rows(const int64_t* rows, WinPlan* p) {
  p->n = (int)rows[0];
  p->words = (int)rows[1];
  if (p->n < 0 || p->n > WIN_MAX_KEYS || p->words < 0 || p->words > WIN_MAX_WORDS) return 0;
  for (int w = 0; w < p->words; ++w) p->mask[w] = (unsigned)rows[2 + w];
  const int64_t* f = rows + 2 + p->words;
  for (int i = 0; i < p->n; ++i) {
    WinField& F = p->f[i];
    F.lane = (int)f[5 * i];
    F.lo = (int)f[5 * i + 1];
    F.width = (int)f[5 * i + 2];
    F.g0 = (int)f[5 * i + 3];
    F.min = (unsigned long long)f[5 * i + 4];
    if (F.width < 1 || F.width > 64 || F.lo < 0 || F.lo > 63 || F.g0 < 0 ||
        F.g0 + F.width > 64 * p->words)
      return 0;
  }
  return 1;
}

RW_EXPORT int rw_window_fold(int64_t cap, int64_t n_ghost, const uint8_t* m1, const uint8_t* m2,
                             const long long* win, int64_t cutoff, const uint8_t* present,
                             const uint8_t* ghost, const int32_t* gslot, const int64_t* key_rows,
                             int n_keys, int32_t* part, unsigned long long* fold, int64_t* host,
                             cudaStream_t stream) {
  WinKeys k;
  if (!win_keys(key_rows, n_keys, &k) || m1 == nullptr) return (int)cudaErrorInvalidValue;
  if (n_ghost > 0 && (ghost == nullptr || gslot == nullptr)) return (int)cudaErrorInvalidValue;
  WinDomain d{cap, n_ghost, m1, m2, win, cutoff, present, ghost, gslot};
  const int64_t total = cap + n_ghost;
  const int tiles = compact_tiles(total);
  win_fold_init_kernel<<<1, 32, 0, stream>>>(k.n, fold);
  if (total > 0) {
    win_fold_kernel<<<tiles, COMPACT_THREADS, 0, stream>>>(k, d, total, part, fold);
    scan_top_kernel<<<1, SCAN_TOP_THREADS, 0, stream>>>(part, tiles);
  }
  int32_t m = 0;
  if ((total > 0 && cudaMemcpyAsync(&m, part + tiles, sizeof(int32_t), cudaMemcpyDeviceToHost,
                                    stream) != cudaSuccess) ||
      cudaMemcpyAsync(host + 1, fold, sizeof(unsigned long long) * 4 * k.n,
                      cudaMemcpyDeviceToHost, stream) != cudaSuccess ||
      cudaStreamSynchronize(stream) != cudaSuccess) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? (int)err : (int)cudaErrorUnknown;
  }
  host[0] = m;
  return (int)cudaGetLastError();
}

RW_EXPORT int rw_window_order(int64_t cap, int64_t n_ghost, const uint8_t* m1, const uint8_t* m2,
                              const long long* win, int64_t cutoff, const uint8_t* present,
                              const uint8_t* ghost, const int32_t* gslot, const int64_t* key_rows,
                              int n_keys, const int64_t* plan_rows, int64_t m,
                              const int32_t* part, unsigned long long* words, int32_t* ent,
                              unsigned long long* ka, unsigned long long* kb, int32_t* pa,
                              int32_t* pb, uint32_t* hist, uint32_t* status, int64_t* host,
                              cudaStream_t stream) {
  WinKeys k;
  WinPlan p;
  if (!win_keys(key_rows, n_keys, &k) || !win_plan_rows(plan_rows, &p) || m1 == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n_ghost > 0 && (ghost == nullptr || gslot == nullptr)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < p.n; ++i)
    if (p.f[i].lane >= k.n) return (int)cudaErrorInvalidValue;
  const int64_t total = cap + n_ghost;
  if (m < 0 || m > total || m > OS_MAX_KEYS) return (int)cudaErrorInvalidValue;
  WinDomain d{cap, n_ghost, m1, m2, win, cutoff, present, ghost, gslot};
  host[0] = 0;
  host[1] = (int64_t)ent;
  if (m == 0) return (int)cudaGetLastError();
  win_write_kernel<<<compact_tiles(total), COMPACT_THREADS, 0, stream>>>(k, p, d, total, part,
                                                                         words, total, ent);
  const OsScratch s{ka, kb, pa, pb, hist, status};
  const unsigned long long* key;
  const int32_t* pay;
  win_sort(p, m, total, words, ent, s, &key, &pay, stream);
  host[0] = (int64_t)key;
  host[1] = (int64_t)pay;
  return (int)cudaGetLastError();
}

RW_EXPORT int rw_window_calls(int64_t cap, int64_t n_ghost, const uint8_t* present,
                              const uint8_t* touched, const int64_t* call_rows, int n_calls,
                              int64_t m, int unsort, const int64_t* sorted_rows, int n_words,
                              int32_t* idx, uint8_t* hf, long long* sv, uint8_t* sn, int n_inputs,
                              long long* scan, long long* carry, uint8_t* segmark,
                              int32_t* pos, unsigned long long* rec, int rs,
                              uint8_t* dirty_slot, const int64_t* gather_rows, int n_gather,
                              uint8_t* out_valid, int64_t out_cap, uint8_t* clear_valid,
                              cudaStream_t stream) {
  WinView v;
  WinInputs in;
  if (!win_calls(call_rows, n_calls, &v.calls, &in) || in.n > n_inputs)
    return (int)cudaErrorInvalidValue;
  if (n_words < 0 || n_words > WIN_MAX_WORDS || m < 0 || m > cap + n_ghost)
    return (int)cudaErrorInvalidValue;
  WinOut o;
  if (!rw_tile_lanes(gather_rows, n_gather, 3, &o.gather)) return (int)cudaErrorInvalidValue;
  if (unsort && (dirty_slot == nullptr || touched == nullptr || pos == nullptr ||
                 rec == nullptr || rs < 1 + n_calls))
    return (int)cudaErrorInvalidValue;
  WinSorted s;
  s.key = (const unsigned long long*)sorted_rows[0];
  s.pay = (const int32_t*)sorted_rows[1];
  s.words = (const unsigned long long*)sorted_rows[2];
  s.stride = sorted_rows[3];
  s.ent = (const int32_t*)sorted_rows[4];
  s.words_n = n_words;
  for (int w = 0; w < n_words; ++w) {
    s.part_mask[w] = (unsigned long long)sorted_rows[5 + w];
    s.order_mask[w] = (unsigned long long)sorted_rows[5 + n_words + w];
  }
  if (m > 0 && ((n_words > 0 && s.key == nullptr) || (n_words > 1 && s.ent == nullptr) ||
                (n_words <= 1 && s.pay == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int64_t dom = cap + n_ghost;
  for (int c = 0; c < in.n; ++c) {
    in.sv[c] = sv + c * dom;
    in.sn[c] = sn + c * dom;
    v.sv[c] = in.sv[c];
    v.sn[c] = in.sn[c];
  }
  const WinDomain d{cap, n_ghost, nullptr, nullptr, nullptr, 0, present, nullptr, nullptr};
  v.hf = hf;
  v.m = m;
  SegPlan plan;
  win_plan(v, plan);
  if (unsort) cudaMemsetAsync(pos, 0xFF, sizeof(int32_t) * (size_t)cap, stream);
  if (m > 0) {
    const int blocks = rw_blocks(m, WIN_THREADS);
    win_layout_kernel<<<blocks, WIN_THREADS, 0, stream>>>(s, d, in, touched, m, idx, hf,
                                                          unsort ? pos : nullptr);
    rw_seg_scan(v, plan, m, carry, scan, stream);
    if (unsort) {
      cudaMemsetAsync(segmark, 0, (size_t)m, stream);
      win_mark_kernel<<<blocks, WIN_THREADS, 0, stream>>>(m, hf, scan, segmark);
    }
    o.cap = cap;
    o.idx = idx;
    o.scan = scan;
    o.segmark = segmark;
    o.rec = unsort ? rec : nullptr;
    o.rs = rs;
    o.clear_valid = clear_valid;
    win_calls_kernel<<<blocks, WIN_THREADS, 0, stream>>>(v, o);
  }
  if (unsort && cap > 0)
    win_place_kernel<<<rw_blocks(cap, WIN_THREADS), WIN_THREADS, 0, stream>>>(v.calls, cap, pos,
                                                                              rec, rs, dirty_slot);
  if (out_valid != nullptr && out_cap > 0)
    win_valid_kernel<<<rw_blocks(out_cap, WIN_THREADS), WIN_THREADS, 0, stream>>>(out_cap, m,
                                                                                  out_valid);
  return (int)cudaGetLastError();
}

RW_EXPORT int rw_onesweep_sort(const unsigned long long* keys, const int32_t* pay, int64_t n,
                               int mask, unsigned long long* ka, unsigned long long* kb,
                               int32_t* pa, int32_t* pb, uint32_t* hist, uint32_t* status,
                               int64_t* host, cudaStream_t stream) {
  if (n < 0 || n > OS_MAX_KEYS) return (int)cudaErrorInvalidValue;
  const OsScratch s{ka, kb, pa, pb, hist, status};
  const unsigned long long* key;
  const int32_t* p;
  os_sort(keys, pay, n, (unsigned)mask, s, &key, &p, stream);
  host[0] = (int64_t)key;
  host[1] = (int64_t)p;
  return (int)cudaGetLastError();
}
