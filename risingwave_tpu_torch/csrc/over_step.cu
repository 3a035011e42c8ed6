// Kernel AD: one chunk through the append-only over-window.
//
// Replaces risingwave_tpu/executors/over_window.py:_over_step (:129) after
// its lookup_or_insert of the partition keys (kernel A) (K28).
//
// Per chunk: the inserted rows' slots are marked live and sdirty; the rows
// are ordered by slot with kernel F's stable radix passes
// (csrc/radix.cuh) over the bytes a slot index needs, rows without a slot
// last: ties keep arrival order, the reference's (slot, pos) sort. One
// segmented scan (csrc/segscan.cuh) gives every call's in-chunk running
// lanes at once: the row's rank in its segment, running sums, running
// extremes and their presence counts, value-group counts and starts. One
// launch then reads each partition's stored accumulators, writes every
// call's output (and the min/max and lag null lanes) back at the row's
// arrival position, stages the segment end's new accumulator values and
// latches out-of-order rank arrivals; a last launch lets each segment's
// end store them with plain stores (a slot has one segment, so no
// atomics). A retracting valid row latches saw_delete, an inserted row
// without a slot latches dropped and takes no further part.
//
// What bounds it on the card: bytes. The chunk (2^21 rows) is read once
// per lane, each radix pass moves a 12-byte (key, row) pair per row, the
// scan reads each input at random through the row order, and each
// partition's accumulators are read at random once per row and written
// once per segment.
#include "radix.cuh"
#include "segscan.cuh"

#define OS_MAX_CALLS 16  // = over_window.WINDOW_CALLS
#define OS_THREADS 256
#define OS_MAXI 0x7FFFFFFFFFFFFFFFll
#define OS_MINI ((long long)0x8000000000000000ull)

// = over_window.KINDS
enum OsKind : int {
  OK_ROW_NUMBER = 0,
  OK_COUNT = 1,
  OK_SUM = 2,
  OK_MIN = 3,
  OK_MAX = 4,
  OK_LAG = 5,
  OK_LEAD = 6,
  OK_RANK = 7,
  OK_DENSE_RANK = 8,
};

struct OsCall {
  int kind;
  const long long* val;  // (n,) int64 input at arrival positions
  const uint8_t* vnull;
  long long* out;
  uint8_t* onull;
  long long* acc[5];  // over_window._accum_names order
  int scan;           // its first scan lane
  int stage;          // its first staged accumulator lane
  int n_acc;
};

struct OsCalls {
  OsCall c[OS_MAX_CALLS];
  int n;
};

enum OsRole : int { OR_RANK = 0, OR_SUM = 1, OR_EXT = 2, OR_HAS = 3, OR_VB = 4, OR_GRP = 5 };

struct OsView {
  OsCalls calls;
  const unsigned long long* skey;  // sorted slots (cap: no slot)
  const int32_t* srow;             // sorted arrival rows
  int64_t cap;
  int role[SEG_MAX_LANES];
  int call[SEG_MAX_LANES];

  __device__ __forceinline__ bool head(int64_t i) const {
    return i == 0 || skey[i] != skey[i - 1];
  }
  __device__ __forceinline__ bool active(int64_t i) const {
    return skey[i] < (unsigned long long)cap;
  }
  __device__ __forceinline__ long long val(const OsCall& c, int64_t i) const {
    return c.val[srow[i]];
  }
  __device__ __forceinline__ bool vnull(const OsCall& c, int64_t i) const {
    return c.vnull != nullptr && c.vnull[srow[i]] != 0;
  }
  __device__ __forceinline__ bool vb(const OsCall& c, int64_t i) const {
    return head(i) || val(c, i) != val(c, i - 1);
  }
  __device__ __forceinline__ long long value(int l, int64_t i) const {
    if (role[l] == OR_RANK) return 1;
    const OsCall& c = calls.c[call[l]];
    const bool real = active(i) && !vnull(c, i);
    switch (role[l]) {
      case OR_SUM: return real ? val(c, i) : 0;
      case OR_EXT: return real ? val(c, i) : (c.kind == OK_MIN ? OS_MAXI : OS_MINI);
      case OR_HAS: return real ? 1 : 0;
      case OR_VB: return vb(c, i) ? 1 : 0;
      default: return vb(c, i) ? (long long)i : OS_MINI;  // OR_GRP
    }
  }
};

__global__ void os_prep_kernel(int64_t n, int64_t cap, const int32_t* slots, const uint8_t* valid,
                               const int32_t* ops, uint8_t* live, uint8_t* sdirty,
                               uint8_t* saw_delete, uint8_t* dropped, unsigned long long* keys,
                               int32_t* idx) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool retract = ops[i] == 1 || ops[i] == 2;  // DELETE | UPDATE_DELETE
  const bool active = valid[i] && !retract;
  if (valid[i] && retract) *saw_delete = 1;
  const int32_t s = slots[i];
  if (active && s < 0) *dropped = 1;
  const bool ok = active && s >= 0;
  if (ok) {
    live[s] = 1;
    sdirty[s] = 1;
  }
  keys[i] = ok ? (unsigned long long)s : (unsigned long long)cap;
  idx[i] = (int32_t)i;
}

__global__ void os_out_kernel(OsView v, int64_t n, const long long* scan, long long* stage,
                              uint8_t* ooo) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool act = v.active(i);
  const int64_t gs = act ? (int64_t)v.skey[i] : 0;
  const int64_t row = v.srow[i];
  const long long rank = scan[i] - 1;
  const bool last = i == n - 1 || v.head(i + 1);
  const bool store = act && last;
  bool bad = false;
  for (int c = 0; c < v.calls.n; ++c) {
    const OsCall& w = v.calls.c[c];
    long long* const* acc = w.acc;
    const long long base = acc[0][gs];
    long long o = 0;
    long long nacc[5] = {0, 0, 0, 0, 0};
    bool onull = false;
    if (w.kind == OK_ROW_NUMBER || w.kind == OK_COUNT) {
      o = base + rank + 1;
      nacc[0] = o;
    } else if (w.kind == OK_SUM) {
      o = (long long)((unsigned long long)base + (unsigned long long)scan[w.scan * n + i]);
      nacc[0] = o;
    } else if (w.kind == OK_MIN || w.kind == OK_MAX) {
      const long long pref = scan[w.scan * n + i];
      o = w.kind == OK_MIN ? (base < pref ? base : pref) : (base > pref ? base : pref);
      const long long has = acc[1][gs];
      const bool pref_has = scan[(w.scan + 1) * n + i] > 0;
      onull = !(has != 0 || pref_has);
      nacc[0] = o;
      nacc[1] = has > (pref_has ? 1 : 0) ? has : (pref_has ? 1 : 0);
    } else if (w.kind == OK_RANK || w.kind == OK_DENSE_RANK) {
      const long long x = v.val(w, i);
      const long long prev = i > 0 ? v.val(w, i - 1) : 0;
      const bool h = v.head(i);
      const long long cnt0 = acc[1][gs], dense0 = acc[2][gs], lastv = acc[3][gs];
      const bool has = acc[4][gs] != 0;
      const long long cum_vb = scan[w.scan * n + i];
      const long long grp_start = scan[(w.scan + 1) * n + i] - (i - rank);
      const bool eq_carry = has && x == lastv && cum_vb == 1;
      if (act && ((!h && x < prev) || (h && has && x < lastv))) bad = true;
      const long long ranked = eq_carry ? base : cnt0 + grp_start + 1;
      const bool first_eq = has && v.val(w, i - rank) == lastv;
      const long long dense_row = dense0 + cum_vb - (first_eq ? 1 : 0);
      o = w.kind == OK_RANK ? ranked : dense_row;
      nacc[0] = ranked;
      nacc[1] = cnt0 + rank + 1;
      nacc[2] = dense_row;
      nacc[3] = x;
      nacc[4] = 1;
    } else {  // lag(1)
      const long long x = v.val(w, i);
      const bool xn = v.vnull(w, i);
      if (rank == 0) {
        o = base;
        onull = acc[1][gs] == 0 || acc[2][gs] != 0;
      } else {
        o = v.val(w, i - 1);
        onull = v.vnull(w, i - 1);
      }
      nacc[0] = x;
      nacc[1] = 1;
      nacc[2] = xn ? 1 : 0;
    }
    w.out[row] = o;
    if (w.onull != nullptr) w.onull[row] = onull ? 1 : 0;
    if (store)
      for (int a = 0; a < w.n_acc; ++a) stage[(int64_t)(w.stage + a) * n + i] = nacc[a];
  }
  if (bad) *ooo = 1;
}

__global__ void os_store_kernel(OsView v, int64_t n, const long long* stage) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !v.active(i) || !(i == n - 1 || v.head(i + 1))) return;
  const int64_t s = (int64_t)v.skey[i];
  for (int c = 0; c < v.calls.n; ++c) {
    const OsCall& w = v.calls.c[c];
    for (int a = 0; a < w.n_acc; ++a) w.acc[a][s] = stage[(int64_t)(w.stage + a) * n + i];
  }
}

static int os_accs(int kind) {
  switch (kind) {
    case OK_LAG: return 3;
    case OK_MIN: case OK_MAX: return 2;
    case OK_RANK: case OK_DENSE_RANK: return 5;
    default: return 1;
  }
}

RW_EXPORT int rw_over_step(const int64_t* call_rows, const int64_t* acc_rows, int n_calls,
                           int64_t n, int64_t cap, const int32_t* slots, const uint8_t* valid,
                           const int32_t* ops, uint8_t* live, uint8_t* sdirty,
                           uint8_t* saw_delete, uint8_t* dropped, uint8_t* ooo,
                           unsigned long long* keys, int32_t* idx, int32_t* hist,
                           long long* scan, long long* carry, long long* stage,
                           cudaStream_t stream) {
  if (n_calls < 0 || n_calls > OS_MAX_CALLS) return (int)cudaErrorInvalidValue;
  OsView v;
  SegPlan plan;
  v.calls.n = n_calls;
  v.cap = cap;
  int lanes = 0, stages = 0;
  auto add = [&](int role, int call, int op) {
    v.role[lanes] = role;
    v.call[lanes] = call;
    plan.op[lanes] = op;
    plan.reset[lanes] = 1;
    ++lanes;
  };
  add(OR_RANK, -1, SEG_ADD);
  for (int c = 0; c < n_calls; ++c) {
    const int64_t* r = call_rows + 10 * c;
    OsCall& w = v.calls.c[c];
    w.kind = (int)r[0];
    w.val = (const long long*)r[5];
    w.vnull = (const uint8_t*)r[7];
    w.out = (long long*)r[8];
    w.onull = (uint8_t*)r[9];
    if (w.kind < OK_ROW_NUMBER || w.kind > OK_DENSE_RANK || w.kind == OK_LEAD || r[1] != 0 ||
        w.out == nullptr)
      return (int)cudaErrorInvalidValue;
    if (w.val == nullptr && w.kind != OK_ROW_NUMBER && w.kind != OK_COUNT)
      return (int)cudaErrorInvalidValue;
    if (w.val != nullptr && r[6] != RW_I64) return (int)cudaErrorInvalidValue;
    w.n_acc = os_accs(w.kind);
    for (int a = 0; a < 5; ++a) w.acc[a] = (long long*)acc_rows[5 * c + a];
    for (int a = 0; a < w.n_acc; ++a)
      if (w.acc[a] == nullptr) return (int)cudaErrorInvalidValue;
    w.stage = stages;
    stages += w.n_acc;
    w.scan = lanes;
    if (w.kind == OK_SUM) {
      add(OR_SUM, c, SEG_ADD);
    } else if (w.kind == OK_MIN || w.kind == OK_MAX) {
      add(OR_EXT, c, w.kind == OK_MIN ? SEG_MIN : SEG_MAX);
      add(OR_HAS, c, SEG_ADD);
    } else if (w.kind == OK_RANK || w.kind == OK_DENSE_RANK) {
      add(OR_VB, c, SEG_ADD);
      add(OR_GRP, c, SEG_MAX);
    }
  }
  plan.n = lanes;
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = rw_blocks(n, OS_THREADS);
  os_prep_kernel<<<blocks, OS_THREADS, 0, stream>>>(n, cap, slots, valid, ops, live, sdirty,
                                                    saw_delete, dropped, keys, idx);
  // the bytes a key in [0, cap] needs
  int bits = 0;
  while (bits < 63 && ((unsigned long long)cap >> bits) != 0ull) ++bits;
  int cur = 0;
  for (int b = 0; b * 8 < bits; ++b) {
    rbk_radix_pass(keys + cur * n, idx + cur * n, keys + (1 - cur) * n, idx + (1 - cur) * n, n,
                   8 * b, hist, stream);
    cur = 1 - cur;
  }
  v.skey = keys + cur * n;
  v.srow = idx + cur * n;
  rw_seg_scan(v, plan, n, carry, scan, stream);
  os_out_kernel<<<blocks, OS_THREADS, 0, stream>>>(v, n, scan, stage, ooo);
  os_store_kernel<<<blocks, OS_THREADS, 0, stream>>>(v, n, stage);
  return (int)cudaGetLastError();
}
