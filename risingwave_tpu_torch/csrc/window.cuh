// Kernel AE's sorted-segment window body, shared by the EOWC emit and the
// general executor's recompute (risingwave_tpu/executors/over_window.py
// _eowc_over_emit :437-572 and _general_over_step :1061-1202, nearly line
// for line).
//
// A domain is `cap` arena slots plus `n_ghost` ghost entries (entry
// cap + j stands for chunk row j's old partition; only the general step
// has them). Its members are the slots with m1 | m2 (and, with a window
// lane, win < cutoff) and the ghosts marked in `ghost`. A sort key lane is
// read at a slot from `lane`, or from `fallback` where `present` is given
// and the slot is not present, and at a ghost from `fallback` at the
// ghost's slot; the ABSENT mode gives 1 for a slot that is not present
// and for a ghost (live rows first). Values are signed; a key is encoded
// with bit 63 flipped so unsigned digit order is signed order.
//
// Order (rw_window_order): the members compacted in entry order
// (csrc/compact.cuh), each key lane's varying bits folded (one host read
// of them and of the count), then one gather and kernel F's stable 8-bit
// passes (csrc/radix.cuh) per varying byte of each key lane, least
// significant lane first: ties keep entry order. Keys are unique among the
// members (seq is), so the order is the reference's lax.sort order.
//
// Calls (win_calls): over the m sorted members, segment heads where a
// partition key changes, then one segmented scan (csrc/segscan.cuh) of
// in_seg, gid and every call's running lanes, then each call's output:
// row_number, rank, dense_rank, lead/lag(k) and ROWS frames by looking at
// neighbours of the same segment, running sum/count/min/max from the
// scan. A row takes part (frames, lead/lag, running values) only if live:
// always in the EOWC emit, present slots in the general step.
#pragma once

#include "compact.cuh"
#include "radix.cuh"
#include "segscan.cuh"
#include "tile.cuh"

#define WIN_MAX_KEYS 12   // = over_window.WINDOW_KEYS
#define WIN_MAX_CALLS 16  // = over_window.WINDOW_CALLS
#define WIN_THREADS 256
#define WIN_BITS_BLOCKS 1024
#define WIN_SIGN 0x8000000000000000ull
#define WIN_MAXI 0x7FFFFFFFFFFFFFFFll
#define WIN_MINI ((long long)0x8000000000000000ull)

// = over_window.KINDS
enum WinKind : int {
  WK_ROW_NUMBER = 0,
  WK_COUNT = 1,
  WK_SUM = 2,
  WK_MIN = 3,
  WK_MAX = 4,
  WK_LAG = 5,
  WK_LEAD = 6,
  WK_RANK = 7,
  WK_DENSE_RANK = 8,
};

enum WinKeyMode : int { WIN_KEY_VALUE = 0, WIN_KEY_ABSENT = 1 };

struct WinDomain {
  int64_t cap, n_ghost;
  const uint8_t* m1;
  const uint8_t* m2;
  const long long* win;
  long long cutoff;
  const uint8_t* present;
  const uint8_t* ghost;
  const int32_t* gslot;
};

struct WinKeys {
  const void* lane[WIN_MAX_KEYS];
  int dt[WIN_MAX_KEYS];
  const long long* fallback[WIN_MAX_KEYS];
  int mode[WIN_MAX_KEYS];
  int n;
};

// One call: over_window._call_rows.
struct WinCall {
  int kind, has_frame, lo, hi, offset, dt;
  const void* val;
  const uint8_t* vnull;
  long long* out;
  uint8_t* onull;
};

struct WinCalls {
  WinCall c[WIN_MAX_CALLS];
  int n;
};

__device__ __forceinline__ long long win_load(const void* p, int dt, int64_t i) {
  switch (dt) {
    case RW_BOOL: return ((const uint8_t*)p)[i] ? 1 : 0;
    case RW_I32: return (long long)((const int32_t*)p)[i];
    default: return ((const long long*)p)[i];
  }
}

__device__ __forceinline__ bool win_member(const WinDomain& d, int64_t e) {
  if (e >= d.cap) return d.ghost[e - d.cap] != 0;
  bool m = d.m1[e] != 0 || (d.m2 != nullptr && d.m2[e] != 0);
  if (m && d.win != nullptr) m = d.win[e] < d.cutoff;
  return m;
}

__device__ __forceinline__ bool win_live(const WinDomain& d, int64_t e) {
  if (d.present == nullptr) return true;
  return e < d.cap && d.present[e] != 0;
}

__device__ __forceinline__ long long win_key(const WinKeys& k, int l, const WinDomain& d,
                                             int64_t e) {
  if (k.mode[l] == WIN_KEY_ABSENT) return win_live(d, e) ? 0 : 1;
  if (e >= d.cap) return k.fallback[l][d.gslot[e - d.cap]];
  if (d.present != nullptr && k.fallback[l] != nullptr && !d.present[e]) return k.fallback[l][e];
  return win_load(k.lane[l], k.dt[l], e);
}

// ---- order ------------------------------------------------------------------------
struct WinMemberFlags {
  static constexpr bool kAux = false;
  WinDomain d;
  __device__ int flags(int64_t total, int64_t base, uint8_t* f, int*) const {
    int c = 0;
#pragma unroll
    for (int j = 0; j < COMPACT_ITEMS; ++j) {
      const int64_t e = base + j;
      const bool m = e < total && win_member(d, e);
      f[j] = m ? 1 : 0;
      c += m;
    }
    return c;
  }
  __device__ void on_select(int64_t, uint8_t) const {}
  __device__ void on_total(long long*) const {}
};

__global__ void win_bits_init_kernel(int n_keys, unsigned long long* bits) {
  const int l = threadIdx.x;
  if (l < n_keys) {
    bits[2 * l] = 0ull;
    bits[2 * l + 1] = ~0ull;
  }
}

// bits[2l] |= every member's encoded key of lane l, bits[2l + 1] &= each
__global__ void win_bits_kernel(WinKeys k, WinDomain d, const int32_t* sel, const long long* status,
                                int64_t total, unsigned long long* bits) {
  const int64_t m = status[0];
  for (int l = 0; l < k.n; ++l) {
    unsigned long long o = 0ull, a = ~0ull;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m && i < total;
         i += (int64_t)gridDim.x * blockDim.x) {
      const unsigned long long e = (unsigned long long)win_key(k, l, d, sel[i]) ^ WIN_SIGN;
      o |= e;
      a &= e;
    }
    for (int s = 16; s > 0; s >>= 1) {
      o |= __shfl_xor_sync(0xFFFFFFFFu, o, s);
      a &= __shfl_xor_sync(0xFFFFFFFFu, a, s);
    }
    if ((threadIdx.x & 31) == 0) {
      atomicOr(bits + 2 * l, o);
      atomicAnd(bits + 2 * l + 1, a);
    }
  }
}

__global__ void win_copy_kernel(const int32_t* src, int64_t m, int32_t* dst) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m) dst[i] = src[i];
}

__global__ void win_gather_key_kernel(WinKeys k, int l, WinDomain d, int64_t m, const int32_t* idx,
                                      unsigned long long* keys) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m) keys[i] = (unsigned long long)win_key(k, l, d, idx[i]) ^ WIN_SIGN;
}

// The members in key order at idx[0, m); returns m, or -1 on a CUDA error.
static int64_t win_order(const WinKeys& k, const WinDomain& d, int32_t* sel, uint8_t* payload,
                         int32_t* part, long long* status, unsigned long long* keys, int32_t* idx,
                         int32_t* hist, unsigned long long* bits, cudaStream_t st) {
  const int64_t total = d.cap + d.n_ghost;
  WinMemberFlags fn{d};
  rw_compact(fn, total, part, sel, payload, status, st);
  win_bits_init_kernel<<<1, 32, 0, st>>>(k.n, bits);
  const int blocks = rw_blocks(total, WIN_THREADS);
  win_bits_kernel<<<blocks < WIN_BITS_BLOCKS ? blocks : WIN_BITS_BLOCKS, WIN_THREADS, 0, st>>>(
      k, d, sel, status, total, bits);
  unsigned long long h[2 * WIN_MAX_KEYS];
  long long m = 0;
  if (cudaMemcpyAsync(&m, status, sizeof(long long), cudaMemcpyDeviceToHost, st) != cudaSuccess ||
      cudaMemcpyAsync(h, bits, sizeof(unsigned long long) * 2 * k.n, cudaMemcpyDeviceToHost,
                      st) != cudaSuccess ||
      cudaStreamSynchronize(st) != cudaSuccess)
    return -1;
  if (m == 0) return 0;
  const int mb = rw_blocks(m, WIN_THREADS);
  win_copy_kernel<<<mb, WIN_THREADS, 0, st>>>(sel, m, idx);
  int cur = 0;
  for (int l = k.n - 1; l >= 0; --l) {
    const unsigned long long varying = h[2 * l] ^ h[2 * l + 1];
    if (varying == 0ull) continue;  // one value in every member orders nothing
    win_gather_key_kernel<<<mb, WIN_THREADS, 0, st>>>(k, l, d, m, idx + cur * m, keys + cur * m);
    for (int b = 0; b < 8; ++b) {
      if (((varying >> (8 * b)) & 0xFFull) == 0ull) continue;
      rbk_radix_pass(keys + cur * m, idx + cur * m, keys + (1 - cur) * m, idx + (1 - cur) * m, m,
                     8 * b, hist, st);
      cur = 1 - cur;
    }
  }
  if (cur == 1) win_copy_kernel<<<mb, WIN_THREADS, 0, st>>>(idx + m, m, idx);
  return m;
}

// ---- calls ------------------------------------------------------------------------
// Scan lane roles (over_window._window_scan_lanes counts them)
enum WinRole : int {
  WR_IN_SEG = 0,  // count from the segment head
  WR_GID = 1,     // heads so far (no reset)
  WR_RANK = 2,    // latest value-group start (max)
  WR_DENSE = 3,   // value-group starts in the segment
  WR_SUM = 4,     // live non-null values
  WR_COUNT = 5,   // live rows
  WR_EXT = 6,     // live non-null values, else the sentinel (min or max)
  WR_HAS = 7,     // live non-null rows
};

struct WinView {
  WinDomain d;
  WinKeys k;
  WinCalls calls;
  const int32_t* idx;  // sorted entries
  int64_t m;
  int n_part, order_key;
  int role[SEG_MAX_LANES];
  int call[SEG_MAX_LANES];

  __device__ __forceinline__ bool head(int64_t i) const {
    if (i == 0) return true;
    const int64_t e = idx[i], p = idx[i - 1];
    for (int l = 0; l < n_part; ++l)
      if (win_key(k, l, d, e) != win_key(k, l, d, p)) return true;
    return false;
  }
  __device__ __forceinline__ long long order(int64_t i) const {
    return win_key(k, order_key, d, idx[i]);
  }
  __device__ __forceinline__ bool vb(int64_t i) const {
    return head(i) || order(i) != order(i - 1);
  }
  __device__ __forceinline__ long long val(const WinCall& c, int64_t i) const {
    const int64_t e = idx[i];
    return e < d.cap ? win_load(c.val, c.dt, e) : 0;
  }
  __device__ __forceinline__ bool vnull(const WinCall& c, int64_t i) const {
    if (c.vnull == nullptr) return false;
    const int64_t e = idx[i];
    return e < d.cap ? c.vnull[e] != 0 : true;
  }
  __device__ __forceinline__ bool live(int64_t i) const { return win_live(d, idx[i]); }
  __device__ __forceinline__ long long value(int l, int64_t i) const {
    switch (role[l]) {
      case WR_IN_SEG: return 1;
      case WR_GID: return head(i) ? 1 : 0;
      case WR_RANK: return vb(i) ? (long long)i : WIN_MINI;
      case WR_DENSE: return vb(i) ? 1 : 0;
      case WR_COUNT: return live(i) ? 1 : 0;
      default: break;
    }
    const WinCall& c = calls.c[call[l]];
    const bool real = live(i) && !vnull(c, i);
    switch (role[l]) {
      case WR_SUM: return real ? val(c, i) : 0;
      case WR_EXT: return real ? val(c, i) : (c.kind == WK_MIN ? WIN_MAXI : WIN_MINI);
      default: return real ? 1 : 0;  // WR_HAS
    }
  }
};

// The scan plan of `calls` into `v` (roles) and `plan` (combines).
static inline void win_plan(WinView& v, SegPlan& plan) {
  int n = 0;
  auto add = [&](int role, int call, int op, int reset) {
    v.role[n] = role;
    v.call[n] = call;
    plan.op[n] = op;
    plan.reset[n] = reset;
    ++n;
  };
  add(WR_IN_SEG, -1, SEG_ADD, 1);
  add(WR_GID, -1, SEG_ADD, 0);
  for (int c = 0; c < v.calls.n; ++c) {
    const WinCall& w = v.calls.c[c];
    if (w.kind == WK_RANK) add(WR_RANK, c, SEG_MAX, 1);
    else if (w.kind == WK_DENSE_RANK) add(WR_DENSE, c, SEG_ADD, 1);
    else if (!w.has_frame && w.kind == WK_SUM) add(WR_SUM, c, SEG_ADD, 1);
    else if (!w.has_frame && w.kind == WK_COUNT) add(WR_COUNT, c, SEG_ADD, 1);
    else if (!w.has_frame && (w.kind == WK_MIN || w.kind == WK_MAX)) {
      add(WR_EXT, c, w.kind == WK_MIN ? SEG_MIN : SEG_MAX, 1);
      add(WR_HAS, c, SEG_ADD, 1);
    }
  }
  plan.n = n;
}

// segmark[gid] = 1 where the segment holds a touched entry (a ghost is)
__global__ void win_mark_kernel(WinView v, const long long* scan, const uint8_t* touched,
                                uint8_t* segmark) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= v.m) return;
  const int64_t e = v.idx[i];
  if (e >= v.d.cap || touched[e]) segmark[scan[v.m + i] - 1] = 1;
}

struct WinOut {
  int unsort;
  const long long* scan;
  const uint8_t* segmark;
  uint8_t* dirty_slot;
  RwTileLanes gather;
  uint8_t* clear_valid;
};

__global__ void win_calls_kernel(WinView v, WinOut o) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= v.m) return;
  const int64_t m = v.m;
  const int64_t e = v.idx[i];
  if (o.unsort && e >= v.d.cap) return;  // a ghost has no slot
  const int64_t pos = o.unsort ? e : i;
  const long long* scan = o.scan;
  const long long in_seg = scan[i] - 1;
  const long long gid = scan[m + i];
  const bool live_i = v.live(i);
  int l = 2;
  for (int c = 0; c < v.calls.n; ++c) {
    const WinCall& w = v.calls.c[c];
    long long out = 0;
    bool onull = false;
    if (w.kind == WK_ROW_NUMBER) {
      out = in_seg + 1;
    } else if (w.kind == WK_RANK) {
      out = scan[l * m + i] - (i - in_seg) + 1;
      ++l;
    } else if (w.kind == WK_DENSE_RANK) {
      out = scan[l * m + i];
      ++l;
    } else if (w.kind == WK_LEAD || w.kind == WK_LAG) {
      const int64_t j = i + (w.kind == WK_LEAD ? w.offset : -w.offset);
      const bool ok = j >= 0 && j < m && scan[m + j] == gid && v.live(j) && live_i;
      out = ok ? v.val(w, j) : 0;
      onull = ok ? v.vnull(w, j) : true;
    } else if (w.has_frame) {
      const long long ident =
          w.kind == WK_MIN ? WIN_MAXI : (w.kind == WK_MAX ? WIN_MINI : 0);
      long long acc = ident;
      bool any = false;
      for (int dd = w.lo; dd <= w.hi; ++dd) {
        const int64_t j = i + dd;
        const bool ok = j >= 0 && j < m && scan[m + j] == gid && v.live(j) && live_i;
        const bool real = ok && (w.kind == WK_COUNT || !v.vnull(w, j));
        if (!real) continue;
        const long long x = w.kind == WK_COUNT ? 1 : v.val(w, j);
        if (w.kind == WK_MIN) acc = x < acc ? x : acc;
        else if (w.kind == WK_MAX) acc = x > acc ? x : acc;
        else acc = (long long)((unsigned long long)acc + (unsigned long long)x);
        any = true;
      }
      out = acc;
      onull = w.kind == WK_COUNT ? false : !any;
    } else if (w.kind == WK_SUM || w.kind == WK_COUNT) {
      out = scan[l * m + i];
      ++l;
    } else {  // running min / max
      out = scan[l * m + i];
      onull = scan[(l + 1) * m + i] <= 0;
      l += 2;
    }
    w.out[pos] = out;
    if (w.onull != nullptr) w.onull[pos] = onull ? 1 : 0;
  }
  if (o.dirty_slot != nullptr) o.dirty_slot[e] = o.segmark[gid - 1];
  if (!o.unsort) {
    for (int g = 0; g < o.gather.n; ++g)
      rw_tile_copy(o.gather.dst[g], o.gather.src[g], o.gather.esize[g], i, e);
    if (o.clear_valid != nullptr) o.clear_valid[e] = 0;
  }
}

__global__ void win_valid_kernel(int64_t out_cap, int64_t m, uint8_t* out_valid) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < out_cap) out_valid[i] = i < m ? 1 : 0;
}
