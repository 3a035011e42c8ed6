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
// with bit 63 flipped so unsigned order is signed order.
//
// Fold (win_fold_kernel): one coalesced pass over the domain in
// csrc/compact.cuh's tiles counts each tile's members and folds each key
// lane's encoded keys over the members into OR, AND, MIN and MAX; the host
// reads the count and the fold (one copy) and plans one packed key
// (over_window.window_pack_plan): each varying lane, most significant
// first, gets a field of the bits of (key - MIN) >> lo, lo its lowest
// varying bit, as wide as MAX - MIN needs; the fields fill 64-bit words
// from the top of the first.
//
// Order (win_write_kernel, win_sort): each member, in entry order, writes
// its words once (every key lane read at its own slot, no gather) beside
// its entry; then csrc/onesweep.cuh's single-sweep passes over the
// varying bytes of the last word, and, past 64 bits, of each earlier word
// gathered in the order so far (least significant word first). Ties keep
// entry order; keys are unique among the members (seq is), so the order
// is the reference's lax.sort order.
//
// Calls (win_layout_kernel, then win_calls): one pass lays out in sorted
// order what the scan and the calls read: the entry, a flag byte (segment
// head where a partition field differs from the row before, value-group
// start where the order field does too, live, touched) and each distinct
// call input with its null flag; then one segmented scan
// (csrc/segscan.cuh) of in_seg, gid and every call's running lanes, and
// each call's output: row_number, rank, dense_rank, lead/lag(k) and ROWS
// frames from neighbours of the same segment, running sum/count/min/max
// from the scan. A row takes part (frames, lead/lag, running values) only
// if live: always in the EOWC emit, present slots in the general step.
// The EOWC emit writes outputs at the sorted position; the general step
// writes each member's outputs as one record in sorted order, then one
// pass in slot order lands them through each slot's sorted place
// (win_place_kernel): whole records gathered, whole sectors written.
#pragma once

#include "compact.cuh"
#include "onesweep.cuh"
#include "segscan.cuh"
#include "tile.cuh"

#define WIN_MAX_KEYS 12   // = over_window.WINDOW_KEYS
#define WIN_MAX_CALLS 16  // = over_window.WINDOW_CALLS
#define WIN_MAX_WORDS 12  // 64-bit words of a packed key: 12 lanes of 64 bits
#define WIN_THREADS 256
#define WIN_SIGN 0x8000000000000000ull
#define WIN_MAXI 0x7FFFFFFFFFFFFFFFll
#define WIN_MINI ((long long)0x8000000000000000ull)

// a sorted member's flag byte
#define WIN_HEAD 1u     // a partition starts here
#define WIN_VB 2u       // a value group (partition, order value) starts here
#define WIN_LIVE 4u     // takes part in frames, lead/lag and running values
#define WIN_TOUCHED 8u  // marks its partition dirty (general step)

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

// One call: over_window._call_rows; `in` its input's place among the
// laid-out inputs (-1: it reads none).
struct WinCall {
  int kind, has_frame, lo, hi, offset, dt, in;
  const void* val;
  const uint8_t* vnull;
  long long* out;
  uint8_t* onull;
};

struct WinCalls {
  WinCall c[WIN_MAX_CALLS];
  int n;
};

// One field of the packed key: bits of (encoded key - min) >> lo, width
// wide, lowest bit at bit g0 of the whole key (64 * words bits, word 0
// most significant).
struct WinField {
  int lane, lo, width, g0;
  unsigned long long min;
};

struct WinPlan {
  WinField f[WIN_MAX_KEYS];
  unsigned mask[WIN_MAX_WORDS];  // per word: bit b where byte b may vary
  int n, words;
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

// ---- fold ---------------------------------------------------------------------------
// fold[4l .. 4l + 3]: OR, AND, MIN, MAX of lane l's encoded keys
__global__ void win_fold_init_kernel(int n_keys, unsigned long long* fold) {
  const int l = threadIdx.x;
  if (l < n_keys) {
    fold[4 * l] = 0ull;
    fold[4 * l + 1] = ~0ull;
    fold[4 * l + 2] = ~0ull;
    fold[4 * l + 3] = 0ull;
  }
}

__device__ __forceinline__ unsigned win_member_rounds(const WinDomain& d, int64_t total) {
  unsigned sel = 0u;
#pragma unroll
  for (int r = 0; r < COMPACT_ITEMS; ++r) {
    const int64_t e = compact_round_slot(blockIdx.x, r);
    if (e < total && win_member(d, e)) sel |= 1u << r;
  }
  return sel;
}

// part[tile] = the tile's members; the fold over them
__global__ void __launch_bounds__(COMPACT_THREADS)
    win_fold_kernel(WinKeys k, WinDomain d, int64_t total, int32_t* part,
                    unsigned long long* fold) {
  __shared__ unsigned long long s_fold[COMPACT_THREADS / 32][4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned sel = win_member_rounds(d, total);
  int excl;
  const int members = rw_block_exclusive_scan<COMPACT_THREADS>(__popc(sel), &excl);
  if (threadIdx.x == 0) part[blockIdx.x] = members;
  if (members == 0) return;
  for (int l = 0; l < k.n; ++l) {
    unsigned long long o = 0ull, a = ~0ull, lo = ~0ull, hi = 0ull;
    for (unsigned s = sel; s; s &= s - 1u) {
      const int64_t e = compact_round_slot(blockIdx.x, __ffs(s) - 1);
      const unsigned long long u = (unsigned long long)win_key(k, l, d, e) ^ WIN_SIGN;
      o |= u;
      a &= u;
      lo = u < lo ? u : lo;
      hi = u > hi ? u : hi;
    }
    for (int x = 16; x > 0; x >>= 1) {
      o |= __shfl_xor_sync(0xFFFFFFFFu, o, x);
      a &= __shfl_xor_sync(0xFFFFFFFFu, a, x);
      const unsigned long long ol = __shfl_xor_sync(0xFFFFFFFFu, lo, x);
      const unsigned long long oh = __shfl_xor_sync(0xFFFFFFFFu, hi, x);
      lo = ol < lo ? ol : lo;
      hi = oh > hi ? oh : hi;
    }
    if (lane == 0) {
      s_fold[warp][0] = o;
      s_fold[warp][1] = a;
      s_fold[warp][2] = lo;
      s_fold[warp][3] = hi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < COMPACT_THREADS / 32; ++w) {
        o |= s_fold[w][0];
        a &= s_fold[w][1];
        lo = s_fold[w][2] < lo ? s_fold[w][2] : lo;
        hi = s_fold[w][3] > hi ? s_fold[w][3] : hi;
      }
      atomicOr(fold + 4 * l, o);
      atomicAnd(fold + 4 * l + 1, a);
      atomicMin(fold + 4 * l + 2, lo);
      atomicMax(fold + 4 * l + 3, hi);
    }
    __syncthreads();
  }
}

// ---- order --------------------------------------------------------------------------
// Word w (0: most significant) of entry e's packed key.
__device__ __forceinline__ unsigned long long win_pack_word(const WinKeys& k, const WinPlan& p,
                                                            const WinDomain& d, int64_t e,
                                                            int w) {
  const int wl = p.words - 1 - w;  // the word's place from the least significant end
  unsigned long long out = 0ull;
  for (int f = 0; f < p.n; ++f) {
    const WinField& F = p.f[f];
    const int at = F.g0 >> 6, s = F.g0 & 63;
    const bool here = at == wl;
    const bool spill = at + 1 == wl && s != 0 && s + F.width > 64;
    if (!here && !spill) continue;
    const unsigned long long v =
        (((unsigned long long)win_key(k, F.lane, d, e) ^ WIN_SIGN) - F.min) >> F.lo;
    out |= here ? v << s : v >> (64 - s);
  }
  return out;
}

// The compaction's write pass, coalesced (compact.cuh compact_warp_place):
// each member in entry order into ent, its words beside it (word w at
// words[w * stride + place]).
__global__ void __launch_bounds__(COMPACT_THREADS)
    win_write_kernel(WinKeys k, WinPlan p, WinDomain d, int64_t total, const int32_t* part,
                     unsigned long long* __restrict__ words, int64_t stride,
                     int32_t* __restrict__ ent) {
  const unsigned sel = win_member_rounds(d, total);
  int64_t place = compact_warp_place(sel, part[blockIdx.x]);
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
#pragma unroll
  for (int r = 0; r < COMPACT_ITEMS; ++r) {
    const bool on = (sel >> r) & 1u;
    const unsigned b = __ballot_sync(0xFFFFFFFFu, on);
    if (on) {
      const int64_t e = compact_round_slot(blockIdx.x, r);
      const int64_t at = place + __popc(b & below);
      for (int w = 0; w < p.words; ++w) words[w * stride + at] = win_pack_word(k, p, d, e, w);
      ent[at] = (int32_t)e;
    }
    place += __popc(b);
  }
}

// The m members sorted by their packed words (onesweep.cuh os_sort_words).
static void win_sort(const WinPlan& p, int64_t m, int64_t stride, const unsigned long long* words,
                     const int32_t* ent, const OsScratch& s, const unsigned long long** key,
                     const int32_t** pay, cudaStream_t st) {
  os_sort_words(p.mask, p.words, m, stride, words, ent, s, key, pay, st);
}

// ---- calls --------------------------------------------------------------------------
// The sorted members as the order left them, and what tells a partition
// and a value group apart: the key bits of the partition fields and of
// the order field, per word.
struct WinSorted {
  const unsigned long long* key;  // word 0 of each sorted member's key
  const int32_t* pay;             // entry (one word) or compaction place (nullptr: i)
  const unsigned long long* words;
  const int32_t* ent;
  int64_t stride;
  int words_n;
  unsigned long long part_mask[WIN_MAX_WORDS], order_mask[WIN_MAX_WORDS];
};

// The distinct call inputs, each laid out in sorted order.
struct WinInputs {
  const void* val[WIN_MAX_CALLS];
  int dt[WIN_MAX_CALLS];
  const uint8_t* vnull[WIN_MAX_CALLS];
  long long* sv[WIN_MAX_CALLS];
  uint8_t* sn[WIN_MAX_CALLS];
  int n;
};

__device__ __forceinline__ unsigned long long win_word(const WinSorted& s, int w, int64_t i,
                                                       int64_t p) {
  return w == 0 ? s.key[i] : s.words[w * s.stride + p];
}

// pos (general): each member slot's sorted place (a ghost has no slot)
__global__ void win_layout_kernel(WinSorted s, WinDomain d, WinInputs in, const uint8_t* touched,
                                  int64_t m, int32_t* __restrict__ idx, uint8_t* __restrict__ hf,
                                  int32_t* __restrict__ pos) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int64_t p = s.pay != nullptr ? s.pay[i] : i;
  const int64_t e = s.words_n > 1 ? s.ent[p] : p;
  unsigned f = WIN_HEAD | WIN_VB;
  if (i > 0) {
    const int64_t q = s.pay != nullptr ? s.pay[i - 1] : i - 1;
    bool head = false, vb = false;
    for (int w = 0; w < s.words_n; ++w) {
      const unsigned long long x = win_word(s, w, i, p) ^ win_word(s, w, i - 1, q);
      head |= (x & s.part_mask[w]) != 0ull;
      vb |= (x & s.order_mask[w]) != 0ull;
    }
    f = head ? WIN_HEAD | WIN_VB : (vb ? WIN_VB : 0u);
  }
  if (win_live(d, e)) f |= WIN_LIVE;
  if (touched != nullptr && (e >= d.cap || touched[e])) f |= WIN_TOUCHED;
  hf[i] = (uint8_t)f;
  idx[i] = (int32_t)e;
  if (pos != nullptr && e < d.cap) pos[e] = (int32_t)i;
  for (int c = 0; c < in.n; ++c) {
    in.sv[c][i] = e < d.cap ? win_load(in.val[c], in.dt[c], e) : 0;
    in.sn[c][i] = in.vnull[c] == nullptr ? 0 : (e < d.cap ? in.vnull[c][e] : 1);
  }
}

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
  WinCalls calls;
  const uint8_t* hf;
  const long long* sv[WIN_MAX_CALLS];
  const uint8_t* sn[WIN_MAX_CALLS];
  int64_t m;
  int role[SEG_MAX_LANES];
  int call[SEG_MAX_LANES];

  __device__ __forceinline__ bool head(int64_t i) const { return hf[i] & WIN_HEAD; }
  __device__ __forceinline__ bool vb(int64_t i) const { return hf[i] & WIN_VB; }
  __device__ __forceinline__ bool live(int64_t i) const { return hf[i] & WIN_LIVE; }
  __device__ __forceinline__ long long val(const WinCall& c, int64_t i) const {
    return sv[c.in][i];
  }
  __device__ __forceinline__ bool vnull(const WinCall& c, int64_t i) const {
    return sn[c.in][i] != 0;
  }
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
__global__ void win_mark_kernel(int64_t m, const uint8_t* hf, const long long* scan,
                                uint8_t* segmark) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m && (hf[i] & WIN_TOUCHED)) segmark[scan[m + i] - 1] = 1;
}

// Where the calls' outputs go: the EOWC emit writes them at the sorted
// position (with the emission's lanes gathered there and the closed
// slots freed); the general step writes each member's record in sorted
// order (rec: rs words a member, word 0 its flags: bit 0 dirty
// partition, bit 1 + c call c's NULL; then call c's output at 1 + c),
// which win_place_kernel lands by slot.
struct WinOut {
  int64_t cap;
  const int32_t* idx;
  const long long* scan;
  const uint8_t* segmark;
  unsigned long long* rec;
  int rs;
  RwTileLanes gather;
  uint8_t* clear_valid;
};

__global__ void win_calls_kernel(WinView v, WinOut o) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= v.m) return;
  const int64_t m = v.m;
  const int64_t e = o.idx[i];
  const long long* scan = o.scan;
  const long long gid = scan[m + i];
  unsigned long long* rec = o.rec != nullptr ? o.rec + i * o.rs : nullptr;
  if (rec != nullptr && (e >= o.cap || !o.segmark[gid - 1])) {
    rec[0] = 0ull;  // a ghost, or a clean partition: nothing to land
    return;
  }
  unsigned long long flags = 1ull;
  const long long in_seg = scan[i] - 1;
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
    if (rec != nullptr) {
      rec[1 + c] = (unsigned long long)out;
      flags |= (onull ? 1ull : 0ull) << (1 + c);
    } else {
      w.out[i] = out;
      if (w.onull != nullptr) w.onull[i] = onull ? 1 : 0;
    }
  }
  if (rec != nullptr) {
    rec[0] = flags;
    return;
  }
  for (int g = 0; g < o.gather.n; ++g)
    rw_tile_copy(o.gather.dst[g], o.gather.src[g], o.gather.esize[g], i, e);
  if (o.clear_valid != nullptr) o.clear_valid[e] = 0;
}

// The general step's outputs by slot, in slot order: a slot whose sorted
// place (pos, -1 for a non-member) holds a dirty partition's record takes
// its outputs and NULL flags and dirty_slot = 1; every other slot 0.
__global__ void win_place_kernel(WinCalls calls, int64_t cap, const int32_t* __restrict__ pos,
                                 const unsigned long long* __restrict__ rec, int rs,
                                 uint8_t* __restrict__ dirty_slot) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= cap) return;
  const int32_t p = pos[s];
  const unsigned long long* r = p >= 0 ? rec + (int64_t)p * rs : nullptr;
  const unsigned long long flags = r != nullptr ? r[0] : 0ull;
  const bool dirty = flags & 1ull;
  for (int c = 0; c < calls.n; ++c) {
    const WinCall& w = calls.c[c];
    w.out[s] = dirty ? (long long)r[1 + c] : 0;
    if (w.onull != nullptr) w.onull[s] = dirty ? (uint8_t)((flags >> (1 + c)) & 1ull) : 0;
  }
  dirty_slot[s] = dirty ? 1 : 0;
}

__global__ void win_valid_kernel(int64_t out_cap, int64_t m, uint8_t* out_valid) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < out_cap) out_valid[i] = i < m ? 1 : 0;
}
