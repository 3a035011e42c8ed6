// Kernels W and X: rank a TopN row store.
//
// W replaces risingwave_tpu/executors/top_n_plain.py:_rank_top (:86):
// the slots of the first n rows of the store by (live first, order key,
// pk lanes, slot), and their liveness. X replaces _group_topk_mask
// (:390): per slot, in_topk (live and among its group's first k by
// (live first, order key, pk lanes, slot)) and gdirty (its group, by
// the group lanes' values, holds an epoch-dirty slot). Liveness is its
// own key, so a dead row never displaces a live one, whatever its order
// value. Order keys are the reference's unsigned keys (_order_key_u64:
// a float's total-order key, a signed lane with its top bit flipped, all
// bits inverted for DESC), computed here from the order lane; pk and
// group lanes order as signed integers (bool: false first).
//
// What bounds them on the card: bytes. W's sort reads and writes a
// 12-byte (key, slot) pair per slot of the store each pass; X reads the
// live, epoch-dirty, group and order lanes of every slot twice, sorts
// 12-byte pairs of the live rows only, and writes two bool lanes.
//
// W's design: an LSD radix sort, least significant key first, of (64-bit
// encoded key, slot) pairs that starts from the slots in order, so ties
// keep slot order with no pass over the slot. One launch first folds
// every lane's encoded keys into their OR and AND, which the host reads
// (the entry's one device-to-host copy): a byte where the two agree is
// the same for every key and gets no pass, a lane with no varying bit no
// gather. Each key lane that varies: one gather of its encoded key in the
// current order, then kernel F's stable 8-bit pass (csrc/radix.cuh) per
// varying byte; W copies out the first n slots and their liveness.
//
// X's design rests on two facts: only a live row can be in_topk, and its
// rank depends only on the live rows of its group; the pk lanes and the
// slot only break ties between rows of equal (group, order key).
//   1. rw_group_topk_fold, one coalesced pass: each tile's live count (the
//      count of csrc/compact.cuh's compaction), the OR and AND of the
//      group lanes' and the order key's encoded keys over the live rows,
//      the epoch-dirty count; the host reads them (one copy) and packs the
//      varying bits of each lane, group lanes first, into one 64-bit key
//      (top_n_plain.topk_pack_plan; past 64 bits it keeps the top 64);
//   2. rw_group_topk_mask: the compaction's write pass (compact.cuh's
//      coalesced compact_warp_place) puts each live slot in slot order beside
//      its packed key (no gather through a permutation), then one stable
//      8-bit pass per varying byte of the key. A row is in_topk by place
//      when the row k places before it is of another group (the group is
//      the key's top bits). Only a run of equal keys that straddles a
//      group's k-th place can be misplaced (ties by order key, or order
//      bits cut past 64): one warp per such run ranks its rows by the full
//      (order key, store keys, slot). Where the group bits alone pass 64,
//      every run of equal key longer than k is ranked so, counting only
//      rows of the same group. A warp counts at most long_run rows a row
//      (top_n_plain.TOPK_LONG_RUN); a longer run is listed, and
//      rw_group_topk_long sorts the rows of all listed runs alone by (run,
//      [group lanes,] order key, store keys, slot), the LSD passes above
//      over those rows only, and places each by its rank in its run: no
//      run costs more than linear work;
//   3. gdirty without the sort: the group key of each epoch-dirty slot goes
//      into a set of at least twice their count (csrc/probe.cuh's claim
//      protocol, probing unbounded), then every slot probes it with its
//      group lanes; a store all dirty or all clean needs no set.
#include "compact.cuh"
#include "probe.cuh"
#include "radix.cuh"

#define TR_MAX_KEYS 12
#define TR_THREADS 256
#define TR_BITS_BLOCKS 1024
#define TR_SIGN 0x8000000000000000ull

// a key lane's role (top_n_plain.py _KEY_*)
enum TrMode : int { TR_PLAIN = 0, TR_ASC = 1, TR_DESC = 2, TR_LIVE_LAST = 3 };

struct TrKeys {
  const void* lane[TR_MAX_KEYS];  // (cap,) lanes, most significant first
  int dt[TR_MAX_KEYS];
  int mode[TR_MAX_KEYS];
  int n;
};

__device__ __forceinline__ unsigned long long tr_encode(const void* lane, int dt, int mode,
                                                        int64_t i) {
  if (mode == TR_LIVE_LAST) return ((const uint8_t*)lane)[i] ? 0ull : 1ull;
  if (mode == TR_PLAIN) {
    switch (dt) {
      case RW_BOOL: return ((const uint8_t*)lane)[i] ? 1ull : 0ull;
      case RW_I32: return (unsigned long long)((uint32_t)((const int32_t*)lane)[i] ^ 0x80000000u);
      default: return (unsigned long long)((const long long*)lane)[i] ^ TR_SIGN;
    }
  }
  unsigned long long k;
  switch (dt) {
    case RW_BOOL: k = (((const uint8_t*)lane)[i] ? 1ull : 0ull) ^ TR_SIGN; break;
    case RW_I32: k = (unsigned long long)(long long)((const int32_t*)lane)[i] ^ TR_SIGN; break;
    case RW_I64: k = (unsigned long long)((const long long*)lane)[i] ^ TR_SIGN; break;
    case RW_F32: k = (unsigned long long)rw_order_key_f32(((const float*)lane)[i]); break;
    default: k = (unsigned long long)rw_order_key_f64(((const double*)lane)[i]) ^ TR_SIGN; break;
  }
  return mode == TR_DESC ? ~k : k;
}

__global__ void tr_bits_init_kernel(int n_keys, unsigned long long* bits) {
  const int l = threadIdx.x;
  if (l < n_keys) {
    bits[2 * l] = 0ull;
    bits[2 * l + 1] = ~0ull;
  }
}

// bits[2l] |= every encoded key of lane l, bits[2l + 1] &= each
__global__ void tr_bits_kernel(TrKeys kd, int64_t n, unsigned long long* bits) {
  for (int l = 0; l < kd.n; ++l) {
    unsigned long long o = 0ull, a = ~0ull;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
      const unsigned long long e = tr_encode(kd.lane[l], kd.dt[l], kd.mode[l], i);
      o |= e;
      a &= e;
    }
    for (int d = 16; d > 0; d >>= 1) {
      o |= __shfl_xor_sync(0xFFFFFFFFu, o, d);
      a &= __shfl_xor_sync(0xFFFFFFFFu, a, d);
    }
    if ((threadIdx.x & 31) == 0) {
      atomicOr(bits + 2 * l, o);
      atomicAnd(bits + 2 * l + 1, a);
    }
  }
}

__global__ void tr_init_kernel(int64_t n, int32_t* idx) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) idx[i] = (int32_t)i;
}

__global__ void tr_gather_kernel(const void* lane, int dt, int mode, int64_t n,
                                 unsigned long long* keys, const int32_t* idx) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = tr_encode(lane, dt, mode, idx[i]);
}

// The whole sort: the slots in key order land in idx + return * n (the
// buffer the last pass wrote), or -1 on a CUDA error.
static int tr_sort(const TrKeys& kd, int64_t n, unsigned long long* keys, int32_t* idx,
                   int32_t* hist, unsigned long long* bits, cudaStream_t st) {
  const int blocks = rw_blocks(n, TR_THREADS);
  tr_bits_init_kernel<<<1, 32, 0, st>>>(kd.n, bits);
  tr_bits_kernel<<<blocks < TR_BITS_BLOCKS ? blocks : TR_BITS_BLOCKS, TR_THREADS, 0, st>>>(
      kd, n, bits);
  unsigned long long h[2 * TR_MAX_KEYS];
  if (cudaMemcpyAsync(h, bits, sizeof(unsigned long long) * 2 * kd.n, cudaMemcpyDeviceToHost,
                      st) != cudaSuccess ||
      cudaStreamSynchronize(st) != cudaSuccess)
    return -1;
  tr_init_kernel<<<blocks, TR_THREADS, 0, st>>>(n, idx);
  int cur = 0;
  for (int l = kd.n - 1; l >= 0; --l) {
    const unsigned long long varying = h[2 * l] ^ h[2 * l + 1];
    if (varying == 0ull) continue;  // one value in every slot orders nothing
    tr_gather_kernel<<<blocks, TR_THREADS, 0, st>>>(kd.lane[l], kd.dt[l], kd.mode[l], n,
                                                    keys + cur * n, idx + cur * n);
    for (int b = 0; b < 8; ++b) {
      if (((varying >> (8 * b)) & 0xFFull) == 0ull) continue;
      rbk_radix_pass(keys + cur * n, idx + cur * n, keys + (1 - cur) * n, idx + (1 - cur) * n,
                     n, 8 * b, hist, st);
      cur = 1 - cur;
    }
  }
  return cur;
}

static bool tr_parse(const int64_t* rows, int n_keys, TrKeys* kd) {
  if (n_keys < 1 || n_keys > TR_MAX_KEYS) return false;
  kd->n = n_keys;
  for (int l = 0; l < n_keys; ++l) {
    kd->lane[l] = (const void*)rows[3 * l];
    kd->dt[l] = (int)rows[3 * l + 1];
    kd->mode[l] = (int)rows[3 * l + 2];
    if (kd->mode[l] < TR_PLAIN || kd->mode[l] > TR_LIVE_LAST) return false;
    if (kd->mode[l] == TR_PLAIN && (kd->dt[l] == RW_F32 || kd->dt[l] == RW_F64)) return false;
    if (kd->mode[l] == TR_LIVE_LAST && kd->dt[l] != RW_BOOL) return false;
  }
  return true;
}

__global__ void tr_top_kernel(int64_t n_top, const int32_t* order, const uint8_t* live,
                              int32_t* out_idx, uint8_t* out_alive) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_top) return;
  const int32_t s = order[i];
  out_idx[i] = s;
  out_alive[i] = live[s];
}

// keys: n_keys rows of (lane, dtype code, mode), most significant first:
// live (LIVE_LAST), the order lane (ASC/DESC), the pk lanes (PLAIN).
// keys_buf: 2 * cap int64; idx_buf: 2 * cap int32; hist: 256 * tiles +
// 256 int32 (radix.cuh); bits: 2 * n_keys int64.
RW_EXPORT int rw_rank_top(const int64_t* keys, int n_keys, int64_t cap, const void* live,
                          void* keys_buf, void* idx_buf, void* hist, void* bits, int64_t n_top,
                          void* out_idx, void* out_alive, void* stream) {
  TrKeys kd;
  if (!tr_parse(keys, n_keys, &kd) || cap < 1 || n_top < 0 || n_top > cap)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int cur = tr_sort(kd, cap, (unsigned long long*)keys_buf, (int32_t*)idx_buf,
                          (int32_t*)hist, (unsigned long long*)bits, st);
  if (cur < 0) return (int)cudaGetLastError();
  if (n_top > 0)
    tr_top_kernel<<<rw_blocks(n_top, TR_THREADS), TR_THREADS, 0, st>>>(
        n_top, (const int32_t*)idx_buf + cur * cap, (const uint8_t*)live, (int32_t*)out_idx,
        (uint8_t*)out_alive);
  return (int)cudaGetLastError();
}

// ---- kernel X ---------------------------------------------------------------------
// Key lanes of an X call: the n_group group lanes (PLAIN), the order lane
// (ASC/DESC), the store's key lanes that are not group lanes (PLAIN). The
// fold covers the first n_group + 1 (group lanes and order key).
#define XK_MAX_GROUP (TR_MAX_KEYS - 1)
#define XK_FOLD_MAX TR_MAX_KEYS
#define XK_WARPS (COMPACT_THREADS / 32)
#define XK_RESOLVE_THREADS 256
#define XK_LONG_THREADS 256
// work's header (int64): the listed runs' count, the long runs' count,
// the rows of the long runs; then the listed runs, then 4 words per long
// run (first row, length, m, offset among the long runs' rows)
#define XK_HEAD 3

// The packed key of a live row: each field (bits [lo, lo + w) of a fold
// lane's encoded key) lands with its lowest bit at pos, a negative pos
// cutting the field's low bits (a key past 64 bits keeps its top 64).
struct XkPlan {
  int n;
  int lane[XK_FOLD_MAX];
  int lo[XK_FOLD_MAX];
  int w[XK_FOLD_MAX];
  int pos[XK_FOLD_MAX];
};

__device__ __forceinline__ unsigned long long xk_pack(const TrKeys& kd, const XkPlan& p,
                                                      int64_t s) {
  unsigned long long key = 0ull;
#pragma unroll
  for (int f = 0; f < XK_FOLD_MAX; ++f) {
    if (f >= p.n) break;
    const int l = p.lane[f];
    unsigned long long v = tr_encode(kd.lane[l], kd.dt[l], kd.mode[l], s) >> p.lo[f];
    if (p.w[f] < 64) v &= (1ull << p.w[f]) - 1ull;
    key |= p.pos[f] >= 0 ? v << p.pos[f] : v >> -p.pos[f];
  }
  return key;
}

// The group part of a packed key (exact groups: its top bits).
__device__ __forceinline__ unsigned long long xk_group(unsigned long long key, int gshift) {
  return gshift >= 64 ? 0ull : key >> gshift;
}

// The set of the epoch-dirty slots' group keys (gdirty): probe.cuh's
// table layout over set_cap slots, probing unbounded (at most half full,
// so a chain always ends); cap == 0 for none.
struct XkSet {
  KeyLanesN<XK_MAX_GROUP> g;  // in: the store's group lanes, tab: the set's key lanes
  int32_t* fp1;
  int32_t* fp2;
  int32_t* stamp;
  const uint8_t* dirty;
  uint32_t mask;
  int64_t cap;
};

// Per tile of COMPACT_TILE slots: its live count (the compaction's count,
// into part), and over the live slots each fold lane's OR (fold[l]) and
// AND (fold[n_fold + l]); the epoch-dirty slots are counted into
// fold[2 n_fold]. One coalesced pass, each thread's loads issued together.
__global__ void xk_fold_kernel(TrKeys kd, int n_fold, int64_t cap, const uint8_t* live,
                               const uint8_t* dirty, int32_t* part, unsigned long long* fold) {
  __shared__ unsigned long long s_or[XK_FOLD_MAX][XK_WARPS];
  __shared__ unsigned long long s_and[XK_FOLD_MAX][XK_WARPS];
  bool lv[COMPACT_ITEMS];
  int n_live = 0, n_dirty = 0;
#pragma unroll
  for (int r = 0; r < COMPACT_ITEMS; ++r) {
    const int64_t s = compact_round_slot(blockIdx.x, r);
    lv[r] = s < cap && live[s];
    n_live += lv[r] ? 1 : 0;
    n_dirty += s < cap && dirty[s] ? 1 : 0;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int l = 0; l < XK_FOLD_MAX; ++l) {
    if (l >= n_fold) break;
    unsigned long long o = 0ull, a = ~0ull;
#pragma unroll
    for (int r = 0; r < COMPACT_ITEMS; ++r) {
      if (!lv[r]) continue;
      const unsigned long long e =
          tr_encode(kd.lane[l], kd.dt[l], kd.mode[l], compact_round_slot(blockIdx.x, r));
      o |= e;
      a &= e;
    }
    for (int d = 16; d > 0; d >>= 1) {
      o |= __shfl_xor_sync(0xFFFFFFFFu, o, d);
      a &= __shfl_xor_sync(0xFFFFFFFFu, a, d);
    }
    if (lane == 0) {
      s_or[l][warp] = o;
      s_and[l][warp] = a;
    }
  }
  int excl;
  const int total_live = rw_block_exclusive_scan<COMPACT_THREADS>(n_live, &excl);
  const int total_dirty = rw_block_exclusive_scan<COMPACT_THREADS>(n_dirty, &excl);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = total_live;
    if (total_dirty) atomicAdd(fold + 2 * n_fold, (unsigned long long)total_dirty);
    if (total_live) {
      for (int l = 0; l < n_fold; ++l) {
        unsigned long long bo = 0ull, ba = ~0ull;
        for (int w = 0; w < XK_WARPS; ++w) {
          bo |= s_or[l][w];
          ba &= s_and[l][w];
        }
        atomicOr(fold + l, bo);
        atomicAnd(fold + n_fold + l, ba);
      }
    }
  }
}

// The compaction's write pass, coalesced (compact.cuh compact_warp_place):
// each live slot into idx (slot order) beside its packed key in keys.
__global__ void xk_write_kernel(TrKeys kd, XkPlan plan, int64_t cap,
                                const uint8_t* __restrict__ live, const int32_t* part,
                                unsigned long long* __restrict__ keys,
                                int32_t* __restrict__ idx) {
  unsigned sel = 0u;
#pragma unroll
  for (int r = 0; r < COMPACT_ITEMS; ++r) {
    const int64_t s = compact_round_slot(blockIdx.x, r);
    if (s < cap && live[s]) sel |= 1u << r;
  }
  int64_t place = compact_warp_place(sel, part[blockIdx.x]);
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
#pragma unroll
  for (int r = 0; r < COMPACT_ITEMS; ++r) {
    const bool on = (sel >> r) & 1u;
    const unsigned b = __ballot_sync(0xFFFFFFFFu, on);
    if (on) {
      const int64_t s = compact_round_slot(blockIdx.x, r);
      const int64_t at = place + __popc(b & below);
      keys[at] = xk_pack(kd, plan, s);
      idx[at] = (int32_t)s;
    }
    place += __popc(b);
  }
}

// The set: each epoch-dirty slot's group key, COMPACT_ITEMS slots a
// thread in the compaction's rounds.
__global__ void xk_set_kernel(XkSet set, int64_t cap) {
  unsigned sel = 0u;
#pragma unroll
  for (int r = 0; r < COMPACT_ITEMS; ++r) {
    const int64_t s = compact_round_slot(blockIdx.x, r);
    if (s < cap && set.dirty[s]) sel |= 1u << r;
  }
  while (sel) {
    const int r = __ffs(sel) - 1;
    sel &= sel - 1u;
    const int64_t s = compact_round_slot(blockIdx.x, r);
    uint32_t h1;
    int32_t f1, f2, seen;
    bool claimed = false;
    rw_key_hash(set.g, s, h1, f1, f2);
    rw_find_or_claim(set.g, s, h1, f1, f2, set.fp1, set.fp2, set.stamp, set.mask, 1, set.cap,
                     &seen, &claimed);
  }
}

// Over the n sorted live rows: in_topk by place (the row is among the
// first k of its group, or, with inexact groups, every row; in_topk was
// zeroed, so only the rows in are written), and the straddling runs listed
// in work (work[0] their count, the runs after XK_HEAD words): with exact
// groups, the first row past a group's k-th place when it ties the row
// before it; otherwise the first row of each run of equal key longer than k.
__global__ void xk_mark_kernel(int64_t n, int k, int exact, int gshift,
                               const unsigned long long* key, const int32_t* slot,
                               uint8_t* in_topk, unsigned long long* work, int64_t max_items) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long p = key[i];
  bool in = true, item = false;
  if (exact) {
    const unsigned long long g = xk_group(p, gshift);
    in = i < k || xk_group(key[i - k], gshift) != g;
    if (!in && key[i - 1] == p)  // i - 1 ties i, so shares its group
      item = i - 1 < k || xk_group(key[i - 1 - k], gshift) != g;
  } else {
    item = (i == 0 || key[i - 1] != p) && i + k < n && key[i + k] == p;
  }
  if (in) in_topk[slot[i]] = 1;
  if (item) {
    const unsigned long long at = atomicAdd(work, 1ull);
    if ((int64_t)at < max_items) work[XK_HEAD + at] = (unsigned long long)i;
  }
}

// Row at sorted place q (slot sq) precedes row at r (slot sr) in the full
// order: (order key, store keys, slot); with inexact groups, only a row of
// the same group counts.
__device__ __forceinline__ bool xk_before(const TrKeys& kd, int n_group, int exact, int32_t sq,
                                          int32_t sr) {
  if (!exact)
    for (int g = 0; g < n_group; ++g)
      if (tr_encode(kd.lane[g], kd.dt[g], TR_PLAIN, sq) !=
          tr_encode(kd.lane[g], kd.dt[g], TR_PLAIN, sr))
        return false;
  for (int l = n_group; l < kd.n; ++l) {
    const unsigned long long a = tr_encode(kd.lane[l], kd.dt[l], kd.mode[l], sq);
    const unsigned long long b = tr_encode(kd.lane[l], kd.dt[l], kd.mode[l], sr);
    if (a != b) return a < b;
  }
  return sq < sr;
}

// One warp per listed run: its bounds (ballots over 32 rows at a time).
// A run of at most long_run rows: each row's rank among the run's rows by
// the full order, counted until it reaches the run's share of the k places
// (m); in_topk = rank < m. A longer run goes to the long list (its first
// row, length and m) for rw_group_topk_long, which sorts it: counting
// would cost the warp m times the run's length.
__global__ void xk_resolve_kernel(TrKeys kd, int n_group, int64_t n, int k, int exact,
                                  int64_t long_run, const unsigned long long* key,
                                  const int32_t* slot, unsigned long long* work, int64_t max_items,
                                  int64_t max_long, uint8_t* in_topk) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  int64_t count = (int64_t)work[0];
  if (count > max_items) count = max_items;
  for (int64_t it = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5; it < count;
       it += warps) {
    const int64_t at = (int64_t)work[XK_HEAD + it];
    const unsigned long long p = key[at];
    int64_t ts = at, te = at + 1;
    while (true) {  // back to the run's first row
      const int64_t q = ts - 1 - lane;
      const unsigned b = __ballot_sync(0xFFFFFFFFu, q < 0 || key[q] != p);
      if (b) {
        ts -= __ffs(b) - 1;
        break;
      }
      ts -= 32;
    }
    while (true) {  // on past its last
      const int64_t q = te + lane;
      const unsigned b = __ballot_sync(0xFFFFFFFFu, q >= n || key[q] != p);
      if (b) {
        te += __ffs(b) - 1;
        break;
      }
      te += 32;
    }
    const int64_t m = exact ? at - ts : (int64_t)k;
    if (te - ts > long_run) {
      if (lane == 0) {
        const unsigned long long j = atomicAdd(work + 1, 1ull);
        if ((int64_t)j < max_long) {
          unsigned long long* w = work + XK_HEAD + max_items + 4 * j;
          w[0] = (unsigned long long)ts;
          w[1] = (unsigned long long)(te - ts);
          w[2] = (unsigned long long)m;
        }
      }
      continue;
    }
    for (int64_t r = ts + lane; r < te; r += 32) {
      const int32_t sr = slot[r];
      int64_t below = 0;
      for (int64_t q = ts; q < te && below < m; ++q)
        if (q != r && xk_before(kd, n_group, exact, slot[q], sr)) ++below;
      in_topk[sr] = below < m ? 1 : 0;
    }
  }
}

// One block: each long run's offset among the long runs' rows (its fourth
// word) and their total (work[2]).
__global__ void xk_long_scan_kernel(unsigned long long* work, int64_t max_items,
                                    int64_t max_long) {
  int64_t n_long = (int64_t)work[1];
  if (n_long > max_long) n_long = max_long;
  unsigned long long* runs = work + XK_HEAD + max_items;
  unsigned long long base = 0ull;
  for (int64_t c = 0; c < n_long; c += XK_LONG_THREADS) {
    const int64_t j = c + threadIdx.x;
    const int len = j < n_long ? (int)runs[4 * j + 1] : 0;
    int excl;
    const int total = rw_block_exclusive_scan<XK_LONG_THREADS>(len, &excl);
    if (j < n_long) runs[4 * j + 3] = base + (unsigned long long)excl;
    base += (unsigned long long)total;
  }
  if (threadIdx.x == 0) work[2] = base;
}

// gdirty per slot: an epoch-dirty slot's group is in the set; another
// slot probes the set with its group lanes.
__global__ void xk_gdirty_kernel(XkSet set, int64_t cap, uint8_t* gdirty) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= cap) return;
  gdirty[s] = set.dirty[s] ||
              rw_probe_readonly(set.g, s, set.fp1, set.fp2, set.mask, set.cap) >= 0 ? 1 : 0;
}

// ---- the long runs (rw_group_topk_long) -------------------------------------------
// The rows of the long runs, e = their place among them: their slots, in
// each run's order (slot order: the sort is stable and began in slot order),
// and their run; eidx starts as e. One block per run at a time.
__global__ void xl_fill_kernel(const unsigned long long* runs, int64_t n_long, const int32_t* slot,
                               int32_t* eslot, int32_t* erun, int32_t* eidx) {
  for (int64_t j = blockIdx.x; j < n_long; j += gridDim.x) {
    const int64_t ts = (int64_t)runs[4 * j], len = (int64_t)runs[4 * j + 1];
    const int64_t off = (int64_t)runs[4 * j + 3];
    for (int64_t t = threadIdx.x; t < len; t += blockDim.x) {
      eslot[off + t] = slot[ts + t];
      erun[off + t] = (int32_t)j;
      eidx[off + t] = (int32_t)(off + t);
    }
  }
}

// bits[2l] |= lane l's encoded key of every long-run row, bits[2l + 1] &=
// each, for the lanes from first on.
__global__ void xl_bits_kernel(TrKeys kd, int first, int64_t n, const int32_t* eslot,
                               unsigned long long* bits) {
  for (int l = first; l < kd.n; ++l) {
    unsigned long long o = 0ull, a = ~0ull;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
      const unsigned long long e = tr_encode(kd.lane[l], kd.dt[l], kd.mode[l], eslot[i]);
      o |= e;
      a &= e;
    }
    for (int d = 16; d > 0; d >>= 1) {
      o |= __shfl_xor_sync(0xFFFFFFFFu, o, d);
      a &= __shfl_xor_sync(0xFFFFFFFFu, a, d);
    }
    if ((threadIdx.x & 31) == 0) {
      atomicOr(bits + 2 * l, o);
      atomicAnd(bits + 2 * l + 1, a);
    }
  }
}

// keys[i]: lane's encoded key of the row at place i (run < 0), or its run.
__global__ void xl_key_kernel(const void* lane, int dt, int mode, int64_t n, const int32_t* eslot,
                              const int32_t* erun, const int32_t* eidx, int run,
                              unsigned long long* keys) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t e = eidx[i];
  keys[i] = run ? (unsigned long long)erun[e] : tr_encode(lane, dt, mode, eslot[e]);
}

// The long-run rows sorted by (run, [group lanes,] order key, store keys,
// slot): a row's place in its run is its rank; with exact groups in_topk =
// rank < m, otherwise the row k places before it is of another run or
// group.
__global__ void xl_mark_kernel(TrKeys kd, int n_group, int exact, int k, int64_t n,
                               const unsigned long long* runs, const int32_t* eidx,
                               const int32_t* eslot, const int32_t* erun, uint8_t* in_topk) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t e = eidx[i];
  const int32_t s = eslot[e];
  const int32_t j = erun[e];
  const int64_t off = (int64_t)runs[4 * j + 3];
  bool in;
  if (exact) {
    in = i - off < (int64_t)runs[4 * j + 2];
  } else {
    in = i - k < off;
    if (!in) {
      const int32_t q = eslot[eidx[i - k]];
      for (int g = 0; g < n_group && !in; ++g)
        in = tr_encode(kd.lane[g], kd.dt[g], TR_PLAIN, q) !=
             tr_encode(kd.lane[g], kd.dt[g], TR_PLAIN, s);
    }
  }
  in_topk[s] = in ? 1 : 0;
}

static bool xk_parse(const int64_t* keys, int n_keys, int n_group, TrKeys* kd) {
  if (!tr_parse(keys, n_keys, kd) || n_group < 1 || n_group > XK_MAX_GROUP ||
      n_group + 1 > n_keys)
    return false;
  for (int l = 0; l < n_keys; ++l) {
    const bool order = l == n_group;
    if (order != (kd->mode[l] == TR_ASC || kd->mode[l] == TR_DESC)) return false;
    if (kd->mode[l] == TR_LIVE_LAST) return false;
  }
  return true;
}

// X's first half: the fold of the live rows and the live count, read back.
// keys: n_keys rows of (lane, dtype code, mode) as xk_parse takes them;
// part: compact_tiles(cap) + 1 int32; fold: 2 (n_group + 1) + 1 int64;
// host_out (host memory): n_live, n_dirty, each fold lane's OR, then each
// one's AND. Waits for the stream.
RW_EXPORT int rw_group_topk_fold(const int64_t* keys, int n_keys, int n_group, int64_t cap,
                                 const void* live, const void* epoch_dirty, void* part,
                                 void* fold, int64_t* host_out, void* stream) {
  TrKeys kd;
  if (!xk_parse(keys, n_keys, n_group, &kd) || cap < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_fold = n_group + 1;
  unsigned long long* fd = (unsigned long long*)fold;
  cudaMemsetAsync(fd, 0, sizeof(unsigned long long) * n_fold, st);
  cudaMemsetAsync(fd + n_fold, 0xFF, sizeof(unsigned long long) * n_fold, st);
  cudaMemsetAsync(fd + 2 * n_fold, 0, sizeof(unsigned long long), st);
  const int tiles = compact_tiles(cap);
  xk_fold_kernel<<<tiles, COMPACT_THREADS, 0, st>>>(kd, n_fold, cap, (const uint8_t*)live,
                                                    (const uint8_t*)epoch_dirty, (int32_t*)part,
                                                    fd);
  scan_top_kernel<<<1, SCAN_TOP_THREADS, 0, st>>>((int32_t*)part, tiles);
  int32_t n_live = 0;
  unsigned long long h[2 * XK_FOLD_MAX + 1];
  if (cudaMemcpyAsync(&n_live, (int32_t*)part + tiles, sizeof(int32_t), cudaMemcpyDeviceToHost,
                      st) != cudaSuccess ||
      cudaMemcpyAsync(h, fd, sizeof(unsigned long long) * (2 * n_fold + 1),
                      cudaMemcpyDeviceToHost, st) != cudaSuccess ||
      cudaStreamSynchronize(st) != cudaSuccess)
    return (int)cudaGetLastError();
  host_out[0] = n_live;
  host_out[1] = (int64_t)h[2 * n_fold];
  for (int l = 0; l < 2 * n_fold; ++l) host_out[2 + l] = (int64_t)h[l];
  return (int)cudaGetLastError();
}

// X's second half. plan (top_n_plain._group_topk_mask_cuda, from
// topk_pack_plan): n_live, n_dirty, exact, gshift, pass_mask (bit b: sort
// by byte b), max_items, max_long, long_run, n_fields, then (lane, lo, w,
// pos) per field. set: the dirty groups' set (fp1, fp2, stamp, one key
// lane per group lane; set_cap slots, 0 for none: every slot dirty or
// none). part: the fold's; keys_buf: 2 n_live int64; idx_buf: 2 n_live
// int32; hist: 256 * rbk_tiles(n_live) + 256 int32; work: XK_HEAD +
// max_items + 4 max_long int64. host_out (host memory): the long runs'
// count, their rows, and which half of keys_buf and idx_buf holds the
// sorted rows; rw_group_topk_long ranks those runs when there are any.
// Waits for the stream.
RW_EXPORT int rw_group_topk_mask(const int64_t* keys, int n_keys, int n_group, int64_t cap,
                                 const void* live, const void* epoch_dirty, int k,
                                 const int64_t* plan, const int64_t* set, int64_t set_cap,
                                 void* part, void* keys_buf, void* idx_buf, void* hist, void* work,
                                 void* in_topk, void* gdirty, int64_t* host_out, void* stream) {
  TrKeys kd;
  if (!xk_parse(keys, n_keys, n_group, &kd) || cap < 1 || k < 0) return (int)cudaErrorInvalidValue;
  const int64_t n = plan[0], n_dirty = plan[1], max_items = plan[5], max_long = plan[6];
  const int64_t long_run = plan[7];
  const int exact = (int)plan[2], gshift = (int)plan[3];
  const unsigned pass_mask = (unsigned)plan[4];
  XkPlan xp;
  xp.n = (int)plan[8];
  if (n < 0 || n > cap || n_dirty < 0 || n_dirty > cap || xp.n < 0 || xp.n > n_group + 1 ||
      max_items < 1 || max_long < 1 || long_run < 1)
    return (int)cudaErrorInvalidValue;
  for (int f = 0; f < xp.n; ++f) {
    xp.lane[f] = (int)plan[9 + 4 * f];
    xp.lo[f] = (int)plan[10 + 4 * f];
    xp.w[f] = (int)plan[11 + 4 * f];
    xp.pos[f] = (int)plan[12 + 4 * f];
    if (xp.lane[f] < 0 || xp.lane[f] > n_group || xp.w[f] < 1 || xp.lo[f] < 0 ||
        xp.lo[f] + xp.w[f] > 64 || xp.pos[f] <= -xp.w[f] || xp.pos[f] + xp.w[f] > 64)
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(in_topk, 0, cap, st);
  XkSet xs;
  xs.cap = set_cap;
  xs.dirty = (const uint8_t*)epoch_dirty;
  if (set_cap == 0) {
    if (n_dirty > 0 && n_dirty < cap) return (int)cudaErrorInvalidValue;
  } else {
    if (set_cap & (set_cap - 1) || set_cap < 2 * n_dirty) return (int)cudaErrorInvalidValue;
    xs.g.n = n_group;
    for (int l = 0; l < n_group; ++l) {
      xs.g.in[l] = kd.lane[l];
      xs.g.tab[l] = (void*)set[3 + l];
      xs.g.dt[l] = kd.dt[l];
    }
    xs.fp1 = (int32_t*)set[0];
    xs.fp2 = (int32_t*)set[1];
    xs.stamp = (int32_t*)set[2];
    xs.mask = (uint32_t)(set_cap - 1);
    cudaMemsetAsync(xs.fp1, 0, sizeof(int32_t) * set_cap, st);
    cudaMemsetAsync(xs.stamp, 0, sizeof(int32_t) * set_cap, st);
  }
  const bool rank = n > 0 && k > 0;
  unsigned long long* kb = (unsigned long long*)keys_buf;
  int32_t* ib = (int32_t*)idx_buf;
  unsigned long long* wk = (unsigned long long*)work;
  int cur = 0;
  cudaMemsetAsync(wk, 0, sizeof(unsigned long long) * XK_HEAD, st);
  if (set_cap) xk_set_kernel<<<compact_tiles(cap), COMPACT_THREADS, 0, st>>>(xs, cap);
  if (rank) {
    xk_write_kernel<<<compact_tiles(cap), COMPACT_THREADS, 0, st>>>(
        kd, xp, cap, (const uint8_t*)live, (const int32_t*)part, kb, ib);
    for (int b = 0; b < 8; ++b) {
      if (!((pass_mask >> b) & 1u)) continue;
      rbk_radix_pass(kb + cur * n, ib + cur * n, kb + (1 - cur) * n, ib + (1 - cur) * n, n, 8 * b,
                     (int32_t*)hist, st);
      cur = 1 - cur;
    }
    const unsigned long long* key = kb + cur * n;
    const int32_t* slot = ib + cur * n;
    xk_mark_kernel<<<rw_blocks(n, TR_THREADS), TR_THREADS, 0, st>>>(
        n, k, exact, gshift, key, slot, (uint8_t*)in_topk, wk, max_items);
    int rblocks = rw_blocks(max_items, XK_RESOLVE_THREADS / 32);
    if (rblocks > 1024) rblocks = 1024;
    xk_resolve_kernel<<<rblocks, XK_RESOLVE_THREADS, 0, st>>>(
        kd, n_group, n, k, exact, long_run, key, slot, wk, max_items, max_long,
        (uint8_t*)in_topk);
    xk_long_scan_kernel<<<1, XK_LONG_THREADS, 0, st>>>(wk, max_items, max_long);
  }
  if (set_cap == 0)
    cudaMemsetAsync(gdirty, n_dirty > 0 ? 1 : 0, cap, st);
  else
    xk_gdirty_kernel<<<rw_blocks(cap, TR_THREADS), TR_THREADS, 0, st>>>(xs, cap,
                                                                       (uint8_t*)gdirty);
  unsigned long long h[XK_HEAD];
  if (cudaMemcpyAsync(h, wk, sizeof(h), cudaMemcpyDeviceToHost, st) != cudaSuccess ||
      cudaStreamSynchronize(st) != cudaSuccess)
    return (int)cudaGetLastError();
  host_out[0] = (int64_t)(h[1] < (unsigned long long)max_long ? h[1] : max_long);
  host_out[1] = (int64_t)h[2];
  host_out[2] = cur;
  return (int)cudaGetLastError();
}

// X's long runs, after rw_group_topk_mask listed n_long of them in work
// (n_rows rows in all): their rows sorted by (run, [group lanes with
// inexact groups,] order key, store keys, slot), an LSD radix sort of the
// long-run rows alone, least significant lane first from the runs' slot
// order; then each row's in_topk by its place in its run. slot: the mask's
// sorted slots (its half of idx_buf); keys_buf: 2 n_rows int64; idx_buf,
// 2 n_rows int32; eslot, erun: n_rows int32; hist: 256 *
// rbk_tiles(n_rows) + 256 int32; bits: 2 n_keys int64. Waits for the
// stream once (the fold of the rows' lanes).
RW_EXPORT int rw_group_topk_long(const int64_t* keys, int n_keys, int n_group, int exact, int k,
                                 const void* slot, const void* work, int64_t max_items,
                                 int64_t n_long, int64_t n_rows, void* keys_buf, void* idx_buf,
                                 void* eslot, void* erun, void* hist, void* bits, void* in_topk,
                                 void* stream) {
  TrKeys kd;
  if (!xk_parse(keys, n_keys, n_group, &kd) || k < 1 || n_long < 1 || n_rows < 1 ||
      max_items < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned long long* runs = (const unsigned long long*)work + XK_HEAD + max_items;
  unsigned long long* kb = (unsigned long long*)keys_buf;
  int32_t* ib = (int32_t*)idx_buf;
  int32_t* es = (int32_t*)eslot;
  int32_t* er = (int32_t*)erun;
  unsigned long long* bt = (unsigned long long*)bits;
  const int64_t n = n_rows;
  const int blocks = rw_blocks(n, TR_THREADS);
  xl_fill_kernel<<<n_long < 1024 ? (int)n_long : 1024, XK_LONG_THREADS, 0, st>>>(
      runs, n_long, (const int32_t*)slot, es, er, ib);
  const int first = exact ? n_group : 0;
  tr_bits_init_kernel<<<1, 32, 0, st>>>(kd.n, bt);
  xl_bits_kernel<<<blocks < TR_BITS_BLOCKS ? blocks : TR_BITS_BLOCKS, TR_THREADS, 0, st>>>(
      kd, first, n, es, bt);
  unsigned long long h[2 * TR_MAX_KEYS];
  if (cudaMemcpyAsync(h, bt, sizeof(unsigned long long) * 2 * kd.n, cudaMemcpyDeviceToHost,
                      st) != cudaSuccess ||
      cudaStreamSynchronize(st) != cudaSuccess)
    return (int)cudaGetLastError();
  int cur = 0;
  // each varying lane, least significant first, then the run (most
  // significant: bytes up to n_long - 1's highest)
  for (int l = kd.n - 1; l >= first - 1; --l) {
    const bool run = l < first;
    const unsigned long long varying =
        run ? (unsigned long long)(n_long - 1) : h[2 * l] ^ h[2 * l + 1];
    if (varying == 0ull) continue;
    xl_key_kernel<<<blocks, TR_THREADS, 0, st>>>(run ? nullptr : kd.lane[l], run ? 0 : kd.dt[l],
                                                run ? 0 : kd.mode[l], n, es, er, ib + cur * n,
                                                run ? 1 : 0, kb + cur * n);
    for (int b = 0; b < 8; ++b) {
      if (!run && ((varying >> (8 * b)) & 0xFFull) == 0ull) continue;
      if (run && (varying >> (8 * b)) == 0ull) break;
      rbk_radix_pass(kb + cur * n, ib + cur * n, kb + (1 - cur) * n, ib + (1 - cur) * n, n,
                     8 * b, (int32_t*)hist, st);
      cur = 1 - cur;
    }
  }
  xl_mark_kernel<<<blocks, TR_THREADS, 0, st>>>(kd, n_group, exact, k, n, runs, ib + cur * n, es,
                                               er, (uint8_t*)in_topk);
  return (int)cudaGetLastError();
}
