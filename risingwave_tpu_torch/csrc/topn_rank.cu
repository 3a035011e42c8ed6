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
// What bounds them on the card: bytes. W reads the live and order lanes
// of every slot a few times and the pk lanes of its candidates alone; X
// reads the live, epoch-dirty, group and order lanes of every slot twice,
// sorts 12-byte pairs of the live rows only, and writes two bool lanes.
//
// W's design: select the first n rows, do not sort the store. A row's
// class is its liveness (live rows first); the first n rows are the first
// min(n, live) live rows, then, past the live count, the first dead rows
// by their stale lanes. Only the class that the n-th row falls in is
// selected; a class the n rows hold whole is taken whole.
//   1. rw_rank_fold, one coalesced pass over live and the order lane: the
//      live count and the order key's OR, AND, MIN, MAX per class, read by
//      the host (top_n_plain.rank_select_plan): the selected class's field
//      is (key - MIN) >> lo, exact (lo its lowest varying bit), as wide as
//      MAX - MIN needs, cut into rounds of at most 11 bits from the top;
//   2. rw_rank_select: per round, one pass counts the digits of the rows
//      whose field agrees with the prefix found so far (shared counts,
//      one atomic per warp and digit), and one block finds the digit
//      holding the m-th row, on the card (no host read between rounds);
//      the last round leaves the n-th row's field t. Then one pass
//      compacts the candidates (rows of a class taken whole, rows of the
//      selected class with field <= t: those ahead of the n-th row and the
//      whole tie run at it) in slot order, placed by a decoupled look-back,
//      and folds every key lane over them (the pk lanes read for the
//      candidates alone); the host reads their count and the fold and
//      plans one packed key (over_window.window_pack_plan: class, order
//      key, pk lanes; exact, more 64-bit words past 64 bits);
//   3. rw_rank_top: each candidate's packed key, csrc/onesweep.cuh's
//      single-sweep passes over its varying bytes (stable, so ties keep
//      slot order: the reference's order), the first n out with their
//      liveness.
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
#include "onesweep.cuh"
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

// ---- kernel W -----------------------------------------------------------------------
// Key lanes of a W call: live (LIVE_LAST), the order lane (ASC/DESC), the
// pk lanes (PLAIN). A row's class is its liveness: the live rows come
// first, then the dead ones, each by (order key, pk lanes, slot).
#define TR_SEL_BITS 11  // digit bits of a select round; = top_n_plain.SELECT_BITS
#define TR_SEL_BINS (1 << TR_SEL_BITS)
#define TR_PICK_THREADS (TR_SEL_BINS / 2)
#define TR_MAX_ROUNDS 6  // ceil(64 / TR_SEL_BITS)
#define TR_FOLD_WORDS 9  // the live count; OR, AND, MIN, MAX of the order key: live, dead

// What the select takes (top_n_plain.RankSelect): the class whose first m
// rows are selected (cls: 1 live, 0 dead, -1 none), the classes taken
// whole, the selected class's field (encoded order key - min) >> lo and
// its rounds of digits, from the top: (field >> shift) & (2^bits - 1).
struct TrSelect {
  int cls, take_live, take_dead, lo, n_rounds;
  int64_t m;
  unsigned long long min;
  int shift[TR_MAX_ROUNDS], bits[TR_MAX_ROUNDS];
};

// One field of the candidates' packed key (over_window.window_pack_plan):
// bits of (encoded key - min) >> lo, width wide, lowest bit at bit g0 of
// the whole key (64 * words bits, word 0 most significant).
struct TrField {
  int lane, lo, width, g0;
  unsigned long long min;
};

struct TrPlan {
  TrField f[TR_MAX_KEYS];
  unsigned mask[TR_MAX_KEYS];  // per word: bit b where byte b may vary
  int n, words;
};

__device__ __forceinline__ unsigned long long tr_order(const TrKeys& kd, int64_t s) {
  return tr_encode(kd.lane[1], kd.dt[1], kd.mode[1], s);
}

// A fold (OR, AND, MIN, MAX) takes in another one, or one key (g = e, e, e, e)
__device__ __forceinline__ void tr_fold_merge(unsigned long long (&f)[4],
                                              const unsigned long long* g) {
  f[0] |= g[0];
  f[1] &= g[1];
  f[2] = g[2] < f[2] ? g[2] : f[2];
  f[3] = g[3] > f[3] ? g[3] : f[3];
}

__device__ __forceinline__ void tr_fold_in(unsigned long long (&f)[4], unsigned long long e) {
  const unsigned long long g[4] = {e, e, e, e};
  tr_fold_merge(f, g);
}

__device__ __forceinline__ void tr_fold_warp(unsigned long long (&f)[4]) {
  for (int x = 16; x > 0; x >>= 1) {
    unsigned long long g[4];
    for (int j = 0; j < 4; ++j) g[j] = __shfl_xor_sync(0xFFFFFFFFu, f[j], x);
    tr_fold_merge(f, g);
  }
}

__device__ __forceinline__ void tr_fold_atomic(unsigned long long* to,
                                               const unsigned long long (&f)[4]) {
  atomicOr(to, f[0]);
  atomicAnd(to + 1, f[1]);
  atomicMin(to + 2, f[2]);
  atomicMax(to + 3, f[3]);
}

// n words of 4 at `fold`: OR 0, AND, MIN all ones, MAX 0; sel[0] (the
// selected prefix) 0, sel[1] (rows still to take at it) m; n_zero words
// at zero and n_hist at hist 0 (one launch in place of the memsets)
__global__ void tr_rank_init_kernel(unsigned long long* fold, int n, unsigned long long* sel,
                                    int64_t m, unsigned long long* zero, int64_t n_zero,
                                    uint32_t* hist, int n_hist) {
  const int l = threadIdx.x;
  if (l < n) {
    fold[4 * l] = 0ull;
    fold[4 * l + 1] = ~0ull;
    fold[4 * l + 2] = ~0ull;
    fold[4 * l + 3] = 0ull;
  }
  if (l == 0 && sel != nullptr) {
    sel[0] = 0ull;
    sel[1] = (unsigned long long)m;
  }
  for (int64_t i = l; i < n_zero; i += blockDim.x) zero[i] = 0ull;
  for (int i = l; i < n_hist; i += blockDim.x) hist[i] = 0u;
}

// One coalesced pass in compact.cuh's tiles: the live count into fold[0],
// the order key's OR, AND, MIN, MAX over the live rows into fold[1..4]
// and over the dead rows into fold[5..8].
__global__ void __launch_bounds__(COMPACT_THREADS)
    tr_rank_fold_kernel(TrKeys kd, int64_t cap, unsigned long long* fold) {
  __shared__ unsigned long long s_f[COMPACT_THREADS / 32][8];
  __shared__ int s_n[COMPACT_THREADS / 32];
  const uint8_t* live = (const uint8_t*)kd.lane[0];
  unsigned long long lf[4] = {0ull, ~0ull, ~0ull, 0ull};
  unsigned long long df[4] = {0ull, ~0ull, ~0ull, 0ull};
  int n_live = 0;
#pragma unroll
  for (int r = 0; r < COMPACT_ITEMS; ++r) {
    const int64_t s = compact_round_slot(blockIdx.x, r);
    if (s >= cap) continue;
    const unsigned long long e = tr_order(kd, s);
    if (live[s]) {
      tr_fold_in(lf, e);
      ++n_live;
    } else {
      tr_fold_in(df, e);
    }
  }
  tr_fold_warp(lf);
  tr_fold_warp(df);
  n_live = __reduce_add_sync(0xFFFFFFFFu, n_live);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    for (int j = 0; j < 4; ++j) {
      s_f[warp][j] = lf[j];
      s_f[warp][4 + j] = df[j];
    }
    s_n[warp] = n_live;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  int tile_live = 0;
  for (int w = 0; w < COMPACT_THREADS / 32; ++w) {
    tr_fold_merge(lf, s_f[w]);
    tr_fold_merge(df, s_f[w] + 4);
    tile_live += s_n[w];
  }
  const int64_t left = cap - (int64_t)blockIdx.x * COMPACT_TILE;
  const int tile_slots = left < COMPACT_TILE ? (int)left : COMPACT_TILE;
  if (tile_live) {
    atomicAdd(fold, (unsigned long long)tile_live);
    tr_fold_atomic(fold + 1, lf);
  }
  if (tile_slots > tile_live) tr_fold_atomic(fold + 5, df);
}

// One round of the select over the rows of class sp.cls whose field
// agrees with the prefix found so far (sel[0]) above this round's digit:
// the counts of their digits, aggregated per warp, into hist.
__global__ void __launch_bounds__(COMPACT_THREADS)
    tr_round_kernel(TrKeys kd, TrSelect sp, int r, int64_t cap, const unsigned long long* sel,
                    uint32_t* hist) {
  __shared__ uint32_t h[TR_SEL_BINS];
  const int shift = sp.shift[r], hi = shift + sp.bits[r];
  const unsigned bins = 1u << sp.bits[r];
  for (unsigned i = threadIdx.x; i < bins; i += COMPACT_THREADS) h[i] = 0u;
  __syncthreads();
  const unsigned long long want = sel[0];
  const uint8_t* live = (const uint8_t*)kd.lane[0];
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
#pragma unroll 4
  for (int j = 0; j < COMPACT_ITEMS; ++j) {
    const int64_t s = compact_round_slot(blockIdx.x, j);
    unsigned d = 0xFFFFFFFFu;
    if (s < cap && (live[s] != 0) == (sp.cls == 1)) {
      const unsigned long long f = (tr_order(kd, s) - sp.min) >> sp.lo;
      if (hi >= 64 || (f >> hi) == want) d = (unsigned)(f >> shift) & (bins - 1u);
    }
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    if (d != 0xFFFFFFFFu && (peers & below) == 0u) atomicAdd(&h[d], (uint32_t)__popc(peers));
  }
  __syncthreads();
  for (unsigned i = threadIdx.x; i < bins; i += COMPACT_THREADS)
    if (h[i]) atomicAdd(hist + i, h[i]);
}

// One block: the digit holding the sel[1]-th row of this round's counts;
// the prefix takes it, sel[1] becomes that row's place among the digit's
// rows. The counts are zeroed for the next round.
__global__ void __launch_bounds__(TR_PICK_THREADS)
    tr_pick_kernel(int bits, unsigned long long* sel, uint32_t* hist) {
  const unsigned bins = 1u << bits, b0 = 2u * threadIdx.x, b1 = b0 + 1u;
  const long long c0 = b0 < bins ? hist[b0] : 0u, c1 = b1 < bins ? hist[b1] : 0u;
  const long long m = (long long)sel[1];
  int excl;
  rw_block_exclusive_scan<TR_PICK_THREADS>((int)(c0 + c1), &excl);  // every m read first
  const long long x = excl;
  if (x < m && m <= x + c0) {
    sel[0] = (sel[0] << bits) | b0;
    sel[1] = (unsigned long long)(m - x);
  } else if (x + c0 < m && m <= x + c0 + c1) {
    sel[0] = (sel[0] << bits) | b1;
    sel[1] = (unsigned long long)(m - x - c0);
  }
  if (b0 < bins) hist[b0] = 0u;
  if (b1 < bins) hist[b1] = 0u;
}

// Is slot s a candidate: of a class taken whole, or of the selected class
// with a field at most the n-th row's (t)?
__device__ __forceinline__ bool tr_candidate(const TrKeys& kd, const TrSelect& sp,
                                             unsigned long long t, int64_t s) {
  const bool lv = ((const uint8_t*)kd.lane[0])[s] != 0;
  if (lv ? sp.take_live : sp.take_dead) return true;
  if (sp.cls != (lv ? 1 : 0)) return false;
  return ((tr_order(kd, s) - sp.min) >> sp.lo) <= t;
}

// bit j set where the thread's slot of round j of the tile
// (compact_round_slot) is a candidate
__device__ __forceinline__ unsigned tr_cand_rounds(const TrKeys& kd, const TrSelect& sp,
                                                   unsigned long long t, int64_t cap,
                                                   int64_t tile) {
  unsigned sel = 0u;
#pragma unroll
  for (int j = 0; j < COMPACT_ITEMS; ++j) {
    const int64_t s = compact_round_slot(tile, j);
    if (s < cap && tr_candidate(kd, sp, t, s)) sel |= 1u << j;
  }
  return sel;
}

// The candidates compacted in one pass: each tile (from the counter
// status[tiles]) counts its candidates, places them after those of every
// earlier tile by a decoupled look-back (common.cuh rw_lookback), writes
// their slots into ent in slot order (compact.cuh's coalesced
// compact_warp_place) and folds every key lane's OR, AND, MIN, MAX over
// them into fold[4l .. 4l + 3] (the pk lanes are read for the candidates
// alone); the last tile writes their count into status[tiles + 1].
__global__ void __launch_bounds__(COMPACT_THREADS)
    tr_cand_kernel(TrKeys kd, TrSelect sp, int64_t cap, const unsigned long long* sel,
                   unsigned long long* status, unsigned tiles, int32_t* __restrict__ ent,
                   unsigned long long* fold) {
  __shared__ unsigned long long s_fold[COMPACT_THREADS / 32][4];
  __shared__ unsigned s_tile;
  __shared__ uint32_t s_off;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd((unsigned*)(status + tiles), 1u);
  __syncthreads();
  const unsigned tile = s_tile;
  const unsigned on = tr_cand_rounds(kd, sp, sel[0], cap, tile);
  int excl;
  const int count = rw_block_exclusive_scan<COMPACT_THREADS>(__popc(on), &excl);
  if (threadIdx.x < 32) {
    uint32_t before, unused;
    rw_lookback(status, tile, (uint32_t)count, 0u, &before, &unused);
    if (threadIdx.x == 0) {
      s_off = before;
      if (tile == tiles - 1) status[tiles + 1] = (unsigned long long)before + count;
    }
  }
  __syncthreads();
  if (count == 0) return;
  int64_t place = compact_warp_place(on, s_off);
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < COMPACT_ITEMS; ++j) {
    const unsigned b = __ballot_sync(0xFFFFFFFFu, (on >> j) & 1u);
    if ((on >> j) & 1u) ent[place + __popc(b & below)] = (int32_t)compact_round_slot(tile, j);
    place += __popc(b);
  }
  for (int l = 0; l < kd.n; ++l) {
    unsigned long long f[4] = {0ull, ~0ull, ~0ull, 0ull};
    for (unsigned b = on; b; b &= b - 1u)
      tr_fold_in(f, tr_encode(kd.lane[l], kd.dt[l], kd.mode[l],
                              compact_round_slot(tile, __ffs(b) - 1)));
    tr_fold_warp(f);
    if (lane == 0)
      for (int j = 0; j < 4; ++j) s_fold[warp][j] = f[j];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < COMPACT_THREADS / 32; ++w) tr_fold_merge(f, s_fold[w]);
      tr_fold_atomic(fold + 4 * l, f);
    }
    __syncthreads();
  }
}

// Word w (0: most significant) of slot s's packed key.
__device__ __forceinline__ unsigned long long tr_pack_word(const TrKeys& kd, const TrPlan& p,
                                                           int64_t s, int w) {
  const int wl = p.words - 1 - w;  // the word's place from the least significant end
  unsigned long long out = 0ull;
  for (int f = 0; f < p.n; ++f) {
    const TrField& F = p.f[f];
    const int at = F.g0 >> 6, sh = F.g0 & 63;
    const bool here = at == wl;
    const bool spill = at + 1 == wl && sh != 0 && sh + F.width > 64;
    if (!here && !spill) continue;
    const unsigned long long v =
        (tr_encode(kd.lane[F.lane], kd.dt[F.lane], kd.mode[F.lane], s) - F.min) >> F.lo;
    out |= here ? v << sh : v >> (64 - sh);
  }
  return out;
}

// Each candidate's packed words (word w at words[w * m + i]), candidate i
// at slot ent[i].
__global__ void tr_pack_kernel(TrKeys kd, TrPlan p, int64_t m, const int32_t* __restrict__ ent,
                               unsigned long long* __restrict__ words) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int64_t s = ent[i];
  for (int w = 0; w < p.words; ++w) words[w * m + i] = tr_pack_word(kd, p, s, w);
}

// The first n_top sorted candidates: slot (the sorted payload, or, past
// one word, the candidate at that place) and liveness.
__global__ void tr_top_kernel(int64_t n_top, const int32_t* pay, const int32_t* ent, int via_ent,
                              const uint8_t* live, int32_t* out_idx, uint8_t* out_alive) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_top) return;
  const int32_t p = pay != nullptr ? pay[i] : (int32_t)i;
  const int32_t s = via_ent ? ent[p] : p;
  out_idx[i] = s;
  out_alive[i] = live[s];
}

static bool tr_rank_parse(const int64_t* keys, int n_keys, TrKeys* kd) {
  if (!tr_parse(keys, n_keys, kd) || n_keys < 2 || kd->mode[0] != TR_LIVE_LAST ||
      (kd->mode[1] != TR_ASC && kd->mode[1] != TR_DESC))
    return false;
  for (int l = 2; l < n_keys; ++l)
    if (kd->mode[l] != TR_PLAIN) return false;
  return true;
}

// RankSelect.rows(): cls, take_live, take_dead, m, min, lo, n_rounds,
// then (shift, bits) per round, the top digit first
static bool tr_select_rows(const int64_t* r, int64_t cap, TrSelect* sp) {
  sp->cls = (int)r[0];
  sp->take_live = (int)r[1];
  sp->take_dead = (int)r[2];
  sp->m = r[3];
  sp->min = (unsigned long long)r[4];
  sp->lo = (int)r[5];
  sp->n_rounds = (int)r[6];
  if (sp->cls < -1 || sp->cls > 1 || (sp->cls >= 0 && (sp->m < 1 || sp->m > cap)) ||
      sp->lo < 0 || sp->lo > 63 || sp->n_rounds < 0 || sp->n_rounds > TR_MAX_ROUNDS ||
      (sp->cls < 0 && sp->n_rounds > 0))
    return false;
  int top = 64;
  for (int i = 0; i < sp->n_rounds; ++i) {
    sp->shift[i] = (int)r[7 + 2 * i];
    sp->bits[i] = (int)r[8 + 2 * i];
    if (sp->bits[i] < 1 || sp->bits[i] > TR_SEL_BITS || sp->shift[i] < 0 ||
        sp->shift[i] + sp->bits[i] > top)
      return false;
    top = sp->shift[i];
  }
  return sp->n_rounds == 0 || top == 0;  // the last round takes the field's lowest bits
}

// WindowPlan.rows(): n fields, words, each word's pass mask, then (lane,
// lo, width, g0, min) per field
static bool tr_plan_rows(const int64_t* rows, int n_keys, TrPlan* p) {
  p->n = (int)rows[0];
  p->words = (int)rows[1];
  if (p->n < 0 || p->n > n_keys || p->words < 0 || p->words > TR_MAX_KEYS) return false;
  for (int w = 0; w < p->words; ++w) p->mask[w] = (unsigned)rows[2 + w];
  const int64_t* f = rows + 2 + p->words;
  for (int i = 0; i < p->n; ++i) {
    TrField& F = p->f[i];
    F.lane = (int)f[5 * i];
    F.lo = (int)f[5 * i + 1];
    F.width = (int)f[5 * i + 2];
    F.g0 = (int)f[5 * i + 3];
    F.min = (unsigned long long)f[5 * i + 4];
    if (F.lane < 0 || F.lane >= n_keys || F.width < 1 || F.width > 64 || F.lo < 0 ||
        F.lo > 63 || F.g0 < 0 || F.g0 + F.width > 64 * p->words)
      return false;
  }
  return true;
}

// W's first part: the fold, read back (waits for the stream). keys: n_keys
// rows of (lane, dtype code, mode): live (LIVE_LAST), the order lane
// (ASC/DESC), the pk lanes (PLAIN). fold: TR_FOLD_WORDS int64 scratch;
// host_out (host memory): the live count, then the order key's OR, AND,
// MIN, MAX over the live rows and over the dead rows.
RW_EXPORT int rw_rank_fold(const int64_t* keys, int n_keys, int64_t cap, void* fold,
                           int64_t* host_out, void* stream) {
  TrKeys kd;
  if (!tr_rank_parse(keys, n_keys, &kd) || cap < 1 || cap > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* fd = (unsigned long long*)fold;
  tr_rank_init_kernel<<<1, 32, 0, st>>>(fd + 1, 2, nullptr, 0, fd, 1, nullptr, 0);
  tr_rank_fold_kernel<<<compact_tiles(cap), COMPACT_THREADS, 0, st>>>(kd, cap, fd);
  unsigned long long h[TR_FOLD_WORDS];
  if (cudaMemcpyAsync(h, fd, sizeof(h), cudaMemcpyDeviceToHost, st) != cudaSuccess ||
      cudaStreamSynchronize(st) != cudaSuccess)
    return (int)cudaGetLastError();
  for (int i = 0; i < TR_FOLD_WORDS; ++i) host_out[i] = (int64_t)h[i];
  return (int)cudaGetLastError();
}

// W's second part: the select's rounds, then the candidates compacted
// and every key lane folded over them, read back (waits for the stream).
// select: RankSelect.rows(); sel: 2 int64 (the prefix found and the rows
// still to take at it); hist: TR_SEL_BINS int32; status:
// compact_tiles(cap) + 2 int64 (zeroed here); ent: cap int32, the
// candidates' slots in slot order; fold: 4 n_keys int64. host_out (host
// memory): the candidates' count, then each lane's OR, AND, MIN, MAX over
// them.
RW_EXPORT int rw_rank_select(const int64_t* keys, int n_keys, int64_t cap, const int64_t* select,
                             void* sel, void* hist, void* status, void* ent, void* fold,
                             int64_t* host_out, void* stream) {
  TrKeys kd;
  TrSelect sp;
  if (!tr_rank_parse(keys, n_keys, &kd) || cap < 1 || cap > INT32_MAX ||
      !tr_select_rows(select, cap, &sp))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* sd = (unsigned long long*)sel;
  unsigned long long* fd = (unsigned long long*)fold;
  unsigned long long* sw = (unsigned long long*)status;
  const unsigned tiles = (unsigned)compact_tiles(cap);
  tr_rank_init_kernel<<<1, 1024, 0, st>>>(fd, n_keys, sd, sp.m, sw, (int64_t)tiles + 2,
                                          (uint32_t*)hist, sp.n_rounds > 0 ? TR_SEL_BINS : 0);
  for (int r = 0; r < sp.n_rounds; ++r) {
    tr_round_kernel<<<tiles, COMPACT_THREADS, 0, st>>>(kd, sp, r, cap, sd, (uint32_t*)hist);
    tr_pick_kernel<<<1, TR_PICK_THREADS, 0, st>>>(sp.bits[r], sd, (uint32_t*)hist);
  }
  tr_cand_kernel<<<tiles, COMPACT_THREADS, 0, st>>>(kd, sp, cap, sd, sw, tiles, (int32_t*)ent,
                                                    fd);
  unsigned long long h[1 + 4 * TR_MAX_KEYS];
  if (cudaMemcpyAsync(h, sw + tiles + 1, sizeof(unsigned long long), cudaMemcpyDeviceToHost,
                      st) != cudaSuccess ||
      cudaMemcpyAsync(h + 1, fd, sizeof(unsigned long long) * 4 * n_keys, cudaMemcpyDeviceToHost,
                      st) != cudaSuccess ||
      cudaStreamSynchronize(st) != cudaSuccess)
    return (int)cudaGetLastError();
  for (int i = 0; i < 1 + 4 * n_keys; ++i) host_out[i] = (int64_t)h[i];
  return (int)cudaGetLastError();
}

// W's last part: each candidate's packed key (top_n_plain: window_pack_plan
// of the candidates' fold), the candidates sorted by it (csrc/onesweep.cuh;
// they were compacted in slot order, so ties keep slot order), the first
// n_top out with their liveness. ent: rw_rank_select's, n_cand candidates;
// bufs (int64 row): words (max(words, 1) * n_cand int64), pa, pb (n_cand
// int32), ka, kb (n_cand int64), digit counts (8 * 256 int32), look-back
// words (os_tiles(n_cand) * 256 + 1 int32).
RW_EXPORT int rw_rank_top(const int64_t* keys, int n_keys, int64_t cap, const int64_t* plan,
                          const void* ent, int64_t n_cand, const int64_t* bufs, int64_t n_top,
                          void* out_idx, void* out_alive, void* stream) {
  TrKeys kd;
  TrPlan p;
  if (!tr_rank_parse(keys, n_keys, &kd) || cap < 1 || cap > INT32_MAX ||
      !tr_plan_rows(plan, n_keys, &p) || n_top < 1 || n_top > n_cand ||
      n_cand > cap)  // fewer candidates than n_top: a select gone wrong
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* words = (unsigned long long*)bufs[0];
  const OsScratch s{(unsigned long long*)bufs[3], (unsigned long long*)bufs[4], (int32_t*)bufs[1],
                    (int32_t*)bufs[2], (uint32_t*)bufs[5], (uint32_t*)bufs[6]};
  if (p.words > 0)
    tr_pack_kernel<<<rw_blocks(n_cand, TR_THREADS), TR_THREADS, 0, st>>>(kd, p, n_cand,
                                                                         (const int32_t*)ent,
                                                                         words);
  const unsigned long long* key;
  const int32_t* pay;
  os_sort_words(p.mask, p.words, n_cand, n_cand, words, (const int32_t*)ent, s, &key, &pay, st);
  tr_top_kernel<<<rw_blocks(n_top, TR_THREADS), TR_THREADS, 0, st>>>(
      n_top, pay, (const int32_t*)ent, p.words > 1 ? 1 : 0, (const uint8_t*)kd.lane[0],
      (int32_t*)out_idx, (uint8_t*)out_alive);
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
