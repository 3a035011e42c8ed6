// Kernel F: pre-reduce an epoch's rows by group key.
//
// Replaces risingwave_tpu/ops/agg.py:reduce_by_key (:334), with K1
// (ops/hashing.py:hash128, :94) computed inside, as kernel A does.
//
// What it computes, exactly as the reference: the fingerprint pair
// (h1, h2) of each row's key (0xFFFFFFFF for both on invisible rows,
// sign == 0), a STABLE sort of the rows by (h1, h2) (lax.sort is
// stable, so ties keep row order), the key lanes gathered in that order,
// a segment boundary wherever the fingerprint, the visibility or any
// exact key lane changes (NaN equals NaN), and per segment the sum of
// the signs (w) and the per-call lanes (count, sum + non-null count,
// append-only min/max + its count), each broadcast to every row of its
// segment. rep_valid marks each visible segment's first row; the
// minmax latch records a retraction reaching a MIN/MAX call.
//
// What bounds it on the card: bytes. The sort moves a 12-byte
// (key, row) pair per row per pass; the reduce reads the key, sign and
// value lanes once more (at random, through the sort's permutation) and
// writes the sorted key lanes and the reduced lanes.
//
// Design, in launches on one stream:
//  0. one memset zeroes the digit counts and every look-back word;
//  1. hash + histogram: each row's fingerprints packed as
//     h1 << 32 | h2, written once with its payload (the row index, its
//     sign in the top two bits), and the digits of all eight bytes
//     counted in the same read of the key lanes and signs;
//  2. eight single-sweep radix passes (csrc/onesweep.cuh), one launch a
//     byte (every byte of a fingerprint varies): the sign rides with the
//     row, so the reduce reads no sign at random;
//  3. reduce: tiles of 2048 sorted rows, each tile's index from an
//     atomic counter. A tile reads its keys and payloads once,
//     gathers its key lanes, writes the sorted key lanes, flags
//     its boundaries (its predecessor and successor rows read directly,
//     so no tile waits for that), and per lane folds its segments with a
//     segmented scan (per thread, then across warps by shuffles). A
//     segment inside the tile is written to its rows at once. The
//     segment still open at the tile's end publishes its fold; a tile
//     whose first row continues a segment finds the fold of that
//     segment's earlier rows by a decoupled look-back and writes the
//     segment's rows in it once it ends there;
//  4. fix-up: the rows of a segment's earlier tiles get the total that
//     the tile where it ends wrote (only tiles whose last segment runs
//     past them do any work).
//
// The same input gives the same bits every run, float sums included:
// within a tile the association is fixed by the code; across tiles the
// look-back does not add folds in the order they arrive. It finds the
// nearest tile that published its inclusive fold and folds forward from
// it over the later tiles' own folds, left to right. That inclusive fold
// was made the same way, so by induction every carry equals the strict
// left fold ((f(s) + f(s+1)) + ...) over the tiles from the segment's
// first one, whichever tiles had published when the look-back ran. No
// tile waits for a chain: a tile with a boundary publishes its
// inclusive fold at once.
#include "hashing.cuh"
#include "onesweep.cuh"

#define RBK_MAX_KEYS 8
#define RBK_MAX_LANES 20
#define RBK_THREADS OS_THREADS
#define RBK_ITEMS 8
#define RBK_TILE OS_TILE  // rows per reduce tile, as a sort tile (_kernels.OS_TILE sizes both)
static_assert(RBK_THREADS * RBK_ITEMS == RBK_TILE, "a reduce thread holds RBK_ITEMS rows");
// a tile's rows in shared memory, one 8-byte pad after every thread's 8
// rows, so 64-bit reads by thread (t * 8 + j) meet no bank twice
#define RBK_STAGE (RBK_TILE + RBK_TILE / RBK_ITEMS)
#define RBK_AT(r) ((r) + ((r) >> 3))
// a row's payload through the sort: its index, and its sign in the top
// two bits (0, 1, 2: sign 0, +1, -1; 3: another sign, read from the lane)
#define RBK_ROW 0x3FFFFFFFu
// a reduce tile's published word
#define RBK_AGG 1u  // the fold of its last segment's rows in it
#define RBK_INC 2u  // ... from the segment's first row

// what a row contributes to a reduced lane (ops/agg.py _SRC_*)
enum RbkSrc : int { SRC_SIGN = 0, SRC_WN = 1, SRC_SUM = 2, SRC_EXT = 3, SRC_USE = 4 };
// how a segment's rows combine, and the output type (ops/agg.py _OP_*)
enum RbkOp : int {
  OP_SUM_I64 = 0, OP_SUM_F32 = 1, OP_SUM_F64 = 2, OP_MIN_I64 = 3, OP_MAX_I64 = 4,
  OP_MIN_I32 = 5, OP_MAX_I32 = 6,
};

struct RbkKeys {
  const void* in[RBK_MAX_KEYS];  // (n,) key lanes
  void* out[RBK_MAX_KEYS];       // (n,) sorted key lanes, same dtypes
  int dt[RBK_MAX_KEYS];
  int n;
};

struct RbkLanes {
  int src[RBK_MAX_LANES];
  int op[RBK_MAX_LANES];
  const void* val[RBK_MAX_LANES];    // (n,) input value lane or null
  int vdt[RBK_MAX_LANES];
  const uint8_t* nul[RBK_MAX_LANES]; // (n,) input null lane or null
  void* out[RBK_MAX_LANES];          // (n,) reduced lane
  long long sentinel[RBK_MAX_LANES]; // value of a row that does not count (SRC_EXT)
  int n;
};

// The reduce tiles' records (scratch; flag and counter zeroed).
struct RbkTiles {
  uint32_t* flag;     // (tiles,) 0, RBK_AGG or RBK_INC
  uint32_t* counter;  // the next tile index
  int32_t* start;     // (tiles,) with RBK_INC: the tile the open segment starts in
  long long* agg;     // (tiles, lanes) the open segment's fold over the tile's rows
  long long* inc;     // (tiles, lanes) ... over its rows up to the tile's end
  long long* tot;     // (tiles, lanes) a segment's total, by the tile it starts in
  int32_t* fix_lo;    // (tiles,) first row of a segment that runs past the tile, or -1
  int32_t* fix_from;  // (tiles,) the tile that segment starts in
};

// -- 1. hash + histogram ---------------------------------------------------------
static __global__ void rbk_hash_hist_kernel(RbkKeys keys, int64_t n, const int32_t* signs,
                                            const long long* fp1, const long long* fp2,
                                            unsigned long long* key64, int32_t* pay,
                                            uint32_t* hist, uint8_t* minmax_ret) {
  __shared__ uint32_t h[OS_HIST_COPIES][8 * OS_RADIX];
  for (int i = threadIdx.x; i < OS_HIST_COPIES * 8 * OS_RADIX; i += blockDim.x) (&h[0][0])[i] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) *minmax_ret = 0;
  __syncthreads();
  uint32_t* mine = h[(threadIdx.x >> 5) & (OS_HIST_COPIES - 1)];
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint32_t h1, h2;
    if (fp1 != nullptr) {
      h1 = (uint32_t)fp1[i];
      h2 = (uint32_t)fp2[i];
    } else {
      h1 = RW_HASH_INIT;
      h2 = RW_HASH_INIT ^ RW_SEED_FP2;
      for (int l = 0; l < keys.n; ++l) rw_hash_lane(keys.in[l], keys.dt[l], i, h1, h2);
      h1 = rw_mix32(h1);
      h2 = rw_mix32(h2);
    }
    const int32_t sg = signs[i];
    if (sg == 0) h1 = h2 = 0xFFFFFFFFu;
    const unsigned long long k = ((unsigned long long)h1 << 32) | (unsigned long long)h2;
    key64[i] = k;
    const uint32_t code = sg == 0 ? 0u : sg == 1 ? 1u : sg == -1 ? 2u : 3u;
    pay[i] = (int32_t)((uint32_t)i | (code << 30));
#pragma unroll
    for (int b = 0; b < 8; ++b) atomicAdd(&mine[b * OS_RADIX + ((k >> (8 * b)) & 0xFFull)], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * OS_RADIX; i += blockDim.x) {
    uint32_t c = 0;
    for (int j = 0; j < OS_HIST_COPIES; ++j) c += h[j][i];
    if (c) atomicAdd(hist + i, c);
  }
}

// -- 3. reduce ---------------------------------------------------------------------
// A sorted row's sign, from its payload.
__device__ __forceinline__ int32_t rbk_sign(uint32_t pay, const int32_t* signs) {
  switch (pay >> 30) {
    case 0: return 0;
    case 1: return 1;
    case 2: return -1;
  }
  return signs[pay & RBK_ROW];
}

// A lane's element at row r as raw bits (bool: 0/1 byte; 32-bit lanes
// zero-extended).
__device__ __forceinline__ long long rbk_load_raw(const void* p, int dt, int64_t r) {
  switch (dt) {
    case RW_BOOL: return ((const uint8_t*)p)[r];
    case RW_I32:
    case RW_F32: return (long long)((const uint32_t*)p)[r];
  }
  return ((const long long*)p)[r];
}

__device__ __forceinline__ void rbk_store_raw(void* p, int dt, int64_t r, long long v) {
  switch (dt) {
    case RW_BOOL: ((uint8_t*)p)[r] = (uint8_t)v; break;
    case RW_I32:
    case RW_F32: ((uint32_t*)p)[r] = (uint32_t)v; break;
    default: ((long long*)p)[r] = v; break;
  }
}

// Two raw elements of one key lane differ as grouping sees them.
__device__ __forceinline__ bool rbk_differ(int dt, long long a, long long b) {
  switch (dt) {
    case RW_BOOL: return (a != 0) != (b != 0);
    case RW_I32: return (int)a != (int)b;
    case RW_F32: {
      const float x = __uint_as_float((uint32_t)a), y = __uint_as_float((uint32_t)b);
      return x != y && !(isnan(x) && isnan(y));
    }
    case RW_F64: {
      const double x = __longlong_as_double(a), y = __longlong_as_double(b);
      return x != y && !(isnan(x) && isnan(y));
    }
  }
  return a != b;
}

__device__ __forceinline__ long long rbk_combine(int op, long long a, long long b) {
  switch (op) {
    case OP_SUM_I64: return a + b;
    case OP_SUM_F32: {
      const float r = __int_as_float((int)a) + __int_as_float((int)b);
      return (long long)(unsigned int)__float_as_int(r);
    }
    case OP_SUM_F64:
      return __double_as_longlong(__longlong_as_double(a) + __longlong_as_double(b));
    case OP_MIN_I64: return a < b ? a : b;
    case OP_MAX_I64: return a > b ? a : b;
    case OP_MIN_I32: return (int)a < (int)b ? a : b;
    case OP_MAX_I32: return (int)a > (int)b ? a : b;
  }
  return 0;
}

__device__ __forceinline__ long long rbk_load_i64(const void* p, int dt, int64_t r) {
  switch (dt) {
    case RW_BOOL: return ((const uint8_t*)p)[r] ? 1 : 0;
    case RW_I32: return ((const int32_t*)p)[r];
    case RW_I64: return ((const long long*)p)[r];
  }
  return 0;
}

// Row r's contribution (with sign w) to lane l.
__device__ __forceinline__ long long rbk_contribution(const RbkLanes& L, int l, int64_t r,
                                                      int32_t w, bool* retract) {
  const bool notnull = L.nul[l] == nullptr || !L.nul[l][r];
  switch (L.src[l]) {
    case SRC_SIGN: return (long long)w;
    case SRC_WN: return notnull ? (long long)w : 0;
    case SRC_SUM:
      if (!notnull) return 0;
      switch (L.op[l]) {
        case OP_SUM_F32: {
          const float x = ((const float*)L.val[l])[r] * (float)w;
          return (long long)(unsigned int)__float_as_int(x);
        }
        case OP_SUM_F64: {
          const double x = ((const double*)L.val[l])[r] * (double)w;
          return __double_as_longlong(x);
        }
        default: return rbk_load_i64(L.val[l], L.vdt[l], r) * (long long)w;
      }
    case SRC_EXT: {
      if (notnull && w < 0) *retract = true;
      if (!(notnull && w > 0)) return L.sentinel[l];
      long long key;
      if (L.vdt[l] == RW_F32) key = rw_order_key_f32(((const float*)L.val[l])[r]);
      else if (L.vdt[l] == RW_F64) key = rw_order_key_f64(((const double*)L.val[l])[r]);
      else key = rbk_load_i64(L.val[l], L.vdt[l], r);
      if (L.op[l] == OP_MIN_I32 || L.op[l] == OP_MAX_I32) key = (long long)(int)key;
      return key;
    }
    case SRC_USE: return (notnull && w > 0) ? 1 : 0;
  }
  return 0;
}

__device__ __forceinline__ void rbk_store_out(const RbkLanes& L, int l, int64_t i, long long x) {
  switch (L.op[l]) {
    case OP_SUM_F32:
    case OP_MIN_I32:
    case OP_MAX_I32: ((int32_t*)L.out[l])[i] = (int32_t)x; break;
    default: ((long long*)L.out[l])[i] = x; break;
  }
}

// The segmented fold of the rows before this thread's in the tile, since
// the last boundary among them (thread 0: none). (f, a): a thread's rows
// hold a boundary; their fold since the last one. Association fixed:
// within a warp by shuffles, then the warps' results left to right.
__device__ __forceinline__ long long rbk_carry_in(int op, bool f, long long a, long long* s_wa,
                                                  uint8_t* s_wf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool fi = f;
  long long ai = a;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long oa = __shfl_up_sync(0xFFFFFFFFu, ai, d);
    const int of = __shfl_up_sync(0xFFFFFFFFu, (int)fi, d);
    if (lane >= d) {
      if (!fi) ai = rbk_combine(op, oa, ai);
      fi = fi || of;
    }
  }
  if (lane == 31) {
    s_wa[warp] = ai;
    s_wf[warp] = fi ? 1 : 0;
  }
  __syncthreads();
  long long pa = 0;  // the earlier warps, left to right
  for (int w = 0; w < warp; ++w)
    pa = (w == 0 || s_wf[w]) ? s_wa[w] : rbk_combine(op, pa, s_wa[w]);
  long long ea = __shfl_up_sync(0xFFFFFFFFu, ai, 1);
  const int ef = __shfl_up_sync(0xFFFFFFFFu, (int)fi, 1);
  if (lane == 0) ea = pa;
  else if (warp > 0 && !ef) ea = rbk_combine(op, pa, ea);
  __syncthreads();  // s_wa is reused by the next lane
  return ea;
}

__global__ void __launch_bounds__(RBK_THREADS)
    rbk_reduce_kernel(RbkKeys K, RbkLanes L, int64_t n, const unsigned long long* __restrict__ key64,
                      const int32_t* __restrict__ perm, const int32_t* __restrict__ signs,
                      uint8_t* __restrict__ rep_valid, uint8_t* minmax_ret, RbkTiles T) {
  __shared__ long long sa[RBK_STAGE];  // the sorted keys, then a lane's segment folds
  __shared__ long long sb[RBK_STAGE];  // the permutation, signs, key and output values
  __shared__ uint8_t s_first[RBK_THREADS + 1];  // a thread's first row is a boundary
  __shared__ long long s_wa[RBK_THREADS / 32];
  __shared__ uint8_t s_wf[RBK_THREADS / 32];
  __shared__ long long s_agg[RBK_MAX_LANES], s_head[RBK_MAX_LANES], s_tot[RBK_MAX_LANES];
  __shared__ uint32_t s_tile;
  __shared__ uint32_t s_prev, s_next;  // the payloads of the rows before and after the tile
  __shared__ int s_next_flag, s_first_b, s_last_b, s_from;
  const int t = threadIdx.x;
  if (t == 0) {
    s_tile = atomicAdd(T.counter, 1u);
    s_first_b = RBK_TILE;
    s_last_b = -1;
  }
  __syncthreads();
  const uint32_t tile = s_tile;
  const int64_t base = (int64_t)tile * RBK_TILE;
  const int cnt = n - base < RBK_TILE ? (int)(n - base) : RBK_TILE;
  const bool has_prev = base > 0, has_next = base + cnt < n;

  // the sorted keys and the permutation, read once, coalesced
  for (int i = t; i < cnt; i += RBK_THREADS) {
    sa[RBK_AT(i)] = (long long)key64[base + i];
    sb[RBK_AT(i)] = perm[base + i];
  }
  if (t == 0) {
    s_prev = has_prev ? (uint32_t)perm[base - 1] : 0u;
    s_next = has_next ? (uint32_t)perm[base + cnt] : 0u;
    s_next_flag = has_next ? key64[base + cnt] != key64[base + cnt - 1] : 1;
  }
  __syncthreads();
  int64_t p[RBK_ITEMS];
  int32_t sg[RBK_ITEMS];
  bool f[RBK_ITEMS];  // boundaries (rows past the tile's end: no)
#pragma unroll
  for (int j = 0; j < RBK_ITEMS; ++j) {
    const int r = t * RBK_ITEMS + j;
    const bool ok = r < cnt;
    const uint32_t pay = ok ? (uint32_t)sb[RBK_AT(r)] : 0u;
    p[j] = pay & RBK_ROW;
    sg[j] = ok ? rbk_sign(pay, signs) : 0;
    f[j] = ok && (r == 0 ? (!has_prev || sa[RBK_AT(0)] != (long long)key64[base - 1])
                         : sa[RBK_AT(r)] != sa[RBK_AT(r - 1)]);
  }
  __syncthreads();
  // the visibility changes too
#pragma unroll
  for (int j = 0; j < RBK_ITEMS; ++j) {
    const int r = t * RBK_ITEMS + j;
    if (r < cnt) sb[RBK_AT(r)] = sg[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < RBK_ITEMS; ++j) {
    const int r = t * RBK_ITEMS + j;
    if (r >= cnt) continue;
    const bool prev_vis = r > 0 ? sb[RBK_AT(r - 1)] != 0 : (has_prev && (s_prev >> 30) != 0u);
    f[j] = f[j] || (r > 0 || has_prev) && (sg[j] != 0) != prev_vis;
  }
  if (t == 0 && has_next) s_next_flag |= ((s_next >> 30) != 0u) != (sb[RBK_AT(cnt - 1)] != 0);
  __syncthreads();
  // key lanes: gathered, written in sorted order, compared with the row before
  for (int l = 0; l < K.n; ++l) {
    const int dt = K.dt[l];
    long long v[RBK_ITEMS];
#pragma unroll
    for (int j = 0; j < RBK_ITEMS; ++j) {
      const int r = t * RBK_ITEMS + j;
      v[j] = r < cnt ? rbk_load_raw(K.in[l], dt, p[j]) : 0;
      if (r < cnt) sb[RBK_AT(r)] = v[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < RBK_ITEMS; ++j) {
      const int r = t * RBK_ITEMS + j;
      if (r >= cnt || f[j]) continue;
      const long long prev = r > 0 ? sb[RBK_AT(r - 1)] : rbk_load_raw(K.in[l], dt, s_prev & RBK_ROW);
      f[j] = rbk_differ(dt, v[j], prev);  // r == 0 here only when has_prev
    }
    if (t == 0 && has_next && !s_next_flag)
      s_next_flag = rbk_differ(dt, rbk_load_raw(K.in[l], dt, s_next & RBK_ROW), sb[RBK_AT(cnt - 1)]);
    for (int i = t; i < cnt; i += RBK_THREADS) rbk_store_raw(K.out[l], dt, base + i, sb[RBK_AT(i)]);
    __syncthreads();
  }
  // boundaries: local segment numbers, the first and last boundary, rep_valid
  int nb = 0, fb = -1, lb = -1;
#pragma unroll
  for (int j = 0; j < RBK_ITEMS; ++j) {
    if (!f[j]) continue;
    const int r = t * RBK_ITEMS + j;
    ++nb;
    if (fb < 0) fb = r;
    lb = r;
  }
  s_first[t] = f[0] ? 1 : 0;
  if (t == 0) s_first[RBK_THREADS] = 1;  // the tile's end closes every segment
  if (fb >= 0) {
    atomicMin(&s_first_b, fb);
    atomicMax(&s_last_b, lb);
  }
  int bex;
  const int nbound = rw_block_exclusive_scan<RBK_THREADS>(nb, &bex);
  const int h = s_first[0] ? 0 : 1;  // the tile's first row continues a segment
  const bool tail_open = !s_next_flag;  // its last segment runs into the next tile
  const int head_end = h ? (nbound > 0 ? s_first_b : cnt) : 0;
  const int tail_lo = tail_open ? (nbound > 0 ? s_last_b : 0) : cnt;
  const bool head_done = h && (nbound > 0 || !tail_open);  // the head segment ends here
  int seg[RBK_ITEMS];  // each row's segment in the tile
  {
    int s = h + bex - 1;
#pragma unroll
    for (int j = 0; j < RBK_ITEMS; ++j) {
      s += f[j] ? 1 : 0;
      seg[j] = s;
    }
  }
  {
    const int r0 = t * RBK_ITEMS;
    if (r0 + RBK_ITEMS <= cnt) {
      unsigned long long word = 0;
#pragma unroll
      for (int j = 0; j < RBK_ITEMS; ++j)
        word |= (unsigned long long)(f[j] && sg[j] != 0) << (8 * j);
      *(unsigned long long*)(rep_valid + base + r0) = word;
    } else {
      for (int j = 0; j < RBK_ITEMS && r0 + j < cnt; ++j)
        rep_valid[base + r0 + j] = (f[j] && sg[j] != 0) ? 1 : 0;
    }
  }
  // value lanes: a segmented scan, each segment's fold in sa, its rows written
  bool retract = false;
  for (int l = 0; l < L.n; ++l) {
    const int op = L.op[l];
    long long v[RBK_ITEMS];
#pragma unroll
    for (int j = 0; j < RBK_ITEMS; ++j) {
      const int r = t * RBK_ITEMS + j;
      v[j] = r < cnt ? rbk_contribution(L, l, p[j], sg[j], &retract) : 0;
    }
    long long agg = v[0];
    bool any = f[0];
#pragma unroll
    for (int j = 1; j < RBK_ITEMS; ++j) {
      agg = f[j] ? v[j] : rbk_combine(op, agg, v[j]);
      any = any || f[j];
    }
    long long run = rbk_carry_in(op, any, agg, s_wa, s_wf);
#pragma unroll
    for (int j = 0; j < RBK_ITEMS; ++j) {
      const int r = t * RBK_ITEMS + j;
      if (r >= cnt) break;
      run = (f[j] || r == 0) ? v[j] : rbk_combine(op, run, v[j]);
      const bool last = j + 1 < RBK_ITEMS ? f[j + 1] : s_first[t + 1] != 0;
      if (last || r + 1 == cnt) sa[seg[j]] = run;
    }
    __syncthreads();
    if (t == 0) {
      s_agg[l] = sa[h + nbound - 1];
      s_head[l] = sa[0];
    }
#pragma unroll
    for (int j = 0; j < RBK_ITEMS; ++j) {
      const int r = t * RBK_ITEMS + j;
      if (r < cnt) sb[RBK_AT(r)] = sa[seg[j]];
    }
    __syncthreads();
    for (int i = head_end + t; i < tail_lo; i += RBK_THREADS) rbk_store_out(L, l, base + i, sb[RBK_AT(i)]);
    __syncthreads();
  }
  if (retract) *minmax_ret = 1;
  // publish the open segment's fold; look back for the head's carry
  if (t < 32) {
    const int lane = t;
    const bool inc_now = nbound > 0;  // the open segment starts in this tile
    if (lane < L.n) {
      if (inc_now) T.inc[(int64_t)tile * L.n + lane] = s_agg[lane];
      else T.agg[(int64_t)tile * L.n + lane] = s_agg[lane];
      __threadfence();
    }
    __syncwarp();
    if (lane == 0) {
      if (inc_now) T.start[tile] = (int32_t)tile;
      __threadfence();
      *(volatile uint32_t*)(T.flag + tile) = inc_now ? RBK_INC : RBK_AGG;
    }
    if (h) {
      // the nearest earlier tile with its inclusive fold: every tile in
      // between has no boundary and published its own fold
      int64_t found = -1;
      for (int64_t q0 = (int64_t)tile - 1; found < 0; q0 -= 32) {
        const int64_t q = q0 - lane;
        uint32_t fl = RBK_INC;  // before tile 0: never reached (tile 0 starts a segment)
        if (q >= 0) {
          int64_t spins = 0;
          do {
            fl = *(volatile uint32_t*)(T.flag + q);
            if (++spins > RW_SPIN_LIMIT) __trap();  // a tile that never published: fail, not hang
          } while (fl == 0u);
        }
        const unsigned inc = __ballot_sync(0xFFFFFFFFu, fl == RBK_INC);
        if (inc) found = q0 - (__ffs(inc) - 1);
      }
      __threadfence();
      const int from = *(volatile int32_t*)(T.start + found);
      if (lane < L.n) {
        const int op = L.op[lane];
        long long c = *(volatile long long*)(T.inc + found * L.n + lane);
        for (int64_t q = found + 1; q < (int64_t)tile; ++q)
          c = rbk_combine(op, c, *(volatile long long*)(T.agg + q * L.n + lane));
        if (!inc_now) T.inc[(int64_t)tile * L.n + lane] = rbk_combine(op, c, s_agg[lane]);
        const long long total = rbk_combine(op, c, s_head[lane]);
        if (head_done) {
          s_tot[lane] = total;
          T.tot[(int64_t)from * L.n + lane] = total;
        }
        __threadfence();
      }
      __syncwarp();
      if (lane == 0) {
        s_from = from;
        if (!inc_now) {
          T.start[tile] = from;
          __threadfence();
          *(volatile uint32_t*)(T.flag + tile) = RBK_INC;
        }
      }
    }
    if (lane == 0) {
      T.fix_lo[tile] = tail_open ? (int32_t)(base + tail_lo) : -1;
      T.fix_from[tile] = nbound > 0 ? (int32_t)tile : s_from;
    }
  }
  __syncthreads();
  if (head_done)
    for (int l = 0; l < L.n; ++l)
      for (int i = t; i < head_end; i += RBK_THREADS) rbk_store_out(L, l, base + i, s_tot[l]);
}

// -- 4. fix-up: the rows of a segment's earlier tiles ---------------------------------
__global__ void rbk_fixup_kernel(RbkLanes L, int64_t n, RbkTiles T) {
  const int64_t tile = blockIdx.x;
  const int32_t lo = T.fix_lo[tile];
  if (lo < 0) return;
  const int64_t end = (tile + 1) * RBK_TILE < n ? (tile + 1) * RBK_TILE : n;
  const int64_t from = T.fix_from[tile];
  for (int l = 0; l < L.n; ++l) {
    const long long x = T.tot[from * L.n + l];
    for (int64_t i = lo + threadIdx.x; i < end; i += blockDim.x) rbk_store_out(L, l, i, x);
  }
}

static inline size_t rbk_align(size_t b) { return (b + 255) & ~(size_t)255; }

// keys: n_keys rows of (input ptr, dtype code, sorted output ptr);
// fp1/fp2: (n,) int64 fingerprints replacing hash128, or null;
// lanes: n_lanes rows of (src, op, val, vdt, nul, out, sentinel), lane 0
// being w; minmax_ret: one byte (written here); scratch: scratch_bytes
// bytes, laid out below (ops/agg.py reduce_scratch_bytes computes the
// same size).
RW_EXPORT int rw_reduce_by_key(const int64_t* keys, int n_keys, int64_t n, const void* signs,
                               const void* fp1, const void* fp2, const int64_t* lanes,
                               int n_lanes, void* rep_valid, void* minmax_ret, void* scratch,
                               int64_t scratch_bytes, void* stream) {
  if (n_keys < 1 || n_keys > RBK_MAX_KEYS || n_lanes < 1 || n_lanes > RBK_MAX_LANES || n < 0 ||
      n > OS_MAX_KEYS)
    return (int)cudaErrorInvalidValue;
  RbkKeys K;
  K.n = n_keys;
  for (int l = 0; l < n_keys; ++l) {
    K.in[l] = (const void*)keys[3 * l];
    K.dt[l] = (int)keys[3 * l + 1];
    K.out[l] = (void*)keys[3 * l + 2];
  }
  RbkLanes L;
  L.n = n_lanes;
  for (int l = 0; l < n_lanes; ++l) {
    const int64_t* r = lanes + 7 * l;
    L.src[l] = (int)r[0];
    L.op[l] = (int)r[1];
    L.val[l] = (const void*)r[2];
    L.vdt[l] = (int)r[3];
    L.nul[l] = (const uint8_t*)r[4];
    L.out[l] = (void*)r[5];
    L.sentinel[l] = (long long)r[6];
  }
  // scratch: two (key, payload) buffers of the sort; then, zeroed by one
  // memset, the digit counts, each pass's look-back words and tile
  // counter, and the reduce tiles' flags and counter; then the reduce
  // tiles' records
  const int64_t os_t = os_tiles(n), tiles = (n + RBK_TILE - 1) / RBK_TILE;
  const size_t pass_words = (size_t)os_t * OS_RADIX + 1;
  char* at = (char*)scratch;
  auto take = [&](size_t bytes) {
    char* p = at;
    at += rbk_align(bytes);
    return (void*)p;
  };
  OsScratch s;
  s.ka = (unsigned long long*)take(8 * (size_t)n);
  s.kb = (unsigned long long*)take(8 * (size_t)n);
  s.pa = (int32_t*)take(4 * (size_t)n);
  s.pb = (int32_t*)take(4 * (size_t)n);
  char* zero = at;
  s.hist = (uint32_t*)take(4 * 8 * OS_RADIX);
  s.status = (uint32_t*)take(4 * 8 * pass_words);
  RbkTiles T;
  T.flag = (uint32_t*)take(4 * ((size_t)tiles + 1));
  T.counter = T.flag + tiles;
  const size_t zero_bytes = at - zero;
  T.start = (int32_t*)take(4 * (size_t)tiles);
  T.agg = (long long*)take(8 * (size_t)tiles * n_lanes);
  T.inc = (long long*)take(8 * (size_t)tiles * n_lanes);
  T.tot = (long long*)take(8 * (size_t)tiles * n_lanes);
  T.fix_lo = (int32_t*)take(4 * (size_t)tiles);
  T.fix_from = (int32_t*)take(4 * (size_t)tiles);
  if ((int64_t)(at - (char*)scratch) > scratch_bytes) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 0) {
    cudaMemsetAsync(minmax_ret, 0, 1, st);
    return (int)cudaGetLastError();
  }
  cudaMemsetAsync(zero, 0, zero_bytes, st);
  const int hb = rw_blocks(n, OS_THREADS);
  rbk_hash_hist_kernel<<<hb < OS_HIST_BLOCKS ? hb : OS_HIST_BLOCKS, OS_THREADS, 0, st>>>(
      K, n, (const int32_t*)signs, (const long long*)fp1, (const long long*)fp2, s.ka, s.pb,
      s.hist, (uint8_t*)minmax_ret);
  const unsigned long long* ck = s.ka;
  const int32_t* cp = s.pb;
  for (int b = 0; b < 8; ++b) {
    unsigned long long* ok = ck == s.ka ? s.kb : s.ka;
    int32_t* op = cp == s.pa ? s.pb : s.pa;
    uint32_t* status = s.status + b * pass_words;
    os_pass_kernel<<<(int)os_t, OS_THREADS, 0, st>>>(ck, cp, ok, op, n, 8 * b, s.hist + b * OS_RADIX,
                                                     status, status + pass_words - 1);
    ck = ok;
    cp = op;
  }
  rbk_reduce_kernel<<<(int)tiles, RBK_THREADS, 0, st>>>(K, L, n, ck, cp, (const int32_t*)signs,
                                                        (uint8_t*)rep_valid, (uint8_t*)minmax_ret,
                                                        T);
  rbk_fixup_kernel<<<(int)tiles, RBK_THREADS, 0, st>>>(L, n, T);
  return (int)cudaGetLastError();
}
