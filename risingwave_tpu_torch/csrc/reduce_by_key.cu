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
// (key, row) pair per row per pass; the gather, boundary and reduce
// passes read the key, sign and value lanes once more (the value and
// null lanes at random, through the sort's permutation) and write the
// sorted key lanes and the reduced lanes.
//
// Design, in launches on one stream:
//  1. keys: hash each row (hashing.cuh), pack h1 << 32 | h2 into a
//     64-bit key, with the row index as payload;
//  2. an LSD radix sort of the 64-bit keys, 8 passes of 8 bits, each
//     pass three launches (csrc/radix.cuh, shared with kernels W and
//     X): per-tile digit counts; per digit, an exclusive scan of the
//     counts over the tiles; a scatter in which each tile first sorts
//     its 2048 keys by the digit locally with eight stable 1-bit splits
//     in shared memory, so ranks within a digit keep row order (an
//     atomic counter would lose it) and the whole sort is stable, as
//     lax.sort is;
//  3. gather: the key lanes and signs in sorted order;
//  4. boundaries: per row, against its predecessor; a count per tile;
//  5. a one-block scan of the tile counts: each tile's first segment
//     index and the number of segments;
//  6. reduce: per tile, each row's segment index and contribution, a
//     segmented scan inside the tile (per thread, then across threads
//     in shared memory), the tile-local total of each segment that
//     starts in the tile, and the tile's share of the segment that
//     runs into it from before;
//  7. combine: per segment, the shares of the later tiles it covers,
//     added in tile order (so float sums are deterministic);
//  8. broadcast: each row gets its segment's totals, and rep_valid.
#include "hashing.cuh"
#include "radix.cuh"

#define RBK_MAX_KEYS 8
#define RBK_MAX_LANES 20

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

// -- 1. keys -------------------------------------------------------------------
__global__ void rbk_keys_kernel(RbkKeys keys, int64_t n, const int32_t* signs,
                                const long long* fp1, const long long* fp2,
                                unsigned long long* key64, int32_t* idx) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
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
  if (signs[i] == 0) h1 = h2 = 0xFFFFFFFFu;
  key64[i] = ((unsigned long long)h1 << 32) | (unsigned long long)h2;
  idx[i] = (int32_t)i;
}

// -- 3. gather -------------------------------------------------------------------
__global__ void rbk_gather_kernel(RbkKeys keys, int64_t n, const int32_t* perm,
                                  const int32_t* signs, int32_t* s_sign) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t r = perm[i];
  for (int l = 0; l < keys.n; ++l) {
    switch (keys.dt[l]) {
      case RW_BOOL: ((uint8_t*)keys.out[l])[i] = ((const uint8_t*)keys.in[l])[r]; break;
      case RW_I32:
      case RW_F32: ((uint32_t*)keys.out[l])[i] = ((const uint32_t*)keys.in[l])[r]; break;
      default:
        ((unsigned long long*)keys.out[l])[i] = ((const unsigned long long*)keys.in[l])[r];
        break;
    }
  }
  s_sign[i] = signs[r];
}

// -- 4. boundaries -----------------------------------------------------------------
__device__ __forceinline__ bool rbk_lane_changes(const void* lane, int dt, int64_t i) {
  switch (dt) {
    case RW_BOOL: return (((const uint8_t*)lane)[i] != 0) != (((const uint8_t*)lane)[i - 1] != 0);
    case RW_I32: return ((const int32_t*)lane)[i] != ((const int32_t*)lane)[i - 1];
    case RW_I64: return ((const long long*)lane)[i] != ((const long long*)lane)[i - 1];
    case RW_F32: {
      const float a = ((const float*)lane)[i], b = ((const float*)lane)[i - 1];
      return a != b && !(isnan(a) && isnan(b));
    }
    case RW_F64: {
      const double a = ((const double*)lane)[i], b = ((const double*)lane)[i - 1];
      return a != b && !(isnan(a) && isnan(b));
    }
  }
  return false;
}

__global__ void rbk_flags_kernel(RbkKeys keys, int64_t n, const unsigned long long* key64,
                                 const int32_t* s_sign, uint8_t* flags, int32_t* tile_counts) {
  const int64_t base = (int64_t)blockIdx.x * RBK_TILE;
  int count = 0;
#pragma unroll
  for (int j = 0; j < RBK_ITEMS; ++j) {
    const int64_t i = base + j * RBK_THREADS + threadIdx.x;
    if (i >= n) continue;
    bool b = i == 0 || key64[i] != key64[i - 1] || ((s_sign[i] != 0) != (s_sign[i - 1] != 0));
    for (int l = 0; l < keys.n && !b; ++l) b = rbk_lane_changes(keys.out[l], keys.dt[l], i);
    flags[i] = b ? 1 : 0;
    count += b ? 1 : 0;
  }
  int excl;
  const int total = rw_block_exclusive_scan<RBK_THREADS>(count, &excl);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// -- 5. one-block scan of the per-tile boundary counts ----------------------------------
__global__ void rbk_tile_scan_kernel(int32_t* tile_counts, int n_tiles, int32_t* n_seg) {
  const int per = (n_tiles + RBK_SCAN_THREADS - 1) / RBK_SCAN_THREADS;
  const int lo = threadIdx.x * per;
  int local = 0;
  for (int j = lo; j < lo + per && j < n_tiles; ++j) local += tile_counts[j];
  int excl;
  const int total = rw_block_exclusive_scan<RBK_SCAN_THREADS>(local, &excl);
  int run = excl;
  for (int j = lo; j < lo + per && j < n_tiles; ++j) {
    const int c = tile_counts[j];
    tile_counts[j] = run;
    run += c;
  }
  if (threadIdx.x == 0) *n_seg = total;
}

// -- 6. reduce -----------------------------------------------------------------------
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

// Row r's contribution (in sorted position with sign w) to lane l.
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

__global__ void rbk_reduce_kernel(RbkLanes L, int64_t n, const int32_t* perm,
                                  const int32_t* s_sign, const uint8_t* flags,
                                  const int32_t* tile_offsets, int32_t* seg_id,
                                  int32_t* seg_start, long long* segval, long long* carry,
                                  int n_tiles, uint8_t* minmax_ret) {
  __shared__ uint8_t sflag[RBK_THREADS];     // a boundary inside the thread's rows
  __shared__ long long sval[2][RBK_THREADS];  // the thread aggregate, scanned
  __shared__ uint8_t sf[2][RBK_THREADS];
  __shared__ uint8_t first_flag[RBK_THREADS + 1];  // the first row's flag, per thread
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * RBK_TILE;
  bool f[RBK_ITEMS];  // boundary (rows past n count as boundaries)
  int nf = 0;
#pragma unroll
  for (int j = 0; j < RBK_ITEMS; ++j) {
    const int64_t i = base + t * RBK_ITEMS + j;
    f[j] = i >= n || flags[i] != 0;
    if (i < n && f[j]) ++nf;
  }
  int excl;
  rw_block_exclusive_scan<RBK_THREADS>(nf, &excl);
  first_flag[t] = f[0] ? 1 : 0;
  if (t == 0) first_flag[RBK_THREADS] = 1;  // the tile's end closes every segment
  int seg_here = tile_offsets[blockIdx.x] + excl - 1;
#pragma unroll
  for (int j = 0; j < RBK_ITEMS; ++j) {
    const int64_t i = base + t * RBK_ITEMS + j;
    if (i >= n) break;
    if (f[j]) {
      ++seg_here;
      seg_start[seg_here] = (int32_t)i;
    }
    seg_id[i] = seg_here;
  }
  __syncthreads();
  bool retract = false;
  for (int l = 0; l < L.n; ++l) {
    long long v[RBK_ITEMS];
#pragma unroll
    for (int j = 0; j < RBK_ITEMS; ++j) {
      const int64_t i = base + t * RBK_ITEMS + j;
      v[j] = i < n ? rbk_contribution(L, l, perm[i], s_sign[i], &retract) : 0;
    }
    // the thread's aggregate: rows after its last boundary
    const int op = L.op[l];
    long long agg = v[0];
    bool fl = f[0];
#pragma unroll
    for (int j = 1; j < RBK_ITEMS; ++j) {
      agg = f[j] ? v[j] : rbk_combine(op, agg, v[j]);
      fl |= f[j];
    }
    // inclusive segmented scan of (flag, aggregate) across the threads
    int cur = 0;
    sval[0][t] = agg;
    sf[0][t] = fl ? 1 : 0;
    __syncthreads();
    for (int d = 1; d < RBK_THREADS; d <<= 1) {
      long long a = sval[cur][t];
      uint8_t g = sf[cur][t];
      if (t >= d && !g) {
        a = rbk_combine(op, sval[cur][t - d], a);
        g = sf[cur][t - d];
      }
      sval[cur ^ 1][t] = a;
      sf[cur ^ 1][t] = g;
      cur ^= 1;
      __syncthreads();
    }
    // the carry into this thread: rows since the last boundary before it
    const bool has_carry = t > 0;
    const long long carry_in = has_carry ? sval[cur][t - 1] : 0;
    const bool started_before = has_carry && sf[cur][t - 1];  // a boundary earlier in the tile
    long long run = carry_in;
    bool in_tile_start = started_before;
    seg_here = tile_offsets[blockIdx.x] + excl - 1;
#pragma unroll
    for (int j = 0; j < RBK_ITEMS; ++j) {
      const int64_t i = base + t * RBK_ITEMS + j;
      if (i >= n) break;
      if (f[j]) {
        run = v[j];
        in_tile_start = true;
        ++seg_here;
      } else if (j == 0 && !has_carry) {
        run = v[j];
      } else {
        run = rbk_combine(op, run, v[j]);
      }
      const bool next_flag = j + 1 < RBK_ITEMS ? f[j + 1] : first_flag[t + 1] != 0;
      if (next_flag || i + 1 == n) {
        if (in_tile_start) segval[(int64_t)l * n + seg_here] = run;
        else carry[(int64_t)l * n_tiles + blockIdx.x] = run;
      }
    }
    __syncthreads();
  }
  if (retract) *minmax_ret = 1;
}

// -- 7. combine -------------------------------------------------------------------------
__global__ void rbk_combine_kernel(RbkLanes L, int64_t n, const int32_t* n_seg,
                                   const int32_t* seg_start, long long* segval,
                                   const long long* carry, int n_tiles) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t ns = *n_seg;
  if (s >= ns) return;
  const int64_t start = seg_start[s];
  const int64_t end = s + 1 < ns ? seg_start[s + 1] : n;
  const int64_t t0 = start / RBK_TILE, t1 = (end - 1) / RBK_TILE;
  if (t1 == t0) return;
  for (int l = 0; l < L.n; ++l) {
    long long acc = segval[(int64_t)l * n + s];
    for (int64_t tt = t0 + 1; tt <= t1; ++tt)
      acc = rbk_combine(L.op[l], acc, carry[(int64_t)l * n_tiles + tt]);
    segval[(int64_t)l * n + s] = acc;
  }
}

// -- 8. broadcast ------------------------------------------------------------------------
__global__ void rbk_broadcast_kernel(RbkLanes L, int64_t n, const int32_t* seg_id,
                                     const long long* segval, const uint8_t* flags,
                                     const int32_t* s_sign, uint8_t* rep_valid) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t s = seg_id[i];
  for (int l = 0; l < L.n; ++l) {
    const long long x = segval[(int64_t)l * n + s];
    switch (L.op[l]) {
      case OP_SUM_F32: ((int32_t*)L.out[l])[i] = (int32_t)x; break;
      case OP_MIN_I32:
      case OP_MAX_I32: ((int32_t*)L.out[l])[i] = (int32_t)x; break;
      default: ((long long*)L.out[l])[i] = x; break;
    }
  }
  rep_valid[i] = (flags[i] && s_sign[i] != 0) ? 1 : 0;
}

// keys: n_keys rows of (input ptr, dtype code, sorted output ptr);
// fp1/fp2: (n,) int64 fingerprints replacing hash128, or null;
// lanes: n_lanes rows of (src, op, val, vdt, nul, out, sentinel), lane 0
// being w; minmax_ret: one byte, zeroed by the caller; the rest is
// scratch sized by the Python wrapper (ops/agg.py _reduce_by_key_cuda).
RW_EXPORT int rw_reduce_by_key(const int64_t* keys, int n_keys, int64_t n, const void* signs,
                               const void* fp1, const void* fp2, const int64_t* lanes,
                               int n_lanes, void* rep_valid, void* minmax_ret, void* keys_a,
                               void* keys_b, void* idx_a, void* idx_b, void* hist, void* s_sign,
                               void* flags, void* tile_counts, void* n_seg, void* seg_id,
                               void* seg_start, void* segval, void* carry, void* stream) {
  if (n_keys < 1 || n_keys > RBK_MAX_KEYS || n_lanes < 1 || n_lanes > RBK_MAX_LANES ||
      n >= (int64_t)1 << 31)
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
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  const int blocks = rw_blocks(n, threads);
  const int tiles = (int)((n + RBK_TILE - 1) / RBK_TILE);
  unsigned long long* ka = (unsigned long long*)keys_a;
  unsigned long long* kb = (unsigned long long*)keys_b;
  int32_t* ia = (int32_t*)idx_a;
  int32_t* ib = (int32_t*)idx_b;
  int32_t* h = (int32_t*)hist;

  rbk_keys_kernel<<<blocks, threads, 0, st>>>(K, n, (const int32_t*)signs, (const long long*)fp1,
                                              (const long long*)fp2, ka, ia);
  for (int pass = 0; pass < 8; ++pass) {
    rbk_radix_pass(ka, ia, kb, ib, n, 8 * pass, h, st);
    unsigned long long* tk = ka; ka = kb; kb = tk;
    int32_t* ti = ia; ia = ib; ib = ti;
  }
  // eight passes: the sorted keys and permutation are back in keys_a / idx_a
  rbk_gather_kernel<<<blocks, threads, 0, st>>>(K, n, ia, (const int32_t*)signs,
                                                (int32_t*)s_sign);
  rbk_flags_kernel<<<tiles, RBK_THREADS, 0, st>>>(K, n, ka, (const int32_t*)s_sign,
                                                     (uint8_t*)flags, (int32_t*)tile_counts);
  rbk_tile_scan_kernel<<<1, RBK_SCAN_THREADS, 0, st>>>((int32_t*)tile_counts, tiles,
                                                       (int32_t*)n_seg);
  rbk_reduce_kernel<<<tiles, RBK_THREADS, 0, st>>>(
      L, n, ia, (const int32_t*)s_sign, (const uint8_t*)flags, (const int32_t*)tile_counts,
      (int32_t*)seg_id, (int32_t*)seg_start, (long long*)segval, (long long*)carry, tiles,
      (uint8_t*)minmax_ret);
  rbk_combine_kernel<<<blocks, threads, 0, st>>>(L, n, (const int32_t*)n_seg,
                                                 (const int32_t*)seg_start, (long long*)segval,
                                                 (const long long*)carry, tiles);
  rbk_broadcast_kernel<<<blocks, threads, 0, st>>>(L, n, (const int32_t*)seg_id,
                                                   (const long long*)segval, (const uint8_t*)flags,
                                                   (const int32_t*)s_sign, (uint8_t*)rep_valid);
  return (int)cudaGetLastError();
}
