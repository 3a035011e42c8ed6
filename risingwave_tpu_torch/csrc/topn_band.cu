// Kernel U: one chunk into the append-only GroupTopN's bands.
//
// Replaces risingwave_tpu/executors/top_n.py:_topn_step (:67) after its
// lookup_or_insert of the group keys (kernel A) and its
// first_occurrence_mask (kernel J's first-occurrence entry, `fmask`:
// one leader row per touched group slot).
//
// What it computes, exactly as the reference: a valid DELETE row latches
// saw_delete; a valid insert without a slot latches dropped; every other
// valid insert marks its slot live and sdirty. For each touched group,
// its band's valid entries and the group's chunk rows are ranked by
// (order key, then the band's entries in band position, then chunk rows
// in row order), the order of the reference's stable lexsort; the first
// k stay. The band is rewritten: position p < kept holds the p-th kept
// entry (every lane), band_valid is p < kept, and the lanes past it keep
// their stale values. The emission chunk (out_cap rows, zero-filled by
// the caller) gets every band leaver as a DELETE, ordered by its group's
// leader row and then band position, then every kept chunk row as an
// INSERT in row order: the reference's cumsum over (band entries, chunk
// rows). Each row carries the group keys (from the table), the order
// column (the key decoded: NOT again for DESC) and the payload lanes;
// an emission past out_cap latches overflow and is dropped.
//
// What bounds it on the card: the chunk's lanes read a few times
// coalesced, each touched group's band rows read and rewritten (k
// entries of every band lane), the emitted rows written. A group whose
// chunk rows are many (q19's hot auction takes thousands a chunk) is
// merged by one thread, row by row, into a k-entry list; most rows are
// turned away by one comparison once the list is full.
//
// Design, in launches on one stream (no sort, scratch the size of the
// chunk): 1. per row: latches, live, sdirty, and the leader's row index
// into the group's scratch slot (kernel J's first_scratch lane, restored
// to its sentinel by launch 7); 2. per row: its leader (gid) and a count
// per leader; 3. an exclusive scan of the counts; 4. each row placed in
// its leader's segment (atomic cursor: the order inside a segment does
// not matter, the merge's key is total); 5. per leader: the band's valid
// entries and the segment's rows inserted into a sorted k-entry register
// list, which yields the kept entries, the leaver count and each entering
// row's flag; 6. one exclusive scan over (leaver counts, entering flags),
// which is each emission's position; 7. per leader: the leavers written
// out and the band rewritten (each lane's old entries read into registers
// first); per entering row: its INSERT written out.
#include "scan.cuh"

#define TB_MAX_LANES 16
#define TB_MAX_KEYS 8
#define TB_MAX_K 64
#define TB_THREADS 256
#define FO_SENTINEL 0x7FFFFFFF

struct TbKeys {
  const void* lane[TB_MAX_KEYS];  // (cap,) group key lanes of the table
  void* out[TB_MAX_KEYS];         // (out_cap,) emission columns
  int esize[TB_MAX_KEYS];
  int n;
};

struct TbLanes {
  void* band[TB_MAX_LANES];       // (cap, k) payload bands
  const void* src[TB_MAX_LANES];  // (n,) chunk columns, the bands' dtypes
  void* out[TB_MAX_LANES];        // (out_cap,) emission columns
  int esize[TB_MAX_LANES];
  int n;
};

__device__ __forceinline__ bool tb_is_del(int32_t op) { return op == 1 || op == 2; }

__device__ __forceinline__ int64_t tb_order(const void* col, int dt, int64_t i, int desc) {
  const int64_t v = dt == RW_I32 ? (int64_t)((const int32_t*)col)[i]
                                 : (int64_t)((const long long*)col)[i];
  return desc ? ~v : v;
}

__device__ __forceinline__ unsigned long long tb_load(const void* p, int64_t i, int esize) {
  switch (esize) {
    case 1: return ((const uint8_t*)p)[i];
    case 4: return ((const uint32_t*)p)[i];
    default: return ((const unsigned long long*)p)[i];
  }
}

__device__ __forceinline__ void tb_store(void* p, int64_t i, int esize, unsigned long long v) {
  switch (esize) {
    case 1: ((uint8_t*)p)[i] = (uint8_t)v; break;
    case 4: ((uint32_t*)p)[i] = (uint32_t)v; break;
    default: ((unsigned long long*)p)[i] = v; break;
  }
}

// (key, tag) before (key2, tag2): order key, then tag (band positions
// 0..k-1 before chunk rows k + row)
__device__ __forceinline__ bool tb_less(int64_t a, int32_t ta, int64_t b, int32_t tb) {
  return a < b || (a == b && ta < tb);
}

__global__ void tb_mark_kernel(int64_t n, const int32_t* slots, const uint8_t* fmask,
                               const uint8_t* valid, const int32_t* ops, uint8_t* live,
                               uint8_t* sdirty, int32_t* scratch, int32_t* cnt, int32_t* cur,
                               int32_t* emit, uint8_t* saw_delete, uint8_t* dropped) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  cnt[i] = 0;
  cur[i] = 0;
  emit[i] = 0;
  emit[n + i] = 0;
  if (!valid[i]) return;
  if (tb_is_del(ops[i])) {
    *saw_delete = 1;
    return;
  }
  const int32_t s = slots[i];
  if (s < 0) {
    *dropped = 1;
    return;
  }
  live[s] = 1;
  sdirty[s] = 1;
  if (fmask[i]) scratch[s] = (int32_t)i;
}

__global__ void tb_count_kernel(int64_t n, const int32_t* slots, const uint8_t* valid,
                                const int32_t* ops, const int32_t* scratch, int32_t* gid,
                                int32_t* cnt) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t g = -1;
  if (valid[i] && !tb_is_del(ops[i]) && slots[i] >= 0) {
    g = scratch[slots[i]];
    atomicAdd(cnt + g, 1);
  }
  gid[i] = g;
}

__global__ void tb_place_kernel(int64_t n, const int32_t* gid, const int32_t* off,
                                int32_t* cur, int32_t* lst) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t g = gid[i];
  if (g >= 0) lst[off[g] + atomicAdd(cur + g, 1)] = (int32_t)i;
}

template <int KMAX>
__global__ void tb_merge_kernel(int64_t n, int k, const int32_t* slots, const uint8_t* fmask,
                                const int32_t* cnt, const int32_t* off, const int32_t* lst,
                                const void* order_col, int order_dt, int desc,
                                const long long* band_order, const uint8_t* band_valid,
                                int32_t* kept, int32_t* emit) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !fmask[i]) return;
  const int64_t base = (int64_t)slots[i] * k;
  int64_t lk[KMAX];
  int32_t lt[KMAX];
  int m = 0;
  auto insert = [&](int64_t key, int32_t tag) {
    int pos;
    if (m == k) {
      if (!tb_less(key, tag, lk[k - 1], lt[k - 1])) return;
      pos = k - 1;
    } else {
      pos = m++;
    }
    while (pos > 0 && tb_less(key, tag, lk[pos - 1], lt[pos - 1])) {
      lk[pos] = lk[pos - 1];
      lt[pos] = lt[pos - 1];
      --pos;
    }
    lk[pos] = key;
    lt[pos] = tag;
  };
  int band_live = 0;
  for (int j = 0; j < k; ++j) {
    if (band_valid[base + j]) {
      ++band_live;
      insert((int64_t)band_order[base + j], j);
    }
  }
  const int32_t lo = off[i], hi = off[i] + cnt[i];
  for (int32_t q = lo; q < hi; ++q) {
    const int32_t r = lst[q];
    insert(tb_order(order_col, order_dt, r, desc), k + r);
  }
  int band_kept = 0;
  for (int p = 0; p < k; ++p) {
    const int32_t t = p < m ? lt[p] : -1;
    kept[i * k + p] = t;
    if (t >= 0 && t < k) ++band_kept;
    if (t >= k) emit[n + (t - k)] = 1;
  }
  emit[i] = band_live - band_kept;
}

template <int KMAX>
__global__ void tb_write_kernel(TbKeys keys, TbLanes lanes, int64_t n, int k, int64_t out_cap,
                                const int32_t* slots, const uint8_t* fmask, int32_t* scratch,
                                const void* order_col, int order_dt, int desc,
                                long long* band_order, uint8_t* band_valid, const int32_t* kept,
                                const int32_t* emit, const int32_t* epos, long long* out_order,
                                int32_t* out_ops, uint8_t* out_valid, uint8_t* overflow) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (fmask[i]) {
    const int32_t s = slots[i];
    const int64_t base = (int64_t)s * k;
    int m = 0;
    unsigned long long kept_band = 0ull, valid_band = 0ull;
    for (int p = 0; p < k; ++p) {
      const int32_t t = kept[i * k + p];
      if (t >= 0) {
        ++m;
        if (t < k) kept_band |= 1ull << t;
      }
      if (band_valid[base + p]) valid_band |= 1ull << p;
    }
    const unsigned long long leave = valid_band & ~kept_band;
    // the leavers first, while the band still holds them
    int64_t pos = epos[i];
    for (int j = 0; j < k; ++j) {
      if (!((leave >> j) & 1ull)) continue;
      if (pos >= out_cap) {
        *overflow = 1;
        ++pos;
        continue;
      }
      for (int g = 0; g < keys.n; ++g)
        tb_store(keys.out[g], pos, keys.esize[g], tb_load(keys.lane[g], s, keys.esize[g]));
      const long long o = band_order[base + j];
      out_order[pos] = desc ? ~o : o;
      for (int l = 0; l < lanes.n; ++l)
        tb_store(lanes.out[l], pos, lanes.esize[l],
                 tb_load(lanes.band[l], base + j, lanes.esize[l]));
      out_ops[pos] = 1;  // DELETE
      out_valid[pos] = 1;
      ++pos;
    }
    // then the band: each lane's old entries into registers, the kept
    // entries written at their ranks
    unsigned long long old[KMAX];
    for (int j = 0; j < k; ++j) old[j] = (unsigned long long)band_order[base + j];
    for (int p = 0; p < m; ++p) {
      const int32_t t = kept[i * k + p];
      band_order[base + p] =
          t < k ? (long long)old[t] : (long long)tb_order(order_col, order_dt, t - k, desc);
    }
    for (int l = 0; l < lanes.n; ++l) {
      const int e = lanes.esize[l];
      for (int j = 0; j < k; ++j) old[j] = tb_load(lanes.band[l], base + j, e);
      for (int p = 0; p < m; ++p) {
        const int32_t t = kept[i * k + p];
        tb_store(lanes.band[l], base + p, e, t < k ? old[t] : tb_load(lanes.src[l], t - k, e));
      }
    }
    for (int p = 0; p < k; ++p) band_valid[base + p] = p < m ? 1 : 0;
    scratch[s] = FO_SENTINEL;
  }
  if (emit[n + i]) {
    const int64_t pos = epos[n + i];
    if (pos >= out_cap) {
      *overflow = 1;
      return;
    }
    const int32_t s = slots[i];
    for (int g = 0; g < keys.n; ++g)
      tb_store(keys.out[g], pos, keys.esize[g], tb_load(keys.lane[g], s, keys.esize[g]));
    out_order[pos] = tb_order(order_col, order_dt, i, 0);
    for (int l = 0; l < lanes.n; ++l)
      tb_store(lanes.out[l], pos, lanes.esize[l], tb_load(lanes.src[l], i, lanes.esize[l]));
    out_ops[pos] = 0;  // INSERT
    out_valid[pos] = 1;
  }
}

template <int KMAX>
static void tb_merge_and_write(const TbKeys& kd, const TbLanes& ld, int64_t n, int k,
                               int64_t out_cap, const int32_t* slots, const uint8_t* fmask,
                               int32_t* scratch, const void* order_col, int order_dt, int desc,
                               long long* band_order, uint8_t* band_valid, const int32_t* cnt,
                               const int32_t* off, const int32_t* lst, int32_t* kept,
                               int32_t* emit, int32_t* epos, int32_t* part, long long* out_order,
                               int32_t* out_ops, uint8_t* out_valid, uint8_t* overflow,
                               cudaStream_t st) {
  const int blocks = rw_blocks(n, TB_THREADS);
  tb_merge_kernel<KMAX><<<blocks, TB_THREADS, 0, st>>>(
      n, k, slots, fmask, cnt, off, lst, order_col, order_dt, desc, band_order, band_valid,
      kept, emit);
  rw_exclusive_scan(emit, 2 * n, part, epos, st);
  tb_write_kernel<KMAX><<<blocks, TB_THREADS, 0, st>>>(
      kd, ld, n, k, out_cap, slots, fmask, scratch, order_col, order_dt, desc, band_order,
      band_valid, kept, emit, epos, out_order, out_ops, out_valid, overflow);
}

// keys: n_keys rows of (table key lane, emission column, esize); lanes:
// n_lanes rows of (band lane, chunk column, emission column, esize); all
// int64. work: int32 scratch of (9 + k) * n + 2 * n / SCAN_TILE + 2 words
// (_kernels band_workspace): gid, cnt, cur, off, lst (n each), emit,
// epos (2n each), kept (n * k), then the scan's partials.
RW_EXPORT int rw_topn_step(const int64_t* keys, int n_keys, const int64_t* lanes, int n_lanes,
                           int64_t n, int k, int64_t cap, int64_t out_cap, const void* slots,
                           const void* fmask, const void* valid, const void* ops,
                           const void* order_col, int order_dt, int desc, void* live,
                           void* sdirty, void* scratch, void* band_order, void* band_valid,
                           void* out_order, void* out_ops, void* out_valid, void* saw_delete,
                           void* dropped, void* overflow, void* work, void* stream) {
  if (n_keys < 0 || n_keys > TB_MAX_KEYS || n_lanes < 0 || n_lanes > TB_MAX_LANES || k < 1 ||
      k > TB_MAX_K || cap < 1 || (order_dt != RW_I32 && order_dt != RW_I64))
    return (int)cudaErrorInvalidValue;
  TbKeys kd;
  kd.n = n_keys;
  for (int g = 0; g < n_keys; ++g) {
    kd.lane[g] = (const void*)keys[3 * g];
    kd.out[g] = (void*)keys[3 * g + 1];
    kd.esize[g] = (int)keys[3 * g + 2];
    if (kd.esize[g] != 1 && kd.esize[g] != 4 && kd.esize[g] != 8)
      return (int)cudaErrorInvalidValue;
  }
  TbLanes ld;
  ld.n = n_lanes;
  for (int l = 0; l < n_lanes; ++l) {
    ld.band[l] = (void*)lanes[4 * l];
    ld.src[l] = (const void*)lanes[4 * l + 1];
    ld.out[l] = (void*)lanes[4 * l + 2];
    ld.esize[l] = (int)lanes[4 * l + 3];
    if (ld.esize[l] != 1 && ld.esize[l] != 4 && ld.esize[l] != 8)
      return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    int32_t* w = (int32_t*)work;
    int32_t* gid = w;
    int32_t* cnt = gid + n;
    int32_t* cur = cnt + n;
    int32_t* off = cur + n;
    int32_t* lst = off + n;
    int32_t* emit = lst + n;
    int32_t* epos = emit + 2 * n;
    int32_t* kept = epos + 2 * n;
    int32_t* part = kept + n * k;
    const int blocks = rw_blocks(n, TB_THREADS);
    const int32_t* sl = (const int32_t*)slots;
    const uint8_t* fm = (const uint8_t*)fmask;
    const uint8_t* vd = (const uint8_t*)valid;
    const int32_t* op = (const int32_t*)ops;
    tb_mark_kernel<<<blocks, TB_THREADS, 0, st>>>(
        n, sl, fm, vd, op, (uint8_t*)live, (uint8_t*)sdirty, (int32_t*)scratch, cnt, cur, emit,
        (uint8_t*)saw_delete, (uint8_t*)dropped);
    tb_count_kernel<<<blocks, TB_THREADS, 0, st>>>(n, sl, vd, op, (const int32_t*)scratch,
                                                   gid, cnt);
    rw_exclusive_scan(cnt, n, part, off, st);
    tb_place_kernel<<<blocks, TB_THREADS, 0, st>>>(n, gid, off, cur, lst);
    if (k <= 16)
      tb_merge_and_write<16>(kd, ld, n, k, out_cap, sl, fm, (int32_t*)scratch, order_col,
                             order_dt, desc, (long long*)band_order, (uint8_t*)band_valid, cnt,
                             off, lst, kept, emit, epos, part, (long long*)out_order,
                             (int32_t*)out_ops, (uint8_t*)out_valid, (uint8_t*)overflow, st);
    else
      tb_merge_and_write<TB_MAX_K>(kd, ld, n, k, out_cap, sl, fm, (int32_t*)scratch, order_col,
                                   order_dt, desc, (long long*)band_order, (uint8_t*)band_valid,
                                   cnt, off, lst, kept, emit, epos, part, (long long*)out_order,
                                   (int32_t*)out_ops, (uint8_t*)out_valid, (uint8_t*)overflow,
                                   st);
  }
  return (int)cudaGetLastError();
}
