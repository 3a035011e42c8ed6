// Kernel L: fold one chunk into its own join side, and move a side's
// bucket entries when it is rebuilt.
//
// Replaces risingwave_tpu/ops/join.py:apply_side (:215) after its
// lookup_or_insert on the join key (kernel A), with _intra_chunk_rank
// (:141), _row_fingerprint (:178, K1 inside) and _entry_matches (:192);
// and the bucket half of regrow (:458) as rw_join_regrow.
//
// What it computes, exactly as the reference (the positions matter: the
// join-side digest folds each bucket's entries in position order):
//   - every touching row (valid, sign != 0) marks its slot sdirty; one
//     without a slot latches overflow;
//   - an inserting row takes the (rank+1)-th free position of its
//     bucket as it was before the chunk, rank = the number of earlier
//     inserting rows of the chunk with the same slot; no such position
//     latches overflow. It writes the payload and null lanes, sets
//     row_valid and seeds the degree with init_degree[row] (the row's
//     match count on the other side, kernel M's mc; outer, semi and anti
//     joins), or 0 without it (:289-299);
//   - then a deleting row clears the (rank+1)-th entry of its bucket
//     that equals it exactly (NaN == NaN, NULL == NULL), rank = the
//     number of earlier deleting rows with the same slot and the same
//     payload fingerprint (hash128 of the payload lanes, values zeroed
//     under NULL); no such entry latches inconsistent. Inserts land
//     first, so an insert and a delete of one row in a chunk net out;
//   - every touched slot's live becomes any(row_valid) of its bucket.
//
// What bounds it on the card: per touching row, a bucket of fanout
// entries read at random (row_valid, and for a delete every payload
// lane), a few scattered stores (sdirty, the entry's lanes, live) and
// at most fanout + 1 atomics on its group's entry (below); the chunk's
// lanes are read coalesced. At q8's 32,768- and 65,536-row chunks that
// is a few MB: the seven launches are short, and launch overhead is a
// good part of them.
//
// Design: the reference ranks with a stable sort. Here the ranks come
// from a per-call open-addressing table of groups: (slot, insert) for
// inserting rows, (slot, delete, fingerprint) for deleting rows, with
// G >= 2n entries (a power of two), each an owner row (-1: empty) and
// a list of fanout row indices (INT_MAX: empty). Launch 1 empties the
// table, marks sdirty and fingerprints the deletes. Launch 2: each
// touching row claims its group's entry with a CAS on the owner or
// finds it (the owner's slot, kind and fingerprint equal its own), then
// pushes its row index down the group's list with atomicMin, carrying
// the larger of the two values on, until it fills an empty place or
// leaves the list. Every value passes place 0, every value but the
// least passes place 1, and so on: after the launch place p holds the
// (p+1)-th earliest row of the group, whatever the order the atomics
// ran in. A row's rank is its place in the list, or fanout when it is
// not there: past fanout the outcome (overflow, or inconsistent) no
// longer changes. That is O(n * fanout) work whatever the keys; rows
// of one hot group serialise on its fanout words. Positions are chosen
// against the bucket as it was (launch 3) before any insert is written
// (launch 4), and deletes choose (launch 5) after every insert and
// before any entry is cleared (launch 6); launch 7 sets liveness.
#include <climits>

#include "hashing.cuh"

#define JA_MAX_PAY 8
#define JA_EMPTY INT_MAX

struct PayLanes {
  const void* src[JA_MAX_PAY];      // (n,) chunk payload lane
  const uint8_t* src_null[JA_MAX_PAY];  // (n,) chunk null lane, or null
  int dt[JA_MAX_PAY];
  void* dst[JA_MAX_PAY];            // (cap * fanout,) bucket lane, same dtype
  uint8_t* dst_null[JA_MAX_PAY];    // (cap * fanout,) bucket null lane, or null
  int n;
};

// 0: no-op row; 1: insert; 2: delete
__device__ __forceinline__ int ja_kind(const uint8_t* valid, const int32_t* ops, int64_t i) {
  if (!valid[i]) return 0;
  const int32_t op = ops[i];
  return (op == 1 || op == 2) ? 2 : 1;
}

__device__ __forceinline__ int ja_esize(int dt) {
  return dt == RW_BOOL ? 1 : (dt == RW_I32 || dt == RW_F32) ? 4 : 8;
}

// Launch over max(n, n_groups * fanout) threads.
__global__ void ja_prep_kernel(PayLanes P, int64_t n, const uint8_t* valid, const int32_t* ops,
                               const int32_t* slots, uint8_t* sdirty, uint8_t* overflow,
                               uint32_t* fps, int32_t* grp, int32_t* target, int32_t* owner,
                               int32_t* first, int64_t n_groups, int fanout) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_groups) owner[i] = -1;
  if (i < n_groups * fanout) first[i] = JA_EMPTY;
  if (i >= n) return;
  grp[i] = -1;
  target[i] = -1;
  const int kind = ja_kind(valid, ops, i);
  if (kind == 0) return;
  const int32_t s = slots[i];
  if (s < 0) {
    *overflow = 1;
    return;
  }
  sdirty[s] = 1;
  if (kind == 2) {  // the payload fingerprint (ops/join.py:_row_fingerprint)
    uint32_t a = RW_HASH_INIT, b = RW_HASH_INIT ^ RW_SEED_FP2;
    for (int l = 0; l < P.n; ++l) {
      const uint8_t* nl = P.src_null[l];
      if (nl != nullptr) {
        const bool is_null = nl[i] != 0;
        rw_fold2(is_null ? 1u : 0u, a, b);
        if (is_null) {  // the value lane zeroed under NULL
          rw_fold2(0u, a, b);
          if (ja_esize(P.dt[l]) == 8) rw_fold2(0u, a, b);
          continue;
        }
      }
      rw_hash_lane(P.src[l], P.dt[l], i, a, b);
    }
    fps[2 * i] = rw_mix32(a);
    fps[2 * i + 1] = rw_mix32(b);
  }
}

__device__ __forceinline__ bool ja_same_group(const uint8_t* valid, const int32_t* ops,
                                              const int32_t* slots, const uint32_t* fps,
                                              int64_t i, int64_t j, int kind) {
  if (slots[j] != slots[i] || ja_kind(valid, ops, j) != kind) return false;
  return kind == 1 || (fps[2 * j] == fps[2 * i] && fps[2 * j + 1] == fps[2 * i + 1]);
}

__global__ void ja_group_kernel(int64_t n, const uint8_t* valid, const int32_t* ops,
                                const int32_t* slots, const uint32_t* fps, int32_t* owner,
                                int32_t* first, int64_t n_groups, int fanout, int32_t* grp) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int kind = ja_kind(valid, ops, i);
  const int32_t s = slots[i];
  if (kind == 0 || s < 0) return;
  uint32_t h = rw_mix32((uint32_t)s * 2u + (uint32_t)(kind - 1));
  if (kind == 2) h = rw_combine(rw_combine(h, fps[2 * i]), fps[2 * i + 1]);
  const int64_t mask = n_groups - 1;
  int64_t g = h & mask;
  for (;;) {  // at most n rows claim, so an empty entry is always ahead
    const int32_t o = atomicCAS(owner + g, -1, (int32_t)i);
    if (o == -1 || ja_same_group(valid, ops, slots, fps, i, o, kind)) break;
    g = (g + 1) & mask;
  }
  grp[i] = (int32_t)g;
  int32_t* list = first + g * fanout;
  int32_t v = (int32_t)i;
  for (int p = 0; p < fanout; ++p) {
    const int32_t old = atomicMin(list + p, v);
    if (old == JA_EMPTY) break;
    v = max(v, old);
  }
}

// The row's rank within its group, capped at fanout.
__device__ __forceinline__ int ja_rank(const int32_t* first, const int32_t* grp, int fanout,
                                       int64_t i) {
  const int32_t* list = first + (int64_t)grp[i] * fanout;
  for (int p = 0; p < fanout; ++p)
    if (list[p] == (int32_t)i) return p;
  return fanout;
}

__global__ void ja_place_kernel(int64_t n, const uint8_t* valid, const int32_t* ops,
                                const int32_t* slots, const int32_t* first, const int32_t* grp,
                                const uint8_t* row_valid, int fanout, int32_t* target,
                                uint8_t* overflow) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || ja_kind(valid, ops, i) != 1) return;
  const int64_t s = slots[i];
  if (s < 0) return;
  int free_seen = 0;
  const int want = ja_rank(first, grp, fanout, i);
  for (int j = 0; j < fanout; ++j) {
    if (row_valid[s * fanout + j]) continue;
    if (free_seen == want) {
      target[i] = (int32_t)(s * fanout + j);
      return;
    }
    ++free_seen;
  }
  *overflow = 1;
}

__global__ void ja_insert_kernel(PayLanes P, int64_t n, const uint8_t* valid, const int32_t* ops,
                                 const int32_t* target, uint8_t* row_valid, int32_t* degree,
                                 const int32_t* init_degree) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || ja_kind(valid, ops, i) != 1) return;
  const int64_t t = target[i];
  if (t < 0) return;
  for (int l = 0; l < P.n; ++l) {
    switch (ja_esize(P.dt[l])) {
      case 1: ((uint8_t*)P.dst[l])[t] = ((const uint8_t*)P.src[l])[i]; break;
      case 4: ((uint32_t*)P.dst[l])[t] = ((const uint32_t*)P.src[l])[i]; break;
      default:
        ((unsigned long long*)P.dst[l])[t] = ((const unsigned long long*)P.src[l])[i];
        break;
    }
    if (P.dst_null[l] != nullptr)
      P.dst_null[l][t] = P.src_null[l] != nullptr && P.src_null[l][i] ? 1 : 0;
  }
  row_valid[t] = 1;
  degree[t] = init_degree != nullptr ? init_degree[i] : 0;
}

__device__ __forceinline__ bool ja_value_equal(const void* stored, const void* val, int dt,
                                               int64_t e, int64_t i) {
  switch (dt) {
    case RW_BOOL: return (((const uint8_t*)stored)[e] != 0) == (((const uint8_t*)val)[i] != 0);
    case RW_I32: return ((const int32_t*)stored)[e] == ((const int32_t*)val)[i];
    case RW_I64: return ((const long long*)stored)[e] == ((const long long*)val)[i];
    case RW_F32: {
      const float a = ((const float*)stored)[e], b = ((const float*)val)[i];
      return a == b || (isnan(a) && isnan(b));
    }
    case RW_F64: {
      const double a = ((const double*)stored)[e], b = ((const double*)val)[i];
      return a == b || (isnan(a) && isnan(b));
    }
  }
  return false;
}

__global__ void ja_select_delete_kernel(PayLanes P, int64_t n, const uint8_t* valid,
                                        const int32_t* ops, const int32_t* slots,
                                        const int32_t* first, const int32_t* grp,
                                        const uint8_t* row_valid, int fanout, int32_t* target,
                                        uint8_t* inconsistent) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || ja_kind(valid, ops, i) != 2) return;
  const int64_t s = slots[i];
  if (s < 0) return;
  int seen = 0;
  const int want = ja_rank(first, grp, fanout, i);
  for (int j = 0; j < fanout; ++j) {
    const int64_t e = s * fanout + j;
    if (!row_valid[e]) continue;
    bool ok = true;
    for (int l = 0; l < P.n && ok; ++l) {
      bool eq = ja_value_equal(P.dst[l], P.src[l], P.dt[l], e, i);
      if (P.dst_null[l] != nullptr) {
        const bool sn = P.dst_null[l][e] != 0;
        const bool rn = P.src_null[l] != nullptr && P.src_null[l][i] != 0;
        if (sn || rn) eq = sn == rn;
      }
      ok = eq;
    }
    if (!ok) continue;
    if (seen == want) {
      target[i] = (int32_t)e;
      return;
    }
    ++seen;
  }
  *inconsistent = 1;
}

__global__ void ja_delete_kernel(int64_t n, const uint8_t* valid, const int32_t* ops,
                                 const int32_t* target, uint8_t* row_valid, int32_t* degree) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || ja_kind(valid, ops, i) != 2) return;
  const int64_t t = target[i];
  if (t < 0) return;
  row_valid[t] = 0;
  degree[t] = 0;
}

__global__ void ja_live_kernel(int64_t n, const uint8_t* valid, const int32_t* slots,
                               const uint8_t* row_valid, int fanout, uint8_t* live) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const int64_t s = slots[i];
  if (s < 0) return;
  bool any = false;
  for (int j = 0; j < fanout; ++j) any |= row_valid[s * fanout + j] != 0;
  live[s] = any ? 1 : 0;  // every row of the slot writes the same value
}

// pay: n_pay rows of (src, src_null or 0, dtype code, dst, dst_null or
// 0), int64, in the side's payload-name order; init_degree: (n,) int32
// or null; valid/ops: the chunk's
// touching rows and ops; slots: kernel A's over valid; fps (2n uint32),
// grp and target (n int32), owner (n_groups int32) and first
// (n_groups * fanout int32): scratch, n_groups a power of two >= 2n.
RW_EXPORT int rw_join_apply(const int64_t* pay, int n_pay, int64_t n, const void* valid,
                            const void* ops, const void* slots, int fanout, void* row_valid,
                            void* degree, const void* init_degree, void* live, void* sdirty, void* overflow,
                            void* inconsistent, void* fps, void* grp, void* target, void* owner,
                            void* first, int64_t n_groups, void* stream) {
  if (n_pay < 0 || n_pay > JA_MAX_PAY || fanout < 1 || n_groups < 2 * n ||
      (n_groups & (n_groups - 1)) != 0 || n_groups * fanout >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  PayLanes P;
  P.n = n_pay;
  for (int l = 0; l < n_pay; ++l) {
    const int64_t* r = pay + 5 * l;
    P.src[l] = (const void*)r[0];
    P.src_null[l] = (const uint8_t*)r[1];
    P.dt[l] = (int)r[2];
    P.dst[l] = (void*)r[3];
    P.dst_null[l] = (uint8_t*)r[4];
  }
  if (n == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const int blocks = rw_blocks(n, threads);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* v = (const uint8_t*)valid;
  const int32_t* o = (const int32_t*)ops;
  const int32_t* sl = (const int32_t*)slots;
  const uint32_t* fp = (const uint32_t*)fps;
  uint8_t* rv = (uint8_t*)row_valid;
  int32_t* tg = (int32_t*)target;
  int32_t* gr = (int32_t*)grp;
  int32_t* ow = (int32_t*)owner;
  int32_t* fi = (int32_t*)first;
  ja_prep_kernel<<<rw_blocks(n_groups * fanout, threads), threads, 0, st>>>(
      P, n, v, o, sl, (uint8_t*)sdirty, (uint8_t*)overflow, (uint32_t*)fps, gr, tg, ow, fi,
      n_groups, fanout);
  ja_group_kernel<<<blocks, threads, 0, st>>>(n, v, o, sl, fp, ow, fi, n_groups, fanout, gr);
  ja_place_kernel<<<blocks, threads, 0, st>>>(n, v, o, sl, fi, gr, rv, fanout, tg,
                                              (uint8_t*)overflow);
  ja_insert_kernel<<<blocks, threads, 0, st>>>(P, n, v, o, tg, rv, (int32_t*)degree,
                                               (const int32_t*)init_degree);
  ja_select_delete_kernel<<<blocks, threads, 0, st>>>(P, n, v, o, sl, fi, gr, rv, fanout, tg,
                                                      (uint8_t*)inconsistent);
  ja_delete_kernel<<<blocks, threads, 0, st>>>(n, v, o, tg, rv, (int32_t*)degree);
  ja_live_kernel<<<blocks, threads, 0, st>>>(n, v, sl, rv, fanout, (uint8_t*)live);
  return (int)cudaGetLastError();
}

// ---- regrow: each kept old slot's live entries, in position order, to
// the front of its new bucket (at most new_fanout of them) -------------------
#define JR_MAX_LANES 16

struct EntryLanes {
  const void* src[JR_MAX_LANES];  // (cap * fanout,) old bucket lanes
  void* dst[JR_MAX_LANES];        // (new_cap * new_fanout,) new bucket lanes
  int esize[JR_MAX_LANES];
  int n;
};

__global__ void ja_regrow_kernel(EntryLanes L, int64_t cap, int fanout, int new_fanout,
                                 const uint8_t* keep, const int32_t* new_slots,
                                 const uint8_t* row_valid, uint8_t* new_row_valid) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap || !keep[i]) return;
  const int64_t ns = new_slots[i];
  if (ns < 0) return;
  int p = 0;
  for (int j = 0; j < fanout && p < new_fanout; ++j) {
    const int64_t e = i * fanout + j;
    if (!row_valid[e]) continue;
    const int64_t d = ns * new_fanout + p;
    for (int k = 0; k < L.n; ++k) {
      switch (L.esize[k]) {
        case 1: ((uint8_t*)L.dst[k])[d] = ((const uint8_t*)L.src[k])[e]; break;
        case 4: ((uint32_t*)L.dst[k])[d] = ((const uint32_t*)L.src[k])[e]; break;
        case 8:
          ((unsigned long long*)L.dst[k])[d] = ((const unsigned long long*)L.src[k])[e];
          break;
      }
    }
    new_row_valid[d] = 1;
    ++p;
  }
}

// lanes: n_lanes rows of (src, dst, esize), int64; keep (cap,) bool and
// new_slots (cap,) int32 from kernel A's re-insert of the kept keys; the
// new lanes zero-filled by the caller.
RW_EXPORT int rw_join_regrow(const int64_t* lanes, int n_lanes, int64_t cap, int fanout,
                             int new_fanout, const void* keep, const void* new_slots,
                             const void* row_valid, void* new_row_valid, void* stream) {
  if (n_lanes < 0 || n_lanes > JR_MAX_LANES || fanout < 1 || new_fanout < 1)
    return (int)cudaErrorInvalidValue;
  EntryLanes L;
  L.n = n_lanes;
  for (int k = 0; k < n_lanes; ++k) {
    L.src[k] = (const void*)lanes[3 * k];
    L.dst[k] = (void*)lanes[3 * k + 1];
    L.esize[k] = (int)lanes[3 * k + 2];
    if (L.esize[k] != 1 && L.esize[k] != 4 && L.esize[k] != 8) return (int)cudaErrorInvalidValue;
  }
  if (cap > 0) {
    const int threads = 256;
    ja_regrow_kernel<<<rw_blocks(cap, threads), threads, 0, (cudaStream_t)stream>>>(
        L, cap, fanout, new_fanout, (const uint8_t*)keep, (const int32_t*)new_slots,
        (const uint8_t*)row_valid, (uint8_t*)new_row_valid);
  }
  return (int)cudaGetLastError();
}
