// Kernel Q: the retractable MIN/MAX multiset of a materialized-input
// aggregate call, with its clear and rescatter entries.
//
// Replaces risingwave_tpu/ops/minput.py: minput_apply (:65), minput_clear
// (:172) and minput_rescatter (:179), as risingwave_tpu/executors/
// hash_agg.py:_minput_pass (:82) runs them per chunk (_agg_step_mi :157)
// and per epoch (_agg_epoch_reduced_mi :258). Reference: src/stream/src/
// executor/aggregation/minput.rs.
//
// What rw_minput_apply computes, as the reference: over the active rows
// (slot >= 0, sign != 0, value not NULL), the net signed weight dw of each
// distinct (slot, value) pair; for each pair with dw != 0 its value's lane
// in the group's K lanes (the lowest lane holding it with a count > 0) or,
// for a new value with dw > 0, a lane that was free BEFORE the batch (a
// lane the batch frees is not reused); the new count (old + dw, clamped at
// 0) and value; then for every group with an active row its new extreme
// (the sentinel when no lane is live) into accum[slot] and its live total
// into nonnull[slot]. overflow latches when a group has more new values
// than free lanes; inconsistent when a pair with dw < 0 has no lane or
// drives a count below zero. Lanes: the reference gives a group's j-th new
// value (in value order) its j-th free lane; here the j-th new value to
// reach the group's counter takes it. So the lanes a value lands in may
// differ from the reference's, while each group's multiset of (value,
// count), its extreme, its total and the latches do not.
//
// What bounds it on the card: the rows' slot, sign, value and null bytes
// read once; per distinct pair its group's K lanes read (K * 12 bytes) and
// one lane written; per touched group its K lanes read again and two words
// written. With many rows on few pairs (q5's MAX over per-window counts:
// about 300,000 rows on 2,400 pairs) the pair set's atomics on the same
// addresses bound it instead.
//
// Design (scratch the size of the batch, never of the table):
//   1. init: empty an open-addressing pair set and a group set of H >= 2n
//      entries each;
//   2. insert: one thread per row; an active row finds or claims its pair's
//      entry by CAS of its row index (the entry's key is the claiming row's
//      slot and value, read from the inputs), the rows of one warp with one
//      entry add their signs first (__match_any_sync, __reduce_add_sync) and
//      one of them adds the sum; a pair's claimer appends the entry to the
//      pair list and finds or claims its slot in the group set, whose
//      claimer appends to the group list;
//   3. decide: one warp per listed pair reads its group's K lanes (32 a
//      step, coalesced), finds the value's lane by ballot, or takes a rank
//      from the group's counter and finds the rank-th pre-batch free lane;
//      no lane is written in this launch;
//   4. write: one thread per listed pair writes its lane's count and value;
//   5. reduce: one warp per listed group reduces its K lanes to the extreme
//      and the total and writes accum and nonnull.
#include "hashing.cuh"

#define MI_THREADS 256
#define MI_WARPS (MI_THREADS / 32)
#define MI_MAX_BLOCKS 2048

__device__ __forceinline__ int64_t mi_key(const void* v, int vdt, int64_t i) {
  switch (vdt) {
    case RW_I32: return (int64_t)((const int32_t*)v)[i];
    case RW_I64: return ((const int64_t*)v)[i];
    case RW_F32: return rw_order_key_f32(((const float*)v)[i]);
    case RW_F64: return rw_order_key_f64(((const double*)v)[i]);
  }
  return 0;
}

__device__ __forceinline__ int64_t mi_load(const void* vals, int dt, int64_t i) {
  return dt == RW_I32 ? (int64_t)((const int32_t*)vals)[i] : ((const int64_t*)vals)[i];
}

__device__ __forceinline__ void mi_store(void* vals, int dt, int64_t i, int64_t x) {
  if (dt == RW_I32)
    ((int32_t*)vals)[i] = (int32_t)x;
  else
    ((int64_t*)vals)[i] = x;
}

__device__ __forceinline__ uint32_t mi_hash(int32_t s, int64_t key) {
  const uint32_t hv = rw_mix32((uint32_t)key ^ rw_mix32((uint32_t)((uint64_t)key >> 32)));
  return rw_mix32((uint32_t)s * 0x9E3779B1u ^ hv);
}

struct MiScratch {
  int32_t* pk;     // (H,) pair entry: its claiming row, -1 empty
  int32_t* pnet;   // (H,) net sign sum; after decide, the new count
  int32_t* plane;  // (H,) lane to write, -1 none
  int32_t* pgrp;   // (H,) the pair's group entry
  int32_t* gk;     // (H,) group entry: its slot, -1 empty
  int32_t* gnew;   // (H,) the group's new-value counter
  int32_t* plist;  // (n,) claimed pair entries
  int32_t* glist;  // (n,) claimed group entries
  int32_t* count;  // [pairs, groups]
};

__global__ void mi_init_kernel(MiScratch s, int64_t h_size) {
  for (int64_t h = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; h < h_size;
       h += (int64_t)gridDim.x * blockDim.x) {
    s.pk[h] = -1;
    s.pnet[h] = 0;
    s.gk[h] = -1;
    s.gnew[h] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x < 2) s.count[threadIdx.x] = 0;
}

__global__ void mi_insert_kernel(MiScratch s, int64_t n, const int32_t* slots,
                                 const int32_t* signs, const void* v, int vdt,
                                 const uint8_t* notnull, int64_t h_mask) {
  const int64_t i = (int64_t)blockIdx.x * MI_THREADS + threadIdx.x;
  int32_t h = -1;
  int sg = 0;
  if (i < n) {
    const int32_t slot = slots[i];
    sg = signs[i];
    if (slot >= 0 && sg != 0 && (notnull == nullptr || notnull[i])) {
      const int64_t key = mi_key(v, vdt, i);
      int64_t hh = mi_hash(slot, key) & h_mask;
      for (;;) {  // at most n pairs claim, so an empty entry is always ahead
        const int32_t k = atomicCAS(s.pk + hh, -1, (int32_t)i);
        if (k == -1) {
          s.plist[atomicAdd(s.count, 1)] = (int32_t)hh;
          int64_t gh = rw_mix32((uint32_t)slot) & h_mask;
          for (;;) {
            const int32_t g = atomicCAS(s.gk + gh, -1, slot);
            if (g == -1) {
              s.glist[atomicAdd(s.count + 1, 1)] = (int32_t)gh;
              break;
            }
            if (g == slot) break;
            gh = (gh + 1) & h_mask;
          }
          s.pgrp[hh] = (int32_t)gh;
          break;
        }
        if (slots[k] == slot && mi_key(v, vdt, k) == key) break;
        hh = (hh + 1) & h_mask;
      }
      h = (int32_t)hh;
    }
  }
  // rows of this warp on one entry add their signs first
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, h);
  if (h >= 0) {
    const int sum = __reduce_add_sync(peers, sg);
    if ((int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(s.pnet + h, sum);
  }
}

__global__ void mi_decide_kernel(MiScratch s, const int32_t* slots, const void* v, int vdt,
                                 const void* vals, int vals_dt, const int32_t* cnt, int K,
                                 uint8_t* overflow, uint8_t* inconsistent) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * MI_WARPS;
  const int32_t n_pairs = s.count[0];
  for (int64_t p = (int64_t)blockIdx.x * MI_WARPS + (threadIdx.x >> 5); p < n_pairs;
       p += warps) {
    const int32_t e = s.plist[p];
    const int32_t r = s.pk[e];
    const int64_t base = (int64_t)slots[r] * K;
    const int64_t key = mi_key(v, vdt, r);
    const int32_t dw = s.pnet[e];
    int match = -1;
    for (int l0 = 0; l0 < K; l0 += 32) {
      const int l = l0 + lane;
      const bool m = l < K && cnt[base + l] > 0 && mi_load(vals, vals_dt, base + l) == key;
      const unsigned b = __ballot_sync(0xFFFFFFFFu, m);
      if (b) {
        match = l0 + __ffs(b) - 1;
        break;
      }
    }
    int out = -1;
    int32_t newc = 0;
    if (match >= 0) {
      if (dw != 0) {
        newc = cnt[base + match] + dw;
        if (newc < 0) {
          if (lane == 0) *inconsistent = 1;
          newc = 0;
        }
        out = match;
      }
    } else if (dw < 0) {
      if (lane == 0) *inconsistent = 1;
    } else if (dw > 0) {
      int rank = 0;
      if (lane == 0) rank = atomicAdd(s.gnew + s.pgrp[e], 1);
      rank = __shfl_sync(0xFFFFFFFFu, rank, 0);
      for (int l0 = 0; l0 < K; l0 += 32) {
        const int l = l0 + lane;
        unsigned b = __ballot_sync(0xFFFFFFFFu, l < K && cnt[base + l] == 0);
        const int c = __popc(b);
        if (rank < c) {
          for (int t = 0; t < rank; ++t) b &= b - 1;
          out = l0 + __ffs(b) - 1;
          break;
        }
        rank -= c;
      }
      if (out < 0 && lane == 0) *overflow = 1;
      newc = dw;
    }
    if (lane == 0) {
      s.plane[e] = out;
      s.pnet[e] = newc;
    }
  }
}

__global__ void mi_write_kernel(MiScratch s, const int32_t* slots, const void* v, int vdt,
                                void* vals, int vals_dt, int32_t* cnt, int K) {
  const int32_t n_pairs = s.count[0];
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n_pairs;
       p += (int64_t)gridDim.x * blockDim.x) {
    const int32_t e = s.plist[p];
    const int32_t l = s.plane[e];
    if (l < 0) continue;
    const int32_t r = s.pk[e];
    const int64_t at = (int64_t)slots[r] * K + l;
    cnt[at] = s.pnet[e];
    mi_store(vals, vals_dt, at, mi_key(v, vdt, r));
  }
}

__global__ void mi_reduce_kernel(MiScratch s, const void* vals, int vals_dt, const int32_t* cnt,
                                 int K, int is_max, int64_t sentinel, void* accum,
                                 long long* nonnull) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * MI_WARPS;
  const int32_t n_groups = s.count[1];
  for (int64_t q = (int64_t)blockIdx.x * MI_WARPS + (threadIdx.x >> 5); q < n_groups;
       q += warps) {
    const int32_t slot = s.gk[s.glist[q]];
    const int64_t base = (int64_t)slot * K;
    int64_t ext = sentinel;
    long long total = 0;
    for (int l = lane; l < K; l += 32) {
      const int32_t c = cnt[base + l];
      if (c > 0) {
        const int64_t x = mi_load(vals, vals_dt, base + l);
        ext = is_max ? (x > ext ? x : ext) : (x < ext ? x : ext);
        total += c;
      }
    }
    for (int d = 16; d > 0; d >>= 1) {
      const int64_t y = __shfl_xor_sync(0xFFFFFFFFu, ext, d);
      ext = is_max ? (y > ext ? y : ext) : (y < ext ? y : ext);
      total += __shfl_xor_sync(0xFFFFFFFFu, total, d);
    }
    if (lane == 0) {
      mi_store(accum, vals_dt, slot, ext);
      nonnull[slot] = total;
    }
  }
}

static inline int mi_grid(int64_t units, int per_block) {
  int64_t b = (units + per_block - 1) / per_block;
  if (b < 1) b = 1;
  return (int)(b < MI_MAX_BLOCKS ? b : MI_MAX_BLOCKS);
}

// n rows of slots (int32, -1 skips), signs (int32), v (vdt) and notnull
// (bool, or null: no NULL input); vals (cap, K) in vals_dt (RW_I32 or
// RW_I64) and cnt (cap, K) int32, updated in place; accum (cap,) in
// vals_dt and nonnull (cap,) int64 written at each touched group's slot;
// overflow and inconsistent () bool latches, set, never cleared (may be
// one); sentinel the kind's empty extreme; scratch 6 * h_size + 2 *
// max(n, 1) + 2 int32, h_size a power of two >= 2n.
RW_EXPORT int rw_minput_apply(int64_t n, const void* slots, const void* signs, const void* v,
                              int vdt, const void* notnull, int is_max, void* vals,
                              int vals_dt, void* cnt, int64_t cap, int K, void* accum,
                              void* nonnull, void* overflow, void* inconsistent,
                              int64_t sentinel, void* scratch, int64_t h_size, void* stream) {
  if (n < 0 || n >= ((int64_t)1 << 30) || K < 1 || cap < 0 ||
      (vals_dt != RW_I32 && vals_dt != RW_I64) ||
      (vdt != RW_I32 && vdt != RW_I64 && vdt != RW_F32 && vdt != RW_F64) ||
      h_size < 2 * n || (h_size & (h_size - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  MiScratch s;
  s.pk = (int32_t*)scratch;
  s.pnet = s.pk + h_size;
  s.plane = s.pnet + h_size;
  s.pgrp = s.plane + h_size;
  s.gk = s.pgrp + h_size;
  s.gnew = s.gk + h_size;
  s.plist = s.gnew + h_size;
  s.glist = s.plist + n;
  s.count = s.glist + n;
  const int32_t* sl = (const int32_t*)slots;
  mi_init_kernel<<<mi_grid(h_size, MI_THREADS), MI_THREADS, 0, st>>>(s, h_size);
  mi_insert_kernel<<<(int)((n + MI_THREADS - 1) / MI_THREADS), MI_THREADS, 0, st>>>(
      s, n, sl, (const int32_t*)signs, v, vdt, (const uint8_t*)notnull, h_size - 1);
  mi_decide_kernel<<<mi_grid(n, MI_WARPS), MI_THREADS, 0, st>>>(
      s, sl, v, vdt, vals, vals_dt, (const int32_t*)cnt, K, (uint8_t*)overflow,
      (uint8_t*)inconsistent);
  mi_write_kernel<<<mi_grid(n, MI_THREADS), MI_THREADS, 0, st>>>(s, sl, v, vdt, vals, vals_dt,
                                                                 (int32_t*)cnt, K);
  mi_reduce_kernel<<<mi_grid(n, MI_WARPS), MI_THREADS, 0, st>>>(
      s, vals, vals_dt, (const int32_t*)cnt, K, is_max, sentinel, accum, (long long*)nonnull);
  return (int)cudaGetLastError();
}

__global__ void mi_clear_kernel(int64_t total, const int32_t* slots, int32_t* cnt, int K) {
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int32_t s = slots[t / K];
    if (s >= 0) cnt[(int64_t)s * K + t % K] = 0;
  }
}

// n slots (int32, -1 skips) whose K lanes of cnt ((cap, K) int32) go to 0.
RW_EXPORT int rw_minput_clear(int64_t n, const void* slots, void* cnt, int64_t cap, int K,
                              void* stream) {
  if (n < 0 || K < 1 || cap < 0) return (int)cudaErrorInvalidValue;
  if (n > 0)
    mi_clear_kernel<<<mi_grid(n * K, MI_THREADS), MI_THREADS, 0, (cudaStream_t)stream>>>(
        n * K, (const int32_t*)slots, (int32_t*)cnt, K);
  return (int)cudaGetLastError();
}

__global__ void mi_rescatter_kernel(int64_t total, int K, const uint8_t* keep,
                                    const int32_t* new_slots, const void* vals_src,
                                    void* vals_dst, int vals_esize, const int32_t* cnt_src,
                                    int32_t* cnt_dst) {
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = t / K;
    if (!keep[i]) continue;
    const int32_t s = new_slots[i];
    if (s < 0) continue;
    const int64_t d = (int64_t)s * K + t % K;
    cnt_dst[d] = cnt_src[t];
    if (vals_esize == 4)
      ((uint32_t*)vals_dst)[d] = ((const uint32_t*)vals_src)[t];
    else
      ((unsigned long long*)vals_dst)[d] = ((const unsigned long long*)vals_src)[t];
  }
}

// n old slots: row i of vals ((n, K), 4- or 8-byte lanes) and cnt ((n, K)
// int32) moves to row new_slots[i] of the new arrays (which the caller
// filled: vals with the unwritten-lane value, cnt with 0), iff keep[i] and
// new_slots[i] >= 0.
RW_EXPORT int rw_minput_rescatter(int64_t n, int K, const void* keep, const void* new_slots,
                                  const void* vals_src, void* vals_dst, int vals_esize,
                                  const void* cnt_src, void* cnt_dst, void* stream) {
  if (n < 0 || K < 1 || (vals_esize != 4 && vals_esize != 8)) return (int)cudaErrorInvalidValue;
  if (n > 0)
    mi_rescatter_kernel<<<mi_grid(n * K, MI_THREADS), MI_THREADS, 0, (cudaStream_t)stream>>>(
        n * K, K, (const uint8_t*)keep, (const int32_t*)new_slots, vals_src, vals_dst,
        vals_esize, (const int32_t*)cnt_src, (int32_t*)cnt_dst);
  return (int)cudaGetLastError();
}
