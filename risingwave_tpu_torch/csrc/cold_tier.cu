// Kernel AG: the cold tier's select and merge (K30's cold half).
//
// Replaces the device half of the reference's eviction and merge-on-return:
// - the hot mask, the evicted count and the durable set of
//   risingwave_tpu/executors/hash_agg.py:_evict (:330) and evict_cold
//   (:879-931), and the durable mask of hash_join.py:_evict_side (:617);
// - hash_agg.py:_cold_merge (:1217), the stored state of evicted groups
//   folded into the slots re-created since, and the set_live that
//   _merge_cold (:1013-1017) runs after it.
//
// Two entry points:
//   rw_cold_select: per slot, claimed = fp1 != 0 and
//     agg (mode 0):  durable = claimed & stored & ~sdirty & ~dirty,
//                    hot = (live | ev | dirty | sdirty) & claimed & ~durable,
//                    counted = durable & (live | ev);
//     join (mode 1): durable = claimed & stored & ~sdirty & ~ddirty,
//                    hot = claimed & ~durable, counted = durable.
//     merge (mode 2): durable = the candidates sdirty & ~stored (groups
//                    created since the last checkpoint), counted = durable,
//                    no hot slot.
//     Writes the hot mask (where hot is given), compacts the durable slots
//     in ascending order into sel, and status = [durable, counted, hot] as
//     int64 on the card, read by the host once. (live | ev) & ~hot of the reference is
//     counted: a slot that is not claimed is never live or emitted.
//   rw_cold_merge: for each of n distinct hit slots s and each lane k,
//     dst_k[s] (op) src_k[r]: add (COUNT, SUM, non-null counts, row_count),
//     min or max (MIN/MAX accumulators, float ones on their int64 order
//     keys), set (emitted snapshots, their NULL flags, emitted_valid) or set
//     true (dirty, sdirty, stored); then live[s] = row_count[s] > 0.
//
// What bounds it on the card: the select reads, for every slot, the lanes
// of its mode (agg: the fp1 word and live, ev, dirty, sdirty, stored;
// join: fp1 and sdirty, stored, ddirty; merge: sdirty and stored alone)
// twice (count, then write), writes the hot byte once (count pass) and 4
// bytes per durable slot; the merge reads and writes each hit
// slot's lanes once at random slots (a 32-byte sector per 1- to 8-byte
// access) and reads the packed rows coalesced. Both are bound by bytes.
//
// Design: the select is csrc/compact.cuh's stream compaction, called
// through its kernels so that the count pass alone also writes the hot
// mask and counts hot slots (a warp reduction, one atomic per warp). The
// merge is one thread per hit slot walking every lane in one launch; hit
// slots are distinct, so the reference's .at[idx] updates need no atomics.
#include "compact.cuh"

#define CT_MAX_LANES 40

enum ColdOp : int { CT_SET = 0, CT_ADD = 1, CT_MIN = 2, CT_MAX = 3, CT_TRUE = 4 };

struct ColdMarks {
  int mode;  // 0 agg, 1 join, 2 merge candidates
  const int32_t* fp1;
  const uint8_t* live;
  const uint8_t* ev;      // agg only
  const uint8_t* dirty;   // agg only
  const uint8_t* sdirty;
  const uint8_t* stored;
  const uint8_t* ddirty;  // join, or null
  uint8_t* hot;           // written by the count pass only
  unsigned long long* n_hot;  // status + 2, count pass only
};

__device__ __forceinline__ uint8_t ct_byte(const uint8_t* p, int64_t s) {
  return p != nullptr && p[s] != 0;
}

struct ColdFlags {
  static constexpr bool kAux = true;
  ColdMarks M;
  __device__ int flags(int64_t cap, int64_t base, uint8_t* f, int* aux) const {
    int cnt = 0, counted = 0, hots = 0;
#pragma unroll
    for (int j = 0; j < COMPACT_ITEMS; ++j) {
      const int64_t s = base + j;
      bool durable = false, hot = false, c = false;
      if (s < cap) {
        const bool sd = ct_byte(M.sdirty, s), st = ct_byte(M.stored, s);
        if (M.mode == 0) {
          const bool claimed = M.fp1[s] != 0;
          const bool dt = ct_byte(M.dirty, s);
          const bool alive = ct_byte(M.live, s) || ct_byte(M.ev, s);
          durable = claimed && st && !sd && !dt;
          hot = (alive || dt || sd) && claimed && !durable;
          c = durable && alive;
        } else if (M.mode == 1) {
          const bool claimed = M.fp1[s] != 0;
          durable = claimed && st && !sd && !ct_byte(M.ddirty, s);
          hot = claimed && !durable;
          c = durable;
        } else {
          durable = sd && !st;  // the merge candidates
          c = durable;
        }
        if (M.hot != nullptr) M.hot[s] = hot ? 1 : 0;
      }
      f[j] = durable ? 1 : 0;
      cnt += durable ? 1 : 0;
      counted += c ? 1 : 0;
      hots += hot ? 1 : 0;
    }
    if (M.n_hot != nullptr) {
      const int w = __reduce_add_sync(0xFFFFFFFFu, hots);
      if ((threadIdx.x & 31) == 0 && w) atomicAdd(M.n_hot, (unsigned long long)w);
    }
    *aux = counted;
    return cnt;
  }
  __device__ void on_select(int64_t, uint8_t) const {}
  __device__ void on_total(long long*) const {}
};

// fp1: (cap,) int32; live, sdirty, stored: (cap,) bool; ev, dirty: (cap,)
// bool for mode 0, else null; ddirty: (cap,) bool or null (mode 1). hot:
// (cap,) bool out, or null. tile_counts: ceil(cap / 4096) + 1 int32 scratch. sel:
// (cap,) int32 and payload: (cap,) bytes, their first status[0] entries
// written. status: (3,) int64.
RW_EXPORT int rw_cold_select(int mode, int64_t cap, const void* fp1, const void* live,
                             const void* ev, const void* dirty, const void* sdirty,
                             const void* stored, const void* ddirty, void* hot,
                             void* tile_counts, void* sel, void* payload, void* status,
                             void* stream) {
  if (mode < 0 || mode > 2 || cap < 0) return (int)cudaErrorInvalidValue;
  if (mode == 0 && (ev == nullptr || dirty == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  long long* stat = (long long*)status;
  cudaMemsetAsync(stat, 0, 3 * sizeof(long long), st);
  if (cap == 0) return (int)cudaGetLastError();
  ColdMarks M{mode, (const int32_t*)fp1, (const uint8_t*)live, (const uint8_t*)ev,
              (const uint8_t*)dirty, (const uint8_t*)sdirty, (const uint8_t*)stored,
              (const uint8_t*)ddirty, (uint8_t*)hot, (unsigned long long*)(stat + 2)};
  const ColdFlags count_fn{M};
  ColdMarks W = M;
  W.hot = nullptr;
  W.n_hot = nullptr;
  const ColdFlags write_fn{W};
  const int tiles = compact_tiles(cap);
  int32_t* part = (int32_t*)tile_counts;
  compact_count_kernel<<<tiles, COMPACT_THREADS, 0, st>>>(count_fn, cap, part,
                                                          (unsigned long long*)stat);
  scan_top_kernel<<<1, SCAN_TOP_THREADS, 0, st>>>(part, tiles);
  compact_write_kernel<<<tiles, COMPACT_THREADS, 0, st>>>(write_fn, cap, part, tiles,
                                                          (int32_t*)sel, (uint8_t*)payload, stat);
  return (int)cudaGetLastError();
}

struct MergeLanes {
  void* dst[CT_MAX_LANES];        // (cap,) state lane
  const void* src[CT_MAX_LANES];  // (n,) stored rows, or null for CT_TRUE
  int op[CT_MAX_LANES];
  int dtype[CT_MAX_LANES];        // RwDType
  int n;
};

template <class T>
__device__ __forceinline__ void ct_fold(T* d, T v, int op) {
  switch (op) {
    case CT_ADD: *d = *d + v; break;
    case CT_MIN: *d = v < *d ? v : *d; break;
    case CT_MAX: *d = v > *d ? v : *d; break;
    default: *d = v; break;
  }
}

__global__ void cold_merge_kernel(MergeLanes L, const int32_t* slots, int64_t n,
                                  const int64_t* row_count, uint8_t* live) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int64_t s = slots[r];
  for (int k = 0; k < L.n; ++k) {
    const int op = L.op[k];
    if (op == CT_TRUE) {
      ((uint8_t*)L.dst[k])[s] = 1;
      continue;
    }
    switch (L.dtype[k]) {
      case RW_BOOL: ((uint8_t*)L.dst[k])[s] = ((const uint8_t*)L.src[k])[r]; break;
      case RW_I32: ct_fold((int32_t*)L.dst[k] + s, ((const int32_t*)L.src[k])[r], op); break;
      case RW_I64:
        ct_fold((long long*)L.dst[k] + s, ((const long long*)L.src[k])[r], op);
        break;
      case RW_F32: ct_fold((float*)L.dst[k] + s, ((const float*)L.src[k])[r], op); break;
      case RW_F64: ct_fold((double*)L.dst[k] + s, ((const double*)L.src[k])[r], op); break;
    }
  }
  live[s] = row_count[s] > 0 ? 1 : 0;
}

// lanes: n_lanes rows of (dst, src, op, dtype), int64; bool lanes take
// CT_SET or CT_TRUE only. slots: (n,) int32, distinct and >= 0. row_count
// (int64) and live (bool): the state's (cap,) lanes, row_count among the
// folded lanes.
RW_EXPORT int rw_cold_merge(const int64_t* lanes, int n_lanes, const void* slots, int64_t n,
                            const void* row_count, void* live, void* stream) {
  if (n_lanes < 0 || n_lanes > CT_MAX_LANES || n < 0 || row_count == nullptr ||
      live == nullptr)
    return (int)cudaErrorInvalidValue;
  MergeLanes L;
  L.n = n_lanes;
  for (int k = 0; k < n_lanes; ++k) {
    L.dst[k] = (void*)lanes[4 * k];
    L.src[k] = (const void*)lanes[4 * k + 1];
    L.op[k] = (int)lanes[4 * k + 2];
    L.dtype[k] = (int)lanes[4 * k + 3];
    if (L.op[k] < CT_SET || L.op[k] > CT_TRUE || L.dtype[k] < RW_BOOL || L.dtype[k] > RW_F64)
      return (int)cudaErrorInvalidValue;
    if (L.dtype[k] == RW_BOOL && L.op[k] != CT_SET && L.op[k] != CT_TRUE)
      return (int)cudaErrorInvalidValue;
    if (L.op[k] != CT_TRUE && L.src[k] == nullptr) return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    const int threads = 256;
    cold_merge_kernel<<<rw_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
        L, (const int32_t*)slots, n, (const int64_t*)row_count, (uint8_t*)live);
  }
  return (int)cudaGetLastError();
}
