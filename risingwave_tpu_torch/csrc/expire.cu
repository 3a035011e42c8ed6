// Kernel O: watermark state cleaning of a hash table's closed keys.
//
// Replaces the watermark expiries of the reference, each
// `expired = live & (key_lane < cutoff)`, then `live[expired] = False`
// and a per-kind clearing of the expired slots' lanes:
//   rw_expire_keys  risingwave_tpu/executors/dynamic_filter.py:on_watermark
//                   (:329) and executors/dedup.py:on_watermark (:284):
//                   sdirty set;
//   rw_expire_join  ops/join.py:expire_keys (:508): sdirty set, the
//                   slot's fanout row_valid entries cleared, its degrees 0;
//   rw_expire_agg   executors/hash_agg.py:_expire (:393) with
//                   ops/agg.py:_reset_groups (:533): row_count 0, sdirty
//                   set, every accumulator to its kind's init, every
//                   non-null count 0, and dirty = mark_dirty
//                   (delete_groups) or dirty and emitted_valid cleared
//                   (forget_groups).
// Keys and payload bytes stay: a tombstone keeps probe chains intact, and
// the digests mask by live / row_valid.
//
// What bounds it on the card: the live lane is read once, coalesced, over
// the whole table (q7's tables hold 2^22 slots, mostly empty); each live
// slot reads its key (a 32-byte sector when live slots are sparse) and
// each expired slot writes its lanes (a sector per lane, 16 + 64 bytes
// of fanout entries for a join side).
//
// Design: one grid-stride pass over the slots, shared by the three
// entries; each entry only lists the lanes to write at an expired slot
// (pointer, element size, elements per slot, value bits). A slot is
// written by the thread that owns it alone, so nothing is atomic.
#include "common.cuh"

#define EX_MAX_LANES 24

struct ExpireLanes {
  void* ptr[EX_MAX_LANES];
  int esize[EX_MAX_LANES];  // 1, 4 or 8 bytes
  int width[EX_MAX_LANES];  // elements per slot (a join side's fanout)
  int64_t bits[EX_MAX_LANES];  // the value to write, as raw bits
  int n;
};

__global__ void expire_kernel(ExpireLanes lanes, int64_t cap, uint8_t* live, const void* key,
                              int key_code, int64_t cutoff) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; s < cap; s += stride) {
    if (!live[s]) continue;
    const int64_t k = key_code == RW_I64 ? ((const int64_t*)key)[s]
                                         : (int64_t)((const int32_t*)key)[s];
    if (k >= cutoff) continue;
    live[s] = 0;
    for (int l = 0; l < lanes.n; ++l) {
      const int w = lanes.width[l];
      const int64_t base = s * w;
      switch (lanes.esize[l]) {
        case 1:
          for (int j = 0; j < w; ++j) ((uint8_t*)lanes.ptr[l])[base + j] = (uint8_t)lanes.bits[l];
          break;
        case 4:
          for (int j = 0; j < w; ++j)
            ((uint32_t*)lanes.ptr[l])[base + j] = (uint32_t)lanes.bits[l];
          break;
        case 8:
          for (int j = 0; j < w; ++j)
            ((unsigned long long*)lanes.ptr[l])[base + j] = (unsigned long long)lanes.bits[l];
          break;
      }
    }
  }
}

static int expire_launch(const ExpireLanes& lanes, int64_t cap, void* live, const void* key,
                         int key_code, int64_t cutoff, void* stream) {
  if (key_code != RW_I32 && key_code != RW_I64) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < lanes.n; ++l) {
    const int e = lanes.esize[l];
    if ((e != 1 && e != 4 && e != 8) || lanes.width[l] < 1) return (int)cudaErrorInvalidValue;
  }
  if (cap > 0) {
    const int threads = 256;
    int blocks = rw_blocks(cap, threads);
    if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride: 16 blocks per SM
    expire_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        lanes, cap, (uint8_t*)live, key, key_code, cutoff);
  }
  return (int)cudaGetLastError();
}

static void expire_add(ExpireLanes& lanes, void* ptr, int esize, int width, int64_t bits) {
  lanes.ptr[lanes.n] = ptr;
  lanes.esize[lanes.n] = esize;
  lanes.width[lanes.n] = width;
  lanes.bits[lanes.n] = bits;
  lanes.n += 1;
}

// A plain key table (dynamic filter, dedup): live and sdirty bool,
// key an int32 or int64 lane (key_code), all of cap slots.
RW_EXPORT int rw_expire_keys(int64_t cap, void* live, const void* key, int key_code,
                             int64_t cutoff, void* sdirty, void* stream) {
  ExpireLanes lanes;
  lanes.n = 0;
  expire_add(lanes, sdirty, 1, 1, 1);
  return expire_launch(lanes, cap, live, key, key_code, cutoff, stream);
}

// A join side: row_valid bool and degree int32, each (cap, fanout).
RW_EXPORT int rw_expire_join(int64_t cap, void* live, const void* key, int key_code,
                             int64_t cutoff, void* sdirty, void* row_valid, void* degree,
                             int fanout, void* stream) {
  ExpireLanes lanes;
  lanes.n = 0;
  expire_add(lanes, sdirty, 1, 1, 1);
  expire_add(lanes, row_valid, 1, fanout, 0);
  expire_add(lanes, degree, 4, fanout, 0);
  return expire_launch(lanes, cap, live, key, key_code, cutoff, stream);
}

// A HashAgg table: row_count int64, sdirty/dirty/emitted_valid bool;
// acc_rows: n_acc rows of (pointer, element size, init bits), int64, for
// every accumulator and non-null count lane.
RW_EXPORT int rw_expire_agg(int64_t cap, void* live, const void* key, int key_code,
                            int64_t cutoff, void* row_count, void* sdirty, void* dirty,
                            void* emitted_valid, int mark_dirty, const int64_t* acc_rows,
                            int n_acc, void* stream) {
  if (n_acc < 0 || n_acc > EX_MAX_LANES - 4) return (int)cudaErrorInvalidValue;
  ExpireLanes lanes;
  lanes.n = 0;
  expire_add(lanes, row_count, 8, 1, 0);
  expire_add(lanes, sdirty, 1, 1, 1);
  expire_add(lanes, dirty, 1, 1, mark_dirty ? 1 : 0);
  if (!mark_dirty) expire_add(lanes, emitted_valid, 1, 1, 0);
  for (int k = 0; k < n_acc; ++k)
    expire_add(lanes, (void*)acc_rows[3 * k], (int)acc_rows[3 * k + 1], 1, acc_rows[3 * k + 2]);
  return expire_launch(lanes, cap, live, key, key_code, cutoff, stream);
}
