// Kernel N: the dynamic max filter's per-chunk decision and fold.
//
// Replaces risingwave_tpu/executors/dynamic_filter.py:filter_step_fn
// (:56) after its lookup_or_insert (kernel A). A row passes iff it is
// valid, positive, and either claimed its group's slot in this call
// (A's `inserted`, which also marks the claimer's same-key twins) or its
// value is >= the group's running max as it stood BEFORE this chunk.
// Inserted slots become live and their max starts again at the value
// type's minimum (a fresh slot may hold a stale max); then the chunk's
// positive rows fold into the max and mark their slot sdirty. A valid
// row with a negative sign latches saw_delete; a valid positive row
// without a slot (MAX_PROBE overflow) latches dropped, passes on the
// comparison with slot 0's max (the reference's max(slots, 0)) and
// folds nothing (the reference's index -1 wraps to the last slot; the
// barrier raises on `dropped` either way).
//
// What bounds it on the card: the chunk's lanes (valid, ops, slots,
// inserted, value, ok out) are read and written coalesced; per row one
// random 8-byte read of its slot's max, per inserted row one 8-byte and
// one 1-byte store, and per positive row one 8-byte atomicMax and a
// 1-byte store, each a 32-byte sector of a table of up to 2^22+ slots.
// At q7's chunks (65,536 rows) both launches are short.
//
// Design: one launch cannot both read the pre-chunk max and atomicMax
// it, so launch 1 decides and resets, launch 2 folds. No row of a reset
// slot reads its max in launch 1 (every row of that slot is inserted),
// so the resets race with no read. 64-bit signed atomicMax is native on
// sm_90. The latches are plain stores of 1.
#include "common.cuh"

template <typename V>
__device__ __forceinline__ V dyn_min();
template <>
__device__ __forceinline__ int32_t dyn_min<int32_t>() { return INT32_MIN; }
template <>
__device__ __forceinline__ int64_t dyn_min<int64_t>() { return INT64_MIN; }

__device__ __forceinline__ void dyn_atomic_max(int32_t* p, int32_t v) { atomicMax((int*)p, (int)v); }
__device__ __forceinline__ void dyn_atomic_max(int64_t* p, int64_t v) {
  atomicMax((long long*)p, (long long)v);
}

__device__ __forceinline__ bool dyn_negative(int32_t op) { return op == 1 || op == 2; }

template <typename V>
__global__ void dyn_decide_kernel(int64_t n, const uint8_t* valid, const int32_t* ops,
                                  const int32_t* slots, const uint8_t* inserted, const V* value,
                                  V* maxes, uint8_t* live, int64_t cap, uint8_t* ok,
                                  uint8_t* saw_delete, uint8_t* dropped) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint8_t pass = 0;
  if (valid[i]) {
    if (dyn_negative(ops[i])) {
      *saw_delete = 1;
    } else {
      const int32_t s = slots[i];
      if (s < 0) {
        *dropped = 1;
        pass = value[i] >= maxes[0];
      } else if (s < cap) {
        if (inserted[i]) {
          pass = 1;
          maxes[s] = dyn_min<V>();
          live[s] = 1;
        } else {
          pass = value[i] >= maxes[s];
        }
      }
    }
  }
  ok[i] = pass;
}

template <typename V>
__global__ void dyn_fold_kernel(int64_t n, const uint8_t* valid, const int32_t* ops,
                                const int32_t* slots, const V* value, V* maxes, uint8_t* sdirty,
                                int64_t cap) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i] || dyn_negative(ops[i])) return;
  const int32_t s = slots[i];
  if (s < 0 || s >= cap) return;
  dyn_atomic_max(maxes + s, value[i]);
  sdirty[s] = 1;
}

template <typename V>
static void dyn_launch(int64_t n, const void* valid, const void* ops, const void* slots,
                       const void* inserted, const void* value, void* maxes, void* live,
                       void* sdirty, int64_t cap, void* ok, void* saw_delete, void* dropped,
                       cudaStream_t st) {
  const int threads = 256;
  dyn_decide_kernel<V><<<rw_blocks(n, threads), threads, 0, st>>>(
      n, (const uint8_t*)valid, (const int32_t*)ops, (const int32_t*)slots,
      (const uint8_t*)inserted, (const V*)value, (V*)maxes, (uint8_t*)live, cap, (uint8_t*)ok,
      (uint8_t*)saw_delete, (uint8_t*)dropped);
  dyn_fold_kernel<V><<<rw_blocks(n, threads), threads, 0, st>>>(
      n, (const uint8_t*)valid, (const int32_t*)ops, (const int32_t*)slots, (const V*)value,
      (V*)maxes, (uint8_t*)sdirty, cap);
}

// valid/inserted/live/sdirty/ok bool, ops/slots int32 (slots and
// inserted from kernel A over valid & sign > 0); value and maxes one
// dtype, value_code RW_I32 or RW_I64; saw_delete and dropped one byte
// each, set (never cleared) by the call.
RW_EXPORT int rw_dyn_filter(int64_t n, const void* valid, const void* ops, const void* slots,
                            const void* inserted, const void* value, int value_code, void* maxes,
                            void* live, void* sdirty, int64_t cap, void* ok, void* saw_delete,
                            void* dropped, void* stream) {
  if (value_code != RW_I32 && value_code != RW_I64) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (value_code == RW_I64)
      dyn_launch<int64_t>(n, valid, ops, slots, inserted, value, maxes, live, sdirty, cap, ok,
                          saw_delete, dropped, st);
    else
      dyn_launch<int32_t>(n, valid, ops, slots, inserted, value, maxes, live, sdirty, cap, ok,
                          saw_delete, dropped, st);
  }
  return (int)cudaGetLastError();
}
