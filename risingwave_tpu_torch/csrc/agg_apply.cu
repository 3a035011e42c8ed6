// Kernel B: fold one chunk's rows into the slot-indexed aggregation state.
//
// Replaces risingwave_tpu/ops/agg.py:apply (:257) and the set_live that
// follows it in risingwave_tpu/executors/hash_agg.py:agg_step_fn (:135).
//
// What bounds it on the card: per active row, one random 8-byte atomic
// read-modify-write on row_count plus one per aggregate call (and one
// more on the non-null counter for SUM/MIN/MAX), and 1-byte stores to
// dirty/sdirty, all at the row's slot in tables of up to 2^24+ slots.
// The row-side lanes (slots, signs, values, nulls) are read coalesced.
//
// Design: one thread per row. COUNT(*), COUNT, SUM and the non-null
// counters are 64-bit atomicAdd (float SUMs use float atomicAdd, so
// their order of additions is not the reference's); append-only MIN/MAX
// are atomicMin/atomicMax on int64 (or int32) lanes, with float inputs
// mapped to their total-order key (ops/agg.py:112, common.cuh) so NaN
// orders above everything and one NaN cannot poison a group. A
// retraction that reaches a MIN/MAX call latches minmax_retracted.
// Liveness (live = row_count > 0) needs every add of the chunk to have
// landed, so it is a second launch from this file (rw_agg_set_live).
#include "common.cuh"

#define RW_MAX_CALLS 8

enum AggKind : int { K_COUNT_STAR = 0, K_COUNT = 1, K_SUM = 2, K_MIN = 3, K_MAX = 4 };

struct AggCallLanes {
  int kind[RW_MAX_CALLS];
  int vdt[RW_MAX_CALLS];            // input dtype code
  int adt[RW_MAX_CALLS];            // accumulator dtype code
  const void* val[RW_MAX_CALLS];    // (n,) input lane or null
  const uint8_t* nul[RW_MAX_CALLS]; // (n,) input null lane or null
  void* acc[RW_MAX_CALLS];          // (cap,) accumulator
  long long* nonnull[RW_MAX_CALLS]; // (cap,) non-null counter or null
  int n;
};

__device__ __forceinline__ long long rw_load_i64(const void* p, int dt, int64_t i) {
  switch (dt) {
    case RW_BOOL: return ((const uint8_t*)p)[i] ? 1 : 0;
    case RW_I32: return ((const int32_t*)p)[i];
    case RW_I64: return ((const long long*)p)[i];
  }
  return 0;
}

__device__ __forceinline__ double rw_load_f64(const void* p, int dt, int64_t i) {
  return dt == RW_F32 ? (double)((const float*)p)[i] : ((const double*)p)[i];
}

// MIN/MAX input -> the value stored in the accumulator lane.
__device__ __forceinline__ long long rw_extreme_key(const void* p, int dt, int64_t i) {
  if (dt == RW_F32) return rw_order_key_f32(((const float*)p)[i]);
  if (dt == RW_F64) return rw_order_key_f64(((const double*)p)[i]);
  return rw_load_i64(p, dt, i);
}

__global__ void agg_apply_kernel(AggCallLanes calls, int64_t n, const int32_t* slots,
                                 const int32_t* signs, long long* row_count, uint8_t* dirty,
                                 uint8_t* sdirty, uint8_t* minmax_retracted) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t s = slots[i];
  const int32_t w = signs[i];
  if (s < 0 || w == 0) return;
  const long long w64 = (long long)w;
  atomicAdd((unsigned long long*)(row_count + s), (unsigned long long)w64);
  dirty[s] = 1;
  sdirty[s] = 1;
  for (int c = 0; c < calls.n; ++c) {
    const int kind = calls.kind[c];
    if (kind == K_COUNT_STAR) {
      atomicAdd((unsigned long long*)calls.acc[c] + s, (unsigned long long)w64);
      continue;
    }
    const bool notnull = calls.nul[c] == nullptr || !calls.nul[c][i];
    if (!notnull) continue;
    if (kind == K_COUNT) {
      atomicAdd((unsigned long long*)calls.acc[c] + s, (unsigned long long)w64);
    } else if (kind == K_SUM) {
      switch (calls.adt[c]) {
        case RW_I64:
          atomicAdd((unsigned long long*)calls.acc[c] + s,
                    (unsigned long long)(rw_load_i64(calls.val[c], calls.vdt[c], i) * w64));
          break;
        case RW_F32:
          atomicAdd((float*)calls.acc[c] + s,
                    ((const float*)calls.val[c])[i] * (float)w);
          break;
        case RW_F64:
          atomicAdd((double*)calls.acc[c] + s,
                    rw_load_f64(calls.val[c], calls.vdt[c], i) * (double)w);
          break;
      }
      atomicAdd((unsigned long long*)calls.nonnull[c] + s, (unsigned long long)w64);
    } else {  // K_MIN / K_MAX, append-only
      if (w < 0) {
        *minmax_retracted = 1;
        continue;
      }
      const long long key = rw_extreme_key(calls.val[c], calls.vdt[c], i);
      if (calls.adt[c] == RW_I32) {
        int* a = (int*)calls.acc[c] + s;
        if (kind == K_MIN) atomicMin(a, (int)key);
        else atomicMax(a, (int)key);
      } else {
        long long* a = (long long*)calls.acc[c] + s;
        if (kind == K_MIN) atomicMin(a, key);
        else atomicMax(a, key);
      }
      atomicAdd((unsigned long long*)calls.nonnull[c] + s, 1ull);
    }
  }
}

__global__ void agg_set_live_kernel(int64_t n, const int32_t* slots,
                                    const long long* row_count, uint8_t* live) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t s = slots[i];
  if (s >= 0) live[s] = row_count[s] > 0 ? 1 : 0;
}

// calls: n_calls rows of (kind, vdt, adt, val, nul, acc, nonnull), int64.
RW_EXPORT int rw_agg_apply(const int64_t* calls, int n_calls, int64_t n, const void* slots,
                           const void* signs, void* row_count, void* dirty, void* sdirty,
                           void* minmax_retracted, void* stream) {
  if (n_calls < 0 || n_calls > RW_MAX_CALLS) return (int)cudaErrorInvalidValue;
  AggCallLanes c;
  c.n = n_calls;
  for (int k = 0; k < n_calls; ++k) {
    const int64_t* r = calls + 7 * k;
    c.kind[k] = (int)r[0];
    c.vdt[k] = (int)r[1];
    c.adt[k] = (int)r[2];
    c.val[k] = (const void*)r[3];
    c.nul[k] = (const uint8_t*)r[4];
    c.acc[k] = (void*)r[5];
    c.nonnull[k] = (long long*)r[6];
  }
  if (n > 0) {
    const int threads = 256;
    agg_apply_kernel<<<rw_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
        c, n, (const int32_t*)slots, (const int32_t*)signs, (long long*)row_count,
        (uint8_t*)dirty, (uint8_t*)sdirty, (uint8_t*)minmax_retracted);
  }
  return (int)cudaGetLastError();
}

RW_EXPORT int rw_agg_set_live(int64_t n, const void* slots, const void* row_count,
                              void* live, void* stream) {
  if (n > 0) {
    const int threads = 256;
    agg_set_live_kernel<<<rw_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
        n, (const int32_t*)slots, (const long long*)row_count, (uint8_t*)live);
  }
  return (int)cudaGetLastError();
}
