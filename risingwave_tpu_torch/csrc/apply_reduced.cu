// Kernel G: scatter an epoch's per-key reductions into the aggregation
// state.
//
// Replaces risingwave_tpu/ops/agg.py:apply_reduced (:464) and the
// set_live that follows it in risingwave_tpu/executors/hash_agg.py
// (_epoch_reduced_fn, :228-232). For each representative row of
// reduce_by_key (rep_valid, slot >= 0): row_count and COUNT(*) += w,
// COUNT += cnt, SUM += sum and its non-null counter += nn, append-only
// MIN/MAX fold ext and count nnp; dirty and sdirty are set; the
// minmax_retracted latch ORs in reduce_by_key's. Rows that are not
// representatives, or have no slot, write nothing.
//
// What bounds it on the card: one random 8-byte atomic per active lane
// at each representative's slot (row_count plus one or two per call),
// plus byte stores to dirty/sdirty/live, in tables of up to 2^24+
// slots; the representative lanes are read coalesced. Only one row in
// about ten to twenty is a representative on q5's epochs.
//
// Design: one thread per row, atomics as kernel B uses them. Two
// representatives can share a slot (a visible key whose fingerprints
// are both 0xFFFFFFFF sorts among the invisible rows and splits), so
// every update must accumulate. Float SUMs add with float atomics, in
// no fixed order. Liveness needs every add to have landed, so it is a
// second launch from this file.
#include "common.cuh"

#define AR_MAX_CALLS 16

enum ArKind : int { AR_COUNT_STAR = 0, AR_COUNT = 1, AR_SUM = 2, AR_MIN = 3, AR_MAX = 4 };

struct ReducedCalls {
  int kind[AR_MAX_CALLS];
  int adt[AR_MAX_CALLS];               // accumulator dtype code
  void* acc[AR_MAX_CALLS];             // (cap,) accumulator
  const void* red[AR_MAX_CALLS];       // (n,) cnt_/sum_/ext_ lane, accumulator dtype
  long long* nonnull[AR_MAX_CALLS];    // (cap,) non-null counter or null
  const long long* nn_red[AR_MAX_CALLS];  // (n,) nn_/nnp_ lane or null
  int n;
};

__global__ void apply_reduced_kernel(ReducedCalls calls, int64_t n, const int32_t* slots,
                                     const uint8_t* rep_valid, const long long* w,
                                     long long* row_count, uint8_t* dirty, uint8_t* sdirty,
                                     const uint8_t* mret_in, uint8_t* mret_state) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0 && *mret_in) *mret_state = 1;
  if (i >= n || !rep_valid[i]) return;
  const int32_t s = slots[i];
  if (s < 0) return;
  const long long ww = w[i];
  atomicAdd((unsigned long long*)(row_count + s), (unsigned long long)ww);
  dirty[s] = 1;
  sdirty[s] = 1;
  for (int c = 0; c < calls.n; ++c) {
    const int kind = calls.kind[c];
    if (kind == AR_COUNT_STAR) {
      atomicAdd((unsigned long long*)calls.acc[c] + s, (unsigned long long)ww);
      continue;
    }
    if (kind == AR_COUNT) {
      atomicAdd((unsigned long long*)calls.acc[c] + s,
                (unsigned long long)((const long long*)calls.red[c])[i]);
      continue;
    }
    if (kind == AR_SUM) {
      switch (calls.adt[c]) {
        case RW_I64:
          atomicAdd((unsigned long long*)calls.acc[c] + s,
                    (unsigned long long)((const long long*)calls.red[c])[i]);
          break;
        case RW_F32:
          atomicAdd((float*)calls.acc[c] + s, ((const float*)calls.red[c])[i]);
          break;
        case RW_F64:
          atomicAdd((double*)calls.acc[c] + s, ((const double*)calls.red[c])[i]);
          break;
      }
    } else if (calls.adt[c] == RW_I32) {  // AR_MIN / AR_MAX
      const int e = ((const int*)calls.red[c])[i];
      if (kind == AR_MIN) atomicMin((int*)calls.acc[c] + s, e);
      else atomicMax((int*)calls.acc[c] + s, e);
    } else {
      const long long e = ((const long long*)calls.red[c])[i];
      if (kind == AR_MIN) atomicMin((long long*)calls.acc[c] + s, e);
      else atomicMax((long long*)calls.acc[c] + s, e);
    }
    atomicAdd((unsigned long long*)calls.nonnull[c] + s, (unsigned long long)calls.nn_red[c][i]);
  }
}

__global__ void reduced_set_live_kernel(int64_t n, const int32_t* slots, const uint8_t* rep_valid,
                                        const long long* row_count, uint8_t* live) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !rep_valid[i]) return;
  const int32_t s = slots[i];
  if (s >= 0) live[s] = row_count[s] > 0 ? 1 : 0;
}

// calls: n_calls rows of (kind, adt, acc, red, nonnull, nn_red), int64;
// live: the table's live lane, or null to skip set_live.
RW_EXPORT int rw_apply_reduced(const int64_t* calls, int n_calls, int64_t n, const void* slots,
                               const void* rep_valid, const void* w, void* row_count, void* dirty,
                               void* sdirty, const void* mret_in, void* mret_state, void* live,
                               void* stream) {
  if (n_calls < 0 || n_calls > AR_MAX_CALLS) return (int)cudaErrorInvalidValue;
  ReducedCalls c;
  c.n = n_calls;
  for (int k = 0; k < n_calls; ++k) {
    const int64_t* r = calls + 6 * k;
    c.kind[k] = (int)r[0];
    c.adt[k] = (int)r[1];
    c.acc[k] = (void*)r[2];
    c.red[k] = (const void*)r[3];
    c.nonnull[k] = (long long*)r[4];
    c.nn_red[k] = (const long long*)r[5];
  }
  if (n > 0) {
    const int threads = 256;
    cudaStream_t st = (cudaStream_t)stream;
    apply_reduced_kernel<<<rw_blocks(n, threads), threads, 0, st>>>(
        c, n, (const int32_t*)slots, (const uint8_t*)rep_valid, (const long long*)w,
        (long long*)row_count, (uint8_t*)dirty, (uint8_t*)sdirty, (const uint8_t*)mret_in,
        (uint8_t*)mret_state);
    if (live != nullptr)
      reduced_set_live_kernel<<<rw_blocks(n, threads), threads, 0, st>>>(
          n, (const int32_t*)slots, (const uint8_t*)rep_valid, (const long long*)row_count,
          (uint8_t*)live);
  }
  return (int)cudaGetLastError();
}
