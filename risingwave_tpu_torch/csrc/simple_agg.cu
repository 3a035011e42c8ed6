// Kernel Y: fold one chunk into the one-group aggregation state of a
// SimpleAgg (a global aggregation: every row lands on slot 0).
//
// Replaces risingwave_tpu/executors/simple_agg.py:_simple_step (:37), which
// scatters every active row of the chunk into slot 0 of a 2-slot AggState
// through ops/agg.py:apply (:257): row_count, the COUNT(*), COUNT and SUM
// accumulators, the non-null counters of SUM/MIN/MAX, the append-only
// MIN/MAX (float inputs as their total-order keys, ops/agg.py:112,
// common.cuh), the minmax_retracted latch (a retraction reaching a
// MIN/MAX call) and the dirty and sdirty marks of slot 0.
//
// What bounds it on the card: the chunk's lanes, read once (valid, ops,
// and each call's value and null lanes); the state is a handful of
// scalars. Kernel B would issue one atomic per row and lane, and every row
// of the chunk would hit the same address, so the adds would serialise in
// L2.
//
// Design: a grid-stride loop over rows; each thread folds its rows into
// registers (one set per call, the call loop unrolled to SA_MAX_CALLS);
// the block reduces them with warp shuffles and shared memory; thread 0
// then issues one atomic per block and lane (add, min or max) and sets
// the marks. Integer results are exact; a float SUM is summed in double
// inside a block and added once per block, so its order of additions is
// not the reference's.
#include <climits>

#include "common.cuh"

#define SA_MAX_CALLS 8
#define SA_THREADS 256
#define SA_ROWS_PER_THREAD 8
#define SA_MAX_BLOCKS 264

enum AggKind : int { K_COUNT_STAR = 0, K_COUNT = 1, K_SUM = 2, K_MIN = 3, K_MAX = 4 };

struct SimpleCalls {
  int kind[SA_MAX_CALLS];
  int vdt[SA_MAX_CALLS];            // input dtype code
  int adt[SA_MAX_CALLS];            // accumulator dtype code
  const void* val[SA_MAX_CALLS];    // (n,) input lane or null
  const uint8_t* nul[SA_MAX_CALLS]; // (n,) input null lane or null
  void* acc[SA_MAX_CALLS];          // (2,) accumulator
  long long* nonnull[SA_MAX_CALLS]; // (2,) non-null counter or null
  int n;
};

struct SumLL {
  __device__ long long operator()(long long a, long long b) const { return a + b; }
};
struct MinLL {
  __device__ long long operator()(long long a, long long b) const { return a < b ? a : b; }
};
struct MaxLL {
  __device__ long long operator()(long long a, long long b) const { return a > b ? a : b; }
};
struct SumD {
  __device__ double operator()(double a, double b) const { return a + b; }
};

// The block's fold of one value per thread; the result is valid in
// thread 0. `ident` is the operation's identity.
template <typename T, typename Op>
__device__ __forceinline__ T sa_block_reduce(T v, Op op, T ident, T* smem) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = op(v, __shfl_down_sync(0xFFFFFFFFu, v, d));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < SA_THREADS / 32 ? smem[lane] : ident;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v = op(v, __shfl_down_sync(0xFFFFFFFFu, v, d));
  }
  __syncthreads();  // smem is reused by the next reduction
  return v;
}

__device__ __forceinline__ long long sa_load_i64(const void* p, int dt, int64_t i) {
  switch (dt) {
    case RW_BOOL: return ((const uint8_t*)p)[i] ? 1 : 0;
    case RW_I32: return ((const int32_t*)p)[i];
    case RW_I64: return ((const long long*)p)[i];
  }
  return 0;
}

__device__ __forceinline__ double sa_load_f64(const void* p, int dt, int64_t i) {
  return dt == RW_F32 ? (double)((const float*)p)[i] : ((const double*)p)[i];
}

__device__ __forceinline__ long long sa_extreme_key(const void* p, int dt, int64_t i) {
  if (dt == RW_F32) return rw_order_key_f32(((const float*)p)[i]);
  if (dt == RW_F64) return rw_order_key_f64(((const double*)p)[i]);
  return sa_load_i64(p, dt, i);
}

__global__ void __launch_bounds__(SA_THREADS)
simple_apply_kernel(SimpleCalls calls, int64_t n, const uint8_t* valid, const int32_t* ops,
                    long long* row_count, uint8_t* dirty, uint8_t* sdirty,
                    uint8_t* minmax_retracted) {
  __shared__ long long s_ll[SA_THREADS / 32];
  __shared__ double s_d[SA_THREADS / 32];
  long long rows = 0, active = 0, retracted = 0;
  long long ia[SA_MAX_CALLS], nn[SA_MAX_CALLS], ex[SA_MAX_CALLS];
  double fa[SA_MAX_CALLS];
#pragma unroll
  for (int c = 0; c < SA_MAX_CALLS; ++c) {
    ia[c] = 0;
    nn[c] = 0;
    fa[c] = 0.0;
    ex[c] = calls.kind[c] == K_MIN ? LLONG_MAX : LLONG_MIN;
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (!valid[i]) continue;
    const int32_t op = ops[i];
    const long long w = (op == 1 || op == 2) ? -1 : 1;  // DELETE | UPDATE_DELETE
    rows += w;
    active += 1;
#pragma unroll
    for (int c = 0; c < SA_MAX_CALLS; ++c) {
      if (c >= calls.n) break;
      const int kind = calls.kind[c];
      if (kind == K_COUNT_STAR) {
        ia[c] += w;
        continue;
      }
      if (calls.nul[c] != nullptr && calls.nul[c][i]) continue;
      if (kind == K_COUNT) {
        ia[c] += w;
      } else if (kind == K_SUM) {
        if (calls.adt[c] == RW_I64) ia[c] += sa_load_i64(calls.val[c], calls.vdt[c], i) * w;
        else fa[c] += sa_load_f64(calls.val[c], calls.vdt[c], i) * (double)w;
        nn[c] += w;
      } else {  // K_MIN / K_MAX, append-only
        if (w < 0) {
          retracted = 1;
          continue;
        }
        const long long key = sa_extreme_key(calls.val[c], calls.vdt[c], i);
        ex[c] = kind == K_MIN ? (key < ex[c] ? key : ex[c]) : (key > ex[c] ? key : ex[c]);
        nn[c] += 1;
      }
    }
  }
  active = sa_block_reduce(active, SumLL(), 0LL, s_ll);
  // every thread takes the same branch: thread 0's total reaches the rest
  if (threadIdx.x == 0) s_ll[0] = active;
  __syncthreads();
  active = s_ll[0];
  __syncthreads();
  if (active == 0) return;
  rows = sa_block_reduce(rows, SumLL(), 0LL, s_ll);
  retracted = sa_block_reduce(retracted, MaxLL(), 0LL, s_ll);
  if (threadIdx.x == 0) {
    atomicAdd((unsigned long long*)row_count, (unsigned long long)rows);
    dirty[0] = 1;
    sdirty[0] = 1;
    if (retracted) *minmax_retracted = 1;
  }
#pragma unroll
  for (int c = 0; c < SA_MAX_CALLS; ++c) {
    if (c >= calls.n) break;
    const int kind = calls.kind[c];
    if (kind == K_COUNT_STAR || kind == K_COUNT) {
      const long long v = sa_block_reduce(ia[c], SumLL(), 0LL, s_ll);
      if (threadIdx.x == 0) atomicAdd((unsigned long long*)calls.acc[c], (unsigned long long)v);
      continue;
    }
    const long long cnt = sa_block_reduce(nn[c], SumLL(), 0LL, s_ll);
    if (kind == K_SUM) {
      if (calls.adt[c] == RW_I64) {
        const long long v = sa_block_reduce(ia[c], SumLL(), 0LL, s_ll);
        if (threadIdx.x == 0) atomicAdd((unsigned long long*)calls.acc[c], (unsigned long long)v);
      } else {
        const double v = sa_block_reduce(fa[c], SumD(), 0.0, s_d);
        if (threadIdx.x == 0) {
          if (calls.adt[c] == RW_F32) atomicAdd((float*)calls.acc[c], (float)v);
          else atomicAdd((double*)calls.acc[c], v);
        }
      }
      if (threadIdx.x == 0) atomicAdd((unsigned long long*)calls.nonnull[c], (unsigned long long)cnt);
      continue;
    }
    const long long key = kind == K_MIN ? sa_block_reduce(ex[c], MinLL(), LLONG_MAX, s_ll)
                                        : sa_block_reduce(ex[c], MaxLL(), LLONG_MIN, s_ll);
    if (threadIdx.x == 0 && cnt > 0) {
      if (calls.adt[c] == RW_I32) {
        int* a = (int*)calls.acc[c];
        if (kind == K_MIN) atomicMin(a, (int)key);
        else atomicMax(a, (int)key);
      } else {
        long long* a = (long long*)calls.acc[c];
        if (kind == K_MIN) atomicMin(a, key);
        else atomicMax(a, key);
      }
      atomicAdd((unsigned long long*)calls.nonnull[c], (unsigned long long)cnt);
    }
  }
}

// calls: n_calls rows of (kind, vdt, adt, val, nul, acc, nonnull), int64, as
// kernel B's rw_agg_apply takes them; the state lanes are slot 0 of (2,)
// lanes. valid, ops: the chunk's (n,) lanes.
RW_EXPORT int rw_simple_apply(const int64_t* calls, int n_calls, int64_t n, const void* valid,
                              const void* ops, void* row_count, void* dirty, void* sdirty,
                              void* minmax_retracted, void* stream) {
  if (n_calls < 0 || n_calls > SA_MAX_CALLS) return (int)cudaErrorInvalidValue;
  SimpleCalls c;
  c.n = n_calls;
  for (int k = 0; k < SA_MAX_CALLS; ++k) {
    const bool used = k < n_calls;
    const int64_t* r = calls + 7 * k;
    c.kind[k] = used ? (int)r[0] : K_COUNT_STAR;
    c.vdt[k] = used ? (int)r[1] : 0;
    c.adt[k] = used ? (int)r[2] : 0;
    c.val[k] = used ? (const void*)r[3] : nullptr;
    c.nul[k] = used ? (const uint8_t*)r[4] : nullptr;
    c.acc[k] = used ? (void*)r[5] : nullptr;
    c.nonnull[k] = used ? (long long*)r[6] : nullptr;
  }
  if (n > 0) {
    int64_t blocks = (n + (int64_t)SA_THREADS * SA_ROWS_PER_THREAD - 1) /
                     ((int64_t)SA_THREADS * SA_ROWS_PER_THREAD);
    if (blocks > SA_MAX_BLOCKS) blocks = SA_MAX_BLOCKS;
    simple_apply_kernel<<<(int)blocks, SA_THREADS, 0, (cudaStream_t)stream>>>(
        c, n, (const uint8_t*)valid, (const int32_t*)ops, (long long*)row_count,
        (uint8_t*)dirty, (uint8_t*)sdirty, (uint8_t*)minmax_retracted);
  }
  return (int)cudaGetLastError();
}
