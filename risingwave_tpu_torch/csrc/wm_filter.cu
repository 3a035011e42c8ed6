// Kernel T: the watermark filter's per-chunk step.
//
// Replaces risingwave_tpu/executors/watermark_filter.py:_wm_step (:31,
// K24c). For one chunk of (ts, valid, ops[, ts NULL lane]):
//   - the running max of the event time folds in the chunk's maximum
//     over active rows (valid, non-NULL ts; every op's sign is +-1, so
//     the reference's sign test keeps them all);
//   - keep = valid & (ts >= floor | the row is a Delete or U-): an
//     insert below the current watermark is late and drops, a
//     retraction always passes;
//   - a surviving U- whose next row is not a surviving U+ becomes a
//     Delete (an update that moved a row below the watermark), the next
//     row of the chunk's last one being row 0, as jnp.roll wraps.
// The floor is the host's watermark as of the last barrier, passed by
// value; the running max stays on the card, and the host reads it once
// per barrier (WatermarkFilterExecutor.emit_watermark).
//
// What bounds it on the card: bytes (ts 8, valid 1, ops 4 read, valid
// and ops written, one 8-byte atomic per block); a 65,536-row chunk is
// launch-bound.
//
// Design: a block of 256 rows reduces its max with warp shuffles and
// one 64-bit atomicMax into the running max (skipped when the block has
// no active row). Verdicts stay in shared memory for the torn-pair test;
// the row past the tile's end, or row 0 for the chunk's last row, is
// judged again from device memory (the one-row halo).
#include "common.cuh"

#define WM_TILE 256
#define WM_OP_DELETE 1
#define WM_OP_UD 2
#define WM_OP_UI 3

__device__ __forceinline__ bool wm_keep(bool valid, long long ts, int32_t op, long long floor) {
  return valid && (ts >= floor || op == WM_OP_DELETE || op == WM_OP_UD);
}

__global__ void wm_step_kernel(int64_t n, const long long* ts, const uint8_t* ts_null,
                               const uint8_t* valid, const int32_t* ops, long long floor,
                               long long* running_max, uint8_t* valid_out, int32_t* ops_out) {
  __shared__ uint8_t s_keep[WM_TILE];
  __shared__ int32_t s_op[WM_TILE];
  __shared__ long long s_max[WM_TILE / 32];
  const int tid = threadIdx.x;
  const int64_t t0 = (int64_t)blockIdx.x * WM_TILE;
  const int64_t s = t0 + tid;
  long long m = INT64_MIN;
  bool keep = false;
  int32_t op = 0;
  if (s < n) {
    op = ops[s];
    const bool v = valid[s] != 0;
    const long long t = ts[s];
    if (v && !(ts_null != nullptr && ts_null[s] != 0)) m = t;
    keep = wm_keep(v, t, op, floor);
    valid_out[s] = keep;
  }
  s_keep[tid] = keep;
  s_op[tid] = op;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const long long o = __shfl_down_sync(0xFFFFFFFFu, m, d);
    m = o > m ? o : m;
  }
  if ((tid & 31) == 0) s_max[tid >> 5] = m;
  __syncthreads();
  if (tid < 32) {
    long long x = tid < WM_TILE / 32 ? s_max[tid] : INT64_MIN;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const long long o = __shfl_down_sync(0xFFFFFFFFu, x, d);
      x = o > x ? o : x;
    }
    if (tid == 0 && x != INT64_MIN) atomicMax((long long*)running_max, x);
  }
  if (s >= n) return;
  int32_t out = op;
  if (keep && op == WM_OP_UD) {
    const int64_t q = s + 1 == n ? 0 : s + 1;
    bool q_keep;
    int32_t q_op;
    if (q >= t0 && q < t0 + WM_TILE) {
      q_keep = s_keep[q - t0] != 0;
      q_op = s_op[q - t0];
    } else {
      q_op = ops[q];
      q_keep = wm_keep(valid[q] != 0, ts[q], q_op, floor);
    }
    if (!(q_keep && q_op == WM_OP_UI)) out = WM_OP_DELETE;
  }
  ops_out[s] = out;
}

RW_EXPORT int rw_wm_step(int64_t n, const void* ts, const void* ts_null, const void* valid,
                         const void* ops, int64_t floor, void* running_max, void* valid_out,
                         void* ops_out, void* stream) {
  if (n < 0 || running_max == nullptr) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int64_t blocks = (n + WM_TILE - 1) / WM_TILE;
    wm_step_kernel<<<(int)blocks, WM_TILE, 0, (cudaStream_t)stream>>>(
        n, (const long long*)ts, (const uint8_t*)ts_null, (const uint8_t*)valid,
        (const int32_t*)ops, (long long)floor, (long long*)running_max, (uint8_t*)valid_out,
        (int32_t*)ops_out);
  }
  return (int)cudaGetLastError();
}
