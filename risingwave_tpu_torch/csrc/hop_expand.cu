// Kernel E: hop-window expansion of a stacked epoch.
//
// Replaces risingwave_tpu/executors/hop_window.py:hop_step_fn (:27) as
// the reference runs it over a stacked epoch (jax.vmap over the chunk
// axis, then a flatten): each input row of chunk c at row r lands in
// factor = ceil(size / slide) output rows, copy k at output index
// (c * factor + k) * cap + r. So the output is chunk 0's block layout,
// then chunk 1's, and so on, the order the sort of kernel F relies on.
// Each copy carries every column and null lane of its row, its
// window_start = first + k * slide (first: the smallest multiple of
// slide greater than ts - size), valid & (window_start <= ts), and the
// row's op.
//
// What bounds it on the card: bytes. Every input lane is read once and
// every output lane written factor times over (5x for q5), all
// coalesced; there is no arithmetic to speak of.
//
// Design: one thread per input row reads the row once and writes its
// factor copies; for a fixed k the threads of a warp write neighbouring
// addresses. Columns are copied as raw 1-, 4- or 8-byte elements through
// tile.cuh's lane table, as kernel AA's.
#include "tile.cuh"

__device__ __forceinline__ long long rw_floor_div(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__global__ void hop_expand_kernel(RwTileLanes lanes, int64_t n_chunks, int64_t cap, int factor,
                                  long long size, long long slide, const long long* ts,
                                  const uint8_t* valid, const int32_t* ops, long long* starts,
                                  uint8_t* valid_out, int32_t* ops_out) {
  const int64_t total = n_chunks * cap;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; s < total; s += stride) {
    const int64_t c = s / cap;
    const int64_t r = s - c * cap;
    const long long t = ts[s];
    const long long first = (rw_floor_div(t - size, slide) + 1) * slide;
    const bool v = valid[s] != 0;
    const int32_t op = ops[s];
    for (int k = 0; k < factor; ++k) {
      const int64_t o = (c * factor + k) * cap + r;
      const long long start = first + (long long)k * slide;
      starts[o] = start;
      valid_out[o] = (v && start <= t) ? 1 : 0;
      ops_out[o] = op;
      rw_tile_row(lanes, k, o, s);
    }
  }
}

// copies: n_copies rows of (src, dst, esize), int64.
RW_EXPORT int rw_hop_expand(const int64_t* copies, int n_copies, int64_t n_chunks, int64_t cap,
                            int factor, int64_t size, int64_t slide, const void* ts,
                            const void* valid, const void* ops, void* starts, void* valid_out,
                            void* ops_out, void* stream) {
  RwTileLanes h;
  if (!rw_tile_lanes(copies, n_copies, 3, &h) || factor < 1 || slide <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t total = n_chunks * cap;
  if (total > 0)
    hop_expand_kernel<<<rw_tile_blocks(total), RW_TILE_THREADS, 0, (cudaStream_t)stream>>>(
        h, n_chunks, cap, factor, (long long)size, (long long)slide, (const long long*)ts,
        (const uint8_t*)valid, (const int32_t*)ops, (long long*)starts, (uint8_t*)valid_out,
        (int32_t*)ops_out);
  return (int)cudaGetLastError();
}
