// Kernel D: apply one chunk to the device materialized view.
//
// Replaces risingwave_tpu/executors/materialize.py:mv_step_fn (:551)
// after its lookup_or_insert on the pk (kernel A), including
// ops/hash_table.py:last_occurrence_mask (:334): ConflictBehavior
// Overwrite, the last valid row per slot wins; a winning delete clears
// live, a winning insert sets live and writes the value and null lanes;
// every winning slot is marked sdirty. A valid row without a slot latches
// the dropped flag (MAX_PROBE overflow).
//
// What bounds it on the card: per valid row, one random 4-byte atomic on
// the scratch lane, then per winning row a few scattered 1- and 8-byte
// stores (live, sdirty, each value lane) into tables of up to 2^24+
// slots. The chunk's lanes are read coalesced, twice.
//
// Design: the reference sorts the slots to find the last row per slot.
// Here launch 1 takes atomicMax of the row index into a per-slot int32
// scratch lane (kept all -1 between calls, allocated once per table);
// launch 2 lets the row whose index won apply its row and reset the
// scratch entry. Rows of a slot that lost read either the winner's index
// or -1, never their own, so the reset cannot make a loser win. On
// request launch 1 also adds the chunk's valid rows to a counter (the
// fused program's mv_rows), one atomic per warp.
#include "common.cuh"

#define MV_MAX_LANES 24  // value (and null) lanes one call writes; = materialize.MV_LANES

struct MvLanes {
  const void* src[MV_MAX_LANES];     // (n,) chunk value lanes
  void* dst[MV_MAX_LANES];           // (cap,) MV value lanes, same dtypes
  int esize[MV_MAX_LANES];
  const uint8_t* nsrc[MV_MAX_LANES]; // (n,) chunk null lanes, or null
  uint8_t* ndst[MV_MAX_LANES];       // (cap,) MV null lanes
  int n, nn;
};

__global__ void mv_last_kernel(int64_t n, const int32_t* slots, const uint8_t* valid,
                               int32_t* scratch, uint8_t* dropped,
                               unsigned long long* rows) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool v = i < n && valid[i];
  if (rows != nullptr) {  // every thread of the block is still here
    const unsigned b = __ballot_sync(0xFFFFFFFFu, v);
    if ((threadIdx.x & 31) == 0 && b != 0u) atomicAdd(rows, (unsigned long long)__popc(b));
  }
  if (!v) return;
  const int32_t s = slots[i];
  if (s < 0) {
    *dropped = 1;
    return;
  }
  atomicMax(scratch + s, (int)i);
}

__global__ void mv_apply_kernel(MvLanes lanes, int64_t n, const int32_t* slots,
                                const uint8_t* valid, const int32_t* ops, int32_t* scratch,
                                uint8_t* live, uint8_t* sdirty) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const int32_t s = slots[i];
  if (s < 0 || scratch[s] != (int32_t)i) return;
  scratch[s] = -1;
  const int32_t op = ops[i];
  const bool del = op == 1 || op == 2;  // DELETE | UPDATE_DELETE
  live[s] = del ? 0 : 1;
  sdirty[s] = 1;
  if (del) return;
  for (int k = 0; k < lanes.n; ++k) {
    switch (lanes.esize[k]) {
      case 1: ((uint8_t*)lanes.dst[k])[s] = ((const uint8_t*)lanes.src[k])[i]; break;
      case 4: ((uint32_t*)lanes.dst[k])[s] = ((const uint32_t*)lanes.src[k])[i]; break;
      case 8:
        ((unsigned long long*)lanes.dst[k])[s] = ((const unsigned long long*)lanes.src[k])[i];
        break;
    }
  }
  for (int k = 0; k < lanes.nn; ++k)
    lanes.ndst[k][s] = lanes.nsrc[k] != nullptr && lanes.nsrc[k][i] ? 1 : 0;
}

// values: n_values rows of (src, dst, esize); nulls: n_nulls rows of
// (src or 0, dst); all int64. rows: an int64 the chunk's valid rows are
// added to, or null.
RW_EXPORT int rw_mv_upsert(const int64_t* values, int n_values, const int64_t* nulls,
                           int n_nulls, int64_t n, const void* slots, const void* valid,
                           const void* ops, void* scratch, void* live, void* sdirty,
                           void* dropped, void* rows, void* stream) {
  if (n_values < 0 || n_values > MV_MAX_LANES || n_nulls < 0 || n_nulls > MV_MAX_LANES)
    return (int)cudaErrorInvalidValue;
  MvLanes m;
  m.n = n_values;
  m.nn = n_nulls;
  for (int k = 0; k < n_values; ++k) {
    m.src[k] = (const void*)values[3 * k];
    m.dst[k] = (void*)values[3 * k + 1];
    m.esize[k] = (int)values[3 * k + 2];
  }
  for (int k = 0; k < n_nulls; ++k) {
    m.nsrc[k] = (const uint8_t*)nulls[2 * k];
    m.ndst[k] = (uint8_t*)nulls[2 * k + 1];
  }
  if (n > 0) {
    const int threads = 256;
    cudaStream_t st = (cudaStream_t)stream;
    mv_last_kernel<<<rw_blocks(n, threads), threads, 0, st>>>(
        n, (const int32_t*)slots, (const uint8_t*)valid, (int32_t*)scratch,
        (uint8_t*)dropped, (unsigned long long*)rows);
    mv_apply_kernel<<<rw_blocks(n, threads), threads, 0, st>>>(
        m, n, (const int32_t*)slots, (const uint8_t*)valid, (const int32_t*)ops,
        (int32_t*)scratch, (uint8_t*)live, (uint8_t*)sdirty);
  }
  return (int)cudaGetLastError();
}
