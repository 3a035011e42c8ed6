// Kernel V: one chunk into a TopN executor's pk-keyed row store.
//
// Replaces risingwave_tpu/executors/top_n_plain.py:_upsert_step (:53)
// and _upsert_step_ed (:367) after their lookup_or_insert of the pk
// (kernel A): for the LAST valid row of each slot, every row lane is
// written from the chunk (on a delete too: the reference's scatter writes
// them, and its checkpoint stages a tombstone's lanes), live is set by
// the row's sign, sdirty (and epoch_dirty, when given) is marked. A
// valid row without a slot latches dropped. "Last row wins" is XLA's CPU
// scatter, the reference the CPU tests compare with; the reference's
// GPU scatter picks a winner in no fixed order, so the port fixes it.
//
// What bounds it on the card: per valid row, one random 4-byte atomic on
// the scratch lane; per winning row a scattered store of each lane and
// three 1-byte marks into a store of up to 2^26 slots. The chunk's lanes
// are read coalesced.
//
// Design: kernel D's last-row rule. Launch 1 takes atomicMax of the row
// index into a per-slot int32 scratch lane (kept at -1 between calls,
// allocated once per store); launch 2 lets the row whose index won write
// its slot and reset the scratch entry. A row that lost reads the
// winner's index or -1, never its own, so the reset cannot make a loser
// win.
#include "common.cuh"

#define TU_MAX_LANES 16
#define TU_THREADS 256

struct TuLanes {
  const void* src[TU_MAX_LANES];  // (n,) chunk lanes
  void* dst[TU_MAX_LANES];        // (cap,) row lanes, same dtypes
  int esize[TU_MAX_LANES];
  int n;
};

__global__ void tu_last_kernel(int64_t n, const int32_t* slots, const uint8_t* valid,
                               int32_t* scratch, uint8_t* dropped) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const int32_t s = slots[i];
  if (s < 0) {
    *dropped = 1;
    return;
  }
  atomicMax(scratch + s, (int)i);
}

__global__ void tu_apply_kernel(TuLanes lanes, int64_t n, const int32_t* slots,
                                const uint8_t* valid, const int32_t* ops, int32_t* scratch,
                                uint8_t* live, uint8_t* sdirty, uint8_t* epoch_dirty) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const int32_t s = slots[i];
  if (s < 0 || scratch[s] != (int32_t)i) return;
  scratch[s] = -1;
  const int32_t op = ops[i];
  live[s] = (op == 1 || op == 2) ? 0 : 1;  // DELETE | UPDATE_DELETE
  sdirty[s] = 1;
  if (epoch_dirty != nullptr) epoch_dirty[s] = 1;
  for (int k = 0; k < lanes.n; ++k) {
    switch (lanes.esize[k]) {
      case 1: ((uint8_t*)lanes.dst[k])[s] = ((const uint8_t*)lanes.src[k])[i]; break;
      case 4: ((uint32_t*)lanes.dst[k])[s] = ((const uint32_t*)lanes.src[k])[i]; break;
      default:
        ((unsigned long long*)lanes.dst[k])[s] = ((const unsigned long long*)lanes.src[k])[i];
        break;
    }
  }
}

// lanes: n_lanes rows of (src, dst, esize), int64, esize in {1, 4, 8};
// epoch_dirty may be null.
RW_EXPORT int rw_topn_upsert(const int64_t* lanes, int n_lanes, int64_t n, const void* slots,
                             const void* valid, const void* ops, void* scratch, void* live,
                             void* sdirty, void* epoch_dirty, void* dropped, void* stream) {
  if (n_lanes < 0 || n_lanes > TU_MAX_LANES) return (int)cudaErrorInvalidValue;
  TuLanes m;
  m.n = n_lanes;
  for (int k = 0; k < n_lanes; ++k) {
    m.src[k] = (const void*)lanes[3 * k];
    m.dst[k] = (void*)lanes[3 * k + 1];
    m.esize[k] = (int)lanes[3 * k + 2];
    if (m.esize[k] != 1 && m.esize[k] != 4 && m.esize[k] != 8)
      return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    tu_last_kernel<<<rw_blocks(n, TU_THREADS), TU_THREADS, 0, st>>>(
        n, (const int32_t*)slots, (const uint8_t*)valid, (int32_t*)scratch, (uint8_t*)dropped);
    tu_apply_kernel<<<rw_blocks(n, TU_THREADS), TU_THREADS, 0, st>>>(
        m, n, (const int32_t*)slots, (const uint8_t*)valid, (const int32_t*)ops,
        (int32_t*)scratch, (uint8_t*)live, (uint8_t*)sdirty, (uint8_t*)epoch_dirty);
  }
  return (int)cudaGetLastError();
}
