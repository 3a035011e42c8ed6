// Kernel I: move a rebuilt table's slot-indexed lanes to their new slots.
//
// Replaces the gathers and scatters of the table rebuilds:
// risingwave_tpu/executors/hash_agg.py:_rehash (:268) and
// risingwave_tpu/executors/materialize.py:_mv_rebuild (:587), after their
// lookup_or_insert of the surviving keys into the new table (kernel A).
// For every old slot i with keep[i] and new_slots[i] >= 0, each lane's
// dst[new_slots[i]] = src[i]; every other new slot keeps the value the
// caller filled it with (the lane's init). A kept slot without a new slot
// (MAX_PROBE overflow in the new table) moves nothing, as the reference's
// scatter with mode="drop" does.
//
// What bounds it on the card: keep and new_slots are read coalesced over
// the old capacity; each kept slot reads its lanes coalesced and writes
// them at a random new slot (a 32-byte sector per 1- to 8-byte store).
//
// Design: one thread per old slot, every lane in one launch (up to
// SM_MAX_LANES; the wrapper splits longer lists). New slots are distinct
// for distinct old slots, so the stores need no atomics.
#include "common.cuh"

#define SM_MAX_LANES 24

struct MoveLanes {
  const void* src[SM_MAX_LANES];  // (n,) lanes of the old table
  void* dst[SM_MAX_LANES];        // (new_cap,) lanes of the new table, same dtypes
  int esize[SM_MAX_LANES];
  int n;
};

__global__ void slot_move_kernel(MoveLanes lanes, int64_t n, const int32_t* new_slots,
                                 const uint8_t* keep) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !keep[i]) return;
  const int64_t s = new_slots[i];
  if (s < 0) return;
  for (int k = 0; k < lanes.n; ++k) {
    switch (lanes.esize[k]) {
      case 1: ((uint8_t*)lanes.dst[k])[s] = ((const uint8_t*)lanes.src[k])[i]; break;
      case 4: ((uint32_t*)lanes.dst[k])[s] = ((const uint32_t*)lanes.src[k])[i]; break;
      case 8:
        ((unsigned long long*)lanes.dst[k])[s] = ((const unsigned long long*)lanes.src[k])[i];
        break;
    }
  }
}

// lanes: n_lanes rows of (src, dst, esize), int64; esize in {1, 4, 8}.
RW_EXPORT int rw_slot_move(const int64_t* lanes, int n_lanes, int64_t n, const void* new_slots,
                           const void* keep, void* stream) {
  if (n_lanes < 0 || n_lanes > SM_MAX_LANES) return (int)cudaErrorInvalidValue;
  MoveLanes m;
  m.n = n_lanes;
  for (int k = 0; k < n_lanes; ++k) {
    m.src[k] = (const void*)lanes[3 * k];
    m.dst[k] = (void*)lanes[3 * k + 1];
    m.esize[k] = (int)lanes[3 * k + 2];
    if (m.esize[k] != 1 && m.esize[k] != 4 && m.esize[k] != 8)
      return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    const int threads = 256;
    slot_move_kernel<<<rw_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
        m, n, (const int32_t*)new_slots, (const uint8_t*)keep);
  }
  return (int)cudaGetLastError();
}
