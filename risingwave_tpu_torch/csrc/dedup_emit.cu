// Kernel J: the append-only dedup's emission after its find-or-insert.
//
// Replaces risingwave_tpu/executors/dedup.py:dedup_step_fn (:47) after
// its lookup_or_insert (kernel A), with
// risingwave_tpu/ops/hash_table.py:first_occurrence_mask (:342) inside:
// every row that claimed a slot in this call, or is a same-key twin of
// the row that did, has A's `inserted` set; the slot becomes live and
// sdirty; the chunk keeps only the FIRST (lowest-index) inserted row of
// each slot. A valid row with a negative sign latches saw_delete, a
// valid positive row without a slot (MAX_PROBE overflow) latches
// dropped. rw_first_occurrence is the same first-row rule alone, for
// first_occurrence_mask on the card.
//
// What bounds it on the card: per inserted row, one random 4-byte
// atomic on the scratch lane and two 1-byte stores (live, sdirty) at
// its slot, each a 32-byte sector of a table of up to 2^23+ slots; the
// chunk's lanes (valid, ops, slots, inserted, emit out) are read and
// written coalesced. At q8's chunk sizes (32,768 and 65,536 rows) the
// two launches are short and launch overhead is a good part of them.
//
// Design: the reference sorts the slots to find the first row per slot.
// Here, as kernel D does for the last row, launch 1 takes atomicMin of
// the row index into a per-slot int32 scratch lane (kept at INT32_MAX
// between calls, allocated once per table); launch 2 lets the row whose
// index won emit and reset the scratch entry. A row that lost reads the
// winner's index or INT32_MAX, never its own, so the reset cannot make a
// loser win. The latches are plain stores of 1 (every writer writes the
// same value).
#include "common.cuh"

#define FO_SENTINEL 0x7FFFFFFF

__global__ void fo_claim_kernel(int64_t n, const int32_t* slots, const uint8_t* valid,
                                int32_t* scratch, int64_t cap) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const int32_t s = slots[i];
  if (s < 0 || s >= cap) return;
  atomicMin(scratch + s, (int)i);
}

__global__ void fo_keep_kernel(int64_t n, const int32_t* slots, const uint8_t* valid,
                               int32_t* scratch, int64_t cap, uint8_t* out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint8_t keep = 0;
  if (valid[i]) {
    const int32_t s = slots[i];
    if (s >= 0 && s < cap && scratch[s] == (int32_t)i) {
      scratch[s] = FO_SENTINEL;
      keep = 1;
    }
  }
  out[i] = keep;
}

__global__ void dedup_mark_kernel(int64_t n, const uint8_t* valid, const int32_t* ops,
                                  const int32_t* slots, const uint8_t* inserted,
                                  uint8_t* live, uint8_t* sdirty, int32_t* scratch,
                                  int64_t cap, uint8_t* saw_delete, uint8_t* dropped) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const int32_t op = ops[i];
  if (op == 1 || op == 2) {  // DELETE | UPDATE_DELETE: sign < 0
    *saw_delete = 1;
    return;
  }
  const int32_t s = slots[i];
  if (s < 0) {
    *dropped = 1;
    return;
  }
  if (!inserted[i] || s >= cap) return;
  live[s] = 1;
  sdirty[s] = 1;
  atomicMin(scratch + s, (int)i);
}

// slots/scratch int32, valid/out bool; scratch holds FO_SENTINEL at
// every slot before and after the call.
RW_EXPORT int rw_first_occurrence(int64_t n, const void* slots, const void* valid, void* scratch,
                                  int64_t cap, void* out, void* stream) {
  if (n > 0) {
    const int threads = 256;
    cudaStream_t st = (cudaStream_t)stream;
    fo_claim_kernel<<<rw_blocks(n, threads), threads, 0, st>>>(
        n, (const int32_t*)slots, (const uint8_t*)valid, (int32_t*)scratch, cap);
    fo_keep_kernel<<<rw_blocks(n, threads), threads, 0, st>>>(
        n, (const int32_t*)slots, (const uint8_t*)valid, (int32_t*)scratch, cap, (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}

// valid/inserted/live/sdirty/emit bool, ops/slots int32 (slots and
// inserted from kernel A over valid & sign > 0); saw_delete and dropped
// one byte each, set (never cleared) by the call.
RW_EXPORT int rw_dedup_emit(int64_t n, const void* valid, const void* ops, const void* slots,
                            const void* inserted, void* live, void* sdirty, void* scratch,
                            int64_t cap, void* emit, void* saw_delete, void* dropped,
                            void* stream) {
  if (n > 0) {
    const int threads = 256;
    cudaStream_t st = (cudaStream_t)stream;
    dedup_mark_kernel<<<rw_blocks(n, threads), threads, 0, st>>>(
        n, (const uint8_t*)valid, (const int32_t*)ops, (const int32_t*)slots,
        (const uint8_t*)inserted, (uint8_t*)live, (uint8_t*)sdirty, (int32_t*)scratch, cap,
        (uint8_t*)saw_delete, (uint8_t*)dropped);
    fo_keep_kernel<<<rw_blocks(n, threads), threads, 0, st>>>(
        n, (const int32_t*)slots, (const uint8_t*)inserted, (int32_t*)scratch, cap,
        (uint8_t*)emit);
  }
  return (int)cudaGetLastError();
}
