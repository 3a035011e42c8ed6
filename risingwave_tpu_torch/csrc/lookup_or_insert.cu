// Kernel A: batched find-or-insert into the open-addressing hash table.
//
// Replaces risingwave_tpu/ops/hash_table.py:lookup_or_insert (:119), with
// K1 (ops/hashing.py:hash128) inlined from hashing.cuh.
//
// What bounds it on the card: one random probe per row into a table of
// up to 2^24+ slots, i.e. several scattered 4- and 8-byte accesses per
// row (the stamp word, each key lane and live of the probed slot; a
// claim also writes fp1 and fp2), each costing a 32-byte sector of
// device memory: the card's rate of random sectors, not its byte rate.
// The row-side traffic (key lanes in, slots/found/inserted out) is
// coalesced and small beside that.
//
// Design: the reference elects claim winners in lockstep probe rounds
// (scatter, re-read, verify) because XLA has no atomics. Here each row
// is one thread that probes on its own:
//   1. hash the key lanes (K1); fp1 == 0 is remapped to 1 (0 = EMPTY);
//   2. inside a warp, rows whose (h1, fp2) agree are matched
//      (__match_any_sync); the lowest such row leads, and a row whose key
//      equals its leader's exactly takes the leader's slot and stamp
//      instead of probing. A row with the leader's fingerprints and
//      another key probes on its own, so two keys never merge;
//   3. every other row probes (h1 + t) & mask for t < MAX_PROBE (64)
//      through probe.cuh's claim protocol: the stamp word read relaxed
//      beside the first key lane, the key compared exactly (no
//      fingerprint read: a found key costs its stamp, key lanes and live,
//      four 32-byte sectors for a two-lane key), an EMPTY slot claimed with
//      atomicCAS (0 -> -1) and published with a release store of this
//      call's generation; only a slot claimed in this launch (-1, or the
//      generation) is read again after an acquire load of its stamp. No
//      probe step takes a fence;
//   4. a slot whose stamp is this call's generation is a claim of this
//      call (the row's own, or a same-key twin's): inserted, not found.
//      A match claimed in an earlier call reports found = live[slot]
//      (tombstones resolve but are not found);
//   5. each claim adds one to the table's claimed-slot counter (the
//      occupancy the host reads at the barrier), one atomic per warp.
// Rows that run past 64 probes, and invalid rows, get slot -1.
#include "probe.cuh"

#define LI_THREADS 256

__global__ void lookup_or_insert_kernel(KeyLanes keys, int64_t n, const uint8_t* valid,
                                        int32_t* fp1, int32_t* fp2, int32_t* stamp,
                                        unsigned long long* claimed, const uint8_t* live,
                                        uint32_t mask, int32_t gen, int32_t* slots,
                                        uint8_t* found, uint8_t* inserted) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = (int)(threadIdx.x & 31);
  const bool v = i < n && valid[i] != 0;
  uint32_t h1 = 0u;
  int32_t f1 = 0, f2 = 0;
  if (v) rw_key_hash(keys, i, h1, f1, f2);
  const unsigned vmask = __ballot_sync(0xFFFFFFFFu, v);
  int leader = lane;
  bool follow = false;
  if (v) {
    const unsigned group =
        __match_any_sync(vmask, ((unsigned long long)h1 << 32) | (uint32_t)f2);
    leader = __ffs(group) - 1;
    follow = leader != lane && rw_rows_equal(keys, i, i - lane + leader);
  }
  int32_t slot = -1, seen = 0;
  bool did_claim = false;
  if (v && !follow)
    slot = rw_find_or_claim(keys, i, h1, f1, f2, fp1, fp2, stamp, mask, gen, RW_MAX_PROBE, &seen,
                            &did_claim);
  const int32_t lead_slot = __shfl_sync(0xFFFFFFFFu, slot, leader);
  const int32_t lead_seen = __shfl_sync(0xFFFFFFFFu, seen, leader);
  if (follow) {
    slot = lead_slot;
    seen = lead_seen;
  }
  if (i < n) {
    slots[i] = slot;
    inserted[i] = slot >= 0 && seen == gen ? 1 : 0;
    found[i] = slot >= 0 && seen != gen && live[slot] ? 1 : 0;
  }
  // the table's claimed-slot counter: one atomic per warp
  const unsigned won = __ballot_sync(0xFFFFFFFFu, did_claim);
  if (won != 0u && lane == 0) atomicAdd(claimed, (unsigned long long)__popc(won));
}

// lanes: n_keys rows of (input ptr, dtype code, table ptr), as int64.
RW_EXPORT int rw_lookup_or_insert(const int64_t* lanes, int n_keys, int64_t n,
                                  const void* valid, void* fp1, void* fp2, void* stamp,
                                  void* claimed, const void* live, int64_t capacity, int gen,
                                  void* slots, void* found, void* inserted, void* stream) {
  KeyLanes k;
  if (!rw_key_lanes(lanes, n_keys, &k)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    lookup_or_insert_kernel<<<rw_blocks(n, LI_THREADS), LI_THREADS, 0, (cudaStream_t)stream>>>(
        k, n, (const uint8_t*)valid, (int32_t*)fp1, (int32_t*)fp2, (int32_t*)stamp,
        (unsigned long long*)claimed, (const uint8_t*)live, (uint32_t)(capacity - 1),
        (int32_t)gen, (int32_t*)slots, (uint8_t*)found, (uint8_t*)inserted);
  }
  return (int)cudaGetLastError();
}
