// Kernel A: batched find-or-insert into the open-addressing hash table.
//
// Replaces risingwave_tpu/ops/hash_table.py:lookup_or_insert (:119), with
// K1 (ops/hashing.py:hash128) inlined from hashing.cuh.
//
// What bounds it on the card: one random probe per row into a table of
// up to 2^24+ slots, i.e. several scattered 4- and 8-byte accesses per
// row (the fp1/fp2 words, the stamp word and each key lane of the probed
// slot), each costing a 32-byte sector of device memory. The row-side
// traffic (key lanes in, slots/found/inserted out) is coalesced and
// small beside that.
//
// Design: the reference elects claim winners in lockstep probe rounds
// (scatter, re-read, verify) because XLA has no atomics. Here each row
// is one thread that probes on its own:
//   1. hash the key lanes (K1); fp1 == 0 is remapped to 1 (0 = EMPTY);
//   2. probe (h1 + t) & mask for t < MAX_PROBE (64);
//   3. an EMPTY slot is claimed with atomicCAS on the slot's stamp word
//      (0 -> -1 "writing"); the winner writes fp1, fp2 and the key lanes,
//      fences, then publishes the stamp as this call's generation (> 0);
//   4. a reader that finds a slot in the writing state spins until it is
//      published, then compares fingerprints and exact keys (NaN equals
//      NaN for float lanes). A match whose stamp equals this call's
//      generation is a same-key twin of this call's winner: it reports
//      inserted, not found. A match claimed in an earlier call reports
//      found = live[slot] (tombstones resolve but are not found).
//   5. each claim adds one to the table's claimed-slot counter (the
//      occupancy the host reads at the barrier), one atomic per warp.
// Rows that run past 64 probes, and invalid rows, get slot -1.
// Table lanes are read with volatile loads so no stale L1 line is used.
// The hash, key compare and probe order come from probe.cuh, shared
// with kernel M's read-only lookup.
#include "probe.cuh"

__device__ __forceinline__ void rw_lane_store(void* tab, const void* in, int dt,
                                              int64_t s, int64_t i) {
  switch (dt) {
    case RW_BOOL: ((uint8_t*)tab)[s] = ((const uint8_t*)in)[i] ? 1 : 0; break;
    case RW_I32: ((int32_t*)tab)[s] = ((const int32_t*)in)[i]; break;
    case RW_I64: ((long long*)tab)[s] = ((const long long*)in)[i]; break;
    case RW_F32: ((float*)tab)[s] = ((const float*)in)[i]; break;
    case RW_F64: ((double*)tab)[s] = ((const double*)in)[i]; break;
  }
}

__global__ void lookup_or_insert_kernel(KeyLanes keys, int64_t n, const uint8_t* valid,
                                        int32_t* fp1, int32_t* fp2, int32_t* stamp,
                                        unsigned long long* claimed, const uint8_t* live,
                                        uint32_t mask, int32_t gen, int32_t* slots,
                                        uint8_t* found, uint8_t* inserted) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t out_slot = -1;
  uint8_t out_found = 0, out_ins = 0;
  bool did_claim = false;
  if (valid[i]) {
    uint32_t h1;
    int32_t f1, f2;
    rw_key_hash(keys, i, h1, f1, f2);
    for (int t = 0; t < RW_MAX_PROBE; ++t) {
      const int64_t s = (int64_t)((h1 + (uint32_t)t) & mask);
      volatile int32_t* st = stamp + s;
      int32_t cur = *st;
      if (cur == 0) {
        cur = atomicCAS((int*)(stamp + s), 0, -1);
        if (cur == 0) {  // won the claim: write the slot, then publish
          fp1[s] = f1;
          fp2[s] = f2;
          for (int l = 0; l < keys.n; ++l)
            rw_lane_store(keys.tab[l], keys.in[l], keys.dt[l], s, i);
          __threadfence();
          atomicExch((int*)(stamp + s), gen);
          out_slot = (int32_t)s;
          out_ins = 1;
          did_claim = true;
          break;
        }
      }
      while (cur == -1) {  // another row is writing this slot
        __nanosleep(20);
        cur = *st;
      }
      __threadfence();
      if (((volatile int32_t*)fp1)[s] != f1 || ((volatile int32_t*)fp2)[s] != f2) continue;
      if (!rw_keys_equal(keys, s, i)) continue;
      out_slot = (int32_t)s;
      if (cur == gen) out_ins = 1;
      else out_found = live[s] ? 1 : 0;
      break;
    }
  }
  slots[i] = out_slot;
  found[i] = out_found;
  inserted[i] = out_ins;
  // the table's claimed-slot counter: one atomic per warp
  const unsigned act = __activemask();
  const unsigned won = __ballot_sync(act, did_claim);
  if (won != 0u && (int)(threadIdx.x & 31) == __ffs(act) - 1)
    atomicAdd(claimed, (unsigned long long)__popc(won));
}

// lanes: n_keys rows of (input ptr, dtype code, table ptr), as int64.
RW_EXPORT int rw_lookup_or_insert(const int64_t* lanes, int n_keys, int64_t n,
                                  const void* valid, void* fp1, void* fp2, void* stamp,
                                  void* claimed, const void* live, int64_t capacity, int gen,
                                  void* slots, void* found, void* inserted, void* stream) {
  KeyLanes k;
  if (!rw_key_lanes(lanes, n_keys, &k)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int threads = 256;
    lookup_or_insert_kernel<<<rw_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
        k, n, (const uint8_t*)valid, (int32_t*)fp1, (int32_t*)fp2, (int32_t*)stamp,
        (unsigned long long*)claimed, (const uint8_t*)live, (uint32_t)(capacity - 1), (int32_t)gen, (int32_t*)slots,
        (uint8_t*)found, (uint8_t*)inserted);
  }
  return (int)cudaGetLastError();
}
