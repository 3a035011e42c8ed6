// The hash table's probe loop, shared by kernel A (lookup_or_insert.cu,
// find-or-insert), kernel M (join_probe.cu, the read-only lookup of
// risingwave_tpu/ops/hash_table.py:lookup :232 and the join probe), kernel
// AB (temporal_probe.cu) and kernel X's set of dirty groups (topn_rank.cu).
//
// A key's fingerprints are K1 (hashing.cuh) over its lanes: h1 picks
// the home slot, fp1 = h1 (0 remapped to 1, since fp1 == 0 marks an
// EMPTY slot) and fp2 = h2 are stored per slot. Probing visits
// (h1 + t) & mask for t < max_probe (RW_MAX_PROBE for the state tables)
// and compares fingerprints, then every key lane exactly (NaN equals NaN
// for float lanes).
//
// The claim protocol (rw_find_or_claim) orders a slot's lanes by its
// stamp word alone: 0 empty, -1 being written, then the generation of the
// call that claimed it. A claim is a CAS 0 -> -1, plain stores of fp1,
// fp2 and the key lanes, then a release store of the generation. A slot
// published by an earlier launch never changes again, so a stamp read
// with a relaxed load that holds an older generation lets every other
// lane of the slot be read with plain loads: no fence. Only a stamp seen
// as -1 or as this call's generation (a claim of this launch) is read
// again with an acquire load, spinning while it is -1, before the slot's
// lanes are read. The claim protocol compares keys alone: equal keys
// have equal fingerprints, so those serve the read-only probes.
#pragma once

#include <cuda/atomic>

#include "hashing.cuh"

#define RW_MAX_PROBE 64

// The key lanes of a probe: at most N (the state tables' RW_MAX_LANES;
// kernel X's set takes one per group lane, up to its TR_MAX_KEYS - 1).
template <int N>
struct KeyLanesN {
  const void* in[N];   // (n,) input key lanes
  void* tab[N];        // (cap,) table key lanes, same dtypes
  int dt[N];
  int n;
};
using KeyLanes = KeyLanesN<RW_MAX_LANES>;

// Fill a KeyLanes from n_keys int64 rows of (input ptr, dtype code, table ptr).
static inline bool rw_key_lanes(const int64_t* lanes, int n_keys, KeyLanes* k) {
  if (n_keys < 1 || n_keys > RW_MAX_LANES) return false;
  k->n = n_keys;
  for (int l = 0; l < n_keys; ++l) {
    k->in[l] = (const void*)lanes[3 * l];
    k->dt[l] = (int)lanes[3 * l + 1];
    k->tab[l] = (void*)lanes[3 * l + 2];
  }
  return true;
}

// K1 over row i's key lanes: h1 (the probe start) and the stored pair.
template <class K>
__device__ __forceinline__ void rw_key_hash(const K& keys, int64_t i, uint32_t& h1,
                                            int32_t& f1, int32_t& f2) {
  uint32_t a = RW_HASH_INIT, b = RW_HASH_INIT ^ RW_SEED_FP2;
  for (int l = 0; l < keys.n; ++l) rw_hash_lane(keys.in[l], keys.dt[l], i, a, b);
  h1 = rw_mix32(a);
  f1 = (int32_t)(h1 == 0u ? 1u : h1);
  f2 = (int32_t)rw_mix32(b);
}

// Element s of lane a equals element i of lane b (same dtype).
__device__ __forceinline__ bool rw_lane_equal(const void* a, const void* b, int dt, int64_t s,
                                              int64_t i) {
  switch (dt) {
    case RW_BOOL:
      return (((const uint8_t*)a)[s] != 0) == (((const uint8_t*)b)[i] != 0);
    case RW_I32:
      return ((const int32_t*)a)[s] == ((const int32_t*)b)[i];
    case RW_I64:
      return ((const long long*)a)[s] == ((const long long*)b)[i];
    case RW_F32: {
      const float x = ((const float*)a)[s], y = ((const float*)b)[i];
      return x == y || (isnan(x) && isnan(y));
    }
    case RW_F64: {
      const double x = ((const double*)a)[s], y = ((const double*)b)[i];
      return x == y || (isnan(x) && isnan(y));
    }
  }
  return false;
}

// Slot s of the table holds row i's key.
template <class K>
__device__ __forceinline__ bool rw_keys_equal(const K& keys, int64_t s, int64_t i) {
  bool eq = true;
  for (int l = 0; l < keys.n && eq; ++l)
    eq = rw_lane_equal(keys.tab[l], keys.in[l], keys.dt[l], s, i);
  return eq;
}

// Input rows i and j hold the same key.
template <class K>
__device__ __forceinline__ bool rw_rows_equal(const K& keys, int64_t i, int64_t j) {
  bool eq = true;
  for (int l = 0; l < keys.n && eq; ++l)
    eq = rw_lane_equal(keys.in[l], keys.in[l], keys.dt[l], i, j);
  return eq;
}

// Read-only probe of row i: its slot, or -1 when the chain reaches an
// EMPTY slot (or runs past max_probe) without the key. No other thread
// writes the table during the launch.
template <class K>
__device__ __forceinline__ int32_t rw_probe_readonly(const K& keys, int64_t i,
                                                     const int32_t* fp1, const int32_t* fp2,
                                                     uint32_t mask,
                                                     int64_t max_probe = RW_MAX_PROBE) {
  uint32_t h1;
  int32_t f1, f2;
  rw_key_hash(keys, i, h1, f1, f2);
  for (int64_t t = 0; t < max_probe; ++t) {
    const int64_t s = (int64_t)((h1 + (uint32_t)t) & mask);
    const int32_t sf1 = fp1[s];
    if (sf1 == f1 && fp2[s] == f2 && rw_keys_equal(keys, s, i)) return (int32_t)s;
    if (sf1 == 0) return -1;  // EMPTY: the key is absent
  }
  return -1;
}

__device__ __forceinline__ void rw_lane_store(void* tab, const void* in, int dt, int64_t s,
                                              int64_t i) {
  switch (dt) {
    case RW_BOOL: ((uint8_t*)tab)[s] = ((const uint8_t*)in)[i] ? 1 : 0; break;
    case RW_I32: ((int32_t*)tab)[s] = ((const int32_t*)in)[i]; break;
    case RW_I64: ((long long*)tab)[s] = ((const long long*)in)[i]; break;
    case RW_F32: ((float*)tab)[s] = ((const float*)in)[i]; break;
    case RW_F64: ((double*)tab)[s] = ((const double*)in)[i]; break;
  }
}

using rw_stamp_ref = cuda::atomic_ref<int32_t, cuda::thread_scope_device>;

// Find row i's key (home h1) or claim an EMPTY slot for it (writing its
// fingerprints f1, f2), over at most max_probe slots. A probe step reads
// the stamp and the first key lane together and compares the keys
// exactly, without reading the fingerprints: a found key costs the stamp
// and its key lanes. Returns the slot, or -1; *seen gets the slot's
// published stamp (gen for a claim of this call, this row's or a same-key
// twin's) and *claimed whether this row claimed it.
template <class K>
__device__ __forceinline__ int32_t rw_find_or_claim(const K& keys, int64_t i, uint32_t h1,
                                                    int32_t f1, int32_t f2, int32_t* fp1,
                                                    int32_t* fp2, int32_t* stamp, uint32_t mask,
                                                    int32_t gen, int64_t max_probe, int32_t* seen,
                                                    bool* claimed) {
  for (int64_t t = 0; t < max_probe; ++t) {
    const int64_t s = (int64_t)((h1 + (uint32_t)t) & mask);
    int32_t cur = rw_stamp_ref(stamp[s]).load(cuda::memory_order_relaxed);
    bool eq = rw_lane_equal(keys.tab[0], keys.in[0], keys.dt[0], s, i);
    if (cur == 0) {
      cur = atomicCAS((int*)(stamp + s), 0, -1);
      if (cur == 0) {  // won the claim: write the slot, then publish
        fp1[s] = f1;
        fp2[s] = f2;
        for (int l = 0; l < keys.n; ++l) rw_lane_store(keys.tab[l], keys.in[l], keys.dt[l], s, i);
        rw_stamp_ref(stamp[s]).store(gen, cuda::memory_order_release);
        *seen = gen;
        *claimed = true;
        return (int32_t)s;
      }
    }
    if (cur == -1 || cur == gen) {  // claimed in this launch: wait for it, then acquire
      while ((cur = rw_stamp_ref(stamp[s]).load(cuda::memory_order_acquire)) == -1)
        __nanosleep(20);
      eq = rw_lane_equal(keys.tab[0], keys.in[0], keys.dt[0], s, i);
    }
    for (int l = 1; l < keys.n && eq; ++l)
      eq = rw_lane_equal(keys.tab[l], keys.in[l], keys.dt[l], s, i);
    if (!eq) continue;
    *seen = cur;
    return (int32_t)s;
  }
  return -1;
}
