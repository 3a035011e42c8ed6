// The hash table's probe loop, shared by kernel A (lookup_or_insert.cu,
// find-or-insert) and kernel M (join_probe.cu, the read-only lookup of
// risingwave_tpu/ops/hash_table.py:lookup :232 and the join probe).
//
// A key's fingerprints are K1 (hashing.cuh) over its lanes: h1 picks
// the home slot, fp1 = h1 (0 remapped to 1, since fp1 == 0 marks an
// EMPTY slot) and fp2 = h2 are stored per slot. Probing visits
// (h1 + t) & mask for t < RW_MAX_PROBE and compares fingerprints, then
// every key lane exactly (NaN equals NaN for float lanes). Table lanes
// are read with volatile loads: kernel A reads slots other threads of
// the same launch are writing.
#pragma once

#include "hashing.cuh"

#define RW_MAX_PROBE 64

struct KeyLanes {
  const void* in[RW_MAX_LANES];   // (n,) input key lanes
  void* tab[RW_MAX_LANES];        // (cap,) table key lanes, same dtypes
  int dt[RW_MAX_LANES];
  int n;
};

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
__device__ __forceinline__ void rw_key_hash(const KeyLanes& keys, int64_t i, uint32_t& h1,
                                            int32_t& f1, int32_t& f2) {
  uint32_t a = RW_HASH_INIT, b = RW_HASH_INIT ^ RW_SEED_FP2;
  for (int l = 0; l < keys.n; ++l) rw_hash_lane(keys.in[l], keys.dt[l], i, a, b);
  h1 = rw_mix32(a);
  f1 = (int32_t)(h1 == 0u ? 1u : h1);
  f2 = (int32_t)rw_mix32(b);
}

__device__ __forceinline__ bool rw_lane_equal(const void* tab, const void* in, int dt,
                                              int64_t s, int64_t i) {
  switch (dt) {
    case RW_BOOL:
      return (((const volatile uint8_t*)tab)[s] != 0) == (((const uint8_t*)in)[i] != 0);
    case RW_I32:
      return ((const volatile int32_t*)tab)[s] == ((const int32_t*)in)[i];
    case RW_I64:
      return ((const volatile long long*)tab)[s] == ((const long long*)in)[i];
    case RW_F32: {
      float a = ((const volatile float*)tab)[s], b = ((const float*)in)[i];
      return a == b || (isnan(a) && isnan(b));
    }
    case RW_F64: {
      double a = ((const volatile double*)tab)[s], b = ((const double*)in)[i];
      return a == b || (isnan(a) && isnan(b));
    }
  }
  return false;
}

__device__ __forceinline__ bool rw_keys_equal(const KeyLanes& keys, int64_t s, int64_t i) {
  bool eq = true;
  for (int l = 0; l < keys.n && eq; ++l)
    eq = rw_lane_equal(keys.tab[l], keys.in[l], keys.dt[l], s, i);
  return eq;
}

// Read-only probe of row i: its slot, or -1 when the chain reaches an
// EMPTY slot (or runs past RW_MAX_PROBE) without the key. No other
// thread writes the table during the launch.
__device__ __forceinline__ int32_t rw_probe_readonly(const KeyLanes& keys, int64_t i,
                                                     const int32_t* fp1, const int32_t* fp2,
                                                     uint32_t mask) {
  uint32_t h1;
  int32_t f1, f2;
  rw_key_hash(keys, i, h1, f1, f2);
  for (int t = 0; t < RW_MAX_PROBE; ++t) {
    const int64_t s = (int64_t)((h1 + (uint32_t)t) & mask);
    const int32_t sf1 = fp1[s];
    if (sf1 == f1 && fp2[s] == f2 && rw_keys_equal(keys, s, i)) return (int32_t)s;
    if (sf1 == 0) return -1;  // EMPTY: the key is absent
  }
  return -1;
}
