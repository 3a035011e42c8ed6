// K1: the compound-key hash of risingwave_tpu/ops/hashing.py
// (hash_columns :80, hash128 :94), bit-exact, as __device__ functions.
//
// Each key lane is cut into uint32 words (64-bit lanes into lo then hi;
// bool as 0/1; floats canonicalised so -0.0 == +0.0 and every NaN is
// one NaN), each word goes through murmur3 fmix32 and a boost
// hash_combine chain, and the chain ends in one more fmix32. Two seeds
// give the fingerprint pair (fp1, fp2). The plain PyTorch twin is
// risingwave_tpu_torch/ops/hashing.py.
#pragma once

#include "common.cuh"

#define RW_HASH_INIT 0x811C9DC5u
#define RW_SEED_FP2 0x5BD1E995u

__device__ __forceinline__ uint32_t rw_mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t rw_combine(uint32_t h, uint32_t w) {
  return h ^ (rw_mix32(w) + 0x9E3779B9u + (h << 6) + (h >> 2));
}

// Fold one word into both chains of hash128.
__device__ __forceinline__ void rw_fold2(uint32_t w, uint32_t& h1, uint32_t& h2) {
  h1 = rw_combine(h1, w);
  h2 = rw_combine(h2, w);
}

// Fold row i of one key lane into both chains.
__device__ __forceinline__ void rw_hash_lane(const void* lane, int dt, int64_t i,
                                             uint32_t& h1, uint32_t& h2) {
  switch (dt) {
    case RW_BOOL:
      rw_fold2(((const uint8_t*)lane)[i] ? 1u : 0u, h1, h2);
      break;
    case RW_I32:
      rw_fold2((uint32_t)((const int32_t*)lane)[i], h1, h2);
      break;
    case RW_I64: {
      uint64_t v = (uint64_t)((const long long*)lane)[i];
      rw_fold2((uint32_t)v, h1, h2);
      rw_fold2((uint32_t)(v >> 32), h1, h2);
      break;
    }
    case RW_F32: {
      uint32_t b = __float_as_uint(((const float*)lane)[i]);
      if ((b & 0x7FFFFFFFu) == 0u) b = 0u;
      if ((b & 0x7F800000u) == 0x7F800000u && (b & 0x007FFFFFu)) b = 0x7FC00000u;
      rw_fold2(b, h1, h2);
      break;
    }
    case RW_F64: {
      uint64_t b = (uint64_t)__double_as_longlong(((const double*)lane)[i]);
      if ((b & 0x7FFFFFFFFFFFFFFFull) == 0ull) b = 0ull;
      if ((b & 0x7FF0000000000000ull) == 0x7FF0000000000000ull &&
          (b & 0x000FFFFFFFFFFFFFull))
        b = 0x7FF8000000000000ull;
      rw_fold2((uint32_t)b, h1, h2);
      rw_fold2((uint32_t)(b >> 32), h1, h2);
      break;
    }
  }
}
