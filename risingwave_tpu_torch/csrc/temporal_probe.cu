// Kernel AB: the temporal join's probe of a device MV.
//
// Replaces risingwave_tpu/executors/temporal_join.py:_probe_step (:32),
// which is ops/hash_table.py:lookup (:232, K3) over the MV's pk table,
// then a gather of each output value lane at the found slot, then the
// output's null lanes and valid. Per row i of the stream chunk, as the
// reference:
//   - active = valid[i] && key_ok[i] (a NULL key never matches: its
//     placeholder lane value would hit a real pk);
//   - slot = the read-only probe of the key lanes (csrc/probe.cuh, K3's
//     loop), found = slot >= 0 && live[slot] (a deleted MV row does not
//     match), idx = found ? slot : cap - 1 (the reference's safe lane);
//   - for each output column: dst[i] = values[idx], dnull[i] = !found ||
//     vnull[idx] (vnull only where the MV column is nullable);
//   - valid_out[i] = valid[i] for a left join, valid[i] && found for inner.
// The chunk's own lanes and ops pass through untouched (the wrapper reuses
// their tensors).
//
// What bounds it on the card: per row, one random probe of the table (a
// 32-byte sector of fp1, fp2, each key lane and live, usually one step)
// and one random read of each output value and null lane; the chunk's
// key, valid and key_ok lanes are read and the outputs written coalesced.
//
// Design: one thread per row, the probe and every gather in one launch.
#include "probe.cuh"

#define TP_MAX_OUT 16

struct ProbeOuts {
  const void* val[TP_MAX_OUT];     // (cap,) MV value lane
  const uint8_t* vnull[TP_MAX_OUT];  // (cap,) MV null lane, or null
  void* dst[TP_MAX_OUT];           // (n,) output value lane
  uint8_t* dnull[TP_MAX_OUT];      // (n,) output null lane
  int esize[TP_MAX_OUT];
  int n;
};

__global__ void temporal_probe_kernel(KeyLanes keys, int64_t n, const uint8_t* valid,
                                      const uint8_t* key_ok, const int32_t* fp1,
                                      const int32_t* fp2, const uint8_t* live, uint32_t mask,
                                      ProbeOuts o, int left, uint8_t* valid_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool v = valid[i] != 0;
  int32_t s = -1;
  if (v && key_ok[i]) s = rw_probe_readonly(keys, i, fp1, fp2, mask);
  const bool found = s >= 0 && live[s];
  const int64_t idx = found ? (int64_t)s : (int64_t)mask;  // cap - 1 on a miss
  for (int l = 0; l < o.n; ++l) {
    switch (o.esize[l]) {
      case 1: ((uint8_t*)o.dst[l])[i] = ((const uint8_t*)o.val[l])[idx]; break;
      case 4: ((uint32_t*)o.dst[l])[i] = ((const uint32_t*)o.val[l])[idx]; break;
      case 8:
        ((unsigned long long*)o.dst[l])[i] = ((const unsigned long long*)o.val[l])[idx];
        break;
    }
    o.dnull[l][i] = (!found || (o.vnull[l] != nullptr && o.vnull[l][idx])) ? 1 : 0;
  }
  valid_out[i] = (v && (left || found)) ? 1 : 0;
}

// keys: n_keys rows of (input key lane, dtype code, table key lane), the
// input lanes in the table's dtypes; valid, key_ok: (n,) bool; fp1, fp2,
// live: the MV's (cap,) table lanes; outs: n_out rows of (value lane,
// null lane or 0, dst, dnull, esize), int64; left: 1 for a left join;
// valid_out: (n,) bool.
RW_EXPORT int rw_temporal_probe(const int64_t* keys, int n_keys, int64_t n, const void* valid,
                                const void* key_ok, const void* fp1, const void* fp2,
                                const void* live, int64_t cap, const int64_t* outs, int n_out,
                                int left, void* valid_out, void* stream) {
  KeyLanes k;
  if (!rw_key_lanes(keys, n_keys, &k) || n_out < 0 || n_out > TP_MAX_OUT || cap < 1 ||
      (cap & (cap - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  ProbeOuts o;
  o.n = n_out;
  for (int l = 0; l < n_out; ++l) {
    const int64_t* r = outs + 5 * l;
    o.val[l] = (const void*)r[0];
    o.vnull[l] = (const uint8_t*)r[1];
    o.dst[l] = (void*)r[2];
    o.dnull[l] = (uint8_t*)r[3];
    o.esize[l] = (int)r[4];
    if (o.esize[l] != 1 && o.esize[l] != 4 && o.esize[l] != 8) return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    const int threads = 256;
    temporal_probe_kernel<<<rw_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
        k, n, (const uint8_t*)valid, (const uint8_t*)key_ok, (const int32_t*)fp1,
        (const int32_t*)fp2, (const uint8_t*)live, (uint32_t)(cap - 1), o, left,
        (uint8_t*)valid_out);
  }
  return (int)cudaGetLastError();
}
