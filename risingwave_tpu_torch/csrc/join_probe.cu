// Kernel M: the join's probe of the other side and the compaction of the
// matched pairs into one fixed-capacity output chunk.
//
// Replaces risingwave_tpu/ops/join.py:probe_side (:407), gather_matches
// (:420) and compact_pairs (:429) as risingwave_tpu/executors/
// hash_join.py:join_step_fn (:91) uses them for an inner join (the
// pairs group, :139-238), with ops/hash_table.py:lookup (:232) inside.
// rw_lookup is that lookup alone.
//
// What it computes, as the reference: per active probe row, a read-only
// lookup of its key in the other side's table (probe.cuh, the probe
// loop of kernel A); found = the slot is live; the (n, fanout) match
// mask is the slot's row_valid entries on found rows, mc per row its
// count. The pairs are compacted in the reference's order (probe row
// major, bucket position minor) into the first min(total, out_cap)
// rows of the output: the probe row's own lanes, the stored entry's
// lanes and null lanes, op INSERT or DELETE from the probe row's sign,
// valid set. Rows past the last pair keep the zeros the wrapper
// allocated. em_overflow latches total > out_cap; join_rows, if given,
// gets the pairs written added (the fused program's telemetry counter).
//
// What bounds it on the card: per probe row, one random probe (fp1,
// fp2, key lanes and live of a 2^23+-slot table, a 32-byte sector
// each) and, on a hit, the bucket's row_valid bytes; per pair, each of
// the other side's lanes read at random and every output lane written
// coalesced. q8's chunks (65,536 probe rows, up to 16,384 pairs) move a
// few MB, so the three launches are short.
//
// Design: count / scan / write, as kernel C, with no atomics, so the
// order is the reference's cumsum order without a sort:
//   1. probe + count: one row per thread; its slot and mc go to scratch
//      and each 256-row tile's total to tile_counts;
//   2. scan: one block turns the tile totals into offsets, and writes
//      the latch and the counter;
//   3. write: each tile rescans its rows' mc and writes each row's pairs
//      from its offset, dropping those at or past out_cap.
#include "probe.cuh"

#define JP_THREADS 256
#define JP_SCAN_THREADS 1024
#define JP_MAX_OUT 16

struct OutLanes {
  const void* src[JP_MAX_OUT];  // own: (n,) chunk lane; other: (cap * fanout,) bucket lane
  void* dst[JP_MAX_OUT];        // (out_cap,) output lane
  int other[JP_MAX_OUT];        // 1: read at the matched entry; 0: at the probe row
  int esize[JP_MAX_OUT];        // 1, 4 or 8 bytes; a null lane is a 1-byte lane
  int n;
};

__global__ void lookup_kernel(KeyLanes keys, int64_t n, const uint8_t* valid,
                              const int32_t* fp1, const int32_t* fp2, const uint8_t* live,
                              uint32_t mask, int32_t* slots, uint8_t* found) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t s = -1;
  if (valid[i]) s = rw_probe_readonly(keys, i, fp1, fp2, mask);
  slots[i] = s;
  found[i] = s >= 0 && live[s] ? 1 : 0;
}

__device__ __forceinline__ int jp_bucket_count(const uint8_t* row_valid, int64_t s, int fanout) {
  int c = 0;
  for (int j = 0; j < fanout; ++j) c += row_valid[s * fanout + j] ? 1 : 0;
  return c;
}

__global__ void probe_count_kernel(KeyLanes keys, int64_t n, const uint8_t* valid,
                                   const int32_t* fp1, const int32_t* fp2, const uint8_t* live,
                                   uint32_t mask, const uint8_t* row_valid, int fanout,
                                   int32_t* slot_of, int32_t* mc_of, int32_t* tile_counts) {
  const int64_t i = (int64_t)blockIdx.x * JP_THREADS + threadIdx.x;
  int mc = 0;
  if (i < n) {
    int32_t s = -1;
    if (valid[i]) {
      s = rw_probe_readonly(keys, i, fp1, fp2, mask);
      if (s >= 0 && !live[s]) s = -1;  // a tombstoned key matches nothing
    }
    if (s >= 0) mc = jp_bucket_count(row_valid, s, fanout);
    slot_of[i] = s;
    mc_of[i] = mc;
  }
  int excl;
  const int total = rw_block_exclusive_scan<JP_THREADS>(mc, &excl);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

__global__ void probe_scan_kernel(int32_t* tile_counts, int n_tiles, int32_t out_cap,
                                  uint8_t* em_overflow, long long* join_rows) {
  const int per = (n_tiles + JP_SCAN_THREADS - 1) / JP_SCAN_THREADS;
  const int lo = threadIdx.x * per;
  long long local = 0;
  for (int j = lo; j < lo + per && j < n_tiles; ++j) local += tile_counts[j];
  int excl;
  // totals fit an int: at most n * fanout pairs, n < 2^31 / fanout
  const int total = rw_block_exclusive_scan<JP_SCAN_THREADS>((int)local, &excl);
  int run = excl;
  for (int j = lo; j < lo + per && j < n_tiles; ++j) {
    const int c = tile_counts[j];
    tile_counts[j] = run;
    run += c;
  }
  if (threadIdx.x == 0) {
    if (total > out_cap) *em_overflow = 1;
    if (join_rows != nullptr) *join_rows += (long long)(total < out_cap ? total : out_cap);
  }
}

__device__ __forceinline__ void jp_copy(void* dst, int64_t d, const void* src, int64_t s,
                                        int esize) {
  switch (esize) {
    case 1: ((uint8_t*)dst)[d] = ((const uint8_t*)src)[s]; break;
    case 4: ((uint32_t*)dst)[d] = ((const uint32_t*)src)[s]; break;
    case 8: ((unsigned long long*)dst)[d] = ((const unsigned long long*)src)[s]; break;
  }
}

__global__ void probe_write_kernel(OutLanes out, int64_t n, const int32_t* ops,
                                   const uint8_t* row_valid, int fanout, const int32_t* slot_of,
                                   const int32_t* mc_of, const int32_t* tile_offsets,
                                   int32_t out_cap, int32_t* out_ops, uint8_t* out_valid) {
  const int64_t i = (int64_t)blockIdx.x * JP_THREADS + threadIdx.x;
  const int mc = i < n ? mc_of[i] : 0;
  int excl;
  rw_block_exclusive_scan<JP_THREADS>(mc, &excl);
  if (mc == 0) return;
  int64_t p = (int64_t)tile_offsets[blockIdx.x] + excl;
  const int64_t s = slot_of[i];
  const int32_t op = ops[i];
  const int32_t out_op = (op == 1 || op == 2) ? 1 : 0;  // sign < 0: DELETE, else INSERT
  for (int j = 0; j < fanout && p < out_cap; ++j) {
    const int64_t e = s * fanout + j;
    if (!row_valid[e]) continue;
    for (int k = 0; k < out.n; ++k)
      jp_copy(out.dst[k], p, out.src[k], out.other[k] ? e : i, out.esize[k]);
    out_ops[p] = out_op;
    out_valid[p] = 1;
    ++p;
  }
}

// lanes: n_keys rows of (input ptr, dtype code, table ptr), int64.
RW_EXPORT int rw_lookup(const int64_t* lanes, int n_keys, int64_t n, const void* valid,
                        const void* fp1, const void* fp2, const void* live, int64_t cap,
                        void* slots, void* found, void* stream) {
  KeyLanes k;
  if (!rw_key_lanes(lanes, n_keys, &k)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int threads = 256;
    lookup_kernel<<<rw_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
        k, n, (const uint8_t*)valid, (const int32_t*)fp1, (const int32_t*)fp2,
        (const uint8_t*)live, (uint32_t)(cap - 1), (int32_t*)slots, (uint8_t*)found);
  }
  return (int)cudaGetLastError();
}

// keys: as rw_lookup, against the other side's table; outs: n_out rows
// of (src, is_other, dst, esize), int64 (value lanes then null lanes,
// in the output's order); slot_of/mc_of: (n,) int32 scratch;
// tile_counts: ceil(n / 256) int32 scratch; out_ops/out_valid and every
// dst zero-filled by the caller; join_rows an int64 counter or null.
RW_EXPORT int rw_join_probe(const int64_t* keys, int n_keys, int64_t n, const void* valid,
                            const void* ops, const void* fp1, const void* fp2,
                            const void* live, int64_t cap, const void* row_valid, int fanout,
                            const int64_t* outs, int n_out, int out_cap, void* out_ops,
                            void* out_valid, void* slot_of, void* mc_of, void* tile_counts,
                            void* em_overflow, void* join_rows, void* stream) {
  KeyLanes k;
  if (!rw_key_lanes(keys, n_keys, &k) || n_out < 0 || n_out > JP_MAX_OUT || fanout < 1 ||
      n * (int64_t)fanout >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  OutLanes o;
  o.n = n_out;
  for (int l = 0; l < n_out; ++l) {
    const int64_t* r = outs + 4 * l;
    o.src[l] = (const void*)r[0];
    o.other[l] = (int)r[1];
    o.dst[l] = (void*)r[2];
    o.esize[l] = (int)r[3];
    if (o.esize[l] != 1 && o.esize[l] != 4 && o.esize[l] != 8) return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaGetLastError();
  const int tiles = (int)((n + JP_THREADS - 1) / JP_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  probe_count_kernel<<<tiles, JP_THREADS, 0, st>>>(
      k, n, (const uint8_t*)valid, (const int32_t*)fp1, (const int32_t*)fp2,
      (const uint8_t*)live, (uint32_t)(cap - 1), (const uint8_t*)row_valid, fanout,
      (int32_t*)slot_of, (int32_t*)mc_of, (int32_t*)tile_counts);
  probe_scan_kernel<<<1, JP_SCAN_THREADS, 0, st>>>((int32_t*)tile_counts, tiles, out_cap,
                                                   (uint8_t*)em_overflow, (long long*)join_rows);
  probe_write_kernel<<<tiles, JP_THREADS, 0, st>>>(
      o, n, (const int32_t*)ops, (const uint8_t*)row_valid, fanout, (const int32_t*)slot_of,
      (const int32_t*)mc_of, (const int32_t*)tile_counts, (int32_t)out_cap, (int32_t*)out_ops,
      (uint8_t*)out_valid);
  return (int)cudaGetLastError();
}
