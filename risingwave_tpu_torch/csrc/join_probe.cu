// Kernel M: the join's probe of the other side and the compaction of the
// probe chunk's emission (the pairs, then the own NULL-pad, semi or anti
// rows) into one fixed-capacity output chunk.
//
// Replaces risingwave_tpu/ops/join.py:probe_side (:407), gather_matches
// (:420) and compact_pairs (:429) as risingwave_tpu/executors/
// hash_join.py:join_step_fn (:91) uses them: group 1, the pairs
// (:156-172), and group 2, the rows judged by their match count mc
// (:174-195), with ops/hash_table.py:lookup (:232) inside. rw_lookup is
// that lookup alone.
//
// What it computes, as the reference: per active probe row, a read-only
// lookup of its key in the other side's table (probe.cuh, the probe
// loop of kernel A); found = the slot is live; the (n, fanout) match
// mask is the slot's row_valid entries on found rows, mc per row its
// count. Group 1 (pairs_on): one row per (probe row, live match), probe
// row major, bucket position minor: the probe row's own lanes, the
// stored entry's lanes and null lanes. Group 2 (group2 != 0), after
// every pair: each active probe row with mc == 0 (outer: its other-side
// lanes NULL-padded, the lanes flagged g2_one written 1; anti) or mc > 0
// (semi), its own lanes. Ops INSERT or DELETE from the probe row's sign.
// Both groups land in the first min(total, out_cap) rows of the output,
// valid set; rows past the last keep the zeros the wrapper allocated.
// written gets the total (uncapped; kernel P appends group 3 after it),
// em_overflow latches total > out_cap, join_rows, if given, gets the
// rows written added (the fused program's telemetry counter). slot_of
// (the probed slot, -1 without a live match) and mc_of are outputs too:
// P reads the matches from them, L seeds inserted rows' degrees with mc.
//
// What bounds it on the card: per probe row, one random probe (fp1,
// fp2, key lanes and live of a 2^22+-slot table, a 32-byte sector
// each) and, on a hit, the bucket's row_valid bytes; per emitted row,
// each of the other side's lanes read at random and every output lane
// written coalesced. A 65,536-row chunk moves a few MB, so the three
// launches are short.
//
// Design: count / scan / write, as kernel C, with no atomics, so the
// order is the reference's cumsum order without a sort:
//   1. probe + count: one row per thread; its slot and mc go to slot_of
//      and mc_of, each 256-row tile's pair total to tile_counts[t] and
//      its group-2 total to tile_counts[tiles + t];
//   2. scan: one block turns the 2 * tiles totals, pairs first, into
//      offsets (group 2's start after the last pair), and writes
//      written, the latch and the counter;
//   3. write: each tile rescans its rows' counts and writes each row's
//      pairs and its group-2 row from their offsets, dropping those at
//      or past out_cap.
#include "probe.cuh"

#define JP_THREADS 256
#define JP_SCAN_THREADS 1024
#define JP_MAX_OUT 16

// group2 modes (ops/join.py G2_*)
#define JP_G2_NONE 0
#define JP_G2_OUTER 1
#define JP_G2_SEMI 2
#define JP_G2_ANTI 3

struct OutLanes {
  const void* src[JP_MAX_OUT];  // own: (n,) chunk lane; other: (cap * fanout,) bucket lane; or null
  void* dst[JP_MAX_OUT];        // (out_cap,) output lane
  int other[JP_MAX_OUT];        // 1: read at the matched entry; 0: at the probe row
  int esize[JP_MAX_OUT];        // 1, 4 or 8 bytes; a null lane is a 1-byte lane
  int g2_one[JP_MAX_OUT];       // 1: a group-2 row writes 1 here (an outer NULL pad)
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

// Does an active probe row with match count mc write a group-2 row?
__device__ __forceinline__ int jp_group2(int mode, bool active, int mc) {
  if (!active || mode == JP_G2_NONE) return 0;
  return (mode == JP_G2_SEMI ? mc > 0 : mc == 0) ? 1 : 0;
}

__global__ void probe_count_kernel(KeyLanes keys, int64_t n, const uint8_t* valid,
                                   const int32_t* fp1, const int32_t* fp2, const uint8_t* live,
                                   uint32_t mask, const uint8_t* row_valid, int fanout,
                                   int pairs_on, int group2, int32_t* slot_of, int32_t* mc_of,
                                   int32_t* tile_counts, int tiles) {
  const int64_t i = (int64_t)blockIdx.x * JP_THREADS + threadIdx.x;
  int mc = 0, g2 = 0;
  if (i < n) {
    int32_t s = -1;
    const bool active = valid[i] != 0;
    if (active) {
      s = rw_probe_readonly(keys, i, fp1, fp2, mask);
      if (s >= 0 && !live[s]) s = -1;  // a tombstoned key matches nothing
    }
    if (s >= 0) mc = jp_bucket_count(row_valid, s, fanout);
    slot_of[i] = s;
    mc_of[i] = mc;
    g2 = jp_group2(group2, active, mc);
  }
  int excl;
  const int pairs = rw_block_exclusive_scan<JP_THREADS>(pairs_on ? mc : 0, &excl);
  const int g2_total = rw_block_exclusive_scan<JP_THREADS>(g2, &excl);
  if (threadIdx.x == 0) {
    tile_counts[blockIdx.x] = pairs;
    tile_counts[tiles + blockIdx.x] = g2_total;
  }
}

// One block: exclusive scan of n_counts tile totals in place; the total
// goes to written, the latch and the counter.
__global__ void probe_scan_kernel(int32_t* tile_counts, int n_counts, int32_t out_cap,
                                  int32_t* written, uint8_t* em_overflow, long long* join_rows) {
  const int per = (n_counts + JP_SCAN_THREADS - 1) / JP_SCAN_THREADS;
  const int lo = threadIdx.x * per;
  long long local = 0;
  for (int j = lo; j < lo + per && j < n_counts; ++j) local += tile_counts[j];
  int excl;
  // totals fit an int: at most n * (fanout + 1) rows, checked by the entry
  const int total = rw_block_exclusive_scan<JP_SCAN_THREADS>((int)local, &excl);
  int run = excl;
  for (int j = lo; j < lo + per && j < n_counts; ++j) {
    const int c = tile_counts[j];
    tile_counts[j] = run;
    run += c;
  }
  if (threadIdx.x == 0) {
    *written = total;
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

__global__ void probe_write_kernel(OutLanes out, int64_t n, const uint8_t* valid,
                                   const int32_t* ops, const uint8_t* row_valid, int fanout,
                                   int pairs_on, int group2, const int32_t* slot_of,
                                   const int32_t* mc_of, const int32_t* tile_offsets, int tiles,
                                   int32_t out_cap, int32_t* out_ops, uint8_t* out_valid) {
  const int64_t i = (int64_t)blockIdx.x * JP_THREADS + threadIdx.x;
  const int mc = i < n ? mc_of[i] : 0;
  const int g2 = i < n ? jp_group2(group2, valid[i] != 0, mc) : 0;
  int excl_p, excl_g;
  rw_block_exclusive_scan<JP_THREADS>(pairs_on ? mc : 0, &excl_p);
  rw_block_exclusive_scan<JP_THREADS>(g2, &excl_g);
  if (i >= n) return;
  const int32_t op = ops[i];
  const int32_t out_op = (op == 1 || op == 2) ? 1 : 0;  // sign < 0: DELETE, else INSERT
  if (pairs_on && mc > 0) {
    int64_t p = (int64_t)tile_offsets[blockIdx.x] + excl_p;
    const int64_t s = slot_of[i];
    for (int j = 0; j < fanout && p < out_cap; ++j) {
      const int64_t e = s * fanout + j;
      if (!row_valid[e]) continue;
      for (int k = 0; k < out.n; ++k)
        if (out.src[k] != nullptr)
          jp_copy(out.dst[k], p, out.src[k], out.other[k] ? e : i, out.esize[k]);
      out_ops[p] = out_op;
      out_valid[p] = 1;
      ++p;
    }
  }
  if (g2) {
    const int64_t p = (int64_t)tile_offsets[tiles + blockIdx.x] + excl_g;
    if (p >= out_cap) return;
    for (int k = 0; k < out.n; ++k) {
      if (out.other[k]) {
        if (out.g2_one[k]) ((uint8_t*)out.dst[k])[p] = 1;  // NULL pad
      } else if (out.src[k] != nullptr) {
        jp_copy(out.dst[k], p, out.src[k], i, out.esize[k]);
      }
    }
    out_ops[p] = out_op;
    out_valid[p] = 1;
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
// of (src or 0, is_other, dst, esize, g2_one), int64 (value lanes then
// null lanes, in the output's order); slot_of/mc_of: (n,) int32
// outputs; tile_counts: 2 * ceil(n / 256) int32 scratch; written: a ()
// int32 output; out_ops/out_valid and every dst zero-filled by the
// caller; join_rows an int64 counter or null; pairs_on 0/1; group2 a
// JP_G2_* mode.
RW_EXPORT int rw_join_probe(const int64_t* keys, int n_keys, int64_t n, const void* valid,
                            const void* ops, const void* fp1, const void* fp2,
                            const void* live, int64_t cap, const void* row_valid, int fanout,
                            const int64_t* outs, int n_out, int out_cap, void* out_ops,
                            void* out_valid, void* slot_of, void* mc_of, void* tile_counts,
                            void* written, void* em_overflow, void* join_rows, int pairs_on,
                            int group2, void* stream) {
  KeyLanes k;
  if (!rw_key_lanes(keys, n_keys, &k) || n_out < 0 || n_out > JP_MAX_OUT || fanout < 1 ||
      n * ((int64_t)fanout + 1) >= ((int64_t)1 << 31) || group2 < JP_G2_NONE ||
      group2 > JP_G2_ANTI)
    return (int)cudaErrorInvalidValue;
  OutLanes o;
  o.n = n_out;
  for (int l = 0; l < n_out; ++l) {
    const int64_t* r = outs + 5 * l;
    o.src[l] = (const void*)r[0];
    o.other[l] = (int)r[1];
    o.dst[l] = (void*)r[2];
    o.esize[l] = (int)r[3];
    o.g2_one[l] = (int)r[4];
    if (o.esize[l] != 1 && o.esize[l] != 4 && o.esize[l] != 8) return (int)cudaErrorInvalidValue;
    if (o.g2_one[l] && o.esize[l] != 1) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 0) return (int)cudaMemsetAsync(written, 0, sizeof(int32_t), st);
  const int tiles = (int)((n + JP_THREADS - 1) / JP_THREADS);
  probe_count_kernel<<<tiles, JP_THREADS, 0, st>>>(
      k, n, (const uint8_t*)valid, (const int32_t*)fp1, (const int32_t*)fp2,
      (const uint8_t*)live, (uint32_t)(cap - 1), (const uint8_t*)row_valid, fanout, pairs_on,
      group2, (int32_t*)slot_of, (int32_t*)mc_of, (int32_t*)tile_counts, tiles);
  probe_scan_kernel<<<1, JP_SCAN_THREADS, 0, st>>>((int32_t*)tile_counts, 2 * tiles, out_cap,
                                                   (int32_t*)written, (uint8_t*)em_overflow,
                                                   (long long*)join_rows);
  probe_write_kernel<<<tiles, JP_THREADS, 0, st>>>(
      o, n, (const uint8_t*)valid, (const int32_t*)ops, (const uint8_t*)row_valid, fanout,
      pairs_on, group2, (const int32_t*)slot_of, (const int32_t*)mc_of,
      (const int32_t*)tile_counts, tiles, (int32_t)out_cap, (int32_t*)out_ops,
      (uint8_t*)out_valid);
  return (int)cudaGetLastError();
}
