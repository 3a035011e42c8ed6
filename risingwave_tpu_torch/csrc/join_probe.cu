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
// valid set; every row past them is written zero (valid false), so the
// caller's output lanes need no fill. written gets the total (uncapped;
// kernel P appends group 3 after it), em_overflow latches total >
// out_cap, join_rows, if given, gets the rows written added (the fused
// program's telemetry counter). slot_of (the probed slot, -1 without a
// live match) and mc_of are outputs too: P reads the matches from them,
// L seeds inserted rows' degrees with mc.
//
// What bounds it on the card: per probe row, one random probe (fp1,
// fp2, key lanes and live of a 2^22+-slot table, a 32-byte sector
// each) and, on a hit, the bucket's row_valid bytes; per emitted row,
// each of the other side's lanes read at random; every output row
// written once. A 65,536-row chunk moves a few MB: the card's share is
// microseconds, so launches and the host's work bound the call.
//
// Design: one pass probes, places and writes. Each tile of 256 probe
// rows takes its index from an atomic counter, probes its rows once,
// scans their pair and group-2 counts, publishes them at once and finds
// the counts of every earlier tile by a decoupled look-back (32 words at
// a time; a tile that never publishes traps after 2^26 reads rather than
// hang), then writes its pairs at their places (the order is the
// reference's cumsum order: probe row major, no sort). The last tile
// writes written, the latch and the counter. A few tail blocks, which
// take their indices after every tile, wait for the last tile's
// inclusive counts and write zero rows from min(total, out_cap) to
// out_cap. Group 2 follows every pair, so its places need the pair
// total: with pairs off (semi, anti) it starts at 0 and the one pass
// writes it; with pairs on (the outer joins) a second short launch writes
// it once the pass has published every tile. The inner joins run one
// launch (and one memset of the look-back words).
#include "probe.cuh"

#define JP_THREADS 256
#define JP_MAX_OUT 32  // = ops/join.PROBE_LANES
#define JP_TAIL_BLOCKS 16

// group2 modes (ops/join.py G2_*)
#define JP_G2_NONE 0
#define JP_G2_OUTER 1
#define JP_G2_SEMI 2
#define JP_G2_ANTI 3

struct OutLanes {
  const void* src[JP_MAX_OUT];  // own: (n,) chunk lane; other: (cap * fanout,) bucket lane; or
                                // null: written 0 (1 on a group-2 row where g2_one)
  void* dst[JP_MAX_OUT];        // (out_cap,) output lane
  int other[JP_MAX_OUT];        // 1: read at the matched entry (0 on a group-2 row); 0: at the
                                // probe row
  int esize[JP_MAX_OUT];        // 1, 4 or 8 bytes
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

__device__ __forceinline__ unsigned long long jp_load(const void* src, int64_t s, int esize) {
  switch (esize) {
    case 1: return ((const uint8_t*)src)[s];
    case 4: return ((const uint32_t*)src)[s];
    default: return ((const unsigned long long*)src)[s];
  }
}

__device__ __forceinline__ void jp_store(void* dst, int64_t d, int esize, unsigned long long v) {
  switch (esize) {
    case 1: ((uint8_t*)dst)[d] = (uint8_t)v; break;
    case 4: ((uint32_t*)dst)[d] = (uint32_t)v; break;
    default: ((unsigned long long*)dst)[d] = v; break;
  }
}

// Output row p: probe row i's own lanes and entry e's (e < 0: a group-2
// row, the other side's lanes 0, or 1 where g2_one), its op, valid.
__device__ __forceinline__ void jp_write_row(const OutLanes& out, int64_t p, int64_t i, int64_t e,
                                             int32_t op, int32_t* out_ops, uint8_t* out_valid) {
  for (int k = 0; k < out.n; ++k) {
    unsigned long long v = 0ull;
    if (out.other[k]) {
      if (e >= 0 && out.src[k] != nullptr) v = jp_load(out.src[k], e, out.esize[k]);
      else if (e < 0 && out.g2_one[k]) v = 1ull;  // NULL pad
    } else if (out.src[k] != nullptr) {
      v = jp_load(out.src[k], i, out.esize[k]);
    }
    jp_store(out.dst[k], p, out.esize[k], v);
  }
  out_ops[p] = op;
  out_valid[p] = 1;
}

__device__ __forceinline__ int32_t jp_out_op(const int32_t* ops, int64_t i) {
  const int32_t op = ops[i];
  return (op == 1 || op == 2) ? 1 : 0;  // sign < 0: DELETE, else INSERT
}

// The one pass: blocks take their index from status[tiles] in turn; the
// first `tiles` probe 256 rows each (above), the JP_TAIL_BLOCKS after them
// zero the rows past min(total, out_cap) once the last tile has published.
__global__ void __launch_bounds__(JP_THREADS)
    jp_probe_kernel(KeyLanes keys, OutLanes out, int64_t n, const uint8_t* valid,
                    const int32_t* ops, const int32_t* fp1, const int32_t* fp2,
                    const uint8_t* live, uint32_t mask, const uint8_t* row_valid, int fanout,
                    int pairs_on, int group2, int32_t out_cap, int32_t* out_ops,
                    uint8_t* out_valid, int32_t* slot_of, int32_t* mc_of,
                    unsigned long long* status, unsigned tiles, int32_t* written,
                    uint8_t* em_overflow, long long* join_rows) {
  __shared__ unsigned s_tile;
  __shared__ uint32_t s_p, s_g;
  if (threadIdx.x == 0) s_tile = atomicAdd((unsigned*)(status + tiles), 1u);
  __syncthreads();
  const unsigned tile = s_tile;
  if (tile >= tiles) {  // a tail block
    if (threadIdx.x == 0) {
      const unsigned long long v = rw_lb_inclusive(status, tiles - 1);
      s_p = (uint32_t)(v >> 32);
      s_g = (uint32_t)v;
    }
    __syncthreads();
    const int64_t total = (int64_t)s_p + s_g;
    const int64_t from = total < out_cap ? total : out_cap;
    for (int64_t r = from + (int64_t)(tile - tiles) * JP_THREADS + threadIdx.x; r < out_cap;
         r += (int64_t)JP_TAIL_BLOCKS * JP_THREADS) {
      for (int k = 0; k < out.n; ++k) jp_store(out.dst[k], r, out.esize[k], 0ull);
      out_ops[r] = 0;
      out_valid[r] = 0;
    }
    return;
  }
  const int64_t i = (int64_t)tile * JP_THREADS + threadIdx.x;
  int mc = 0, g2 = 0;
  int32_t s = -1;
  if (i < n) {
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
  int xp, xg;
  const uint32_t tp = (uint32_t)rw_block_exclusive_scan<JP_THREADS>(pairs_on ? mc : 0, &xp);
  const uint32_t tg = (uint32_t)rw_block_exclusive_scan<JP_THREADS>(g2, &xg);
  if (threadIdx.x < 32) {
    uint32_t ep, eg;
    rw_lookback(status, tile, tp, tg, &ep, &eg);
    if (threadIdx.x == 0) {
      s_p = ep;
      s_g = eg;
      if (tile == tiles - 1) {
        const long long total = (long long)ep + tp + eg + tg;
        *written = (int32_t)total;
        if (total > out_cap) *em_overflow = 1;
        if (join_rows != nullptr) *join_rows += total < out_cap ? total : (long long)out_cap;
      }
    }
  }
  __syncthreads();
  if (i >= n) return;
  if (pairs_on && mc > 0) {
    const int32_t op = jp_out_op(ops, i);
    int64_t p = (int64_t)s_p + xp;
    for (int j = 0; j < fanout && p < out_cap; ++j) {
      const int64_t e = (int64_t)s * fanout + j;
      if (!row_valid[e]) continue;
      jp_write_row(out, p, i, e, op, out_ops, out_valid);
      ++p;
    }
  }
  if (g2 && !pairs_on) {  // group 2 alone: its rows start at 0
    const int64_t p = (int64_t)s_g + xg;
    if (p < out_cap) jp_write_row(out, p, i, -1, jp_out_op(ops, i), out_ops, out_valid);
  }
}

// Group 2 after the pairs (pairs_on): tile t's rows from the pair total
// plus the group-2 rows of the tiles before it (its inclusive word less
// its own count, scanned again).
__global__ void __launch_bounds__(JP_THREADS)
    jp_group2_kernel(OutLanes out, int64_t n, const uint8_t* valid, const int32_t* ops,
                     int group2, int32_t out_cap, int32_t* out_ops, uint8_t* out_valid,
                     const int32_t* mc_of, const unsigned long long* status, unsigned tiles) {
  const int64_t i = (int64_t)blockIdx.x * JP_THREADS + threadIdx.x;
  const int g2 = i < n ? jp_group2(group2, valid[i] != 0, mc_of[i]) : 0;
  int xg;
  const uint32_t tg = (uint32_t)rw_block_exclusive_scan<JP_THREADS>(g2, &xg);
  if (!g2) return;
  const int64_t pairs = (int64_t)((status[tiles - 1] >> 31) & RW_LB_COUNT);
  const int64_t before = (int64_t)(status[blockIdx.x] & RW_LB_COUNT) - tg;
  const int64_t p = pairs + before + xg;
  if (p < out_cap) jp_write_row(out, p, i, -1, jp_out_op(ops, i), out_ops, out_valid);
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
// of (src or 0, is_other, dst, esize, g2_one), int64, one per output
// lane (value lanes then null lanes, in the output's order); every
// output lane, out_ops and out_valid are written in full (no fill
// needed); slot_of/mc_of: (n,) int32 outputs; status: ceil(n / 256) + 1
// int64 scratch (zeroed here); written: a () int32 output; join_rows an
// int64 counter or null; pairs_on 0/1; group2 a JP_G2_* mode.
RW_EXPORT int rw_join_probe(const int64_t* keys, int n_keys, int64_t n, const void* valid,
                            const void* ops, const void* fp1, const void* fp2,
                            const void* live, int64_t cap, const void* row_valid, int fanout,
                            const int64_t* outs, int n_out, int out_cap, void* out_ops,
                            void* out_valid, void* slot_of, void* mc_of, void* status,
                            void* written, void* em_overflow, void* join_rows, int pairs_on,
                            int group2, void* stream) {
  KeyLanes k;
  if (!rw_key_lanes(keys, n_keys, &k) || n_out < 0 || n_out > JP_MAX_OUT || fanout < 1 ||
      n < 0 || out_cap < 0 || n * ((int64_t)fanout + 1) >= ((int64_t)1 << 31) ||
      group2 < JP_G2_NONE || group2 > JP_G2_ANTI)
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
    if ((o.dst[l] == nullptr && out_cap > 0) ||
        (o.esize[l] != 1 && o.esize[l] != 4 && o.esize[l] != 8) ||
        (o.g2_one[l] && o.esize[l] != 1))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned tiles = (unsigned)rw_blocks(n > 0 ? n : 1, JP_THREADS);  // n = 0: one empty tile
  cudaMemsetAsync(status, 0, sizeof(unsigned long long) * ((size_t)tiles + 1), st);
  jp_probe_kernel<<<tiles + JP_TAIL_BLOCKS, JP_THREADS, 0, st>>>(
      k, o, n, (const uint8_t*)valid, (const int32_t*)ops, (const int32_t*)fp1,
      (const int32_t*)fp2, (const uint8_t*)live, (uint32_t)(cap - 1), (const uint8_t*)row_valid,
      fanout, pairs_on, group2, (int32_t)out_cap, (int32_t*)out_ops, (uint8_t*)out_valid,
      (int32_t*)slot_of, (int32_t*)mc_of, (unsigned long long*)status, tiles, (int32_t*)written,
      (uint8_t*)em_overflow, (long long*)join_rows);
  if (pairs_on && group2 != JP_G2_NONE && n > 0)
    jp_group2_kernel<<<tiles, JP_THREADS, 0, st>>>(
        o, n, (const uint8_t*)valid, (const int32_t*)ops, group2, (int32_t)out_cap,
        (int32_t*)out_ops, (uint8_t*)out_valid, (const int32_t*)mc_of,
        (const unsigned long long*)status, tiles);
  return (int)cudaGetLastError();
}
