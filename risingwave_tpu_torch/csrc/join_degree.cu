// Kernel P: the degree update of the other join side by one probe chunk,
// and group 3 of the chunk's emission, the zero-crossing transitions.
//
// Replaces risingwave_tpu/ops/join.py:degree_apply (:339) and
// gather_flat (:394) as risingwave_tpu/executors/hash_join.py:
// join_step_fn (:91) uses them for the outer, semi and anti joins
// (:197-223). Reference: the degree tables of src/stream/src/executor/
// join/hash_join.rs:157.
//
// What it computes, as the reference: the chunk's matches are kernel
// M's (a probe row with slot_of[i] = s >= 0 matches every live entry
// s * fanout + j of the other side's bucket). For each DISTINCT matched
// stored row pid = s * fanout + j: net = the sum of its probe rows'
// signs, old = its degree before the chunk, degree[pid] = old + net,
// went_pos = old == 0 && new > 0, went_zero = old > 0 && new <= 0. So
// U-/U+ rows on one stored row net to zero and emit nothing. With
// mode != NONE each transition writes one output row after the rows
// kernel M wrote (from *written, on the device): the stored row's
// lanes and null lanes, the lanes flagged `one` written 1 (the arrival
// side's NULL pad of an outer join); op DELETE on went_pos and INSERT on
// went_zero (outer, anti), the reverse for semi. The total past out_cap
// latches em_overflow; join_rows gets the rows written added, and
// *written the transitions. Beyond the reference: each stored row whose
// degree moved (net != 0) marks its key slot in ddirty, so the next
// checkpoint stages the new degrees (the reference stages only sdirty
// keys and misses them).
//
// Order: the reference sorts the pids, so its group 3 runs in pid order.
// Here group 3 runs in the order of each pid's first matching entry in
// the chunk (probe row major, bucket position minor), deterministic but
// not the reference's. The MV cannot tell: two transitions of one
// chunk write the same output row only when their stored rows are
// equal, and then the two rows are equal. chip_smoke.py compares group
// 3 with the plain version as a multiset, and groups 1-2 exactly.
//
// What bounds it on the card: per probe row its slot, op and bucket's
// row_valid bytes; per matched entry a few random words of the chunk's
// pid set and, per distinct pid, its degree read and written; per
// transition the stored row's lanes read at random and the output lanes
// written. A 65,536-row flush chunk against a fanout-4 side is a few MB.
//
// Design (no scratch the size of the side; decide, then fold, as N):
//   1. init: empty the pid set, an open-addressing table of H >= 2 *
//      n * fanout entries (key pid or -1, the least entry index,
//      the net sign sum, the old degree);
//   2. elect: one thread per (row, position) entry; a matched entry
//      claims or finds its pid's set entry by CAS, the claimer reads the
//      old degree, every entry atomicMins its index and atomicAdds its
//      sign; nothing writes a degree in this launch;
//   3. count: the representative entry (the least index) of each pid
//      writes the new degree and flags its transition; each 256-entry
//      tile counts its flagged entries;
//   4. scan: one block turns the tile counts into offsets after
//      *written, and writes the latch, the counter and *written;
//   5. write: each flagged entry writes its row at its offset.
#include <climits>

#include "hashing.cuh"

#define JD_THREADS 256
#define JD_SCAN_THREADS 1024
#define JD_MAX_OUT 16

// group-3 modes (ops/join.py G3_*)
#define JD_NONE 0
#define JD_OUTER 1
#define JD_ANTI 2
#define JD_SEMI 3

struct DegLanes {
  const void* src[JD_MAX_OUT];  // (cap * fanout,) stored lane of the other side, or null
  void* dst[JD_MAX_OUT];        // (out_cap,) output lane
  int esize[JD_MAX_OUT];        // 1, 4 or 8 bytes
  int one[JD_MAX_OUT];          // 1: write 1 (a NULL pad), no source
  int n;
};

__global__ void jd_init_kernel(int64_t h_size, int32_t* keys, int32_t* rep, int32_t* net) {
  for (int64_t h = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; h < h_size;
       h += (int64_t)gridDim.x * blockDim.x) {
    keys[h] = -1;
    rep[h] = INT_MAX;
    net[h] = 0;
  }
}

__global__ void jd_elect_kernel(int64_t n, int fanout, const int32_t* slots, const int32_t* ops,
                                const uint8_t* row_valid, const int32_t* degree, int32_t* keys,
                                int32_t* rep, int32_t* net, int32_t* old, int64_t h_mask,
                                int32_t* hidx) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n * fanout) return;
  const int64_t i = e / fanout;
  const int j = (int)(e - i * fanout);
  hidx[e] = -1;
  const int64_t s = slots[i];
  if (s < 0) return;
  const int64_t pid64 = s * fanout + j;
  if (!row_valid[pid64]) return;
  const int32_t pid = (int32_t)pid64;
  int64_t h = rw_mix32((uint32_t)pid) & h_mask;
  for (;;) {  // at most n * fanout pids claim, so an empty entry is always ahead
    const int32_t k = atomicCAS(keys + h, -1, pid);
    if (k == -1) {
      old[h] = degree[pid];  // no launch before count writes a degree
      break;
    }
    if (k == pid) break;
    h = (h + 1) & h_mask;
  }
  hidx[e] = (int32_t)h;
  atomicMin(rep + h, (int32_t)e);
  const int32_t op = ops[i];
  atomicAdd(net + h, (op == 1 || op == 2) ? -1 : 1);
}

// 0: no transition; 1: went_pos; 2: went_zero. Writes the new degree,
// and marks the stored row's key slot in ddirty (if given) when it moved.
__device__ __forceinline__ int jd_decide(int64_t e, const int32_t* hidx, const int32_t* keys,
                                         const int32_t* rep, const int32_t* net,
                                         const int32_t* old, int32_t* degree, uint8_t* ddirty,
                                         int fanout) {
  const int32_t h = hidx[e];
  if (h < 0 || rep[h] != (int32_t)e) return 0;
  const int32_t o = old[h];
  const int32_t nw = o + net[h];
  degree[keys[h]] = nw;
  if (ddirty != nullptr && net[h] != 0) ddirty[keys[h] / fanout] = 1;
  if (o == 0 && nw > 0) return 1;
  if (o > 0 && nw <= 0) return 2;
  return 0;
}

__global__ void jd_count_kernel(int64_t m, const int32_t* hidx, const int32_t* keys,
                                const int32_t* rep, const int32_t* net, const int32_t* old,
                                int32_t* degree, uint8_t* ddirty, int fanout, int emit,
                                int32_t* flag, int32_t* tile_counts) {
  const int64_t e = (int64_t)blockIdx.x * JD_THREADS + threadIdx.x;
  int t = 0;
  if (e < m) {
    const int f = jd_decide(e, hidx, keys, rep, net, old, degree, ddirty, fanout);
    flag[e] = f;
    t = emit && f ? 1 : 0;
  }
  if (!emit) return;
  int excl;
  const int total = rw_block_exclusive_scan<JD_THREADS>(t, &excl);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

__global__ void jd_scan_kernel(int32_t* tile_counts, int n_tiles, int32_t out_cap,
                               int32_t* written, uint8_t* em_overflow, long long* join_rows) {
  const int per = (n_tiles + JD_SCAN_THREADS - 1) / JD_SCAN_THREADS;
  const int lo = threadIdx.x * per;
  const int base = *written;  // rows kernel M wrote (groups 1 and 2)
  long long local = 0;
  for (int j = lo; j < lo + per && j < n_tiles; ++j) local += tile_counts[j];
  int excl;
  const int total = rw_block_exclusive_scan<JD_SCAN_THREADS>((int)local, &excl);
  int run = base + excl;
  for (int j = lo; j < lo + per && j < n_tiles; ++j) {
    const int c = tile_counts[j];
    tile_counts[j] = run;
    run += c;
  }
  __syncthreads();  // every thread has read *written
  if (threadIdx.x == 0) {
    const int end = base + total;
    *written = end;
    if (end > out_cap) *em_overflow = 1;
    if (join_rows != nullptr) {
      const int lo_cap = base < out_cap ? base : out_cap;
      const int hi_cap = end < out_cap ? end : out_cap;
      *join_rows += (long long)(hi_cap - lo_cap);
    }
  }
}

__device__ __forceinline__ void jd_copy(void* dst, int64_t d, const void* src, int64_t s,
                                        int esize) {
  switch (esize) {
    case 1: ((uint8_t*)dst)[d] = ((const uint8_t*)src)[s]; break;
    case 4: ((uint32_t*)dst)[d] = ((const uint32_t*)src)[s]; break;
    case 8: ((unsigned long long*)dst)[d] = ((const unsigned long long*)src)[s]; break;
  }
}

__global__ void jd_write_kernel(DegLanes out, int64_t m, int mode, const int32_t* hidx,
                                const int32_t* keys, const int32_t* flag,
                                const int32_t* tile_offsets, int32_t out_cap, int32_t* out_ops,
                                uint8_t* out_valid) {
  const int64_t e = (int64_t)blockIdx.x * JD_THREADS + threadIdx.x;
  const int f = e < m ? flag[e] : 0;
  int excl;
  rw_block_exclusive_scan<JD_THREADS>(f ? 1 : 0, &excl);
  if (!f) return;
  const int64_t p = (int64_t)tile_offsets[blockIdx.x] + excl;
  if (p >= out_cap) return;
  const int64_t pid = keys[hidx[e]];
  for (int k = 0; k < out.n; ++k) {
    if (out.one[k])
      ((uint8_t*)out.dst[k])[p] = 1;
    else if (out.src[k] != nullptr)
      jd_copy(out.dst[k], p, out.src[k], pid, out.esize[k]);
  }
  const bool went_pos = f == 1;
  // outer, anti: matched for the first time -> DELETE the pad / bare row;
  // semi: matched -> INSERT the row
  out_ops[p] = (mode == JD_SEMI) == went_pos ? 0 : 1;
  out_valid[p] = 1;
}

// n probe rows with slot_of (kernel M's: -1 without a live match) and
// ops; row_valid and degree the other side's (cap * fanout,) lanes;
// outs: n_out rows of (src or 0, dst, esize, one), int64; mode a JD_*
// mode; out_ops/out_valid and every dst the chunk kernel M wrote;
// written its () int32 row count; join_rows an int64 counter or null;
// scratch: 4 * h_size + 2 * n * fanout + ceil(n * fanout / 256) int32,
// h_size a power of two >= 2 * n * fanout; ddirty: the other side's
// (cap,) bool lane marking key slots whose degrees moved, or null.
RW_EXPORT int rw_join_degree(int64_t n, const void* slot_of, const void* ops,
                             const void* row_valid, int fanout, int64_t cap, void* degree,
                             const int64_t* outs, int n_out, int mode, int out_cap,
                             void* out_ops, void* out_valid, void* written, void* em_overflow,
                             void* join_rows, void* scratch, int64_t h_size, void* ddirty,
                             void* stream) {
  const int64_t m = n * (int64_t)fanout;
  if (n_out < 0 || n_out > JD_MAX_OUT || fanout < 1 || mode < JD_NONE || mode > JD_SEMI ||
      cap * (int64_t)fanout >= ((int64_t)1 << 31) || m >= ((int64_t)1 << 29) ||
      h_size < 2 * m || (h_size & (h_size - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  DegLanes o;
  o.n = n_out;
  for (int l = 0; l < n_out; ++l) {
    const int64_t* r = outs + 4 * l;
    o.src[l] = (const void*)r[0];
    o.dst[l] = (void*)r[1];
    o.esize[l] = (int)r[2];
    o.one[l] = (int)r[3];
    if (o.esize[l] != 1 && o.esize[l] != 4 && o.esize[l] != 8) return (int)cudaErrorInvalidValue;
    if (o.one[l] && o.esize[l] != 1) return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* keys = (int32_t*)scratch;
  int32_t* rep = keys + h_size;
  int32_t* net = rep + h_size;
  int32_t* old = net + h_size;
  int32_t* hidx = old + h_size;
  int32_t* flag = hidx + m;
  int32_t* tile_counts = flag + m;
  const int tiles = (int)((m + JD_THREADS - 1) / JD_THREADS);
  int64_t init_blocks = (h_size + JD_THREADS - 1) / JD_THREADS;
  if (init_blocks > 1024) init_blocks = 1024;  // grid-stride
  jd_init_kernel<<<(int)init_blocks, JD_THREADS, 0, st>>>(h_size, keys, rep, net);
  jd_elect_kernel<<<tiles, JD_THREADS, 0, st>>>(
      n, fanout, (const int32_t*)slot_of, (const int32_t*)ops, (const uint8_t*)row_valid,
      (const int32_t*)degree, keys, rep, net, old, h_size - 1, hidx);
  const int emit = mode != JD_NONE;
  jd_count_kernel<<<tiles, JD_THREADS, 0, st>>>(m, hidx, keys, rep, net, old, (int32_t*)degree,
                                                (uint8_t*)ddirty, fanout, emit, flag,
                                                tile_counts);
  if (emit) {
    jd_scan_kernel<<<1, JD_SCAN_THREADS, 0, st>>>(tile_counts, tiles, (int32_t)out_cap,
                                                  (int32_t*)written, (uint8_t*)em_overflow,
                                                  (long long*)join_rows);
    jd_write_kernel<<<tiles, JD_THREADS, 0, st>>>(o, m, mode, hidx, keys, flag, tile_counts,
                                                  (int32_t)out_cap, (int32_t*)out_ops,
                                                  (uint8_t*)out_valid);
  }
  return (int)cudaGetLastError();
}
