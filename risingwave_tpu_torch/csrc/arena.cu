// Kernel AC: the EOWC arena's append and emit.
//
// Replaces risingwave_tpu/executors/sort.py:_sort_append (:36) and
// _sort_emit (:72) (K27).
//
// rw_arena_append: the chunk's valid rows claim the free slots in order,
// the row of rank r the r-th free slot: both lists come from a stream
// compaction (csrc/compact.cuh, ranks by its scan, so ascending without a
// sort); one launch then scatters every lane of 1, 4 or 8 bytes (values and
// null lanes, one lane table as csrc/tile.cuh's), sets valid and
// seq = next_seq + r, and one thread advances next_seq and latches
// overflow (more valid rows than free slots) and saw_delete (a valid row
// that retracts). Nothing is read back.
//
// rw_arena_emit: the closed slots (valid & ts < cutoff) compacted in slot
// order, the varying bits of their seq and ts folded and read back once
// with their count (the reference reads the count once per watermark,
// sort.py:363), then kernel F's stable 8-bit radix passes
// (csrc/radix.cuh) over the varying bytes: seq first, then ts, so ties in
// ts keep seq order. One launch gathers every lane into the emission's
// first n rows and frees the slots; the emission's valid lane is set for
// its capacity. The rows past n are invalid and their content free.
//
// What bounds it on the card: bytes. The append reads the valid lane of
// the arena (2^21 slots) and the chunk once and scatters each lane's rows;
// the emit reads valid and ts once, then each radix pass reads and writes
// a 12-byte (key, slot) pair per closed row, and the gather moves each
// lane once.
#include "compact.cuh"
#include "radix.cuh"
#include "tile.cuh"

#define AC_THREADS 256
#define AC_SIGN 0x8000000000000000ull

struct FreeSlots {
  static constexpr bool kAux = false;
  const uint8_t* valid;
  __device__ int flags(int64_t cap, int64_t base, uint8_t* f, int*) const {
    int c = 0;
#pragma unroll
    for (int j = 0; j < COMPACT_ITEMS; ++j) {
      const bool sel = base + j < cap && !valid[base + j];
      f[j] = sel;
      c += sel;
    }
    return c;
  }
  __device__ void on_select(int64_t, uint8_t) const {}
  __device__ void on_total(long long*) const {}
};

struct LiveRows {
  static constexpr bool kAux = true;
  const uint8_t* valid;
  const int32_t* ops;
  __device__ int flags(int64_t n, int64_t base, uint8_t* f, int* aux) const {
    int c = 0, del = 0;
#pragma unroll
    for (int j = 0; j < COMPACT_ITEMS; ++j) {
      const int64_t i = base + j;
      const bool sel = i < n && valid[i];
      f[j] = sel;
      c += sel;
      if (sel && (ops[i] == 1 || ops[i] == 2)) ++del;  // DELETE | UPDATE_DELETE
    }
    *aux = del;
    return c;
  }
  __device__ void on_select(int64_t, uint8_t) const {}
  __device__ void on_total(long long*) const {}
};

struct ClosedSlots {
  static constexpr bool kAux = false;
  const uint8_t* valid;
  const long long* ts;
  long long cutoff;
  __device__ int flags(int64_t cap, int64_t base, uint8_t* f, int*) const {
    int c = 0;
#pragma unroll
    for (int j = 0; j < COMPACT_ITEMS; ++j) {
      const int64_t s = base + j;
      const bool sel = s < cap && valid[s] && ts[s] < cutoff;
      f[j] = sel;
      c += sel;
    }
    return c;
  }
  __device__ void on_select(int64_t, uint8_t) const {}
  __device__ void on_total(long long*) const {}
};

// status: [0] free slots, [2] valid rows, [3] retracting rows
__global__ void ac_scatter_kernel(RwTileLanes lanes, int64_t n, const int32_t* free_sel,
                                  const int32_t* rows, const long long* status, uint8_t* valid,
                                  long long* seq, long long* next_seq) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n_free = status[0], n_live = status[2];
  if (r >= n || r >= n_live || r >= n_free) return;
  const int64_t s = free_sel[r], i = rows[r];
  for (int l = 0; l < lanes.n; ++l) rw_tile_copy(lanes.dst[l], lanes.src[l], lanes.esize[l], s, i);
  valid[s] = 1;
  seq[s] = *next_seq + r;
}

__global__ void ac_latch_kernel(const long long* status, long long* next_seq, uint8_t* overflow,
                                uint8_t* saw_delete) {
  const long long n_free = status[0], n_live = status[2], n_del = status[3];
  if (n_live > n_free) *overflow = 1;
  if (n_del > 0) *saw_delete = 1;
  *next_seq += n_live;
}

RW_EXPORT int rw_arena_append(const int64_t* lane_rows, int n_lanes, int64_t cap, int64_t n,
                              const uint8_t* chunk_valid, const int32_t* ops, uint8_t* valid,
                              long long* seq, long long* next_seq, uint8_t* overflow,
                              uint8_t* saw_delete, int32_t* sel, int32_t* rows, uint8_t* payload,
                              int32_t* part, long long* status, cudaStream_t stream) {
  RwTileLanes lanes;
  if (!rw_tile_lanes(lane_rows, n_lanes, 3, &lanes)) return (int)cudaErrorInvalidValue;
  rw_compact(FreeSlots{valid}, cap, part, sel, payload, status, stream);
  rw_compact(LiveRows{chunk_valid, ops}, n, part, rows, payload, status + 2, stream);
  if (n > 0)
    ac_scatter_kernel<<<rw_blocks(n, AC_THREADS), AC_THREADS, 0, stream>>>(
        lanes, n, sel, rows, status, valid, seq, next_seq);
  ac_latch_kernel<<<1, 1, 0, stream>>>(status, next_seq, overflow, saw_delete);
  return (int)cudaGetLastError();
}

__global__ void ac_bits_init_kernel(unsigned long long* bits) {
  if (threadIdx.x < 2) {
    bits[2 * threadIdx.x] = 0ull;
    bits[2 * threadIdx.x + 1] = ~0ull;
  }
}

// bits[0..1]: OR and AND of the closed rows' seq; bits[2..3]: of their ts
// (bit 63 flipped)
__global__ void ac_bits_kernel(const int32_t* sel, const long long* status, const long long* seq,
                               const long long* ts, unsigned long long* bits) {
  const int64_t m = status[0];
  unsigned long long o0 = 0ull, a0 = ~0ull, o1 = 0ull, a1 = ~0ull;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t s = sel[i];
    const unsigned long long k0 = (unsigned long long)seq[s] ^ AC_SIGN;
    const unsigned long long k1 = (unsigned long long)ts[s] ^ AC_SIGN;
    o0 |= k0;
    a0 &= k0;
    o1 |= k1;
    a1 &= k1;
  }
  for (int d = 16; d > 0; d >>= 1) {
    o0 |= __shfl_xor_sync(0xFFFFFFFFu, o0, d);
    a0 &= __shfl_xor_sync(0xFFFFFFFFu, a0, d);
    o1 |= __shfl_xor_sync(0xFFFFFFFFu, o1, d);
    a1 &= __shfl_xor_sync(0xFFFFFFFFu, a1, d);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicOr(bits, o0);
    atomicAnd(bits + 1, a0);
    atomicOr(bits + 2, o1);
    atomicAnd(bits + 3, a1);
  }
}

__global__ void ac_init_kernel(const int32_t* sel, int64_t m, int32_t* idx) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m) idx[i] = sel[i];
}

__global__ void ac_gather_key_kernel(const long long* lane, int64_t m, const int32_t* idx,
                                     unsigned long long* keys) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m) keys[i] = (unsigned long long)lane[idx[i]] ^ AC_SIGN;
}

__global__ void ac_emit_kernel(RwTileLanes lanes, int64_t cap, int64_t m, const int32_t* idx,
                               uint8_t* valid, uint8_t* out_valid) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  out_valid[i] = i < m ? 1 : 0;
  if (i >= m) return;
  const int64_t s = idx[i];
  for (int l = 0; l < lanes.n; ++l) rw_tile_copy(lanes.dst[l], lanes.src[l], lanes.esize[l], i, s);
  valid[s] = 0;
}

RW_EXPORT int rw_arena_emit(const int64_t* lane_rows, int n_lanes, int64_t cap, int64_t cutoff,
                            const long long* ts, uint8_t* valid, const long long* seq,
                            uint8_t* out_valid, int32_t* sel, uint8_t* payload, int32_t* part,
                            long long* status, unsigned long long* keys, int32_t* idx,
                            int32_t* hist, unsigned long long* bits, int64_t* n_out,
                            cudaStream_t stream) {
  RwTileLanes lanes;
  if (!rw_tile_lanes(lane_rows, n_lanes, 3, &lanes)) return (int)cudaErrorInvalidValue;
  rw_compact(ClosedSlots{valid, ts, cutoff}, cap, part, sel, payload, status, stream);
  ac_bits_init_kernel<<<1, 32, 0, stream>>>(bits);
  const int blocks = rw_blocks(cap, AC_THREADS);
  ac_bits_kernel<<<blocks < 1024 ? blocks : 1024, AC_THREADS, 0, stream>>>(sel, status, seq, ts,
                                                                          bits);
  unsigned long long h[4];
  long long m = 0;
  if (cudaMemcpyAsync(&m, status, sizeof(long long), cudaMemcpyDeviceToHost, stream) !=
          cudaSuccess ||
      cudaMemcpyAsync(h, bits, sizeof(h), cudaMemcpyDeviceToHost, stream) != cudaSuccess ||
      cudaStreamSynchronize(stream) != cudaSuccess) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? (int)err : (int)cudaErrorUnknown;
  }
  *n_out = m;
  if (m == 0) return (int)cudaGetLastError();  // nothing closes: no emission, nothing freed
  const int mb = rw_blocks(m, AC_THREADS);
  ac_init_kernel<<<mb, AC_THREADS, 0, stream>>>(sel, m, idx);
  int cur = 0;
  const long long* lanes_by_pass[2] = {seq, ts};
  for (int k = 0; k < 2; ++k) {  // seq, then ts: the last pass orders most
    const unsigned long long varying = h[2 * k] ^ h[2 * k + 1];
    if (varying == 0ull) continue;
    ac_gather_key_kernel<<<mb, AC_THREADS, 0, stream>>>(lanes_by_pass[k], m, idx + cur * m,
                                                        keys + cur * m);
    for (int b = 0; b < 8; ++b) {
      if (((varying >> (8 * b)) & 0xFFull) == 0ull) continue;
      rbk_radix_pass(keys + cur * m, idx + cur * m, keys + (1 - cur) * m, idx + (1 - cur) * m, m,
                     8 * b, hist, stream);
      cur = 1 - cur;
    }
  }
  ac_emit_kernel<<<rw_blocks(cap, AC_THREADS), AC_THREADS, 0, stream>>>(lanes, cap, m,
                                                                        idx + cur * m, valid,
                                                                        out_valid);
  return (int)cudaGetLastError();
}
