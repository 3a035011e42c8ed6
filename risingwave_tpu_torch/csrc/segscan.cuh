// A device-wide segmented inclusive scan of several int64 lanes at once,
// shared by kernel AD (csrc/over_step.cu) and kernel AE
// (csrc/window.cuh).
//
// Each lane has its own combine (wrapping add, min or max) and either
// restarts at every segment head or runs across heads (a lane of segment
// ids). Three launches on one stream, whatever the number of lanes: per
// tile of SEG_SCAN_TILE elements and per lane, the tile's segmented
// reduction (and, once, whether the tile holds a head); one block per
// lane scans the tile reductions into each tile's carry-in; per tile and
// lane, the block re-scans its elements from the carry and writes them.
// The carry crosses a tile only up to the tile's first head, so a pass is
// the classic segmented-scan combine (f_a, v_a) + (f_b, v_b) = (f_a | f_b,
// f_b ? v_b : v_a op v_b).
//
// The functor F gives, for element i < n:
//   bool head(int64_t i): a segment starts at i;
//   long long value(int lane, int64_t i): the lane's input.
// `out` holds n_lanes * n values (lane-major); `carry` holds
// (2 * n_lanes + 1) * seg_scan_tiles(n) words.
#pragma once

#include "common.cuh"

#define SEG_SCAN_THREADS 256
#define SEG_SCAN_ITEMS 4
#define SEG_SCAN_TILE (SEG_SCAN_THREADS * SEG_SCAN_ITEMS)  // = _kernels.SEG_SCAN_TILE
#define SEG_SCAN_TOP_THREADS 1024
#define SEG_MAX_LANES 40

enum SegOp : int { SEG_ADD = 0, SEG_MIN = 1, SEG_MAX = 2 };

struct SegPlan {
  int op[SEG_MAX_LANES];
  int reset[SEG_MAX_LANES];  // 1: restart at each head; 0: run across heads
  int n;
};

__device__ __forceinline__ long long seg_comb(int op, long long a, long long b) {
  if (op == SEG_ADD) return (long long)((unsigned long long)a + (unsigned long long)b);
  if (op == SEG_MIN) return a < b ? a : b;
  return a > b ? a : b;
}

__device__ __forceinline__ long long seg_identity(int op) {
  if (op == SEG_ADD) return 0;
  if (op == SEG_MIN) return 0x7FFFFFFFFFFFFFFFll;
  return (long long)0x8000000000000000ull;
}

// Inclusive block scan of one (flag, value) pair per thread under `op`;
// every thread gets the inclusive prefix up to itself.
template <int THREADS>
__device__ __forceinline__ void seg_block_scan(int op, bool& f, long long& v) {
  __shared__ long long wv[THREADS / 32];
  __shared__ int wf[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long ov = __shfl_up_sync(0xFFFFFFFFu, v, d);
    const int of = __shfl_up_sync(0xFFFFFFFFu, (int)f, d);
    if (lane >= d) {
      if (!f) v = seg_comb(op, ov, v);
      f = f || of;
    }
  }
  if (lane == 31) {
    wv[warp] = v;
    wf[warp] = f;
  }
  __syncthreads();
  if (warp == 0) {
    long long x = lane < THREADS / 32 ? wv[lane] : seg_identity(op);
    int xf = lane < THREADS / 32 ? wf[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long ox = __shfl_up_sync(0xFFFFFFFFu, x, d);
      const int of = __shfl_up_sync(0xFFFFFFFFu, xf, d);
      if (lane >= d) {
        if (!xf) x = seg_comb(op, ox, x);
        xf = xf || of;
      }
    }
    if (lane < THREADS / 32) {
      wv[lane] = x;
      wf[lane] = xf;
    }
  }
  __syncthreads();
  if (warp > 0) {
    if (!f) v = seg_comb(op, wv[warp - 1], v);
    f = f || wf[warp - 1];
  }
  __syncthreads();
}

// This thread's exclusive prefix within the block (valid when `has`).
template <int THREADS>
__device__ __forceinline__ void seg_block_exclusive(int op, bool f, long long v, bool* has_excl,
                                                    bool* f_excl, long long* v_excl) {
  __shared__ long long sv[THREADS];
  __shared__ int sf[THREADS];
  seg_block_scan<THREADS>(op, f, v);
  sv[threadIdx.x] = v;
  sf[threadIdx.x] = f;
  __syncthreads();
  *has_excl = threadIdx.x > 0;
  *f_excl = threadIdx.x > 0 ? sf[threadIdx.x - 1] : false;
  *v_excl = threadIdx.x > 0 ? sv[threadIdx.x - 1] : seg_identity(op);
  __syncthreads();
}

static inline int seg_scan_tiles(int64_t n) {
  return n > 0 ? (int)((n + SEG_SCAN_TILE - 1) / SEG_SCAN_TILE) : 1;
}

// The thread's aggregate over its SEG_SCAN_ITEMS elements of one lane.
template <class F>
__device__ __forceinline__ void seg_thread_agg(const F& fn, int l, int op, int reset, int64_t base,
                                               int64_t n, bool* f, long long* v) {
  bool fl = false;
  long long acc = seg_identity(op);
  bool any = false;
#pragma unroll
  for (int j = 0; j < SEG_SCAN_ITEMS; ++j) {
    const int64_t i = base + j;
    if (i >= n) break;
    const long long x = fn.value(l, i);
    const bool h = reset && fn.head(i);
    acc = (h || !any) ? x : seg_comb(op, acc, x);
    if (h) fl = true;
    any = true;
  }
  *f = fl;
  *v = acc;
}

template <class F>
__global__ void seg_reduce_kernel(F fn, SegPlan plan, int64_t n, int tiles, long long* carry) {
  const int64_t base =
      (int64_t)blockIdx.x * SEG_SCAN_TILE + (int64_t)threadIdx.x * SEG_SCAN_ITEMS;
  for (int l = 0; l < plan.n; ++l) {
    bool f;
    long long v;
    seg_thread_agg(fn, l, plan.op[l], plan.reset[l], base, n, &f, &v);  // past n: identity
    seg_block_scan<SEG_SCAN_THREADS>(plan.op[l], f, v);
    if (threadIdx.x == SEG_SCAN_THREADS - 1) {
      carry[(int64_t)l * tiles + blockIdx.x] = v;
      if (plan.reset[l]) carry[(int64_t)2 * plan.n * tiles + blockIdx.x] = f ? 1 : 0;
    }
  }
}

// One block per lane: carry-in of every tile = the inclusive reduction
// of the tiles before it (identity for tile 0).
__global__ void seg_top_kernel(SegPlan plan, int tiles, long long* carry) {
  const int l = blockIdx.x;
  const int op = plan.op[l];
  const bool reset = plan.reset[l];
  const long long* agg = carry + (int64_t)l * tiles;
  long long* cin = carry + (int64_t)(plan.n + l) * tiles;
  const long long* heads = carry + (int64_t)2 * plan.n * tiles;
  const int per = (tiles + SEG_SCAN_TOP_THREADS - 1) / SEG_SCAN_TOP_THREADS;
  const int lo = threadIdx.x * per;
  bool f = false, any = false;
  long long v = seg_identity(op);
  for (int t = lo; t < lo + per && t < tiles; ++t) {
    const bool h = reset && heads[t];
    v = (h || !any) ? agg[t] : seg_comb(op, v, agg[t]);
    f = f || h;
    any = true;
  }
  bool has, fe;
  long long ve;
  seg_block_exclusive<SEG_SCAN_TOP_THREADS>(op, f, v, &has, &fe, &ve);
  long long run = has ? ve : seg_identity(op);
  for (int t = lo; t < lo + per && t < tiles; ++t) {
    cin[t] = run;
    const bool h = reset && heads[t];
    run = h ? agg[t] : seg_comb(op, run, agg[t]);
  }
}

template <class F>
__global__ void seg_apply_kernel(F fn, SegPlan plan, int64_t n, int tiles, const long long* carry,
                                 long long* out) {
  const int64_t base =
      (int64_t)blockIdx.x * SEG_SCAN_TILE + (int64_t)threadIdx.x * SEG_SCAN_ITEMS;
  for (int l = 0; l < plan.n; ++l) {
    const int op = plan.op[l];
    const int reset = plan.reset[l];
    bool f;
    long long v;
    seg_thread_agg(fn, l, op, reset, base, n, &f, &v);
    bool has, fe;
    long long ve;
    seg_block_exclusive<SEG_SCAN_THREADS>(op, f, v, &has, &fe, &ve);
    const long long cin = carry[(int64_t)(plan.n + l) * tiles + blockIdx.x];
    // this thread's exclusive prefix: the tile's carry, then the block's
    long long run = has ? (fe ? ve : seg_comb(op, cin, ve)) : cin;
    long long* o = out + (int64_t)l * n;
#pragma unroll
    for (int j = 0; j < SEG_SCAN_ITEMS; ++j) {
      const int64_t i = base + j;
      if (i >= n) break;
      const long long x = fn.value(l, i);
      run = (reset && fn.head(i)) ? x : seg_comb(op, run, x);
      o[i] = run;
    }
  }
}

// The whole scan of every lane of `plan` over n elements.
template <class F>
static inline void rw_seg_scan(const F& fn, const SegPlan& plan, int64_t n, long long* carry,
                               long long* out, cudaStream_t st) {
  if (n <= 0 || plan.n == 0) return;
  const int tiles = seg_scan_tiles(n);
  seg_reduce_kernel<<<tiles, SEG_SCAN_THREADS, 0, st>>>(fn, plan, n, tiles, carry);
  seg_top_kernel<<<plan.n, SEG_SCAN_TOP_THREADS, 0, st>>>(plan, tiles, carry);
  seg_apply_kernel<<<tiles, SEG_SCAN_THREADS, 0, st>>>(fn, plan, n, tiles, carry, out);
}
