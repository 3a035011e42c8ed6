// Kernel Z: the general dynamic filter's row store and its right-value diff.
//
// Replaces the two device steps of risingwave_tpu/executors/dynamic_filter.py
// that follow kernel A's lookup_or_insert on the pk lanes:
// - _dyn_left_step (:417): every active row of a left chunk is stored at
//   its pk's slot (each row lane, whatever its width), the slot turns live
//   or dead by the row's sign, sdirty, and passing = the row passes and is
//   an insert; the chunk passes through masked by valid & rv_valid &
//   cmp(value, rv). The reference writes every lane with `.at[idx].set`,
//   so where rows of one chunk share a slot (an update's U-/U+ pair, an
//   insert then a delete of one pk) the last row wins for all of them.
// - _dyn_rv_diff (:442): after the right value moved, mask_new = live &
//   rv_valid & cmp(value, rv) over the capacity and changed = mask_new !=
//   passing; here also passing = mask_new and sdirty |= changed (the
//   executor's barrier, :633-639), and the changed slots compacted in
//   ascending slot order with their new status, so the barrier pulls only
//   the rows that flipped after one read of the count.
// rv and rv_valid are device scalars: neither entry reads the host.
//
// What bounds it on the card: the left step reads the chunk's lanes and
// writes the winning rows' lanes at random slots of tables of up to 2^22+
// slots (one random 4-byte atomic per row on the election lane); the diff
// reads the live, passing and value lanes of every slot twice (count,
// then write) and writes 5 bytes per changed slot. Both are bound by
// bytes.
//
// Design: the left step is kernel D's rule (csrc/mv_upsert.cu): launch 1
// takes atomicMax of the row index into a per-slot int32 scratch lane
// (kept all -1 between calls) and writes the pass-through mask; launch 2
// lets the row whose index won write every lane of its slot and reset the
// scratch entry, so live, passing, sdirty and the row lanes all come from
// the same (last) row. The diff is csrc/compact.cuh's stream compaction,
// which kernel R's stage select also runs, with the changed slots selected
// and their new status as the payload; no atomics decide a position.
#include "compact.cuh"

enum DgCmp : int { CMP_GT = 0, CMP_GE = 1, CMP_LT = 2, CMP_LE = 3 };

template <typename T>
__device__ __forceinline__ bool dg_cmp(T v, T rv, int op) {
  switch (op) {
    case CMP_GT: return v > rv;
    case CMP_GE: return v >= rv;
    case CMP_LT: return v < rv;
    default: return v <= rv;
  }
}

// cmp(lane[i], *rv) in the lane's dtype (rv holds the same dtype).
__device__ __forceinline__ bool dg_cmp_at(const void* lane, int dt, int64_t i, const void* rv,
                                          int op) {
  switch (dt) {
    case RW_BOOL: return dg_cmp<int>(((const uint8_t*)lane)[i] != 0, *(const uint8_t*)rv != 0, op);
    case RW_I32: return dg_cmp(((const int32_t*)lane)[i], *(const int32_t*)rv, op);
    case RW_I64: return dg_cmp(((const long long*)lane)[i], *(const long long*)rv, op);
    case RW_F32: return dg_cmp(((const float*)lane)[i], *(const float*)rv, op);
    case RW_F64: return dg_cmp(((const double*)lane)[i], *(const double*)rv, op);
  }
  return false;
}

struct DgLanes {
  const void* src[RW_MAX_LANES];  // (n,) chunk lanes
  void* dst[RW_MAX_LANES];        // (cap,) row-store lanes, same dtypes
  int esize[RW_MAX_LANES];
  int n;
};

__global__ void dg_elect_kernel(int64_t n, const uint8_t* valid, const int32_t* slots,
                                const void* value, int vdt, const void* rv,
                                const uint8_t* rv_valid, int op, int32_t* scratch,
                                uint8_t* ok, uint8_t* dropped) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool v = valid[i] != 0;
  ok[i] = v && *rv_valid && dg_cmp_at(value, vdt, i, rv, op) ? 1 : 0;
  if (!v) return;
  const int32_t s = slots[i];
  if (s < 0) {
    *dropped = 1;
    return;
  }
  atomicMax(scratch + s, (int)i);
}

__global__ void dg_store_kernel(DgLanes lanes, int64_t n, const uint8_t* valid,
                                const int32_t* ops, const int32_t* slots, const uint8_t* ok,
                                int32_t* scratch, uint8_t* live, uint8_t* sdirty,
                                uint8_t* passing) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const int32_t s = slots[i];
  if (s < 0 || scratch[s] != (int32_t)i) return;
  scratch[s] = -1;
  const int32_t o = ops[i];
  const bool ins = !(o == 1 || o == 2);  // not DELETE | UPDATE_DELETE
  live[s] = ins ? 1 : 0;
  sdirty[s] = 1;
  passing[s] = ins && ok[i] ? 1 : 0;
  for (int k = 0; k < lanes.n; ++k) {
    switch (lanes.esize[k]) {
      case 1: ((uint8_t*)lanes.dst[k])[s] = ((const uint8_t*)lanes.src[k])[i]; break;
      case 4: ((uint32_t*)lanes.dst[k])[s] = ((const uint32_t*)lanes.src[k])[i]; break;
      case 8:
        ((unsigned long long*)lanes.dst[k])[s] = ((const unsigned long long*)lanes.src[k])[i];
        break;
    }
  }
}

// The diff as compact.cuh's flag functor: bit 0 = changed, bit 1 = the
// new status (the payload); a changed slot's passing takes its new
// status and its sdirty is set; status[1] = the left step's latch.
struct DiffFlags {
  static constexpr bool kAux = false;
  const uint8_t* live;
  const void* value;
  int vdt;
  const void* rv;
  const uint8_t* rv_valid;
  int op;
  uint8_t* passing;
  uint8_t* sdirty;
  const uint8_t* dropped;

  __device__ int flags(int64_t cap, int64_t base, uint8_t* f, int*) const {
    const bool rvv = *rv_valid != 0;
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < COMPACT_ITEMS; ++j) {
      const int64_t s = base + j;
      bool nw = false, ch = false;
      if (s < cap) {
        nw = live[s] && rvv && dg_cmp_at(value, vdt, s, rv, op);
        ch = nw != (passing[s] != 0);
      }
      f[j] = (uint8_t)((ch ? 1 : 0) | (nw ? 2 : 0));
      cnt += ch ? 1 : 0;
    }
    return cnt;
  }
  __device__ void on_select(int64_t s, uint8_t f) const {
    passing[s] = (f >> 1) & 1;
    sdirty[s] = 1;
  }
  __device__ void on_total(long long* status) const { status[1] = *dropped ? 1 : 0; }
};

// rows: n_rows rows of (src, dst, esize), int64. valid, ops, slots (from
// kernel A), value: the chunk's (n,) lanes; rv, rv_valid: device scalars
// (rv in the value's dtype vdt). scratch: (cap,) int32, all -1 between
// calls; live, sdirty, passing: (cap,) bool. ok: (n,) bool out, the
// pass-through mask. dropped: a bool latch.
RW_EXPORT int rw_dyn_left_step(const int64_t* rows, int n_rows, int64_t n, const void* valid,
                               const void* ops, const void* slots, const void* value, int vdt,
                               const void* rv, const void* rv_valid, int op, void* scratch,
                               void* live, void* sdirty, void* passing, void* ok,
                               void* dropped, void* stream) {
  if (n_rows < 0 || n_rows > RW_MAX_LANES || op < CMP_GT || op > CMP_LE)
    return (int)cudaErrorInvalidValue;
  DgLanes lanes;
  lanes.n = n_rows;
  for (int k = 0; k < n_rows; ++k) {
    lanes.src[k] = (const void*)rows[3 * k];
    lanes.dst[k] = (void*)rows[3 * k + 1];
    lanes.esize[k] = (int)rows[3 * k + 2];
  }
  if (n > 0) {
    const int threads = 256;
    cudaStream_t st = (cudaStream_t)stream;
    dg_elect_kernel<<<rw_blocks(n, threads), threads, 0, st>>>(
        n, (const uint8_t*)valid, (const int32_t*)slots, value, vdt, rv,
        (const uint8_t*)rv_valid, op, (int32_t*)scratch, (uint8_t*)ok, (uint8_t*)dropped);
    dg_store_kernel<<<rw_blocks(n, threads), threads, 0, st>>>(
        lanes, n, (const uint8_t*)valid, (const int32_t*)ops, (const int32_t*)slots,
        (const uint8_t*)ok, (int32_t*)scratch, (uint8_t*)live, (uint8_t*)sdirty,
        (uint8_t*)passing);
  }
  return (int)cudaGetLastError();
}

// live, passing, sdirty: (cap,) bool; value: the (cap,) value lane of the
// row store (dtype vdt); rv, rv_valid: device scalars; dropped: the left
// step's latch, copied into status[1]. tile_counts: ceil(cap / 4096) + 1
// int32 scratch. sel: (cap,) int32 and now: (cap,) bool, the first
// status[0] entries written. status: (2,) int64.
RW_EXPORT int rw_dyn_rv_diff(int64_t cap, const void* live, const void* value, int vdt,
                             const void* rv, const void* rv_valid, int op, void* passing,
                             void* sdirty, const void* dropped, void* tile_counts, void* sel,
                             void* now, void* status, void* stream) {
  if (cap < 1 || op < CMP_GT || op > CMP_LE) return (int)cudaErrorInvalidValue;
  const DiffFlags fn{(const uint8_t*)live, value, vdt, rv, (const uint8_t*)rv_valid, op,
                     (uint8_t*)passing, (uint8_t*)sdirty, (const uint8_t*)dropped};
  rw_compact(fn, cap, (int32_t*)tile_counts, (int32_t*)sel, (uint8_t*)now, (long long*)status,
             (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
