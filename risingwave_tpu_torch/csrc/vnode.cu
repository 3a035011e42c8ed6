// Kernel AH: the vnode of a compound key, and the hash dispatcher's
// per-downstream row masks.
//
// Replaces risingwave_tpu/ops/hashing.py:vnode_of (:129, the rest of
// K1) and risingwave_tpu/runtime/graph.py:_vnode_slice_mask (:172-177,
// K33). A row's vnode is hash_columns(key lanes, seed=0xC0FFEE) % 256;
// it decides which parallel actor owns the row's key for good, so the
// hash is hashing.cuh's (kernels A, F and L hash with it), not a second
// implementation.
//
//   rw_vnode_of:       vnode[i] = vnode(row i), int32;
//   rw_vnode_dispatch: mask[d * n + i] = valid[i] && vnode(row i) % n_down == d
//                      for every downstream d < n_down, in one launch.
//
// The reference hashes a chunk once per downstream; one launch here
// hashes every row once and writes all n_down rows of the mask, which
// is the same function.
//
// What bounds it on the card: bytes (the key lanes and valid read once,
// the vnode lane or n_down mask bytes per row written once). A 65,536-
// row chunk is launch-bound.
//
// Design: one thread per row; a lane is (pointer, dtype code, element
// stride), so a column of a wider tensor needs no copy. The mask rows
// are written in row order, so each warp's stores to row d coalesce.
#include "hashing.cuh"

#define RW_SEED_VNODE 0xC0FFEEu
#define RW_VNODE_COUNT 256u

struct VnodeLanes {
  const void* p[RW_MAX_LANES];
  int64_t stride[RW_MAX_LANES];
  int dt[RW_MAX_LANES];
  int n;
};

// Fill a VnodeLanes from n_keys int64 rows of (pointer, dtype code, stride).
static inline bool rw_vnode_lanes(const int64_t* lanes, int n_keys, VnodeLanes* k) {
  if (n_keys < 1 || n_keys > RW_MAX_LANES) return false;
  k->n = n_keys;
  for (int l = 0; l < n_keys; ++l) {
    k->p[l] = (const void*)lanes[3 * l];
    k->dt[l] = (int)lanes[3 * l + 1];
    k->stride[l] = lanes[3 * l + 2];
    if (k->dt[l] < RW_BOOL || k->dt[l] > RW_F64) return false;
  }
  return true;
}

__device__ __forceinline__ uint32_t rw_vnode_row(const VnodeLanes& k, int64_t i) {
  uint32_t h = RW_HASH_INIT ^ RW_SEED_VNODE, unused = 0u;
  for (int l = 0; l < k.n; ++l) rw_hash_lane(k.p[l], k.dt[l], i * k.stride[l], h, unused);
  return rw_mix32(h) % RW_VNODE_COUNT;
}

__global__ void vnode_of_kernel(VnodeLanes k, int64_t n, int32_t* vnode) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) vnode[i] = (int32_t)rw_vnode_row(k, i);
}

__global__ void vnode_dispatch_kernel(VnodeLanes k, int64_t n, const uint8_t* valid,
                                      int n_down, uint8_t* mask) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool v = valid[i] != 0;
  const int dest = v ? (int)(rw_vnode_row(k, i) % (uint32_t)n_down) : -1;
  for (int d = 0; d < n_down; ++d) mask[(int64_t)d * n + i] = (uint8_t)(dest == d);
}

// lanes: n_keys rows of (pointer, dtype code, element stride), as int64.
RW_EXPORT int rw_vnode_of(const int64_t* lanes, int n_keys, int64_t n, void* vnode,
                          void* stream) {
  VnodeLanes k;
  if (!rw_vnode_lanes(lanes, n_keys, &k)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int threads = 256;
    vnode_of_kernel<<<rw_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
        k, n, (int32_t*)vnode);
  }
  return (int)cudaGetLastError();
}

// mask: (n_down, n) bool, row d the rows downstream d receives.
RW_EXPORT int rw_vnode_dispatch(const int64_t* lanes, int n_keys, int64_t n,
                                const void* valid, int n_down, void* mask, void* stream) {
  VnodeLanes k;
  if (!rw_vnode_lanes(lanes, n_keys, &k) || n_down < 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int threads = 256;
    vnode_dispatch_kernel<<<rw_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
        k, n, (const uint8_t*)valid, n_down, (uint8_t*)mask);
  }
  return (int)cudaGetLastError();
}
