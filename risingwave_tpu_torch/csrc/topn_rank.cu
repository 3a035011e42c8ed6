// Kernels W and X: rank a TopN row store by a stable multi-lane key.
//
// W replaces risingwave_tpu/executors/top_n_plain.py:_rank_top (:86):
// the slots of the first n rows of the store by (live first, order key,
// pk lanes, slot), and their liveness. X replaces _group_topk_mask
// (:390): per slot, in_topk (live and among its group's first k by
// (live first, order key, pk lanes, slot)) and gdirty (its group, by
// the group lanes' values, holds an epoch-dirty slot). Liveness is its
// own key, so a dead row never displaces a live one, whatever its order
// value. Order keys are the reference's unsigned keys (_order_key_u64:
// a float's total-order key, a signed lane with its top bit flipped, all
// bits inverted for DESC), computed here from the order lane; pk and
// group lanes order as signed integers (bool: false first).
//
// What bounds it on the card: bytes. Every pass of the sort reads and
// writes a 12-byte (key, slot) pair per slot of the store (up to 2^26
// slots), and each key lane is read once more to find its varying bits
// and gathered once at random through the permutation; X then reads the
// sorted slots' group lanes, live and epoch_dirty once more and writes
// two bool lanes at random.
//
// Design: an LSD radix sort, least significant key first, of (64-bit
// encoded key, slot) pairs that starts from the slots in order, so ties
// keep slot order with no pass over the slot. One launch first folds
// every lane's encoded keys into their OR and AND, which the host reads
// (the entry's one device-to-host copy): a byte where the two agree is
// the same for every key and gets no pass (the high bytes of small ids,
// a store all live), a lane with no varying bit no gather. Each key lane
// that varies: one gather of its encoded key in the current order, then
// kernel F's stable 8-bit pass (csrc/radix.cuh) per varying byte. Then W
// copies out the first n slots and their liveness; X marks group
// boundaries (any group lane changes from the previous slot in order),
// scans them into segment ids (csrc/scan.cuh), records each segment's
// start and whether it holds an epoch-dirty slot, and writes both masks
// back by slot, its segment lanes in the sort's key buffers.
#include "radix.cuh"
#include "scan.cuh"

#define TR_MAX_KEYS 12
#define TR_THREADS 256
#define TR_BITS_BLOCKS 1024
#define TR_SIGN 0x8000000000000000ull

// a key lane's role (top_n_plain.py _KEY_*)
enum TrMode : int { TR_PLAIN = 0, TR_ASC = 1, TR_DESC = 2, TR_LIVE_LAST = 3 };

struct TrKeys {
  const void* lane[TR_MAX_KEYS];  // (cap,) lanes, most significant first
  int dt[TR_MAX_KEYS];
  int mode[TR_MAX_KEYS];
  int n;
};

__device__ __forceinline__ unsigned long long tr_encode(const void* lane, int dt, int mode,
                                                        int64_t i) {
  if (mode == TR_LIVE_LAST) return ((const uint8_t*)lane)[i] ? 0ull : 1ull;
  if (mode == TR_PLAIN) {
    switch (dt) {
      case RW_BOOL: return ((const uint8_t*)lane)[i] ? 1ull : 0ull;
      case RW_I32: return (unsigned long long)((uint32_t)((const int32_t*)lane)[i] ^ 0x80000000u);
      default: return (unsigned long long)((const long long*)lane)[i] ^ TR_SIGN;
    }
  }
  unsigned long long k;
  switch (dt) {
    case RW_BOOL: k = (((const uint8_t*)lane)[i] ? 1ull : 0ull) ^ TR_SIGN; break;
    case RW_I32: k = (unsigned long long)(long long)((const int32_t*)lane)[i] ^ TR_SIGN; break;
    case RW_I64: k = (unsigned long long)((const long long*)lane)[i] ^ TR_SIGN; break;
    case RW_F32: k = (unsigned long long)rw_order_key_f32(((const float*)lane)[i]); break;
    default: k = (unsigned long long)rw_order_key_f64(((const double*)lane)[i]) ^ TR_SIGN; break;
  }
  return mode == TR_DESC ? ~k : k;
}

__global__ void tr_bits_init_kernel(int n_keys, unsigned long long* bits) {
  const int l = threadIdx.x;
  if (l < n_keys) {
    bits[2 * l] = 0ull;
    bits[2 * l + 1] = ~0ull;
  }
}

// bits[2l] |= every encoded key of lane l, bits[2l + 1] &= each
__global__ void tr_bits_kernel(TrKeys kd, int64_t n, unsigned long long* bits) {
  for (int l = 0; l < kd.n; ++l) {
    unsigned long long o = 0ull, a = ~0ull;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
      const unsigned long long e = tr_encode(kd.lane[l], kd.dt[l], kd.mode[l], i);
      o |= e;
      a &= e;
    }
    for (int d = 16; d > 0; d >>= 1) {
      o |= __shfl_xor_sync(0xFFFFFFFFu, o, d);
      a &= __shfl_xor_sync(0xFFFFFFFFu, a, d);
    }
    if ((threadIdx.x & 31) == 0) {
      atomicOr(bits + 2 * l, o);
      atomicAnd(bits + 2 * l + 1, a);
    }
  }
}

__global__ void tr_init_kernel(int64_t n, int32_t* idx) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) idx[i] = (int32_t)i;
}

__global__ void tr_gather_kernel(const void* lane, int dt, int mode, int64_t n,
                                 unsigned long long* keys, const int32_t* idx) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = tr_encode(lane, dt, mode, idx[i]);
}

// The whole sort: the slots in key order land in idx + return * n (the
// buffer the last pass wrote), or -1 on a CUDA error.
static int tr_sort(const TrKeys& kd, int64_t n, unsigned long long* keys, int32_t* idx,
                   int32_t* hist, unsigned long long* bits, cudaStream_t st) {
  const int blocks = rw_blocks(n, TR_THREADS);
  tr_bits_init_kernel<<<1, 32, 0, st>>>(kd.n, bits);
  tr_bits_kernel<<<blocks < TR_BITS_BLOCKS ? blocks : TR_BITS_BLOCKS, TR_THREADS, 0, st>>>(
      kd, n, bits);
  unsigned long long h[2 * TR_MAX_KEYS];
  if (cudaMemcpyAsync(h, bits, sizeof(unsigned long long) * 2 * kd.n, cudaMemcpyDeviceToHost,
                      st) != cudaSuccess ||
      cudaStreamSynchronize(st) != cudaSuccess)
    return -1;
  tr_init_kernel<<<blocks, TR_THREADS, 0, st>>>(n, idx);
  int cur = 0;
  for (int l = kd.n - 1; l >= 0; --l) {
    const unsigned long long varying = h[2 * l] ^ h[2 * l + 1];
    if (varying == 0ull) continue;  // one value in every slot orders nothing
    tr_gather_kernel<<<blocks, TR_THREADS, 0, st>>>(kd.lane[l], kd.dt[l], kd.mode[l], n,
                                                    keys + cur * n, idx + cur * n);
    for (int b = 0; b < 8; ++b) {
      if (((varying >> (8 * b)) & 0xFFull) == 0ull) continue;
      rbk_radix_pass(keys + cur * n, idx + cur * n, keys + (1 - cur) * n, idx + (1 - cur) * n,
                     n, 8 * b, hist, st);
      cur = 1 - cur;
    }
  }
  return cur;
}

static bool tr_parse(const int64_t* rows, int n_keys, TrKeys* kd) {
  if (n_keys < 1 || n_keys > TR_MAX_KEYS) return false;
  kd->n = n_keys;
  for (int l = 0; l < n_keys; ++l) {
    kd->lane[l] = (const void*)rows[3 * l];
    kd->dt[l] = (int)rows[3 * l + 1];
    kd->mode[l] = (int)rows[3 * l + 2];
    if (kd->mode[l] < TR_PLAIN || kd->mode[l] > TR_LIVE_LAST) return false;
    if (kd->mode[l] == TR_PLAIN && (kd->dt[l] == RW_F32 || kd->dt[l] == RW_F64)) return false;
    if (kd->mode[l] == TR_LIVE_LAST && kd->dt[l] != RW_BOOL) return false;
  }
  return true;
}

__global__ void tr_top_kernel(int64_t n_top, const int32_t* order, const uint8_t* live,
                              int32_t* out_idx, uint8_t* out_alive) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_top) return;
  const int32_t s = order[i];
  out_idx[i] = s;
  out_alive[i] = live[s];
}

// keys: n_keys rows of (lane, dtype code, mode), most significant first:
// live (LIVE_LAST), the order lane (ASC/DESC), the pk lanes (PLAIN).
// keys_buf: 2 * cap int64; idx_buf: 2 * cap int32; hist: 256 * tiles +
// 256 int32 (radix.cuh); bits: 2 * n_keys int64.
RW_EXPORT int rw_rank_top(const int64_t* keys, int n_keys, int64_t cap, const void* live,
                          void* keys_buf, void* idx_buf, void* hist, void* bits, int64_t n_top,
                          void* out_idx, void* out_alive, void* stream) {
  TrKeys kd;
  if (!tr_parse(keys, n_keys, &kd) || cap < 1 || n_top < 0 || n_top > cap)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int cur = tr_sort(kd, cap, (unsigned long long*)keys_buf, (int32_t*)idx_buf,
                          (int32_t*)hist, (unsigned long long*)bits, st);
  if (cur < 0) return (int)cudaGetLastError();
  if (n_top > 0)
    tr_top_kernel<<<rw_blocks(n_top, TR_THREADS), TR_THREADS, 0, st>>>(
        n_top, (const int32_t*)idx_buf + cur * cap, (const uint8_t*)live, (int32_t*)out_idx,
        (uint8_t*)out_alive);
  return (int)cudaGetLastError();
}

// X, after the sort: flag[i] = a group starts at sorted position i
__global__ void tr_bound_kernel(TrKeys kd, int n_group, int64_t cap, const int32_t* order,
                                int32_t* flag, uint8_t* seg_dirty) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  seg_dirty[i] = 0;
  int f = i == 0 ? 1 : 0;
  if (!f) {
    const int32_t a = order[i], b = order[i - 1];
    for (int g = 0; g < n_group && !f; ++g)
      f = tr_encode(kd.lane[g], kd.dt[g], TR_PLAIN, a) != tr_encode(kd.lane[g], kd.dt[g], TR_PLAIN, b);
  }
  flag[i] = f;
}

// segment id = (groups started before i) + flag[i] - 1
__global__ void tr_seg_kernel(int64_t cap, const int32_t* order, const int32_t* flag,
                              const int32_t* excl, const uint8_t* epoch_dirty,
                              int32_t* seg_start, uint8_t* seg_dirty) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  const int32_t sid = excl[i] + flag[i] - 1;
  if (flag[i]) seg_start[sid] = (int32_t)i;
  if (epoch_dirty[order[i]]) seg_dirty[sid] = 1;
}

__global__ void tr_mask_kernel(int64_t cap, int k, const int32_t* order, const int32_t* flag,
                               const int32_t* excl, const int32_t* seg_start,
                               const uint8_t* seg_dirty, const uint8_t* live, uint8_t* in_topk,
                               uint8_t* gdirty) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  const int32_t sid = excl[i] + flag[i] - 1;
  const int32_t s = order[i];
  in_topk[s] = live[s] && (i - seg_start[sid]) < k ? 1 : 0;
  gdirty[s] = seg_dirty[sid];
}

// keys: n_keys rows of (lane, dtype code, mode), most significant first:
// the n_group group lanes (PLAIN), live (LIVE_LAST), the order lane
// (ASC/DESC), the store's key lanes (PLAIN). Buffers as rw_rank_top's.
RW_EXPORT int rw_group_topk_mask(const int64_t* keys, int n_keys, int n_group, int64_t cap,
                                 const void* live, const void* epoch_dirty, int k,
                                 void* keys_buf, void* idx_buf, void* hist, void* bits,
                                 void* in_topk, void* gdirty, void* stream) {
  TrKeys kd;
  if (!tr_parse(keys, n_keys, &kd) || n_group < 1 || n_group > n_keys || cap < 1 || k < 0)
    return (int)cudaErrorInvalidValue;
  for (int g = 0; g < n_group; ++g)
    if (kd.mode[g] != TR_PLAIN) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int cur = tr_sort(kd, cap, (unsigned long long*)keys_buf, (int32_t*)idx_buf,
                          (int32_t*)hist, (unsigned long long*)bits, st);
  if (cur < 0) return (int)cudaGetLastError();
  const int32_t* order = (const int32_t*)idx_buf + cur * cap;
  // the key buffers (4 * cap int32 words) now hold flag, excl, seg_start
  // and (cap bytes) seg_dirty; hist holds the scan's partials
  int32_t* flag = (int32_t*)keys_buf;
  int32_t* excl = flag + cap;
  int32_t* seg_start = excl + cap;
  uint8_t* seg_dirty = (uint8_t*)(seg_start + cap);
  const int blocks = rw_blocks(cap, TR_THREADS);
  tr_bound_kernel<<<blocks, TR_THREADS, 0, st>>>(kd, n_group, cap, order, flag, seg_dirty);
  rw_exclusive_scan(flag, cap, (int32_t*)hist, excl, st);
  tr_seg_kernel<<<blocks, TR_THREADS, 0, st>>>(cap, order, flag, excl,
                                               (const uint8_t*)epoch_dirty, seg_start, seg_dirty);
  tr_mask_kernel<<<blocks, TR_THREADS, 0, st>>>(cap, k, order, flag, excl, seg_start, seg_dirty,
                                                (const uint8_t*)live, (uint8_t*)in_topk,
                                                (uint8_t*)gdirty);
  return (int)cudaGetLastError();
}
