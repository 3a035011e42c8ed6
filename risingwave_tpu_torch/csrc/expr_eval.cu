// Kernel S: Project and Filter over a compiled expression program.
//
// Replaces risingwave_tpu/executors/project.py:_project_step (:22, K24b)
// and executors/filter.py:_filter_step (:25, K24a) together with the
// expression trees they evaluate (K23; the interpreter is expr_vm.cuh).
//
// rw_project: one launch evaluates every computed output of a Project,
// row by row (a grid-stride loop, one row per thread at a time), and
// writes each output's value lane and, where the output is nullable,
// its NULL lane.
//
// rw_filter: one launch evaluates the predicate, writes valid & keep,
// and rewrites torn update pairs: a surviving U- whose next row is not a
// surviving U+ becomes a Delete, a surviving U+ whose previous row is
// not a surviving U- an Insert. A block takes a tile of 256 rows and
// keeps their verdicts in shared memory; a row whose neighbour lies
// outside the tile (the one-row halo on each side, and the wraparound
// at a chunk's ends, where row 0's U+ looks at row cap-1 as jnp.roll
// does) evaluates the neighbour's predicate itself, so no second launch
// is needed. Stacked chunks (n_chunks, cap) wrap within each chunk.
//
// What bounds it on the card: bytes for a short program (each input lane
// read once, each output written once, coalesced); on 65,536-row chunks
// the launch itself. The program's instruction words are read through
// the constant cache by all threads of a warp at once.
#include "expr_vm.cuh"

#define VM_TILE 256

__global__ void vm_project_kernel(const __grid_constant__ VmProg p, int64_t n,
                                  const long long* pi, const long long* pf) {
  long long r[VM_MAX_REGS];
  for (int i = 0; i < VM_MAX_REGS; ++i) r[i] = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; row < n; row += stride) {
    unsigned nul = 0;
    vm_row(p, row, pi, pf, r, nul);
    for (int j = 0; j < p.n_out; ++j) vm_store(p, j, row, r, nul);
  }
}

__global__ void vm_filter_kernel(const __grid_constant__ VmProg p, int64_t n_chunks, int64_t cap,
                                 const uint8_t* valid, const int32_t* ops, uint8_t* valid_out,
                                 int32_t* ops_out, const long long* pi, const long long* pf) {
  __shared__ uint8_t s_alive[VM_TILE];
  __shared__ int32_t s_op[VM_TILE];
  long long r[VM_MAX_REGS];
  for (int i = 0; i < VM_MAX_REGS; ++i) r[i] = 0;
  const int64_t total = n_chunks * cap;
  const int64_t t0 = (int64_t)blockIdx.x * VM_TILE;
  const int64_t s = t0 + threadIdx.x;
  bool alive = false;
  int32_t op = 0;
  if (s < total) {
    op = ops[s];
    alive = valid[s] != 0 && vm_keep(p, s, pi, pf, r);
    valid_out[s] = alive;
  }
  s_alive[threadIdx.x] = alive;
  s_op[threadIdx.x] = op;
  __syncthreads();
  if (s >= total) return;
  int32_t out = op;
  if (alive && (op == VM_OP_UD || op == VM_OP_UI)) {
    const int64_t c = s / cap, rr = s - c * cap;
    int64_t q;  // the partner row: next for a U-, previous for a U+
    if (op == VM_OP_UD) q = rr == cap - 1 ? s - rr : s + 1;
    else q = rr == 0 ? s + cap - 1 : s - 1;
    bool q_alive;
    int32_t q_op;
    if (q >= t0 && q < t0 + VM_TILE) {
      q_alive = s_alive[q - t0] != 0;
      q_op = s_op[q - t0];
    } else {  // the halo row: evaluate it here
      q_op = ops[q];
      q_alive = valid[q] != 0 && vm_keep(p, q, pi, pf, r);
    }
    if (op == VM_OP_UD && !(q_alive && q_op == VM_OP_UI)) out = VM_OP_DELETE;
    if (op == VM_OP_UI && !(q_alive && q_op == VM_OP_UD)) out = VM_OP_INSERT;
  }
  ops_out[s] = out;
}

// The host descriptor (ops/expr_vm.py:pack_program), int64 words:
// n_insn, n_in, n_out, n_lits, keep_reg; per instruction its four
// words; per input (value ptr, null ptr or 0, dtype); per output
// (value ptr, null ptr or 0, dtype | reg << 8); the literal pool.
static int vm_parse(const int64_t* w, int n_words, VmProg* p) {
  if (n_words < 5) return -1;
  p->n_insn = (int)w[0];
  p->n_in = (int)w[1];
  p->n_out = (int)w[2];
  p->n_lits = (int)w[3];
  p->keep_reg = (int)w[4];
  if (p->n_insn < 0 || p->n_insn > VM_MAX_INSN || p->n_in < 0 || p->n_in > VM_MAX_IN ||
      p->n_out < 0 || p->n_out > VM_MAX_OUT || p->n_lits < 0 || p->n_lits > VM_MAX_LITS ||
      p->keep_reg >= VM_MAX_REGS)
    return -1;
  if (n_words != 5 + 4 * p->n_insn + 3 * p->n_in + 3 * p->n_out + p->n_lits) return -1;
  int k = 5;
  for (int i = 0; i < p->n_insn; ++i, k += 4) {
    p->insn[i] = make_int4((int)w[k], (int)w[k + 1], (int)w[k + 2], (int)w[k + 3]);
    const int op = (int)(w[k] & 0xFF), dt = (int)((w[k] >> 8) & 0xF);
    const int64_t regs = w[k + 1];
    for (int b = 0; b < 4; ++b)
      if (((regs >> (8 * b)) & 0xFF) >= VM_MAX_REGS) return -1;
    if (dt > RW_F64 || op < VM_COL || op > VM_FIRST) return -1;
    if (op == VM_COL && (w[k + 2] < 0 || w[k + 2] >= p->n_in)) return -1;
    if (op == VM_LIT && (w[k + 2] < 0 || w[k + 2] >= p->n_lits)) return -1;
    if (op == VM_GATHER && (w[k + 3] < 1 || w[k + 2] < 0 || w[k + 2] + w[k + 3] > p->n_lits))
      return -1;
  }
  for (int i = 0; i < p->n_in; ++i, k += 3) {
    p->in_v[i] = (const void*)w[k];
    p->in_n[i] = (const uint8_t*)w[k + 1];
    p->in_dt[i] = (int)w[k + 2];
    if (p->in_v[i] == nullptr || p->in_dt[i] < 0 || p->in_dt[i] > RW_F64) return -1;
  }
  for (int i = 0; i < p->n_out; ++i, k += 3) {
    p->out_v[i] = (void*)w[k];
    p->out_n[i] = (uint8_t*)w[k + 1];
    p->out_dt[i] = (int)(w[k + 2] & 0xFF);
    p->out_reg[i] = (int)(w[k + 2] >> 8);
    if (p->out_v[i] == nullptr || p->out_dt[i] > RW_F64 || p->out_reg[i] >= VM_MAX_REGS)
      return -1;
  }
  for (int i = 0; i < p->n_lits; ++i, ++k) p->lits[i] = (long long)w[k];
  return 0;
}

// A program that reads a lifted literal needs that kind's parameter
// vector (an empty vector's pointer may be null: it is never read).
static bool vm_params_ok(const VmProg& p, const void* params_i, const void* params_f) {
  for (int i = 0; i < p.n_insn; ++i) {
    const int op = p.insn[i].x & 0xFF;
    if ((op == VM_PARAM_I && params_i == nullptr) || (op == VM_PARAM_F && params_f == nullptr))
      return false;
  }
  return true;
}

RW_EXPORT int rw_project(const int64_t* desc, int n_words, int64_t n_rows, const void* params_i,
                         const void* params_f, void* stream) {
  VmProg p;
  if (vm_parse(desc, n_words, &p) != 0 || p.keep_reg >= 0) return (int)cudaErrorInvalidValue;
  if (!vm_params_ok(p, params_i, params_f)) return (int)cudaErrorInvalidValue;
  if (n_rows > 0 && p.n_out > 0) {
    const int threads = 256;
    int64_t blocks = (n_rows + threads - 1) / threads;
    if (blocks > 132 * 16) blocks = 132 * 16;
    vm_project_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
        p, n_rows, (const long long*)params_i, (const long long*)params_f);
  }
  return (int)cudaGetLastError();
}

RW_EXPORT int rw_filter(const int64_t* desc, int n_words, int64_t n_chunks, int64_t cap,
                        const void* valid, const void* ops, void* valid_out, void* ops_out,
                        const void* params_i, const void* params_f, void* stream) {
  VmProg p;
  if (vm_parse(desc, n_words, &p) != 0 || p.keep_reg < 0 || p.n_out != 0)
    return (int)cudaErrorInvalidValue;
  if (!vm_params_ok(p, params_i, params_f)) return (int)cudaErrorInvalidValue;
  const int64_t total = n_chunks * cap;
  if (total > 0) {
    const int64_t blocks = (total + VM_TILE - 1) / VM_TILE;
    vm_filter_kernel<<<(int)blocks, VM_TILE, 0, (cudaStream_t)stream>>>(
        p, n_chunks, cap, (const uint8_t*)valid, (const int32_t*)ops, (uint8_t*)valid_out,
        (int32_t*)ops_out, (const long long*)params_i, (const long long*)params_f);
  }
  return (int)cudaGetLastError();
}
