// Kernel S's interpreter: one row of a compiled expression program.
//
// Replaces the reference's expression evaluation inside its jitted
// steps (risingwave_tpu/expr/expr.py node evals, expr/functions.py Func,
// Extract, DateTrunc, Coalesce, NullIf, StringFunc). The program comes
// from risingwave_tpu_torch/ops/expr_vm.py (Compiler -> Program,
// pack_program), which also holds the plain PyTorch semantics of every
// opcode (OPS); the numbers below are its opcode numbers.
//
// A register holds a 64-bit word and a NULL bit: bools and ints as
// sign-extended int64 (an int32 result wrapped to 32 bits), float32 and
// float64 values as float64 bits (a float32 value is exact in a double,
// and float32 operations round through float). Float arithmetic uses
// the _rn intrinsics, which nvcc never contracts into an FMA, so + - * /
// match the reference bit for bit; transcendental functions use
// libdevice and may differ from XLA's by a few ulp.
//
// Every thread runs the same instruction stream for its own row, so the
// switch is warp-uniform; the program sits in the kernel's by-value
// parameter (__grid_constant__, read through the constant cache).
#pragma once

#include <math.h>

#include "common.cuh"

#define VM_MAX_INSN 128
#define VM_MAX_REGS 32
#define VM_MAX_IN 16
#define VM_MAX_OUT 16
#define VM_MAX_LITS 128

enum VmOp : int {
  VM_COL = 1, VM_LIT = 2, VM_NULL_LIT = 3, VM_PARAM_I = 4, VM_PARAM_F = 5, VM_CAST = 6,
  VM_GUARDZ = 7, VM_ADD = 8, VM_SUB = 9, VM_MUL = 10, VM_FLOORDIV = 11, VM_TRUEDIV = 12,
  VM_REM = 13, VM_EQ = 14, VM_NE = 15, VM_LT = 16, VM_LE = 17, VM_GT = 18, VM_GE = 19,
  VM_BAND = 20, VM_BOR = 21, VM_NOT = 22, VM_AND3 = 23, VM_OR3 = 24, VM_ISNULL = 25,
  VM_SELECT = 26, VM_COALESCE2 = 27, VM_NULLIF = 28, VM_NOTNULL = 29, VM_FALSE = 30,
  VM_ABS = 31, VM_SIGN = 32, VM_CEIL = 33, VM_FLOOR = 34, VM_ROUND = 35, VM_TRUNC = 36,
  VM_POW10 = 37, VM_MATH1 = 38, VM_MATH2 = 39, VM_FACTORIAL = 40, VM_GCD = 41, VM_LCM = 42,
  VM_BITAND = 43, VM_BITOR = 44, VM_BITXOR = 45, VM_BITNOT = 46, VM_SHL = 47, VM_SHR = 48,
  VM_MAX = 49, VM_MIN = 50, VM_EXTRACT = 51, VM_DATETRUNC = 52, VM_GATHER = 53,
  VM_FIRST = 55,
};

// row ops (types.Op)
#define VM_OP_INSERT 0
#define VM_OP_DELETE 1
#define VM_OP_UD 2
#define VM_OP_UI 3

struct VmProg {
  int n_insn, n_in, n_out, n_lits, keep_reg;
  // x: op | dt << 8 | out << 12; y: dst | a << 8 | b << 16 | c << 24;
  // z, w: the attributes (lane or pool index, length, field, function)
  int4 insn[VM_MAX_INSN];
  const void* in_v[VM_MAX_IN];
  const uint8_t* in_n[VM_MAX_IN];  // nullptr: the lane has no NULLs
  int in_dt[VM_MAX_IN];
  void* out_v[VM_MAX_OUT];
  uint8_t* out_n[VM_MAX_OUT];  // nullptr: the output has no NULL lane
  int out_dt[VM_MAX_OUT];
  int out_reg[VM_MAX_OUT];
  long long lits[VM_MAX_LITS];
};

__device__ __forceinline__ double vm_d(long long x) { return __longlong_as_double(x); }
__device__ __forceinline__ long long vm_w(double d) { return __double_as_longlong(d); }
__device__ __forceinline__ long long vm_wf(float f) { return __double_as_longlong((double)f); }
__device__ __forceinline__ float vm_f(long long x) { return (float)__longlong_as_double(x); }
__device__ __forceinline__ bool vm_isf(int dt) { return dt == RW_F32 || dt == RW_F64; }

__device__ __forceinline__ long long vm_wrap(unsigned long long x, int dt) {
  if (dt == RW_I32) return (long long)(int)(unsigned int)x;
  if (dt == RW_BOOL) return x != 0ull;
  return (long long)x;
}

__device__ __forceinline__ double vm_sgn(double x) { return x > 0.0 ? 1.0 : (x < 0.0 ? -1.0 : x); }
__device__ __forceinline__ float vm_sgnf(float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : x); }
__device__ __forceinline__ long long vm_isgn(long long x) { return (x > 0) - (x < 0); }

// XLA's truncating integer division and remainder: x / 0 = -1, x % 0 =
// x, and x / -1 wraps (INT_MIN / -1 = INT_MIN), x % -1 = 0.
__device__ __forceinline__ long long vm_idiv(long long a, long long b) {
  if (b == 0) return -1;
  if (b == -1) return (long long)(0ull - (unsigned long long)a);
  return a / b;
}
__device__ __forceinline__ long long vm_irem(long long a, long long b) {
  if (b == 0) return a;
  if (b == -1) return 0;
  return a % b;
}

// floor division / remainder by a positive constant (the calendar)
__device__ __forceinline__ long long vm_fdiv(long long a, long long k) {
  const long long q = a / k;
  return (a % k != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ long long vm_pmod(long long a, long long k) {
  return a - vm_fdiv(a, k) * k;
}

#define VM_MS_DAY 86400000ll

__device__ void vm_civil(long long days, long long* y_, long long* m_, long long* d_) {
  const long long z = days + 719468;
  const long long era = vm_fdiv(z >= 0 ? z : z - 146096, 146097);
  const long long doe = z - era * 146097;
  const long long yoe =
      vm_fdiv(doe - vm_fdiv(doe, 1460) + vm_fdiv(doe, 36524) - vm_fdiv(doe, 146096), 365);
  const long long y = yoe + era * 400;
  const long long doy = doe - (365 * yoe + vm_fdiv(yoe, 4) - vm_fdiv(yoe, 100));
  const long long mp = vm_fdiv(5 * doy + 2, 153);
  const long long d = doy - vm_fdiv(153 * mp + 2, 5) + 1;
  const long long m = mp < 10 ? mp + 3 : mp - 9;
  *y_ = m <= 2 ? y + 1 : y;
  *m_ = m;
  *d_ = d;
}

__device__ long long vm_days_from_civil(long long y, long long m, long long d) {
  y = m <= 2 ? y - 1 : y;
  const long long era = vm_fdiv(y >= 0 ? y : y - 399, 400);
  const long long yoe = y - era * 400;
  const long long mp = m > 2 ? m - 3 : m + 9;
  const long long doy = vm_fdiv(153 * mp + 2, 5) + d - 1;
  const long long doe = yoe * 365 + vm_fdiv(yoe, 4) - vm_fdiv(yoe, 100) + doy;
  return era * 146097 + doe - 719468;
}

// field order: expr_vm.EXTRACT_FIELDS
__device__ long long vm_extract(int field, long long ts) {
  const long long days = vm_fdiv(ts, VM_MS_DAY);
  const long long ms_of_day = ts - days * VM_MS_DAY;
  switch (field) {
    case 0: return vm_fdiv(ts, 1000);
    case 1: return vm_pmod(ms_of_day, 1000);
    case 2: return vm_pmod(vm_fdiv(ms_of_day, 1000), 60);
    case 3: return vm_pmod(vm_fdiv(ms_of_day, 60000), 60);
    case 4: return vm_fdiv(ms_of_day, 3600000);
    case 8: return vm_pmod(days + 4, 7);
    default: break;
  }
  long long y, m, d;
  vm_civil(days, &y, &m, &d);
  if (field == 5) return d;
  if (field == 6) return m;
  if (field == 7) return y;
  return days - vm_days_from_civil(y, 1, 1) + 1;  // 9: doy
}

// field order: expr_vm.TRUNC_FIELDS
__device__ long long vm_date_trunc(int field, long long ts) {
  switch (field) {
    case 0: return vm_fdiv(ts, 1000) * 1000;
    case 1: return vm_fdiv(ts, 60000) * 60000;
    case 2: return vm_fdiv(ts, 3600000) * 3600000;
    case 3: return vm_fdiv(ts, VM_MS_DAY) * VM_MS_DAY;
    default: break;
  }
  const long long days = vm_fdiv(ts, VM_MS_DAY);
  if (field == 4) return (days - vm_pmod(days + 3, 7)) * VM_MS_DAY;
  long long y, m, d;
  vm_civil(days, &y, &m, &d);
  return vm_days_from_civil(y, field == 5 ? m : 1, 1) * VM_MS_DAY;
}

__device__ __forceinline__ long long vm_cast(long long x, int from, int to) {
  const bool ff = vm_isf(from);
  switch (to) {
    case RW_BOOL: return ff ? (vm_d(x) != 0.0) : (x != 0);
    case RW_I32: return ff ? (long long)__double2int_rz(vm_d(x)) : vm_wrap(x, RW_I32);
    case RW_I64: return ff ? __double2ll_rz(vm_d(x)) : x;
    case RW_F32: return ff ? vm_wf(__double2float_rn(vm_d(x))) : vm_wf(__ll2float_rn(x));
    default: return ff ? x : vm_w(__ll2double_rn(x));  // RW_F64
  }
}

__device__ __forceinline__ double vm_max_d(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}
__device__ __forceinline__ double vm_min_d(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

__device__ double vm_math1(int fn, double f, bool* bad) {
  switch (fn) {
    case 0: *bad = f < 0.0; return sqrt(*bad ? 0.0 : f);
    case 1: return exp(f);
    case 2: *bad = f <= 0.0; return log(*bad ? 1.0 : f);
    case 3: *bad = f <= 0.0; return __ddiv_rn(log(*bad ? 1.0 : f), 2.302585092994046);
    case 4: return cbrt(f);
    case 5: *bad = f <= 0.0; return __ddiv_rn(log(f), 0.6931471805599453);
    case 6: return sin(f);
    case 7: return cos(f);
    case 8: return tan(f);
    case 9: return __ddiv_rn(cos(f), sin(f));
    case 10: *bad = fabs(f) > 1.0; return asin(f);
    case 11: *bad = fabs(f) > 1.0; return acos(f);
    case 12: return atan(f);
    case 13: return sinh(f);
    case 14: return cosh(f);
    case 15: return tanh(f);
    case 16: return asinh(f);
    case 17: *bad = f < 1.0; return acosh(*bad ? 1.0 : f);
    case 18: {  // XLA's form: 0.5 * log1p(x) - 0.5 * log1p(-x)
      *bad = fabs(f) >= 1.0;
      const double x = *bad ? 0.0 : f;
      return __dsub_rn(__dmul_rn(0.5, log1p(x)), __dmul_rn(0.5, log1p(-x)));
    }
    case 19: return __dmul_rn(f, 57.29577951308232);     // 180 / pi
    default: return __dmul_rn(f, 0.017453292519943295);  // 20: pi / 180
  }
}

__device__ double vm_math2(int fn, double a, double b, bool* bad) {
  switch (fn) {
    case 0: return pow(a, b);
    case 1: return atan2(a, b);
    case 2: {  // jnp.hypot, step for step
      const double x1 = fabs(a), x2 = fabs(b);
      const bool inf = isinf(x1) || isinf(x2);
      const double hi = vm_max_d(x1, x2), lo = vm_min_d(x1, x2);
      const double q = __ddiv_rn(lo, hi == 0.0 ? 1.0 : hi);
      const double x = hi == 0.0 ? hi : __dmul_rn(hi, __dsqrt_rn(__dadd_rn(1.0, __dmul_rn(q, q))));
      return inf ? (double)INFINITY : x;
    }
    default:  // 3: log(base a, x b)
      *bad = b <= 0.0 || a <= 0.0 || a == 1.0;
      return __ddiv_rn(log(b), log(a));
  }
}

__device__ __forceinline__ long long vm_gcd(long long a, long long b) {
  long long x1 = a < 0 ? (long long)(0ull - (unsigned long long)a) : a;
  long long x2 = b < 0 ? (long long)(0ull - (unsigned long long)b) : b;
  // jnp.gcd's loop; Euclid on 64 bits ends within 93 steps, the cap
  // only stops the INT64_MIN rows the reference never finishes
  for (int it = 0; it < 128 && x2 != 0; ++it) {
    const long long r = vm_irem(x1, x2);
    x1 = x2;
    x2 = r;
    if (x1 < x2) {
      const long long t = x1;
      x1 = x2;
      x2 = t;
    }
  }
  return x1;
}

__device__ __forceinline__ long long vm_floordiv_i(long long a, long long b, int dt) {
  const long long q = vm_idiv(a, b);
  const bool sel = vm_isgn(a) != vm_isgn(b) && vm_irem(a, b) != 0;
  return vm_wrap((unsigned long long)q - (sel ? 1ull : 0ull), dt);
}

__device__ __forceinline__ long long vm_rem_i(long long a, long long b, int dt) {
  if (b == 0) b = 1;
  const long long tm = vm_irem(a, b);
  const bool plus = ((tm < 0) != (b < 0)) && tm != 0;
  return vm_wrap((unsigned long long)tm + (plus ? (unsigned long long)b : 0ull), dt);
}

__constant__ long long vm_factorials[21] = {
    1ll, 1ll, 2ll, 6ll, 24ll, 120ll, 720ll, 5040ll, 40320ll, 362880ll, 3628800ll, 39916800ll,
    479001600ll, 6227020800ll, 87178291200ll, 1307674368000ll, 20922789888000ll,
    355687428096000ll, 6402373705728000ll, 121645100408832000ll, 2432902008176640000ll};

__device__ __forceinline__ long long vm_load(const VmProg& p, int k, int64_t row, bool* null) {
  const int dt = p.in_dt[k];
  const void* v = p.in_v[k];
  *null = p.in_n[k] != nullptr && p.in_n[k][row] != 0;
  switch (dt) {
    case RW_BOOL: return ((const uint8_t*)v)[row] != 0;
    case RW_I32: return ((const int32_t*)v)[row];
    case RW_I64: return ((const long long*)v)[row];
    case RW_F32: return vm_wf(((const float*)v)[row]);
    default: return ((const long long*)v)[row];  // RW_F64: the bits as they are
  }
}

__device__ __forceinline__ void vm_store(const VmProg& p, int j, int64_t row, const long long* r,
                                         unsigned nul) {
  const int reg = p.out_reg[j];
  const long long x = r[reg];
  void* v = p.out_v[j];
  switch (p.out_dt[j]) {
    case RW_BOOL: ((uint8_t*)v)[row] = x != 0; break;
    case RW_I32: ((int32_t*)v)[row] = (int32_t)x; break;
    case RW_I64: ((long long*)v)[row] = x; break;
    case RW_F32: ((float*)v)[row] = vm_f(x); break;
    default: ((long long*)v)[row] = x; break;
  }
  if (p.out_n[j] != nullptr) p.out_n[j][row] = (nul >> reg) & 1u;
}

// Run every instruction for one row; r and nul hold the registers.
__device__ void vm_row(const VmProg& p, int64_t row, const long long* pi, const long long* pf,
                       long long* r, unsigned& nul) {
  for (int k = 0; k < p.n_insn; ++k) {
    const int4 in = p.insn[k];
    const int op = in.x & 0xFF, dt = (in.x >> 8) & 0xF;
    const int dst = in.y & 0xFF, ra = (in.y >> 8) & 0xFF, rb = (in.y >> 16) & 0xFF,
              rc = (in.y >> 24) & 0xFF;
    const long long a = r[ra], b = r[rb], c = r[rc];
    const bool an = (nul >> ra) & 1u, bn = (nul >> rb) & 1u, cn = (nul >> rc) & 1u;
    const bool fl = vm_isf(dt), f32 = dt == RW_F32;
    long long v = 0;
    bool n = an;  // unary strict ops; others set it below
    bool bad = false;
    switch (op) {
      case VM_COL: v = vm_load(p, in.z, row, &n); break;
      case VM_LIT: v = p.lits[in.z]; n = false; break;
      case VM_NULL_LIT: v = 0; n = true; break;
      case VM_PARAM_I: v = pi[in.z]; n = false; break;
      case VM_PARAM_F: v = pf[in.z]; n = false; break;
      case VM_CAST: v = vm_cast(a, in.z, dt); break;
      case VM_GUARDZ: {
        const bool z = fl ? vm_d(a) == 0.0 : a == 0;
        v = z ? (fl ? vm_w(1.0) : 1) : a;
        n = an || z;
        break;
      }
      case VM_ADD: case VM_SUB: case VM_MUL: case VM_TRUEDIV: case VM_FLOORDIV: case VM_REM:
      case VM_MAX: case VM_MIN: {
        n = an || bn;
        if (f32) {
          const float x = vm_f(a), y = vm_f(b);
          float z;
          switch (op) {
            case VM_ADD: z = __fadd_rn(x, y); break;
            case VM_SUB: z = __fsub_rn(x, y); break;
            case VM_MUL: z = __fmul_rn(x, y); break;
            case VM_TRUEDIV: z = __fdiv_rn(x, y); break;
            case VM_FLOORDIV: {
              const float mod = fmodf(x, y);
              float div = __fdiv_rn(__fsub_rn(x, mod), y);
              if (mod != 0.f && vm_sgnf(y) != vm_sgnf(mod)) div = __fsub_rn(div, 1.f);
              z = roundf(div);
              break;
            }
            case VM_REM: {
              z = fmodf(x, y);
              if (((z < 0.f) != (y < 0.f)) && z != 0.f) z = __fadd_rn(z, y);
              break;
            }
            case VM_MAX: z = (float)vm_max_d(x, y); break;
            default: z = (float)vm_min_d(x, y); break;
          }
          v = vm_wf(z);
        } else if (fl) {
          const double x = vm_d(a), y = vm_d(b);
          double z;
          switch (op) {
            case VM_ADD: z = __dadd_rn(x, y); break;
            case VM_SUB: z = __dsub_rn(x, y); break;
            case VM_MUL: z = __dmul_rn(x, y); break;
            case VM_TRUEDIV: z = __ddiv_rn(x, y); break;
            case VM_FLOORDIV: {
              const double mod = fmod(x, y);
              double div = __ddiv_rn(__dsub_rn(x, mod), y);
              if (mod != 0.0 && vm_sgn(y) != vm_sgn(mod)) div = __dsub_rn(div, 1.0);
              z = round(div);
              break;
            }
            case VM_REM: {
              z = fmod(x, y);
              if (((z < 0.0) != (y < 0.0)) && z != 0.0) z = __dadd_rn(z, y);
              break;
            }
            case VM_MAX: z = vm_max_d(x, y); break;
            default: z = vm_min_d(x, y); break;
          }
          v = vm_w(z);
        } else {
          const unsigned long long x = (unsigned long long)a, y = (unsigned long long)b;
          switch (op) {
            case VM_ADD: v = vm_wrap(x + y, dt); break;
            case VM_SUB: v = vm_wrap(x - y, dt); break;
            case VM_MUL: v = vm_wrap(x * y, dt); break;
            case VM_FLOORDIV: v = vm_floordiv_i(a, b, dt); break;
            case VM_REM: v = vm_rem_i(a, b, dt); break;
            case VM_MAX: v = a > b ? a : b; break;
            case VM_MIN: v = a < b ? a : b; break;
            default: v = 0; break;  // TRUEDIV is never integer-typed
          }
        }
        break;
      }
      case VM_EQ: case VM_NE: case VM_LT: case VM_LE: case VM_GT: case VM_GE: {
        n = an || bn;
        bool z;
        if (fl) {
          const double x = vm_d(a), y = vm_d(b);
          z = op == VM_EQ ? x == y : op == VM_NE ? x != y : op == VM_LT ? x < y
            : op == VM_LE ? x <= y : op == VM_GT ? x > y : x >= y;
        } else {
          z = op == VM_EQ ? a == b : op == VM_NE ? a != b : op == VM_LT ? a < b
            : op == VM_LE ? a <= b : op == VM_GT ? a > b : a >= b;
        }
        v = z;
        break;
      }
      case VM_BAND: v = (a != 0) && (b != 0); n = an || bn; break;
      case VM_BOR: v = (a != 0) || (b != 0); n = an || bn; break;
      case VM_NOT: v = a == 0; break;
      case VM_AND3: {
        const bool l = a != 0, rr = b != 0;
        const bool ldf = !l && !an, rdf = !rr && !bn;
        n = (an || bn) && !ldf && !rdf;
        v = l && rr && !n;
        break;
      }
      case VM_OR3: {
        const bool l = a != 0, rr = b != 0;
        const bool ldt = l && !an, rdt = rr && !bn;
        n = (an || bn) && !ldt && !rdt;
        v = (l || rr || ldt || rdt) && !n;
        break;
      }
      case VM_ISNULL: v = an != (in.z != 0); n = false; break;
      case VM_SELECT: {
        const bool fire = a != 0 && !an;
        v = fire ? b : c;
        n = fire ? bn : cn;
        break;
      }
      case VM_COALESCE2: v = an ? b : a; n = an && bn; break;
      case VM_NULLIF: v = a; n = an || (b != 0 && !bn); break;
      case VM_NOTNULL: v = a; n = false; break;
      case VM_FALSE: v = 0; break;
      case VM_FIRST: v = a; n = an || bn; break;
      case VM_ABS:
        if (f32) v = vm_wf(fabsf(vm_f(a)));
        else if (fl) v = vm_w(fabs(vm_d(a)));
        else v = vm_wrap(a < 0 ? 0ull - (unsigned long long)a : (unsigned long long)a, dt);
        break;
      case VM_SIGN:
        if (f32) v = vm_wf(vm_sgnf(vm_f(a)));
        else if (fl) v = vm_w(vm_sgn(vm_d(a)));
        else v = vm_isgn(a);
        break;
      case VM_CEIL: v = f32 ? vm_wf(ceilf(vm_f(a))) : vm_w(ceil(vm_d(a))); break;
      case VM_FLOOR: v = f32 ? vm_wf(floorf(vm_f(a))) : vm_w(floor(vm_d(a))); break;
      case VM_ROUND: v = f32 ? vm_wf(rintf(vm_f(a))) : vm_w(rint(vm_d(a))); break;
      case VM_TRUNC: v = f32 ? vm_wf(truncf(vm_f(a))) : vm_w(trunc(vm_d(a))); break;
      case VM_POW10: v = f32 ? vm_wf(powf(10.f, vm_f(a))) : vm_w(pow(10.0, vm_d(a))); break;
      case VM_MATH1: v = vm_w(vm_math1(in.z, vm_d(a), &bad)); n = an || bad; break;
      case VM_MATH2: v = vm_w(vm_math2(in.z, vm_d(a), vm_d(b), &bad)); n = an || bn || bad; break;
      case VM_FACTORIAL: {
        bad = a < 0 || a > 20;
        v = vm_factorials[a < 0 ? 0 : (a > 20 ? 20 : a)];
        n = an || bad;
        break;
      }
      case VM_GCD: v = vm_gcd(a, b); n = an || bn; break;
      case VM_LCM: {
        const long long d = vm_gcd(a, b);
        if (d == 0) {
          v = 0;
        } else {
          const long long m = (long long)((unsigned long long)a *
                                          (unsigned long long)vm_floordiv_i(b, d, RW_I64));
          v = m < 0 ? (long long)(0ull - (unsigned long long)m) : m;
        }
        n = an || bn;
        break;
      }
      case VM_BITAND: v = a & b; n = an || bn; break;
      case VM_BITOR: v = a | b; n = an || bn; break;
      case VM_BITXOR: v = a ^ b; n = an || bn; break;
      case VM_BITNOT: v = ~a; break;
      case VM_SHL:
        v = (b < 0 || b >= 64) ? 0 : (long long)((unsigned long long)a << b);
        n = an || bn;
        break;
      case VM_SHR:
        v = (b < 0 || b >= 64) ? (a < 0 ? -1 : 0) : (a >> b);
        n = an || bn;
        break;
      case VM_EXTRACT: v = vm_extract(in.z, a); break;
      case VM_DATETRUNC: v = vm_date_trunc(in.z, a); break;
      case VM_GATHER: {
        const long long idx = a < 0 ? 0 : (a >= in.w ? in.w - 1 : a);
        v = p.lits[in.z + idx];
        break;
      }
      default: break;
    }
    r[dst] = v;
    nul = n ? (nul | (1u << dst)) : (nul & ~(1u << dst));
  }
}

// A filter program's verdict for one row: its predicate TRUE (NULL drops).
__device__ __forceinline__ bool vm_keep(const VmProg& p, int64_t row, const long long* pi,
                                        const long long* pf, long long* r) {
  unsigned nul = 0;
  vm_row(p, row, pi, pf, r, nul);
  return r[p.keep_reg] != 0 && !((nul >> p.keep_reg) & 1u);
}
