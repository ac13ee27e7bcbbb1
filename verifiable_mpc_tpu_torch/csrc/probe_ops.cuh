// Loop bodies of the probe kernels P1-P4 (csrc/probe_vpu.cu,
// csrc/probe_carrychain.cu), for one thread.
//
// Counterparts of the bodies that probes/probe_vpu.py and
// probes/probe_carrychain.py hand to jax.lax.fori_loop inside their
// pallas_calls:
//   P1  one elementwise op x <- f(x, y) (probe_vpu.py:53-59);
//   P2  x <- mul25519(x, y) (fe25519.cuh's fe_mul) and x <- mont_mul(x, y)
//       mod 2^255 - 19 with R = 2^256 (limbs_lm.mont_mul with p25519's
//       constants, probe_vpu.py:78-79), here a word-by-word (CIOS)
//       Montgomery product; and, as a third row, fp254.cuh's fp_mul, the
//       BN256 product K5-K12 run;
//   P3  chains of fe_mul (probe_carrychain.py:61-72);
//   P4  x <- x * y + 1 (probe_carrychain.py:89-93), P1's u32_mul.
//
// The step counts are runtime arguments, so nvcc cannot fold a loop: the
// timed binary is the one the checks ran.  The elementwise loop runs
// VPU_UNROLL steps a turn (then the rest one at a time), so its body holds
// VPU_UNROLL copies of the op and three loop-control instructions.
//
// Every function is __host__ __device__: the same header builds with g++
// (tests compile it on the CPU) and with nvcc for sm_90a.

#pragma once

#include <math.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "fp254.cuh"

#define VPU_UNROLL 16

// static member functions cannot take FE_FN's "static" on the host
#if defined(__CUDACC__)
#define PROBE_MEMBER_FN __host__ __device__ __forceinline__
#else
#define PROBE_MEMBER_FN inline
#endif

// P1's four cases, in probe_vpu.py's order
enum { VPU_U32_MUL_SPLIT = 0, VPU_U32_MUL = 1, VPU_U32_ADD = 2, VPU_F32_FMA = 3 };

template <int OP>
struct VpuOp;

// ((x * y) & 0xFFFF) + ((x * y) >> 16): a limb product split
template <>
struct VpuOp<VPU_U32_MUL_SPLIT> {
  typedef uint32_t T;
  static PROBE_MEMBER_FN uint32_t step(uint32_t x, uint32_t y) {
    uint32_t p = x * y;
    return (p & 0xFFFFu) + (p >> 16);
  }
};

// x * y + 1 (also P4's step)
template <>
struct VpuOp<VPU_U32_MUL> {
  typedef uint32_t T;
  static PROBE_MEMBER_FN uint32_t step(uint32_t x, uint32_t y) { return x * y + 1u; }
};

// (x + y) ^ x
template <>
struct VpuOp<VPU_U32_ADD> {
  typedef uint32_t T;
  static PROBE_MEMBER_FN uint32_t step(uint32_t x, uint32_t y) { return (x + y) ^ x; }
};

// x * y + x, one fused multiply-add (one rounding)
template <>
struct VpuOp<VPU_F32_FMA> {
  typedef float T;
  static PROBE_MEMBER_FN float step(float x, float y) {
#if defined(__CUDA_ARCH__)
    return __fmaf_rn(x, y, x);
#else
    return fmaf(x, y, x);
#endif
  }
};

template <int OP>
FE_FN typename VpuOp<OP>::T vpu_steps(typename VpuOp<OP>::T x,
                                      typename VpuOp<OP>::T y, int iters) {
  int k = 0;
#pragma unroll 1
  for (; k + VPU_UNROLL <= iters; k += VPU_UNROLL) {
#pragma unroll
    for (int u = 0; u < VPU_UNROLL; u++) x = VpuOp<OP>::step(x, y);
  }
#pragma unroll 1
  for (; k < iters; k++) x = VpuOp<OP>::step(x, y);
  return x;
}

// P2's products
enum { FIELD_MUL25519 = 0, FIELD_MONT25519 = 1, FIELD_FP254 = 2 };

// 2^255 - 19 and -p^-1 mod 2^32, handed to the kernel as arguments so the
// Montgomery product multiplies by them as a general modulus would (a
// compile-time p of all-ones words would turn m * p[j] into shifts)
struct Mont25519 {
  uint32_t p[8];
  uint32_t n0;
};

FE_FN Mont25519 mont25519_consts() {
  Mont25519 k = {{0xffffffedu, 0xffffffffu, 0xffffffffu, 0xffffffffu,
                  0xffffffffu, 0xffffffffu, 0xffffffffu, 0x7fffffffu},
                 0x286bca1bu};
  return k;
}

// CIOS Montgomery product a * b * 2^-256 mod p, word by word: each of the
// eight rounds adds a * b[i], then m * p with m = t[0] * n0, and shifts
// one word out.  For a, b < 2^256 the running value stays below 2^256 + p
// (t[8] holds its top bit); one conditional subtraction of p leaves a
// result below 2^256, congruent but not always below p, as
// limbs_lm.mont_mul leaves inputs at or above p.
FE_FN void mont25519_mul(fe &r, const fe &a, const fe &b, const Mont25519 &k) {
  uint32_t t[10];
  for (int i = 0; i < 10; i++) t[i] = 0;
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
    for (int j = 0; j < 8; j++) {
      uint64_t x = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
      t[j] = (uint32_t)x;
      c = x >> 32;
    }
    uint64_t x = (uint64_t)t[8] + c;
    t[8] = (uint32_t)x;
    t[9] = (uint32_t)(x >> 32);
    uint32_t m = t[0] * k.n0;
    x = (uint64_t)m * k.p[0] + t[0];
    c = x >> 32;
    for (int j = 1; j < 8; j++) {
      x = (uint64_t)m * k.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)x;
      c = x >> 32;
    }
    x = (uint64_t)t[8] + c;
    t[7] = (uint32_t)x;
    t[8] = t[9] + (uint32_t)(x >> 32);
  }
  uint32_t d[8];
  uint64_t br = 0;
  for (int i = 0; i < 8; i++) {
    uint64_t x = (uint64_t)t[i] - k.p[i] - br;
    d[i] = (uint32_t)x;
    br = x >> 63;
  }
  bool sub = t[8] != 0 || br == 0;
  for (int i = 0; i < 8; i++) r.v[i] = sub ? d[i] : t[i];
}

template <int OP>
FE_FN void field_step(fe &a, const fe &b, const Mont25519 &k) {
  if (OP == FIELD_MUL25519) {
    fe_mul(a, a, b);
  } else if (OP == FIELD_MONT25519) {
    mont25519_mul(a, a, b, k);
  } else {
    fp x, y;
    for (int i = 0; i < 8; i++) {
      x.v[i] = a.v[i];
      y.v[i] = b.v[i];
    }
    fp_mul(x, x, y);
    for (int i = 0; i < 8; i++) a.v[i] = x.v[i];
  }
}

template <int OP>
FE_FN void field_steps(fe &a, const fe &b, const Mont25519 &k, int iters) {
#pragma unroll 1
  for (int s = 0; s < iters; s++) field_step<OP>(a, b, k);
}

// P3: K independent chains a_c <- a_c * b, interleaved in one loop
template <int K>
FE_FN void chain_steps(fe *a, const fe &b, int iters) {
#pragma unroll 1
  for (int s = 0; s < iters; s++) {
#pragma unroll
    for (int c = 0; c < K; c++) fe_mul(a[c], a[c], b);
  }
}

// word-major [8][n] u32 <-> one lane's value
FE_FN void fe_load_words(fe &r, const uint32_t *w, long long n, long long i) {
  for (int k = 0; k < 8; k++) r.v[k] = w[k * n + i];
}

FE_FN void fe_store_words(uint32_t *w, const fe &a, long long n, long long i) {
  for (int k = 0; k < 8; k++) w[k * n + i] = a.v[k];
}
