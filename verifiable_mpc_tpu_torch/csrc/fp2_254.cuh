// Arithmetic in GF(p^2) = GF(p)[i] / (i^2 + 1) over the BN256 base field,
// in Montgomery form, for one thread.
//
// Counterpart of the GF(p^2) functions of
// verifiable_mpc_tpu/ops/bn2_pallas.py (_add2, _sub2, _mul2 by Karatsuba,
// _sq2, _b3mul2) with the constants of its _consts, over fp254.cuh's
// canonical 8 x 32-bit CIOS field.  Every part of every value is canonical,
// below p, in and out of every function; the sums inside Karatsuba's
// (a0 + a1)(b0 + b1) are fp254.cuh's carry-folding adds (this p is above
// 2^255, so a sum of two values carries out of bit 256).
//
// Costs in base-field Montgomery products: a product 3, a square 2, a
// product by the twist constant 3 b' (a full GF(p^2) constant, 9 / xi) 3,
// an inverse one Fermat inversion in GF(p) plus 4.
//
// Every function writes its result last, so the result may alias an
// operand.  __host__ __device__: the same header builds with g++ (tests
// compile it on the CPU) and with nvcc for sm_90a.

#pragma once

#include "fp254.cuh"

struct fp2 {
  fp c0, c1;
};

FE_FN void fp2_zero(fp2 &r) {
  fp_zero(r.c0);
  fp_zero(r.c1);
}

// 1 in Montgomery form
FE_FN void fp2_one_mont(fp2 &r) {
  fp_one_mont(r.c0);
  fp_zero(r.c1);
}

FE_FN bool fp2_is_zero(const fp2 &a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}

FE_FN bool fp2_equal(const fp2 &a, const fp2 &b) {
  return fp_equal(a.c0, b.c0) && fp_equal(a.c1, b.c1);
}

// eight little-endian u64 limbs (c0 then c1) <-> a value
FE_FN void fp2_load(fp2 &r, const uint64_t *s) {
  fp_load(r.c0, s);
  fp_load(r.c1, s + 4);
}

FE_FN void fp2_store(uint64_t *d, const fp2 &a) {
  fp_store(d, a.c0);
  fp_store(d + 4, a.c1);
}

FE_FN void fp2_add(fp2 &r, const fp2 &a, const fp2 &b) {
  fp x, y;
  fp_add(x, a.c0, b.c0);
  fp_add(y, a.c1, b.c1);
  r.c0 = x;
  r.c1 = y;
}

FE_FN void fp2_sub(fp2 &r, const fp2 &a, const fp2 &b) {
  fp x, y;
  fp_sub(x, a.c0, b.c0);
  fp_sub(y, a.c1, b.c1);
  r.c0 = x;
  r.c1 = y;
}

FE_FN void fp2_neg(fp2 &r, const fp2 &a) {
  fp x, y;
  fp_neg(x, a.c0);
  fp_neg(y, a.c1);
  r.c0 = x;
  r.c1 = y;
}

// Karatsuba (_mul2): t0 = a0 b0, t1 = a1 b1, t2 = (a0 + a1)(b0 + b1);
// real t0 - t1, imaginary t2 - t0 - t1 (i^2 = -1).  3 products.
FE_FN void fp2_mul(fp2 &r, const fp2 &a, const fp2 &b) {
  fp t0, t1, t2, s, u;
  fp_add(s, a.c0, a.c1);
  fp_add(u, b.c0, b.c1);
  fp_mul(t2, s, u);
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_sub(t2, t2, t0);
  fp_sub(r.c1, t2, t1);
  fp_sub(r.c0, t0, t1);
}

// (_sq2): (a0 + a1)(a0 - a1) + 2 a0 a1 i.  2 products.
FE_FN void fp2_sq(fp2 &r, const fp2 &a) {
  fp s, d, m1, m2;
  fp_add(s, a.c0, a.c1);
  fp_sub(d, a.c0, a.c1);
  fp_mul(m2, a.c0, a.c1);
  fp_mul(m1, s, d);
  r.c0 = m1;
  fp_add(r.c1, m2, m2);
}

// the parts of 3 b' = 9 / xi in Montgomery form: k0, k1 and k0 + k1 mod p
#define FP2_B3_K0                                                           \
  {{0x62409d6eu, 0xfb350956u, 0xa346e0e1u, 0xb406d934u, 0xec84376au,        \
    0x12138807u, 0x1dfd434fu, 0x3ae3914bu}}
#define FP2_B3_K1                                                           \
  {{0xa942a853u, 0x5f0d365cu, 0xd47a46e9u, 0x13718fdeu, 0x7c558c3du,        \
    0x32c976e5u, 0xb98cc18eu, 0x1c45d032u}}
#define FP2_B3_K01                                                          \
  {{0x0b8345c1u, 0x5a423fb3u, 0x77c127cbu, 0xc7786913u, 0x68d9c3a7u,        \
    0x44dcfeedu, 0xd78a04ddu, 0x5729617du}}

// times 3 b' (_b3mul2): Karatsuba against the constant's parts k0, k1 and
// k0 + k1.  3 products.
FE_FN void fp2_mul_b3(fp2 &r, const fp2 &a) {
  const fp k0 = FP2_B3_K0;
  const fp k1 = FP2_B3_K1;
  const fp k01 = FP2_B3_K01;
  fp t0, t1, t2, s;
  fp_add(s, a.c0, a.c1);
  fp_mul(t2, s, k01);
  fp_mul(t0, a.c0, k0);
  fp_mul(t1, a.c1, k1);
  fp_sub(t2, t2, t0);
  fp_sub(r.c1, t2, t1);
  fp_sub(r.c0, t0, t1);
}

// Karatsuba's parts of a product: r = a.c0, a.c1, a.c0 + a.c1 or a.c0 - a.c1
// for part 0, 1, 2 or 3 (a product's three base-field products take parts
// 0, 1 and 2 of both operands; a square's two take 2 and 3, then 0 and 1)
FE_FN void fp2_part(fp &r, const fp2 &a, int part) {
  if (part == 0) {
    r = a.c0;
  } else if (part == 1) {
    r = a.c1;
  } else if (part == 2) {
    fp_add(r, a.c0, a.c1);
  } else {
    fp_sub(r, a.c0, a.c1);
  }
}

// part 0, 1 or 2 of 3 b' (the constant operand of fp2_mul_b3's products)
FE_FN void fp2_b3_part(fp &r, int part) {
  const fp k0 = FP2_B3_K0;
  const fp k1 = FP2_B3_K1;
  const fp k01 = FP2_B3_K01;
  r = part == 0 ? k0 : part == 1 ? k1 : k01;
}

// a product from its three base-field products m = (a0 b0, a1 b1,
// (a0 + a1)(b0 + b1)): (m0 - m1, m2 - m0 - m1); r must not overlap m
FE_FN void fp2_karatsuba(fp2 &r, const fp *m) {
  fp t;
  fp_sub(t, m[2], m[0]);
  fp_sub(r.c1, t, m[1]);
  fp_sub(r.c0, m[0], m[1]);
}

// Montgomery form -> standard form, part by part
FE_FN void fp2_from_mont(fp2 &r, const fp2 &a) {
  fp x, y;
  fp_from_mont(x, a.c0);
  fp_from_mont(y, a.c1);
  r.c0 = x;
  r.c1 = y;
}

// the inverse of a Montgomery-form value, in Montgomery form: the
// conjugate over the norm a0^2 + a1^2, one Fermat inversion in GF(p)
// (0 maps to 0; field_bn254x2.inv runs the same steps)
FE_FN void fp2_inv(fp2 &r, const fp2 &a) {
  fp n, t, ni;
  fp_sq(n, a.c0);
  fp_sq(t, a.c1);
  fp_add(n, n, t);
  fp_inv(ni, n);
  fp_mul(t, a.c1, ni);
  fp_mul(r.c0, a.c0, ni);
  fp_neg(r.c1, t);
}
