// Arithmetic mod the BN256 base-field prime p in Montgomery form
// (R = 2^256), for one thread.
//
// Counterpart of the Montgomery functions of
// verifiable_mpc_tpu/ops/limbs_lm.py (mont_redc, mont_mul, mont_sq,
// mont_mul_const, add_mod, sub_mod, neg_mod) with the constants of
// verifiable_mpc_tpu/ops/bn_pallas.py _consts (b3 = 9 R mod p; multiplying
// by it is 9 a, four additions here).  The TPU code keeps 16 x 16-bit
// limbs in a limb-major layout for Mosaic; here a value is 8 x 32-bit
// limbs in registers, multiplied by CIOS Montgomery multiplication with
// 32 x 32 -> 64-bit products (IMAD.WIDE on Hopper) carried through 64-bit
// sums.
//
// Domain: every value is canonical, below p, in and out of every function
// (this p is above 2^255, so a sum of two values can carry out of bit 256;
// add and the final step of mul handle that carry).  Results leave the
// device canonical, so nothing that reaches a hash depends on the
// representation.
//
// Every function is __host__ __device__: the same header builds with g++
// (tests compile it on the CPU) and with nvcc for sm_90a.

#pragma once

#include <stddef.h>
#include <stdint.h>

#ifndef FE_FN
#if defined(__CUDACC__)
#define FE_FN __host__ __device__ __forceinline__
#else
#define FE_FN static inline
#endif
#endif

struct fp {
  uint32_t v[8];
};

#define FP_P                                                                  \
  {0x5e089667u, 0x185cac6cu, 0x20b5b59eu, 0xee5b88d1u,                       \
   0x6184dc21u, 0xaa6fecb8u, 0x4aa387f9u, 0x8fb501e3u}
#define FP_N0 0x7f17daa9u  // -p^-1 mod 2^32

FE_FN void fp_zero(fp &r) {
  for (int i = 0; i < 8; i++) r.v[i] = 0;
}

// 1 in Montgomery form: R mod p
FE_FN void fp_one_mont(fp &r) {
  const uint32_t k[8] = {0xa1f76999u, 0xe7a35393u, 0xdf4a4a61u, 0x11a4772eu,
                         0x9e7b23deu, 0x55901347u, 0xb55c7806u, 0x704afe1cu};
  for (int i = 0; i < 8; i++) r.v[i] = k[i];
}

// R^2 mod p: a Montgomery product with it takes a value into Montgomery
// form
FE_FN void fp_r2(fp &r) {
  const uint32_t k[8] = {0x7e444f56u, 0x9c21c3ffu, 0xb2efb0c2u, 0x409ed151u,
                         0x80fb1651u, 0x0c6dc37bu, 0x2c2380b7u, 0x7c36e0e6u};
  for (int i = 0; i < 8; i++) r.v[i] = k[i];
}

FE_FN bool fp_is_zero(const fp &a) {
  uint32_t o = 0;
  for (int i = 0; i < 8; i++) o |= a.v[i];
  return o == 0;
}

FE_FN bool fp_equal(const fp &a, const fp &b) {
  uint32_t o = 0;
  for (int i = 0; i < 8; i++) o |= a.v[i] ^ b.v[i];
  return o == 0;
}

// four little-endian u64 limbs <-> eight u32 limbs
FE_FN void fp_load(fp &r, const uint64_t *s) {
  for (int i = 0; i < 4; i++) {
    uint64_t x = s[i];
    r.v[2 * i] = (uint32_t)x;
    r.v[2 * i + 1] = (uint32_t)(x >> 32);
  }
}

FE_FN void fp_store(uint64_t *d, const fp &a) {
  for (int i = 0; i < 4; i++)
    d[i] = (uint64_t)a.v[2 * i] | ((uint64_t)a.v[2 * i + 1] << 32);
}

// r = a - p if (carry, a) >= p, else a; (carry, a) < 2p
FE_FN void fp_cond_sub_p(fp &r, const fp &a, uint32_t carry) {
  const uint32_t p[8] = FP_P;
  fp t;
  uint64_t br = 0;
  for (int i = 0; i < 8; i++) {
    uint64_t x = (uint64_t)a.v[i] - p[i] - br;
    t.v[i] = (uint32_t)x;
    br = x >> 63;
  }
  // keep a only when it is below p and nothing carried out of bit 256
  r = (br && !carry) ? a : t;
}

FE_FN void fp_add(fp &r, const fp &a, const fp &b) {
  fp s;
  uint64_t c = 0;
  for (int i = 0; i < 8; i++) {
    uint64_t x = (uint64_t)a.v[i] + b.v[i] + c;
    s.v[i] = (uint32_t)x;
    c = x >> 32;
  }
  fp_cond_sub_p(r, s, (uint32_t)c);
}

FE_FN void fp_sub(fp &r, const fp &a, const fp &b) {
  const uint32_t p[8] = FP_P;
  fp d;
  uint64_t br = 0;
  for (int i = 0; i < 8; i++) {
    uint64_t x = (uint64_t)a.v[i] - b.v[i] - br;
    d.v[i] = (uint32_t)x;
    br = x >> 63;
  }
  if (br) {  // a < b: add p back (the carry out of bit 256 cancels)
    uint64_t c = 0;
    for (int i = 0; i < 8; i++) {
      uint64_t x = (uint64_t)d.v[i] + p[i] + c;
      d.v[i] = (uint32_t)x;
      c = x >> 32;
    }
  }
  r = d;
}

FE_FN void fp_neg(fp &r, const fp &a) {
  fp z;
  fp_zero(z);
  fp_sub(r, z, a);
}

// CIOS Montgomery product a * b * R^-1 mod p for a, b < p.  The running
// value t stays below 2p < 2^257: t[8] holds its top bit.
FE_FN void fp_mul(fp &r, const fp &a, const fp &b) {
  const uint32_t p[8] = FP_P;
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
    uint32_t m = t[0] * FP_N0;
    x = (uint64_t)m * p[0] + t[0];
    c = x >> 32;
    for (int j = 1; j < 8; j++) {
      x = (uint64_t)m * p[j] + t[j] + c;
      t[j - 1] = (uint32_t)x;
      c = x >> 32;
    }
    x = (uint64_t)t[8] + c;
    t[7] = (uint32_t)x;
    t[8] = t[9] + (uint32_t)(x >> 32);
  }
  fp s;
  for (int i = 0; i < 8; i++) s.v[i] = t[i];
  fp_cond_sub_p(r, s, t[8]);
}

// a square as a full product (a squaring of 36 limb products is left for
// later; chip_smoke.py's bounds charge a square at 36)
FE_FN void fp_sq(fp &r, const fp &a) { fp_mul(r, a, a); }

// times 3 b = 9 (mont_mul_const by 9 R mod p): 8 a + a, by additions
FE_FN void fp_mul_b3(fp &r, const fp &a) {
  fp t;
  fp_add(t, a, a);
  fp_add(t, t, t);
  fp_add(t, t, t);
  fp_add(r, t, a);
}

// Montgomery form -> standard form: a * 1 * R^-1
FE_FN void fp_from_mont(fp &r, const fp &a) {
  fp one;
  fp_zero(one);
  one.v[0] = 1;
  fp_mul(r, a, one);
}

// a^(p-2) in the Montgomery domain (the inverse of a Montgomery-form value,
// in Montgomery form; 0 maps to 0): left-to-right square-and-multiply over
// the 256 bits of p - 2, 255 squarings and 124 multiplies (field_bn254.inv
// runs the same chain)
FE_FN void fp_inv(fp &r, const fp &a) {
  const uint32_t e[8] = {0x5e089665u, 0x185cac6cu, 0x20b5b59eu, 0xee5b88d1u,
                         0x6184dc21u, 0xaa6fecb8u, 0x4aa387f9u, 0x8fb501e3u};
  fp acc = a;  // bit 255 of p - 2 is set
  for (int bit = 254; bit >= 0; bit--) {
    fp t;
    fp_sq(t, acc);
    if ((e[bit >> 5] >> (bit & 31)) & 1) {
      fp_mul(acc, t, a);
    } else {
      acc = t;
    }
  }
  r = acc;
}
