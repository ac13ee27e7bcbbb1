// Arithmetic mod p = 2^255 - 19 and the Ed25519 group law, for one thread.
//
// Counterpart of the 2^255-19 functions of verifiable_mpc_tpu/ops/limbs_lm.py
// (mul25519, sq25519, add25519, sub25519, neg25519, canon25519, inv25519)
// and of the Ed25519 adapter in verifiable_mpc_tpu/ops/msm_pallas.py
// (ed_add_lm, ed_dbl_lm, ed_to_pre, ed_add_pre_lm, neg_where_pre,
// pre_identity, normalize_pack).  The TPU code keeps 16 x 16-bit limbs in
// a limb-major layout for Mosaic's tiling; here a value is 8 x 32-bit limbs
// in registers, multiplied with 32 x 32 -> 64-bit products (IMAD.WIDE on
// Hopper) and carried through 64-bit sums.
//
// Domain: "relaxed" values < 2^256, congruent mod p.  2^256 == 38 (mod p),
// so every carry out of bit 256 folds back in as +38.  Only fe_canon gives
// the canonical residue < p; results are canonicalized before they leave
// the device, so nothing that reaches a hash depends on the representation.
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

struct fe {
  uint32_t v[8];
};

// extended twisted Edwards coordinates (X : Y : Z : T), a = -1
struct ge_ext {
  fe X, Y, Z, T;
};

// precomputed form (Y+X, Y-X, 2dT, 2Z): a mixed addition costs 8 muls
struct ge_pre {
  fe ypx, ymx, t2d, z2;
};

// affine precomputed form (y+x, y-x, 2dxy), Z = 1: a mixed addition costs 7
struct ge_aff {
  fe ypx, ymx, t2d;
};

FE_FN void fe_zero(fe &r) {
  for (int i = 0; i < 8; i++) r.v[i] = 0;
}

// r = c ? a : r, without a branch
FE_FN void fe_pick(fe &r, bool c, const fe &a) {
  for (int i = 0; i < 8; i++) r.v[i] = c ? a.v[i] : r.v[i];
}

FE_FN void fe_small(fe &r, uint32_t c) {
  fe_zero(r);
  r.v[0] = c;
}

// 2d mod p, d = -121665 / 121666
FE_FN void fe_two_d(fe &r) {
  const uint32_t k[8] = {0x26b2f159u, 0xebd69b94u, 0x8283b156u, 0x00e0149au,
                         0xeef3d130u, 0x198e80f2u, 0x56dffce7u, 0x2406d9dcu};
  for (int i = 0; i < 8; i++) r.v[i] = k[i];
}

// four little-endian u64 limbs <-> eight u32 limbs
FE_FN void fe_load(fe &r, const uint64_t *s) {
  for (int i = 0; i < 4; i++) {
    uint64_t x = s[i];
    r.v[2 * i] = (uint32_t)x;
    r.v[2 * i + 1] = (uint32_t)(x >> 32);
  }
}

FE_FN void fe_store(uint64_t *d, const fe &a) {
  for (int i = 0; i < 4; i++)
    d[i] = (uint64_t)a.v[2 * i] | ((uint64_t)a.v[2 * i + 1] << 32);
}

// r = r + 38 * c, c < 2^32 / 38: the fold of a carry out of bit 256.  A
// second carry can only occur when r wrapped to a value below 38 * c, so
// adding 38 again cannot carry.
FE_FN void fe_fold_carry(fe &r, uint64_t c) {
  uint64_t x = (uint64_t)r.v[0] + c * 38u;
  r.v[0] = (uint32_t)x;
  c = x >> 32;
  for (int i = 1; i < 8; i++) {
    x = (uint64_t)r.v[i] + c;
    r.v[i] = (uint32_t)x;
    c = x >> 32;
  }
  r.v[0] += (uint32_t)(c * 38u);
}

FE_FN void fe_add(fe &r, const fe &a, const fe &b) {
  uint64_t c = 0;
  for (int i = 0; i < 8; i++) {
    uint64_t x = (uint64_t)a.v[i] + b.v[i] + c;
    r.v[i] = (uint32_t)x;
    c = x >> 32;
  }
  fe_fold_carry(r, c);
}

// a - b: a borrow out of bit 256 means the stored value is a - b + 2^256
// == a - b + 38, so 38 is taken off (twice if that borrows again).
FE_FN void fe_sub(fe &r, const fe &a, const fe &b) {
  uint64_t br = 0;
  for (int i = 0; i < 8; i++) {
    uint64_t x = (uint64_t)a.v[i] - b.v[i] - br;
    r.v[i] = (uint32_t)x;
    br = x >> 63;
  }
  for (int round = 0; round < 2; round++) {
    uint64_t x = (uint64_t)r.v[0] - 38u * br;
    r.v[0] = (uint32_t)x;
    br = x >> 63;
    for (int i = 1; i < 8; i++) {
      x = (uint64_t)r.v[i] - br;
      r.v[i] = (uint32_t)x;
      br = x >> 63;
    }
  }
}

FE_FN void fe_neg(fe &r, const fe &a) {
  fe z;
  fe_zero(z);
  fe_sub(r, z, a);
}

// 512-bit product t[16] -> relaxed residue: lo + 38 * hi, then the carry
FE_FN void fe_reduce512(fe &r, const uint32_t *t) {
  uint64_t c = 0;
  for (int i = 0; i < 8; i++) {
    uint64_t x = (uint64_t)t[i + 8] * 38u + t[i] + c;
    r.v[i] = (uint32_t)x;
    c = x >> 32;
  }
  fe_fold_carry(r, c);
}

FE_FN void fe_mul(fe &r, const fe &a, const fe &b) {
  uint32_t t[16];
  for (int i = 0; i < 16; i++) t[i] = 0;
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
    for (int j = 0; j < 8; j++) {
      uint64_t x = (uint64_t)a.v[i] * b.v[j] + t[i + j] + c;
      t[i + j] = (uint32_t)x;
      c = x >> 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  fe_reduce512(r, t);
}

FE_FN void fe_sq(fe &r, const fe &a) { fe_mul(r, a, a); }

FE_FN void fe_sqn(fe &r, const fe &a, int n) {
  r = a;
  for (int i = 0; i < n; i++) fe_sq(r, r);
}

// relaxed (< 2^256 = 2p + 38) -> canonical (< p): two conditional
// subtractions of p
FE_FN void fe_canon(fe &r, const fe &a) {
  const uint32_t p[8] = {0xffffffedu, 0xffffffffu, 0xffffffffu, 0xffffffffu,
                         0xffffffffu, 0xffffffffu, 0xffffffffu, 0x7fffffffu};
  r = a;
  for (int k = 0; k < 2; k++) {
    fe t;
    uint64_t br = 0;
    for (int i = 0; i < 8; i++) {
      uint64_t x = (uint64_t)r.v[i] - p[i] - br;
      t.v[i] = (uint32_t)x;
      br = x >> 63;
    }
    if (!br) r = t;
  }
}

// z^(p-2): the curve25519 Fermat chain (254 squarings + 11 multiplies)
FE_FN void fe_inv(fe &r, const fe &z) {
  fe z2, z9, z11, a, b, t, z2_5_0, z2_10_0, z2_20_0, z2_50_0, z2_100_0;
  fe_sq(z2, z);
  fe_sqn(t, z2, 2);
  fe_mul(z9, t, z);
  fe_mul(z11, z9, z2);
  fe_sq(t, z11);
  fe_mul(z2_5_0, t, z9);
  fe_sqn(t, z2_5_0, 5);
  fe_mul(z2_10_0, t, z2_5_0);
  fe_sqn(t, z2_10_0, 10);
  fe_mul(z2_20_0, t, z2_10_0);
  fe_sqn(t, z2_20_0, 20);
  fe_mul(a, t, z2_20_0);
  fe_sqn(t, a, 10);
  fe_mul(z2_50_0, t, z2_10_0);
  fe_sqn(t, z2_50_0, 50);
  fe_mul(z2_100_0, t, z2_50_0);
  fe_sqn(t, z2_100_0, 100);
  fe_mul(b, t, z2_100_0);
  fe_sqn(t, b, 50);
  fe_mul(a, t, z2_50_0);
  fe_sqn(t, a, 5);
  fe_mul(r, t, z11);
}

// 1/z by the binary extended Euclid algorithm (variable time: for one
// lane's lone inversion, K2's, whose Fermat chain is 265 dependent
// products; about 510 halvings and 255 subtractions of 8-limb values,
// no product).  Invariants x1 z == u and x2 z == v (mod p), x1, x2 < p;
// z == 0 (mod p) gives 0, as the Fermat chain does.
FE_FN void fe_inv_var(fe &r, const fe &z) {
  const uint32_t p[8] = {0xffffffedu, 0xffffffffu, 0xffffffffu, 0xffffffffu,
                         0xffffffffu, 0xffffffffu, 0xffffffffu, 0x7fffffffu};
  fe u, v, x1, x2;
  fe_canon(u, z);
  uint32_t any = 0;
  for (int i = 0; i < 8; i++) any |= u.v[i];
  if (!any) {
    fe_zero(r);
    return;
  }
  for (int i = 0; i < 8; i++) v.v[i] = p[i];
  fe_small(x1, 1);
  fe_zero(x2);
  // a /= 2 with x = x / 2 mod p (x + p when x is odd; x + p < 2^256)
  auto halve = [&](fe &a, fe &x) {
    for (int i = 0; i < 7; i++) a.v[i] = (a.v[i] >> 1) | (a.v[i + 1] << 31);
    a.v[7] >>= 1;
    uint32_t odd = x.v[0] & 1;
    uint64_t c = 0;
    for (int i = 0; i < 8; i++) {
      c += (uint64_t)x.v[i] + (odd ? p[i] : 0);
      x.v[i] = (uint32_t)c;
      c >>= 32;
    }
    for (int i = 0; i < 7; i++) x.v[i] = (x.v[i] >> 1) | (x.v[i + 1] << 31);
    x.v[7] >>= 1;
  };
  // a -= b (a >= b) with x = x - y mod p
  auto sub = [&](fe &a, const fe &b, fe &x, const fe &y) {
    uint64_t br = 0;
    for (int i = 0; i < 8; i++) {
      uint64_t d = (uint64_t)a.v[i] - b.v[i] - br;
      a.v[i] = (uint32_t)d;
      br = d >> 63;
    }
    br = 0;
    for (int i = 0; i < 8; i++) {
      uint64_t d = (uint64_t)x.v[i] - y.v[i] - br;
      x.v[i] = (uint32_t)d;
      br = d >> 63;
    }
    uint64_t c = 0;
    for (int i = 0; i < 8; i++) {
      c += (uint64_t)x.v[i] + (br ? p[i] : 0);
      x.v[i] = (uint32_t)c;
      c >>= 32;
    }
  };
  auto is_one = [](const fe &a) {
    uint32_t rest = a.v[0] ^ 1;
    for (int i = 1; i < 8; i++) rest |= a.v[i];
    return rest == 0;
  };
  while (!is_one(u) && !is_one(v)) {
    while (!(u.v[0] & 1)) halve(u, x1);
    while (!(v.v[0] & 1)) halve(v, x2);
    bool ge = true;
    for (int i = 7; i >= 0; i--) {
      if (u.v[i] != v.v[i]) {
        ge = u.v[i] > v.v[i];
        break;
      }
    }
    if (ge) {
      sub(u, v, x1, x2);
    } else {
      sub(v, u, x2, x1);
    }
  }
  r = is_one(u) ? x1 : x2;
}

// ---------------------------------------------------------------------------
// group law
// ---------------------------------------------------------------------------

FE_FN void ge_identity(ge_ext &p) {
  fe_zero(p.X);
  fe_small(p.Y, 1);
  fe_small(p.Z, 1);
  fe_zero(p.T);
}

FE_FN void ge_pre_identity(ge_pre &q) {
  fe_small(q.ypx, 1);
  fe_small(q.ymx, 1);
  fe_zero(q.t2d);
  fe_small(q.z2, 2);
}

// row of 16 u64: x, y, z, t (four limbs each)
FE_FN void ge_load(ge_ext &p, const uint64_t *row) {
  fe_load(p.X, row);
  fe_load(p.Y, row + 4);
  fe_load(p.Z, row + 8);
  fe_load(p.T, row + 12);
}

// same row layout, holding (Y+X, Y-X, 2dT, 2Z)
FE_FN void ge_pre_load(ge_pre &q, const uint64_t *row) {
  fe_load(q.ypx, row);
  fe_load(q.ymx, row + 4);
  fe_load(q.t2d, row + 8);
  fe_load(q.z2, row + 12);
}

FE_FN void ge_store(uint64_t *row, const ge_ext &p) {
  fe_store(row, p.X);
  fe_store(row + 4, p.Y);
  fe_store(row + 8, p.Z);
  fe_store(row + 12, p.T);
}

// add-2008-hwcd-3, complete (ed_add_lm)
FE_FN void ge_add(ge_ext &r, const ge_ext &p, const ge_ext &q) {
  fe a, b, c, d, e, f, g, h, t0, t1, k;
  fe_sub(t0, p.Y, p.X);
  fe_sub(t1, q.Y, q.X);
  fe_mul(a, t0, t1);
  fe_add(t0, p.Y, p.X);
  fe_add(t1, q.Y, q.X);
  fe_mul(b, t0, t1);
  fe_two_d(k);
  fe_mul(t0, p.T, k);
  fe_mul(c, t0, q.T);
  fe_add(t0, p.Z, p.Z);
  fe_mul(d, t0, q.Z);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// dbl-2008-hwcd with a = -1 (ed_dbl_lm), X, Y and Z only (7 products),
// with e and h, whose product is T; T of the input is not read, and r may
// be p
FE_FN void ge_dbl_eh(ge_ext &r, const ge_ext &p, fe &e, fe &h) {
  fe a, b, c, f, g, t;
  fe_sq(a, p.X);
  fe_sq(b, p.Y);
  fe_sq(t, p.Z);
  fe_add(c, t, t);
  fe_add(t, p.X, p.Y);
  fe_sq(e, t);
  fe_sub(e, e, a);
  fe_sub(e, e, b);
  fe_sub(g, b, a);
  fe_sub(f, g, c);
  fe_add(t, a, b);
  fe_neg(h, t);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
}

// the full doubling (8 products)
FE_FN void ge_dbl(ge_ext &r, const ge_ext &p) {
  fe e, h;
  ge_dbl_eh(r, p, e, h);
  fe_mul(r.T, e, h);
}

// a doubling whose T nothing reads (only the add after a doubling reads
// T): 7 products, r.T left as it was (the ref10 pattern)
FE_FN void ge_dbl_no_t(ge_ext &r, const ge_ext &p) {
  fe e, h;
  ge_dbl_eh(r, p, e, h);
}

// extended -> precomputed form (ed_to_pre)
FE_FN void ge_to_pre(ge_pre &q, const ge_ext &p) {
  fe k;
  fe_add(q.ypx, p.Y, p.X);
  fe_sub(q.ymx, p.Y, p.X);
  fe_two_d(k);
  fe_mul(q.t2d, p.T, k);
  fe_add(q.z2, p.Z, p.Z);
}

// mixed addition extended + precomputed (ed_add_pre_lm)
FE_FN void ge_add_pre(ge_ext &r, const ge_ext &p, const ge_pre &q) {
  fe a, b, c, d, e, f, g, h, t;
  fe_sub(t, p.Y, p.X);
  fe_mul(a, t, q.ymx);
  fe_add(t, p.Y, p.X);
  fe_mul(b, t, q.ypx);
  fe_mul(c, p.T, q.t2d);
  fe_mul(d, p.Z, q.z2);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// p + q for neg false, p - q for neg true, with q's operands picked rather
// than a negated copy of q made: -(Y+X, Y-X, 2dT, 2Z) = (Y-X, Y+X, -2dT, 2Z),
// so Y+X and Y-X trade places and the sign of 2dT T swaps f and g.  q may
// lie in local memory: it is read where it is used.
FE_FN void ge_add_pre_signed(ge_ext &r, const ge_ext &p, const ge_pre &q,
                             bool neg) {
  fe a, b, c, d, e, f, g, h, t;
  fe_sub(t, p.Y, p.X);
  fe_mul(a, t, neg ? q.ypx : q.ymx);
  fe_add(t, p.Y, p.X);
  fe_mul(b, t, neg ? q.ymx : q.ypx);
  fe_mul(c, p.T, q.t2d);
  fe_mul(d, p.Z, q.z2);
  fe_sub(e, b, a);
  if (neg) {
    fe_add(f, d, c);
    fe_sub(g, d, c);
  } else {
    fe_sub(f, d, c);
    fe_add(g, d, c);
  }
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// row of 12 u64: y+x, y-x, 2dxy
FE_FN void ge_aff_load(ge_aff &q, const uint64_t *row) {
  fe_load(q.ypx, row);
  fe_load(q.ymx, row + 4);
  fe_load(q.t2d, row + 8);
}

// p + q for neg false, p - q for neg true, q affine in precomputed form:
// ge_add_pre_signed with 2Z2 = 2, so D = 2 Z1 is an addition (7
// products).  r may be p.
FE_FN void ge_add_aff_signed(ge_ext &r, const ge_ext &p, const ge_aff &q,
                             bool neg) {
  fe a, b, c, d, e, f, g, h, t;
  fe_sub(t, p.Y, p.X);
  fe_mul(a, t, neg ? q.ypx : q.ymx);
  fe_add(t, p.Y, p.X);
  fe_mul(b, t, neg ? q.ymx : q.ypx);
  fe_mul(c, p.T, q.t2d);
  fe_add(d, p.Z, p.Z);
  fe_sub(e, b, a);
  if (neg) {
    fe_add(f, d, c);
    fe_sub(g, d, c);
  } else {
    fe_sub(f, d, c);
    fe_add(g, d, c);
  }
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// -(Y+X, Y-X, 2dT, 2Z) = (Y-X, Y+X, -2dT, 2Z)  (neg_where_pre)
FE_FN void ge_pre_neg(ge_pre &q) {
  fe t = q.ypx;
  q.ypx = q.ymx;
  q.ymx = t;
  fe_neg(q.t2d, q.t2d);
}

// 1/d mod p
FE_FN void fe_inv_d(fe &r) {
  const uint32_t k[8] = {0xcdc9f843u, 0x25e0f276u, 0x4279542eu, 0x0b5dd698u,
                         0xcdb9cf66u, 0x2b162114u, 0x14d5ce43u, 0x40907ed2u};
  for (int i = 0; i < 8; i++) r.v[i] = k[i];
}

// precomputed form -> extended: (Y+X, Y-X, 2dT, 2Z) gives (2X : 2Y : 2Z :
// 2T), the same point, with 2T = 2dT / d (one product)
FE_FN void ge_pre_to_ext(ge_ext &r, const ge_pre &q) {
  fe inv_d;
  fe_inv_d(inv_d);
  fe_sub(r.X, q.ypx, q.ymx);
  fe_add(r.Y, q.ypx, q.ymx);
  r.Z = q.z2;
  fe_mul(r.T, q.t2d, inv_d);
}

// +-q affine in precomputed form -> extended (2x : 2y : 2 : 2xy) (one
// product); -(y+x, y-x, 2dxy) = (y-x, y+x, -2dxy)
FE_FN void ge_aff_to_ext(ge_ext &r, const ge_aff &q, bool neg) {
  fe inv_d, t;
  fe_inv_d(inv_d);
  fe_sub(r.X, neg ? q.ymx : q.ypx, neg ? q.ypx : q.ymx);
  fe_add(r.Y, q.ypx, q.ymx);
  fe_small(r.Z, 2);
  fe_mul(t, q.t2d, inv_d);
  if (neg) {
    fe_neg(r.T, t);
  } else {
    r.T = t;
  }
}

// canonical affine row (x, y, 1, x*y) of (X : Y : Z) given zinv = 1/Z
FE_FN void ge_store_affine(uint64_t *row, const fe &X, const fe &Y,
                           const fe &zinv) {
  fe x, y, t, one;
  fe_mul(t, X, zinv);
  fe_canon(x, t);
  fe_mul(t, Y, zinv);
  fe_canon(y, t);
  fe_mul(one, x, y);
  fe_canon(t, one);
  fe_small(one, 1);
  fe_store(row, x);
  fe_store(row + 4, y);
  fe_store(row + 8, one);
  fe_store(row + 12, t);
}

// canonical affine row (x, y, 1, x*y) of p (normalize_pack)
FE_FN void ge_store_normalized(uint64_t *row, const ge_ext &p) {
  fe zinv;
  fe_inv(zinv, p.Z);
  ge_store_affine(row, p.X, p.Y, zinv);
}
