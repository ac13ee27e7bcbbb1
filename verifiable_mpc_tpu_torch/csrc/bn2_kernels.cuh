// BN256 twist (G2) group law and the per-thread bodies of the twist kernels
// K9-K12 (bn2_msm_accum.cu, bn2_msm_tail.cu, bn2_bexp.cu and bn2_fold.cu
// launch them).  __host__ __device__, so the same code also builds with
// g++ and is checked on the CPU against the plain PyTorch versions in
// ops/msm_bn2_cuda.py.
//
// Group law: the complete projective formulas for a = 0 of Renes, Costello
// and Batina (2015), Algorithm 7 (add) and Algorithm 9 (double), step for
// step as verifiable_mpc_tpu/ops/bn2_pallas.py bn2_add_lm / bn2_dbl_lm over
// fp2_254.cuh: no branch and no exceptional case (identity operands and
// P + P included), and Algorithm 8 (the mixed add of an affine point that
// is not the identity, for K9 and K11).  The complete add is 42 base-field
// products (12 GF(p^2) products and 2 by the GF(p^2) constant 3 b', 3
// each), against 12 on G1; the mixed add 39; a doubling 25.
//
// Registers: a projective twist point is 48 32-bit words.  The add and
// the doubling order their steps so that an operand dies as soon as its
// last product is taken (about ten GF(p^2) values live at the add's peak),
// and the kernels keep the fewest points live: K9 reads each point's
// multiples, affine (32 words), from a table that its first launches
// write, instead of building them in registers as K5 does.
//
// Data formats (all little-endian):
//   input row    24 x u64: X.c0, X.c1, Y.c0, Y.c1, Z.c0, Z.c1, four u64
//                limbs each, jacobian, each part canonical in standard
//                form: the rows of native._bn2_pts_to_u64
//                (ops/curve_bn2.py)
//   working row  24 x u64: the same parts, projective, Montgomery form
//   K9 entry     16 x u64: x.c0, x.c1, y.c0, y.c1 of an affine point in
//                Montgomery form; (0, 0) for the identity
//   result row   24 x u64: the normalized point in standard form, (x, y, 1),
//                or (1, 1, 0) for the identity (BNTwistPoint.identity); an
//                input row too
//   packed digits u8 [nw/2][n] (digits.cuh)

#pragma once

#include "coop.cuh"
#include "digits.cuh"
#include "fp2_254.cuh"

#define BN2_ROW 24
#define BN2_ENTRY 16  // an affine entry of K9's table: x R, y R

struct g2p {
  fp2 X, Y, Z;
};

FE_FN void g2_identity(g2p &p) {
  fp2_zero(p.X);
  fp2_one_mont(p.Y);
  fp2_zero(p.Z);
}

FE_FN void g2_load(g2p &p, const uint64_t *row) {
  fp2_load(p.X, row);
  fp2_load(p.Y, row + 8);
  fp2_load(p.Z, row + 16);
}

FE_FN void g2_store(uint64_t *row, const g2p &p) {
  fp2_store(row, p.X);
  fp2_store(row + 8, p.Y);
  fp2_store(row + 16, p.Z);
}

// an input row (X, Y, Z), jacobian, standard form -> the working point
// (X Z, Y, Z^3) R, projective, Montgomery form; the identity (Z = 0) ->
// (0 : R : 0).  14 base-field products.
FE_FN void g2_load_jacobian(g2p &p, const uint64_t *row) {
  fp r2;
  fp2 x, z, zz;
  fp_r2(r2);
  fp2_load(z, row + 16);
  fp_mul(z.c0, z.c0, r2);  // Z R
  fp_mul(z.c1, z.c1, r2);
  fp2_load(x, row);
  fp_mul(x.c0, x.c0, r2);  // X R
  fp_mul(x.c1, x.c1, r2);
  fp2_mul(p.X, x, z);  // X Z R
  fp2_load(p.Y, row + 8);
  fp_mul(p.Y.c0, p.Y.c0, r2);  // Y R
  fp_mul(p.Y.c1, p.Y.c1, r2);
  fp2_sq(zz, z);         // Z^2 R
  fp2_mul(p.Z, zz, z);   // Z^3 R
  if (fp2_is_zero(p.Z)) fp2_one_mont(p.Y);
}

// RCB15 Algorithm 7, a = 0 (bn2_add_lm).  r may alias p or q: they are
// last read before r is written.
FE_FN void g2_add(g2p &r, const g2p &p, const g2p &q) {
  fp2 t0, t1, t2, t3, t4, u, v;
  fp2_add(u, p.X, p.Y);
  fp2_add(v, q.X, q.Y);
  fp2_mul(t3, u, v);
  fp2_mul(t0, p.X, q.X);
  fp2_mul(t1, p.Y, q.Y);
  fp2_add(u, t0, t1);
  fp2_sub(t3, t3, u);  // x1 y2 + x2 y1
  fp2_add(u, p.Y, p.Z);
  fp2_add(v, q.Y, q.Z);
  fp2_mul(t4, u, v);
  fp2_mul(t2, p.Z, q.Z);
  fp2_add(u, t1, t2);
  fp2_sub(t4, t4, u);  // y1 z2 + y2 z1
  fp2_add(u, p.X, p.Z);
  fp2_add(v, q.X, q.Z);
  fp2_mul(u, u, v);
  fp2_add(v, t0, t2);
  fp2_sub(u, u, v);  // x1 z2 + x2 z1
  fp2_add(v, t0, t0);
  fp2_add(t0, v, t0);  // 3 x1 x2
  fp2_mul_b3(t2, t2);  // 3b' z1 z2
  fp2_add(v, t1, t2);  // z3
  fp2_sub(t1, t1, t2);
  fp2_mul_b3(u, u);  // y3 = 3b' (x1 z2 + x2 z1)
  fp2 a, b;
  fp2_mul(a, t3, t1);
  fp2_mul(b, t4, u);
  fp2_sub(r.X, a, b);
  fp2_mul(a, u, t0);
  fp2_mul(b, t1, v);
  fp2_add(r.Y, a, b);
  fp2_mul(a, v, t4);
  fp2_mul(b, t0, t3);
  fp2_add(r.Z, a, b);
}

// RCB15 Algorithm 8, a = 0: r = p + (qx, qy) for an affine q (Z = 1, not
// the identity), 11 GF(p^2) products and 2 by 3b' (39 base-field
// products, against the full add's 42).  r may alias p.
FE_FN void g2_madd(g2p &r, const g2p &p, const fp2 &qx, const fp2 &qy) {
  fp2 t0, t1, t2, t3, t4, u;
  fp2_mul(t0, p.X, qx);
  fp2_mul(t1, p.Y, qy);
  fp2_add(t3, qx, qy);
  fp2_add(t4, p.X, p.Y);
  fp2_mul(t3, t3, t4);
  fp2_add(t4, t0, t1);
  fp2_sub(t3, t3, t4);  // x1 y2 + x2 y1
  fp2_mul(t4, qy, p.Z);
  fp2_add(t4, t4, p.Y);  // y1 + y2 z1
  fp2_mul(u, qx, p.Z);
  fp2_add(u, u, p.X);  // x1 + x2 z1
  fp2_add(t2, t0, t0);
  fp2_add(t0, t2, t0);  // 3 x1 x2
  fp2_mul_b3(t2, p.Z);  // 3b' z1
  fp2 z3;
  fp2_add(z3, t1, t2);
  fp2_sub(t1, t1, t2);
  fp2_mul_b3(u, u);  // y3 = 3b' (x1 + x2 z1)
  fp2 a, b;
  fp2_mul(a, t4, u);
  fp2_mul(b, t3, t1);
  fp2_sub(r.X, b, a);
  fp2_mul(a, u, t0);
  fp2_mul(b, t1, z3);
  fp2_add(r.Y, b, a);
  fp2_mul(a, t0, t3);
  fp2_mul(b, z3, t4);
  fp2_add(r.Z, b, a);
}

// RCB15 Algorithm 9, a = 0 (bn2_dbl_lm).  r may alias p.
FE_FN void g2_dbl(g2p &r, const g2p &p) {
  fp2 t0, t1, t2, xy, x3, y3, z3;
  fp2_mul(xy, p.X, p.Y);
  fp2_sq(t0, p.Y);
  fp2_mul(t1, p.Y, p.Z);
  fp2_sq(t2, p.Z);
  fp2_mul_b3(t2, t2);  // 3b' z^2
  fp2_add(z3, t0, t0);
  fp2_add(z3, z3, z3);
  fp2_add(z3, z3, z3);  // 8 y^2
  fp2_mul(x3, t2, z3);
  fp2_mul(z3, t1, z3);
  fp2_add(y3, t0, t2);
  fp2_add(t1, t2, t2);
  fp2_add(t2, t1, t2);
  fp2_sub(t0, t0, t2);  // y^2 - 3 (3b' z^2)
  fp2_mul(y3, t0, y3);
  fp2_add(r.Y, x3, y3);
  fp2_mul(x3, t0, xy);
  fp2_add(r.X, x3, x3);
  r.Z = z3;
}

// -(X, Y, Z) = (X, -Y, Z)
FE_FN void g2_neg(g2p &p) { fp2_neg(p.Y, p.Y); }

// the identity's result row: (1, 1, 0) in standard form
FE_FN void g2_store_identity_row(uint64_t *row) {
  fp2 one, zero;
  fp2_zero(zero);
  fp2_zero(one);
  one.c0.v[0] = 1;
  fp2_store(row, one);
  fp2_store(row + 8, one);
  fp2_store(row + 16, zero);
}

// the result row (x, y, 1), standard form, of the working point (X : Y : Z)
// given zi = Z^-1 in standard form: x = X zi R^-1 with X in Montgomery form
FE_FN void g2_store_affine_row(uint64_t *row, const fp2 &X, const fp2 &Y,
                               const fp2 &zi) {
  fp2 x, y, one;
  fp2_mul(x, X, zi);
  fp2_mul(y, Y, zi);
  fp2_zero(one);
  one.c0.v[0] = 1;
  fp2_store(row, x);
  fp2_store(row + 8, y);
  fp2_store(row + 16, one);
}

// the normalized standard-form row of p: (x, y, 1), or (1, 1, 0) for the
// identity (whose Z is 0: it takes no part in the inversion)
FE_FN void g2_store_normalized(uint64_t *row, const g2p &p) {
  if (fp2_is_zero(p.Z)) {
    g2_store_identity_row(row);
    return;
  }
  fp2 zi;
  fp2_inv(zi, p.Z);       // Z^-1 R
  fp2_from_mont(zi, zi);  // Z^-1
  g2_store_affine_row(row, p.X, p.Y, zi);
}

// Montgomery's trick over one thread's group of result rows: rows i = g,
// g + G, g + 2G, ... < n of out hold working rows (projective, Montgomery
// form) and leave as their normalized result rows, with one GF(p^2)
// inversion for the group; pre [n][8] is scratch for the running products
// of the Z's.  An identity (Z = 0) enters the product as 1 and leaves as
// exactly (1, 1, 0); a group of identities inverts 1.  Per row 3 GF(p^2)
// products, Z^-1 out of Montgomery form, x and y: 17 base-field products.
FE_FN void bn2_normalize_group(uint64_t *out, uint64_t *pre, int n, int g,
                               int G) {
  fp2 c, z;
  fp2_one_mont(c);
  int last = -1;
  for (int i = g; i < n; i += G) {
    fp2_load(z, out + (size_t)i * BN2_ROW + 16);
    if (!fp2_is_zero(z)) fp2_mul(c, c, z);
    fp2_store(pre + (size_t)i * 8, c);  // Z_g ... Z_i
    last = i;
  }
  fp2 inv;
  fp2_inv(inv, c);  // (Z_g ... Z_last)^-1 R
  for (int i = last; i >= g; i -= G) {
    uint64_t *row = out + (size_t)i * BN2_ROW;
    fp2_load(z, row + 16);
    if (fp2_is_zero(z)) {
      g2_store_identity_row(row);
      continue;
    }
    fp2 zi, X, Y;
    if (i - G >= g) {
      fp2_load(c, pre + (size_t)(i - G) * 8);
      fp2_mul(zi, inv, c);  // Z_i^-1 R
    } else {
      zi = inv;
    }
    fp2_mul(inv, inv, z);  // (Z_g ... Z_{i-G})^-1 R
    fp2_from_mont(zi, zi);
    fp2_load(X, row);
    fp2_load(Y, row + 8);
    g2_store_affine_row(row, X, Y, zi);
  }
}

// input row -> working row
FE_FN void bn2_encode_one(const uint64_t *in_row, uint64_t *out_row) {
  g2p p;
  g2_load_jacobian(p, in_row);
  g2_store(out_row, p);
}

// K11's first launch, for one table row: input row -> the working row of
// its affine form (x R : y R : R), or (0 : R : 0) for the identity.  The
// C++ tier's comb tables are affine already (no inversion); a row with
// another Z costs one GF(p^2) inversion.
FE_FN void bn2_encode_affine_one(const uint64_t *in_row, uint64_t *out_row) {
  g2p p;
  fp2 one;
  g2_load_jacobian(p, in_row);
  fp2_one_mont(one);
  if (!fp2_is_zero(p.Z) && !fp2_equal(p.Z, one)) {
    fp2 zi;
    fp2_inv(zi, p.Z);
    fp2_mul(p.X, p.X, zi);
    fp2_mul(p.Y, p.Y, zi);
    p.Z = one;
  }
  g2_store(out_row, p);
}

// An entry of K9's table before its normalization: X and Y in the entry
// (tbl_e [16]), Z in the first half of its scratch (pre_e [16])
FE_FN void bn2_entry_store(uint64_t *tbl_e, uint64_t *pre_e, const g2p &p) {
  fp2_store(tbl_e, p.X);
  fp2_store(tbl_e + 8, p.Y);
  fp2_store(pre_e, p.Z);
}

// K9's first launch, for one point: its input row -> its multiples 1..8,
// projective (tbl [8][16] and pre [8][16] of the point, entry m - 1
// holding m P; bn2_entry_store): the encoding and 7 adds, once per point,
// shared by all its windows.  (4 doublings and 3 adds take 226 products
// where 7 adds take 294, but ran slower on the H100: PERF.md §6.)
FE_FN void bn2_table_one(const uint64_t *in_row, uint64_t *tbl,
                         uint64_t *pre) {
  g2p p, cur;
  g2_load_jacobian(p, in_row);
  bn2_entry_store(tbl, pre, p);
  cur = p;
  for (int m = 2; m <= 8; m++) {
    g2_add(cur, cur, p);
    bn2_entry_store(tbl + (m - 1) * BN2_ENTRY, pre + (m - 1) * BN2_ENTRY,
                    cur);
  }
}

// K9's second launch, for thread g of G: the entries of the points i = g,
// g + G, g + 2G, ... < rows (bn2_table_one's) -> affine, (x R, y R) in
// Montgomery form, with one GF(p^2) inversion for the group (Montgomery's
// trick over the group's 8 entries a point; the pattern of
// bn2_normalize_group, kept in Montgomery form).  The second half of each
// entry's scratch takes the running product of the group's Z's up to it.
// An identity entry (Z = 0) enters the product as 1 and leaves as (0, 0),
// which is no point of the twist (its order is odd, so no point has
// y = 0): the accumulation skips it.  Per entry 15 base-field products:
// the running product, Z^-1, the inverse's update, x and y.
FE_FN void bn2_table_norm_group(uint64_t *tbl, uint64_t *pre, long long rows,
                                long long g, long long G) {
  fp2 c, z;
  fp2_one_mont(c);
  long long last = -1;
  for (long long i = g; i < rows; i += G) {
    for (int m = 0; m < 8; m++) {
      uint64_t *pe = pre + (i * 8 + m) * BN2_ENTRY;
      fp2_load(z, pe);
      if (!fp2_is_zero(z)) fp2_mul(c, c, z);
      fp2_store(pe + 8, c);  // the group's Z's up to this entry
    }
    last = i;
  }
  fp2 inv;
  fp2_inv(inv, c);  // (the group's Z's)^-1 R
  for (long long i = last; i >= g; i -= G) {
    for (int m = 7; m >= 0; m--) {
      uint64_t *e = tbl + (i * 8 + m) * BN2_ENTRY;
      const uint64_t *pe = pre + (i * 8 + m) * BN2_ENTRY;
      fp2 zi, x, y;
      fp2_load(z, pe);
      if (fp2_is_zero(z)) {
        fp2_zero(x);
        fp2_store(e, x);
        fp2_store(e + 8, x);
        continue;
      }
      // the running product before this entry, if any
      const uint64_t *before =
          m ? pe - BN2_ENTRY
            : i - G >= g ? pre + ((i - G) * 8 + 7) * BN2_ENTRY : nullptr;
      if (before) {
        fp2_load(zi, before + 8);
        fp2_mul(zi, inv, zi);  // Z^-1 R
      } else {
        zi = inv;
      }
      fp2_mul(inv, inv, z);
      fp2_load(x, e);
      fp2_load(y, e + 8);
      fp2_mul(x, x, zi);  // x R
      fp2_mul(y, y, zi);
      fp2_store(e, x);
      fp2_store(e + 8, y);
    }
  }
}

// K9 body (B1's BN2 instance, msm_pallas._make_chunk_kernel with the BN2
// adapter): the window-w accumulator of slice s.  The slice holds points
// i = s, s + S, s + 2S, ... (neighbouring threads read neighbouring
// points); tbl [n][8][16] holds each point's multiples 1..8, affine
// (bn2_table_one, bn2_table_norm_group).  For each nonzero digit d the
// entry |d| P is read, its y negated for d < 0, and added by the mixed add;
// a zero digit and an identity entry (y = 0) are skipped.
FE_FN void bn2_msm_accum_one(const uint64_t *tbl, const uint8_t *digits,
                             uint64_t *acc_row, int n, int w, int s, int S) {
  g2p acc;
  g2_identity(acc);
  for (int i = s; i < n; i += S) {
    int d = digit_at(digits, n, w, i);
    if (d == 0) continue;
    const uint64_t *e =
        tbl + ((size_t)i * 8 + (d < 0 ? -d : d) - 1) * BN2_ENTRY;
    fp2 qx, qy;
    fp2_load(qy, e + 8);
    if (fp2_is_zero(qy)) continue;
    fp2_load(qx, e);
    if (d < 0) fp2_neg(qy, qy);
    g2_madd(acc, acc, qx, qy);
  }
  g2_store(acc_row, acc);
}

// ---------------------------------------------------------------------------
// K10 (B2's BN2 instance): the window sums' combination spread over lanes
// ---------------------------------------------------------------------------
//
// K6's design (bn254_kernels.cuh, over coop.cuh's lane groups) over
// GF(p^2) slots.  The constant 3b' is a full GF(p^2) element here, so a
// group operation has three levels of independent base-field products: an
// add (RCB15 Algorithm 7) 18 (its first 6 GF(p^2) products, Karatsuba's
// three parts each), then 6 (3b' times Z1 Z2 and times X1 Z2 + X2 Z1),
// then 18; a doubling (Algorithm 9) 10 (X Y, Y^2, Y Z, Z^2; a square takes
// two), then 3 (3b' Z^2), then 12.  Lane l takes the products k = l,
// l + L, ... of a level (every lane the same fp_mul on the parts it picks
// by k); after the second level a linear step writes the third level's six
// GF(p^2) operands, lane l the operands l, l + L, ...; a last step writes
// the result.  So an operation is five steps of (slots, lane, L), each
// ended by the group's barrier, and no step reads a slot that it writes.

// one lane group's shared slots: v the point (X, Y, Z), an add's other
// operand and 0 (v[6]); p a level's base-field products (the first and the
// third level's); q the products by 3b'; u the third level's operands
struct g2_coop {
  static constexpr int COORDS = 3;
  fp2 v[7];
  fp p[18];
  fp q[6];
  fp2 u[6];
};

// doubling, level 1: X Y (products 0-2), Y^2 (3, 4), Y Z (5-7), Z^2 (8,
// 9); product k takes part nib64(.., k) of slot nib64(.., k) of each
// operand: X Y and Y Z parts 0, 1, 2 of both, a square (a0 + a1)(a0 - a1)
// and a0 a1
FE_FN void coop2_dbl_lv1(g2_coop &s, int lane, int L) {
  for (int k = lane; k < 10; k += L) {
    fp a, b, r;
    fp2_part(a, s.v[nib64(0x2211111000ull, k)], nib64(0x0221002210ull, k));
    fp2_part(b, s.v[nib64(0x2222211111ull, k)], nib64(0x1321013210ull, k));
    fp_mul(r, a, b);
    s.p[k] = r;
  }
}

// doubling, level 2: 3b' Z^2, Z^2 = (p8, 2 p9)
FE_FN void coop2_dbl_lv2(g2_coop &s, int lane, int L) {
  for (int k = lane; k < 3; k += L) {
    fp2 zz;
    fp a, b, r;
    zz.c0 = s.p[8];
    fp_add(zz.c1, s.p[9], s.p[9]);
    fp2_part(a, zz, k);
    fp2_b3_part(b, k);
    fp_mul(r, a, b);
    s.q[k] = r;
  }
}

// doubling, the third level's operands: t2 = 3b' Z^2, z3 = 8 Y^2, Y Z,
// t0 = Y^2 - 3 t2, y3 = Y^2 + t2, X Y
FE_FN void coop2_dbl_lin(g2_coop &s, int lane, int L) {
  for (int k = lane; k < 6; k += L) {
    fp2 yy, t2, r;
    yy.c0 = s.p[3];
    fp_add(yy.c1, s.p[4], s.p[4]);
    fp2_karatsuba(t2, s.q);
    if (k == 0) {
      r = t2;
    } else if (k == 1) {
      fp2_add(r, yy, yy);
      fp2_add(r, r, r);
      fp2_add(r, r, r);
    } else if (k == 2) {
      fp2_karatsuba(r, s.p + 5);
    } else if (k == 3) {
      fp2_add(r, t2, t2);
      fp2_add(r, r, t2);
      fp2_sub(r, yy, r);
    } else if (k == 4) {
      fp2_add(r, yy, t2);
    } else {
      fp2_karatsuba(r, s.p);
    }
    s.u[k] = r;
  }
}

// doubling, level 3: t2 z3 (products 0-2), Y Z z3 (3-5), t0 y3 (6-8),
// t0 X Y (9-11)
FE_FN void coop2_dbl_lv3(g2_coop &s, int lane, int L) {
  for (int k = lane; k < 12; k += L) {
    int j = k / 3;
    fp a, b, r;
    fp2_part(a, s.u[nib(0x3320u, j)], k - 3 * j);
    fp2_part(b, s.u[nib(0x5411u, j)], k - 3 * j);
    fp_mul(r, a, b);
    s.p[k] = r;
  }
}

// doubling, the result: X = 2 t0 X Y, Y = t2 z3 + t0 y3, Z = Y Z z3
// (coordinate c written by lane c mod L)
FE_FN void coop2_dbl_fin(g2_coop &s, int lane, int L) {
  for (int c = lane; c < 3; c += L) {
    fp2 r, t;
    if (c == 0) {
      fp2_karatsuba(t, s.p + 9);
      fp2_add(r, t, t);
    } else if (c == 1) {
      fp2_karatsuba(r, s.p);
      fp2_karatsuba(t, s.p + 6);
      fp2_add(r, r, t);
    } else {
      fp2_karatsuba(r, s.p + 3);
    }
    s.v[c] = r;
  }
}

// add, level 1 (v[0..2] + v[3..5]): X1 X2, Y1 Y2, Z1 Z2, (X1 + Y1)(X2 + Y2),
// (Y1 + Z1)(Y2 + Z2), (X1 + Z1)(X2 + Z2), GF(p^2) product j in products
// 3j..3j+2; each operand the sum of two slots, the zero slot v[6] for the
// first three
FE_FN void coop2_add_lv1(g2_coop &s, int lane, int L) {
  for (int k = lane; k < 18; k += L) {
    int j = k / 3;
    fp2 x, y;
    fp a, b, r;
    fp2_add(x, s.v[nib(0x010210u, j)], s.v[nib(0x221666u, j)]);
    fp2_add(y, s.v[nib(0x343543u, j)], s.v[nib(0x554666u, j)]);
    fp2_part(a, x, k - 3 * j);
    fp2_part(b, y, k - 3 * j);
    fp_mul(r, a, b);
    s.p[k] = r;
  }
}

// add, level 2: 3b' Z1 Z2 (products 0-2) and 3b' (X1 Z2 + X2 Z1) (3-5)
FE_FN void coop2_add_lv2(g2_coop &s, int lane, int L) {
  for (int k = lane; k < 6; k += L) {
    fp2 x, t;
    fp a, b, r;
    fp2_karatsuba(x, s.p + 6);  // Z1 Z2
    if (k >= 3) {
      fp2_karatsuba(t, s.p);  // X1 X2
      fp2_add(t, t, x);
      fp2_karatsuba(x, s.p + 15);
      fp2_sub(x, x, t);  // X1 Z2 + X2 Z1
    }
    fp2_part(a, x, k % 3);
    fp2_b3_part(b, k % 3);
    fp_mul(r, a, b);
    s.q[k] = r;
  }
}

// add, the third level's operands (g2_add's names): t3 = x1 y2 + x2 y1,
// t1 = y1 y2 - 3b' z1 z2, t4 = y1 z2 + y2 z1, y3 = 3b' (x1 z2 + x2 z1),
// t0 = 3 x1 x2, z3 = y1 y2 + 3b' z1 z2
FE_FN void coop2_add_lin(g2_coop &s, int lane, int L) {
  for (int k = lane; k < 6; k += L) {
    fp2 r, t, x;
    if (k == 0 || k == 2) {
      fp2_karatsuba(t, s.p + 3);       // Y1 Y2
      fp2_karatsuba(x, s.p + 3 * k);   // X1 X2 or Z1 Z2
      fp2_add(t, t, x);
      fp2_karatsuba(r, s.p + 9 + 3 * (k / 2));
      fp2_sub(r, r, t);
    } else if (k == 1 || k == 5) {
      fp2_karatsuba(t, s.p + 3);
      fp2_karatsuba(x, s.q);
      if (k == 1) {
        fp2_sub(r, t, x);
      } else {
        fp2_add(r, t, x);
      }
    } else if (k == 3) {
      fp2_karatsuba(r, s.q + 3);
    } else {
      fp2_karatsuba(t, s.p);
      fp2_add(r, t, t);
      fp2_add(r, r, t);
    }
    s.u[k] = r;
  }
}

// add, level 3: t3 t1, t4 y3, y3 t0, t1 z3, z3 t4, t0 t3 (GF(p^2) product
// j in products 3j..3j+2)
FE_FN void coop2_add_lv3(g2_coop &s, int lane, int L) {
  for (int k = lane; k < 18; k += L) {
    int j = k / 3;
    fp a, b, r;
    fp2_part(a, s.u[nib(0x451320u, j)], k - 3 * j);
    fp2_part(b, s.u[nib(0x025431u, j)], k - 3 * j);
    fp_mul(r, a, b);
    s.p[k] = r;
  }
}

// add, the result: X = t3 t1 - t4 y3, Y = y3 t0 + t1 z3, Z = z3 t4 + t0 t3
FE_FN void coop2_add_fin(g2_coop &s, int lane, int L) {
  for (int c = lane; c < 3; c += L) {
    fp2 a, b;
    fp2_karatsuba(a, s.p + 6 * c);
    fp2_karatsuba(b, s.p + 6 * c + 3);
    if (c == 0) {
      fp2_sub(a, a, b);
    } else {
      fp2_add(a, a, b);
    }
    s.v[c] = a;
  }
}

// slots dst[0..2] <- a working row (24 u64), the words split over the lanes
FE_FN void coop_load_row(fp2 *dst, const uint64_t *row, int lane, int L) {
  for (int i = lane; i < 24; i += L) {
    uint64_t x = row[i];
    fp &f = (i & 4) ? dst[i >> 3].c1 : dst[i >> 3].c0;
    f.v[2 * (i & 3)] = (uint32_t)x;
    f.v[2 * (i & 3) + 1] = (uint32_t)(x >> 32);
  }
}

// slots dst[0..2] <- src[0..2], the words split over the lanes
FE_FN void coop_copy(fp2 *dst, const fp2 *src, int lane, int L) {
  for (int i = lane; i < 48; i += L) {
    const fp &a = (i & 8) ? src[i >> 4].c1 : src[i >> 4].c0;
    fp &b = (i & 8) ? dst[i >> 4].c1 : dst[i >> 4].c0;
    b.v[i & 7] = a.v[i & 7];
  }
}

// v[0..2] = 2 v[0..2]
template <class Lanes>
FE_FN void coop_dbl(const Lanes &ex, g2_coop &s) {
  ex.run([&](int l) { coop2_dbl_lv1(s, l, ex.L); });
  ex.run([&](int l) { coop2_dbl_lv2(s, l, ex.L); });
  ex.run([&](int l) { coop2_dbl_lin(s, l, ex.L); });
  ex.run([&](int l) { coop2_dbl_lv3(s, l, ex.L); });
  ex.run([&](int l) { coop2_dbl_fin(s, l, ex.L); });
}

// v[0..2] = v[0..2] + v[3..5]
template <class Lanes>
FE_FN void coop_add(const Lanes &ex, g2_coop &s) {
  ex.run([&](int l) { coop2_add_lv1(s, l, ex.L); });
  ex.run([&](int l) { coop2_add_lv2(s, l, ex.L); });
  ex.run([&](int l) { coop2_add_lin(s, l, ex.L); });
  ex.run([&](int l) { coop2_add_lv3(s, l, ex.L); });
  ex.run([&](int l) { coop2_add_fin(s, l, ex.L); });
}

// the normalized result row of v[0..2] (out [24])
FE_FN void coop_store_normalized(uint64_t *out, const g2_coop &s) {
  g2p h;
  h.X = s.v[0];
  h.Y = s.v[1];
  h.Z = s.v[2];
  g2_store_normalized(out, h);
}

// K11 body (B4's BN2 instance, msm_pallas._make_bexp_kernel, redesigned
// as a fixed-base comb): base^e_i for the exponents i = g, g + G, g + 2G,
// ... < n of one thread.  Each is the sum over the windows of
// +-T[w][|d_w(e_i)|]: the first window's entry, then one table read and at
// most one mixed add per window, no doubling.  Table row w*9 + m (a
// working row of bn2_encode_affine_one) holds
// m * 16^(nw-1-w) * base; for a base of prime order every row but m = 0 is
// affine, and an identity base makes every row the identity (row 1 tells).
// The sums go to their out rows as working rows, then leave normalized by
// one inversion for the group (bn2_normalize_group, pre its scratch).
FE_FN void bn2_bexp_group(const uint64_t *tbl, const uint8_t *digits, int n,
                          int nw, int g, int G, uint64_t *pre,
                          uint64_t *out) {
  fp2 z;
  fp2_load(z, tbl + BN2_ROW + 16);
  int windows = fp2_is_zero(z) ? 1 : nw;  // an identity base: no adds
  for (int i = g; i < n; i += G) {
    g2p acc;
    int d = digit_at(digits, n, 0, i);
    g2_load(acc, tbl + (size_t)(d < 0 ? -d : d) * BN2_ROW);
    if (d < 0) g2_neg(acc);
    for (int w = 1; w < windows; w++) {
      d = digit_at(digits, n, w, i);
      if (d == 0) continue;
      const uint64_t *row = tbl + (size_t)(w * 9 + (d < 0 ? -d : d)) * BN2_ROW;
      fp2 qx, qy;
      fp2_load(qx, row);
      fp2_load(qy, row + 8);
      if (d < 0) fp2_neg(qy, qy);
      g2_madd(acc, acc, qx, qy);
    }
    g2_store(out + (size_t)i * BN2_ROW, acc);
  }
  bn2_normalize_group(out, pre, n, g, G);
}

// K12 body (B3's BN2 instance, msm_pallas._make_fold_kernel, redesigned
// on K3's fold_group as K7's bn_fold_group): gl_i^c * gr_i for the
// elements i = g, g + G, g + 2G, ... < n of one thread, c given as its nd
// width-5 NAF digits, most significant first (msm_cuda.fold_digits with
// the BN order; c is not balanced, so nothing rests on a point lying in
// the order's subgroup: the twist's cofactor is 2p - n).  Per element:
// gl_i and gr_i encoded as they are loaded, the table of gl_i's odd
// multiples 1, 3, ..., 15 (one doubling and 7 complete adds, 1.5 KB of
// local memory), the sum started from the first nonzero digit's entry,
// then per digit a doubling and, for a nonzero digit, an add of the entry
// with its Y negated for a negative digit, then the add of gr_i.  Every
// thread reads the same digit, so no branch diverges.  The sums go to
// their out rows as working rows and leave normalized by one GF(p^2)
// inversion for the group (bn2_normalize_group, pre its scratch).
FE_FN void bn2_fold_group(const uint64_t *gl, const uint64_t *gr,
                          const int8_t *cdig, int nd, int n, int g, int G,
                          uint64_t *pre, uint64_t *out) {
  int first = 0;
  while (first < nd && cdig[first] == 0) first++;
  for (int i = g; i < n; i += G) {
    g2p acc;
    if (first < nd) {
      g2p tbl[8], p2;
      g2_load_jacobian(tbl[0], gl + (size_t)i * BN2_ROW);
      g2_dbl(p2, tbl[0]);
      for (int k = 1; k < 8; k++) g2_add(tbl[k], tbl[k - 1], p2);
      int d = cdig[first];
      acc = tbl[((d < 0 ? -d : d) - 1) >> 1];
      if (d < 0) g2_neg(acc);
      for (int b = first + 1; b < nd; b++) {
        g2_dbl(acc, acc);
        d = cdig[b];
        if (d != 0) {
          g2p q = tbl[((d < 0 ? -d : d) - 1) >> 1];
          if (d < 0) g2_neg(q);
          g2_add(acc, acc, q);
        }
      }
    } else {
      g2_identity(acc);
    }
    g2p r;
    g2_load_jacobian(r, gr + (size_t)i * BN2_ROW);
    g2_add(acc, acc, r);
    g2_store(out + (size_t)i * BN2_ROW, acc);
  }
  bn2_normalize_group(out, pre, n, g, G);
}
