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
// P + P included).  The twist adapter has no precomputed form, so every
// accumulation is the full add: 42 base-field products (12 GF(p^2)
// products and 2 by the GF(p^2) constant 3 b', 3 each), against 12 on G1;
// a doubling is 25.
//
// Registers: a projective twist point is 48 32-bit words.  The add and
// the doubling order their steps so that an operand dies as soon as its
// last product is taken (about ten GF(p^2) values live at the add's peak),
// and the kernels keep the fewest points live: K9 reads each point's
// multiples from a table that its first launch writes, instead of building
// them in registers as K5 does.
//
// Data formats (all little-endian):
//   input row    24 x u64: X.c0, X.c1, Y.c0, Y.c1, Z.c0, Z.c1, four u64
//                limbs each, jacobian, each part canonical in standard
//                form: the rows of native._bn2_pts_to_u64
//                (ops/curve_bn2.py)
//   working row  24 x u64: the same parts, projective, Montgomery form
//   result row   24 x u64: the normalized point in standard form, (x, y, 1),
//                or (1, 1, 0) for the identity (BNTwistPoint.identity); an
//                input row too
//   packed digits u8 [nw/2][n] (digits.cuh)

#pragma once

#include "digits.cuh"
#include "fp2_254.cuh"

#define BN2_ROW 24

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

// K9's first launch, for one point: its input row -> the working rows of
// its multiples 1..8 (tbl_rows [8][24], entry m - 1 holding m P): the
// encoding and 7 adds, once per point, shared by all its windows.
FE_FN void bn2_table_one(const uint64_t *in_row, uint64_t *tbl_rows) {
  g2p p, cur;
  g2_load_jacobian(p, in_row);
  g2_store(tbl_rows, p);
  cur = p;
  for (int m = 2; m <= 8; m++) {
    g2_add(cur, cur, p);
    g2_store(tbl_rows + (size_t)(m - 1) * BN2_ROW, cur);
  }
}

// K9 body (B1's BN2 instance, msm_pallas._make_chunk_kernel with the BN2
// adapter): the window-w accumulator of slice s.  The slice holds points
// i = s, s + S, s + 2S, ... (neighbouring threads read neighbouring
// points); tbl [n][8][24] holds each point's multiples 1..8.  For each
// nonzero digit d the entry |d| P is read, negated for d < 0, and added.
FE_FN void bn2_msm_accum_one(const uint64_t *tbl, const uint8_t *digits,
                             uint64_t *acc_row, int n, int w, int s, int S) {
  g2p acc;
  g2_identity(acc);
  for (int i = s; i < n; i += S) {
    int d = digit_at(digits, n, w, i);
    if (d == 0) continue;
    g2p q;
    g2_load(q, tbl + ((size_t)i * 8 + (d < 0 ? -d : d) - 1) * BN2_ROW);
    if (d < 0) g2_neg(q);
    g2_add(acc, acc, q);
  }
  g2_store(acc_row, acc);
}

// K10 second phase body (B2's Horner with the BN2 adapter): window sums
// [nw] (most significant first) -> the normalized result row.
FE_FN void bn2_msm_horner_one(const uint64_t *wsum, uint64_t *out_row,
                              int nw) {
  g2p h;
  g2_identity(h);
  for (int w = 0; w < nw; w++) {
    for (int k = 0; k < 4; k++) g2_dbl(h, h);
    g2p sw;
    g2_load(sw, wsum + (size_t)w * BN2_ROW);
    g2_add(h, h, sw);
  }
  g2_store_normalized(out_row, h);
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

// K12 body (B3's BN2 instance, msm_pallas._make_fold_kernel): gl^c * gr
// for the challenge c given as nw unsigned 4-bit windows, most significant
// first, from a 0..15 table of gl (working rows, local memory); the result
// leaves normalized.
FE_FN void bn2_fold_norm_one(const uint64_t *gl_row, const uint64_t *gr_row,
                             const uint8_t *cdig, int nw, uint64_t *out_row) {
  g2p tbl[16];
  g2_identity(tbl[0]);
  g2_load(tbl[1], gl_row);
  for (int m = 2; m < 16; m++) g2_add(tbl[m], tbl[m - 1], tbl[1]);
  g2p acc;
  g2_identity(acc);
  for (int w = 0; w < nw; w++) {
    for (int k = 0; k < 4; k++) g2_dbl(acc, acc);
    int d = cdig[w];
    if (d) g2_add(acc, acc, tbl[d]);
  }
  g2p r;
  g2_load(r, gr_row);
  g2_add(acc, acc, r);
  g2_store_normalized(out_row, acc);
}
