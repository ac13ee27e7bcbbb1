// BN256 G1 group law and the per-thread bodies of the BN kernels K5-K8
// (bn_msm_accum.cu, bn_msm_tail.cu, bn_fold.cu and bn_comb.cu launch them).
// They are __host__ __device__ so that the same code also builds with g++
// and can be checked on the CPU against the plain PyTorch versions in
// ops/msm_bn_cuda.py.
//
// Group law: the complete projective formulas for a = 0 of Renes, Costello
// and Batina (2015), Algorithm 7 (add) and Algorithm 9 (double), step for
// step as verifiable_mpc_tpu/ops/bn_pallas.py bn_add_lm / bn_dbl_lm over
// fp254.cuh.  They have no branch and no exceptional case (identity
// operands and P + P included), which is what a thread-per-element kernel
// needs.  The BN adapter has no precomputed form (msm_pallas has_pre), so
// every accumulation is the full add, as on the TPU.
//
// Data formats (all little-endian):
//   input row    12 x u64: X, Y, Z, four u64 limbs each, jacobian, each
//                coordinate canonical in standard form: the rows of
//                native._bn_pts_to_u64 (ops/curve_bn.py).  K7 encodes
//                them as it loads them (g1_load_jacobian), K8 turns them
//                into affine working rows (bn_encode_affine_one), K5
//                into its table (bn_table_kernel).
//   working row  12 x u64: X, Y, Z, projective, each coordinate canonical
//                in Montgomery form (K5's accumulators, K6's input)
//   K5 table     working rows [n][8]: each point's multiples 1..8
//   result row   12 x u64: the normalized point in standard form, (x, y, 1),
//                or (1, 1, 0) for the identity (BNPoint.identity); an
//                input row too
//   packed digits u8 [nw/2][n] (digits.cuh)

#pragma once

#include "coop.cuh"
#include "digits.cuh"
#include "fp254.cuh"

struct g1p {
  fp X, Y, Z;
};

FE_FN void g1_identity(g1p &p) {
  fp_zero(p.X);
  fp_one_mont(p.Y);
  fp_zero(p.Z);
}

FE_FN void g1_load(g1p &p, const uint64_t *row) {
  fp_load(p.X, row);
  fp_load(p.Y, row + 4);
  fp_load(p.Z, row + 8);
}

// an input row (X, Y, Z), jacobian, standard form -> the working point
// (X Z, Y, Z^3) R, projective, Montgomery form; the identity (Z = 0) ->
// (0 : R : 0).  Five products and one square.
FE_FN void g1_load_jacobian(g1p &p, const uint64_t *row) {
  fp x, y, z, r2, zz;
  fp_r2(r2);
  fp_load(x, row);
  fp_load(y, row + 4);
  fp_load(z, row + 8);
  fp_mul(z, z, r2);    // Z R
  fp_mul(x, x, r2);    // X R
  fp_mul(p.X, x, z);   // X Z R
  fp_mul(p.Y, y, r2);  // Y R
  fp_sq(zz, z);        // Z^2 R
  fp_mul(p.Z, zz, z);  // Z^3 R
  if (fp_is_zero(p.Z)) fp_one_mont(p.Y);
}

FE_FN void g1_store(uint64_t *row, const g1p &p) {
  fp_store(row, p.X);
  fp_store(row + 4, p.Y);
  fp_store(row + 8, p.Z);
}

// input row -> working row
FE_FN void bn_encode_one(const uint64_t *in_row, uint64_t *out_row) {
  g1p p;
  g1_load_jacobian(p, in_row);
  g1_store(out_row, p);
}

// RCB15 Algorithm 7, a = 0 (bn_add_lm): 12 M + 2 m_b3 (additions)
FE_FN void g1_add(g1p &r, const g1p &p, const g1p &q) {
  fp t0, t1, t2, t3, t4, xz, y3, z3, u, v;
  fp_mul(t0, p.X, q.X);
  fp_mul(t1, p.Y, q.Y);
  fp_mul(t2, p.Z, q.Z);
  fp_add(u, p.X, p.Y);
  fp_add(v, q.X, q.Y);
  fp_mul(t3, u, v);
  fp_add(u, t0, t1);
  fp_sub(t3, t3, u);  // x1 y2 + x2 y1
  fp_add(u, p.Y, p.Z);
  fp_add(v, q.Y, q.Z);
  fp_mul(t4, u, v);
  fp_add(u, t1, t2);
  fp_sub(t4, t4, u);  // y1 z2 + y2 z1
  fp_add(u, p.X, p.Z);
  fp_add(v, q.X, q.Z);
  fp_mul(xz, u, v);
  fp_add(u, t0, t2);
  fp_sub(xz, xz, u);  // x1 z2 + x2 z1
  fp_add(u, t0, t0);
  fp_add(t0, u, t0);  // 3 x1 x2
  fp_mul_b3(t2, t2);  // b3 z1 z2
  fp_add(z3, t1, t2);
  fp_sub(t1, t1, t2);
  fp_mul_b3(y3, xz);  // b3 (x1 z2 + x2 z1)
  fp_mul(u, t3, t1);
  fp_mul(v, t4, y3);
  fp_sub(r.X, u, v);
  fp_mul(u, y3, t0);
  fp_mul(v, t1, z3);
  fp_add(r.Y, u, v);
  fp_mul(u, z3, t4);
  fp_mul(v, t0, t3);
  fp_add(r.Z, u, v);
}

// RCB15 Algorithm 8, a = 0: r = p + (qx, qy) for an affine q (Z = 1, not
// the identity), 11 M + 2 m_b3 (additions).  r may alias p.
FE_FN void g1_madd(g1p &r, const g1p &p, const fp &qx, const fp &qy) {
  fp t0, t1, t2, t3, t4, u, z3, a, b;
  fp_mul(t0, p.X, qx);
  fp_mul(t1, p.Y, qy);
  fp_add(t3, qx, qy);
  fp_add(t4, p.X, p.Y);
  fp_mul(t3, t3, t4);
  fp_add(t4, t0, t1);
  fp_sub(t3, t3, t4);  // x1 y2 + x2 y1
  fp_mul(t4, qy, p.Z);
  fp_add(t4, t4, p.Y);  // y1 + y2 z1
  fp_mul(u, qx, p.Z);
  fp_add(u, u, p.X);  // x1 + x2 z1
  fp_add(t2, t0, t0);
  fp_add(t0, t2, t0);  // 3 x1 x2
  fp_mul_b3(t2, p.Z);  // b3 z1
  fp_add(z3, t1, t2);
  fp_sub(t1, t1, t2);
  fp_mul_b3(u, u);  // y3 = b3 (x1 + x2 z1)
  fp_mul(a, t4, u);
  fp_mul(b, t3, t1);
  fp_sub(r.X, b, a);
  fp_mul(a, u, t0);
  fp_mul(b, t1, z3);
  fp_add(r.Y, b, a);
  fp_mul(a, t0, t3);
  fp_mul(b, z3, t4);
  fp_add(r.Z, b, a);
}

// RCB15 Algorithm 9, a = 0 (bn_dbl_lm): 6 M + 2 S + 1 m_b3 (additions)
FE_FN void g1_dbl(g1p &r, const g1p &p) {
  fp t0, t1, t2, x3, y3, z3, u;
  fp_sq(t0, p.Y);
  fp_add(z3, t0, t0);
  fp_add(z3, z3, z3);
  fp_add(z3, z3, z3);  // 8 y^2
  fp_mul(t1, p.Y, p.Z);
  fp_sq(u, p.Z);
  fp_mul_b3(t2, u);  // b3 z^2
  fp_mul(x3, t2, z3);
  fp_add(y3, t0, t2);
  fp_mul(z3, t1, z3);
  fp_add(t1, t2, t2);
  fp_add(t2, t1, t2);  // 3 b3 z^2
  fp_sub(t0, t0, t2);  // y^2 - 3 b3 z^2
  fp_mul(u, t0, y3);
  fp_add(y3, x3, u);
  fp_mul(t1, p.X, p.Y);
  fp_mul(u, t0, t1);
  fp_add(r.X, u, u);
  r.Y = y3;
  r.Z = z3;
}

// -(X, Y, Z) = (X, -Y, Z)
FE_FN void g1_neg(g1p &p) { fp_neg(p.Y, p.Y); }

// the identity's result row: (1, 1, 0) in standard form
FE_FN void g1_store_identity_row(uint64_t *row) {
  fp one, zero;
  fp_zero(zero);
  fp_zero(one);
  one.v[0] = 1;
  fp_store(row, one);
  fp_store(row + 4, one);
  fp_store(row + 8, zero);
}

// the result row (x, y, 1), standard form, of the working point (X : Y : Z)
// given zi = Z^-1 in standard form: x = X zi R^-1 with X in Montgomery form
FE_FN void g1_store_affine_row(uint64_t *row, const fp &X, const fp &Y,
                               const fp &zi) {
  fp x, y, one;
  fp_mul(x, X, zi);
  fp_mul(y, Y, zi);
  fp_zero(one);
  one.v[0] = 1;
  fp_store(row, x);
  fp_store(row + 4, y);
  fp_store(row + 8, one);
}

// the normalized standard-form row of p: (x, y, 1), or (1, 1, 0) for the
// identity (whose Z is 0: it takes no part in the inversion)
FE_FN void g1_store_normalized(uint64_t *row, const g1p &p) {
  if (fp_is_zero(p.Z)) {
    g1_store_identity_row(row);
    return;
  }
  fp zi_m, zi;
  fp_inv(zi_m, p.Z);       // Z^-1 R
  fp_from_mont(zi, zi_m);  // Z^-1
  g1_store_affine_row(row, p.X, p.Y, zi);
}

// Montgomery's trick over one thread's group of result rows: rows i = g,
// g + G, g + 2G, ... < n of out hold working rows (projective, Montgomery
// form) and leave as their normalized result rows, with one inversion for
// the group; pre [n][4] is scratch for the running products of the Z's.
// An identity (Z = 0) enters the product as 1 and leaves as exactly
// (1, 1, 0); a group of identities inverts 1.  Per row 3 products, Z^-1
// out of Montgomery form, x and y: 6 products.
FE_FN void bn_normalize_group(uint64_t *out, uint64_t *pre, int n, int g,
                              int G) {
  fp c, z;
  fp_one_mont(c);
  int last = -1;
  for (int i = g; i < n; i += G) {
    fp_load(z, out + (size_t)i * 12 + 8);
    if (!fp_is_zero(z)) fp_mul(c, c, z);
    fp_store(pre + (size_t)i * 4, c);  // Z_g ... Z_i
    last = i;
  }
  fp inv;
  fp_inv(inv, c);  // (Z_g ... Z_last)^-1 R
  for (int i = last; i >= g; i -= G) {
    uint64_t *row = out + (size_t)i * 12;
    fp_load(z, row + 8);
    if (fp_is_zero(z)) {
      g1_store_identity_row(row);
      continue;
    }
    fp zi, X, Y, t;
    if (i - G >= g) {
      fp_load(t, pre + (size_t)(i - G) * 4);
      fp_mul(zi, inv, t);  // Z_i^-1 R
    } else {
      zi = inv;
    }
    fp_mul(t, inv, z);  // (Z_g ... Z_{i-G})^-1 R
    inv = t;
    fp_from_mont(t, zi);
    fp_load(X, row);
    fp_load(Y, row + 4);
    g1_store_affine_row(row, X, Y, t);
  }
}

// K8's first launch, for one table row: input row -> the working row of
// its affine form (x R : y R : R), or (0 : R : 0) for the identity.  The
// C++ tier's comb tables are affine already (no inversion); a row with
// another Z costs one inversion.
FE_FN void bn_encode_affine_one(const uint64_t *in_row, uint64_t *out_row) {
  g1p p;
  fp one;
  g1_load_jacobian(p, in_row);
  fp_one_mont(one);
  if (!fp_is_zero(p.Z) && !fp_equal(p.Z, one)) {
    fp zi, t;
    fp_inv(zi, p.Z);
    fp_mul(t, p.X, zi);
    p.X = t;
    fp_mul(t, p.Y, zi);
    p.Y = t;
    p.Z = one;
  }
  g1_store(out_row, p);
}

// K5's first launch, for one point: its input row -> the working rows of
// its multiples 1..8 (tbl_rows [8][12], entry m - 1 holding m P): the
// encoding and 7 complete adds, once per point, shared by all its windows.
// An identity input (Z = 0) gives identity entries (0 : R : 0).
FE_FN void bn_table_one(const uint64_t *in_row, uint64_t *tbl_rows) {
  g1p p, cur;
  g1_load_jacobian(p, in_row);
  g1_store(tbl_rows, p);
  cur = p;
  for (int m = 2; m <= 8; m++) {
    g1p nxt;
    g1_add(nxt, cur, p);
    cur = nxt;
    g1_store(tbl_rows + (size_t)(m - 1) * 12, cur);
  }
}

// K5 body (B1's BN instance, msm_pallas._make_chunk_kernel with the BN
// adapter): the window-w accumulator of slice s.  The slice holds points
// i = s, s + S, s + 2S, ... (neighbouring threads read neighbouring
// points); tbl [n][8][12] holds each point's multiples 1..8 as working
// rows.  Each (window, point) with a nonzero digit reads one entry,
// +-|d| P, negates it for d < 0 and adds it; a zero digit is skipped.
FE_FN void bn_msm_accum_one(const uint64_t *tbl, const uint8_t *digits,
                            uint64_t *acc_row, int n, int w, int s, int S) {
  g1p acc;
  g1_identity(acc);
  for (int i = s; i < n; i += S) {
    int d = digit_at(digits, n, w, i);
    if (d == 0) continue;
    g1p q;
    g1_load(q, tbl + ((size_t)i * 8 + (d < 0 ? -d : d) - 1) * 12);
    if (d < 0) g1_neg(q);
    g1p t;
    g1_add(t, acc, q);
    acc = t;
  }
  g1_store(acc_row, acc);
}

// ---------------------------------------------------------------------------
// K6 (B2's BN instance): the window sums' combination spread over lanes
// ---------------------------------------------------------------------------
//
// A group operation runs on a group of L lanes (1, 2 or 4; bn_msm_tail.cu's
// TAIL_LANES) that share one g1_coop in shared memory (coop.cuh).  An add
// (RCB15 Algorithm 7) has two levels of 6 independent products, a doubling
// (Algorithm 9) two levels of 4: lane l computes the level's products
// k = l, l + L, ... (every lane the same fp_mul on operands it picks by k);
// the linear steps between the levels run in every lane alike.

// one lane group's shared slots: v holds the point (X, Y, Z), an add's
// other operand and 0 (v[6]); m the products of an operation's two levels
struct g1_coop {
  static constexpr int COORDS = 3;
  fp v[7];
  fp m[2][6];
};

// r = c ? a : r, without a branch
FE_FN void fp_pick(fp &r, bool c, const fp &a) {
  for (int i = 0; i < 8; i++) r.v[i] = c ? a.v[i] : r.v[i];
}

// doubling, level 1: Y Y, Y Z, Z Z, X Y
FE_FN void coop_dbl_lv1(g1_coop &s, int lane, int L) {
  for (int k = lane; k < 4; k += L) {
    fp a = s.v[nib(0x0211u, k)], b = s.v[nib(0x1221u, k)], r;
    fp_mul(r, a, b);
    s.m[0][k] = r;
  }
}

// doubling, level 2: t2 = b3 Z^2, z3 = 8 Y^2, y3 = Y^2 + t2, t0 = Y^2 - 3 t2;
// products t2 z3, Y Z z3, t0 y3, t0 X Y
FE_FN void coop_dbl_lv2(g1_coop &s, int lane, int L) {
  fp t0 = s.m[0][0], t1 = s.m[0][1], xy = s.m[0][3], t2, z3, y3, u;
  fp_mul_b3(t2, s.m[0][2]);
  fp_add(z3, t0, t0);
  fp_add(z3, z3, z3);
  fp_add(z3, z3, z3);
  fp_add(y3, t0, t2);
  fp_add(u, t2, t2);
  fp_add(u, u, t2);
  fp_sub(t0, t0, u);
  for (int k = lane; k < 4; k += L) {
    fp a = t2, b = z3, r;
    fp_pick(a, k == 1, t1);
    fp_pick(a, k >= 2, t0);
    fp_pick(b, k == 2, y3);
    fp_pick(b, k == 3, xy);
    fp_mul(r, a, b);
    s.m[1][k] = r;
  }
}

// doubling, the result: X = 2 m3, Y = m0 + m2, Z = m1 (coordinate c written
// by lane c mod L)
FE_FN void coop_dbl_fin(g1_coop &s, int lane, int L) {
  for (int c = lane; c < 3; c += L) {
    fp r;
    if (c == 0) {
      fp_add(r, s.m[1][3], s.m[1][3]);
    } else if (c == 1) {
      fp_add(r, s.m[1][0], s.m[1][2]);
    } else {
      r = s.m[1][1];
    }
    s.v[c] = r;
  }
}

// add, level 1 (v[0..2] + v[3..5]): X1 X2, Y1 Y2, Z1 Z2, (X1 + Y1)(X2 + Y2),
// (Y1 + Z1)(Y2 + Z2), (X1 + Z1)(X2 + Z2); each operand is the sum of two
// slots, the zero slot v[6] for the first three
FE_FN void coop_add_lv1(g1_coop &s, int lane, int L) {
  for (int k = lane; k < 6; k += L) {
    fp a, b, r;
    fp_add(a, s.v[nib(0x010210u, k)], s.v[nib(0x221666u, k)]);
    fp_add(b, s.v[nib(0x343543u, k)], s.v[nib(0x554666u, k)]);
    fp_mul(r, a, b);
    s.m[0][k] = r;
  }
}

// add, level 2: the linear steps of bn_add_lm, then the products
// t3 t1, t4 y3, y3 t0, t1 z3, z3 t4, t0 t3
FE_FN void coop_add_lv2(g1_coop &s, int lane, int L) {
  fp t0 = s.m[0][0], t1 = s.m[0][1], t2 = s.m[0][2], t3, t4, xz, y3, z3, u;
  fp_add(u, t0, t1);
  fp_sub(t3, s.m[0][3], u);  // x1 y2 + x2 y1
  fp_add(u, t1, t2);
  fp_sub(t4, s.m[0][4], u);  // y1 z2 + y2 z1
  fp_add(u, t0, t2);
  fp_sub(xz, s.m[0][5], u);  // x1 z2 + x2 z1
  fp_add(u, t0, t0);
  fp_add(t0, u, t0);  // 3 x1 x2
  fp_mul_b3(t2, t2);  // b3 z1 z2
  fp_add(z3, t1, t2);
  fp_sub(t1, t1, t2);
  fp_mul_b3(y3, xz);  // b3 (x1 z2 + x2 z1)
  for (int k = lane; k < 6; k += L) {
    fp a = t3, b = t1, r;
    fp_pick(a, k == 1, t4);
    fp_pick(a, k == 2, y3);
    fp_pick(a, k == 3, t1);
    fp_pick(a, k == 4, z3);
    fp_pick(a, k == 5, t0);
    fp_pick(b, k == 1, y3);
    fp_pick(b, k == 2, t0);
    fp_pick(b, k == 3, z3);
    fp_pick(b, k == 4, t4);
    fp_pick(b, k == 5, t3);
    fp_mul(r, a, b);
    s.m[1][k] = r;
  }
}

// add, the result: X = m0 - m1, Y = m2 + m3, Z = m4 + m5
FE_FN void coop_add_fin(g1_coop &s, int lane, int L) {
  for (int c = lane; c < 3; c += L) {
    fp r;
    if (c == 0) {
      fp_sub(r, s.m[1][0], s.m[1][1]);
    } else {
      fp_add(r, s.m[1][2 * c], s.m[1][2 * c + 1]);
    }
    s.v[c] = r;
  }
}

// slots dst[0..2] <- a working row (12 u64), the words split over the lanes
FE_FN void coop_load_row(fp *dst, const uint64_t *row, int lane, int L) {
  for (int i = lane; i < 12; i += L) {
    uint64_t x = row[i];
    dst[i >> 2].v[2 * (i & 3)] = (uint32_t)x;
    dst[i >> 2].v[2 * (i & 3) + 1] = (uint32_t)(x >> 32);
  }
}

// slots dst[0..2] <- src[0..2], the words split over the lanes
FE_FN void coop_copy(fp *dst, const fp *src, int lane, int L) {
  for (int i = lane; i < 24; i += L) dst[i >> 3].v[i & 7] = src[i >> 3].v[i & 7];
}

// v[0..2] = 2 v[0..2]
template <class Lanes>
FE_FN void coop_dbl(const Lanes &ex, g1_coop &s) {
  ex.run([&](int l) { coop_dbl_lv1(s, l, ex.L); });
  ex.run([&](int l) { coop_dbl_lv2(s, l, ex.L); });
  ex.run([&](int l) { coop_dbl_fin(s, l, ex.L); });
}

// v[0..2] = v[0..2] + v[3..5]
template <class Lanes>
FE_FN void coop_add(const Lanes &ex, g1_coop &s) {
  ex.run([&](int l) { coop_add_lv1(s, l, ex.L); });
  ex.run([&](int l) { coop_add_lv2(s, l, ex.L); });
  ex.run([&](int l) { coop_add_fin(s, l, ex.L); });
}

// the normalized result row of v[0..2] (out [12])
FE_FN void coop_store_normalized(uint64_t *out, const g1_coop &s) {
  g1p h;
  h.X = s.v[0];
  h.Y = s.v[1];
  h.Z = s.v[2];
  g1_store_normalized(out, h);
}

// K7 body (B3's BN instance, msm_pallas._make_fold_kernel, redesigned on
// K3's fold_group): gl_i^c * gr_i for the elements i = g, g + G, g + 2G,
// ... < n of one thread, c given as its nd width-5 NAF digits, most
// significant first (msm_cuda.fold_digits with the BN order: 0 or odd in
// [-15, 15], at most one nonzero in any five; c is not balanced, so
// nothing rests on a point lying in the order's subgroup).  Per element:
// gl_i and gr_i encoded from their input rows as they are loaded, the
// table of gl_i's odd multiples 1, 3, ..., 15 (one doubling and 7 complete
// adds, 768 bytes of local memory), the sum started from the first nonzero
// digit's entry, then per digit a doubling and, for a nonzero digit, an
// add of the entry with its Y negated for a negative digit, then the add
// of gr_i.  Every thread reads the same digit, so no branch diverges.  The
// complete formulas take identities (an identity gl_i gives identity
// entries).  The sums go to their out rows as working rows and leave
// normalized by one inversion for the group (bn_normalize_group, pre its
// scratch; a sum that is the identity leaves as (1, 1, 0)).
FE_FN void bn_fold_group(const uint64_t *gl, const uint64_t *gr,
                         const int8_t *cdig, int nd, int n, int g, int G,
                         uint64_t *pre, uint64_t *out) {
  int first = 0;
  while (first < nd && cdig[first] == 0) first++;
  for (int i = g; i < n; i += G) {
    g1p acc, t;
    if (first < nd) {
      g1p tbl[8], p2;
      g1_load_jacobian(tbl[0], gl + (size_t)i * 12);
      g1_dbl(p2, tbl[0]);
      for (int k = 1; k < 8; k++) g1_add(tbl[k], tbl[k - 1], p2);
      int d = cdig[first];
      acc = tbl[((d < 0 ? -d : d) - 1) >> 1];
      if (d < 0) g1_neg(acc);
      for (int b = first + 1; b < nd; b++) {
        g1_dbl(t, acc);
        acc = t;
        d = cdig[b];
        if (d != 0) {
          g1p q = tbl[((d < 0 ? -d : d) - 1) >> 1];
          if (d < 0) g1_neg(q);
          g1_add(t, acc, q);
          acc = t;
        }
      }
    } else {
      g1_identity(acc);
    }
    g1p r;
    g1_load_jacobian(r, gr + (size_t)i * 12);
    g1_add(t, acc, r);
    g1_store(out + (size_t)i * 12, t);
  }
  bn_normalize_group(out, pre, n, g, G);
}

// K8 body (B5's BN instance, msm_pallas._make_bexp_comb_kernel):
// base^e_i for the exponents i = g, g + G, g + 2G, ... < n of one thread,
// each out_i = sum_w T[w][d_w(e_i)]: the first window's entry, then one
// select and at most one mixed add per window, no doublings.  Table row
// w*9 + m (a working row of bn_encode_affine_one) holds m * 16^(nw-1-w) *
// base; for a base of prime order every row but m = 0 is affine, and an
// identity base makes every row the identity (row 1 tells).  The sums go
// to their out rows as working rows, then leave normalized by one
// inversion for the group (bn_normalize_group, pre its scratch).
FE_FN void bn_comb_group(const uint64_t *table, const uint8_t *digits,
                         int n, int nw, int g, int G, uint64_t *pre,
                         uint64_t *out) {
  fp z;
  fp_load(z, table + 12 + 8);
  int windows = fp_is_zero(z) ? 1 : nw;  // an identity base: no adds
  for (int i = g; i < n; i += G) {
    g1p acc;
    int d = digit_at(digits, n, 0, i);
    g1_load(acc, table + (size_t)(d < 0 ? -d : d) * 12);
    if (d < 0) g1_neg(acc);
    for (int w = 1; w < windows; w++) {
      d = digit_at(digits, n, w, i);
      if (d == 0) continue;
      const uint64_t *row = table + (size_t)(w * 9 + (d < 0 ? -d : d)) * 12;
      fp qx, qy;
      fp_load(qx, row);
      fp_load(qy, row + 4);
      if (d < 0) fp_neg(qy, qy);
      g1_madd(acc, acc, qx, qy);
    }
    g1_store(out + (size_t)i * 12, acc);
  }
  bn_normalize_group(out, pre, n, g, G);
}
