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
//                native._bn_pts_to_u64 (ops/curve_bn.py).  K7 and K8
//                first turn them into working rows (bn_encode_kernel),
//                K5 into its table (bn_table_kernel).
//   working row  12 x u64: X, Y, Z, projective, each coordinate canonical
//                in Montgomery form (K5's accumulators, K6's input)
//   K5 table     working rows [n][8]: each point's multiples 1..8
//   result row   12 x u64: the normalized point in standard form, (x, y, 1),
//                or (1, 1, 0) for the identity (BNPoint.identity); an
//                input row too
//   packed digits u8 [nw/2][n] (digits.cuh)

#pragma once

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

// the normalized standard-form row of p: (x, y, 1), or (1, 1, 0) for the
// identity (whose Z is 0: it takes no part in the inversion)
FE_FN void g1_store_normalized(uint64_t *row, const g1p &p) {
  fp x, y, one;
  fp_zero(one);
  one.v[0] = 1;
  if (fp_is_zero(p.Z)) {
    fp_zero(x);
    fp_store(row, one);
    fp_store(row + 4, one);
    fp_store(row + 8, x);
    return;
  }
  fp zi_m, zi;
  fp_inv(zi_m, p.Z);      // Z^-1 R
  fp_from_mont(zi, zi_m);  // Z^-1
  fp_mul(x, p.X, zi);      // X R Z^-1 R^-1 = x, standard form
  fp_mul(y, p.Y, zi);
  fp_store(row, x);
  fp_store(row + 4, y);
  fp_store(row + 8, one);
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

// K6 second phase body (B2's Horner with the BN adapter): window sums [nw]
// (most significant first) -> the normalized result row.
FE_FN void bn_msm_horner_one(const uint64_t *wsum, uint64_t *out_row,
                             int nw) {
  g1p h;
  g1_identity(h);
  for (int w = 0; w < nw; w++) {
    for (int k = 0; k < 4; k++) {
      g1p t;
      g1_dbl(t, h);
      h = t;
    }
    g1p sw, t;
    g1_load(sw, wsum + (size_t)w * 12);
    g1_add(t, h, sw);
    h = t;
  }
  g1_store_normalized(out_row, h);
}

// K7 body (B3's BN instance, msm_pallas._make_fold_kernel): gl^c * gr for
// the challenge c given as nw unsigned 4-bit windows, most significant
// first, from a 0..15 table of gl (working rows); the result leaves
// normalized.
FE_FN void bn_fold_norm_one(const uint64_t *gl_row, const uint64_t *gr_row,
                            const uint8_t *cdig, int nw, uint64_t *out_row) {
  g1p tbl[16];
  g1_identity(tbl[0]);
  g1_load(tbl[1], gl_row);
  for (int m = 2; m < 16; m++) g1_add(tbl[m], tbl[m - 1], tbl[1]);
  g1p acc;
  g1_identity(acc);
  for (int w = 0; w < nw; w++) {
    for (int k = 0; k < 4; k++) {
      g1p t;
      g1_dbl(t, acc);
      acc = t;
    }
    int d = cdig[w];
    if (d) {
      g1p t;
      g1_add(t, acc, tbl[d]);
      acc = t;
    }
  }
  g1p r, out;
  g1_load(r, gr_row);
  g1_add(out, acc, r);
  g1_store_normalized(out_row, out);
}

// K8 body (B5's BN instance, msm_pallas._make_bexp_comb_kernel):
// out_i = sum_w T[w][d_w(e_i)], one select and one add per window, no
// doublings; table row w*9 + m (a working row) holds m * 16^(nw-1-w) *
// base.
FE_FN void bn_comb_norm_one(const uint64_t *table, const uint8_t *digits,
                            int n, int nw, int i, uint64_t *out_row) {
  g1p acc;
  g1_identity(acc);
  for (int w = 0; w < nw; w++) {
    int d = digit_at(digits, n, w, i);
    if (d == 0) continue;
    g1p sel, t;
    g1_load(sel, table + (size_t)(w * 9 + (d < 0 ? -d : d)) * 12);
    if (d < 0) g1_neg(sel);
    g1_add(t, acc, sel);
    acc = t;
  }
  g1_store_normalized(out_row, acc);
}

#if defined(__CUDACC__)
// The first launch of K7 and K8: n input rows -> working rows, one thread
// per row (each source holds its own copy).
static __global__ void bn_encode_kernel(const uint64_t *in, uint64_t *out,
                                        long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) bn_encode_one(in + i * 12, out + i * 12);
}
#endif
