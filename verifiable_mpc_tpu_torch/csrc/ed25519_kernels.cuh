// Per-thread bodies of the Ed25519 kernels K1-K4 (msm_accum.cu,
// msm_tail.cu, fold.cu and comb.cu launch them).  They are __host__
// __device__ so that the same code also builds with g++ and can be checked
// on the CPU against the plain PyTorch versions in ops/msm_cuda.py.
//
// Data formats (all little-endian):
//   point row    16 x u64: x, y, z, t, four u64 limbs each (the row format
//                of native._pts_to_u64)
//   pre row      16 x u64: Y+X, Y-X, 2dT, 2Z (precomputed form)
//   packed digits u8 [nw/2][n] (digits.cuh)

#pragma once

#include "digits.cuh"
#include "fe25519.cuh"

// K1 body (B1, msm_pallas._make_chunk_kernel): the window-w accumulator of
// slice s.  The slice holds points i = s, s + S, s + 2S, ... (neighbouring
// threads read neighbouring points).  For each point the multiples
// 1..|d| of the 0..8 precomputed-form table are built on the fly (the
// table entry the digit selects), negated for d < 0, and mixed-added.
FE_FN void msm_accum_one(const uint64_t *pts, const uint8_t *digits,
                         uint64_t *acc_row, int n, int w, int s, int S) {
  ge_ext acc;
  ge_identity(acc);
  for (int i = s; i < n; i += S) {
    int d = digit_at(digits, n, w, i);
    if (d == 0) continue;
    int m = d < 0 ? -d : d;
    ge_ext p, cur;
    ge_load(p, pts + (size_t)i * 16);
    ge_pre pre_p, sel;
    ge_to_pre(pre_p, p);
    cur = p;
    for (int k = 2; k <= m; k++) {
      ge_ext nxt;
      ge_add_pre(nxt, cur, pre_p);
      cur = nxt;
    }
    if (m == 1) {
      sel = pre_p;
    } else {
      ge_to_pre(sel, cur);
    }
    if (d < 0) ge_pre_neg(sel);
    ge_ext nxt;
    ge_add_pre(nxt, acc, sel);
    acc = nxt;
  }
  ge_store(acc_row, acc);
}

// K2 second phase body (B2's Horner, msm_pallas._make_tail_kernel):
// window sums [nw] (most significant first) -> canonical normalized row.
FE_FN void msm_horner_one(const uint64_t *wsum, uint64_t *out_row, int nw) {
  ge_ext h;
  ge_identity(h);
  for (int w = 0; w < nw; w++) {
    for (int k = 0; k < 4; k++) {
      ge_ext t;
      ge_dbl(t, h);
      h = t;
    }
    ge_ext sw, t;
    ge_load(sw, wsum + (size_t)w * 16);
    ge_add(t, h, sw);
    h = t;
  }
  ge_store_normalized(out_row, h);
}

// K3 body (B3, msm_pallas._make_fold_kernel, plus the engine's
// fold-then-normalize of ac20/pivot_tpu._fold_norm_call): gl^c * gr for
// the challenge c given as nw unsigned 4-bit windows, most significant
// first; the result leaves as a canonical affine row.
FE_FN void fold_norm_one(const uint64_t *gl_row, const uint64_t *gr_row,
                         const uint8_t *cdig, int nw, uint64_t *out_row) {
  ge_pre tbl[16];
  ge_ext p, cur;
  ge_load(p, gl_row);
  ge_pre_identity(tbl[0]);
  ge_to_pre(tbl[1], p);
  cur = p;
  for (int m = 2; m < 16; m++) {
    ge_ext nxt;
    ge_add_pre(nxt, cur, tbl[1]);
    cur = nxt;
    ge_to_pre(tbl[m], cur);
  }
  ge_ext acc;
  ge_identity(acc);
  for (int w = 0; w < nw; w++) {
    for (int k = 0; k < 4; k++) {
      ge_ext t;
      ge_dbl(t, acc);
      acc = t;
    }
    int d = cdig[w];
    if (d) {
      ge_ext t;
      ge_add_pre(t, acc, tbl[d]);
      acc = t;
    }
  }
  ge_ext r, out;
  ge_load(r, gr_row);
  ge_add(out, acc, r);
  ge_store_normalized(out_row, out);
}

// K4 body (B5, msm_pallas._make_bexp_comb_kernel + normalize_pack):
// out_i = sum_w T[w][d_w(e_i)], one select and one mixed add per window,
// no doublings; table rows are precomputed-form entries, row w*9 + m
// holding m * 16^(nw-1-w) * base.
FE_FN void comb_norm_one(const uint64_t *table, const uint8_t *digits, int n,
                         int nw, int i, uint64_t *out_row) {
  ge_ext acc;
  ge_identity(acc);
  for (int w = 0; w < nw; w++) {
    int d = digit_at(digits, n, w, i);
    if (d == 0) continue;
    ge_pre sel;
    ge_pre_load(sel, table + (size_t)(w * 9 + (d < 0 ? -d : d)) * 16);
    if (d < 0) ge_pre_neg(sel);
    ge_ext t;
    ge_add_pre(t, acc, sel);
    acc = t;
  }
  ge_store_normalized(out_row, acc);
}
