// Per-thread bodies of the Ed25519 kernels K1-K4 and K13-K16 (msm_accum.cu,
// msm_tail.cu, fold.cu, comb.cu, bucket_accum.cu, bucket_reduce.cu,
// bexp.cu and ed_add_mont.cu launch them).  They are __host__
// __device__ so that the same code also builds with g++ and can be checked
// on the CPU against the plain PyTorch versions in ops/msm_cuda.py.
//
// Data formats (all little-endian):
//   point row    16 x u64: x, y, z, t, four u64 limbs each (the row format
//                of native._pts_to_u64)
//   pre row      16 x u64: Y+X, Y-X, 2dT, 2Z (precomputed form)
//   affine row   12 x u64: y+x, y-x, 2dxy (affine precomputed form, Z = 1)
//   K1 table     pre rows [n][8]: each point's multiples 1..8
//   K4 table     affine rows [nw*9]: row w*9 + m = m * 16^(nw-1-w) * base
//   packed digits u8 [nw/2][n] (digits.cuh)
//   bucket layout int32 entries [E] (point indices, bit 31 set where the
//                digit is negative) and offsets [nw*lanes + 1] (column c
//                holds entries offsets[c] .. offsets[c+1] - 1),
//                msm_bucket_cuda.compact_layout
//   Montgomery limbs u32 [n][16] per coordinate: 16-bit limbs of x * 2^256
//                mod p, least significant first (ops/limbs_mont.py)

#pragma once

#include "coop.cuh"
#include "digits.cuh"
#include "fe25519.cuh"

FE_FN void ge_pre_store(uint64_t *row, const ge_pre &q) {
  fe_store(row, q.ypx);
  fe_store(row + 4, q.ymx);
  fe_store(row + 8, q.t2d);
  fe_store(row + 12, q.z2);
}

// The precomputed-form rows of p + k step for k = 0 .. count - 1 (p1 is
// p's precomputed form, the entry for k = 0): count - 1 mixed adds and
// conversions; put(k, q) receives each.  K1's table (msm_table_one: step
// p, the multiples 1..8) and K3's (fold_group: step 2p, the odd multiples
// 1..15) are built by this one body.
template <class Put>
FE_FN void ge_multiples_pre(const ge_ext &p, const ge_pre &p1,
                            const ge_pre &step, int count, Put put) {
  ge_ext cur = p;
  ge_pre q;
  put(0, p1);
  for (int k = 1; k < count; k++) {
    ge_ext nxt;
    ge_add_pre(nxt, cur, step);
    cur = nxt;
    ge_to_pre(q, cur);
    put(k, q);
  }
}

// K1's first launch, for one point: its row -> the precomputed-form rows
// of its multiples 1..8 (tbl_rows [8][16], entry m - 1 holding m P), once
// per point, shared by all its windows.  An identity point gives identity
// entries.
FE_FN void msm_table_one(const uint64_t *pt_row, uint64_t *tbl_rows) {
  ge_ext p;
  ge_pre p1;
  ge_load(p, pt_row);
  ge_to_pre(p1, p);
  ge_multiples_pre(p, p1, p1, 8, [&](int k, const ge_pre &q) {
    ge_pre_store(tbl_rows + (size_t)k * 16, q);
  });
}

// K1 body (B1, msm_pallas._make_chunk_kernel): the window-w accumulator of
// slice s.  The slice holds points i = s, s + S, s + 2S, ... (neighbouring
// threads read neighbouring points); tbl [n][8][16] holds each point's
// multiples 1..8 in precomputed form.  Each (window, point) reads one
// entry, +-|d| P, negates it for d < 0 (Y+X and Y-X swap, 2dT negates)
// and mixed-adds it.  A zero digit adds the identity entry (the unified
// add is complete), so every point costs one add and no branch skips it.
FE_FN void msm_accum_one(const uint64_t *tbl, const uint8_t *digits,
                         uint64_t *acc_row, int n, int w, int s, int S) {
  ge_ext acc;
  ge_identity(acc);
  for (int i = s; i < n; i += S) {
    int d = digit_at(digits, n, w, i);
    ge_pre q;
    if (d == 0) {
      ge_pre_identity(q);
    } else {
      ge_pre_load(q, tbl + ((size_t)i * 8 + (d < 0 ? -d : d) - 1) * 16);
    }
    if (d < 0) ge_pre_neg(q);
    ge_ext t;
    ge_add_pre(t, acc, q);
    acc = t;
  }
  ge_store(acc_row, acc);
}

// ---------------------------------------------------------------------------
// K2 (B2, msm_pallas._make_tail_kernel): the window sums' combination
// spread over lanes
// ---------------------------------------------------------------------------
//
// A group operation runs on a group of L lanes that share one ed_coop in
// shared memory (coop.cuh's steps, as K6's and K10's).  Both operations
// are two levels of four independent products, and lane l computes the
// level's products k = l, l + L, ... (every lane the same fe_mul on
// operands it picks by k):
//   doubling (dbl-2008-hwcd, a = -1): X^2, Y^2, Z^2, (X + Y)^2, then
//     E F, G H, F G, E H;
//   add (add-2008-hwcd-3, complete): (Y1 - X1)(Y2 - X2), (Y1 + X1)(Y2 +
//     X2), T1 2dT2, Z1 2Z2, then the same four.
// The add reads its operand with 2d T in place of T (coop_operand), so its
// first level holds no product of a product; the window sums and the
// groups' Horner sums are stored in that form once, off the chain of
// doublings, and the doubling and the normalization read no T.  T of a
// doubling costs no time: with four lanes its product runs beside the
// other three.  The second level's products are the result, written
// straight to v[0..3], which that level does not read.  The final
// inversion, one lane's, is the binary extended Euclid algorithm
// (fe_inv_var): shifts and subtractions where the Fermat chain runs 265
// dependent products.

// one lane group's shared slots: v the point (X, Y, Z, T), an add's other
// operand (X, Y, Z, 2dT) and 0 (v[8]); m the first level's products
struct ed_coop {
  static constexpr int COORDS = 4;
  fe v[9];
  fe m[4];
};

// the second level from e, f, g, h: v[0..3] = e f, g h, f g, e h
FE_FN void ed_coop_fin(ed_coop &s, int lane, int L, const fe &e, const fe &f,
                       const fe &g, const fe &h) {
  for (int k = lane; k < 4; k += L) {
    fe a = e, b = f, r;
    fe_pick(a, k == 1, g);
    fe_pick(a, k == 2, f);
    fe_pick(b, k & 1, h);
    fe_pick(b, k == 2, g);
    fe_mul(r, a, b);
    s.v[k] = r;
  }
}

// doubling, level 1: X^2, Y^2, Z^2, (X + Y)^2
FE_FN void ed_coop_dbl_lv1(ed_coop &s, int lane, int L) {
  for (int k = lane; k < 4; k += L) {
    fe a, r;
    fe_add(a, s.v[0], s.v[1]);
    fe_pick(a, k < 3, s.v[k < 3 ? k : 0]);
    fe_sq(r, a);
    s.m[k] = r;
  }
}

// doubling, level 2: c = 2 Z^2, e = (X + Y)^2 - X^2 - Y^2, g = Y^2 - X^2,
// f = g - c, h = -(X^2 + Y^2)
FE_FN void ed_coop_dbl_lv2(ed_coop &s, int lane, int L) {
  fe c, e, f, g, h;
  fe_add(c, s.m[2], s.m[2]);
  fe_sub(e, s.m[3], s.m[0]);
  fe_sub(e, e, s.m[1]);
  fe_sub(g, s.m[1], s.m[0]);
  fe_sub(f, g, c);
  fe_add(h, s.m[0], s.m[1]);
  fe_neg(h, h);
  ed_coop_fin(s, lane, L, e, f, g, h);
}

// add, level 1 (v[0..3] + v[4..7], the operand as (X, Y, Z, 2dT)): product
// k of a = v[i] + v[j] and b = v[i'] + v[j'] (the zero slot v[8] where a
// factor is one slot), both differences for k = 0
FE_FN void ed_coop_add_lv1(ed_coop &s, int lane, int L) {
  for (int k = lane; k < 4; k += L) {
    fe a, b, t, r;
    int i = nib(0x2311u, k), j = nib(0x8800u, k);
    int i2 = nib(0x6755u, k), j2 = nib(0x6844u, k);
    fe_add(a, s.v[i], s.v[j]);
    fe_sub(t, s.v[i], s.v[j]);
    fe_pick(a, k == 0, t);
    fe_add(b, s.v[i2], s.v[j2]);
    fe_sub(t, s.v[i2], s.v[j2]);
    fe_pick(b, k == 0, t);
    fe_mul(r, a, b);
    s.m[k] = r;
  }
}

// add, level 2: e = B - A, f = D - C, g = D + C, h = B + A
FE_FN void ed_coop_add_lv2(ed_coop &s, int lane, int L) {
  fe e, f, g, h;
  fe_sub(e, s.m[1], s.m[0]);
  fe_sub(f, s.m[3], s.m[2]);
  fe_add(g, s.m[3], s.m[2]);
  fe_add(h, s.m[1], s.m[0]);
  ed_coop_fin(s, lane, L, e, f, g, h);
}

// slots dst[0..3] <- a point row (16 u64), the words split over the lanes
FE_FN void coop_load_row(fe *dst, const uint64_t *row, int lane, int L) {
  for (int i = lane; i < 16; i += L) {
    uint64_t x = row[i];
    dst[i >> 2].v[2 * (i & 3)] = (uint32_t)x;
    dst[i >> 2].v[2 * (i & 3) + 1] = (uint32_t)(x >> 32);
  }
}

// a point row (16 u64) <- slots src[0..3], the words split over the lanes
FE_FN void coop_store_row(uint64_t *row, const fe *src, int lane, int L) {
  for (int i = lane; i < 16; i += L)
    row[i] = src[i >> 2].v[2 * (i & 3)] |
             (uint64_t)src[i >> 2].v[2 * (i & 3) + 1] << 32;
}

// slots dst[0..3] <- src[0..3], the words split over the lanes
FE_FN void coop_copy(fe *dst, const fe *src, int lane, int L) {
  for (int i = lane; i < 32; i += L) dst[i >> 3].v[i & 7] = src[i >> 3].v[i & 7];
}

// v[k + 3] = 2d v[k + 3]: the point v[k..k+3] as an add's operand
template <class Lanes>
FE_FN void coop_operand(const Lanes &ex, ed_coop &s, int k) {
  ex.run([&](int l) {
    if (l == 0) {
      fe two_d, r;
      fe_two_d(two_d);
      fe_mul(r, s.v[k + 3], two_d);
      s.v[k + 3] = r;
    }
  });
}

// v[0..3] = 2 v[0..3]
template <class Lanes>
FE_FN void coop_dbl(const Lanes &ex, ed_coop &s) {
  ex.run([&](int l) { ed_coop_dbl_lv1(s, l, ex.L); });
  ex.run([&](int l) { ed_coop_dbl_lv2(s, l, ex.L); });
}

// v[0..3] = v[0..3] + v[4..7]
template <class Lanes>
FE_FN void coop_add(const Lanes &ex, ed_coop &s) {
  ex.run([&](int l) { ed_coop_add_lv1(s, l, ex.L); });
  ex.run([&](int l) { ed_coop_add_lv2(s, l, ex.L); });
}

// the canonical affine row of v[0..3] (out [16]); T is not read
FE_FN void coop_store_normalized(uint64_t *out, const ed_coop &s) {
  fe zinv;
  fe_inv_var(zinv, s.v[2]);
  ge_store_affine(out, s.v[0], s.v[1], zinv);
}

// Montgomery's trick over one thread's group of rows i = g, g + G, g + 2G,
// ... < n of out, which hold extended points (X, Y, Z, T): each leaves as
// its canonical affine row (x, y, 1, x y), with one inversion for the
// group; pre [n][4] is scratch for the running products of the Z's (an
// Ed25519 point's Z is never 0).  Per row 3 products, then x, y and x y.
FE_FN void ed_normalize_group(uint64_t *out, uint64_t *pre, int n, int g,
                              int G) {
  fe c, z;
  int last = g;
  fe_load(c, out + (size_t)g * 16 + 8);
  fe_store(pre + (size_t)g * 4, c);
  for (int i = g + G; i < n; i += G) {
    fe_load(z, out + (size_t)i * 16 + 8);
    fe_mul(c, c, z);
    fe_store(pre + (size_t)i * 4, c);  // Z_g ... Z_i
    last = i;
  }
  fe inv;
  fe_inv(inv, c);  // (Z_g ... Z_last)^-1
  for (int i = last; i >= g; i -= G) {
    uint64_t *row = out + (size_t)i * 16;
    fe zi, X, Y, t;
    if (i - G >= g) {
      fe_load(t, pre + (size_t)(i - G) * 4);
      fe_mul(zi, inv, t);  // Z_i^-1
      fe_load(z, row + 8);
      fe_mul(t, inv, z);  // (Z_g ... Z_{i-G})^-1
      inv = t;
    } else {
      zi = inv;
    }
    fe_load(X, row);
    fe_load(Y, row + 4);
    ge_store_affine(row, X, Y, zi);
  }
}

// K3 body (B3, msm_pallas._make_fold_kernel, plus the engine's
// fold-then-normalize of ac20/pivot_tpu._fold_norm_call): gl_i^c * gr_i
// for the elements i = g, g + G, g + 2G, ... < n of one thread, c given
// as its nd width-5 NAF digits, most significant first
// (msm_cuda.fold_digits: 0 or odd in [-15, 15], at most one nonzero in any
// five; c is not balanced, so nothing rests on gl_i lying in the order-l
// subgroup).  Per element: the table of gl_i's odd multiples 1, 3, ..., 15
// (ge_multiples_pre, 1 KB of local memory), the sum started from the first
// nonzero digit's entry, then per digit a doubling (T only in the one an
// add reads) and, for a nonzero digit, a mixed add of +-T[(|d| - 1) / 2]
// (the sign picks the entry's operands: no negated copy, which cost
// registers), then the add of gr_i.  Every thread reads the same digit, so
// no branch diverges.  The sums go to their out rows as extended points
// and leave as canonical affine rows by one inversion for the group
// (ed_normalize_group).
FE_FN void fold_group(const uint64_t *gl, const uint64_t *gr,
                      const int8_t *cdig, int nd, int n, int g, int G,
                      uint64_t *pre, uint64_t *out) {
  int first = 0;
  while (first < nd && cdig[first] == 0) first++;
  for (int i = g; i < n; i += G) {
    ge_ext acc;
    if (first < nd) {
      ge_pre tbl[8], p1, step, q;
      ge_ext p, p2;
      ge_load(p, gl + (size_t)i * 16);
      ge_to_pre(p1, p);
      ge_dbl(p2, p);
      ge_to_pre(step, p2);
      ge_multiples_pre(p, p1, step, 8,
                       [&](int k, const ge_pre &e) { tbl[k] = e; });
      int d = cdig[first];
      q = tbl[((d < 0 ? -d : d) - 1) >> 1];
      if (d < 0) ge_pre_neg(q);
      ge_pre_to_ext(acc, q);
      for (int b = first + 1; b < nd; b++) {
        d = cdig[b];
        if (d != 0 || b == nd - 1) {
          ge_dbl(acc, acc);
        } else {
          ge_dbl_no_t(acc, acc);
        }
        if (d != 0) {
          ge_ext t;
          ge_add_pre_signed(t, acc, tbl[((d < 0 ? -d : d) - 1) >> 1], d < 0);
          acc = t;
        }
      }
    } else {
      ge_identity(acc);
    }
    ge_ext r, sum;
    ge_load(r, gr + (size_t)i * 16);
    ge_add(sum, acc, r);
    ge_store(out + (size_t)i * 16, sum);
  }
  ed_normalize_group(out, pre, n, g, G);
}

// K4 body (B5, msm_pallas._make_bexp_comb_kernel + normalize_pack):
// base^e_i for the exponents i = g, g + G, g + 2G, ... < n of one thread,
// each out_i = sum_w T[w][d_w(e_i)]: the first window's entry as an
// extended point, then one table read and, for a nonzero digit, one mixed
// add of the affine entry per window, no doublings (the last add needs no
// T, but leaving it out behind a branch ran slower on an H100).  Table row
// w*9 + m (an affine row) holds m * 16^(nw-1-w) * base; rows m = 0 are the
// identity (1, 1, 0).  The sums
// go to their out rows as extended points and leave as canonical affine
// rows by one inversion for the group (ed_normalize_group, pre its
// scratch); a sum's Z is never 0, an exponent 0's too.
FE_FN void comb_group(const uint64_t *table, const uint8_t *digits, int n,
                      int nw, int g, int G, uint64_t *pre, uint64_t *out) {
  for (int i = g; i < n; i += G) {
    int d = digit_at(digits, n, 0, i);
    ge_aff q;
    ge_aff_load(q, table + (size_t)(d < 0 ? -d : d) * 12);
    ge_ext acc;
    ge_aff_to_ext(acc, q, d < 0);
    for (int w = 1; w < nw; w++) {
      d = digit_at(digits, n, w, i);
      if (d == 0) continue;
      ge_aff_load(q, table + (size_t)(w * 9 + (d < 0 ? -d : d)) * 12);
      ge_add_aff_signed(acc, acc, q, d < 0);
    }
    ge_store(out + (size_t)i * 16, acc);
  }
  ed_normalize_group(out, pre, n, g, G);
}

// ---------------------------------------------------------------------------
// K13 bodies (B6, msm_bucket._make_accum_kernel): bucket accumulation over
// the compact layout
// ---------------------------------------------------------------------------
//
// Thread t sums the entries [t C, t C + C) of the flat entry list (C =
// chunk, the last thread fewer) run by run, a run being one column's
// entries inside the thread.  A run that is its whole column goes to
// out[c]; a run whose column also holds entries before the thread's first
// goes to the thread's partial slot 0, one whose column holds entries
// after its last (and none before) to slot 1 (part [T][2][16]).  A
// crossing column c then has partials in threads t0 = offsets[c] / C ..
// t1 = (offsets[c+1] - 1) / C: slot 0 of each, except slot 1 of t0 where
// the column starts inside t0 (bucket_partial).

// K13's first launch: a point row -> its precomputed-form row
FE_FN void bucket_pre_one(const uint64_t *pt_row, uint64_t *pre_row) {
  ge_ext p;
  ge_pre q;
  ge_load(p, pt_row);
  ge_to_pre(q, p);
  ge_pre_store(pre_row, q);
}

// the column of entry j < offsets[cols]: the last c with offsets[c] <= j
FE_FN int bucket_column_of(const int32_t *offsets, int cols, int j) {
  int lo = 0, hi = cols;  // offsets[lo] <= j < offsets[hi]
  while (hi - lo > 1) {
    int mid = (lo + hi) >> 1;
    if (offsets[mid] <= j) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// K13's accumulation, thread t of ceil(count / chunk): its runs' sums,
// each entry's precomputed row negated in place where the entry is
// negative, then mixed-added (the signed add's operand picks kept the row
// in local memory and ran slower)
FE_FN void bucket_accum_thread(const uint64_t *pre, const int32_t *entries,
                               const int32_t *offsets, int cols, int count,
                               int chunk, int t, uint64_t *part,
                               uint64_t *out) {
  int j0 = t * chunk;
  int j1 = count - j0 > chunk ? j0 + chunk : count;
  int c = bucket_column_of(offsets, cols, j0);
  int start = j0;
  int end = offsets[c + 1] < j1 ? offsets[c + 1] : j1;
  ge_ext acc;
  ge_identity(acc);
  for (int j = j0; j < j1; j++) {
    int e = entries[j];
    ge_pre q;
    ge_pre_load(q, pre + (size_t)(e & 0x7fffffff) * 16);
    if (e < 0) ge_pre_neg(q);
    ge_ext r;
    ge_add_pre(r, acc, q);
    acc = r;
    if (j + 1 == end) {
      uint64_t *dst;
      if (offsets[c] >= j0 && offsets[c + 1] <= j1) {
        dst = out + (size_t)c * 16;
      } else {
        dst = part + ((size_t)t * 2 + (start == j0 ? 0 : 1)) * 16;
      }
      ge_store(dst, acc);
      ge_identity(acc);
      start = end;
      if (start < j1) {
        do {
          c++;
        } while (offsets[c + 1] <= start);  // empty columns
        end = offsets[c + 1] < j1 ? offsets[c + 1] : j1;
      }
    }
  }
}

// the number of partials of column c: 0 where it is empty or lies inside
// one thread's entries
FE_FN int bucket_partials(const int32_t *offsets, int c, int chunk) {
  int a = offsets[c], b = offsets[c + 1];
  if (a == b) return 0;
  int t0 = a / chunk, t1 = (b - 1) / chunk;
  return t1 > t0 ? t1 - t0 + 1 : 0;
}

// partial k of column c's partials
FE_FN const uint64_t *bucket_partial(const uint64_t *part,
                                     const int32_t *offsets, int c, int chunk,
                                     int k) {
  int a = offsets[c];
  int t = a / chunk + k;
  int slot = k == 0 && a != t * chunk ? 1 : 0;
  return part + ((size_t)t * 2 + slot) * 16;
}

// K13's combination, lane i of M of column c's warp: the partials i,
// i + M, ... < np summed into the row dst (M <= np: every lane has one)
FE_FN void bucket_combine_lane(const uint64_t *part, const int32_t *offsets,
                               int c, int chunk, int np, int i, int M,
                               uint64_t *dst) {
  ge_ext acc;
  ge_load(acc, bucket_partial(part, offsets, c, chunk, i));
  for (int k = i + M; k < np; k += M) {
    ge_ext p, t;
    ge_load(p, bucket_partial(part, offsets, c, chunk, k));
    ge_add(t, acc, p);
    acc = t;
  }
  ge_store(dst, acc);
}

// one step of the combination's tree over the rows buf: buf[i] +=
// buf[i + stride]
FE_FN void bucket_tree_step(uint64_t *buf, int i, int stride) {
  ge_ext x, y, t;
  ge_load(x, buf + (size_t)i * 16);
  ge_load(y, buf + (size_t)(i + stride) * 16);
  ge_add(t, x, y);
  ge_store(buf + (size_t)i * 16, t);
}

// ---------------------------------------------------------------------------
// K14 bodies (B7, msm_bucket._make_reduce_kernel): a window's
// sum_b (b+1) B_b as sum_b suffix(B)_b, every add on a lane group
// ---------------------------------------------------------------------------
//
// Bucket b of a window is lane group b's slots sh[b] (ed_coop).  A round of
// the inclusive suffix scan first copies bucket b + shift's point into b's
// operand slots (bucket_scan_fetch, in every group before any adds: a
// block barrier between), then adds it (bucket_scan_add); a round of the
// tree over the scanned buckets does both for b < stride, whose sources
// that round does not write.

// bucket b's slots <- its row of the window's buckets (rows [lanes][16])
template <class Lanes>
FE_FN void bucket_load(const Lanes &ex, ed_coop *sh, const uint64_t *rows,
                       int b) {
  ex.run([&](int l) {
    coop_load_row(sh[b].v, rows + (size_t)b * 16, l, ex.L);
    if (l == 0) fe_zero(sh[b].v[8]);
  });
}

// bucket b's operand <- bucket b + shift's point (nothing past the last)
template <class Lanes>
FE_FN void bucket_scan_fetch(const Lanes &ex, ed_coop *sh, int lanes, int b,
                             int shift) {
  if (b + shift >= lanes) return;
  ex.run([&](int l) { coop_copy(sh[b].v + 4, sh[b + shift].v, l, ex.L); });
}

// bucket b += its operand (nothing past the last)
template <class Lanes>
FE_FN void bucket_scan_add(const Lanes &ex, ed_coop *sh, int lanes, int b,
                           int shift) {
  if (b + shift >= lanes) return;
  coop_operand(ex, sh[b], 4);
  coop_add(ex, sh[b]);
}

// ---------------------------------------------------------------------------
// K15 body (B4's Ed25519 instance, msm_pallas._make_bexp_kernel)
// ---------------------------------------------------------------------------

// base^e_i by a signed-window Horner ladder over the precomputed-form
// table tbl [9] of the base's multiples 0..8: 4 doublings (none before the
// exponent's first nonzero window) and a mixed add of +-T[|d|] per window;
// the result leaves as a canonical affine row.
FE_FN void bexp_norm_one(const uint64_t *tbl, const uint8_t *digits, int n,
                         int nw, int i, uint64_t *out_row) {
  ge_ext acc;
  ge_identity(acc);
  bool started = false;
  for (int w = 0; w < nw; w++) {
    if (started) {
      for (int k = 0; k < 4; k++) {
        ge_ext t;
        ge_dbl(t, acc);
        acc = t;
      }
    }
    int d = digit_at(digits, n, w, i);
    if (d == 0) continue;
    ge_pre sel;
    ge_pre_load(sel, tbl + (size_t)(d < 0 ? -d : d) * 16);
    if (d < 0) ge_pre_neg(sel);
    ge_ext t;
    ge_add_pre(t, acc, sel);
    acc = t;
    started = true;
  }
  ge_store_normalized(out_row, acc);
}

// ---------------------------------------------------------------------------
// K16 body (B8, pallas_kernels._add_kernel): the unified add on Montgomery
// limbs
// ---------------------------------------------------------------------------

// 16 x 16-bit limbs held in u32 words <-> eight 32-bit limbs
FE_FN void fe_from_limbs16(fe &r, const uint32_t *l) {
  for (int i = 0; i < 8; i++)
    r.v[i] = (l[2 * i] & 0xffffu) | (l[2 * i + 1] << 16);
}

FE_FN void fe_to_limbs16(uint32_t *l, const fe &a) {
  for (int i = 0; i < 8; i++) {
    l[2 * i] = a.v[i] & 0xffffu;
    l[2 * i + 1] = a.v[i] >> 16;
  }
}

// Montgomery limbs of x * R, R = 2^256 == 38 (mod p) -> x: times 38^-1
FE_FN void mont_load(fe &r, const uint32_t *l) {
  const uint32_t k[8] = {0x9435e50au, 0x435e50d7u, 0x35e50d79u, 0x5e50d794u,
                         0xe50d7943u, 0x50d79435u, 0x0d79435eu, 0x179435e5u};
  fe a, inv38;
  for (int i = 0; i < 8; i++) inv38.v[i] = k[i];
  fe_from_limbs16(a, l);
  fe_mul(r, a, inv38);
}

// x -> the limbs of its canonical Montgomery form 38 x mod p
FE_FN void mont_store(uint32_t *l, const fe &a) {
  fe k, t, c;
  fe_small(k, 38);
  fe_mul(t, a, k);
  fe_canon(c, t);
  fe_to_limbs16(l, c);
}

// coordinate arrays x, y, z, t [n][16] of a point vector in Montgomery limbs
struct MontCoords {
  const uint32_t *x, *y, *z, *t;
};
struct MontCoordsOut {
  uint32_t *x, *y, *z, *t;
};

// element i: p_i + q_i (add-2008-hwcd-3, complete), in and out as
// canonical Montgomery limbs
FE_FN void mont_add_one(const MontCoords &p, const MontCoords &q,
                        const MontCoordsOut &o, size_t i) {
  size_t k = i * 16;
  ge_ext a, b, r;
  mont_load(a.X, p.x + k);
  mont_load(a.Y, p.y + k);
  mont_load(a.Z, p.z + k);
  mont_load(a.T, p.t + k);
  mont_load(b.X, q.x + k);
  mont_load(b.Y, q.y + k);
  mont_load(b.Z, q.z + k);
  mont_load(b.T, q.t + k);
  ge_add(r, a, b);
  mont_store(o.x + k, r.X);
  mont_store(o.y + k, r.Y);
  mont_store(o.z + k, r.Z);
  mont_store(o.t + k, r.T);
}
