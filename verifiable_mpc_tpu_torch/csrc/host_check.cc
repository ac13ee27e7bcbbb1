// CPU build of the kernel bodies (g++): each entry point runs the per-thread
// body of one CUDA kernel for every thread index in turn, so the field and
// curve code of fe25519.cuh / ed25519_kernels.cuh, fp254.cuh /
// bn254_kernels.cuh and fp2_254.cuh / bn2_kernels.cuh can be checked
// against the plain PyTorch versions without a GPU
// (tests/port/test_torch_cuda_host.py, tests/port/test_torch_bn_host.py,
// tests/port/test_torch_bn2_host.py), and the loop bodies of the probe
// kernels P1-P4 (probe_ops.cuh) against Python ints.  A kernel whose threads meet in
// shared memory (K13's combination, K14's scan and tree, the tails' lane
// groups) runs its steps here one thread after the other, each step's
// threads reading what the step before wrote.
//
//   g++ -O2 -shared -fPIC -o libhost_check.so host_check.cc

#include <stdint.h>
#include <string.h>

#include "bn254_kernels.cuh"
#include "bn2_kernels.cuh"
#include "ed25519_kernels.cuh"
#include "probe_ops.cuh"

// the combination of K2, K6, K10 or K14 (coop.cuh's tail steps) for each
// batch: part [B][nw][R][row] -> out [B][row], L lanes a group of the
// windows' sums, Lc lanes a group of the Horners and the shift, P window
// groups, windows of ``bits`` bits; the groups run one after another
// between the kernel's block barriers, and each group step lane by lane
// (CoopLanes::run)
template <class Slots, class E>
static void host_tail_combine(const uint64_t *part, uint64_t *out, int B,
                              int nw, int R, int L, int Lc, int P,
                              int bits) {
  constexpr int C = Slots::COORDS;
  const size_t row = C * sizeof(E) / sizeof(uint64_t);
  Slots *sh = new Slots[64];
  E(*wsum)[C] = new E[64][C];
  CoopLanes ex = {0, L, 0}, ec = {0, Lc, 0};
  for (int b = 0; b < B; b++) {
    for (int g = 0; g < nw; g++)
      tail_window(ex, sh[g], part + (size_t)(b * nw + g) * R * row, R,
                  wsum[g]);
    for (int g = 0; g < P; g++) tail_group(ec, sh[g], wsum, g, nw, P, bits);
    tail_shift(ec, sh, nw, P, bits, out + b * row);
  }
  delete[] sh;
  delete[] wsum;
}

extern "C" {

// K1's first launch: n points' rows [n][16] -> tbl [n][8][16]
void host_msm_table(const uint64_t *pts, uint64_t *tbl, long long n) {
  for (long long i = 0; i < n; i++) msm_table_one(pts + i * 16, tbl + i * 128);
}

// K1's second launch, every (batch, window, slice) thread of its grid:
// tbl [B][n][8][16], digits [B][nw/2][n] -> acc [B][nw][S][16]
void host_msm_accum(const uint64_t *tbl, const uint8_t *digits, int B, int n,
                    int nw, int S, uint64_t *acc) {
  for (int b = 0; b < B; b++)
    for (int w = 0; w < nw; w++)
      for (int s = 0; s < S; s++)
        msm_accum_one(tbl + (size_t)b * n * 128,
                      digits + (size_t)b * (nw / 2) * n,
                      acc + ((size_t)(b * nw + w) * S + s) * 16, n, w, s, S);
}

// K2 with R chunks a window, L lanes a group of the windows' sums, Lc
// lanes a group of the Horners and the shift, P window groups and windows
// of ``bits`` bits (K2's 4; K14's combination takes 8), as
// host_bn2_msm_tail: acc [B][nw][S][16] -> part [B][nw][R][16] (scratch)
// -> out [B][16]
void host_msm_tail(const uint64_t *acc, uint64_t *part, uint64_t *out, int B,
                   int nw, int S, int R, int L, int Lc, int P, int bits) {
  int chunk = (S + R - 1) / R;
  for (int b = 0; b < B; b++)
    for (int w = 0; w < nw; w++)
      for (int r = 0; r < R; r++) {
        ge_ext sum;
        ge_identity(sum);
        for (int s = r * chunk; s < S && s < (r + 1) * chunk; s++) {
          ge_ext p, t;
          ge_load(p, acc + ((size_t)(b * nw + w) * S + s) * 16);
          ge_add(t, sum, p);
          sum = t;
        }
        ge_store(part + ((size_t)(b * nw + w) * R + r) * 16, sum);
      }
  host_tail_combine<ed_coop, fe>(part, out, B, nw, R, L, Lc, P, bits);
}

// one of K2's group operations on L lanes, run lane by lane: out = p + q
// (op 0) or 2 p (op 1); point rows [16] in, canonical coordinates out
void host_ed_coop(int op, int L, const uint64_t *p, const uint64_t *q,
                  uint64_t *out) {
  ed_coop s;
  CoopLanes ex = {0, L, 0};
  coop_load_row(s.v, p, 0, 1);
  coop_load_row(s.v + 4, q, 0, 1);
  fe_zero(s.v[8]);
  if (op == 0) {
    coop_operand(ex, s, 4);
    coop_add(ex, s);
  } else {
    coop_dbl(ex, s);
  }
  for (int c = 0; c < 4; c++) {
    fe r;
    fe_canon(r, s.v[c]);
    fe_store(out + 4 * c, r);
  }
}

// K1 then K2 for one batch: pts [n][16], tbl [n][8][16] scratch,
// digits [nw/2][n] -> out [16] (part [nw][16]: K2's partials at R = 1)
void host_msm(const uint64_t *pts, uint64_t *tbl, const uint8_t *digits,
              int n, int nw, int S, uint64_t *acc, uint64_t *part,
              uint64_t *out) {
  host_msm_table(pts, tbl, n);
  for (int w = 0; w < nw; w++)
    for (int s = 0; s < S; s++)
      msm_accum_one(tbl, digits, acc + ((size_t)w * S + s) * 16, n, w, s, S);
  host_msm_tail(acc, part, out, 1, nw, S, 1, 4, 4, 8, 4);
}

// K3 with G threads: gl, gr [n][16], cdig nd NAF digits, pre [n][4],
// out [n][16]
void host_fold_norm(const uint64_t *gl, const uint64_t *gr,
                    const int8_t *cdig, int nd, int G, uint64_t *pre,
                    uint64_t *out, int n) {
  for (int g = 0; g < G; g++) fold_group(gl, gr, cdig, nd, n, g, G, pre, out);
}

// K4 with G threads: table [nw*9][12] affine rows, digits [nw/2][n],
// pre [n][4], out [n][16]
void host_comb_norm(const uint64_t *table, const uint8_t *digits, int n,
                    int nw, int G, uint64_t *pre, uint64_t *out) {
  for (int g = 0; g < G; g++) comb_group(table, digits, n, nw, g, G, pre, out);
}

// K13 with chunk entries a thread and M lanes a column's combination (the
// kernel's warp: 32):
// pts [n][16], pre [n][16] scratch, entries [count] and offsets
// [nw * lanes + 1] (the compact layout), part [ceil(count / chunk)][2][16]
// and buf [M][16] scratch -> out [nw][lanes][16]; every accumulation
// thread, then every column's warp, its lanes one after another between
// its barriers
void host_bucket_accum(const uint64_t *pts, uint64_t *pre,
                       const int32_t *entries, const int32_t *offsets,
                       uint64_t *part, uint64_t *buf, uint64_t *out, int n,
                       int nw, int lanes, int count, int chunk, int M) {
  for (int i = 0; i < n; i++)
    bucket_pre_one(pts + (size_t)i * 16, pre + (size_t)i * 16);
  int cols = nw * lanes;
  for (int t = 0; t * chunk < count; t++)
    bucket_accum_thread(pre, entries, offsets, cols, count, chunk, t, part,
                        out);
  for (int c = 0; c < cols; c++) {
    uint64_t *dst = out + (size_t)c * 16;
    if (offsets[c] == offsets[c + 1]) {
      ge_ext z;
      ge_identity(z);
      ge_store(dst, z);
      continue;
    }
    int np = bucket_partials(offsets, c, chunk);
    if (np == 0) continue;
    int m = np < M ? np : M;
    for (int i = 0; i < m; i++)
      bucket_combine_lane(part, offsets, c, chunk, np, i, m,
                          buf + (size_t)i * 16);
    int p2 = 1;
    while (p2 < m) p2 <<= 1;
    for (int stride = p2 >> 1; stride > 0; stride >>= 1)
      for (int i = 0; i < stride && i + stride < m; i++)
        bucket_tree_step(buf, i, stride);
    memcpy(dst, buf, sizeof(uint64_t) * 16);
  }
}

// K14 with L lanes a group operation and P window groups: buckets
// [nw][lanes][16] -> wsum [nw][16] scratch -> out [16]; each window's
// lane groups run one after another between the block's barriers, then
// the combination with 8-bit windows
void host_bucket_reduce(const uint64_t *buckets, uint64_t *wsum,
                        uint64_t *out, int nw, int lanes, int L, int P) {
  ed_coop *sh = new ed_coop[lanes];
  CoopLanes ex = {0, L, 0};
  for (int w = 0; w < nw; w++) {
    const uint64_t *rows = buckets + (size_t)w * lanes * 16;
    for (int b = 0; b < lanes; b++) bucket_load(ex, sh, rows, b);
    for (int shift = 1; shift < lanes; shift <<= 1) {
      for (int b = 0; b < lanes; b++) bucket_scan_fetch(ex, sh, lanes, b, shift);
      for (int b = 0; b < lanes; b++) bucket_scan_add(ex, sh, lanes, b, shift);
    }
    int p2 = 1;
    while (p2 < lanes) p2 <<= 1;
    for (int stride = p2 >> 1; stride > 0; stride >>= 1)
      for (int b = 0; b < stride; b++) {
        bucket_scan_fetch(ex, sh, lanes, b, stride);
        bucket_scan_add(ex, sh, lanes, b, stride);
      }
    coop_store_row(wsum + (size_t)w * 16, sh[0].v, 0, 1);
  }
  delete[] sh;
  host_tail_combine<ed_coop, fe>(wsum, out, 1, nw, 1, L, L, P, 8);
}

// K15: table [9][16] precomputed-form rows, digits [nw/2][n] -> out [n][16]
void host_bexp_norm(const uint64_t *table, const uint8_t *digits, int n,
                    int nw, uint64_t *out) {
  for (int i = 0; i < n; i++)
    bexp_norm_one(table, digits, n, nw, i, out + (size_t)i * 16);
}

// K16: p, q, out: x, y, z, t [n][16] u32 Montgomery limbs each
void host_mont_add(const uint32_t *px, const uint32_t *py, const uint32_t *pz,
                   const uint32_t *pt, const uint32_t *qx, const uint32_t *qy,
                   const uint32_t *qz, const uint32_t *qt, uint32_t *ox,
                   uint32_t *oy, uint32_t *oz, uint32_t *ot, int n) {
  MontCoords p = {px, py, pz, pt};
  MontCoords q = {qx, qy, qz, qt};
  MontCoordsOut o = {ox, oy, oz, ot};
  for (int i = 0; i < n; i++) mont_add_one(p, q, o, (size_t)i);
}

// field ops on single values (4 u64 limbs each), for edge-value checks
void host_fe_mul(const uint64_t *a, const uint64_t *b, uint64_t *r) {
  fe x, y, z;
  fe_load(x, a);
  fe_load(y, b);
  fe_mul(z, x, y);
  fe_store(r, z);
}

void host_fe_add(const uint64_t *a, const uint64_t *b, uint64_t *r) {
  fe x, y, z;
  fe_load(x, a);
  fe_load(y, b);
  fe_add(z, x, y);
  fe_store(r, z);
}

void host_fe_sub(const uint64_t *a, const uint64_t *b, uint64_t *r) {
  fe x, y, z;
  fe_load(x, a);
  fe_load(y, b);
  fe_sub(z, x, y);
  fe_store(r, z);
}

void host_fe_canon(const uint64_t *a, uint64_t *r) {
  fe x, z;
  fe_load(x, a);
  fe_canon(z, x);
  fe_store(r, z);
}

void host_fe_inv(const uint64_t *a, uint64_t *r) {
  fe x, z;
  fe_load(x, a);
  fe_inv(z, x);
  fe_store(r, z);
}

void host_fe_inv_var(const uint64_t *a, uint64_t *r) {
  fe x, z;
  fe_load(x, a);
  fe_inv_var(z, x);
  fe_store(r, z);
}

// the encoding launch of K5, K7 and K8: n input rows -> working rows
void host_bn_encode(const uint64_t *in, uint64_t *out, int n) {
  for (int i = 0; i < n; i++) bn_encode_one(in + (size_t)i * 12,
                                            out + (size_t)i * 12);
}

// K5's first launch: n input rows [n][12] -> tbl [n][8][12]
void host_bn_table(const uint64_t *in, uint64_t *tbl, long long n) {
  for (long long i = 0; i < n; i++) bn_table_one(in + i * 12, tbl + i * 96);
}

// K5's second launch, as host_msm_accum: tbl [B][n][8][12], digits
// [B][nw/2][n] -> acc [B][nw][S][12]
void host_bn_msm_accum(const uint64_t *tbl, const uint8_t *digits, int B,
                       int n, int nw, int S, uint64_t *acc) {
  for (int b = 0; b < B; b++)
    for (int w = 0; w < nw; w++)
      for (int s = 0; s < S; s++)
        bn_msm_accum_one(tbl + (size_t)b * n * 96,
                         digits + (size_t)b * (nw / 2) * n,
                         acc + ((size_t)(b * nw + w) * S + s) * 12, n, w, s,
                         S);
}

// K6 with R chunks a window, L lanes a group and P window groups:
// acc [B][nw][S][12] -> part [B][nw][R][12] (scratch) -> out [B][12].  A
// chunk's partial is summed in order, then host_tail_combine
void host_bn_msm_tail(const uint64_t *acc, uint64_t *part, uint64_t *out,
                      int B, int nw, int S, int R, int L, int P) {
  int chunk = (S + R - 1) / R;
  for (int b = 0; b < B; b++)
    for (int w = 0; w < nw; w++)
      for (int r = 0; r < R; r++) {
        g1p sum;
        g1_identity(sum);
        for (int s = r * chunk; s < S && s < (r + 1) * chunk; s++) {
          g1p p, t;
          g1_load(p, acc + ((size_t)(b * nw + w) * S + s) * 12);
          g1_add(t, sum, p);
          sum = t;
        }
        g1_store(part + ((size_t)(b * nw + w) * R + r) * 12, sum);
      }
  host_tail_combine<g1_coop, fp>(part, out, B, nw, R, L, L, P, 4);
}

// one of K6's group operations on L lanes, run lane by lane: out = p + q
// (op 0) or 2 p (op 1); working rows [12]
void host_bn_coop(int op, int L, const uint64_t *p, const uint64_t *q,
                  uint64_t *out) {
  g1_coop s;
  CoopLanes ex = {0, L, 0};
  coop_load_row(s.v, p, 0, 1);
  coop_load_row(s.v + 3, q, 0, 1);
  fp_zero(s.v[6]);
  if (op == 0) {
    coop_add(ex, s);
  } else {
    coop_dbl(ex, s);
  }
  g1p r;
  r.X = s.v[0];
  r.Y = s.v[1];
  r.Z = s.v[2];
  g1_store(out, r);
}

// K5 then K6 for one batch: pts [n][12] input rows, tbl [n][8][12]
// scratch, digits [nw/2][n] -> out [12] (wsum [nw][12]: K6's partials at
// R = 1)
void host_bn_msm(const uint64_t *pts, uint64_t *tbl, const uint8_t *digits,
                 int n, int nw, int S, uint64_t *acc, uint64_t *wsum,
                 uint64_t *out) {
  host_bn_table(pts, tbl, n);
  for (int w = 0; w < nw; w++)
    for (int s = 0; s < S; s++)
      bn_msm_accum_one(tbl, digits, acc + ((size_t)w * S + s) * 12, n, w,
                       s, S);
  host_bn_msm_tail(acc, wsum, out, 1, nw, S, 1, 4, 8);
}

// K7 with G threads: gl, gr [n][12] input rows, cdig nd NAF digits,
// pre [n][4], out [n][12]
void host_bn_fold_norm(const uint64_t *gl, const uint64_t *gr,
                       const int8_t *cdig, int nd, int G, uint64_t *pre,
                       uint64_t *out, int n) {
  for (int g = 0; g < G; g++)
    bn_fold_group(gl, gr, cdig, nd, n, g, G, pre, out);
}

// K8 with G threads: table [nw*9][12] input rows, work [nw*9][12],
// pre [n][4], out [n][12]
void host_bn_comb_norm(const uint64_t *table, uint64_t *work,
                       const uint8_t *digits, int n, int nw, int G,
                       uint64_t *pre, uint64_t *out) {
  for (int r = 0; r < nw * 9; r++)
    bn_encode_affine_one(table + (size_t)r * 12, work + (size_t)r * 12);
  for (int g = 0; g < G; g++)
    bn_comb_group(work, digits, n, nw, g, G, pre, out);
}

// BN field ops on single canonical values (4 u64 limbs each)
void host_fp_mul(const uint64_t *a, const uint64_t *b, uint64_t *r) {
  fp x, y, z;
  fp_load(x, a);
  fp_load(y, b);
  fp_mul(z, x, y);
  fp_store(r, z);
}

void host_fp_add(const uint64_t *a, const uint64_t *b, uint64_t *r) {
  fp x, y, z;
  fp_load(x, a);
  fp_load(y, b);
  fp_add(z, x, y);
  fp_store(r, z);
}

void host_fp_sub(const uint64_t *a, const uint64_t *b, uint64_t *r) {
  fp x, y, z;
  fp_load(x, a);
  fp_load(y, b);
  fp_sub(z, x, y);
  fp_store(r, z);
}

void host_fp_mul_b3(const uint64_t *a, uint64_t *r) {
  fp x, z;
  fp_load(x, a);
  fp_mul_b3(z, x);
  fp_store(r, z);
}

void host_fp_inv(const uint64_t *a, uint64_t *r) {
  fp x, z;
  fp_load(x, a);
  fp_inv(z, x);
  fp_store(r, z);
}

// the twist kernels' first launches: n input rows -> working rows
void host_bn2_encode(const uint64_t *in, uint64_t *out, int n) {
  for (int i = 0; i < n; i++)
    bn2_encode_one(in + (size_t)i * BN2_ROW, out + (size_t)i * BN2_ROW);
}

// K9's first two launches, the second with G threads: pts [rows][24]
// input rows -> tbl [rows][8][16] affine entries, pre [rows][8][16] scratch
void host_bn2_table(const uint64_t *pts, uint64_t *tbl, uint64_t *pre,
                    long long rows, int G) {
  for (long long i = 0; i < rows; i++)
    bn2_table_one(pts + i * BN2_ROW, tbl + i * 8 * BN2_ENTRY,
                  pre + i * 8 * BN2_ENTRY);
  for (int g = 0; g < G; g++) bn2_table_norm_group(tbl, pre, rows, g, G);
}

// K9's second launch: tbl [B][n][8][16], digits [B][nw/2][n] ->
// acc [B][nw][S][24]
void host_bn2_msm_accum(const uint64_t *tbl, const uint8_t *digits, int B,
                        int n, int nw, int S, uint64_t *acc) {
  for (int b = 0; b < B; b++)
    for (int w = 0; w < nw; w++)
      for (int s = 0; s < S; s++)
        bn2_msm_accum_one(tbl + (size_t)b * n * 8 * BN2_ENTRY,
                          digits + (size_t)b * (nw / 2) * n,
                          acc + ((size_t)(b * nw + w) * S + s) * BN2_ROW, n,
                          w, s, S);
}

// K10 with R chunks a window, L lanes a group of the windows' sums, Lc
// lanes a group of the Horners and the shift, and P window groups, as
// host_bn_msm_tail: acc [B][nw][S][24] -> part [B][nw][R][24] (scratch) ->
// out [B][24]
void host_bn2_msm_tail(const uint64_t *acc, uint64_t *part, uint64_t *out,
                       int B, int nw, int S, int R, int L, int Lc, int P) {
  int chunk = (S + R - 1) / R;
  for (int b = 0; b < B; b++)
    for (int w = 0; w < nw; w++)
      for (int r = 0; r < R; r++) {
        g2p sum;
        g2_identity(sum);
        for (int s = r * chunk; s < S && s < (r + 1) * chunk; s++) {
          g2p p;
          g2_load(p, acc + ((size_t)(b * nw + w) * S + s) * BN2_ROW);
          g2_add(sum, sum, p);
        }
        g2_store(part + ((size_t)(b * nw + w) * R + r) * BN2_ROW, sum);
      }
  host_tail_combine<g2_coop, fp2>(part, out, B, nw, R, L, Lc, P, 4);
}

// one of K10's group operations on L lanes, run lane by lane: out = p + q
// (op 0) or 2 p (op 1); working rows [24]
void host_bn2_coop(int op, int L, const uint64_t *p, const uint64_t *q,
                   uint64_t *out) {
  g2_coop s;
  CoopLanes ex = {0, L, 0};
  coop_load_row(s.v, p, 0, 1);
  coop_load_row(s.v + 3, q, 0, 1);
  fp2_zero(s.v[6]);
  if (op == 0) {
    coop_add(ex, s);
  } else {
    coop_dbl(ex, s);
  }
  g2p r;
  r.X = s.v[0];
  r.Y = s.v[1];
  r.Z = s.v[2];
  g2_store(out, r);
}

// K9 then K10 for one batch: pts [n][24] input rows, tbl and pre
// [n][8][16], digits [nw/2][n] -> out [24] (part [nw][24]: K10's
// partials at R = 1)
void host_bn2_msm(const uint64_t *pts, uint64_t *tbl, uint64_t *pre,
                  const uint8_t *digits, int n, int nw, int S, uint64_t *acc,
                  uint64_t *part, uint64_t *out) {
  host_bn2_table(pts, tbl, pre, n, n < 3 ? n : 3);
  host_bn2_msm_accum(tbl, digits, 1, n, nw, S, acc);
  host_bn2_msm_tail(acc, part, out, 1, nw, S, 1, 8, 16, 8);
}

// K11 with G threads: table [nw*9][24] input rows, work [nw*9][24],
// pre [n][8], out [n][24]
void host_bn2_bexp(const uint64_t *table, uint64_t *work,
                   const uint8_t *digits, int n, int nw, int G,
                   uint64_t *pre, uint64_t *out) {
  for (int r = 0; r < nw * 9; r++)
    bn2_encode_affine_one(table + (size_t)r * BN2_ROW,
                          work + (size_t)r * BN2_ROW);
  for (int g = 0; g < G; g++)
    bn2_bexp_group(work, digits, n, nw, g, G, pre, out);
}

// K12 with G threads: gl, gr [n][24] input rows, cdig nd NAF digits,
// pre [n][8], out [n][24]
void host_bn2_fold_norm(const uint64_t *gl, const uint64_t *gr,
                        const int8_t *cdig, int nd, int G, uint64_t *pre,
                        uint64_t *out, int n) {
  for (int g = 0; g < G; g++)
    bn2_fold_group(gl, gr, cdig, nd, n, g, G, pre, out);
}

// GF(p^2) ops on single canonical values (8 u64 limbs each: c0, c1)
void host_fp2_mul(const uint64_t *a, const uint64_t *b, uint64_t *r) {
  fp2 x, y, z;
  fp2_load(x, a);
  fp2_load(y, b);
  fp2_mul(z, x, y);
  fp2_store(r, z);
}

void host_fp2_sq(const uint64_t *a, uint64_t *r) {
  fp2 x, z;
  fp2_load(x, a);
  fp2_sq(z, x);
  fp2_store(r, z);
}

void host_fp2_mul_b3(const uint64_t *a, uint64_t *r) {
  fp2 x, z;
  fp2_load(x, a);
  fp2_mul_b3(z, x);
  fp2_store(r, z);
}

void host_fp2_inv(const uint64_t *a, uint64_t *r) {
  fp2 x, z;
  fp2_load(x, a);
  fp2_inv(z, x);
  fp2_store(r, z);
}

// P1: n lanes of `iters` steps of op (u32 for ops 0-2, f32 for op 3)
void host_probe_vpu(int op, const void *x, const void *y, void *out, int n,
                    int iters) {
  const uint32_t *xu = (const uint32_t *)x, *yu = (const uint32_t *)y;
  uint32_t *ou = (uint32_t *)out;
  const float *xf = (const float *)x, *yf = (const float *)y;
  float *of = (float *)out;
  for (int i = 0; i < n; i++) {
    switch (op) {
      case VPU_U32_MUL_SPLIT: ou[i] = vpu_steps<VPU_U32_MUL_SPLIT>(xu[i], yu[i], iters); break;
      case VPU_U32_MUL: ou[i] = vpu_steps<VPU_U32_MUL>(xu[i], yu[i], iters); break;
      case VPU_U32_ADD: ou[i] = vpu_steps<VPU_U32_ADD>(xu[i], yu[i], iters); break;
      default: of[i] = vpu_steps<VPU_F32_FMA>(xf[i], yf[i], iters); break;
    }
  }
}

// P2: word-major [8][n] operands, `iters` steps of product op
void host_probe_field(int op, const uint32_t *x, const uint32_t *y,
                      uint32_t *out, int n, int iters) {
  Mont25519 k = mont25519_consts();
  for (int i = 0; i < n; i++) {
    fe a, b;
    fe_load_words(a, x, n, i);
    fe_load_words(b, y, n, i);
    if (op == FIELD_MUL25519) field_steps<FIELD_MUL25519>(a, b, k, iters);
    else if (op == FIELD_MONT25519) field_steps<FIELD_MONT25519>(a, b, k, iters);
    else field_steps<FIELD_FP254>(a, b, k, iters);
    fe_store_words(out, a, n, i);
  }
}

// P3: a, out [chains][8][n]; b [8][n]; chains 1 or 4
void host_probe_chain(int chains, const uint32_t *a, const uint32_t *b,
                      uint32_t *out, int n, int iters) {
  for (int i = 0; i < n; i++) {
    fe x[4], y;
    for (int c = 0; c < chains; c++) fe_load_words(x[c], a + (size_t)c * 8 * n, n, i);
    fe_load_words(y, b, n, i);
    if (chains == 4) chain_steps<4>(x, y, iters);
    else chain_steps<1>(x, y, iters);
    for (int c = 0; c < chains; c++) fe_store_words(out + (size_t)c * 8 * n, x[c], n, i);
  }
}

// P4: n elements of `steps` steps of x * y + 1
void host_probe_raw(const uint32_t *x, const uint32_t *y, uint32_t *out, int n,
                    int steps) {
  for (int i = 0; i < n; i++) out[i] = vpu_steps<VPU_U32_MUL>(x[i], y[i], steps);
}

// the p25519 Montgomery product on four u64 limbs
void host_mont25519_mul(const uint64_t *a, const uint64_t *b, uint64_t *r) {
  fe x, y, z;
  fe_load(x, a);
  fe_load(y, b);
  mont25519_mul(z, x, y, mont25519_consts());
  fe_store(r, z);
}

}  // extern "C"
