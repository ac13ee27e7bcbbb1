#!/usr/bin/env python3
"""Design variants of the kernels K2-K4 and K6-K14, timed on the card
against the committed kernels on the same inputs.

    python3 chip_variants.py [--log2 17] [--reps 3] [--only NAME ...]
                             [--parent DIR]

A variant is a committed kernel source (``csrc/msm_tail.cu``,
``csrc/fold.cu``, ``csrc/comb.cu``, ``csrc/bn_msm_tail.cu``,
``csrc/bn2_bexp.cu``, ``csrc/bn_comb.cu``, ``csrc/bn2_msm_accum.cu``,
``csrc/bn2_msm_tail.cu``, ``csrc/bucket_accum.cu``,
``csrc/bucket_reduce.cu``, ``csrc/bn_fold.cu`` or ``csrc/bn2_fold.cu``)
with the few text edits listed in ``VARIANTS``
(a function's body copied from its header and edited counts as one, and
so does a header's text put in place of its ``#include`` with edits),
built alone with nvcc into a library of its own (under the kernels' build
directory).  The committed kernel's wrapper then runs with the variant's
entry points in place of the committed ones, on the same inputs: K2's
accumulators at B = 2, nw = 64, S = 4096 (a flagship round 0's two MSMs
at the default), 2^log2 elements for K3 (the flagship's round 0 at the
default), 2^(log2+1) - 1 exponents for K4 (the flagship's generators at
the default), K6's accumulators at B = 1, nw = 64, S = 4096 (the
Pinocchio path's MSM tail), 2^log2 exponents for K8 and K11 (the
Pinocchio path's, the G1 or the twist generator's comb table), 2^log2
twist points for K9 (the Pinocchio prove's twist MSM) and its
accumulators for K10, 2^(log2+1) points and scalars for K13 (protocol 5's
commitment at the default) and its bucket sums for K14, 2^log2 elements
for K7 and K12 (the Pinocchio path's size).  The variants in
``SPLITS`` run the committed K2, K6 or K10 with another chunk count R a
window, the ``ENTRIES`` variants K13 with another count of entries a
thread (its bucket sums compared normalized); the ``WAVES`` variants
run the committed K9 with its normalization, K4, K7 or K12 at another
count of threads an SM; the ``POINTS`` variants
run K9 with another count of points a thread, and K10 on its
accumulators (K9 alone, K10 alone and both are timed; the MSM's rows must
agree).  A variant in ``ONE_LIB`` also holds the committed design, and
both are timed from its library.  Every variant's rows must equal
the committed kernel's (K9's accumulators once normalized), and the two
are timed in turns (committed, variant, variant, committed; CUDA events,
best of ``--reps`` each).  The sources keep one design each; the
alternatives that were measured against it live only here.  Prints the
card line, ptxas's lines of the variants, one line per variant and, last,
one JSON object with the times.  With ``--parent DIR`` it also times K2,
K3, K4 and K6-K14 of this checkout against those of the checkout at DIR
(an earlier commit, unpacked there), each in a process of its own, in
turns, prints both checkouts' ptxas lines of K2, K4, K6, K7, K10, K12,
K13 and K14, and logs the peak device memory of the bucket MSM's layout
and kernels at 2^18 points in each.
Imports neither jax nor the JAX package, and fails without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import random
import sys

import chip_smoke as smoke

HERE = os.path.dirname(os.path.abspath(__file__))

INCLUDES = '#include "launch.cuh"\n'
K11_SMEM_BYTES = "(size_t)64 * 9 * BN2_ROW * sizeof(uint64_t)"
K8_SMEM_BYTES = "(size_t)64 * 9 * 12 * sizeof(uint64_t)"


def shared_table(kernel: str, body: str, table: str, row: str,
                 smem: str) -> list:
    """Edits that copy a kernel's table (argument ``table``, rows of
    ``row`` words) into dynamic shared memory, every block before its
    threads start, and size the launch and the occupancy query for it."""
    return [
        ("  int g = blockIdx.x * blockDim.x + threadIdx.x;\n"
         f"  if (g < G) {body}({table},",
         "  extern __shared__ uint64_t sh[];\n"
         f"  for (int j = threadIdx.x; j < nw * 9 * {row}; j += blockDim.x)\n"
         f"    sh[j] = {table}[j];\n  __syncthreads();\n"
         "  int g = blockIdx.x * blockDim.x + threadIdx.x;\n"
         f"  if (g < G) {body}(sh,"),
        (f"      &blocks, {kernel}, K_THREADS, 0);",
         f"      &blocks, {kernel}, K_THREADS, {smem});"),
        ("  int blocks = 0;\n",
         f"  int blocks = 0;\n  cudaFuncSetAttribute({kernel}, "
         f"cudaFuncAttributeMaxDynamicSharedMemorySize, (int){smem});\n"),
        (f"  {kernel}<<<blocks_for(G, K_THREADS), K_THREADS, 0, s>>>(",
         f"  {kernel}<<<blocks_for(G, K_THREADS), K_THREADS, {smem}, s>>>("),
    ]


# K11's comb with the complete projective add (42 products) in place of the
# mixed add (39)
K11_FULL_ADD = INCLUDES + """
FE_FN void bexp_group_full(const uint64_t *tbl, const uint8_t *digits,
                           int n, int nw, int g, int G, uint64_t *pre,
                           uint64_t *out) {
  for (int i = g; i < n; i += G) {
    g2p acc;
    int d = digit_at(digits, n, 0, i);
    g2_load(acc, tbl + (size_t)(d < 0 ? -d : d) * BN2_ROW);
    if (d < 0) g2_neg(acc);
    for (int w = 1; w < nw; w++) {
      d = digit_at(digits, n, w, i);
      if (d == 0) continue;
      g2p q;
      g2_load(q, tbl + (size_t)(w * 9 + (d < 0 ? -d : d)) * BN2_ROW);
      if (d < 0) g2_neg(q);
      g2_add(acc, acc, q);
    }
    g2_store(out + (size_t)i * BN2_ROW, acc);
  }
  bn2_normalize_group(out, pre, n, g, G);
}
"""

# K8's comb with the complete projective add (12 products) in place of the
# mixed add (11)
K8_FULL_ADD = INCLUDES + """
FE_FN void comb_group_full(const uint64_t *table, const uint8_t *digits,
                           int n, int nw, int g, int G, uint64_t *pre,
                           uint64_t *out) {
  for (int i = g; i < n; i += G) {
    g1p acc;
    int d = digit_at(digits, n, 0, i);
    g1_load(acc, table + (size_t)(d < 0 ? -d : d) * 12);
    if (d < 0) g1_neg(acc);
    for (int w = 1; w < nw; w++) {
      d = digit_at(digits, n, w, i);
      if (d == 0) continue;
      g1p sel, t;
      g1_load(sel, table + (size_t)(w * 9 + (d < 0 ? -d : d)) * 12);
      if (d < 0) g1_neg(sel);
      g1_add(t, acc, sel);
      acc = t;
    }
    g1_store(out + (size_t)i * 12, acc);
  }
  bn_normalize_group(out, pre, n, g, G);
}
"""


# K11's normalization in a launch of its own, after the sums: the comb
# kernel then holds no inversion code
K11_SPLIT = INCLUDES + """
FE_FN void bexp_group_sums(const uint64_t *tbl, const uint8_t *digits,
                           int n, int nw, int g, int G, uint64_t *out) {
  fp2 z;
  fp2_load(z, tbl + BN2_ROW + 16);
  int windows = fp2_is_zero(z) ? 1 : nw;
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
}

__global__ void bn2_norm_kernel(uint64_t *out, uint64_t *pre, int n,
                                int G) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < G) bn2_normalize_group(out, pre, n, g, G);
}
"""


def per_exponent(encode: str) -> tuple:
    """The edit that launches one thread per exponent (G = n), each with
    its own inversion: the kernel before the batched normalization."""
    return (f"  cudaStream_t s = (cudaStream_t)stream;\n  {encode}",
            f"  cudaStream_t s = (cudaStream_t)stream;\n  G = n;\n  {encode}")


def inline_header(header: str, edits):
    """An edit that puts the text of csrc/``header``, with the text edits
    (old, new) applied wherever they occur (each must), in place of its
    ``#include``: a variant of functions that the kernel reaches through
    overloads (K2's ed_coop steps) or through its body (K4's)."""
    def edit(text: str) -> str:
        with open(os.path.join(HERE, "verifiable_mpc_tpu_torch", "csrc",
                               header)) as f:
            body = f.read().replace("#pragma once\n", "")
        for old, new in edits:
            if old not in body:
                raise RuntimeError(f"{header}: no {old[:50]!r}")
            body = body.replace(old, new)
        include = f'#include "{header}"\n'
        if text.count(include) != 1:
            raise RuntimeError(f"the source includes {header} "
                               f"{text.count(include)} times")
        return text.replace(include, body)
    return edit


def body_copy(header: str, fn: str, name: str, edits) -> str:
    """The function ``fn`` of csrc/``header``, renamed ``name``, with the
    text edits (old, new) applied (each anchor must occur in it).  Read
    from this checkout's sources without importing its package, which
    ``--kernel-times`` may take from another checkout."""
    with open(os.path.join(HERE, "verifiable_mpc_tpu_torch", "csrc",
                           header)) as f:
        text = f.read()
    start = text.index(f"FE_FN void {fn}(")
    body = text[start:text.index("\n}\n", start) + 3]
    body = body.replace(f"FE_FN void {fn}(", f"FE_FN void {name}(")
    for old, new in edits:
        if old not in body:
            raise RuntimeError(f"{fn}: no {old[:50]!r}")
        body = body.replace(old, new)
    return body


# c (4 x u64, below 2^253) <- its nd NAF digits (most significant first):
# the host side of the K3 variants that recode c themselves
K3_REBUILD = """
static void naf_value(const int8_t *cdig, int nd, uint64_t *c) {
  for (int j = 0; j < 4; j++) c[j] = 0;
  for (int b = 0; b < nd; b++) {
    for (int j = 3; j > 0; j--) c[j] = (c[j] << 1) | (c[j - 1] >> 63);
    c[0] <<= 1;
    int64_t d = cdig[b];
    unsigned __int128 carry = 0;
    for (int j = 0; j < 4; j++) {
      uint64_t add = j ? (d < 0 ? ~0ull : 0) : (uint64_t)d;
      carry += (unsigned __int128)c[j] + add;
      c[j] = (uint64_t)carry;
      carry >>= 64;
    }
  }
}
"""


# K3 over signed radix-16 digits in [-7, 8] (about 60 adds, 4 doublings a
# window) with the table of the multiples 1..8, the design first written
# for this kernel; the entry point recodes c from the NAF digits
K3_RADIX16 = INCLUDES + K3_REBUILD + """
struct Digits64 {
  int8_t d[64];
};

FE_FN void fold_group_radix16(const uint64_t *gl, const uint64_t *gr,
                              const int8_t *cdig, int nw, int n, int g,
                              int G, uint64_t *pre, uint64_t *out) {
  int first = 0;
  while (first < nw && cdig[first] == 0) first++;
  for (int i = g; i < n; i += G) {
    ge_ext acc;
    if (first < nw) {
      ge_pre tbl[8];
      ge_ext p;
      ge_load(p, gl + (size_t)i * 16);
      ge_pre p1;
      ge_to_pre(p1, p);
      ge_multiples_pre(p, p1, p1, 8,
                       [&](int k, const ge_pre &e) { tbl[k] = e; });
      int d = cdig[first];
      ge_pre q = tbl[(d < 0 ? -d : d) - 1];
      if (d < 0) ge_pre_neg(q);
      ge_pre_to_ext(acc, q);
      for (int w = first + 1; w < nw; w++) {
        for (int k = 0; k < 3; k++) ge_dbl_no_t(acc, acc);
        d = cdig[w];
        if (d != 0 || w == nw - 1) {
          ge_dbl(acc, acc);
        } else {
          ge_dbl_no_t(acc, acc);
        }
        if (d != 0) {
          ge_ext t;
          ge_add_pre_signed(t, acc, tbl[(d < 0 ? -d : d) - 1], d < 0);
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

__global__ void fold_radix16_kernel(const uint64_t *gl, const uint64_t *gr,
                                    Digits64 c, int n, int G, uint64_t *pre,
                                    uint64_t *out) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < G) fold_group_radix16(gl, gr, c.d, 64, n, g, G, pre, out);
}
"""


def k3_radix16(text: str) -> str:
    old = text[text.index("  FoldDigits c;\n"):text.index(
        "  return (int)cudaGetLastError();\n}", text.index("FoldDigits c;"))]
    new = """  uint64_t v[4];
  naf_value(cdig, nd, v);
  Digits64 c;
  int carry = 0;
  for (int w = 0; w < 64; w++) {  // least significant window first
    int d = (int)((v[w >> 4] >> (4 * (w & 15))) & 15) + carry;
    carry = d > 8;
    c.d[63 - w] = (int8_t)(d - 16 * carry);
  }
  fold_radix16_kernel<<<blocks_for(G, K_THREADS), K_THREADS, 0,
                        (cudaStream_t)stream>>>(gl, gr, c, n, G, pre, out);
"""
    return text.replace(INCLUDES, K3_RADIX16).replace(old, new)


# K3 over a width-4 NAF (about 51 adds) with a table of the odd multiples
# 1, 3, 5, 7 (512 bytes); the entry point recodes c from the width-5 NAF
K3_WNAF4 = INCLUDES + K3_REBUILD + """
FE_FN void fold_group_wnaf4(const uint64_t *gl, const uint64_t *gr,
                            const int8_t *naf, int top, int n, int g, int G,
                            uint64_t *pre, uint64_t *out) {
  for (int i = g; i < n; i += G) {
    ge_ext acc;
    if (top >= 0) {
      ge_pre tbl[4], p1, step, q;
      ge_ext p, p2;
      ge_load(p, gl + (size_t)i * 16);
      ge_to_pre(p1, p);
      ge_dbl(p2, p);
      ge_to_pre(step, p2);
      ge_multiples_pre(p, p1, step, 4,
                       [&](int k, const ge_pre &e) { tbl[k] = e; });
      int d = naf[top];
      q = tbl[((d < 0 ? -d : d) - 1) >> 1];
      if (d < 0) ge_pre_neg(q);
      ge_pre_to_ext(acc, q);
      for (int b = top - 1; b >= 0; b--) {
        d = naf[b];
        if (d != 0 || b == 0) {
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

struct Naf256 {
  int8_t d[256];
};

__global__ void fold_wnaf4_kernel(const uint64_t *gl, const uint64_t *gr,
                                  Naf256 c, int top, int n, int G,
                                  uint64_t *pre, uint64_t *out) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < G) fold_group_wnaf4(gl, gr, c.d, top, n, g, G, pre, out);
}
"""


def k3_wnaf4(text: str) -> str:
    old = text[text.index("  FoldDigits c;\n"):text.index(
        "  return (int)cudaGetLastError();\n}", text.index("FoldDigits c;"))]
    new = """  uint64_t v[4];
  naf_value(cdig, nd, v);
  Naf256 c;
  int top = -1;
  for (int b = 0; b < 256; b++) {  // least significant digit first
    int d = 0;
    if (v[0] & 1) {
      d = (int)(v[0] & 15);
      if (d >= 8) d -= 16;
      unsigned __int128 br = 0;
      for (int j = 0; j < 4; j++) {  // v -= d
        uint64_t sub = j ? (d < 0 ? ~0ull : 0) : (uint64_t)(int64_t)d;
        unsigned __int128 x = (unsigned __int128)v[j] - sub - br;
        v[j] = (uint64_t)x;
        br = (x >> 64) & 1;
      }
    }
    c.d[b] = (int8_t)d;
    if (d) top = b;
    for (int j = 0; j < 3; j++) v[j] = (v[j] >> 1) | (v[j + 1] << 63);
    v[3] >>= 1;
  }
  fold_wnaf4_kernel<<<blocks_for(G, K_THREADS), K_THREADS, 0,
                      (cudaStream_t)stream>>>(gl, gr, c, top, n, G, pre, out);
"""
    return text.replace(INCLUDES, K3_WNAF4).replace(old, new)


# K3's doublings all with T (8 products, as before the redesign)
def k3_full_dbl():
    return INCLUDES + body_copy(
        "ed25519_kernels.cuh", "fold_group", "fold_group_full_dbl", [
            ("        } else {\n          ge_dbl_no_t(acc, acc);\n",
             "        } else {\n          ge_dbl(acc, acc);\n")])


# K3 with a negated copy of a negative digit's entry (ge_pre_neg, then the
# mixed add) in place of the signed add's operand picking
def k3_neg_copy():
    return INCLUDES + body_copy(
        "ed25519_kernels.cuh", "fold_group", "fold_group_neg_copy", [
            ("          ge_add_pre_signed(t, acc, tbl[((d < 0 ? -d : d) - 1) "
             ">> 1], d < 0);\n",
             "          q = tbl[((d < 0 ? -d : d) - 1) >> 1];\n"
             "          if (d < 0) ge_pre_neg(q);\n"
             "          ge_add_pre(t, acc, q);\n")])


# K3's thread count G: the wrapper's one wave of FOLD_SM_THREADS["fold"]
# (256) an SM replaced by n threads of one element each (an inversion an
# element), or by one wave of ``per_sm`` threads an SM (0: all that the
# registers allow, 384)
K3_PER_ELEMENT = ("  FoldDigits c;\n", "  FoldDigits c;\n  G = n;\n")


def k3_wave(per_sm: int) -> tuple:
    cap = ("blocks * K_THREADS" if not per_sm
           else f"{per_sm}")
    return ("  FoldDigits c;\n", f"""  FoldDigits c;
  {{
    int dev = 0, sms = 0, blocks = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fold_norm_kernel,
                                                  K_THREADS, 0);
    long long wave = (long long)({cap}) * sms;
    G = wave < n ? (int)wave : n;
  }}
""")


# K3 with the SM's L1/shared split set to the most L1 (its 1 KB tables a
# thread live in local memory, cached there)
K3_MAX_L1 = ("  FoldDigits c;\n",
             "  cudaFuncSetAttribute(fold_norm_kernel, "
             "cudaFuncAttributePreferredSharedMemoryCarveout, 0);\n"
             "  FoldDigits c;\n")


# K7 and K12 (csrc/bn_fold.cu, csrc/bn2_fold.cu) over the parent's
# unsigned radix-16 windows with its 0..15 table (14 adds), from the first
# nonzero window, with the committed group normalization; the entry point
# recodes c from the NAF digits.  {p}: the curve's prefix (g1 or g2), {b}
# the kernels' (bn or bn2), {row} a row's words, {bounds} the committed
# kernel's __launch_bounds__ (K12's), so that its wave fits.
BN_FOLD_RADIX16 = """
struct Windows64 {{
  uint8_t d[64];
}};

FE_FN void {b}_fold_group_radix16(const uint64_t *gl, const uint64_t *gr,
                                  const uint8_t *cdig, int n, int g, int G,
                                  uint64_t *pre, uint64_t *out) {{
  int first = 0;
  while (first < 64 && cdig[first] == 0) first++;
  for (int i = g; i < n; i += G) {{
    {p}p acc, t;
    if (first < 64) {{
      {p}p tbl[16];
      {p}_identity(tbl[0]);
      {p}_load_jacobian(tbl[1], gl + (size_t)i * {row});
      for (int m = 2; m < 16; m++) {p}_add(tbl[m], tbl[m - 1], tbl[1]);
      acc = tbl[cdig[first]];
      for (int w = first + 1; w < 64; w++) {{
        for (int k = 0; k < 4; k++) {{
          {p}_dbl(t, acc);
          acc = t;
        }}
        int d = cdig[w];
        if (d) {{
          {p}_add(t, acc, tbl[d]);
          acc = t;
        }}
      }}
    }} else {{
      {p}_identity(acc);
    }}
    {p}p r;
    {p}_load_jacobian(r, gr + (size_t)i * {row});
    {p}_add(t, acc, r);
    {p}_store(out + (size_t)i * {row}, t);
  }}
  {b}_normalize_group(out, pre, n, g, G);
}}

__global__ void {bounds}{b}_fold_radix16_kernel(const uint64_t *gl,
                                        const uint64_t *gr, Windows64 c,
                                        int n, int G, uint64_t *pre,
                                        uint64_t *out) {{
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < G) {b}_fold_group_radix16(gl, gr, c.d, n, g, G, pre, out);
}}
"""


def fold_bounds(b: str) -> str:
    """The committed K7's (none) or K12's __launch_bounds__."""
    return "__launch_bounds__(K_THREADS, FOLD2_BLOCKS) " if b == "bn2" else ""


def bn_fold_radix16(b: str, p: str, row: str):
    """The edit of ``{b}_fold.cu`` to BN_FOLD_RADIX16."""
    def edit(text: str) -> str:
        old = text[text.index("  FoldDigits c;\n"):text.index(
            "  return (int)cudaGetLastError();\n}",
            text.index("FoldDigits c;"))]
        new = f"""  uint64_t v[4];
  naf_value(cdig, nd, v);
  Windows64 c;
  for (int w = 0; w < 64; w++)  // most significant window first
    c.d[63 - w] = (uint8_t)((v[w >> 4] >> (4 * (w & 15))) & 15);
  {b}_fold_radix16_kernel<<<blocks_for(G, K_THREADS), K_THREADS, 0,
                            (cudaStream_t)stream>>>(gl, gr, c, n, G, pre,
                                                    out);
"""
        return text.replace(INCLUDES, INCLUDES + K3_REBUILD
                            + BN_FOLD_RADIX16.format(b=b, p=p, row=row,
                                                     bounds=fold_bounds(b))
                            ).replace(old, new)
    return edit


# K7 and K12 with the encoding in launches of their own, as in the parent:
# both inputs' working rows in a scratch of 2n rows (allocated once and
# kept, as PyTorch's caching allocator kept the parent's), which the fold
# body then loads as they are
def bn_fold_encoded(b: str, p: str, row: str, header: str):
    body = body_copy(header, f"{b}_fold_group", f"{b}_fold_group_encoded", [
        (f"{p}_load_jacobian(tbl[0], gl", f"{p}_load(tbl[0], gl"),
        (f"{p}_load_jacobian(r, gr", f"{p}_load(r, gr")])
    kernels = f"""
__global__ void {b}_encode_kernel(const uint64_t *in, uint64_t *out,
                                  long long n) {{
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {b}_encode_one(in + i * {row}, out + i * {row});
}}

__global__ void {fold_bounds(b)}{b}_fold_encoded_kernel(const uint64_t *gl,
                                        const uint64_t *gr, FoldDigits c,
                                        int nd, int n, int G, uint64_t *pre,
                                        uint64_t *out) {{
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < G) {b}_fold_group_encoded(gl, gr, c.d, nd, n, g, G, pre, out);
}}
"""

    def edit(text: str) -> str:
        start = text.index(f"  {b}_fold_norm_kernel<<<")
        old = text[start:text.index("  return (int)cudaGetLastError();\n}",
                                    start)]
        new = f"""  static uint64_t *work = nullptr;
  static size_t cap = 0;
  size_t need = (size_t)2 * n * {row};
  if (need > cap) {{
    cudaFree(work);
    if (cudaMalloc(&work, need * sizeof(uint64_t))) return 2;
    cap = need;
  }}
  cudaStream_t s = (cudaStream_t)stream;
  uint64_t *wl = work, *wr = work + (size_t)n * {row};
  {b}_encode_kernel<<<blocks_for(n, K_THREADS), K_THREADS, 0, s>>>(gl, wl,
                                                                  n);
  {b}_encode_kernel<<<blocks_for(n, K_THREADS), K_THREADS, 0, s>>>(gr, wr,
                                                                  n);
  {b}_fold_encoded_kernel<<<blocks_for(G, K_THREADS), K_THREADS, 0, s>>>(
      wl, wr, c, nd, n, G, pre, out);
"""
        return text.replace(INCLUDES, INCLUDES + body + kernels).replace(
            old, new)
    return edit


# K7 and K12 with one inversion an element (G = n)
BN_FOLD_PER_ELEMENT = ("  FoldDigits c;\n", "  FoldDigits c;\n  G = n;\n")


def launch_bounds(kernel: str, blocks: int) -> tuple:
    """The edit that asks for ``blocks`` blocks of K_THREADS an SM
    (``__launch_bounds__``, which caps the kernel's registers)."""
    return (f"__global__ void {kernel}(",
            f"__global__ void __launch_bounds__(K_THREADS, {blocks})\n"
            f"    {kernel}(")


def fold_wave(blocks: int) -> tuple:
    """The edit that runs K7 or K12 at one wave of ``blocks`` blocks an SM
    whatever G the wrapper asks for (with launch_bounds, a thread count an
    SM that the committed registers do not allow)."""
    return ("  FoldDigits c;\n", f"""  FoldDigits c;
  {{
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    long long wave = (long long){blocks} * K_THREADS * sms;
    G = wave < n ? (int)wave : n;
  }}
""")


# K6's inversion by a sliding window over the bits of p - 2 (odd powers
# a, a^3, ..., a^15: about 255 squarings and 57 multiplies, where the
# square-and-multiply chain takes 255 and 124), renamed into every fp_inv
# call of the BN bodies
K6_INV_WINDOW = """#include "fp254.cuh"

FE_FN void fp_inv_window(fp &r, const fp &a) {
  const uint32_t e[8] = {0x5e089665u, 0x185cac6cu, 0x20b5b59eu, 0xee5b88d1u,
                         0x6184dc21u, 0xaa6fecb8u, 0x4aa387f9u, 0x8fb501e3u};
  fp odd[8], a2, acc;
  odd[0] = a;
  fp_sq(a2, a);
  for (int k = 1; k < 8; k++) fp_mul(odd[k], odd[k - 1], a2);
  bool started = false;
  int i = 255;
  while (i >= 0) {
    if (!((e[i >> 5] >> (i & 31)) & 1)) {
      if (started) fp_sq(acc, acc);
      i--;
      continue;
    }
    int j = i - 3 > 0 ? i - 3 : 0;
    while (!((e[j >> 5] >> (j & 31)) & 1)) j++;
    int val = 0;
    for (int b = i; b >= j; b--) {
      val = 2 * val + ((e[b >> 5] >> (b & 31)) & 1);
      if (started) fp_sq(acc, acc);
    }
    if (started) {
      fp_mul(acc, acc, odd[val >> 1]);
    } else {
      acc = odd[val >> 1];
      started = true;
    }
    i = j - 1;
  }
  r = acc;
}
#define fp_inv fp_inv_window
#include "bn254_kernels.cuh"
"""


# K9's table built with 4 doublings (2P, 4P, 8P, 6P) and 3 adds (3P, 7P,
# 5P), 226 products where 7 adds take 294, at most two points live (P and
# 2P read back from the entries written)
K9_DBL_CHAIN = """
FE_FN void bn2_entry_load(g2p &p, const uint64_t *tbl_e,
                          const uint64_t *pre_e) {
  fp2_load(p.X, tbl_e);
  fp2_load(p.Y, tbl_e + 8);
  fp2_load(p.Z, pre_e);
}

FE_FN void table_dbl_chain(const uint64_t *in_row, uint64_t *tbl,
                           uint64_t *pre) {
  g2p a, b;
  g2_load_jacobian(a, in_row);
  bn2_entry_store(tbl, pre, a);
  for (int m = 2; m <= 8; m *= 2) {
    g2_dbl(a, a);
    bn2_entry_store(tbl + (m - 1) * BN2_ENTRY, pre + (m - 1) * BN2_ENTRY, a);
  }
  bn2_entry_load(a, tbl + BN2_ENTRY, pre + BN2_ENTRY);
  bn2_entry_load(b, tbl, pre);
  g2_add(a, a, b);
  bn2_entry_store(tbl + 2 * BN2_ENTRY, pre + 2 * BN2_ENTRY, a);
  g2_dbl(a, a);
  bn2_entry_store(tbl + 5 * BN2_ENTRY, pre + 5 * BN2_ENTRY, a);
  g2_add(a, a, b);
  bn2_entry_store(tbl + 6 * BN2_ENTRY, pre + 6 * BN2_ENTRY, a);
  bn2_entry_load(a, tbl + 3 * BN2_ENTRY, pre + 3 * BN2_ENTRY);
  g2_add(a, a, b);
  bn2_entry_store(tbl + 4 * BN2_ENTRY, pre + 4 * BN2_ENTRY, a);
}
"""


# K9 as before its redesign: each point's multiples 1..8 as projective
# working rows (192 bytes an entry; the first launch one thread a point)
# and the complete add (42 products) an accumulation; its entry point keeps
# the committed signature and holds the projective table in a buffer of
# its own
K9_PROJECTIVE = """__global__ void __launch_bounds__(K_THREADS, 1)
    bn2_table_proj_kernel(const uint64_t *pts, uint64_t *tbl,
                          long long rows) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  g2p p, cur;
  g2_load_jacobian(p, pts + i * BN2_ROW);
  uint64_t *t = tbl + i * 8 * BN2_ROW;
  g2_store(t, p);
  cur = p;
  for (int m = 2; m <= 8; m++) {
    g2_add(cur, cur, p);
    g2_store(t + (size_t)(m - 1) * BN2_ROW, cur);
  }
}

__global__ void __launch_bounds__(K_THREADS, 1)
    bn2_msm_accum_proj_kernel(const uint64_t *tbl, const uint8_t *digits,
                              uint64_t *acc, int n, int nw, int S) {
  int b = blockIdx.y;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nw * S) return;
  int w = t / S;
  int s = t - w * S;
  const uint64_t *tb = tbl + (size_t)b * n * 8 * BN2_ROW;
  const uint8_t *dg = digits + (size_t)b * (nw / 2) * n;
  g2p a;
  g2_identity(a);
  for (int i = s; i < n; i += S) {
    int d = digit_at(dg, n, w, i);
    if (d == 0) continue;
    g2p q;
    g2_load(q, tb + ((size_t)i * 8 + (d < 0 ? -d : d) - 1) * BN2_ROW);
    if (d < 0) g2_neg(q);
    g2_add(a, a, q);
  }
  g2_store(acc + ((size_t)(b * nw + w) * S + s) * BN2_ROW, a);
}

extern "C" int vmpc_cu_bn2_msm_accum(const uint64_t *pts, uint64_t *tbl,
                                     uint64_t *pre, const uint8_t *digits,
                                     uint64_t *acc, int B, int n, int nw,
                                     int S, int G, void *stream) {
  static uint64_t *proj = nullptr;
  static size_t held = 0;
  long long rows = (long long)B * n;
  size_t need = (size_t)rows * 8 * BN2_ROW * sizeof(uint64_t);
  if (need > held) {
    if (proj) cudaFree(proj);
    int rc = (int)cudaMalloc(&proj, need);
    if (rc) return rc;
    held = need;
  }
  cudaStream_t s = (cudaStream_t)stream;
  bn2_table_proj_kernel<<<blocks_for(rows, K_THREADS), K_THREADS, 0, s>>>(
      pts, proj, rows);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  dim3 grid(blocks_for((long long)nw * S, K_THREADS), B);
  bn2_msm_accum_proj_kernel<<<grid, K_THREADS, 0, s>>>(proj, digits, acc, n,
                                                       nw, S);
  return (int)cudaGetLastError();
}
"""


def k9_projective(text: str) -> str:
    """The committed K9 source with its entry point replaced by the
    projective table's (the committed kernels stay, unlaunched)."""
    start = text.index('extern "C" int vmpc_cu_bn2_msm_accum(')
    return text[:start] + K9_PROJECTIVE


def k9_projective_table_only(text: str) -> str:
    """k9_projective's table launch alone (a timing probe)."""
    return k9_projective(text).replace(
        """  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  dim3 grid(""", """  return (int)cudaGetLastError();
  dim3 grid(""")


def blocks3(text: str) -> str:
    """The projective accumulation asking for 3 blocks an SM."""
    return text.replace(
        "__launch_bounds__(K_THREADS, 1)\n    bn2_msm_accum_proj_kernel",
        "__launch_bounds__(K_THREADS, 3)\n    bn2_msm_accum_proj_kernel")


def k9_projective_blocks3(text: str) -> str:
    """k9_projective with its accumulation asking for 3 blocks an SM."""
    return blocks3(k9_projective(text))


def k9_pair_projective3(text: str) -> str:
    """The committed K9 source and, in the same library, k9_projective_blocks3
    under the entry point vmpc_cu_bn2_msm_accum_alt (ONE_LIB)."""
    return text + blocks3(K9_PROJECTIVE).replace(
        "int vmpc_cu_bn2_msm_accum(", "int vmpc_cu_bn2_msm_accum_alt(")


# timing probes: an entry point that returns after its first launches, so
# that the committed kernel's time less the probe's is its last launch's
# (their rows are not the kernel's and are not compared: NO_ROWS)
K9_TABLE_ONLY = ("""  rc = (int)cudaGetLastError();
  if (rc) return rc;
  dim3 grid(""", """  return (int)cudaGetLastError();
  dim3 grid(""")
K10_REDUCE_ONLY = ("""  rc = (int)cudaGetLastError();
  if (rc) return rc;
  bn2_msm_combine_kernel""", """  return (int)cudaGetLastError();
  bn2_msm_combine_kernel""")
K2_REDUCE_ONLY = ("""  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  msm_combine_kernel""", """  return (int)cudaGetLastError();
  msm_combine_kernel""")

# K2's entry point returning before its launches (what the CUDA events
# around a call see of the wrapper's host work), and its combination
# without the final inversion (rows not normalized)
K2_NO_LAUNCH = ("""  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(nw * R, B);""", """  return 0;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(nw * R, B);""")
K2_NO_INVERSION = inline_header("ed25519_kernels.cuh", [(
    "  fe_inv_var(zinv, s.v[2]);", "  zinv = s.v[2];")])

# K2's reduce without its shared-memory tree (thread 0's partial is
# written: a timing probe of the walk), and with the tree's slots
# word-major (sh[word][thread]: a warp's 32 slots on 32 banks, where the
# committed point-major rows put them all on one)
K2_REDUCE_NO_TREE = (
    "  for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {",
    "  for (int stride = 0; stride > 0; stride >>= 1) {")


def k2_tree_word_major(text: str) -> str:
    helpers = """
__device__ __forceinline__ void tree_store(uint64_t (*sh)[REDUCE_THREADS],
                                           int t, const ge_ext &p) {
  uint64_t row[16];
  ge_store(row, p);
  for (int j = 0; j < 16; j++) sh[j][t] = row[j];
}

__device__ __forceinline__ void tree_load(ge_ext &p,
                                          uint64_t (*sh)[REDUCE_THREADS],
                                          int t) {
  uint64_t row[16];
  for (int j = 0; j < 16; j++) row[j] = sh[j][t];
  ge_load(p, row);
}
"""
    for old, new in (
            ("#define TAIL_WINDOWS 64     // most windows of an MSM (one lane "
             "group each)\n",
             "#define TAIL_WINDOWS 64     // most windows of an MSM (one lane "
             "group each)\n" + helpers),
            ("  __shared__ uint64_t sh[REDUCE_THREADS][16];",
             "  __shared__ uint64_t sh[16][REDUCE_THREADS];"),
            ("  ge_store(sh[threadIdx.x], sum);",
             "  tree_store(sh, threadIdx.x, sum);"),
            ("      ge_load(p, sh[threadIdx.x]);\n"
             "      ge_load(q, sh[threadIdx.x + stride]);",
             "      tree_load(p, sh, threadIdx.x);\n"
             "      tree_load(q, sh, threadIdx.x + stride);"),
            ("      ge_store(sh[threadIdx.x], t);",
             "      tree_store(sh, threadIdx.x, t);"),
            ("        sh[0][threadIdx.x];", "        sh[threadIdx.x][0];")):
        if text.count(old) != 1:
            raise RuntimeError(f"msm_tail.cu: {old[:50]!r}")
        text = text.replace(old, new)
    return text


# K2's final inversion by the Fermat chain (fe_inv, 265 dependent
# products) in place of the binary extended Euclid algorithm
K2_FERMAT = inline_header("ed25519_kernels.cuh", [(
    "  fe_inv_var(zinv, s.v[2]);", "  fe_inv(zinv, s.v[2]);")])

# K2's chain (its products and the Fermat inversion) with column-sum
# products: the 64 limb products independent, their halves summed by
# column (each column below 2^37), one carry pass with the reduction
K2_COLS_FNS = """
FE_FN void fe_reduce_cols(fe &r, const uint64_t *col) {
  uint64_t c = 0;
  for (int k = 0; k < 8; k++) {
    c += col[k] + 38u * col[k + 8];
    r.v[k] = (uint32_t)c;
    c >>= 32;
  }
  fe_fold_carry(r, c);
}

FE_FN void fe_mul_cols(fe &r, const fe &a, const fe &b) {
  uint64_t col[16];
  for (int k = 0; k < 16; k++) col[k] = 0;
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) {
      uint64_t x = (uint64_t)a.v[i] * b.v[j];
      col[i + j] += (uint32_t)x;
      col[i + j + 1] += x >> 32;
    }
  fe_reduce_cols(r, col);
}

FE_FN void fe_sq_cols(fe &r, const fe &a) {
  uint64_t col[16];
  for (int k = 0; k < 16; k++) col[k] = 0;
  for (int i = 0; i < 8; i++) {
    uint64_t x = (uint64_t)a.v[i] * a.v[i];
    col[2 * i] += (uint32_t)x;
    col[2 * i + 1] += x >> 32;
    for (int j = i + 1; j < 8; j++) {
      x = (uint64_t)a.v[i] * a.v[j];
      col[i + j] += (uint64_t)(uint32_t)x << 1;
      col[i + j + 1] += (x >> 32) << 1;
    }
  }
  fe_reduce_cols(r, col);
}

FE_FN void fe_inv_cols(fe &r, const fe &z) {
  fe z2, z9, z11, a, b, t, z2_5_0, z2_10_0, z2_20_0, z2_50_0, z2_100_0;
  auto sqn = [](fe &o, const fe &x, int n) {
    o = x;
    for (int i = 0; i < n; i++) fe_sq_cols(o, o);
  };
  fe_sq_cols(z2, z);
  sqn(t, z2, 2);
  fe_mul_cols(z9, t, z);
  fe_mul_cols(z11, z9, z2);
  fe_sq_cols(t, z11);
  fe_mul_cols(z2_5_0, t, z9);
  sqn(t, z2_5_0, 5);
  fe_mul_cols(z2_10_0, t, z2_5_0);
  sqn(t, z2_10_0, 10);
  fe_mul_cols(z2_20_0, t, z2_10_0);
  sqn(t, z2_20_0, 20);
  fe_mul_cols(a, t, z2_20_0);
  sqn(t, a, 10);
  fe_mul_cols(z2_50_0, t, z2_10_0);
  sqn(t, z2_50_0, 50);
  fe_mul_cols(z2_100_0, t, z2_50_0);
  sqn(t, z2_100_0, 100);
  fe_mul_cols(b, t, z2_100_0);
  sqn(t, b, 50);
  fe_mul_cols(a, t, z2_50_0);
  sqn(t, a, 5);
  fe_mul_cols(r, t, z11);
}
"""
K2_COLS = inline_header("ed25519_kernels.cuh", [
    ('#include "fe25519.cuh"\n', '#include "fe25519.cuh"\n' + K2_COLS_FNS),
    ("    fe_sq(r, a);\n    s.m[k] = r;",
     "    fe_sq_cols(r, a);\n    s.m[k] = r;"),
    ("    fe_mul(r, a, b);\n    s.m[k] = r;",
     "    fe_mul_cols(r, a, b);\n    s.m[k] = r;"),
    ("    fe_mul(r, a, b);\n    s.v[k] = r;",
     "    fe_mul_cols(r, a, b);\n    s.v[k] = r;"),
    ("      fe_mul(r, s.v[k + 3], two_d);",
     "      fe_mul_cols(r, s.v[k + 3], two_d);"),
    ("  fe_inv_var(zinv, s.v[2]);", "  fe_inv_cols(zinv, s.v[2]);")])

# K4 with the projective form's add (ge_add_pre_signed: 2Z2 = 2 read as a
# coordinate, D = Z1 2Z2 a product: 8 products) in place of the affine
# mixed add (7)
K4_PROJECTIVE_ADD = inline_header("ed25519_kernels.cuh", [(
    "      ge_add_aff_signed(acc, acc, q, d < 0);\n",
    """      ge_pre e;
      e.ypx = q.ypx;
      e.ymx = q.ymx;
      e.t2d = q.t2d;
      fe_small(e.z2, 2);
      ge_ext t;
      ge_add_pre_signed(t, acc, e, d < 0);
      acc = t;
""")])


# K4 without T in the add of the last window (the normalization does not
# read it), behind a branch on the window
K4_LAST_NO_T = (
    INCLUDES
    + body_copy("fe25519.cuh", "ge_add_aff_signed", "ge_add_aff_last", [
        ("                             bool neg) {",
         "                             bool neg, bool with_t) {"),
        ("  fe_mul(r.T, e, h);", "  if (with_t) fe_mul(r.T, e, h);")])
    + body_copy("ed25519_kernels.cuh", "comb_group", "comb_group_last", [
        ("ge_add_aff_signed(acc, acc, q, d < 0);",
         "ge_add_aff_last(acc, acc, q, d < 0, w < nw - 1);")]))


# K13 with the signed add's operand picks (ge_add_pre_signed) in place of
# the entry negated in place
K13_SIGNED = inline_header("ed25519_kernels.cuh", [(
    "    if (e < 0) ge_pre_neg(q);\n    ge_ext r;\n    ge_add_pre(r, acc, q);\n",
    "    ge_ext r;\n    ge_add_pre_signed(r, acc, q, e < 0);\n")])
# K13's combination with a block of 128 threads a column in place of a warp
K13_COMBINE_BLOCK = """
__global__ void __launch_bounds__(128)
    bucket_combine_block_kernel(const uint64_t *part, const int32_t *offsets,
                                uint64_t *out, int chunk) {
  __shared__ uint64_t sh[128][16];
  int c = blockIdx.x;
  uint64_t *dst = out + (size_t)c * 16;
  if (offsets[c] == offsets[c + 1]) {
    if (threadIdx.x == 0) {
      ge_ext z;
      ge_identity(z);
      ge_store(dst, z);
    }
    return;
  }
  int np = bucket_partials(offsets, c, chunk);
  if (np == 0) return;
  int m = np < 128 ? np : 128;
  if (threadIdx.x < m)
    bucket_combine_lane(part, offsets, c, chunk, np, threadIdx.x, m,
                        sh[threadIdx.x]);
  __syncthreads();
  int p2 = 1;
  while (p2 < m) p2 <<= 1;
  for (int stride = p2 >> 1; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride && threadIdx.x + stride < m)
      bucket_tree_step(sh[0], threadIdx.x, stride);
    __syncthreads();
  }
  if (threadIdx.x < 16) dst[threadIdx.x] = sh[0][threadIdx.x];
}

// pts [n][16] rows"""
# timing probes: K13's first launch alone, and its first two
K13_PRE_ONLY = ("  int T = (int)", "  return 0;\n  int T = (int)")
K13_ACCUM_ONLY = ("  bucket_combine_kernel<<<",
                  "  return 0;\n  bucket_combine_kernel<<<")
# K14's window launch alone (a timing probe)
K14_WINDOW_ONLY = ("""  rc = (int)cudaGetLastError();
  if (rc) return rc;
  bucket_tail_kernel""", """  return (int)cudaGetLastError();
  bucket_tail_kernel""")

# name -> (kernel, source, [(committed text, variant text), ...])
VARIANTS = {
    # K13 with the signed add, a block of 128 threads a column's
    # combination, 2 or 8 columns a block, and its timing probes
    "k13_signed": ("bucket_accumulate", "bucket_accum.cu", [K13_SIGNED]),
    "k13_combine_block": ("bucket_accumulate", "bucket_accum.cu", [
        ("\n// pts [n][16] rows", K13_COMBINE_BLOCK),
        ("  bucket_combine_kernel<<<blocks_for(cols, COMBINE_WARPS), "
         "COMBINE_WARPS * 32,\n                          0, st>>>(part, "
         "offsets, out, cols, chunk);",
         "  bucket_combine_block_kernel<<<cols, 128, 0, st>>>(part, offsets, "
         "out, chunk);")]),
    "k13_combine_warps2": ("bucket_accumulate", "bucket_accum.cu", [
        ("#define COMBINE_WARPS 4 ", "#define COMBINE_WARPS 2 ")]),
    "k13_combine_warps8": ("bucket_accumulate", "bucket_accum.cu", [
        ("#define COMBINE_WARPS 4 ", "#define COMBINE_WARPS 8 ")]),
    "k13_pre_only": ("bucket_accumulate", "bucket_accum.cu", [K13_PRE_ONLY]),
    "k13_accum_only": ("bucket_accumulate", "bucket_accum.cu",
                       [K13_ACCUM_ONLY]),
    # K14 with 1 or 2 lanes a group operation (both launches), 4 or 16
    # window groups, and its window launch alone
    "k14_lanes1": ("bucket_reduce", "bucket_reduce.cu", [
        ("#define BUCKET_LANES 4 ", "#define BUCKET_LANES 1 ")]),
    "k14_lanes2": ("bucket_reduce", "bucket_reduce.cu", [
        ("#define BUCKET_LANES 4 ", "#define BUCKET_LANES 2 ")]),
    "k14_groups4": ("bucket_reduce", "bucket_reduce.cu", [
        ("#define REDUCE_GROUPS 8 ", "#define REDUCE_GROUPS 4 ")]),
    "k14_groups16": ("bucket_reduce", "bucket_reduce.cu", [
        ("#define REDUCE_GROUPS 8 ", "#define REDUCE_GROUPS 16 ")]),
    "k14_window_only": ("bucket_reduce", "bucket_reduce.cu",
                        [K14_WINDOW_ONLY]),
    # K2 with 2 or 8 lanes a group operation (both phases), 4 or 16 window
    # groups, column-sum products, the Fermat inversion, and the timing
    # probes: its reduce launch alone, no launch, no inversion
    "k2_lanes2": ("msm_tail", "msm_tail.cu", [
        ("#define TAIL_LANES 4 ", "#define TAIL_LANES 2 "),
        ("#define TAIL_CHAIN_LANES 4 ", "#define TAIL_CHAIN_LANES 2 ")]),
    "k2_lanes8": ("msm_tail", "msm_tail.cu", [
        ("#define TAIL_LANES 4 ", "#define TAIL_LANES 8 "),
        ("#define TAIL_CHAIN_LANES 4 ", "#define TAIL_CHAIN_LANES 8 ")]),
    "k2_groups4": ("msm_tail", "msm_tail.cu", [
        ("#define TAIL_GROUPS 8 ", "#define TAIL_GROUPS 4 ")]),
    "k2_groups16": ("msm_tail", "msm_tail.cu", [
        ("#define TAIL_GROUPS 8 ", "#define TAIL_GROUPS 16 ")]),
    "k2_cols": ("msm_tail", "msm_tail.cu", [K2_COLS]),
    "k2_fermat": ("msm_tail", "msm_tail.cu", [K2_FERMAT]),
    "k2_reduce_only": ("msm_tail", "msm_tail.cu", [K2_REDUCE_ONLY]),
    "k2_no_launch": ("msm_tail", "msm_tail.cu", [K2_NO_LAUNCH]),
    "k2_no_inversion": ("msm_tail", "msm_tail.cu", [K2_NO_INVERSION]),
    "k2_reduce_no_tree": ("msm_tail", "msm_tail.cu", [K2_REDUCE_ONLY,
                                                      K2_REDUCE_NO_TREE]),
    "k2_tree_word_major": ("msm_tail", "msm_tail.cu", [k2_tree_word_major]),
    # K4 with the projective add, one inversion an exponent, the last
    # window's add without T
    "k4_projective_add": ("comb", "comb.cu", [K4_PROJECTIVE_ADD]),
    "k4_per_exponent": ("comb", "comb.cu", [
        ("  comb_norm_kernel<<<", "  G = n;\n  comb_norm_kernel<<<")]),
    "k4_last_no_t": ("comb", "comb.cu", [
        (INCLUDES, K4_LAST_NO_T),
        ("if (g < G) comb_group(table,",
         "if (g < G) comb_group_last(table,")]),
    # K11's table copied into shared memory (110.6 KB a block) instead of
    # read through L1
    "k11_shared": ("bn2_bexp", "bn2_bexp.cu", shared_table(
        "bn2_bexp_kernel", "bn2_bexp_group", "tbl", "BN2_ROW",
        K11_SMEM_BYTES)),
    "k11_full_add": ("bn2_bexp", "bn2_bexp.cu", [
        (INCLUDES, K11_FULL_ADD),
        ("bn2_bexp_group(tbl,", "bexp_group_full(tbl,")]),
    "k11_split_norm": ("bn2_bexp", "bn2_bexp.cu", [
        (INCLUDES, K11_SPLIT),
        ("bn2_bexp_group(tbl, digits, n, nw, g, G, pre, out);",
         "bexp_group_sums(tbl, digits, n, nw, g, G, out);"),
        ("      work, digits, n, nw, G, pre, out);\n",
         "      work, digits, n, nw, G, pre, out);\n"
         "  bn2_norm_kernel<<<blocks_for(G, K_THREADS), K_THREADS, 0, s>>>("
         "out, pre, n, G);\n")]),
    "k11_per_exponent": ("bn2_bexp", "bn2_bexp.cu", [
        per_exponent("bn2_encode_affine_kernel")]),
    # K8's table copied into shared memory (55 KB a block)
    "k8_shared": ("bn_comb", "bn_comb.cu", shared_table(
        "bn_comb_norm_kernel", "bn_comb_group", "table", "12",
        K8_SMEM_BYTES)),
    "k8_full_add": ("bn_comb", "bn_comb.cu", [
        (INCLUDES, K8_FULL_ADD),
        ("if (g < G) bn_comb_group(table,",
         "if (g < G) comb_group_full(table,")]),
    "k8_per_exponent": ("bn_comb", "bn_comb.cu", [
        per_exponent("bn_encode_affine_kernel")]),
    # K3 over signed radix-16 digits (the multiples 1..8; also at all the
    # threads its registers allow, as first written), over a width-4 NAF,
    # with one inversion an element, with T in every doubling, with a
    # negated copy of an entry, at 384 and 128 threads an SM, with the most
    # L1
    "k3_radix16": ("fold", "fold.cu", [k3_radix16]),
    "k3_radix16_wave384": ("fold", "fold.cu", [k3_wave(0), k3_radix16]),
    "k3_wnaf4": ("fold", "fold.cu", [k3_wnaf4]),
    "k3_per_element": ("fold", "fold.cu", [K3_PER_ELEMENT]),
    "k3_full_dbl": ("fold", "fold.cu", [
        (INCLUDES, k3_full_dbl()),
        ("if (g < G) fold_group(", "if (g < G) fold_group_full_dbl(")]),
    "k3_neg_copy": ("fold", "fold.cu", [
        (INCLUDES, k3_neg_copy()),
        ("if (g < G) fold_group(", "if (g < G) fold_group_neg_copy(")]),
    "k3_wave384": ("fold", "fold.cu", [k3_wave(0)]),
    "k3_wave128": ("fold", "fold.cu", [k3_wave(128)]),
    "k3_max_l1": ("fold", "fold.cu", [K3_MAX_L1]),
    # K7 and K12 over the parent's unsigned windows, with the encoding in
    # launches of their own, with one inversion an element, at another
    # count of blocks of 128 threads an SM (__launch_bounds__, which caps
    # the registers: 168 at 3, 128 at 4, 102 at 5, 85 at 6, 64 at 8; K12's
    # 2 gives the 255 of the parent's __launch_bounds__(K_THREADS, 1),
    # which ran as fast), K7 with the most L1, and unchanged (a null
    # variant: the offset between two libraries of one source)
    "k7_radix16": ("bn_fold", "bn_fold.cu", [
        bn_fold_radix16("bn", "g1", "12")]),
    "k7_encode_launches": ("bn_fold", "bn_fold.cu", [
        bn_fold_encoded("bn", "g1", "12", "bn254_kernels.cuh")]),
    "k7_per_element": ("bn_fold", "bn_fold.cu", [BN_FOLD_PER_ELEMENT]),
    **{f"k7_blocks{k}": ("bn_fold", "bn_fold.cu", [
        launch_bounds("bn_fold_norm_kernel", k), fold_wave(k)])
       for k in (3, 4)},
    "k7_max_l1": ("bn_fold", "bn_fold.cu", [
        ("  FoldDigits c;\n",
         "  cudaFuncSetAttribute(bn_fold_norm_kernel, "
         "cudaFuncAttributePreferredSharedMemoryCarveout, 0);\n"
         "  FoldDigits c;\n")]),
    "k7_same": ("bn_fold", "bn_fold.cu", [
        (INCLUDES, INCLUDES + "// the committed source\n")]),
    "k12_radix16": ("bn2_fold", "bn2_fold.cu", [
        bn_fold_radix16("bn2", "g2", "BN2_ROW")]),
    "k12_encode_launches": ("bn2_fold", "bn2_fold.cu", [
        bn_fold_encoded("bn2", "g2", "BN2_ROW", "bn2_kernels.cuh")]),
    "k12_per_element": ("bn2_fold", "bn2_fold.cu", [BN_FOLD_PER_ELEMENT]),
    **{f"k12_blocks{k}": ("bn2_fold", "bn2_fold.cu", [
        ("#define FOLD2_BLOCKS 4 ", f"#define FOLD2_BLOCKS {k} "),
        fold_wave(k)]) for k in (2, 3, 5, 6, 8)},
    "k12_same": ("bn2_fold", "bn2_fold.cu", [
        (INCLUDES, INCLUDES + "// the committed source\n")]),
    # K6 with 1 or 2 lanes a group operation, 1 or 4 window groups, the
    # sliding-window inversion
    "k6_lanes1": ("bn_msm_tail", "bn_msm_tail.cu", [
        ("#define TAIL_LANES 4 ", "#define TAIL_LANES 1 ")]),
    "k6_lanes2": ("bn_msm_tail", "bn_msm_tail.cu", [
        ("#define TAIL_LANES 4 ", "#define TAIL_LANES 2 ")]),
    "k6_groups1": ("bn_msm_tail", "bn_msm_tail.cu", [
        ("#define TAIL_GROUPS 8 ", "#define TAIL_GROUPS 1 ")]),
    "k6_groups4": ("bn_msm_tail", "bn_msm_tail.cu", [
        ("#define TAIL_GROUPS 8 ", "#define TAIL_GROUPS 4 ")]),
    "k6_inv_window": ("bn_msm_tail", "bn_msm_tail.cu", [
        ('#include "bn254_kernels.cuh"\n', K6_INV_WINDOW)]),
    # K9 with the parent's projective table and complete adds (its
    # accumulation asking for 1 or 3 blocks an SM); the committed K9 with
    # its accumulation asking for 1 or 4 blocks an SM (at 128 threads a
    # block, 255 and 128 registers a thread; 2 also gives 255), with the
    # table built by doublings, and its launches before the accumulation
    # alone (also the projective table's launch alone)
    "k9_projective": ("bn2_msm_accumulate", "bn2_msm_accum.cu",
                      [k9_projective]),
    # the committed sources unchanged, built as a variant is: what the
    # library alone changes
    "k9_same": ("bn2_msm_accumulate", "bn2_msm_accum.cu", [
        (INCLUDES, INCLUDES + "// the committed source\n")]),
    "k10_same": ("bn2_msm_tail", "bn2_msm_tail.cu", [
        (INCLUDES, INCLUDES + "// the committed source\n")]),
    "k9_projective_blocks3": ("bn2_msm_accumulate", "bn2_msm_accum.cu",
                              [k9_projective_blocks3]),
    # k9_projective_blocks3 in one library with the committed K9
    "k9_pair_projective3": ("bn2_msm_accumulate", "bn2_msm_accum.cu",
                            [k9_pair_projective3]),
    "k9_blocks1": ("bn2_msm_accumulate", "bn2_msm_accum.cu", [
        ("__launch_bounds__(K_THREADS, 3)", "__launch_bounds__(K_THREADS, 1)")]),
    "k9_blocks4": ("bn2_msm_accumulate", "bn2_msm_accum.cu", [
        ("__launch_bounds__(K_THREADS, 3)", "__launch_bounds__(K_THREADS, 4)")]),
    "k9_dbl_chain": ("bn2_msm_accumulate", "bn2_msm_accum.cu", [
        (INCLUDES, INCLUDES + K9_DBL_CHAIN),
        ("    bn2_table_one(pts + i * BN2_ROW,", "    table_dbl_chain(pts + i * BN2_ROW,")]),
    "k9_table_only": ("bn2_msm_accumulate", "bn2_msm_accum.cu",
                      [K9_TABLE_ONLY]),
    # K9's first launch asking for 3 blocks an SM
    "k9_table_blocks3": ("bn2_msm_accumulate", "bn2_msm_accum.cu", [
        ("__launch_bounds__(K_THREADS)\n    bn2_table_kernel(",
         "__launch_bounds__(K_THREADS, 3)\n    bn2_table_kernel(")]),
    "k9_projective_table_only": ("bn2_msm_accumulate", "bn2_msm_accum.cu",
                                 [k9_projective_table_only]),
    # K10 with its reduce asking for 3 blocks an SM (170 registers), and
    # its reduce launch alone
    "k10_reduce_blocks3": ("bn2_msm_tail", "bn2_msm_tail.cu", [
        ("__launch_bounds__(BN2_REDUCE_THREADS)",
         "__launch_bounds__(BN2_REDUCE_THREADS, 3)")]),
    "k10_reduce_only": ("bn2_msm_tail", "bn2_msm_tail.cu",
                        [K10_REDUCE_ONLY]),
    # K10's Horners and shift on 8 or 32 lanes a group operation
    "k10_chain_lanes8": ("bn2_msm_tail", "bn2_msm_tail.cu", [
        ("#define TAIL_CHAIN_LANES 16 ", "#define TAIL_CHAIN_LANES 8 ")]),
    "k10_chain_lanes32": ("bn2_msm_tail", "bn2_msm_tail.cu", [
        ("#define TAIL_CHAIN_LANES 16 ", "#define TAIL_CHAIN_LANES 32 ")]),
    # K10 with 1, 2 or 4 lanes a group operation of the windows' sums (and
    # of the Horners), 1 or 4 window groups
    "k10_lanes1": ("bn2_msm_tail", "bn2_msm_tail.cu", [
        ("#define TAIL_LANES 8 ", "#define TAIL_LANES 1 "),
        ("#define TAIL_CHAIN_LANES 16 ", "#define TAIL_CHAIN_LANES 1 ")]),
    "k10_lanes2": ("bn2_msm_tail", "bn2_msm_tail.cu", [
        ("#define TAIL_LANES 8 ", "#define TAIL_LANES 2 "),
        ("#define TAIL_CHAIN_LANES 16 ", "#define TAIL_CHAIN_LANES 2 ")]),
    "k10_lanes4": ("bn2_msm_tail", "bn2_msm_tail.cu", [
        ("#define TAIL_LANES 8 ", "#define TAIL_LANES 4 "),
        ("#define TAIL_CHAIN_LANES 16 ", "#define TAIL_CHAIN_LANES 4 ")]),
    "k10_groups1": ("bn2_msm_tail", "bn2_msm_tail.cu", [
        ("#define TAIL_GROUPS 8 ", "#define TAIL_GROUPS 1 ")]),
    "k10_groups4": ("bn2_msm_tail", "bn2_msm_tail.cu", [
        ("#define TAIL_GROUPS 8 ", "#define TAIL_GROUPS 4 ")]),
}

# the committed K2, K6 or K10 with another chunk count R a window (the
# wrappers' tail_split give 2, 4 and 4 at S = 4096): name -> (kernel, R)
SPLITS = {"k2_r1": ("msm_tail", 1), "k2_r3": ("msm_tail", 3),
          "k2_r4": ("msm_tail", 4), "k2_r8": ("msm_tail", 8),
          "k6_r2": ("bn_msm_tail", 2), "k6_r3": ("bn_msm_tail", 3),
          "k6_r5": ("bn_msm_tail", 5), "k6_r6": ("bn_msm_tail", 6),
          "k6_r8": ("bn_msm_tail", 8), "k6_r16": ("bn_msm_tail", 16),
          "k6_r32": ("bn_msm_tail", 32), "k10_r1": ("bn2_msm_tail", 1),
          "k10_r2": ("bn2_msm_tail", 2), "k10_r4": ("bn2_msm_tail", 4),
          "k10_r8": ("bn2_msm_tail", 8), "k10_r16": ("bn2_msm_tail", 16)}
# variants whose library holds the committed design too, under the
# committed entry points, and the variant's under other names: the two are
# timed from one library, so the offset between libraries drops out
# (name -> {committed entry point: the variant's})
ONE_LIB = {"k9_pair_projective3": {
    "vmpc_cu_bn2_msm_accum": "vmpc_cu_bn2_msm_accum_alt"}}
NO_ROWS = {"k9_table_only", "k9_projective_table_only", "k10_reduce_only",
           "k2_reduce_only", "k2_no_launch", "k2_no_inversion",
           "k2_reduce_no_tree", "k13_pre_only", "k13_accum_only",
           "k14_window_only"}
# K13 with another count of entries a thread (the wrapper's ACCUM_ENTRIES
# is the committed count): name -> entries
ENTRIES = {"k13_c16": 16, "k13_c32": 32, "k13_c48": 48, "k13_c96": 96,
           "k13_c128": 128}
# the committed K9 with its normalization, K4, K7 or K12 at one wave of
# another count of threads an SM (the wrappers' TABLE_SM_THREADS,
# COMB_SM_THREADS and FOLD_SM_THREADS are the committed ones; K9's
# registers allow 384, K4's 640, "all": what the registers allow): fewer
# threads, fewer inversions and longer chains.  name -> (kernel, threads
# an SM); WAVE_KNOBS names each kernel's wrapper setting: a module and its
# constant, or a module, its dict and the key (None: no cap)
WAVES = {"k9_norm_wave128": ("bn2_msm_accumulate", 128),
         "k9_norm_wave384": ("bn2_msm_accumulate", 384),
         "k4_wave_all": ("comb", 1 << 20), "k4_wave256": ("comb", 256),
         "k4_wave128": ("comb", 128),
         "k7_wave128": ("bn_fold", 128), "k7_wave_all": ("bn_fold", 1 << 20),
         "k12_wave128": ("bn2_fold", 128), "k12_wave256": ("bn2_fold", 256),
         "k12_wave_all": ("bn2_fold", 1 << 20)}
WAVE_KNOBS = {"bn2_msm_accumulate": ("msm_bn2_cuda", "TABLE_SM_THREADS"),
              "comb": ("msm_cuda", "COMB_SM_THREADS"),
              "bn_fold": ("msm_cuda", "FOLD_SM_THREADS", "bn_fold"),
              "bn2_fold": ("msm_cuda", "FOLD_SM_THREADS", "bn2_fold")}
# K9's points a thread (the wrapper's ACCUM_POINTS_PER_THREAD is the
# committed count), K10 on the accumulators each gives
POINTS = {"k9_points16": 16, "k9_points32": 32, "k9_points64": 64}


def variant_source(name: str) -> str:
    """The committed source with the variant's edits (each anchor must occur
    exactly once, or the variant no longer applies and this raises)."""
    from verifiable_mpc_tpu_torch.ops import _cuda_build as cb

    _kernel, src, edits = VARIANTS[name]
    with open(os.path.join(cb.CSRC, src)) as f:
        text = f.read()
    for edit in edits:
        if callable(edit):
            text = edit(text)
            continue
        old, new = edit
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {src} holds {old[:50]!r} "
                               f"{text.count(old)} times, not once")
        text = text.replace(old, new)
    return text


def build_variants(names) -> dict:
    """{name: path of its library}, all built side by side (nvcc, ptxas's
    lines printed)."""
    from verifiable_mpc_tpu_torch import _build
    from verifiable_mpc_tpu_torch.ops import _cuda_build as cb

    where = os.path.join(cb.BUILD, "variants")
    os.makedirs(where, exist_ok=True)
    libs, cmds = {}, []
    for name in names:
        src = os.path.join(where, f"{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(name))
        libs[name] = os.path.join(where, f"lib{name}.so")
        cmds.append([cb._nvcc(), *cb.NVCC_FLAGS, "-Xptxas=-v", "-I", cb.CSRC,
                     "-shared", "-o", libs[name], src])
    _build.run_all(cmds, timeout=900, verbose=True)
    return libs


class Swapped:
    """The kernel library with the variant library's entry points in place
    of the committed ones of the same names (or of the names ``names``
    maps them to)."""

    def __init__(self, main, variant, names=None):
        self.main, self.variant, self.names = main, variant, names or {}

    def __getattr__(self, key):
        fn = getattr(self.main, key)
        try:
            alt = getattr(self.variant, self.names.get(key, key))
        except AttributeError:
            return fn
        alt.argtypes, alt.restype = fn.argtypes, fn.restype
        return alt


def kernel_times(root: str, reps: int) -> dict:
    """K2 at B = 2, nw = 64, S = 4096, K3 at 2^17 elements, K4 at 2^18 - 1
    exponents (the generator's comb table of its checkout), K6 at B = 1,
    nw = 64, S = 4096, K9 at 2^17 twist points and K10 on their
    accumulators (each at the slice count of its checkout's MSM) of the
    package under ``root``, on inputs made from fixed seeds (the same for
    every checkout): best-of-``reps`` CUDA-event times and a checksum of
    each kernel's rows (of the twist MSM's result for K9 and K10).  A
    checkout whose K3 takes unsigned radix-16 digits (an earlier commit)
    gets those."""
    sys.path.insert(0, root)
    import torch

    import verifiable_mpc_tpu_torch as vm
    from verifiable_mpc_tpu_torch import native
    from verifiable_mpc_tpu_torch.groups.bn256 import ORDER
    from verifiable_mpc_tpu_torch.groups.edwards import ELL, EdwardsPoint
    from verifiable_mpc_tpu_torch.ops import curve_bn as cbn
    from verifiable_mpc_tpu_torch.ops import curve_bn2 as cb2
    from verifiable_mpc_tpu_torch.ops import curve_ed as ced
    from verifiable_mpc_tpu_torch.ops import msm_bn2_cuda as mb2
    from verifiable_mpc_tpu_torch.ops import msm_bn_cuda as mb
    from verifiable_mpc_tpu_torch.ops import msm_cuda as mc

    assert os.path.abspath(vm.__file__).startswith(os.path.abspath(root))
    vm.enable_gpu("cuda")
    rng = random.Random(7)
    n = 1 << 17
    g = ced.from_reference_rows(smoke.random_points(native, 2 * n, rng),
                                "cuda")
    c = rng.randrange(ELL)
    cdig = (mc.fold_digits(c) if hasattr(mc, "fold_digits")
            else mc.scalar_digits([c])[:, 0])
    work = cbn.encode_jacobian_rows(cbn.encode_points(
        smoke.bn_points(native, 4096, rng), "cuda"))
    idx = torch.randint(0, 4096, (64 * 4096,),
                        generator=torch.Generator().manual_seed(3))
    acc = work[idx.to("cuda")].reshape(1, 64, 4096, 12)
    acc_ed = k2_accumulators(torch, native, ced, rng, "cuda")
    dig4, nw4 = k4_digits(torch, native, mc, rng, 2 * n - 1, "cuda")
    table4 = mc.comb_table(EdwardsPoint.generator, nw4, "cuda")
    calls = {"msm_tail": lambda: mc.msm_tail(acc_ed),
             "fold": lambda: mc.fold_rows(g[:n], g[n:], cdig),
             "comb": lambda: mc.comb_rows(table4, dig4),
             "bn_msm_tail": lambda: mb.msm_tail(acc)}
    out = {k: (smoke.cuda_ms(torch, fn, reps), int(fn().sum().item()))
           for k, fn in calls.items()}
    P = cb2.encode_points(smoke.bn2_points(native, n, rng, identity_at=(5,)),
                          "cuda")[None]
    sc = [rng.randrange(ORDER) for _ in range(n)]
    dig = torch.from_numpy(mc.packed_digits(native._scalars_to_u64(
        sc, ORDER), ORDER)[0]).to("cuda")[None]
    S = mb2.msm_slices(n) if hasattr(mb2, "msm_slices") else mc.slices_for(n)
    acc2 = mb2.msm_accumulate(P, dig, S)
    rows = int(mb2.msm_tail(acc2).sum().item())
    out["bn2_msm_accumulate"] = (smoke.cuda_ms(
        torch, lambda: mb2.msm_accumulate(P, dig, S), reps), rows)
    out["bn2_msm_tail"] = (smoke.cuda_ms(
        torch, lambda: mb2.msm_tail(acc2), reps), rows)
    out.update(bucket_times(torch, native, ced, rng, reps))
    out.update(bn_fold_comb_times(torch, native, rng, n, reps))
    return out


def bn_fold_digits(mc, c: int, order: int):
    """c's digits for the BN folds of the package imported: the width-5
    NAF of c mod the order, or, where fold_digits takes no order (an
    earlier checkout, whose K7 and K12 read unsigned windows), those."""
    try:
        return mc.fold_digits(c, order)
    except TypeError:
        return mc.scalar_digits([c], order)[:, 0]


def bn_fold_comb_times(torch, native, rng, n: int, reps: int) -> dict:
    """K7 and K12 at n elements, K8 and K11 at n exponents (the
    generators' comb tables): times and checksums, as kernel_times."""
    from verifiable_mpc_tpu_torch.groups.bn256 import (ORDER, BNPoint,
                                                       BNTwistPoint)
    from verifiable_mpc_tpu_torch.ops import curve_bn as cbn
    from verifiable_mpc_tpu_torch.ops import curve_bn2 as cb2
    from verifiable_mpc_tpu_torch.ops import msm_bn2_cuda as mb2
    from verifiable_mpc_tpu_torch.ops import msm_bn_cuda as mb
    from verifiable_mpc_tpu_torch.ops import msm_cuda as mc

    g7 = cbn.encode_points(smoke.bn_points(native, 2 * n, rng), "cuda")
    g12 = cb2.encode_points(smoke.bn2_points(native, 2 * n, rng), "cuda")
    d7 = bn_fold_digits(mc, rng.randrange(ORDER), ORDER)
    d12 = bn_fold_digits(mc, rng.randrange(ORDER), ORDER)
    pk, nw = mc.packed_digits(native._scalars_to_u64(
        [rng.randrange(ORDER) for _ in range(n)], ORDER), ORDER)
    dig = torch.from_numpy(pk).to("cuda")
    t8 = mb.comb_table(BNPoint.generator, nw, "cuda")
    t11 = mb2.bexp_table(BNTwistPoint.generator, nw, "cuda")
    calls = {"bn_fold": lambda: mb.fold_rows(g7[:n], g7[n:], d7),
             "bn2_fold": lambda: mb2.fold_rows(g12[:n], g12[n:], d12),
             "bn_comb": lambda: mb.comb_rows(t8, dig),
             "bn2_bexp": lambda: mb2.bexp_rows(t11, dig)}
    return {k: (smoke.cuda_ms(torch, fn, reps), int(fn().sum().item()))
            for k, fn in calls.items()}


def bucket_times(torch, native, ced, rng, reps: int) -> dict:
    """K13 and K14 at protocol 5's commitment (2^18 points and scalars,
    layout_for's layout: the compact one, or an earlier commit's padded
    perm and sgn), checksums of the normalized bucket sums and the result,
    and (as ``bucket_peak_bytes``, checksum 0) the peak device memory of
    the layout and both kernels above what was allocated before."""
    from verifiable_mpc_tpu_torch.groups.edwards import ELL
    from verifiable_mpc_tpu_torch.ops import msm_bucket_cuda as bk

    n = 1 << 18
    pts = ced.from_reference_rows(smoke.random_points(native, n, rng), "cuda")
    sc = [rng.randrange(ELL) for _ in range(n)]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lay = bk.layout_for(sc, 8, bk.LANES, "cuda")[:2]
    buckets = bk.bucket_accumulate(pts, *lay)
    res = bk.bucket_reduce(buckets)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    sums = ced.normalize_rows(ced.split_rows(buckets.reshape(-1, 16)))
    return {"bucket_accumulate": (smoke.cuda_ms(
                torch, lambda: bk.bucket_accumulate(pts, *lay), reps),
                int(sums.sum().item())),
            "bucket_reduce": (smoke.cuda_ms(
                torch, lambda: bk.bucket_reduce(buckets), reps),
                int(res.sum().item())),
            "bucket_peak_bytes": (float(peak), 0)}


def k2_accumulators(torch, native, ced, rng, dev):
    """K2's input at a flagship round 0's shape: [2, 64, 4096, 16]
    accumulators gathered at random from 4,096 random points."""
    pts = ced.from_reference_rows(smoke.random_points(native, 4096, rng), dev)
    idx = torch.randint(0, 4096, (2 * 64 * 4096,),
                        generator=torch.Generator().manual_seed(11))
    return pts[idx.to(dev)].reshape(2, 64, 4096, 16)


def k4_digits(torch, native, mc, rng, n: int, dev):
    """K4's input at the flagship generators' shape: the packed digits of
    n random exponents and their window count."""
    from verifiable_mpc_tpu_torch.groups.edwards import ELL

    pk, nw = mc.packed_digits(native._ints_to_u64x4(
        [rng.randrange(1, ELL) for _ in range(n)], ELL))
    return torch.from_numpy(pk).to(dev), nw


# the sources whose ptxas lines --parent prints for both checkouts: K2,
# K4, K6 and K10, whose combination coop.cuh shares with K2 and K14, K13,
# K14, K7 and K12
PTXAS_SOURCES = ("msm_tail.cu", "comb.cu", "bn_msm_tail.cu",
                 "bn2_msm_tail.cu", "bucket_accum.cu", "bucket_reduce.cu",
                 "bn_fold.cu", "bn2_fold.cu")


def ptxas_of(root: str) -> dict:
    """{kernel: (registers, stack, spill stores, spill loads, shared
    bytes)} of PTXAS_SOURCES in the checkout at ``root``, each compiled
    alone with the package's flags, all at once (objects thrown away)."""
    import subprocess
    import tempfile

    from verifiable_mpc_tpu_torch.ops import _cuda_build as cb

    csrc = os.path.join(root, "verifiable_mpc_tpu_torch", "csrc")
    texts = []
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [cb._nvcc(), *cb.NVCC_FLAGS, "-Xptxas=-v", "-c", "-o",
             os.path.join(tmp, src + ".o"), os.path.join(csrc, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in PTXAS_SOURCES]
        for src, proc in zip(PTXAS_SOURCES, procs):
            texts.append(proc.communicate(timeout=900)[0])
            if proc.returncode:
                raise RuntimeError(f"nvcc {src}:\n{texts[-1]}")
    return smoke.ptxas_usage("\n".join(texts))


def against(parent: str, reps: int) -> dict:
    """K2, K3, K4, K6, K7, K8, K9, K10, K11, K12, K13 and K14 of this
    checkout and of the one at ``parent``, each in a process of its own,
    in turns (parent, this, this, parent); their rows must agree."""
    import subprocess

    out = {"parent": [], "this": []}
    for which in ("parent", "this", "this", "parent"):
        root = os.path.abspath(parent) if which == "parent" else HERE
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--kernel-times", root, "--reps", str(reps)],
                           capture_output=True, text=True, timeout=1800,
                           check=True)
        out[which].append(json.loads(r.stdout.strip().splitlines()[-1]))
    sums = {json.dumps({k: v[1] for k, v in t.items()})
            for ts in out.values() for t in ts}
    assert len(sums) == 1, f"the checkouts' rows differ: {sums}"
    for which, root in (("parent", os.path.abspath(parent)), ("this", HERE)):
        for k, v in sorted(ptxas_of(root).items()):
            print(f"ptxas {which} {k}: {v[0]} registers, {v[1]} bytes stack,"
                  f" {v[2]}/{v[3]} bytes spill stores/loads, {v[4]} bytes "
                  "shared", flush=True)
    for k in out["this"][0]:
        unit = "bytes" if k.endswith("_bytes") else "ms"
        print(f"{k} against {parent}: parent " + " / ".join(
            f"{t[k][0]:.3f}" for t in out["parent"]) + f" {unit}, this "
            + " / ".join(f"{t[k][0]:.3f}" for t in out["this"])
            + f" {unit} (rows equal)", flush=True)
    return {w: [{k: v[0] for k, v in t.items()} for t in ts]
            for w, ts in out.items()}


class Clocks:
    """The card's SM clock (MHz) and power draw (W) as nvidia-smi samples
    them every 50 ms while the block runs: ``low`` the least clock,
    ``high`` the most power (None when no sample came)."""

    def __enter__(self):
        import subprocess

        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out = self.proc.communicate(timeout=30)[0]
        vals = []
        for line in out.splitlines():
            try:
                vals.append(tuple(float(x) for x in line.split(",")))
            except ValueError:
                continue
        self.low = min(v[0] for v in vals) if vals else None
        self.high = max(v[1] for v in vals) if vals else None

    def __str__(self):
        return f"{self.low} MHz, {self.high} W"


def points_times(torch, mb2, P, dig, want, reps: int) -> tuple:
    """K9 alone, K10 alone and K9 + K10 at the slice count of the module's
    ACCUM_POINTS_PER_THREAD (ms, best of ``reps``); the MSM's rows must
    equal ``want``."""
    S = mb2.msm_slices(P.shape[1])
    acc = mb2.msm_accumulate(P, dig, S)
    assert torch.equal(mb2.msm_tail(acc), want), f"S = {S} differs"
    return (smoke.cuda_ms(torch, lambda: mb2.msm_accumulate(P, dig, S), reps),
            smoke.cuda_ms(torch, lambda: mb2.msm_tail(acc), reps),
            smoke.cuda_ms(torch, lambda: mb2.msm_rows(P, dig), reps))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2", type=int, default=smoke.SNARK_LOG2_MULS + 1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", nargs="*",
                    default=(sorted(VARIANTS) + sorted(SPLITS) + sorted(POINTS)
                             + sorted(WAVES) + sorted(ENTRIES)))
    ap.add_argument("--parent", default=None,
                    help="also time K2-K4 and K6-K14 against this "
                    "checkout's")
    ap.add_argument("--kernel-times", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.kernel_times:
        print(json.dumps(kernel_times(args.kernel_times, args.reps)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device available", file=sys.stderr)
        return 2
    import verifiable_mpc_tpu_torch as vm
    from verifiable_mpc_tpu_torch import native
    from verifiable_mpc_tpu_torch.groups.bn256 import (ORDER, BNPoint,
                                                       BNTwistPoint)
    from verifiable_mpc_tpu_torch.groups.edwards import ELL, EdwardsPoint
    from verifiable_mpc_tpu_torch.ops import _cuda_build as cb
    from verifiable_mpc_tpu_torch.ops import curve_bn as cbn
    from verifiable_mpc_tpu_torch.ops import curve_bn2 as cb2
    from verifiable_mpc_tpu_torch.ops import curve_ed as ced
    from verifiable_mpc_tpu_torch.ops import msm_bn2_cuda as mb2
    from verifiable_mpc_tpu_torch.ops import msm_bn_cuda as mb
    from verifiable_mpc_tpu_torch.ops import msm_bucket_cuda as bk
    from verifiable_mpc_tpu_torch.ops import msm_cuda as mc

    print(smoke.card_line(), flush=True)
    vm.enable_gpu("cuda")
    main_lib = cb.lib()
    print(f"threads an SM that the registers allow: K7 "
          f"{main_lib.vmpc_cu_bn_fold_resident()}, K12 "
          f"{main_lib.vmpc_cu_bn2_fold_resident()}", flush=True)
    libs = build_variants(sorted({v for v in args.only if v in VARIANTS}))
    dev = torch.device("cuda")
    n = 1 << args.log2
    rng = random.Random(20261018)
    def kernel_of(v):
        if v in VARIANTS:
            return VARIANTS[v][0]
        if v in WAVES:
            return WAVES[v][0]
        if v in ENTRIES:
            return "bucket_accumulate"
        return SPLITS[v][0] if v in SPLITS else "bn2_points"

    kernels = {kernel_of(v) for v in args.only}
    calls = {}
    if kernels & {"bn2_bexp", "bn_comb"}:
        exps = [rng.randrange(ORDER) for _ in range(n)]
        pk, nw = mc.packed_digits(native._scalars_to_u64(exps, ORDER), ORDER)
        dig = torch.from_numpy(pk).to(dev)
        calls["bn2_bexp"] = (lambda t=mb2.bexp_table(
            BNTwistPoint.generator, nw, dev): mb2.bexp_rows(t, dig))
        calls["bn_comb"] = (lambda t=mb.comb_table(BNPoint.generator, nw,
                                                   dev): mb.comb_rows(t, dig))
    if "msm_tail" in kernels:
        acc_ed = k2_accumulators(torch, native, ced, rng, dev)
        calls["msm_tail"] = lambda: mc.msm_tail(acc_ed)
    if "comb" in kernels:
        dig4, nw4 = k4_digits(torch, native, mc, rng, 2 * n - 1, dev)
        calls["comb"] = (lambda t=mc.comb_table(EdwardsPoint.generator, nw4,
                                                dev): mc.comb_rows(t, dig4))
    if "fold" in kernels:
        g = ced.from_reference_rows(smoke.random_points(native, 2 * n, rng),
                                    dev)
        cdig = mc.fold_digits(rng.randrange(ELL))
        calls["fold"] = lambda: mc.fold_rows(g[:n], g[n:], cdig)
    if "bn_fold" in kernels:
        g7 = cbn.encode_points(smoke.bn_points(native, 2 * n, rng), dev)
        cdig7 = mc.fold_digits(rng.randrange(ORDER), ORDER)
        calls["bn_fold"] = lambda: mb.fold_rows(g7[:n], g7[n:], cdig7)
    if "bn2_fold" in kernels:
        g12 = cb2.encode_points(smoke.bn2_points(native, 2 * n, rng), dev)
        cdig12 = mc.fold_digits(rng.randrange(ORDER), ORDER)
        calls["bn2_fold"] = lambda: mb2.fold_rows(g12[:n], g12[n:], cdig12)
    if "bn_msm_tail" in kernels:
        work = cbn.encode_jacobian_rows(cbn.encode_points(
            smoke.bn_points(native, 4096, rng), dev))
        idx = torch.randint(0, 4096, (64 * 4096,),
                            generator=torch.Generator().manual_seed(5))
        acc = work[idx.to(dev)].reshape(1, 64, 4096, 12)
        calls["bn_msm_tail"] = lambda: mb.msm_tail(acc)
    same = {}
    if kernels & {"bn2_msm_accumulate", "bn2_msm_tail", "bn2_points"}:
        P = cb2.encode_points(smoke.bn2_points(native, n, rng,
                                               identity_at=(5,)), dev)[None]
        sc = [rng.randrange(ORDER) for _ in range(n)]
        dig2 = torch.from_numpy(mc.packed_digits(native._scalars_to_u64(
            sc, ORDER), ORDER)[0]).to(dev)[None]
        S2 = mb2.msm_slices(n)
        acc2 = mb2.msm_accumulate(P, dig2, S2)
        calls["bn2_msm_accumulate"] = lambda: mb2.msm_accumulate(P, dig2, S2)
        calls["bn2_msm_tail"] = lambda: mb2.msm_tail(acc2)
        calls["bn2_points"] = lambda: mb2.msm_rows(P, dig2)
        # accumulators of another representation may hold the same points
        same["bn2_msm_accumulate"] = lambda a, b: torch.equal(*(
            cb2.normalize_rows(cb2.split_rows(x)) for x in (a, b)))
    if kernels & {"bucket_accumulate", "bucket_reduce"}:
        nb = 1 << (args.log2 + 1)
        rows_b = ced.from_reference_rows(
            smoke.random_points(native, nb, rng), dev)
        ent, off, _count = bk.layout_for(
            [rng.randrange(ELL) for _ in range(nb)], 8, bk.LANES, dev)
        buckets = bk.bucket_accumulate(rows_b, ent, off)
        calls["bucket_accumulate"] = lambda: bk.bucket_accumulate(
            rows_b, ent, off)
        calls["bucket_reduce"] = lambda: bk.bucket_reduce(buckets)
        # bucket sums added in another order are other representatives
        same["bucket_accumulate"] = lambda a, b: torch.equal(*(
            ced.normalize_rows(ced.split_rows(x.reshape(-1, 16)))
            for x in (a, b)))
    want = {k: fn() for k, fn in calls.items()}
    mods = {"msm_cuda": mc, "msm_bn2_cuda": mb2}
    # each knob as (dict, key): a module's constant through its __dict__
    knobs = {k: (vars(mods[m]), attr) if not key
             else (getattr(mods[m], attr), key[0])
             for k, (m, attr, *key) in WAVE_KNOBS.items()}
    committed = {mc: mc.tail_split, mb2: mb2.tail_split,
                 "points": mb2.ACCUM_POINTS_PER_THREAD,
                 "waves": {k: d[key] for k, (d, key) in knobs.items()},
                 "entries": bk.ACCUM_ENTRIES}
    out = {}
    for name in args.only:
        kernel = kernel_of(name)
        var = ctypes.CDLL(libs[name]) if name in VARIANTS else None
        swapped = Swapped(main_lib, var, ONE_LIB.get(name)) if var else main_lib
        base = Swapped(main_lib, var) if name in ONE_LIB else main_lib
        times = {"committed": [], name: []}
        clocks = []
        for which in ("committed", name, name, "committed"):
            cb._lib = swapped if which == name else base
            if name in SPLITS and which == name:
                mod = mb2 if kernel == "bn2_msm_tail" else mc
                mod.tail_split = lambda *a, R=SPLITS[name][1], **k: R
            for k, (d, key) in knobs.items():
                d[key] = (WAVES[name][1] if which == name and name in WAVES
                          and k == kernel else committed["waves"][k])
            bk.ACCUM_ENTRIES = (ENTRIES[name] if which == name
                                and name in ENTRIES else committed["entries"])
            if name in POINTS:
                mb2.ACCUM_POINTS_PER_THREAD = (
                    POINTS[name] if which == name else committed["points"])
                times[which].append(points_times(torch, mb2, P, dig2,
                                                 want["bn2_points"],
                                                 args.reps))
                continue
            got = calls[kernel]()
            assert which != name or name in NO_ROWS or same.get(
                kernel, torch.equal)(got, want[kernel]), f"{name} differs"
            with Clocks() as ck:
                times[which].append(smoke.cuda_ms(torch, calls[kernel],
                                                  args.reps))
            clocks.append(str(ck))
            mc.tail_split, mb2.tail_split = committed[mc], committed[mb2]
        cb._lib = main_lib
        mb2.ACCUM_POINTS_PER_THREAD = committed["points"]
        for k, (d, key) in knobs.items():
            d[key] = committed["waves"][k]
        bk.ACCUM_ENTRIES = committed["entries"]
        out.setdefault(name, []).append(times)
        if name in POINTS:
            print(f"{name} (K9 alone / K10 alone / both, n={n}): committed "
                  + " | ".join(" / ".join(f"{x:.3f}" for x in t)
                               for t in times["committed"])
                  + " ms, variant " + " | ".join(
                      " / ".join(f"{x:.3f}" for x in t) for t in times[name])
                  + " ms (MSM rows equal)", flush=True)
            continue
        print(f"{name} ({kernel}, n={n}): committed "
              + ("(from the variant's library) " if name in ONE_LIB else "")
              + " / ".join(f"{t:.3f}" for t in times["committed"])
              + " ms, variant " + " / ".join(f"{t:.3f}" for t in times[name])
              + (" ms (a timing probe)" if name in NO_ROWS
                 else " ms (rows equal)") + "; least SM clock, most power: "
              + " / ".join(clocks), flush=True)
    result = {"n": n, "variants": out, "kind": torch.cuda.get_device_name(0)}
    if args.parent:
        result["against"] = against(args.parent, args.reps)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
