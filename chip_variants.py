#!/usr/bin/env python3
"""Design variants of the comb kernels K8 and K11, timed on the card
against the committed kernels on the same inputs.

    python3 chip_variants.py [--log2 17] [--reps 3]

A variant is a committed kernel source (``csrc/bn2_bexp.cu`` or
``csrc/bn_comb.cu``) with the few text edits listed in ``VARIANTS``, built
alone with nvcc into a library of its own (under the kernels' build
directory).  The committed kernel's wrapper then runs with the variant's
entry points in place of the committed ones, on the same exponents (the
Pinocchio path's 2^17 by default, the twist generator's or the G1
generator's comb table); every variant's rows must equal the committed
kernel's, and the two are timed in turns (committed, variant, variant,
committed; CUDA events, best of ``--reps`` each).  The sources keep one
design each; the alternatives that were measured against it live only here.
Prints the card line, ptxas's lines of the variants, one line per variant
and, last, one JSON object with the times.  Imports neither jax nor the JAX
package, and fails without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import random
import sys

import chip_smoke as smoke

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


# name -> (kernel, source, [(committed text, variant text), ...])
VARIANTS = {
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
}


def variant_source(name: str) -> str:
    """The committed source with the variant's edits (each anchor must occur
    exactly once, or the variant no longer applies and this raises)."""
    from verifiable_mpc_tpu_torch.ops import _cuda_build as cb

    _kernel, src, edits = VARIANTS[name]
    with open(os.path.join(cb.CSRC, src)) as f:
        text = f.read()
    for old, new in edits:
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
    of the committed ones of the same names."""

    def __init__(self, main, variant):
        self.main, self.variant = main, variant

    def __getattr__(self, key):
        fn = getattr(self.main, key)
        try:
            alt = getattr(self.variant, key)
        except AttributeError:
            return fn
        alt.argtypes, alt.restype = fn.argtypes, fn.restype
        return alt


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2", type=int, default=smoke.SNARK_LOG2_MULS + 1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", nargs="*", default=sorted(VARIANTS))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device available", file=sys.stderr)
        return 2
    import verifiable_mpc_tpu_torch as vm
    from verifiable_mpc_tpu_torch import native
    from verifiable_mpc_tpu_torch.groups.bn256 import (ORDER, BNPoint,
                                                       BNTwistPoint)
    from verifiable_mpc_tpu_torch.ops import _cuda_build as cb
    from verifiable_mpc_tpu_torch.ops import msm_bn2_cuda as mb2
    from verifiable_mpc_tpu_torch.ops import msm_bn_cuda as mb
    from verifiable_mpc_tpu_torch.ops import msm_cuda as mc

    print(smoke.card_line(), flush=True)
    vm.enable_gpu("cuda")
    main_lib = cb.lib()
    libs = build_variants(args.only)
    dev = torch.device("cuda")
    n = 1 << args.log2
    rng = random.Random(20261018)
    exps = [rng.randrange(ORDER) for _ in range(n)]
    pk, nw = mc.packed_digits(native._scalars_to_u64(exps, ORDER), ORDER)
    dig = torch.from_numpy(pk).to(dev)
    calls = {
        "bn2_bexp": (lambda t=mb2.bexp_table(BNTwistPoint.generator, nw,
                                             dev): mb2.bexp_rows(t, dig)),
        "bn_comb": (lambda t=mb.comb_table(BNPoint.generator, nw, dev):
                    mb.comb_rows(t, dig)),
    }
    want = {k: fn() for k, fn in calls.items()}
    out = {}
    for name in args.only:
        kernel = VARIANTS[name][0]
        swapped = Swapped(main_lib, ctypes.CDLL(libs[name]))
        times = {"committed": [], name: []}
        for which in ("committed", name, name, "committed"):
            cb._lib = swapped if which == name else main_lib
            got = calls[kernel]()
            assert torch.equal(got, want[kernel]), f"{name} differs"
            times[which].append(smoke.cuda_ms(torch, calls[kernel],
                                              args.reps))
        cb._lib = main_lib
        out[name] = times
        print(f"{name} ({kernel}, n={n}): committed "
              + " / ".join(f"{t:.3f}" for t in times["committed"])
              + " ms, variant " + " / ".join(f"{t:.3f}" for t in times[name])
              + " ms (rows equal)", flush=True)
    print(json.dumps({"n": n, "variants": out,
                      "kind": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
