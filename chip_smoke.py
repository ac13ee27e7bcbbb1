#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each one fatal; any failure exits non-zero and prints no result):

1. the card's name and power limit (nvidia-smi);
2. build the kernels (nvcc, ptxas's registers per thread of every kernel,
   and one line with the registers, stack, spills and shared memory of the
   launches of K1-K14) and the C++ host tier (g++), with their seconds;
3. hold every kernel against its plain PyTorch version on the same inputs
   on the card: K1 + K2 (MSM), K3 (fold), K4 (comb) over Ed25519 and
   K5 + K6 (MSM), K7 (fold), K8 (comb) over BN256 G1 at n in {1, 300,
   4096} with edge scalars (and identity inputs for BN), also against the
   C++ tier (K4 also with an identity base, exponent 0 in thread 0's
   normalization group and the exponents 0, l - 1 and one with a run of
   zero windows), and K9 + K10 (MSM), K11 (the batch-exp's comb) and K12
   (fold) over the BN256 twist the same way (native.bn2_msm,
   native.bn2_batch_exp, the host law); K8 and K11 also with an identity
   base, exponent 0 and a whole normalization group of exponent 0, and at
   the path's 2^17 against the C++ tier; and K13 + K14 (the bucket MSM;
   native.ed_msm), K15 (batch-exp; native.ed_batch_exp and the comb) and
   K16 (the Montgomery-limb add; the host law) with edge scalars, digits
   128 and -128, identities and points with Z != 1; K3 also at the
   challenges 0, 1, 8, 9, l - 1 and one with runs of zero windows (every n
   of these below its thread count G, 2^17 a ragged 2.6 G, and there too
   against the C++ tier), K7 and K12 at those challenges for the BN order
   and 17 * 2^251 (a NAF digit past the order's top bit), with identity
   gl and gr at chosen indices, an element whose result is the identity
   and thread 0's group all identities (fold_inputs), against the C++
   tier's batch-exp of the results' exponents, its MSM of (gl_i, gr_i) by
   (c, 1) and the host law (a random challenge), and at 2^17 (no
   multiple of G) against the batch-exp, K2 and K6 also on accumulators
   made here at B in {1, 2} or {1, 3}, nw in {1, 2, 8, 64}, S not a
   multiple of its chunk count R and a window whose accumulators are all
   the identity (against the C++ tier's MSM of them by 16^(nw-1-w); K2
   also where every window sums to the identity), K10 likewise on twist
   accumulators, and K9 with identity inputs, a slice of zero digits and
   a point of zero digits (accumulators normalized against the plain
   version, K9 + K10 against the C++ tier); then each kernel alone at the
   shapes its path gives it, timed with CUDA events beside its plain
   version and its bound (K4 at 2^18 - 1 exponents, a ragged count of its
   thread count G, with thread 0's group all exponent 0, also against the
   C++ tier, and its comb table's uncached build); the tolerance is exact
   equality of canonical values;
4. the Ed25519 MSM at 2^16 against the port's C++ tier
   (native.ed_msm_arr), and the Ed25519 MSM and comb against native.ed_msm
   / ed_batch_exp at the Ed25519 tier sizes (the sweep behind
   MIN_MSM_BATCH); the BN MSM and comb at 2^16 against native.bn_msm /
   bn_batch_exp, and both at the BN tier's threshold sizes; the twist MSM
   and batch-exp against native.bn2_msm / bn2_batch_exp at the twist tier
   sizes and at 2^17 (the sweep behind BN2_MIN_BATCH; at 2^17 also the
   batch-exp's first call, which builds the comb table); the bucket MSM
   against K1 + K2 and the C++ tier at 2^12 ... 2^18 points, encode to
   decode and with the points resident, its host conversion, card-side
   recoding and compact layout and kernels timed apart, and the peak
   device memory of one bucket MSM at 2^18;
5. the engine cut-over: one protocol-4 round on the card and on the C++
   tier per half size;
6. the Ed25519 flagship: enable_gpu(), a 2^16-multiplication chain
   circuit, create_generators, circuit_sat_prover, circuit_sat_verifier;
   the kernel launch counts are zeroed just before and read just after,
   and every kernel of that path and the resident engine must have run,
   K3 FLAGSHIP_FOLDS times in the prove and as many in the verify;
7. parity at 2^12 multiplications: the generators made on the card (K4)
   and by enable_native() under one seed are equal once normalized; the
   GPU prove and the enable_native() prove under one seed give identical
   (normalized) proof bytes, and the enable_native() prove launches no
   kernel;
7b. the flagship again with the bucket MSM registered
   (msm_bucket_cuda.register()): K13 + K14 serve the synchronous MSMs of
   4096 points and more (protocol 5's commitment A), launches counted per
   stage; its 2^12 parity with the bucket serving from 512 points; then
   enable_gpu() restores the backends; K15 and K16 once through their
   entry points (msm_cuda.batch_exp, add_cuda.add), their launches counted
   there;
8. the BN256 path: Pinocchio at 2^16 multiplications with enable_gpu()
   (SparseQAP, generate_keys_fast, calculate_witness, compute_proof_fast,
   verify), seconds and launches per stage, K8 and the twist's K11 in the
   key generation and K5 + K6 (K6 PINOCCHIO_TAILS times) and the twist's
   K9 + K10 in the prove; at
   2^10, with the BN and twist thresholds lowered so that K5, K6 and
   K8-K11 serve every call, the enable_gpu() and enable_native()
   evaluation keys (twist entries included) and proofs equal once
   normalized; the KoE pivot at 2^10 (K8 in its setup, K5 + K6 in its
   prove), then its parity: the enable_gpu() prove (BN and twist
   thresholds lowered, K5 and K9 launched) and the enable_native() prove
   under one seed give equal normalized bytes, the C++ tier's BN and twist
   MSM results normalized by a wrapper here (the KoE commitment is hashed
   as the backend returned it);
9. the probe kernels P1-P4 (verifiable_mpc_tpu_torch/probes): the loop
   bodies read in the SASS of the built library (the instructions a step,
   the wide products a field product), each kernel held against its plain
   version on the TPU probes' full tiles at 1, 7, 33 and 1,000 steps and
   at every other shape the entry points time (the full-card lane counts,
   P3's one lane) at 1, 7 and 33 steps (u32 and canonical field values
   equal, f32 within F32_ULPS units in the last place below 1,000 steps;
   at the full count two launches give the same bits; 33 steps run the
   unrolled loop body twice), then both probes' entry points
   (probe_vpu.main, probe_carrychain.main) with the launch counts zeroed
   just before: every case timed at the TPU probes' shapes and counts and
   at a lane count that fills the card (P3 also at one lane), each rate
   beside the bound model's;
10. each kernel's bound again by the field products its work needs at the
   product rate P2 measured in phase 9 at full occupancy
   (``bound_product_ms``, beside the multiply model's ``bound_ms``), and
   K14's latency floor, its chain's dependent products at P3's one-lane
   time (``latency_floor_ms``);
11. the ``kernels`` JSON line (twenty kernels), then the result line
   ``{"ok": true, "device": {...}}``.

Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_LOG2_MULS = 16  # BASELINE.json's target size
PARITY_LOG2_MULS = 12
MSM_BENCH_LOG2 = 16
CHECK_SIZES = (1, 300, 4096)
SNARK_LOG2_MULS = 16  # BASELINE.json's Pinocchio size
# the QAP of 2^16 chain multiplications has m = d + 1 = 2^17 (each line
# adds its product and its sum): the prove's MSMs and keygen's combs run
# over about 2^17 points or exponents
SNARK_SHAPE = 1 << (SNARK_LOG2_MULS + 1)
SNARK_PARITY_LOG2_MULS = 10
KOE_LOG2_MULS = 10
ED_TIER_SIZES = (128, 256, 512, 1024, 2048, 4096, 8192)
BN_TIER_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384)
BN2_TIER_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384, SNARK_SHAPE)
CUTOVER_HALVES = tuple(1 << k for k in range(7, 15))
BUCKET_SWEEP_LOG2 = (12, 14, 16, 17, 18)
BUCKET_PARITY_MIN_BATCH = 512  # the bucket serves the 2^12 prove's MSMs
MONT_ADD_SHAPE = 1 << 17
FLAGSHIP_FOLDS = 8  # K3's rounds above the engine's cut-over at 2^16
PINOCCHIO_TAILS = 7  # the G1 MSMs of a Pinocchio prove on the card

# field multiplies (squarings included) of the group operations in
# verifiable_mpc_tpu_torch/csrc/fe25519.cuh, for the bounds
ADD, ADD_PRE, DBL, TO_PRE = 9, 8, 8, 1
ADD_AFF = 7  # the mixed add of an affine entry (K4)
INV = 265  # one Fermat inversion: 254 squarings and 11 multiplies
DBL_NO_T = 7  # a doubling whose T nothing reads (K3)
NORM_EACH = 6  # per point of a batch: Montgomery batch inversion's 3,
#                then x = X/Z, y = Y/Z and t = x*y

# BN256 G1 (csrc/fp254.cuh, csrc/bn254_kernels.cuh), counted in 32-bit
# multiplies as the functions need them: a Montgomery product (M) is 64 + 64
# 32x32->64 products (lo and hi each) and 8 low products; a square (S)
# needs 36 limb products where a product needs 64; times b3 = 9 is four
# additions, no multiply.  The complete add is 12 M, the doubling 6 M +
# 2 S, an input row's encoding (X Z, Y, Z^3) R 5 M + 1 S.
BN_M = 2 * 64 + 2 * 64 + 8
BN_S = 2 * 36 + 2 * 64 + 8
BN_ADD = 12 * BN_M
BN_MADD = 11 * BN_M  # the mixed add of an affine point (RCB15 Algorithm 8)
BN_DBL = 6 * BN_M + 2 * BN_S
BN_ENC = 5 * BN_M + BN_S
BN_INV = 255 * BN_S + 124 * BN_M  # p - 2: 255 squarings, 124 multiplies
BN_NORM_EACH = 6 * BN_M  # batch inversion's 3, Z^-1 out of Montgomery
#                          form, x, y

# BN256 twist (csrc/fp2_254.cuh, csrc/bn2_kernels.cuh), in the same 32-bit
# multiplies: a GF(p^2) product is 3 M (Karatsuba), a GF(p^2) square 2 M,
# a product by 3b' (a full GF(p^2) constant) 3 M.  The complete add is 12
# products and 2 by 3b' (42 M), the doubling 6 products, 2 squares and one
# by 3b' (25 M), the mixed add of an affine point (RCB15 Algorithm 8: 11
# products and 2 by 3b', 39 M), an input row's encoding 6 M into
# Montgomery form plus (X Z, Z^2, Z^3) (14 M).  An inversion in GF(p^2) is
# the norm's 2 S, one inversion in GF(p) and 2 M; batch normalization is 3
# GF(p^2) products a point, Z^-1 out of Montgomery form (2 M), x and y
# (6 M).
BN2_ADD = 42 * BN_M
BN2_MADD = 39 * BN_M
BN2_DBL = 25 * BN_M
BN2_ENC = 14 * BN_M
BN2_INV = 2 * BN_S + BN_INV + 2 * BN_M
BN2_NORM_EACH = 17 * BN_M
# an entry of K9's table normalized in Montgomery form (the running
# product, Z^-1, the inverse's update, x and y: 5 GF(p^2) products)
BN2_ENTRY_NORM = 15 * BN_M

DEV = "cuda"

SOURCES = {
    "msm_accumulate": "verifiable_mpc_tpu_torch/csrc/msm_accum.cu",
    "msm_tail": "verifiable_mpc_tpu_torch/csrc/msm_tail.cu",
    "fold": "verifiable_mpc_tpu_torch/csrc/fold.cu",
    "comb": "verifiable_mpc_tpu_torch/csrc/comb.cu",
    "bn_msm_accumulate": "verifiable_mpc_tpu_torch/csrc/bn_msm_accum.cu",
    "bn_msm_tail": "verifiable_mpc_tpu_torch/csrc/bn_msm_tail.cu",
    "bn_fold": "verifiable_mpc_tpu_torch/csrc/bn_fold.cu",
    "bn_comb": "verifiable_mpc_tpu_torch/csrc/bn_comb.cu",
    "bn2_msm_accumulate": "verifiable_mpc_tpu_torch/csrc/bn2_msm_accum.cu",
    "bn2_msm_tail": "verifiable_mpc_tpu_torch/csrc/bn2_msm_tail.cu",
    "bn2_bexp": "verifiable_mpc_tpu_torch/csrc/bn2_bexp.cu",
    "bn2_fold": "verifiable_mpc_tpu_torch/csrc/bn2_fold.cu",
    "bucket_accumulate": "verifiable_mpc_tpu_torch/csrc/bucket_accum.cu",
    "bucket_reduce": "verifiable_mpc_tpu_torch/csrc/bucket_reduce.cu",
    "bexp": "verifiable_mpc_tpu_torch/csrc/bexp.cu",
    "mont_add": "verifiable_mpc_tpu_torch/csrc/ed_add_mont.cu",
    "probe_vpu": "verifiable_mpc_tpu_torch/csrc/probe_vpu.cu",
    "probe_field": "verifiable_mpc_tpu_torch/csrc/probe_vpu.cu",
    "probe_chain": "verifiable_mpc_tpu_torch/csrc/probe_carrychain.cu",
    "probe_raw": "verifiable_mpc_tpu_torch/csrc/probe_carrychain.cu",
}

_BN = " with the BN adapter verifiable_mpc_tpu/ops/bn_pallas.py:54,88"
_BN2 = (" with the twist adapter verifiable_mpc_tpu/ops/bn2_pallas.py:118,"
        "143")
BN_PATH = ("bn_", "bn2_")  # launch-count keys of the Pinocchio path
REPLACES = {
    "msm_accumulate": "verifiable_mpc_tpu/ops/msm_pallas.py:555",
    "msm_tail": "verifiable_mpc_tpu/ops/msm_pallas.py:616",
    "fold": "verifiable_mpc_tpu/ops/msm_pallas.py:929",
    "comb": "verifiable_mpc_tpu/ops/msm_pallas.py:1284",
    "bn_msm_accumulate": "verifiable_mpc_tpu/ops/msm_pallas.py:555" + _BN,
    "bn_msm_tail": "verifiable_mpc_tpu/ops/msm_pallas.py:616" + _BN,
    "bn_fold": "verifiable_mpc_tpu/ops/msm_pallas.py:929" + _BN,
    "bn_comb": "verifiable_mpc_tpu/ops/msm_pallas.py:1284" + _BN,
    "bn2_msm_accumulate": "verifiable_mpc_tpu/ops/msm_pallas.py:555" + _BN2,
    "bn2_msm_tail": "verifiable_mpc_tpu/ops/msm_pallas.py:616" + _BN2,
    "bn2_bexp": "verifiable_mpc_tpu/ops/msm_pallas.py:1129" + _BN2,
    "bn2_fold": "verifiable_mpc_tpu/ops/msm_pallas.py:929" + _BN2,
    "bucket_accumulate": "verifiable_mpc_tpu/ops/msm_bucket.py:217",
    "bucket_reduce": "verifiable_mpc_tpu/ops/msm_bucket.py:265",
    "bexp": "verifiable_mpc_tpu/ops/msm_pallas.py:1129",
    "mont_add": "verifiable_mpc_tpu/ops/pallas_kernels.py:53",
    "probe_vpu": "probes/probe_vpu.py:38",
    "probe_field": "probes/probe_vpu.py:94",
    "probe_chain": "probes/probe_carrychain.py:73",
    "probe_raw": "probes/probe_carrychain.py:89",
}
ED_KERNELS = ("msm_accumulate", "msm_tail", "fold", "comb")
BUCKET_KERNELS = ("bucket_accumulate", "bucket_reduce")
ENTRY_KERNELS = ("bexp", "mont_add")  # entry points on no protocol path
PROBE_KERNELS = ("probe_vpu", "probe_field", "probe_chain", "probe_raw")
PROBE_CHECK_STEPS = (1, 7, 33, 1000)  # on the TPU probes' tiles
PROBE_WIDE_STEPS = (1, 7, 33)  # on the full-card and one-lane shapes
F32_ULPS = 4  # f32_fma against its plain version below 1,000 steps
# SASS of the probe loops: the instructions a step of each P1 case (by
# opcode, as the loop body holds VPU_UNROLL = 16 steps) and the least count
# of 32 x 32 -> 64-bit products (IMAD.WIDE.U32) a field product needs:
# 64 for a pseudo-Mersenne product, 64 + 56 for a word-by-word Montgomery
# reduction (m * p[1..7] wide; m * p[0] may keep only its high half)
VPU_UNROLL = 16
SASS_STEP = {
    "probe_vpu_kernelILi0E": {"IMAD": 1, "LOP3.LUT": 1, "LEA.HI": 1},
    "probe_vpu_kernelILi1E": {"IMAD": 1},
    "probe_vpu_kernelILi2E": {"IMAD.IADD": 1, "LOP3.LUT": 1},
    "probe_vpu_kernelILi3E": {"FFMA": 1},
    "probe_raw_kernel": {"IMAD": 1},
}
SASS_WIDE = {
    "probe_field_kernelILi0E": 64, "probe_field_kernelILi1E": 120,
    "probe_field_kernelILi2E": 120, "probe_chain_kernelILi1E": 64,
    "probe_chain_kernelILi4E": 4 * 64,
}


def log(msg):
    print(msg, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"   {self.name}: {time.perf_counter() - self.t0:.3f} s")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(torch, fn, reps: int = 3) -> float:
    """Best of ``reps`` CUDA-event timings of ``fn`` (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        best = min(best, s.elapsed_time(e))
    return best


def cuda_once(torch, fn):
    """(result, ms) of one run of ``fn`` timed with CUDA events: the plain
    versions at full shape take seconds, so their one correctness run is
    their timed run."""
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e)


def max_abs_err(torch, a, b) -> float:
    """Largest |a - b| over the canonical u64 limbs (0 when identical)."""
    if torch.equal(a, b):
        return 0.0
    d = (a.cpu().numpy().view(np.uint64).astype(np.float64)
         - b.cpu().numpy().view(np.uint64).astype(np.float64))
    return float(np.abs(d).max()) or 1.0


def bound(torch, nbytes: float, field_muls: float, per_mul: int = None):
    """(ms, "bytes" or "operations"): the larger of the time to move
    ``nbytes`` at the memory rate and the time for ``field_muls`` field
    multiplies of ``per_mul`` 32-bit multiplies each (a product mod
    2^255 - 19 by default) at the 32-bit integer multiply rate, both from
    the port's bound model."""
    from verifiable_mpc_tpu_torch import bound_model as bm

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    by_bytes = nbytes / bm.HBM_BYTES_PER_S * 1e3
    if per_mul is None:
        per_mul = bm.MULS_PER_FIELD_MUL
    by_ops = bm.ops_ms(sms, field_muls * per_mul)
    return (max(by_bytes, by_ops),
            "operations" if by_ops >= by_bytes else "bytes")


def log_stat(name: str, st: dict, unit: str):
    log(f"   {name} [{st['shape']}]: {st['ms']:.3f} ms, plain "
        f"{st['plain_ms']:.1f} ms, bound {st['bound_ms']:.4f} ms "
        f"({st['bound_by']}), {unit} {st['muls']}, max_abs_err {st['err']}")


def product_bounds(stats: dict, rates: dict):
    """Each kernel's bound by the field products its work needs
    (``products``, in products of its curve's field) at the product rate
    the probe phase measured at full occupancy (``rates``: per second,
    "ed" for ``fe_mul``, "bn" for ``fp_mul``), or by its bytes if larger:
    ``bound_product_ms``, beside the multiply model's ``bound_ms``."""
    from verifiable_mpc_tpu_torch import bound_model as bm

    for name, st in stats.items():
        if "products" not in st:
            continue
        rate = rates["bn" if name.startswith(BN_PATH) else "ed"]
        st["bound_product_ms"] = max(st["bytes"] / bm.HBM_BYTES_PER_S * 1e3,
                                     bm.products_ms(st["products"], rate))
        log(f"   {name}: {st['ms']:.3f} ms, {st['ms'] / st['bound_ms']:.1f} x"
            f" the multiply model's bound {st['bound_ms']:.4f} ms, "
            f"{st['ms'] / st['bound_product_ms']:.1f} x the measured product"
            f" rate's {st['bound_product_ms']:.4f} ms")
        if "chain_products" in st:
            st["latency_floor_ms"] = (st["chain_products"]
                                      * rates["dependent_ms"])
            log(f"   {name}: latency floor {st['latency_floor_ms']:.4f} ms "
                f"({st['chain_products']} dependent products at "
                f"{rates['dependent_ms'] * 1e6:.1f} ns, P3 on one lane), "
                f"{st['ms'] / st['latency_floor_ms']:.2f} x")


def ptxas_usage(text: str) -> dict:
    """{kernel: (registers, stack bytes, spill store bytes, spill load
    bytes, static shared memory bytes)} from ptxas's -v output."""
    import re

    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name] = [int(g) for g in m.groups()]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out and len(out[name]) == 3:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name][:0] = [int(m.group(1))]
            out[name].append(int(smem.group(1)) if smem else 0)
    return {k: tuple(v) for k, v in out.items() if len(v) == 5}


# the launches of K1-K14 (each kernel's launches in order)
USAGE_KERNELS = (("K1", ("msm_table_kernel", "msm_accum_kernel")),
                 ("K2", ("msm_reduce_kernel", "msm_combine_kernel")),
                 ("K3", ("fold_norm_kernel",)),
                 ("K4", ("comb_norm_kernel",)),
                 ("K5", ("bn_table_kernel", "bn_msm_accum_kernel")),
                 ("K6", ("bn_msm_reduce_kernel", "bn_msm_combine_kernel")),
                 ("K7", ("bn_fold_norm_kernel",)),
                 ("K8", ("bn_encode_affine_kernel", "bn_comb_norm_kernel")),
                 ("K9", ("bn2_table_kernel", "bn2_table_norm_kernel",
                         "bn2_msm_accum_kernel")),
                 ("K10", ("bn2_msm_reduce_kernel", "bn2_msm_combine_kernel")),
                 ("K11", ("bn2_encode_affine_kernel", "bn2_bexp_kernel")),
                 ("K12", ("bn2_fold_norm_kernel",)),
                 ("K13", ("bucket_pre_kernel", "bucket_accum_kernel",
                          "bucket_combine_kernel")),
                 ("K14", ("bucket_window_kernel", "bucket_tail_kernel")))


def log_accum_usage(usage: dict):
    """The ptxas line of the launches of K1-K14."""
    parts = []
    for label, keys in USAGE_KERNELS:
        for key in keys:
            hit = [v for k, v in usage.items() if f"{len(key)}{key}" in k]
            if hit:
                r, st, ss, sl, sm = hit[0]
                parts.append(f"{label} {key} {r} registers, {st} bytes stack,"
                             f" {ss}/{sl} bytes spill stores/loads, {sm} "
                             "bytes shared")
            else:
                parts.append(f"{label} {key} not in the build output "
                             "(library current)")
    log("   ptxas: " + "; ".join(parts))


def chain_circuit(cb, gf, n_muls: int):
    """x_{i+1} = x_i * x_i + 1: n_muls multiplication gates (the chain of
    bench_ac20.py)."""
    circuit = cb.Circuit()
    x = cb.CircuitVar(gf(3), circuit, "x")
    acc = x
    for _ in range(n_muls - 1):
        acc = acc * acc + 1
    out = acc * x
    out.label_output("out")
    return circuit


def padded_circuit(vm, log2_muls: int):
    import verifiable_mpc_tpu_torch.ac20.circuit_builder as cb
    import verifiable_mpc_tpu_torch.ac20.circuit_sat_cb as cs
    from verifiable_mpc_tpu_torch.fields import GF
    from verifiable_mpc_tpu_torch.groups import EllipticCurve

    group = EllipticCurve("Ed25519", "projective")
    gf = GF(group.order)
    circuit = chain_circuit(cb, gf, 1 << log2_muls)
    x = circuit.initial_inputs()
    _check, padding, g_length = cs.check_input_length_power_of_2(x, circuit)
    for i in range(padding):
        cb.CircuitVar(gf(0), circuit, "unused_" + str(i))
    return group, gf, circuit, circuit.initial_inputs(), g_length


def canonical(obj):
    """Proof with every point normalized: backends give different projective
    representatives of the same element; the hashes see normalized ones."""
    if hasattr(obj, "normalize"):
        return obj.normalize()
    if isinstance(obj, dict):
        return {k: canonical(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(canonical(v) for v in obj)
    return obj


def verified(v) -> bool:
    return all(all(x.values()) if isinstance(x, dict) else bool(x)
               for x in v.values())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def edge_scalars(ell: int):
    return [0, 1, ell // 2 - 1, ell // 2, ell // 2 + 1, ell - 2, ell - 1]


def comb_exponents(n: int, G: int, rng, order: int) -> list:
    """n exponents for a comb kernel (K4, K8, K11) that runs G threads: the
    edge scalars (0 among them), then random ones; exponent 0 also at index 1
    (in a group with others) and at every index of thread 0's group (0, G,
    2G, ...: a whole normalization group of identities)."""
    exps = (edge_scalars(order) + [rng.randrange(order)
                                   for _ in range(n)])[:n]
    for i in range(0, n, G):
        exps[i] = 0
    if n > 1:
        exps[1] = 0
    return exps


def log_groups(name: str, n: int, G: int):
    log(f"   {name} at n={n}: {G} threads, normalization groups of "
        f"{n // G}-{-(-n // G)} exponents (n mod G = {n % G}), thread 0's "
        "group all exponent 0")


def random_points(native, n: int, rng) -> np.ndarray:
    """[n, 16] u64 rows of n distinct points, made by the C++ tier."""
    from verifiable_mpc_tpu_torch.groups.edwards import ELL, EdwardsPoint

    exps = [rng.randrange(1, ELL) for _ in range(n)]
    return native._pts_to_u64(native.ed_batch_exp(EdwardsPoint.generator,
                                                  exps))


# K4's edge exponents beside those of comb_exponents (0 and l - 1 among
# them): one whose windows 1-61 are all 0 (a run of zeros), and 7 * 2^200
COMB_EDGES = [(1 << 250) + 3, 7 << 200]


def check_small(torch, native, mc, ced, rng):
    """K1 + K2, K3, K4 against their plain versions (and the C++ tier) at
    the CHECK_SIZES, with the edge scalars in every batch (K4: the
    exponents of ``comb_exponents`` at its thread count, COMB_EDGES last,
    and an identity base too)."""
    from verifiable_mpc_tpu_torch.groups.edwards import ELL, EdwardsPoint

    dev = torch.device(DEV)
    G3 = mc.fold_threads(1 << 30, dev)
    assert max(CHECK_SIZES) < G3, "K3's check sizes are not below its G"
    log(f"   K3 runs G = {G3} threads at most: one element a thread below")
    for n in CHECK_SIZES:
        rows = random_points(native, n, rng)
        sc = (edge_scalars(ELL) + [rng.randrange(ELL) for _ in range(n)])[:n]
        arr = native._ints_to_u64x4(sc, ELL)
        pk, nw = mc.packed_digits(arr)
        pts = ced.from_reference_rows(rows, dev)
        dig = torch.from_numpy(pk).to(dev)
        got = mc.msm_rows(pts[None], dig[None])
        plain = mc.msm_plain(pts[None], dig[None])
        host = native.ed_msm_arr(np.ascontiguousarray(rows), arr)
        host_n = native.ed_batch_normalize_arr(host.reshape(1, 16).copy())
        assert torch.equal(got, plain), f"K1+K2 != plain at n={n}"
        assert np.array_equal(ced.to_rows(got), host_n), f"K1+K2 != C++ n={n}"

        gr = random_points(native, n, rng)
        gl_t, gr_t = pts, ced.from_reference_rows(gr, dev)
        for c in [*mc.fold_challenges(ELL).values(), rng.randrange(ELL)]:
            cdig = mc.fold_digits(c)
            got = mc.fold_rows(gl_t, gr_t, cdig)
            plain = mc.fold_plain(gl_t, gr_t, cdig)
            host = native.ed_fold_arr(np.ascontiguousarray(rows),
                                      np.ascontiguousarray(gr),
                                      native._ints_to_u64x4([c], ELL))
            native.ed_batch_normalize_arr(host)
            assert torch.equal(got, plain), f"K3 != plain at n={n}, c={c}"
            assert np.array_equal(ced.to_rows(got), host), \
                f"K3 != C++ at n={n}, c={c}"

        exps = comb_exponents(n, mc.comb_threads(n, dev), rng, ELL)
        if n > 10:
            exps[-len(COMB_EDGES):] = COMB_EDGES
        pk4, nw4 = mc.packed_digits(native._ints_to_u64x4(exps, ELL))
        dig4 = torch.from_numpy(pk4).to(dev)
        for base in (EdwardsPoint.generator ** rng.randrange(1, ELL),
                     EdwardsPoint.identity):
            table = mc.comb_table(base, nw4, dev)
            got = mc.comb_rows(table, dig4)
            plain = mc.comb_plain(table, dig4)
            host = ed_host_rows(native, native.ed_batch_exp(base, exps))
            assert torch.equal(got, plain), f"K4 != plain at n={n}"
            assert np.array_equal(ced.to_rows(got), host), f"K4 != C++ n={n}"
        torch.cuda.synchronize()
        log(f"   n={n}: K1+K2, K3 (at the edge challenges too), K4 (also "
            "with an identity base) equal their plain versions and the C++ "
            "tier")


# K2's cases on accumulators made here: (B, nw, S, the window whose
# accumulators are all the identity or None); the chunk counts R at these
# shapes are 2, 2, 2, 3, 1, 1 and 1, so S = 4095, 2049 and 4100 are no
# multiple
ED_TAIL_CASES = ((2, 64, 4096, 5), (1, 64, 4095, None), (2, 8, 2049, 0),
                 (1, 8, 4100, 7), (1, 8, 1501, None), (2, 2, 5, None),
                 (1, 1, 1, None))


def check_tail_ed(torch, native, mc, ced, rng):
    """K2 alone on accumulators made from 4,096 points (one in 64 the
    identity, every third with Z != 1, gathered at random) at
    ED_TAIL_CASES, and on accumulators where every window sums to the
    identity (P and -P): against msm_tail_plain and the C++ tier's MSM of
    the same points by 16^(nw-1-w)."""
    from verifiable_mpc_tpu_torch.groups.edwards import ELL, EdwardsPoint

    dev = torch.device(DEV)
    pts = ed_points(native, 4096, rng, identity_at=tuple(range(3, 4096, 64)))
    rows = np.ascontiguousarray(native._pts_to_u64(pts))
    work = ced.from_reference_rows(rows, dev)
    for B, nw, S, ident in ED_TAIL_CASES:
        idx = np.array([rng.randrange(4096) for _ in range(B * nw * S)])
        if ident is not None:
            idx.reshape(B, nw, S)[:, ident] = 3  # an identity
        acc = work[torch.from_numpy(idx).to(dev)].reshape(B, nw, S, 16)
        got = mc.msm_tail(acc)
        assert torch.equal(got, mc.msm_tail_plain(acc)), \
            f"K2 != plain at B={B} nw={nw} S={S}"
        sc = native._ints_to_u64x4([16 ** (nw - 1 - w) % ELL
                                    for w in range(nw)], ELL)
        sc = np.ascontiguousarray(np.repeat(sc, S, axis=0))
        host = np.stack([native.ed_msm_arr(np.ascontiguousarray(
            rows[idx[b * nw * S:(b + 1) * nw * S]]), sc) for b in range(B)])
        native.ed_batch_normalize_arr(host)
        assert np.array_equal(ced.to_rows(got), host), \
            f"K2 != C++ at B={B} nw={nw} S={S}"
        R = mc.tail_split(S)
        log(f"   K2 at B={B} nw={nw} S={S} (R={R}, S mod R = {S % R}"
            + (f", window {ident} all identities" if ident is not None
               else "") + "): equals its plain version and the C++ tier")
    pairs = [q for p in pts[:6] for q in (p, -p)]  # 3 windows of S = 4
    acc = ced.encode_points(pairs, dev).reshape(1, 3, 4, 16)
    got = mc.msm_tail(acc)
    assert torch.equal(got, mc.msm_tail_plain(acc)), "K2 != plain at 0"
    assert ced.decode_rows(got)[0] == EdwardsPoint.identity, "K2: not 0"
    assert ced.to_rows(got)[0].tolist() == list(ced.IDENTITY_ROW)
    log("   K2 where every window sums to the identity: the identity row")


def msm_accumulate_muls(d) -> int:
    """Field multiplies that the window accumulation needs for signed
    digits d [B, nw, n]: each point's table 1..max|d| in precomputed form
    (built once, shared by its windows), then one mixed add per nonzero
    digit.  K1 does this work, but for building every point's table up to
    8 (seven mixed adds and eight conversions a point, whatever its
    digits)."""
    top = d.abs().amax(dim=1)  # [B, n]
    table = (top > 0) * (TO_PRE + (top - 1).clamp(min=0) * (ADD_PRE + TO_PRE))
    return int(table.sum()) + ADD_PRE * int((d != 0).sum())


def check_main_shapes(torch, native, mc, ced, rng, g_half: int, n_comb: int):
    """Each kernel alone at the flagship's shapes: result against the plain
    version on the same inputs, CUDA-event time, plain time, bound."""
    from verifiable_mpc_tpu_torch.groups.edwards import ELL, EdwardsPoint

    dev = torch.device(DEV)
    stats = {}

    # K1 / K2: a protocol-4 round 0 (both MSMs of the round, 64 windows)
    rows = random_points(native, 2 * g_half, rng)
    g = ced.from_reference_rows(rows, dev)
    z = native._ints_to_u64x4(
        edge_scalars(ELL) + [rng.randrange(ELL) for _ in range(2 * g_half - 7)],
        ELL,
    )
    pk, nw = mc.packed_digits(z)
    d2 = torch.from_numpy(np.stack([pk[:, :g_half], pk[:, g_half:]])).to(dev)
    pts = torch.stack([g[g_half:], g[:g_half]])
    S = mc.slices_for(g_half, mc.ACCUM_POINTS_PER_THREAD)
    acc = mc.msm_accumulate(pts, d2, S)
    acc_plain = mc.msm_accumulate_plain(pts, d2, S)
    norm = lambda a: ced.normalize_rows(ced.split_rows(a))  # noqa: E731
    k1_err = max_abs_err(torch, norm(acc), norm(acc_plain))
    assert k1_err == 0.0, "K1 accumulators differ from the plain version"
    out = mc.msm_tail(acc)
    out_plain = mc.msm_tail_plain(acc)
    k2_err = max_abs_err(torch, out, out_plain)
    assert k2_err == 0.0, "K2 differs from the plain version"
    B = 2
    k1_bytes = B * g_half * 128 + d2.numel() + B * nw * S * 128
    k1_muls = msm_accumulate_muls(mc.unpack_digits(d2))
    stats["msm_accumulate"] = dict(
        err=k1_err,
        ms=cuda_ms(torch, lambda: mc.msm_accumulate(pts, d2, S)),
        plain_ms=cuda_ms(torch, lambda: mc.msm_accumulate_plain(pts, d2, S),
                         reps=1),
        shape=f"B=2 n={g_half} nw={nw} S={S}", bytes=k1_bytes, muls=k1_muls,
    )
    # per MSM: sum the S slices of each window, Horner over the windows
    # (no doublings before the first), normalize the one point
    k2_muls = (B * (nw * (S - 1) * ADD + (nw - 1) * 4 * DBL + nw * ADD
                    + NORM_EACH) + INV)
    k2_bytes = B * nw * S * 128 + B * 128
    stats["msm_tail"] = dict(
        err=k2_err,
        ms=cuda_ms(torch, lambda: mc.msm_tail(acc)),
        plain_ms=cuda_ms(torch, lambda: mc.msm_tail_plain(acc), reps=1),
        shape=f"B=2 nw={nw} S={S} R={mc.tail_split(S)}", bytes=k2_bytes,
        muls=k2_muls,
    )

    # K3: the round-0 fold of the same generator vector, also against the
    # C++ tier (2^17 is a ragged 2.6 groups of K3's thread count)
    c = rng.randrange(ELL)
    cdig = mc.fold_digits(c)
    gl, gr = g[:g_half], g[g_half:]
    got = mc.fold_rows(gl, gr, cdig)
    plain = mc.fold_plain(gl, gr, cdig)
    k3_err = max_abs_err(torch, got, plain)
    assert k3_err == 0.0, "K3 differs from the plain version"
    host = native.ed_fold_arr(np.ascontiguousarray(rows[:g_half]),
                              np.ascontiguousarray(rows[g_half:]),
                              native._ints_to_u64x4([c], ELL))
    native.ed_batch_normalize_arr(host)
    assert np.array_equal(ced.to_rows(got), host), "K3 != C++ at the shape"
    G3 = mc.fold_threads(g_half, dev)
    log(f"   K3 at n={g_half}: {G3} threads, normalization groups of "
        f"{g_half // G3}-{-(-g_half // G3)} elements (n mod G = "
        f"{g_half % G3})")
    # per element: the table of odd multiples 1..max |digit| of c (2 g_l
    # and the adds), from c's first nonzero NAF digit on a doubling a digit
    # (T only before an add, or after the last digit), a mixed add per
    # nonzero digit after the first (the first is the start, 1 product for
    # its T), the add of g_r and its share of the batch normalization
    nz = np.flatnonzero(cdig)
    first, top = int(nz[0]), int(np.abs(cdig.astype(np.int16)).max())
    later = cdig[first + 1:]
    with_t = int((later != 0).sum()) + int(later.size > 0 and later[-1] == 0)
    k3_muls = g_half * (
        2 * TO_PRE + DBL + (top - 1) // 2 * (ADD_PRE + TO_PRE) + 1
        + later.size * DBL_NO_T + with_t * (DBL - DBL_NO_T)
        + int((later != 0).sum()) * ADD_PRE + ADD + NORM_EACH
    ) + INV
    old_dig = mc.scalar_digits([c])[:, 0]
    old_first = int(np.flatnonzero(old_dig)[0])
    old_muls = g_half * (
        TO_PRE + (int(old_dig.max()) - 1) * (ADD_PRE + TO_PRE)
        + (len(old_dig) - 1 - old_first) * 4 * DBL
        + int((old_dig != 0).sum()) * ADD_PRE + ADD + NORM_EACH) + INV
    k3_bytes = 3 * g_half * 128
    log(f"   K3's bound recounted to a width-5 NAF and doublings without T: "
        f"{k3_muls / g_half:.1f} field products an element, "
        f"{bound(torch, k3_bytes, k3_muls)[0]:.4f} ms (unsigned digits and "
        f"full doublings, as counted before: {old_muls / g_half:.1f}, "
        f"{bound(torch, k3_bytes, old_muls)[0]:.4f} ms)")
    stats["fold"] = dict(
        err=k3_err,
        ms=cuda_ms(torch, lambda: mc.fold_rows(gl, gr, cdig)),
        plain_ms=cuda_ms(torch, lambda: mc.fold_plain(gl, gr, cdig), reps=1),
        shape=f"n={g_half} digits={len(cdig)}", bytes=k3_bytes, muls=k3_muls,
    )

    # K4: create_generators' comb over n_comb full-size exponents (thread
    # 0's normalization group all exponent 0; n_comb is no multiple of G),
    # its table built uncached first
    G4 = mc.comb_threads(n_comb, dev)
    exps = comb_exponents(n_comb, G4, rng, ELL)
    log_groups("K4", n_comb, G4)
    pk4, nw4 = mc.packed_digits(native._ints_to_u64x4(exps, ELL))
    dig4 = torch.from_numpy(pk4).to(dev)
    mc._COMB_TABLES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = mc.comb_table(EdwardsPoint.generator, nw4, dev)
    torch.cuda.synchronize()
    log(f"   K4's comb table ({table.shape[0]} affine rows, host law, one "
        f"batch normalization, upload) built uncached in "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    got = mc.comb_rows(table, dig4)
    plain, k4_plain = cuda_once(torch, lambda: mc.comb_plain(table, dig4))
    k4_err = max_abs_err(torch, got, plain)
    assert k4_err == 0.0, "K4 differs from the plain version"
    host = ed_host_rows(native, native.ed_batch_exp(EdwardsPoint.generator,
                                                    exps))
    assert np.array_equal(ced.to_rows(got), host), "K4 != C++ at the shape"
    # the sum of an exponent's nonzero entries: a mixed add of 7 products
    # for each after the first (the last without T, the first entry's T
    # one product), then its share of the batch normalization
    nz4 = (mc.unpack_digits(dig4) != 0).sum(dim=0)
    k4_muls = (ADD_AFF * int((nz4 - 1).clamp(min=0).sum())
               + n_comb * NORM_EACH + INV)
    old_muls = int(nz4.sum()) * ADD_PRE + n_comb * NORM_EACH + INV
    k4_bytes = table.numel() * 8 + dig4.numel() + n_comb * 128
    log(f"   K4's bound recounted to mixed adds of affine entries: "
        f"{k4_muls / n_comb:.1f} field products an exponent, "
        f"{bound(torch, k4_bytes, k4_muls)[0]:.4f} ms (an add of 8 products"
        f" a nonzero window, as counted before: {old_muls / n_comb:.1f}, "
        f"{bound(torch, k4_bytes, old_muls)[0]:.4f} ms)")
    stats["comb"] = dict(
        err=k4_err,
        ms=cuda_ms(torch, lambda: mc.comb_rows(table, dig4)),
        plain_ms=k4_plain,
        shape=f"n={n_comb} nw={nw4} G={G4}", bytes=k4_bytes, muls=k4_muls,
    )
    for name, st in stats.items():
        st["bound_ms"], st["bound_by"] = bound(torch, st["bytes"], st["muls"])
        st["products"] = st["muls"]
        log_stat(name, st, "field muls")
    return stats


# ---------------------------------------------------------------------------
# phases 4-5: MSM against the C++ tier, engine cut-over
# ---------------------------------------------------------------------------


def msm_bench(torch, native, mc, ced, rng):
    from verifiable_mpc_tpu_torch.groups.edwards import ELL

    n = 1 << MSM_BENCH_LOG2
    rows = np.ascontiguousarray(random_points(native, n, rng))
    pts = ced.from_reference_rows(rows, DEV)[None]
    gpu, cpu = [], []
    for rep in range(6):  # rep 0 warms up; distinct scalars every rep
        arr = native._ints_to_u64x4([rng.randrange(ELL) for _ in range(n)],
                                    ELL)
        pk, _nw = mc.packed_digits(arr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dig = torch.from_numpy(pk).to(DEV)[None]
        got = ced.to_rows(mc.msm_rows(pts, dig))  # synchronizes
        t1 = time.perf_counter()
        host = native.ed_msm_arr(rows, arr)
        t2 = time.perf_counter()
        native.ed_batch_normalize_arr(host.reshape(1, 16))
        assert np.array_equal(got[0], host), "GPU MSM != C++ MSM at 2^16"
        if rep:
            gpu.append(t1 - t0)
            cpu.append(t2 - t1)
    for name, ts in (("gpu K1+K2 (upload + launch + download)", gpu),
                     ("c++ native.ed_msm_arr", cpu)):
        log(f"   msm 2^{MSM_BENCH_LOG2} {name}: best {min(ts) * 1e3:.3f} ms, "
            f"mean {statistics.mean(ts) * 1e3:.3f} ± "
            f"{statistics.stdev(ts) * 1e3:.3f} ms over {len(ts)} reps")
    ed_tier(native, mc, rng)


def ed_tier(native, mc, rng):
    """The Ed25519 MSM (K1 + K2) and comb (K4) as the dispatch calls them
    (host points and scalars in, a host point out) on the card and on the
    C++ tier at the ED_TIER_SIZES, best of 3 with distinct scalars every
    rep (the sweep behind MIN_MSM_BATCH)."""
    from verifiable_mpc_tpu_torch.groups.edwards import ELL

    pts = ed_points(native, ED_TIER_SIZES[-1], rng, rescale=False)
    base = pts[1]
    for size in ED_TIER_SIZES:
        ts = {"msm": [], "c++ msm": [], "comb": [], "c++ comb": []}
        for rep in range(4):  # rep 0 warms up
            sc = [rng.randrange(ELL) for _ in range(size)]
            t0 = time.perf_counter()
            a = mc.msm(pts[:size], sc)
            t1 = time.perf_counter()
            b = native.ed_msm(pts[:size], sc)
            t2 = time.perf_counter()
            ca = mc.batch_exp_comb(base, sc)
            t3 = time.perf_counter()
            cb_ = native.ed_batch_exp(base, sc)
            t4 = time.perf_counter()
            assert a == b, f"GPU Ed25519 MSM != C++ at n={size}"
            assert ca == cb_, f"GPU Ed25519 comb != C++ at n={size}"
            if rep:
                for k, t in zip(ts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                    ts[k].append(t)
        log(f"   ed tier n={size}: msm gpu {min(ts['msm']) * 1e3:.3f} ms, "
            f"c++ {min(ts['c++ msm']) * 1e3:.3f} ms; comb gpu "
            f"{min(ts['comb']) * 1e3:.3f} ms, c++ "
            f"{min(ts['c++ comb']) * 1e3:.3f} ms")


def cutover(torch, native, mc, ced, rng):
    """Per half size: one engine round on the card (both round MSMs, fold,
    both downloads) against the C++ resident engine's round."""
    from verifiable_mpc_tpu_torch.groups.edwards import ELL

    rows_all = np.ascontiguousarray(
        random_points(native, 2 * CUTOVER_HALVES[-1], rng))
    faster = []
    for half in CUTOVER_HALVES:
        rows = np.ascontiguousarray(rows_all[: 2 * half])
        z = native._ints_to_u64x4([rng.randrange(ELL) for _ in range(2 * half)],
                                  ELL)
        c = rng.randrange(ELL)
        g = ced.from_reference_rows(rows, DEV)
        c4 = native._ints_to_u64x4([c], ELL)

        def gpu_round():
            pk, _nw = mc.packed_digits(z)
            d2 = torch.from_numpy(
                np.stack([pk[:, :half], pk[:, half:]])).to(DEV)
            ab = mc.msm_rows(torch.stack([g[half:], g[:half]]), d2)
            nxt = mc.fold_rows(g[:half], g[half:], mc.fold_digits(c))
            return ced.to_rows(ab), ced.to_rows(nxt)

        def cpu_round():
            a = native.ed_msm_arr(np.ascontiguousarray(rows[half:]),
                                  np.ascontiguousarray(z[:half]))
            b = native.ed_msm_arr(np.ascontiguousarray(rows[:half]),
                                  np.ascontiguousarray(z[half:]))
            nxt = native.ed_fold_arr(np.ascontiguousarray(rows[:half]),
                                     np.ascontiguousarray(rows[half:]), c4)
            native.ed_batch_normalize_arr(nxt)
            return a, b, nxt

        tg, tc = [], []
        for _ in range(4):
            t0 = time.perf_counter()
            gpu_round()
            t1 = time.perf_counter()
            cpu_round()
            t2 = time.perf_counter()
            tg.append(t1 - t0)
            tc.append(t2 - t1)
        g_ms, c_ms = min(tg[1:]) * 1e3, min(tc[1:]) * 1e3
        faster.append(g_ms < c_ms)
        log(f"   round half={half}: gpu {g_ms:.3f} ms, c++ {c_ms:.3f} ms")
    rec = None
    for i in range(len(CUTOVER_HALVES)):
        if all(faster[i:]):
            rec = CUTOVER_HALVES[i]
            break
    log(f"   cutover: the card wins every round from half={rec}")


# ---------------------------------------------------------------------------
# phases 6-7: the flagship and parity
# ---------------------------------------------------------------------------


def flagship(torch, vm, mc, built, bk=None):
    """Generators, prove and verify of the circuit ``built`` with
    enable_gpu(); with ``bk`` the bucket MSM is registered too
    (``bk.register()``), K13 + K14 must run in the prove, and enable_gpu()
    restores the backends afterwards."""
    import verifiable_mpc_tpu_torch.ac20.circuit_sat_cb as cs
    from verifiable_mpc_tpu_torch.ac20 import pivot_gpu

    vm.enable_gpu(DEV)
    if bk is not None:
        bk.register()
    group, gf, circuit, x, g_length = built
    log(f"   muls={circuit.mul_ct} commitment vector length={g_length}")
    pc = cs.PivotChoice.compressed
    secs, per_stage = {}, {}

    def stage(name, fn):
        before = dict(mc.LAUNCHES)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        per_stage[name] = {k: mc.LAUNCHES[k] - before[k] for k in before}
        return out

    mc.reset_launches()
    runs0 = pivot_gpu.ENGINE_RUNS
    gens = stage("generators", lambda: cs.create_generators(g_length, pc,
                                                            group))
    proof = stage("prove", lambda: cs.circuit_sat_prover(gens, circuit, x,
                                                         gf, pc))
    ver = stage("verify", lambda: cs.circuit_sat_verifier(proof, gens,
                                                          circuit, gf, pc))
    launches = dict(mc.LAUNCHES)
    runs = pivot_gpu.ENGINE_RUNS - runs0
    if bk is not None:
        vm.enable_gpu(DEV)
    log(f"   generators {secs['generators']:.3f} s, prove {secs['prove']:.3f}"
        f" s, verify {secs['verify']:.3f} s (2^{FLAGSHIP_LOG2_MULS} muls"
        + (", bucket MSM registered)" if bk is not None else ")"))
    for name, counts in per_stage.items():
        log(f"   launches in {name}: {counts}")
    log(f"   verification {ver}; engine runs {runs}; launches {launches}")
    assert verified(ver), f"flagship proof did not verify: {ver}"
    assert runs > 0, "the resident GPU engine never ran"
    folds = (per_stage["prove"]["fold"], per_stage["verify"]["fold"])
    assert folds == (FLAGSHIP_FOLDS,) * 2, f"K3 launches {folds}"
    missing = [k for k in ED_KERNELS if launches[k] == 0]
    if bk is not None:
        missing += [k for k in BUCKET_KERNELS if per_stage["prove"][k] == 0]
    assert not missing, f"kernels never launched on the main path: {missing}"
    if bk is not None:  # protocol 5's commitment A moves to K13 + K14
        got = tuple(per_stage["prove"][k] for k in (
            "msm_accumulate", "msm_tail", *BUCKET_KERNELS))
        assert got == (9, 9, 1, 1), f"prove's K1, K2, K13, K14: {got}"
    return launches


def native_prove_launches_nothing(mc, prove):
    """Run ``prove`` under enable_native() with the launch counts zeroed
    just before, and assert that it launched no Ed25519 kernel: its
    commitments are the C++ tier's, not K1 + K2's or K13 + K14's."""
    mc.reset_launches()
    out = prove()
    ran = {k: mc.LAUNCHES[k] for k in ED_KERNELS + BUCKET_KERNELS
           if mc.LAUNCHES[k]}
    assert not ran, f"the enable_native() prove launched kernels: {ran}"
    return out


def parity(torch, vm, mc):
    import verifiable_mpc_tpu_torch.ac20.circuit_sat_cb as cs
    from verifiable_mpc_tpu_torch import rng, serialization
    from verifiable_mpc_tpu_torch.ac20 import pivot_gpu

    vm.enable_gpu(DEV)
    group, gf, circuit, x, g_length = padded_circuit(vm, PARITY_LOG2_MULS)
    pc = cs.PivotChoice.compressed
    mc.reset_launches()
    with rng.deterministic(2026):
        gens = cs.create_generators(g_length, pc, group)
    assert mc.LAUNCHES["comb"] > 0, "K4 did not make the generators"
    vm.enable_native()
    with rng.deterministic(2026):
        gens_native = cs.create_generators(g_length, pc, group)
    assert serialization.dumps(canonical(gens)) == serialization.dumps(
        canonical(gens_native)), "K4's and the C++ tier's generators differ"
    with rng.deterministic(2027):
        p_native = native_prove_launches_nothing(
            mc, lambda: cs.circuit_sat_prover(gens, circuit, x, gf, pc))
    vm.enable_gpu(DEV)
    runs0 = pivot_gpu.ENGINE_RUNS
    with rng.deterministic(2027):
        p_gpu = cs.circuit_sat_prover(gens, circuit, x, gf, pc)
    assert pivot_gpu.ENGINE_RUNS > runs0, "engine did not run at 2^12"
    b_native = serialization.dumps(canonical(p_native))
    b_gpu = serialization.dumps(canonical(p_gpu))
    assert b_native == b_gpu, "GPU and C++ proofs differ at 2^12"
    assert verified(cs.circuit_sat_verifier(p_gpu, gens, circuit, gf, pc))
    log(f"   2^{PARITY_LOG2_MULS} muls: generators ({g_length}, made by K4)"
        " equal the C++ tier's once normalized; the C++ tier's prove "
        f"launched no kernel; {len(b_gpu)} proof bytes identical to the C++ "
        "tier's, verified")


# ---------------------------------------------------------------------------
# Ed25519: the bucket MSM (K13 + K14), batch-exp (K15), Montgomery add (K16)
# ---------------------------------------------------------------------------


def ed_points(native, n: int, rng, identity_at=(), rescale=True):
    """n Ed25519 points made by the C++ tier; with ``rescale`` every third
    one with Z != 1 (identities where asked)."""
    from verifiable_mpc_tpu_torch.groups.edwards import ELL, P, EdwardsPoint

    pts = native.ed_batch_exp(EdwardsPoint.generator,
                              [rng.randrange(1, ELL) for _ in range(n)])
    for i in range(0, n, 3) if rescale else ():
        lam, q = rng.randrange(2, P), pts[i]
        pts[i] = EdwardsPoint(q.x * lam, q.y * lam, q.z * lam, q.t * lam)
    for i in identity_at:
        if i < n:
            pts[i] = EdwardsPoint.identity
    return pts


def bucket_scalars(ell: int, n: int, rng):
    """Edge scalars (order - 1 first: a batch of one is not all zero),
    scalars whose radix-256 digits include 128 and -128, then random
    ones."""
    edge = edge_scalars(ell)[::-1] + [128 + (128 << 8), ell - 128,
                                      ell - (128 << 16) - 128]
    return (edge + [rng.randrange(ell) for _ in range(n)])[:n]


def ed_host_rows(native, points) -> np.ndarray:
    from verifiable_mpc_tpu_torch.groups.edwards import EdwardsPoint

    return np.ascontiguousarray(
        native._pts_to_u64(EdwardsPoint.batch_normalize(list(points))))


def check_small_new(torch, native, mc, bk, ced, add, lm, rng):
    """K13 + K14, K15 and K16 against their plain versions and the C++ tier
    (K16: the host law) at the CHECK_SIZES, with edge scalars, digits 128
    and -128, identities and points with Z != 1; max_abs_err on the
    canonical rows."""
    from verifiable_mpc_tpu_torch.groups.edwards import ELL

    dev = torch.device(DEV)
    norm = lambda a: ced.normalize_rows(  # noqa: E731
        ced.split_rows(a.reshape(-1, 16)))
    for n in CHECK_SIZES:
        pts = ed_points(native, n, rng, identity_at=(2, 200))
        sc = bucket_scalars(ELL, n, rng)
        rows = ced.encode_points(pts, dev)
        entries, offsets, _count = bk.layout_for(sc, 8, bk.LANES, dev)
        buckets = bk.bucket_accumulate(rows, entries, offsets)
        got = bk.bucket_reduce(buckets)
        errs = [max_abs_err(torch, norm(buckets), norm(
                    bk.bucket_accumulate_plain(rows, entries, offsets))),
                max_abs_err(torch, got, bk.bucket_reduce_plain(buckets)),
                host_err(torch, got, ed_host_rows(
                    native, [native.ed_msm(pts, sc)]))]

        base = ed_points(native, 1, rng, rescale=False)[0]
        pk, _nw = mc.packed_digits(native._ints_to_u64x4(sc, ELL))
        dig = torch.from_numpy(pk).to(dev)
        table = mc.bexp_table(base, dev)
        got = mc.bexp_rows(table, dig)
        host = ed_host_rows(native, native.ed_batch_exp(base, sc))
        errs += [max_abs_err(torch, got, mc.bexp_plain(table, dig)),
                 host_err(torch, got, host),
                 host_err(torch, got, ced.to_rows(
                     mc.comb_rows(mc.comb_table(base, _nw, dev), dig)))]

        qs = ed_points(native, n, rng, identity_at=(0,))[::-1]
        if n > 3:
            qs[3] = pts[3]  # a doubling
        mp = tuple(torch.from_numpy(a).to(dev) for a in lm.encode_points(pts))
        mq = tuple(torch.from_numpy(a).to(dev) for a in lm.encode_points(qs))
        got = add.add(mp, mq)
        plain = add.add_plain(mp, mq)
        law = lm.decode_points(tuple(c.cpu().numpy() for c in got))
        errs += [max(max_abs_err(torch, a.to(torch.int64), b.to(torch.int64))
                     for a, b in zip(got, plain)),
                 0.0 if law == [a * b for a, b in zip(pts, qs)] else 1.0]
        torch.cuda.synchronize()
        log(f"   n={n}: max_abs_err K13 plain {errs[0]}; K14 plain {errs[1]}"
            f", K13+K14 c++ {errs[2]}; K15 plain {errs[3]} c++ {errs[4]} "
            f"comb {errs[5]}; K16 plain {errs[6]} host law {errs[7]}")
        assert not any(errs), f"K13-K16 differ at n={n}: {errs}"
    from verifiable_mpc_tpu_torch.groups.edwards import EdwardsPoint

    assert bk.msm(pts[:2], [0, ELL]) == EdwardsPoint.identity


def log_compact_layout(offsets, count: int, nw: int, lanes: int):
    """The compact layout's shape as K13 meets it: entries, columns (empty
    ones), the deepest column, the accumulation threads (C entries each)
    and the partials the combination sums."""
    from verifiable_mpc_tpu_torch.ops import msm_bucket_cuda as bk

    off = offsets.cpu().numpy().astype(np.int64)
    depth = np.diff(off)
    C = bk.ACCUM_ENTRIES
    threads = -(-count // C)
    t0, t1 = off[:-1] // C, np.maximum(off[1:] - 1, 0) // C
    crossing = (depth > 0) & (t1 > t0)
    log(f"   compact layout: {count} entries, {nw * lanes} columns "
        f"({int((depth == 0).sum())} empty), deepest {int(depth.max())}, "
        f"{threads} threads of {C} entries, {int(crossing.sum())} crossing "
        f"columns with {int((t1 - t0 + 1)[crossing].sum())} partials "
        f"(most {int((t1 - t0 + 1)[crossing].max(initial=0))} a column); "
        f"{count * 4 + off.size * 4} bytes")


def check_main_shapes_new(torch, native, mc, bk, ced, add, lm, rng,
                          n_msm: int, n_bexp: int, n_add: int):
    """K13 and K14 at protocol 5's commitment (n_msm points), K15 at the
    generators' shape (n_bexp exponents, beside K4), K16 at n_add: result
    against the plain version on the same inputs, CUDA-event time, plain
    time, bound."""
    from verifiable_mpc_tpu_torch.groups.edwards import ELL, EdwardsPoint

    dev = torch.device(DEV)
    stats = {}
    pts = ed_points(native, n_msm, rng, identity_at=(2,))
    sc = bucket_scalars(ELL, n_msm, rng)
    rows = ced.encode_points(pts, dev)
    u64 = torch.from_numpy(
        mc.scalars_to_u64x4(sc, ELL).view(np.int64).copy()).to(dev)
    digits = bk.trim_windows(bk.digits_signed8(u64))
    lanes = bk.LANES
    entries, offsets, count = bk.compact_layout(digits, lanes)
    nw = digits.shape[0]
    buckets = bk.bucket_accumulate(rows, entries, offsets)
    plain, k13_plain = cuda_once(
        torch, lambda: bk.bucket_accumulate_plain(rows, entries, offsets))
    norm = lambda a: ced.normalize_rows(  # noqa: E731
        ced.split_rows(a.reshape(-1, 16)))
    k13_err = max_abs_err(torch, norm(buckets), norm(plain))
    assert k13_err == 0.0, "K13 bucket sums differ from the plain version"
    out = bk.bucket_reduce(buckets)
    out_plain, k14_plain = cuda_once(
        torch, lambda: bk.bucket_reduce_plain(buckets))
    k14_err = max_abs_err(torch, out, out_plain)
    assert k14_err == 0.0, "K14 differs from the plain version"
    host = ed_host_rows(native, [native.ed_msm(pts, sc)])
    assert host_err(torch, out, host) == 0.0, "K13 + K14 differ from c++"
    nz = int(torch.count_nonzero(digits))
    assert count == nz, f"{count} entries for {nz} nonzero digits"
    log_compact_layout(offsets, count, nw, lanes)
    stats["bucket_accumulate"] = dict(
        err=k13_err, ms=cuda_ms(torch, lambda: bk.bucket_accumulate(
            rows, entries, offsets)),
        plain_ms=k13_plain, shape=f"n={n_msm} nw={nw} lanes={lanes} "
        f"entries={count} C={bk.ACCUM_ENTRIES}",
        # the points, the entry list and offsets read once, the sums written
        bytes=(n_msm * 128 + count * 4 + offsets.numel() * 4
               + nw * lanes * 128),
        muls=n_msm * TO_PRE + nz * ADD_PRE)
    # per window: the suffix sums and their sum, 2 (lanes - 1) adds; the
    # Horner ladder over the windows; one normalization
    stats["bucket_reduce"] = dict(
        err=k14_err, ms=cuda_ms(torch, lambda: bk.bucket_reduce(buckets)),
        plain_ms=k14_plain, shape=f"nw={nw} lanes={lanes}",
        bytes=nw * lanes * 128 + 128,
        muls=(nw * 2 * (lanes - 1) * ADD + (nw - 1) * 8 * DBL
              + (nw - 1) * ADD + NORM_EACH + INV),
        # its chain: 8 (nw - 1) doublings of two dependent products each
        chain_products=2 * 8 * (nw - 1))

    exps = [rng.randrange(1, ELL) for _ in range(n_bexp)]
    pk, nwb = mc.packed_digits(native._ints_to_u64x4(exps, ELL))
    dig = torch.from_numpy(pk).to(dev)
    table = mc.bexp_table(EdwardsPoint.generator, dev)
    got = mc.bexp_rows(table, dig)
    plain, k15_plain = cuda_once(torch, lambda: mc.bexp_plain(table, dig))
    k15_err = max_abs_err(torch, got, plain)
    assert k15_err == 0.0, "K15 differs from the plain version"
    d = mc.unpack_digits(dig).cpu().numpy()  # [nw, n]
    nzw = d != 0
    first = np.where(nzw.any(axis=0), nzw.argmax(axis=0), nwb - 1)
    stats["bexp"] = dict(
        err=k15_err, ms=cuda_ms(torch, lambda: mc.bexp_rows(table, dig)),
        plain_ms=k15_plain, shape=f"n={n_bexp} nw={nwb}",
        bytes=table.numel() * 8 + dig.numel() + n_bexp * 128,
        muls=(int((nwb - 1 - first).sum()) * 4 * DBL
              + int(nzw.sum()) * ADD_PRE + n_bexp * NORM_EACH + INV))

    ps = native._u64_to_pts(ced.to_rows(rows[:n_add]))
    qs = ed_points(native, n_add, rng, rescale=True)
    mp = tuple(torch.from_numpy(a).to(dev) for a in lm.encode_points(ps))
    mq = tuple(torch.from_numpy(a).to(dev) for a in lm.encode_points(qs))
    got = add.add(mp, mq)
    plain, k16_plain = cuda_once(torch, lambda: add.add_plain(mp, mq))
    k16_err = max(max_abs_err(torch, a.to(torch.int64), b.to(torch.int64))
                  for a, b in zip(got, plain))
    assert k16_err == 0.0, "K16 differs from the plain version"
    stats["mont_add"] = dict(
        err=k16_err, ms=cuda_ms(torch, lambda: add.add(mp, mq)),
        plain_ms=k16_plain, shape=f"n={n_add}", bytes=n_add * 12 * 64,
        muls=n_add * ADD)
    for name, st in stats.items():
        st["bound_ms"], st["bound_by"] = bound(torch, st["bytes"], st["muls"])
        st["products"] = st["muls"]
        log_stat(name, st, "field muls")
    return stats


def bucket_sweep(torch, native, mc, bk):
    """The bucket MSM against K1 + K2 and the C++ tier as the dispatch calls
    them (host points and scalars in, a host point out), encode to decode
    (the device encode cache emptied first), best of 3 with distinct
    scalars every rep; then both MSMs again with the points resident (the
    flagship's case: its generators stay encoded on the card); the bucket
    MSM's parts timed apart in the same reps: the scalars' conversion to
    u64 rows on the host, their upload with the recoding, window trim and
    layout on the card, and K13 + K14."""
    from verifiable_mpc_tpu_torch.groups.edwards import ELL

    rng = __import__("random").Random(2026)
    pts = ed_points(native, 1 << max(BUCKET_SWEEP_LOG2), rng, rescale=False)
    for lg in BUCKET_SWEEP_LOG2:
        n = 1 << lg
        p = pts[:n]
        t = {k: [] for k in ("bucket", "windowed", "c++", "bucket resident",
                             "windowed resident", "convert", "layout",
                             "kernels")}
        for rep in range(4):  # rep 0 warms up
            sc = [rng.randrange(ELL) for _ in range(n)]
            mc._ED_ENC_CACHE.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a = bk.msm(p, sc)
            t1 = time.perf_counter()
            mc._ED_ENC_CACHE.clear()
            b = mc.msm(p, sc)
            t2 = time.perf_counter()
            c = native.ed_msm(p, sc)
            t3 = time.perf_counter()
            assert a == b == c, f"bucket / K1+K2 / C++ MSMs differ at n={n}"
            dpts = mc._device_points(p)  # resident from here on
            torch.cuda.synchronize()
            r0 = time.perf_counter()
            a = bk.msm(p, sc)
            r1 = time.perf_counter()
            b = mc.msm(p, sc)
            r2 = time.perf_counter()
            assert a == b, f"bucket / K1+K2 MSMs differ at n={n}, resident"
            u0 = time.perf_counter()
            arr = mc.scalars_to_u64x4(sc, ELL)
            u1 = time.perf_counter()
            u64 = torch.from_numpy(arr.view(np.int64).copy()).to(DEV)
            lay = bk.compact_layout(bk.trim_windows(bk.digits_signed8(u64)))
            torch.cuda.synchronize()
            u2 = time.perf_counter()
            bk.bucket_reduce(bk.bucket_accumulate(dpts, lay[0], lay[1]))
            torch.cuda.synchronize()
            u3 = time.perf_counter()
            if rep:
                for key, v in (("bucket", t1 - t0), ("windowed", t2 - t1),
                               ("c++", t3 - t2), ("bucket resident", r1 - r0),
                               ("windowed resident", r2 - r1),
                               ("convert", u1 - u0), ("layout", u2 - u1),
                               ("kernels", u3 - u2)):
                    t[key].append(v)
        best = {key: min(v) * 1e3 for key, v in t.items()}
        log(f"   sweep n=2^{lg}: bucket {best['bucket']:.3f} ms, K1+K2 "
            f"{best['windowed']:.3f} ms, c++ {best['c++']:.3f} ms; points "
            f"resident: bucket {best['bucket resident']:.3f} ms, K1+K2 "
            f"{best['windowed resident']:.3f} ms; bucket parts: host "
            f"conversion {best['convert']:.3f} ms, upload + device recoding "
            f"+ layout {best['layout']:.3f} ms, K13+K14 "
            f"{best['kernels']:.3f} ms")
    # peak device memory of one bucket MSM at the largest size, the points
    # resident (their rows counted before the reset)
    sc = [rng.randrange(ELL) for _ in range(n)]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bk.msm(p, sc)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"   peak device memory of one bucket MSM at n=2^{lg}: "
        f"{peak - before} bytes above the {before} allocated before "
        f"(max_memory_allocated {peak})")


def parity_bucket(torch, vm, mc, bk):
    """At 2^12 multiplications, under one seed: the prove with the bucket
    MSM registered from BUCKET_PARITY_MIN_BATCH points gives the
    enable_native() prove's normalized bytes; enable_gpu() then restores
    the backends."""
    import verifiable_mpc_tpu_torch.ac20.circuit_sat_cb as cs
    from verifiable_mpc_tpu_torch import rng, serialization

    vm.enable_gpu(DEV)
    group, gf, circuit, x, g_length = padded_circuit(vm, PARITY_LOG2_MULS)
    pc = cs.PivotChoice.compressed
    with rng.deterministic(2030):
        gens = cs.create_generators(g_length, pc, group)
    vm.enable_native()
    with rng.deterministic(2031):
        p_native = native_prove_launches_nothing(
            mc, lambda: cs.circuit_sat_prover(gens, circuit, x, gf, pc))
    vm.enable_gpu(DEV)
    bk.register(min_batch=BUCKET_PARITY_MIN_BATCH)
    mc.reset_launches()
    with rng.deterministic(2031):
        p_gpu = cs.circuit_sat_prover(gens, circuit, x, gf, pc)
    served = {k: mc.LAUNCHES[k] for k in BUCKET_KERNELS}
    ok = verified(cs.circuit_sat_verifier(p_gpu, gens, circuit, gf, pc))
    vm.enable_gpu(DEV)
    assert all(served.values()), f"the bucket MSM never ran: {served}"
    b_native = serialization.dumps(canonical(p_native))
    b_gpu = serialization.dumps(canonical(p_gpu))
    assert b_native == b_gpu, "bucket and C++ proofs differ at 2^12"
    assert ok, "the bucket prove at 2^12 did not verify"
    log(f"   2^{PARITY_LOG2_MULS} muls with the bucket MSM from "
        f"{BUCKET_PARITY_MIN_BATCH} points ({served}): {len(b_gpu)} proof "
        "bytes identical to the C++ tier's, verified")


def entry_points(torch, native, mc, add, lm, rng):
    """K15 and K16 through their entry points (msm_cuda.batch_exp,
    add_cuda.add on Montgomery limbs), counts zeroed just before and read
    just after; results against the C++ tier and the host law."""
    from verifiable_mpc_tpu_torch.groups.edwards import ELL, EdwardsPoint

    base = EdwardsPoint.generator ** rng.randrange(1, ELL)
    exps = [rng.randrange(ELL) for _ in range(4096)]
    ps = ed_points(native, 4096, rng)
    qs = ed_points(native, 4096, rng)[::-1]
    mp = tuple(torch.from_numpy(a).to(DEV) for a in lm.encode_points(ps))
    mq = tuple(torch.from_numpy(a).to(DEV) for a in lm.encode_points(qs))
    mc.reset_launches()
    t0 = time.perf_counter()
    got = mc.batch_exp(base, exps)
    t1 = time.perf_counter()
    out = add.add(mp, mq)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k: mc.LAUNCHES[k] for k in ENTRY_KERNELS}
    assert got == native.ed_batch_exp(base, exps), "batch_exp != C++ tier"
    assert lm.decode_points(tuple(c.cpu().numpy() for c in out)) == [
        a * b for a, b in zip(ps, qs)], "add != host law"
    assert all(launches.values()), f"an entry point missed its kernel: " \
        f"{launches}"
    log(f"   batch_exp of 4096 exponents {1e3 * (t1 - t0):.3f} ms, add of "
        f"4096 Montgomery points {1e3 * (t2 - t1):.3f} ms (host to host); "
        f"launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# BN256 G1: kernels K5-K8, the C++ tier, Pinocchio and KoE
# ---------------------------------------------------------------------------


def bn_points(native, n: int, rng, identity_at=(), rescale=True,
              exps=None):
    """n BN256 G1 points made by the C++ tier, ``exps`` (random ones by
    default) times the generator; with ``rescale`` every third one that is
    not the identity in jacobian coordinates with Z != 1 (identities where
    asked)."""
    from verifiable_mpc_tpu_torch.groups.bn256 import ORDER, BNPoint

    if exps is None:
        exps = [rng.randrange(1, ORDER) for _ in range(n)]
    pts = native.bn_batch_exp(BNPoint.generator, exps)
    for i in range(1, n, 3) if rescale else ():
        if exps[i] % ORDER == 0:
            continue
        lam, q = rng.randrange(2, ORDER), pts[i].normalize()
        pts[i] = BNPoint(int(q.x) * lam**2, int(q.y) * lam**3, lam,
                         check=False)
    for i in identity_at:
        if i < n:
            pts[i] = BNPoint.identity
    return pts


def bn_host_rows(native, points) -> np.ndarray:
    """Normalized rows of host points: what the BN kernels return."""
    from verifiable_mpc_tpu_torch.groups.bn256 import BNPoint

    return np.ascontiguousarray(
        native._bn_pts_to_u64(BNPoint.batch_normalize(list(points))))


def fold_inputs(native, points, n: int, G: int, c: int, rng, order: int):
    """gl, gr for a BN or twist fold (``points``: bn_points or bn2_points)
    of n elements by G threads with the challenge c, and the exponents e
    with gl_i^c * gr_i = e_i times the generator: gl_i = a_i and gr_i = b_i
    times it, e_i = a_i c + b_i, so one batch-exp of the C++ tier gives
    every result.  For n > 1 every element of thread 0's group (0, G, 2G,
    ...) has identity gl and gr, gl is the identity at index 2 and gr at 5,
    and element 3's result is the identity (b_3 = -a_3 c)."""
    a = [rng.randrange(1, order) for _ in range(n)]
    b = [rng.randrange(1, order) for _ in range(n)]
    for i in range(0, n, G) if n > 1 else ():
        a[i] = b[i] = 0
    for x, i in ((a, 2), (b, 5)):
        if i < n:
            x[i] = 0
    if n > 3:
        b[3] = -a[3] * c % order
    return (points(native, n, rng, exps=a), points(native, n, rng, exps=b),
            [(x * c + y) % order for x, y in zip(a, b)])


def log_fold_groups(name: str, n: int, G: int):
    log(f"   {name} at n={n}: {G} threads, normalization groups of "
        f"{n // G}-{-(-n // G)} elements (n mod G = {n % G}), thread 0's "
        "group all identities, identity gl at 2 and gr at 5, element 3 "
        "summing to the identity")


def check_small_bn(torch, native, mc, mb, cbn, rng):
    """K5 + K6, K7, K8 against their plain versions and the C++ tier at the
    CHECK_SIZES, with the edge scalars and identity inputs in every batch
    of more than a few points; K8 also with an identity base and the
    exponents of ``comb_exponents``."""
    from verifiable_mpc_tpu_torch.groups.bn256 import ORDER, BNPoint

    dev = torch.device(DEV)
    for n in CHECK_SIZES:
        pts = bn_points(native, n, rng, identity_at=(3, 200))
        sc = (edge_scalars(ORDER) + [rng.randrange(ORDER)
                                     for _ in range(n)])[:n]
        pk, nw = mc.packed_digits(native._scalars_to_u64(sc, ORDER), ORDER)
        pts_t = cbn.encode_points(pts, dev)
        dig = torch.from_numpy(pk).to(dev)
        got = mb.msm_rows(pts_t[None], dig[None])
        plain = mb.msm_plain(pts_t[None], dig[None])
        assert torch.equal(got, plain), f"K5+K6 != plain at n={n}"
        host = bn_host_rows(native, [native.bn_msm(pts, sc)])
        assert np.array_equal(cbn.to_rows(got), host), f"K5+K6 != C++ n={n}"

        G7 = mc.fold_threads(n, dev, "bn_fold")
        for c in [*mc.fold_challenges(ORDER).values(),
                  rng.randrange(ORDER)]:
            gl, gr, e = fold_inputs(native, bn_points, n, G7, c, rng, ORDER)
            gl_t, gr_t = (cbn.encode_points(p, dev) for p in (gl, gr))
            cdig = mc.fold_digits(c, ORDER)
            got = mb.fold_rows(gl_t, gr_t, cdig)
            plain = mb.fold_plain(gl_t, gr_t, cdig)
            assert torch.equal(got, plain), f"K7 != plain at n={n}, c={c}"
            host = bn_host_rows(native, native.bn_batch_exp(
                BNPoint.generator, e))
            assert np.array_equal(cbn.to_rows(got), host), \
                f"K7 != C++ at n={n}, c={c}"
        # the last, random challenge element by element too: the C++
        # tier's MSM of (gl_i, gr_i) by (c, 1), and the host law
        host = bn_host_rows(native, [native.bn_msm([a, b], [c, 1])
                                     for a, b in zip(gl, gr)])
        assert np.array_equal(cbn.to_rows(got), host), f"K7 != C++ n={n}"
        law = bn_host_rows(native, [a ** c * b for a, b in zip(gl[:8],
                                                              gr[:8])])
        assert np.array_equal(cbn.to_rows(got)[:8], law), f"K7 != law n={n}"

        exps = comb_exponents(n, mb.comb_threads(n, dev), rng, ORDER)
        pk8, nw8 = mc.packed_digits(native._scalars_to_u64(exps, ORDER),
                                    ORDER)
        dig8 = torch.from_numpy(pk8).to(dev)
        for base in (bn_points(native, 1, rng)[0], BNPoint.identity):
            table = mb.comb_table(base, nw8, dev)
            got = mb.comb_rows(table, dig8)
            plain = mb.comb_plain(table, dig8)
            assert torch.equal(got, plain), f"K8 != plain at n={n}"
            host = bn_host_rows(native, native.bn_batch_exp(base, exps))
            assert np.array_equal(cbn.to_rows(got), host), f"K8 != C++ n={n}"
        torch.cuda.synchronize()
        log(f"   n={n}: K5+K6, K7 (G = {G7}, at the edge challenges too), "
            "K8 (also with an identity base) equal their plain versions and "
            "the C++ tier")


# K6's cases on accumulators made here: (B, nw, S, the window whose
# accumulators are all the identity or None); the chunk counts R at these
# shapes are 4, 3, 4, 2 and 1, so S = 2050, 4095 and 1501 are no multiple
TAIL_CASES = ((1, 64, 4096, 5), (3, 64, 2050, 0), (1, 64, 4095, None),
              (1, 8, 1501, 7), (3, 2, 5, None))


def check_tail_bn(torch, native, mc, mb, cbn, rng):
    """K6 alone on accumulators made from 4,096 points (one in 64 the
    identity, gathered at random) at TAIL_CASES: against msm_tail_plain and
    the C++ tier's MSM of the same points by 16^(nw-1-w)."""
    from verifiable_mpc_tpu_torch.groups.bn256 import ORDER

    dev = torch.device(DEV)
    pts = bn_points(native, 4096, rng, identity_at=tuple(range(3, 4096, 64)))
    work = cbn.encode_jacobian_rows(cbn.encode_points(pts, dev))
    for B, nw, S, ident in TAIL_CASES:
        idx = np.array([rng.randrange(4096) for _ in range(B * nw * S)])
        if ident is not None:
            idx.reshape(B, nw, S)[:, ident] = 3  # an identity
        acc = work[torch.from_numpy(idx).to(dev)].reshape(B, nw, S, 12)
        got = mb.msm_tail(acc)
        assert torch.equal(got, mb.msm_tail_plain(acc)), \
            f"K6 != plain at B={B} nw={nw} S={S}"
        sc = [16 ** (nw - 1 - w) % ORDER for w in range(nw)
              for _ in range(S)]
        host = bn_host_rows(native, [
            native.bn_msm([pts[i] for i in idx[b * nw * S:(b + 1) * nw * S]],
                          sc) for b in range(B)])
        assert np.array_equal(cbn.to_rows(got), host), \
            f"K6 != C++ at B={B} nw={nw} S={S}"
        R = mc.tail_split(S, mb.TAIL_ADDS)
        log(f"   K6 at B={B} nw={nw} S={S} (R={R}, S mod R = {S % R}"
            + (f", window {ident} all identities" if ident is not None
               else "") + "): equals its plain version and the C++ tier")


def check_main_shapes_bn(torch, native, mc, mb, cbn, rng, n: int):
    """K5-K8 alone at the shapes of the Pinocchio path (one MSM of n
    points, a fold of n, a comb of n exponents): result against the plain
    version on the same inputs, CUDA-event time, plain time, bound."""
    from verifiable_mpc_tpu_torch.groups.bn256 import ORDER, BNPoint

    dev = torch.device(DEV)
    stats = {}
    pts = bn_points(native, 2 * n, rng, identity_at=(5,))
    g = cbn.encode_points(pts, dev)
    sc = edge_scalars(ORDER) + [rng.randrange(ORDER) for _ in range(n - 7)]
    pk, nw = mc.packed_digits(native._scalars_to_u64(sc, ORDER), ORDER)
    dig = torch.from_numpy(pk).to(dev)[None]
    P = g[:n][None]
    S = mc.slices_for(n, mc.ACCUM_POINTS_PER_THREAD)
    acc = mb.msm_accumulate(P, dig, S)
    acc_plain, k5_plain = cuda_once(
        torch, lambda: mb.msm_accumulate_plain(P, dig, S))
    norm = lambda a: cbn.normalize_rows(cbn.split_rows(a))  # noqa: E731
    k5_err = max_abs_err(torch, norm(acc), norm(acc_plain))
    assert k5_err == 0.0, "K5 accumulators differ from the plain version"
    out = mb.msm_tail(acc)
    out_plain, k6_plain = cuda_once(torch, lambda: mb.msm_tail_plain(acc))
    k6_err = max_abs_err(torch, out, out_plain)
    assert k6_err == 0.0, "K6 differs from the plain version"
    d = mc.unpack_digits(dig)  # [1, nw, n]
    top = d.abs().amax(dim=1)
    k5_muls = (n * BN_ENC + BN_ADD * int((top - 1).clamp(min=0).sum())
               + BN_ADD * int((d != 0).sum()))
    stats["bn_msm_accumulate"] = dict(
        err=k5_err, ms=cuda_ms(torch, lambda: mb.msm_accumulate(P, dig, S)),
        plain_ms=k5_plain, shape=f"B=1 n={n} nw={nw} S={S}",
        bytes=n * 96 + dig.numel() + nw * S * 96, muls=k5_muls)
    stats["bn_msm_tail"] = dict(
        err=k6_err, ms=cuda_ms(torch, lambda: mb.msm_tail(acc)),
        plain_ms=k6_plain, shape=f"B=1 nw={nw} S={S}",
        bytes=nw * S * 96 + 96,
        muls=(nw * (S - 1) * BN_ADD + (nw - 1) * 4 * BN_DBL + nw * BN_ADD
              + BN_NORM_EACH + BN_INV))

    # K7: a fold of n elements (a ragged count of its thread count G),
    # with identities and a sum of the identity (fold_inputs), against the
    # plain version and the C++ tier's batch-exp of the exponents
    c = rng.randrange(ORDER)
    G7 = mc.fold_threads(n, dev, "bn_fold")
    gl_p, gr_p, e = fold_inputs(native, bn_points, n, G7, c, rng, ORDER)
    gl, gr = (cbn.encode_points(p, dev) for p in (gl_p, gr_p))
    cdig = mc.fold_digits(c, ORDER)
    got = mb.fold_rows(gl, gr, cdig)
    plain, k7_plain = cuda_once(torch, lambda: mb.fold_plain(gl, gr, cdig))
    k7_err = max_abs_err(torch, got, plain)
    assert k7_err == 0.0, "K7 differs from the plain version"
    host = bn_host_rows(native, native.bn_batch_exp(BNPoint.generator, e))
    assert np.array_equal(cbn.to_rows(got), host), "K7 != C++ at the shape"
    log_fold_groups("K7", n, G7)
    k7_muls, old_muls = fold_muls(mc, c, ORDER, n, BN_ENC, BN_ADD, BN_DBL,
                                  BN_NORM_EACH, BN_INV)
    log_fold_bound(torch, "K7", n, 3 * n * 96, k7_muls, old_muls)
    stats["bn_fold"] = dict(
        err=k7_err, ms=cuda_ms(torch, lambda: mb.fold_rows(gl, gr, cdig)),
        plain_ms=k7_plain, shape=f"n={n} digits={len(cdig)} G={G7}",
        bytes=3 * n * 96, muls=k7_muls)

    G8 = mb.comb_threads(n, dev)
    exps = comb_exponents(n, G8, rng, ORDER)
    pk8, nw8 = mc.packed_digits(native._scalars_to_u64(exps, ORDER), ORDER)
    dig8 = torch.from_numpy(pk8).to(dev)
    table = mb.comb_table(BNPoint.generator, nw8, dev)
    got = mb.comb_rows(table, dig8)
    plain, k8_plain = cuda_once(torch, lambda: mb.comb_plain(table, dig8))
    k8_err = max_abs_err(torch, got, plain)
    assert k8_err == 0.0, "K8 differs from the plain version"
    host = bn_host_rows(native, native.bn_batch_exp(BNPoint.generator, exps))
    assert np.array_equal(cbn.to_rows(got), host), "K8 != C++ at the shape"
    log_groups("K8", n, G8)
    nz8 = (mc.unpack_digits(dig8) != 0).sum(dim=0)  # [n]
    k8_bytes = table.numel() * 8 + dig8.numel() + n * 96
    k8_muls = (table.shape[0] * BN_ENC
               + int((nz8 - 1).clamp(min=0).sum()) * BN_MADD
               + n * BN_NORM_EACH + BN_INV)
    full_muls = (table.shape[0] * BN_ENC + int(nz8.sum()) * BN_ADD
                 + n * BN_NORM_EACH + BN_INV)
    log(f"   K8's bound recounted to mixed adds: "
        f"{bound(torch, k8_bytes, k8_muls, 1)[0]:.4f} ms; with a full add a "
        "nonzero window, as before: "
        f"{bound(torch, k8_bytes, full_muls, 1)[0]:.4f} ms")
    stats["bn_comb"] = dict(
        err=k8_err, ms=cuda_ms(torch, lambda: mb.comb_rows(table, dig8)),
        plain_ms=k8_plain, shape=f"n={n} nw={nw8}", bytes=k8_bytes,
        muls=k8_muls)
    for name, st in stats.items():
        st["bound_ms"], st["bound_by"] = bound(torch, st["bytes"], st["muls"],
                                               per_mul=1)
        st["products"] = st["muls"] / BN_M
        log_stat(name, st, "32-bit multiplies")
    return stats


def fold_muls(mc, c: int, order: int, n: int, enc: int, add: int, dbl: int,
              norm_each: int, inv: int) -> tuple:
    """32-bit multiplies of a BN or twist fold of n elements by c (the
    curve's costs of an encoding, a complete add, a doubling, a point's
    share of a batch normalization and an inversion): (by the width-5 NAF,
    as K7 and K12 compute it now; by unsigned 4-bit windows from the
    identity with a 0..15 table, as counted before).  Per element the NAF
    needs both encodings, the odd multiples 1..15 (a doubling and 7 adds),
    a doubling a digit after the first nonzero one, an add a later nonzero
    digit and the add of gr, then its share of the normalization; one
    inversion for the call."""
    d = mc.fold_digits(c, order)
    nz = np.flatnonzero(d)
    new = n * (2 * enc + dbl + 7 * add + (len(d) - 1 - int(nz[0])) * dbl
               + (len(nz) - 1) * add + add + norm_each) + inv
    w = mc.scalar_digits([c], order)[:, 0].astype(np.int64)
    first = int(np.flatnonzero(w)[0])
    old = n * (2 * enc + max(int(w.max()) - 1, 0) * add
               + (len(w) - 1 - first) * 4 * dbl + int((w != 0).sum()) * add
               + add + norm_each) + inv
    return new, old


def log_fold_bound(torch, name: str, n: int, nbytes: int, muls: int,
                   old: int):
    log(f"   {name}'s bound recounted to a width-5 NAF over odd multiples "
        f"and one inversion: {muls / n / BN_M:.1f} products an element, "
        f"{bound(torch, nbytes, muls, 1)[0]:.4f} ms (unsigned windows and "
        f"a 0..15 table, as counted before: {old / n / BN_M:.1f}, "
        f"{bound(torch, nbytes, old, 1)[0]:.4f} ms)")


def _spread(ts):
    return (f"best {min(ts) * 1e3:.3f} ms, mean "
            f"{statistics.mean(ts) * 1e3:.3f}"
            f" ± {statistics.stdev(ts) * 1e3:.3f} ms over {len(ts)} reps")


def bn_bench(torch, native, mc, mb, rng):
    """The BN MSM and comb as the dispatch calls them (host points and
    scalars in, a host point list out) on the card and on the C++ tier:
    at 2^16, best of 5 with distinct scalars every rep, then at the tier's
    threshold sizes (best of 3)."""
    from verifiable_mpc_tpu_torch.groups.bn256 import ORDER

    n = 1 << SNARK_LOG2_MULS
    pts = bn_points(native, n, rng, rescale=False)  # keys are affine
    base = pts[1]

    def one(size, reps):
        gm, cm, gc, cc = [], [], [], []
        for rep in range(reps + 1):  # rep 0 warms up
            sc = [rng.randrange(ORDER) for _ in range(size)]
            t0 = time.perf_counter()
            a = mb.msm(pts[:size], sc)
            t1 = time.perf_counter()
            b = native.bn_msm(pts[:size], sc)
            t2 = time.perf_counter()
            ca = mb.batch_exp_comb(base, sc)
            t3 = time.perf_counter()
            cb_ = native.bn_batch_exp(base, sc)
            t4 = time.perf_counter()
            assert a == b, f"GPU BN MSM != C++ at n={size}"
            assert ca == cb_, f"GPU BN comb != C++ at n={size}"
            if rep:
                gm.append(t1 - t0)
                cm.append(t2 - t1)
                gc.append(t3 - t2)
                cc.append(t4 - t3)
        return gm, cm, gc, cc

    gm, cm, gc, cc = one(n, 5)
    for name, ts in (("gpu msm (K5+K6, encode to decode)", gm),
                     ("c++ native.bn_msm", cm),
                     ("gpu comb (K8, encode to decode)", gc),
                     ("c++ native.bn_batch_exp", cc)):
        log(f"   bn 2^{SNARK_LOG2_MULS} {name}: {_spread(ts)}")
    for size in BN_TIER_SIZES:
        gm, cm, gc, cc = one(size, 3)
        log(f"   bn tier n={size}: msm gpu {min(gm) * 1e3:.3f} ms, c++ "
            f"{min(cm) * 1e3:.3f} ms; comb gpu {min(gc) * 1e3:.3f} ms, c++ "
            f"{min(cc) * 1e3:.3f} ms")


# ---------------------------------------------------------------------------
# BN256 twist (G2): kernels K9-K12 and the C++ tier
# ---------------------------------------------------------------------------


def bn2_points(native, n: int, rng, identity_at=(), rescale=True,
               exps=None):
    """n twist points made by the C++ tier, ``exps`` (random ones by
    default) times the generator; with ``rescale`` every third one that is
    not the identity in jacobian coordinates with Z != 1 (identities where
    asked)."""
    from verifiable_mpc_tpu_torch.groups.bn256 import (ORDER, P, BNTwistPoint,
                                                       GFp2)

    if exps is None:
        exps = [rng.randrange(1, ORDER) for _ in range(n)]
    pts = native.bn2_batch_exp(BNTwistPoint.generator, exps)
    for i in range(1, n, 3) if rescale else ():
        if exps[i] % ORDER == 0:
            continue
        lam = GFp2(rng.randrange(2, P), rng.randrange(P))
        q = pts[i].normalize()
        pts[i] = BNTwistPoint(q.x * lam * lam, q.y * lam * lam * lam, lam,
                              check=False)
    for i in identity_at:
        if i < n:
            pts[i] = BNTwistPoint.identity
    return pts


def bn2_host_rows(native, points) -> np.ndarray:
    """Normalized rows of host twist points: what K10-K12 return."""
    from verifiable_mpc_tpu_torch.groups.bn256 import BNTwistPoint

    return np.ascontiguousarray(
        native._bn2_pts_to_u64(BNTwistPoint.batch_normalize(list(points))))


def host_err(torch, got, host) -> float:
    """max_abs_err of kernel rows against host rows."""
    return max_abs_err(torch, got, torch.from_numpy(
        np.array(host, dtype=np.uint64).view(np.int64)).to(got.device))


def check_small_bn2(torch, native, mc, mb2, cb2, rng):
    """K9 + K10, K11, K12 against their plain versions and the C++ tier (the
    host law for a few fold elements) at the CHECK_SIZES, with the edge
    scalars, identity inputs and points with Z != 1 in every batch of more
    than a few points, K11 also with an identity base and the exponents of
    ``comb_exponents``; max_abs_err on the canonical rows."""
    from verifiable_mpc_tpu_torch.groups.bn256 import ORDER, BNTwistPoint

    dev = torch.device(DEV)
    for n in CHECK_SIZES:
        pts = bn2_points(native, n, rng, identity_at=(3, 200))
        sc = (edge_scalars(ORDER) + [rng.randrange(ORDER)
                                     for _ in range(n)])[:n]
        pk, nw = mc.packed_digits(native._scalars_to_u64(sc, ORDER), ORDER)
        pts_t = cb2.encode_points(pts, dev)
        dig = torch.from_numpy(pk).to(dev)
        got = mb2.msm_rows(pts_t[None], dig[None])
        errs = [max_abs_err(torch, got, mb2.msm_plain(pts_t[None],
                                                      dig[None])),
                host_err(torch, got, bn2_host_rows(
                    native, [native.bn2_msm(pts, sc)]))]

        exps = comb_exponents(n, mb2.bexp_threads(n, dev), rng,
                              ORDER)
        pk11, nw11 = mc.packed_digits(
            native._scalars_to_u64(exps, ORDER), ORDER)
        dig11 = torch.from_numpy(pk11).to(dev)
        for base in (bn2_points(native, 1, rng)[0], BNTwistPoint.identity):
            table = mb2.bexp_table(base, nw11, dev)
            got = mb2.bexp_rows(table, dig11)
            errs += [max_abs_err(torch, got, mb2.bexp_plain(table, dig11)),
                     host_err(torch, got, bn2_host_rows(
                         native, native.bn2_batch_exp(base, exps)))]

        G12 = mc.fold_threads(n, dev, "bn2_fold")
        fold_errs = [0.0, 0.0]
        for c in [*mc.fold_challenges(ORDER).values(),
                  rng.randrange(ORDER)]:
            gl, gr, e = fold_inputs(native, bn2_points, n, G12, c, rng, ORDER)
            gl_t, gr_t = (cb2.encode_points(p, dev) for p in (gl, gr))
            cdig = mc.fold_digits(c, ORDER)
            got = mb2.fold_rows(gl_t, gr_t, cdig)
            fold_errs = [max(fold_errs[0], max_abs_err(
                             torch, got, mb2.fold_plain(gl_t, gr_t, cdig))),
                         max(fold_errs[1], host_err(torch, got, bn2_host_rows(
                             native, native.bn2_batch_exp(
                                 BNTwistPoint.generator, e))))]
        # the last, random challenge element by element too: the C++
        # tier's MSM of (gl_i, gr_i) by (c, 1), and the host law
        host = [native.bn2_msm([a, b], [c, 1]) for a, b in zip(gl, gr)]
        law = [a ** c * b for a, b in zip(gl[:8], gr[:8])]
        errs += fold_errs + [
            host_err(torch, got, bn2_host_rows(native, host)),
            host_err(torch, got[: len(law)], bn2_host_rows(native, law))]
        torch.cuda.synchronize()
        log(f"   n={n}: max_abs_err K9+K10 plain {errs[0]} c++ {errs[1]}; "
            f"K11 plain {errs[2]} c++ {errs[3]}, identity base plain "
            f"{errs[4]} c++ {errs[5]}; K12 (G = {G12}, the edge challenges "
            f"and a random one) plain {errs[6]} c++ batch-exp {errs[7]}, "
            f"the random one c++ msm {errs[8]} host law {errs[9]}")
        assert not any(errs), f"twist kernels differ at n={n}: {errs}"


# K10's cases on twist accumulators made here: (B, nw, S, the window whose
# accumulators are all the identity or None); the chunk counts R at these
# shapes are 4, 4, 4, 4 and 1, so S mod R is 0, 2, 3, 1 and 0
TAIL2_CASES = ((1, 64, 4096, 5), (3, 64, 2050, 0), (1, 64, 4095, None),
               (1, 8, 1501, 7), (3, 2, 5, None))


def check_edges_bn2(torch, native, mc, mb2, cb2, rng, n: int = 4096,
                    cases=TAIL2_CASES):
    """K10 alone on accumulators made from n twist points (one in 64 the
    identity, gathered at random) at ``cases`` (TAIL2_CASES), against
    msm_tail_plain and the C++ tier's MSM of the same points by
    16^(nw-1-w); K9 on the n points with those identities, a slice whose
    digits are all zero and a point whose digits are all zero: its
    accumulators normalized against the plain version's, K9 + K10 against
    the C++ tier."""
    from verifiable_mpc_tpu_torch.groups.bn256 import ORDER

    dev = torch.device(DEV)
    pts = bn2_points(native, n, rng, identity_at=tuple(range(3, n, 64)))
    rows = cb2.encode_points(pts, dev)
    work = cb2.encode_jacobian_rows(rows)
    for B, nw, S, ident in cases:
        idx = np.array([rng.randrange(n) for _ in range(B * nw * S)])
        if ident is not None:
            idx.reshape(B, nw, S)[:, ident] = 3  # an identity
        acc = work[torch.from_numpy(idx).to(dev)].reshape(B, nw, S, 24)
        got = mb2.msm_tail(acc)
        assert torch.equal(got, mb2.msm_tail_plain(acc)), \
            f"K10 != plain at B={B} nw={nw} S={S}"
        sc = [16 ** (nw - 1 - w) % ORDER for w in range(nw)
              for _ in range(S)]
        host = bn2_host_rows(native, [
            native.bn2_msm([pts[i] for i in idx[b * nw * S:(b + 1) * nw * S]],
                           sc) for b in range(B)])
        assert host_err(torch, got, host) == 0.0, \
            f"K10 != C++ at B={B} nw={nw} S={S}"
        R = mb2.tail_split(S)
        log(f"   K10 at B={B} nw={nw} S={S} (R={R}, S mod R = {S % R}"
            + (f", window {ident} all identities" if ident is not None
               else "") + "): equals its plain version and the C++ tier")

    S = mb2.msm_slices(n)
    sc = [rng.randrange(ORDER) for _ in range(n)]
    sc[0::S] = [0] * len(sc[0::S])  # slice 0: zero digits in every window
    sc[7] = 0  # a point of zero digits
    pk, nw = mc.packed_digits(native._scalars_to_u64(sc, ORDER), ORDER)
    dig = torch.from_numpy(pk).to(dev)[None]
    acc = mb2.msm_accumulate(rows[None], dig, S)
    plain = mb2.msm_accumulate_plain(rows[None], dig, S)
    norm = lambda a: cb2.normalize_rows(cb2.split_rows(a))  # noqa: E731
    assert torch.equal(norm(acc), norm(plain)), "K9 != plain at the edges"
    assert torch.equal(norm(acc[:, :, 0]), norm(cb2.join_rows(
        cb2.identity((1, nw), dev)))), "K9's zero slice is no identity"
    got = mb2.msm_rows(rows[None], dig)
    assert torch.equal(got, mb2.msm_plain(rows[None], dig))
    assert host_err(torch, got, bn2_host_rows(
        native, [native.bn2_msm(pts, sc)])) == 0.0, "K9 + K10 != C++"
    log(f"   K9 at n={n} S={S}: {len(range(3, n, 64))} identity inputs, "
        "slice 0 and point 7 all zero digits: accumulators equal the plain "
        "version's (normalized), K9 + K10 the C++ tier")


def check_main_shapes_bn2(torch, native, mc, mb2, cb2, rng, n: int):
    """K9-K12 alone at the shapes of the Pinocchio path (the twist MSM of n
    points, the twist fill's batch-exp of n exponents, a fold of n): result
    against the plain version on the same inputs, CUDA-event time, plain
    time, bound."""
    from verifiable_mpc_tpu_torch.groups.bn256 import ORDER, BNTwistPoint

    dev = torch.device(DEV)
    stats = {}
    pts = bn2_points(native, 2 * n, rng, identity_at=(5,))
    g = cb2.encode_points(pts, dev)
    sc = edge_scalars(ORDER) + [rng.randrange(ORDER) for _ in range(n - 7)]
    pk, nw = mc.packed_digits(native._scalars_to_u64(sc, ORDER), ORDER)
    dig = torch.from_numpy(pk).to(dev)[None]
    P = g[:n][None]
    S = mb2.msm_slices(n)
    acc = mb2.msm_accumulate(P, dig, S)
    acc_plain, k9_plain = cuda_once(
        torch, lambda: mb2.msm_accumulate_plain(P, dig, S))
    norm = lambda a: cb2.normalize_rows(cb2.split_rows(a))  # noqa: E731
    k9_err = max_abs_err(torch, norm(acc), norm(acc_plain))
    assert k9_err == 0.0, "K9 accumulators differ from the plain version"
    out = mb2.msm_tail(acc)
    out_plain, k10_plain = cuda_once(torch, lambda: mb2.msm_tail_plain(acc))
    k10_err = max_abs_err(torch, out, out_plain)
    assert k10_err == 0.0, "K10 differs from the plain version"
    d = mc.unpack_digits(dig)[0].cpu().numpy()  # [nw, n]
    d[:, 5] = 0  # the identity input: its entries are skipped
    nzd = int((d != 0).sum())
    G9 = mb2.table_threads(n, dev)
    log(f"   K9's table at n={n}: {G9} threads, normalization groups of "
        f"{n // G9}-{-(-n // G9)} points (n mod G = {n % G9})")
    k9_bytes = n * 192 + dig.numel() + nw * S * 192
    # what the function needs, not how the kernel spreads it: the multiples
    # 2..8 by 4 doublings and 3 adds (the kernel does 7 adds), and one
    # inversion for all the entries (the kernel does one a thread)
    table_muls = n * (BN2_ENC + 4 * BN2_DBL + 3 * BN2_ADD)
    k9_muls = (table_muls + n * 8 * BN2_ENTRY_NORM + BN2_INV
               + BN2_MADD * nzd)
    log(f"   K9's bound {bound(torch, k9_bytes, k9_muls, 1)[0]:.4f} ms; "
        "with a projective table and complete adds "
        f"{bound(torch, k9_bytes, table_muls + BN2_ADD * nzd, 1)[0]:.4f} ms")
    stats["bn2_msm_accumulate"] = dict(
        err=k9_err, ms=cuda_ms(torch, lambda: mb2.msm_accumulate(P, dig, S)),
        plain_ms=k9_plain, shape=f"B=1 n={n} nw={nw} S={S}",
        bytes=k9_bytes, muls=k9_muls)
    log(f"   K10 at B=1 nw={nw} S={S}: R={mb2.tail_split(S)} chunks a window")
    stats["bn2_msm_tail"] = dict(
        err=k10_err, ms=cuda_ms(torch, lambda: mb2.msm_tail(acc)),
        plain_ms=k10_plain, shape=f"B=1 nw={nw} S={S}",
        bytes=nw * S * 192 + 192,
        muls=(nw * (S - 1) * BN2_ADD + (nw - 1) * 4 * BN2_DBL + nw * BN2_ADD
              + BN2_NORM_EACH + BN2_INV))

    G11 = mb2.bexp_threads(n, dev)
    exps = comb_exponents(n, G11, rng, ORDER)
    pk11, nw11 = mc.packed_digits(native._scalars_to_u64(exps, ORDER), ORDER)
    dig11 = torch.from_numpy(pk11).to(dev)
    mb2._COMB_TABLES.clear()
    t0 = time.perf_counter()
    table = mb2.bexp_table(BNTwistPoint.generator, nw11, dev)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    got = mb2.bexp_rows(table, dig11)
    plain, k11_plain = cuda_once(torch, lambda: mb2.bexp_plain(table, dig11))
    k11_err = max_abs_err(torch, got, plain)
    assert k11_err == 0.0, "K11 differs from the plain version"
    host = bn2_host_rows(native, native.bn2_batch_exp(BNTwistPoint.generator,
                                                      exps))
    assert host_err(torch, got, host) == 0.0, "K11 != C++ at the shape"
    log_groups("K11", n, G11)
    log(f"   K11's comb table ({table.shape[0]} rows, C++ tier and upload, "
        f"uncached): {build_ms:.3f} ms")
    d11 = mc.unpack_digits(dig11).cpu().numpy()  # [nw, n]
    nzw = d11 != 0
    first = np.where(nzw.any(axis=0), nzw.argmax(axis=0), nw11 - 1)
    # the comb sums an exponent's nonzero entries: one mixed add fewer than
    # it has (the table's rows are affine)
    adds = int((nzw.sum(axis=0) - 1).clip(min=0).sum())
    comb_muls = (table.shape[0] * BN2_ENC + adds * BN2_MADD
                 + n * BN2_NORM_EACH + BN2_INV)
    full_muls = (table.shape[0] * BN2_ENC + int(nzw.sum()) * BN2_ADD
                 + n * BN2_NORM_EACH + BN2_INV)
    ladder_muls = (9 * BN2_ENC + int((nw11 - 1 - first).sum()) * 4 * BN2_DBL
                   + int(nzw.sum()) * BN2_ADD + n * BN2_NORM_EACH + BN2_INV)
    k11_bytes = table.numel() * 8 + dig11.numel() + n * 192
    log(f"   K11's bound recounted to the comb with mixed adds: "
        f"{bound(torch, k11_bytes, comb_muls, 1)[0]:.4f} ms; with a full add "
        f"a nonzero window: {bound(torch, k11_bytes, full_muls, 1)[0]:.4f} ms;"
        " the ladder's (4 doublings a window, as before) on these exponents: "
        f"{bound(torch, k11_bytes, ladder_muls, 1)[0]:.4f} ms")
    stats["bn2_bexp"] = dict(
        err=k11_err, ms=cuda_ms(torch, lambda: mb2.bexp_rows(table, dig11)),
        plain_ms=k11_plain, shape=f"n={n} nw={nw11}", bytes=k11_bytes,
        muls=comb_muls)

    # K12 as K7 in check_main_shapes_bn
    c = rng.randrange(ORDER)
    G12 = mc.fold_threads(n, dev, "bn2_fold")
    gl_p, gr_p, e = fold_inputs(native, bn2_points, n, G12, c, rng, ORDER)
    gl, gr = (cb2.encode_points(p, dev) for p in (gl_p, gr_p))
    cdig = mc.fold_digits(c, ORDER)
    got = mb2.fold_rows(gl, gr, cdig)
    plain, k12_plain = cuda_once(torch, lambda: mb2.fold_plain(gl, gr, cdig))
    k12_err = max_abs_err(torch, got, plain)
    assert k12_err == 0.0, "K12 differs from the plain version"
    assert host_err(torch, got, bn2_host_rows(native, native.bn2_batch_exp(
        BNTwistPoint.generator, e))) == 0.0, "K12 != C++ at the shape"
    log_fold_groups("K12", n, G12)
    k12_muls, old_muls = fold_muls(mc, c, ORDER, n, BN2_ENC, BN2_ADD,
                                   BN2_DBL, BN2_NORM_EACH, BN2_INV)
    log_fold_bound(torch, "K12", n, 3 * n * 192, k12_muls, old_muls)
    stats["bn2_fold"] = dict(
        err=k12_err, ms=cuda_ms(torch, lambda: mb2.fold_rows(gl, gr, cdig)),
        plain_ms=k12_plain, shape=f"n={n} digits={len(cdig)} G={G12}",
        bytes=3 * n * 192, muls=k12_muls)
    for name, st in stats.items():
        st["bound_ms"], st["bound_by"] = bound(torch, st["bytes"], st["muls"],
                                               per_mul=1)
        st["products"] = st["muls"] / BN_M
        log_stat(name, st, "32-bit multiplies")
    return stats


def bn2_bench(torch, native, mb2, rng):
    """The twist MSM and batch-exp as the dispatch calls them (host points
    and scalars in, host points out) on the card and on the C++ tier, best
    of 3 with distinct scalars every rep, at the tier sizes and at the
    path's 2^17: the sweep that sets BN2_MIN_BATCH.  At 2^17 the warm-up
    is the batch-exp's first call for its base: it builds the comb table
    (the cache is cleared first), and its time prints beside the rest."""
    from verifiable_mpc_tpu_torch.groups.bn256 import ORDER

    pts = bn2_points(native, max(BN2_TIER_SIZES), rng, rescale=False)
    base = pts[1]
    for size in BN2_TIER_SIZES:
        gm, cm, gb, cb_ = [], [], [], []
        for rep in range(4):  # rep 0 warms up
            sc = [rng.randrange(ORDER) for _ in range(size)]
            if rep == 0 and size == SNARK_SHAPE:
                mb2._COMB_TABLES.clear()
            t0 = time.perf_counter()
            a = mb2.msm(pts[:size], sc)
            t1 = time.perf_counter()
            b = native.bn2_msm(pts[:size], sc)
            t2 = time.perf_counter()
            ba = mb2.batch_exp(base, sc)
            t3 = time.perf_counter()
            bb = native.bn2_batch_exp(base, sc)
            t4 = time.perf_counter()
            assert a == b, f"GPU twist MSM != C++ at n={size}"
            assert ba == bb, f"GPU twist batch-exp != C++ at n={size}"
            if rep:
                gm.append(t1 - t0)
                cm.append(t2 - t1)
                gb.append(t3 - t2)
                cb_.append(t4 - t3)
            else:
                first = t3 - t2
        log(f"   bn2 tier n={size}: msm gpu {min(gm) * 1e3:.3f} ms, c++ "
            f"{min(cm) * 1e3:.3f} ms; batch-exp gpu {min(gb) * 1e3:.3f} ms, "
            f"c++ {min(cb_) * 1e3:.3f} ms"
            + (f"; batch-exp gpu first call (comb table built) "
               f"{first * 1e3:.3f} ms" if size == SNARK_SHAPE else ""))


def chain_code(n_muls: int) -> str:
    """x_{i+1} = x_i * x_i + 1 chain with n_muls mul gates, one per line
    (the circuit of bench_snark.chain_code)."""
    lines = ["def qeval(x):", "    a0 = x * x + 1"]
    for i in range(1, n_muls - 1):
        lines.append(f"    a{i} = a{i-1} * a{i-1} + 1")
    lines.append(f"    return a{n_muls-2} * x")
    return "\n".join(lines) + "\n"


def snark_setup(log2_muls: int):
    """(g1, g2, gf, SparseQAP) of the chain circuit over BN256."""
    import verifiable_mpc_tpu_torch.trinocchio.qap_fast as qf
    from verifiable_mpc_tpu_torch.fields import GF
    from verifiable_mpc_tpu_torch.groups import EllipticCurve

    g1 = EllipticCurve("BN256", "jacobian")
    g2 = EllipticCurve("BN256_twist", "jacobian")
    gf = GF(g1.order)
    gf.is_signed = False
    return g1, g2, gf, qf.SparseQAP(chain_code(1 << log2_muls), gf)


def snark_keygen(g1, g2, qap):
    import verifiable_mpc_tpu_torch.trinocchio.pynocchio as pyn
    import verifiable_mpc_tpu_torch.trinocchio.qap_fast as qf

    td = pyn.Trapdoor(g1.order)
    gen = pyn.Generators(td, g1.generator, g2.generator)
    return qf.generate_keys_fast(td, qap, gen)


def snark_prove(g1, qap, c, evalkey):
    import verifiable_mpc_tpu_torch.trinocchio.pynocchio as pyn
    import verifiable_mpc_tpu_torch.trinocchio.qap_fast as qf

    return qf.compute_proof_fast(qap, c, evalkey, pyn.SampleDeltas(g1.order))


def pinocchio(torch, vm, mc):
    """The BN256 G1 path: Pinocchio at 2^16 multiplications with
    enable_gpu(); the kernel launch counts are zeroed just before and read
    just after, and the path's kernels must have run where they belong."""
    import verifiable_mpc_tpu_torch.trinocchio.pynocchio as pyn

    vm.enable_gpu(DEV)
    secs, per_stage = {}, {}

    def stage(name, fn):
        before = dict(mc.LAUNCHES)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        per_stage[name] = {k: mc.LAUNCHES[k] - before[k] for k in before
                           if k.startswith(BN_PATH)}
        return out

    mc.reset_launches()
    g1, g2, gf, qap = stage("build_qap",
                            lambda: snark_setup(SNARK_LOG2_MULS))
    evalkey, verikey = stage("keygen", lambda: snark_keygen(g1, g2, qap))
    c = stage("witness", lambda: qap.calculate_witness([gf(3)]))
    proof = stage("prove", lambda: snark_prove(g1, qap, c, evalkey))
    ver = stage("verify", lambda: pyn.verify(qap, verikey, proof,
                                             c[: qap.out_ix + 1]))
    launches = dict(mc.LAUNCHES)
    log(f"   QAP m={qap.m} d={qap.d}; "
        + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())
        + f" (2^{SNARK_LOG2_MULS} muls)")
    for name, counts in per_stage.items():
        log(f"   launches in {name}: {counts}")
    log(f"   verification {ver}; launches {launches}")
    assert all(ver.values()), f"Pinocchio proof did not verify: {ver}"
    for k in ("bn_comb", "bn2_bexp"):
        assert per_stage["keygen"][k] > 0, f"{k} never ran in keygen"
    for k in ("bn_msm_accumulate", "bn_msm_tail", "bn2_msm_accumulate",
              "bn2_msm_tail"):
        assert per_stage["prove"][k] > 0, f"{k} never ran in the prove"
    tails = per_stage["prove"]["bn_msm_tail"]
    assert tails == PINOCCHIO_TAILS, f"K6 launched {tails} times"
    return launches


def pinocchio_parity(torch, vm, mc):
    """At 2^10 multiplications, under one seed: the enable_gpu() and the
    enable_native() evaluation keys (twist entries included) and proofs,
    normalized, are equal.  The GPU run lowers the BN and twist thresholds
    to MIN_MSM_BATCH, so that at this size (about 2^11 key entries) every
    kernel of the path serves its calls and is held against the C++ tier;
    enable_gpu() is installed with its defaults again afterwards."""
    from verifiable_mpc_tpu_torch import rng, serialization

    g1, g2, gf, qap = snark_setup(SNARK_PARITY_LOG2_MULS)
    c = qap.calculate_witness([gf(3)])
    path = ("bn_msm_accumulate", "bn_msm_tail", "bn_comb",
            "bn2_msm_accumulate", "bn2_msm_tail", "bn2_bexp")
    out = {}
    for backend in ("gpu", "native"):
        if backend == "gpu":
            saved = (vm.BN_MIN_MSM_BATCH, vm.BN2_MIN_BATCH)
            vm.BN_MIN_MSM_BATCH = vm.BN2_MIN_BATCH = vm.MIN_MSM_BATCH
            try:
                vm.enable_gpu(DEV)
            finally:
                vm.BN_MIN_MSM_BATCH, vm.BN2_MIN_BATCH = saved
        else:
            vm.enable_native()
        mc.reset_launches()
        with rng.deterministic(2028):
            evalkey, _verikey = snark_keygen(g1, g2, qap)
        with rng.deterministic(2029):
            proof = snark_prove(g1, qap, c, evalkey)
        ran = [mc.LAUNCHES[k] > 0 for k in path]
        assert ran == [backend == "gpu"] * len(path), (backend, mc.LAUNCHES)
        out[backend] = (serialization.dumps(canonical(evalkey)),
                        serialization.dumps(canonical(proof)))
    vm.enable_gpu(DEV)
    assert out["gpu"][0] == out["native"][0], "evaluation keys differ"
    assert out["gpu"][1] == out["native"][1], "proofs differ"
    log(f"   2^{SNARK_PARITY_LOG2_MULS} muls: evaluation key "
        f"({len(out['gpu'][0])} bytes) and proof ({len(out['gpu'][1])} bytes)"
        " identical to the C++ tier's, normalized (GPU run: "
        + ", ".join(path) + " launched)")


def koe_circuit(log2_muls: int):
    """(group, gf, circuit, x, g_length) of the KoE pivot over BN256, built
    as bench_ac20.py --pivot koe builds it."""
    import verifiable_mpc_tpu_torch.ac20.circuit_builder as cb
    import verifiable_mpc_tpu_torch.ac20.circuit_sat_cb as cs
    from verifiable_mpc_tpu_torch.fields import GF
    from verifiable_mpc_tpu_torch.groups import EllipticCurve

    group = [EllipticCurve("BN256", "jacobian"),
             EllipticCurve("BN256_twist", "jacobian")]
    gf = GF(group[0].order)
    circuit = chain_circuit(cb, gf, 1 << log2_muls)
    x = circuit.initial_inputs()
    _check, padding, g_length = cs.check_input_length_power_of_2(x, circuit)
    for i in range(padding):
        cb.CircuitVar(gf(0), circuit, "unused_" + str(i))
    return group, gf, circuit, circuit.initial_inputs(), g_length


def koe(torch, vm, mc):
    """AC20 circuit satisfiability with the KoE pivot over BN256 at 2^10
    multiplications with enable_gpu(), built as bench_ac20.py --pivot koe
    builds it."""
    import verifiable_mpc_tpu_torch.ac20.circuit_sat_cb as cs

    vm.enable_gpu(DEV)
    group, gf, circuit, x, g_length = koe_circuit(KOE_LOG2_MULS)
    pc = cs.PivotChoice.koe
    mc.reset_launches()
    t0 = time.perf_counter()
    gens = cs.create_generators(g_length, pc, group)
    t1 = time.perf_counter()
    proof = cs.circuit_sat_prover(gens, circuit, x, gf, pc)
    t2 = time.perf_counter()
    ver = cs.circuit_sat_verifier(proof, gens, circuit, gf, pc)
    t3 = time.perf_counter()
    launches = {k: v for k, v in mc.LAUNCHES.items()
                if k.startswith(BN_PATH)}
    log(f"   KoE 2^{KOE_LOG2_MULS} muls (vector length {g_length}): "
        f"generators {t1 - t0:.3f} s, prove {t2 - t1:.3f} s, verify "
        f"{t3 - t2:.3f} s; verification {ver}; launches {launches}")
    assert verified(ver), f"KoE proof did not verify: {ver}"
    assert launches["bn_comb"] > 0 and launches["bn_msm_accumulate"] > 0


def koe_parity(torch, vm, mc):
    """At 2^10 multiplications, under one seed: the KoE generators and
    prove with enable_gpu() (BN and twist thresholds lowered to
    MIN_MSM_BATCH, so K5 + K6 and K9 + K10 compute the KoE commitment) and
    with enable_native() give equal normalized proof bytes.  The protocol
    hashes the commitment {P, pi} as the backend returned it, and the
    kernels return normalized points: a wrapper here normalizes the C++
    tier's BN and twist MSM results in both runs."""
    import verifiable_mpc_tpu_torch.ac20.circuit_sat_cb as cs
    from verifiable_mpc_tpu_torch import native, rng, serialization

    group, gf, circuit, x, g_length = koe_circuit(KOE_LOG2_MULS)
    pc = cs.PivotChoice.koe
    real = (native.bn_msm, native.bn2_msm)

    def normalized(fn):
        return lambda *args: fn(*args).normalize()

    path = ("bn_msm_accumulate", "bn_msm_tail", "bn2_msm_accumulate",
            "bn2_msm_tail")
    out = {}
    native.bn_msm, native.bn2_msm = (normalized(f) for f in real)
    try:
        for backend in ("gpu", "native"):
            if backend == "gpu":
                saved = (vm.BN_MIN_MSM_BATCH, vm.BN2_MIN_BATCH)
                vm.BN_MIN_MSM_BATCH = vm.BN2_MIN_BATCH = vm.MIN_MSM_BATCH
                try:
                    vm.enable_gpu(DEV)
                finally:
                    vm.BN_MIN_MSM_BATCH, vm.BN2_MIN_BATCH = saved
            else:
                vm.enable_native()
            mc.reset_launches()
            with rng.deterministic(2032):
                gens = cs.create_generators(g_length, pc, group)
            with rng.deterministic(2033):
                proof = cs.circuit_sat_prover(gens, circuit, x, gf, pc)
            ran = [mc.LAUNCHES[k] > 0 for k in path]
            assert ran == [backend == "gpu"] * len(path), (backend,
                                                           mc.LAUNCHES)
            ver = cs.circuit_sat_verifier(proof, gens, circuit, gf, pc)
            assert verified(ver), f"KoE {backend} proof did not verify"
            out[backend] = serialization.dumps(canonical(proof))
    finally:
        native.bn_msm, native.bn2_msm = real
        vm.enable_gpu(DEV)
    assert out["gpu"] == out["native"], "KoE proofs differ"
    log(f"   KoE 2^{KOE_LOG2_MULS} muls: {len(out['gpu'])} proof bytes "
        "identical to the C++ tier's, normalized (GPU run: "
        + ", ".join(path) + " launched)")


# ---------------------------------------------------------------------------
# the probe kernels P1-P4
# ---------------------------------------------------------------------------


def sass_loops(path: str) -> dict:
    """{kernel name: Counter of opcodes} of the largest loop body of every
    probe kernel in the library's SASS (cuobjdump): the instructions from a
    backward branch's target to the branch."""
    import collections
    import re

    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = os.path.join(home, "bin", "cuobjdump")
    sass = subprocess.run([tool if os.path.exists(tool) else "cuobjdump",
                           "-sass", path], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    loops = {}
    for sec in re.split(r"\n\s*Function : ", "\n" + sass)[1:]:
        name = sec.split("\n", 1)[0].strip()
        if "probe_" not in name:
            continue
        ins = []
        for line in sec.split("\n"):
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m:
                ins.append((int(m.group(1), 16), m.group(2)))
        best = []
        for addr, text in ins:
            m = re.search(r"BRA\s+0x([0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                lo = int(m.group(1), 16)
                body = [t for a, t in ins if lo <= a <= addr]
                best = max(best, body, key=len)
        loops[name] = collections.Counter(
            re.sub(r"^@!?U?P\w+\s+", "", t).split()[0] for t in best)
    return loops


def check_probe_sass(path: str):
    """The timed loops hold the instructions they are named for: each P1
    and P4 loop body VPU_UNROLL steps of exactly SASS_STEP's instructions,
    each field product at least SASS_WIDE's wide products."""
    loops = sass_loops(path)
    for key, want in list(SASS_STEP.items()) + list(SASS_WIDE.items()):
        (name,) = [n for n in loops if key in n]
        ops = loops[name]
        log(f"   SASS {key}: loop body of {sum(ops.values())} instructions "
            + ", ".join(f"{k} {v}" for k, v in ops.most_common(8)))
        if isinstance(want, dict):
            got = {k: ops.get(k, 0) for k in want}
            assert got == {k: VPU_UNROLL * v for k, v in want.items()}, (
                key, dict(ops))
            assert not any(k in ("IMAD", "FFMA", "LOP3.LUT", "LEA.HI",
                                 "IMAD.IADD") and k not in want
                           for k in ops), (key, dict(ops))
        else:
            assert ops.get("IMAD.WIDE.U32", 0) >= want, (key, dict(ops))


def probe_checks(torch, pv, pc):
    """Each probe kernel against its plain version at every shape the
    probes' entry points time: on the TPU probes' tiles at PROBE_CHECK_STEPS
    steps, on the full-card lane counts and P3's one lane at
    PROBE_WIDE_STEPS.  Returns ({kernel: plain ms at the largest count on
    the TPU tiles}, {kernel: max_abs_err})."""
    dev = torch.device(DEV)
    plain, err = {k: 0.0 for k in PROBE_KERNELS}, {k: 0.0 for k in
                                                   PROBE_KERNELS}
    top = max(PROBE_CHECK_STEPS)

    def held(key, steps, got, want_fn, compare):
        want, ms = cuda_once(torch, want_fn)
        if steps == top:
            plain[key] += ms
        e = compare(got, want, steps)
        err[key] = max(err[key], e)

    def exact(got, want, _steps):
        assert torch.equal(got, want), "probe kernel != plain version"
        return 0.0

    def f32(got, want, steps):
        fin = torch.isfinite(want)
        assert torch.equal(torch.isfinite(got), fin), "inf lanes differ"
        if steps < top:
            ulps = (got.view(torch.int32).to(torch.int64)
                    - want.view(torch.int32).to(torch.int64)).abs()[fin]
            assert int(ulps.max()) <= F32_ULPS, f"f32 {int(ulps.max())} ulp"
        return float((got - want)[fin].abs().max()) if fin.any() else 0.0

    for label, shape, fshape in pv.shapes(dev):
        counts = PROBE_CHECK_STEPS if label == "tpu" else PROBE_WIDE_STEPS
        xu, yu, xf, yf, xm, ym = pv.inputs(shape, fshape, dev=DEV)
        for name in pv.CASES:
            x, y = (xf, yf) if name == "f32_fma" else (xu, yu)
            for steps in counts:
                got = pv.vpu_op(name, x, y, steps)
                held("probe_vpu", steps, got,
                     lambda: pv.plain_vpu_op(name, x, y, steps),
                     f32 if name == "f32_fma" else exact)
        if label == "tpu":
            # the full count: the kernel's inf and finite lanes and bits
            # repeat
            a = pv.vpu_op("f32_fma", xf, yf, pv.ITERS)
            b = pv.vpu_op("f32_fma", xf, yf, pv.ITERS)
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
            log(f"   f32_fma at {pv.ITERS} steps: {int(torch.isinf(a).sum())}"
                f" inf lanes of {a.numel()}, the same in two launches")
        for name in pv.FIELD_CASES:
            for steps in counts:
                got = pv.canonical(name, pv.field_chain(name, xm, ym, steps))
                held("probe_field", steps, got,
                     lambda: pv.plain_field_chain(name, xm, ym, steps),
                     exact)
        log(f"   P1 {shape} and P2 {fshape} ({label}) equal their plain "
            f"versions at {counts} steps")
    rng = np.random.RandomState(7)
    for label, per in pc.shapes(dev).items():
        counts = PROBE_CHECK_STEPS if label == "tpu" else PROBE_WIDE_STEPS
        for cname, k in pc.CHAINS.items():
            ops = pc.operands(rng, k, (16,) + per[cname], DEV)
            for steps in counts:
                got = torch.stack([pv.canonical("mul25519", t)
                                   for t in pc.chain(ops[:k], ops[k], steps)])
                held("probe_chain", steps, got,
                     lambda: torch.stack(pc.plain_chain(ops[:k], ops[k],
                                                        steps)),
                     exact)
        if "raw" in per:
            x, y = pc.operands(rng, 1, (16,) + per["raw"], DEV)
            for steps in counts:
                held("probe_raw", steps, pc.raw(x, y, steps),
                     lambda: pc.plain_raw(x, y, steps), exact)
        log(f"   P3/P4 ({label}: {per}) equal their plain versions at "
            f"{counts} steps")
    return plain, err


def probe_bound_ms(torch, row) -> float:
    """The least time of a probe row's work on the card, by operations in
    the port's bound model: P1 by its busiest pipe (the model's steps per
    SM per clock in the row), P2-P4 by their 32-bit multiplies at the IMAD
    rate (as the kernel table's bounds).  Each lane reads and writes a few
    words, so bytes never bound these."""
    from verifiable_mpc_tpu_torch import bound_model as bm

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_step = {
        "P1": lambda: bm.IMAD_PER_SM_CLK / row["model_per_sm_clk"],
        "P2": lambda: row["muls"],
        "P3": lambda: row["fmuls"] / row["iters"] * bm.MULS_PER_FIELD_MUL,
        "P4": lambda: 16}[row["probe"]]()
    return bm.ops_ms(sms, row["iters"] * row["lanes"] * per_step)


def probes(torch):
    """P1-P4: SASS, checks, then both probes' entry points with the launch
    counts zeroed just before and read just after; returns the kernel
    table's stats and the counts."""
    from verifiable_mpc_tpu_torch import probes as prb
    from verifiable_mpc_tpu_torch.ops import _cuda_build
    from verifiable_mpc_tpu_torch.probes import probe_carrychain as pc
    from verifiable_mpc_tpu_torch.probes import probe_vpu as pv

    check_probe_sass(_cuda_build.LIB)
    plain, err = probe_checks(torch, pv, pc)
    log(f"   every probe kernel equals its plain version at every shape "
        f"timed (f32 within {F32_ULPS} ulp below {max(PROBE_CHECK_STEPS)} "
        "steps)")
    prb.reset_launches()
    rows = pv.main([]) + pc.main([])
    launches = dict(prb.LAUNCHES)
    assert all(launches.values()), f"a probe kernel never ran: {launches}"
    log(f"   launches {launches}")
    which = {"P1": "probe_vpu", "P2": "probe_field", "P3": "probe_chain",
             "P4": "probe_raw"}
    stats = {k: {"err": err[k], "ms": 0.0, "plain_ms": plain[k],
                 "bound_ms": 0.0, "bound_by": "operations",
                 "plain_iters": max(PROBE_CHECK_STEPS)}
             for k in PROBE_KERNELS}
    for r in rows:
        if r["shape"] != "tpu":
            continue
        st = stats[which[r["probe"]]]
        st["ms"] += r["ms"]
        st["bound_ms"] += probe_bound_ms(torch, r)
        st["iters"] = r["iters"]
    for k, st in stats.items():
        log(f"   {k} at the TPU probes' shapes and counts: {st['ms']:.3f} ms"
            f" (bound {st['bound_ms']:.4f} ms by operations); plain "
            f"{st['plain_ms']:.3f} ms at {st['plain_iters']} steps")
    rates = {key: max(r["rate"] for r in rows if r["probe"] == "P2"
                      and r["case"] == case and r["shape"] == "full")
             for key, case in (("ed", "mul25519"), ("bn", "fp_mul"))}
    # a dependent fe_mul on one lane (P3's chain), in ms
    rates["dependent_ms"] = min(r["ms"] / r["fmuls"] for r in rows
                                if r["probe"] == "P3" and r["case"] == "chain"
                                and r["shape"] == "one lane")
    return stats, launches, rates


def main() -> int:
    sys.path.insert(0, HERE)
    import random

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import verifiable_mpc_tpu_torch as vm
    from verifiable_mpc_tpu_torch import native
    from verifiable_mpc_tpu_torch.ops import _cuda_build
    from verifiable_mpc_tpu_torch.ops import curve_bn as cbn
    from verifiable_mpc_tpu_torch.ops import curve_bn2 as cb2
    from verifiable_mpc_tpu_torch.ops import curve_ed as ced
    from verifiable_mpc_tpu_torch.ops import msm_bn2_cuda as mb2
    from verifiable_mpc_tpu_torch.ops import msm_bn_cuda as mb
    from verifiable_mpc_tpu_torch.ops import add_cuda as add
    from verifiable_mpc_tpu_torch.ops import limbs_mont as lm
    from verifiable_mpc_tpu_torch.ops import msm_bucket_cuda as bk
    from verifiable_mpc_tpu_torch.ops import msm_cuda as mc

    with Phase("card"):
        card = card_line()
        log(card)
    with Phase("build"):
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            nvcc_s = _cuda_build.build(verbose=True)
        log(out.getvalue().rstrip())
        log_accum_usage(ptxas_usage(out.getvalue()))
        t1 = time.perf_counter()
        assert native.available() and native.fastser() is not None
        log(f"   nvcc {nvcc_s:.1f} s; C++ host tier "
            f"{time.perf_counter() - t1:.1f} s (wall {time.perf_counter() - t0:.1f} s)")
    rng = random.Random(20261016)
    vm.enable_gpu(DEV)  # the kernels' wrappers read the device it sets
    with Phase("kernels against their plain versions, small n"):
        check_small(torch, native, mc, ced, rng)
        check_tail_ed(torch, native, mc, ced, rng)
        check_small_bn(torch, native, mc, mb, cbn, rng)
        check_tail_bn(torch, native, mc, mb, cbn, rng)
        check_small_bn2(torch, native, mc, mb2, cb2, rng)
        check_edges_bn2(torch, native, mc, mb2, cb2, rng)
        check_small_new(torch, native, mc, bk, ced, add, lm, rng)
    g_half = 1 << (FLAGSHIP_LOG2_MULS + 1)  # round 0 of a 2^18 vector
    with Phase("kernels at the flagship's shapes"):
        stats = check_main_shapes(torch, native, mc, ced, rng, g_half,
                                  (1 << (FLAGSHIP_LOG2_MULS + 2)) - 1)
    with Phase("bucket MSM, batch-exp and Montgomery add at their shapes"):
        stats.update(check_main_shapes_new(
            torch, native, mc, bk, ced, add, lm, rng,
            1 << (FLAGSHIP_LOG2_MULS + 2), (1 << (FLAGSHIP_LOG2_MULS + 2)) - 1,
            MONT_ADD_SHAPE))
    with Phase("BN kernels at the Pinocchio path's shapes"):
        stats.update(check_main_shapes_bn(torch, native, mc, mb, cbn, rng,
                                          SNARK_SHAPE))
    with Phase("twist kernels at the Pinocchio path's shapes"):
        stats.update(check_main_shapes_bn2(torch, native, mc, mb2, cb2, rng,
                                           SNARK_SHAPE))
    with Phase(f"msm 2^{MSM_BENCH_LOG2} and the Ed25519 tier sizes against "
               "the C++ tier"):
        msm_bench(torch, native, mc, ced, rng)
    with Phase("BN msm and comb against the C++ tier"):
        bn_bench(torch, native, mc, mb, rng)
    with Phase("twist msm and batch-exp against the C++ tier"):
        bn2_bench(torch, native, mb2, rng)
    with Phase("bucket MSM against K1 + K2 and the C++ tier"):
        bucket_sweep(torch, native, mc, bk)
    with Phase("engine cut-over"):
        cutover(torch, native, mc, ced, rng)
    with Phase(f"build the 2^{FLAGSHIP_LOG2_MULS}-multiplication circuit"):
        built = padded_circuit(vm, FLAGSHIP_LOG2_MULS)
    with Phase(f"flagship 2^{FLAGSHIP_LOG2_MULS}"):
        launches = flagship(torch, vm, mc, built)
    with Phase(f"parity 2^{PARITY_LOG2_MULS}"):
        parity(torch, vm, mc)
    with Phase(f"flagship 2^{FLAGSHIP_LOG2_MULS} with the bucket MSM"):
        bucket_launches = flagship(torch, vm, mc, built, bk)
    del built
    with Phase(f"parity 2^{PARITY_LOG2_MULS} with the bucket MSM"):
        parity_bucket(torch, vm, mc, bk)
    with Phase("K15 and K16 through their entry points"):
        entry_launches = entry_points(torch, native, mc, add, lm, rng)
    with Phase(f"Pinocchio 2^{SNARK_LOG2_MULS}"):
        bn_launches = pinocchio(torch, vm, mc)
    with Phase(f"Pinocchio parity 2^{SNARK_PARITY_LOG2_MULS}"):
        pinocchio_parity(torch, vm, mc)
    with Phase(f"KoE 2^{KOE_LOG2_MULS}"):
        koe(torch, vm, mc)
        koe_parity(torch, vm, mc)
    with Phase("probe kernels against their plain versions, then timed"):
        probe_stats, probe_launches, rates = probes(torch)
    product_bounds(stats, rates)
    stats.update(probe_stats)
    launches.update(probe_launches)

    for name in SOURCES:
        if name.startswith(BN_PATH):
            launches[name] = bn_launches[name]
        elif name in BUCKET_KERNELS:
            launches[name] = bucket_launches[name]
        elif name in ENTRY_KERNELS:
            launches[name] = entry_launches[name]
    kernels = [
        {
            "name": name, "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": st["err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": None,
            **({"iters": st["iters"], "plain_iters": st["plain_iters"]}
               if name in PROBE_KERNELS else {}),
            **({"bound_product_ms": st["bound_product_ms"]}
               if "bound_product_ms" in st else {}),
            **({"latency_floor_ms": st["latency_floor_ms"]}
               if "latency_floor_ms" in st else {}),
        }
        for name, st in stats.items()
    ]
    assert len(kernels) == len(SOURCES)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
