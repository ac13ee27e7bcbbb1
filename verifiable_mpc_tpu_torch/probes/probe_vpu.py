"""Throughput of the card's 32-bit integer and FP32 pipes and of the field
products (P1, P2): the port of the JAX package's ``probes/probe_vpu.py``.

P1 (``csrc/probe_vpu.cu``, counterpart of the pallas_call at
``probe_vpu.py:38``) runs ``ITERS`` steps of one elementwise op a lane
over a ``(64, 1024)`` tile, four cases as the TPU probe's: ``u32_mul_split``
``((x*y) & 0xFFFF) + ((x*y) >> 16)``, ``u32_mul`` ``x*y + 1``, ``u32_add``
``(x + y) ^ x`` and ``f32_fma`` ``x*y + x`` (one fused multiply-add).  The
rate counts 4, 2, 2 and 2 operations a step, as the TPU probe does.

P2 (``probe_vpu.py:94``) runs ``FIELD_ITERS`` dependent field products a
lane over ``[16, 64, 128]`` 16-bit limbs: ``mont_mul`` (a word-by-word
Montgomery product mod 2^255 - 19, R = 2^256, as ``limbs_lm.mont_mul``
with p25519's constants), ``mul25519`` (the pseudo-Mersenne product of
``csrc/fe25519.cuh``, which K1-K4 and K13-K16 run) and, as a third row,
``fp_mul`` (the BN256 Montgomery product of ``csrc/fp254.cuh``, which
K5-K12 run).

Each rate is printed beside the bound model's (:mod:`..bound_model`: 64
32-bit integer and 128 FP32 FMA lanes per SM per clock at 1.98 GHz) and the
card's name and power limit.  On the card each probe also runs at a lane
count that fills it (every SM at the threads the kernel's registers allow).

    python -m verifiable_mpc_tpu_torch.probes.probe_vpu [--device cpu]

The plain versions on the CPU take hours at the probe's counts; call
:func:`run` with smaller ``iters`` and ``field_iters`` there.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import bound_model as bm
from . import (LAUNCHES, MASK32, card_line, check_limbs, check_words, device,
               limbs_to_words, model_rate, random_limbs, resident_lanes,
               time_ms, words_to_limbs)

SHAPE = (64, 1024)
ITERS = 1_000_000
FIELD_SHAPE = (16, 64, 128)
FIELD_ITERS = 2000

# name -> (kernel op, dtype, operations a step as the TPU probe counts
# them, instructions a step on the card, the model's steps a lane per SM
# per clock).  The instructions (chip_smoke.py reads them in the SASS):
# IMAD + LOP3 + LEA.HI, IMAD, IMAD.IADD + LOP3, FFMA.  The model: IMAD on
# the FMA pipe, FFMA on the FP32 pipe, LOP3 and LEA.HI on the integer ALU
# pipe, each step bound by its busiest pipe (two ALU instructions a
# u32_mul_split step).
CASES = {
    "u32_mul_split": (0, torch.uint32, 4, 3, bm.ALU_PER_SM_CLK / 2),
    "u32_mul": (1, torch.uint32, 2, 1, bm.IMAD_PER_SM_CLK),
    "u32_add": (2, torch.uint32, 2, 2, bm.ALU_PER_SM_CLK),
    "f32_fma": (3, torch.float32, 2, 1, bm.FFMA_PER_SM_CLK),
}
# name -> (kernel op, 32-bit multiplies a product in the bound model)
FIELD_CASES = {
    "mont_mul": (1, bm.MULS_PER_MONT_MUL),
    "mul25519": (0, bm.MULS_PER_FIELD_MUL),
    "fp_mul": (2, bm.MULS_PER_MONT_MUL),
}
P25519 = (1 << 255) - 19


def inputs(shape=SHAPE, field_shape=FIELD_SHAPE, seed: int = 0, dev="cpu"):
    """(xu, yu, xf, yf, xm, ym) drawn as the TPU probe draws them from
    ``RandomState(seed)``: u32 in [1, 2^15), f32 in [0, 1), raw 16-bit
    field limbs."""
    rng = np.random.RandomState(seed)
    xu = rng.randint(1, 1 << 15, shape).astype(np.uint32)
    yu = rng.randint(1, 1 << 15, shape).astype(np.uint32)
    xf = rng.rand(*shape).astype(np.float32)
    yf = rng.rand(*shape).astype(np.float32)
    xm = random_limbs(rng, field_shape)
    ym = random_limbs(rng, field_shape)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (xu, yu, xf, yf, xm, ym))


def _check_pair(x, y, dtype, name):
    if x.dtype != dtype or y.dtype != dtype or x.shape != y.shape:
        raise ValueError(f"{name}: expected two {dtype} tensors of one "
                         f"shape, got {x.dtype} {tuple(x.shape)} and "
                         f"{y.dtype} {tuple(y.shape)}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if x.device != y.device:
        raise ValueError(f"{name}: inputs lie on different devices")


# ---------------------------------------------------------------------------
# P1
# ---------------------------------------------------------------------------


def vpu_op(name: str, x: torch.Tensor, y: torch.Tensor,
           iters: int) -> torch.Tensor:
    """``iters`` steps of case ``name`` (x <- f(x, y)) on every element.
    CUDA: P1; CPU: :func:`plain_vpu_op`."""
    op, dtype = CASES[name][:2]
    _check_pair(x, y, dtype, name)
    if x.device.type == "cpu":
        return plain_vpu_op(name, x, y, iters)
    from ..ops import _cuda_build as cb
    from ..ops import msm_cuda as mc

    out = torch.empty_like(x)
    cb.check(cb.lib().vmpc_cu_probe_vpu(op, x.data_ptr(), y.data_ptr(),
                                        out.data_ptr(), x.numel(), iters,
                                        mc._stream(x)), "probe_vpu")
    LAUNCHES["probe_vpu"] += 1
    return out


def mul32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x * y mod 2^32 for int64 tensors of u32 values, without an int64
    overflow: y is split into 16-bit halves."""
    hi = ((x * (y >> 16)) & 0xFFFF) << 16
    return (x * (y & 0xFFFF) + hi) & MASK32


def plain_vpu_op(name: str, x: torch.Tensor, y: torch.Tensor,
                 iters: int) -> torch.Tensor:
    """Plain version of P1: the u32 cases exact on int64 with a 32-bit
    mask; ``f32_fma`` as one rounding of the float64 value of x*y + x to
    float32 (the fused multiply-add's result, but for double rounding where
    x*y + x needs more than 53 bits)."""
    if name == "f32_fma":
        a, b = x.to(torch.float64), y.to(torch.float64)
        for _ in range(iters):
            a = (a * b + a).to(torch.float32).to(torch.float64)
        return a.to(torch.float32)
    a, b = x.to(torch.int64), y.to(torch.int64)
    for _ in range(iters):
        if name == "u32_mul_split":
            p = mul32(a, b)
            a = (p & 0xFFFF) + (p >> 16)
        elif name == "u32_mul":
            a = (mul32(a, b) + 1) & MASK32
        elif name == "u32_add":
            a = ((a + b) & MASK32) ^ a
        else:
            raise KeyError(name)
    return a.to(torch.uint32)


# ---------------------------------------------------------------------------
# P2
# ---------------------------------------------------------------------------


def field_chain(name: str, x: torch.Tensor, y: torch.Tensor,
                iters: int) -> torch.Tensor:
    """``iters`` steps of x <- x * y with product ``name`` on ``[16, *B]``
    uint32 16-bit limbs (limb-major, the TPU probe's layout), through
    :func:`field_chain_words`.  Results on the card are relaxed (below
    2^256, congruent), those of the plain version canonical: compare
    :func:`canonical` values."""
    check_limbs(x, "x")
    check_limbs(y, "y")
    if x.shape != y.shape:
        raise ValueError("x and y differ in shape")
    out = field_chain_words(name, limbs_to_words(x), limbs_to_words(y),
                            iters)
    return words_to_limbs(out, x.shape[1:])


def field_chain_words(name: str, xw: torch.Tensor, yw: torch.Tensor,
                      iters: int) -> torch.Tensor:
    """:func:`field_chain` on word-major ``[8, n]`` uint32 words.  CUDA:
    P2; CPU: :func:`plain_field_chain`."""
    op = FIELD_CASES[name][0]
    check_words(xw, "x")
    check_words(yw, "y")
    if xw.shape != yw.shape or xw.device != yw.device:
        raise ValueError("x and y differ in shape or device")
    n = xw.shape[1]
    if xw.device.type == "cpu":
        return limbs_to_words(plain_field_chain(
            name, words_to_limbs(xw, (n,)), words_to_limbs(yw, (n,)), iters))
    from ..ops import _cuda_build as cb
    from ..ops import msm_cuda as mc

    out = torch.empty_like(xw)
    cb.check(cb.lib().vmpc_cu_probe_field(op, xw.data_ptr(), yw.data_ptr(),
                                          out.data_ptr(), n, iters,
                                          mc._stream(xw)), "probe_field")
    LAUNCHES["probe_field"] += 1
    return out


def plain_field_chain(name: str, x: torch.Tensor, y: torch.Tensor,
                      iters: int) -> torch.Tensor:
    """Plain version of P2 (and of P3's chains): the port's plain fields,
    canonical results.  ``mont_mul`` is the same function as a product
    times 38^-1 (R = 2^256 == 38 mod p), which is how it runs here."""
    from ..ops import field25519 as fe
    from ..ops import field_bn254 as fb

    a = x.to(torch.int64).movedim(0, -1)
    b = y.to(torch.int64).movedim(0, -1)
    if name == "fp_mul":
        for _ in range(iters):
            a = fb.mont_mul(a, b)
        return fb.canon(a).movedim(-1, 0).to(torch.uint32)
    if name == "mul25519":
        for _ in range(iters):
            a = fe.mul(a, b)
    elif name == "mont_mul":
        r_inv = fe.const_rows(pow(38, -1, P25519), (), a.device)
        for _ in range(iters):
            a = fe.mul(fe.mul(a, b), r_inv)
    else:
        raise KeyError(name)
    return fe.canon(a).movedim(-1, 0).to(torch.uint32)


def canonical(name: str, limbs: torch.Tensor) -> torch.Tensor:
    """``[16, *B]`` limbs of values below 2^256 -> the canonical residues
    mod the product's prime, as ``[16, *B]`` uint32 limbs."""
    from ..ops import field25519 as fe
    from ..ops import field_bn254 as fb

    a = limbs.to(torch.int64).movedim(0, -1)
    f = fb if name == "fp_mul" else fe
    return f.canon(a).movedim(-1, 0).to(torch.uint32)


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------


def _resident(dev, kernel: int) -> int:
    from ..ops import _cuda_build as cb

    return resident_lanes(dev, cb.lib().vmpc_cu_probe_vpu_resident(kernel))


def _variants(shape, field_shape, dev, reps: int = 4):
    """Inputs for a warm-up and ``reps - 1`` timed runs: the TPU probe's
    draw first, then fresh draws (distinct inputs a run)."""
    return [inputs(shape, field_shape, seed, dev) for seed in range(reps)]


def shapes(dev: torch.device) -> list:
    """[(label, P1 shape, P2 shape)]: the TPU probe's, and on the card a
    lane count that fills it ("full")."""
    out = [("tpu", SHAPE, FIELD_SHAPE)]
    if dev.type == "cuda":
        n1 = max(_resident(dev, CASES[c][0]) for c in CASES)
        n2 = max(_resident(dev, 4 + FIELD_CASES[c][0]) for c in FIELD_CASES)
        out.append(("full", (n1 // 1024, 1024), (16, n2 // 128, 128)))
    return out


def run(dev=None, iters: int = ITERS, field_iters: int = FIELD_ITERS) -> list:
    """Time every case at each of :func:`shapes`; one dict a row."""
    dev = device(dev)
    cuda = dev.type == "cuda"
    rows = []
    for label, shape, fshape in shapes(dev):
        var = _variants(shape, fshape, dev)
        lanes = int(np.prod(shape))
        for name, (_op, dtype, nops, instrs, per_clk) in CASES.items():
            k = 2 if dtype == torch.float32 else 0
            ms = time_ms(lambda x, y, nm=name: vpu_op(nm, x, y, iters),
                         [(v[k], v[k + 1]) for v in var])
            steps = iters * lanes / ms * 1e3
            rows.append({
                "probe": "P1", "case": name, "shape": label,
                "dims": list(shape), "lanes": lanes, "iters": iters,
                "ms": ms, "rate": steps * nops,
                "model_rate": (model_rate(dev, per_clk) * nops
                               if cuda else None),
                "steps_per_sm_clk": (steps / model_rate(dev, 1)
                                     if cuda else None),
                "instrs": instrs, "model_per_sm_clk": per_clk})
        flanes = int(np.prod(fshape[1:]))
        for name, (_op, muls) in FIELD_CASES.items():
            ms = time_ms(lambda x, y, nm=name: field_chain_words(
                nm, x, y, field_iters),
                [(limbs_to_words(v[4]), limbs_to_words(v[5])) for v in var])
            rows.append({
                "probe": "P2", "case": name, "shape": label,
                "dims": list(fshape), "lanes": flanes, "iters": field_iters,
                "ms": ms, "rate": field_iters * flanes / ms * 1e3,
                "model_rate": (model_rate(dev, bm.IMAD_PER_SM_CLK) / muls
                               if cuda else None),
                "muls": muls})
    return rows


def show(rows, dev) -> None:
    """Print the rows as the TPU probe prints its lines, each rate beside
    the model's and the card."""
    print(f"card: {card_line(dev)}", flush=True)
    for r in rows:
        if r["probe"] == "P1":
            head = (f"{r['case']} {r['shape']} {tuple(r['dims'])}: "
                    f"{r['ms']:.2f} ms -> {r['rate'] / 1e9:.1f} Gop/s")
        else:
            head = (f"{r['case']}[{','.join(map(str, r['dims']))}] "
                    f"x{r['iters']} ({r['shape']}): {r['ms']:.3f} ms -> "
                    f"{r['rate'] / 1e6:.2f} M fieldmul-lanes/s")
        if r["model_rate"]:
            scale = 1e9 if r["probe"] == "P1" else 1e6
            unit = "Gop/s" if r["probe"] == "P1" else "M fieldmul-lanes/s"
            head += (f" (model {r['model_rate'] / scale:.1f} {unit}, "
                     f"{r['rate'] / r['model_rate']:.3f} of it")
            if r["probe"] == "P1":
                st = r["steps_per_sm_clk"]
                head += (f"; {st:.1f} steps ({st * r['instrs']:.1f} "
                         f"instructions) per SM per clock at "
                         f"{bm.BOOST_HZ / 1e9:g} GHz, model "
                         f"{r['model_per_sm_clk']:g} steps")
            head += ")"
        print(head, flush=True)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = device(args.device)
    rows = run(dev)
    show(rows, dev)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
