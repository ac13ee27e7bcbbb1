"""Carry-chain ceiling of the field product (P3, P4): the port of the JAX
package's ``probes/probe_carrychain.py``.

P3 (``csrc/probe_carrychain.cu``, counterpart of the pallas_call at
``probe_carrychain.py:73``) runs ``ITERS`` steps of a <- mul25519(a, b)
(``csrc/fe25519.cuh``'s ``fe_mul``) a lane: one dependent chain
(``chain``) or four independent chains interleaved in one loop (``ilp4``).
If ilp4/chain is well above 1, one chain leaves the multiply pipes idle
waiting on its own results (latency-bound), and interleaving independent
products pays; near 1, the pipes are busy already.

P4 (``probe_carrychain.py:89``) runs ``64 * ITERS`` steps of x <- x * y + 1
on the same tile: the 32-bit multiply ceiling that P3 is read against.

Shapes: the TPU probe's ``[16, 8, 128]`` (1,024 lanes, 16,384 u32 elements
for P4), and on the card also a lane count that fills it and, for P3, one
lane (the shape of the serial tails K6, K10, K14).

    python -m verifiable_mpc_tpu_torch.probes.probe_carrychain [ITERS]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import bound_model as bm
from . import (LAUNCHES, card_line, check_limbs, check_words, device,
               limbs_to_words, model_rate, random_limbs, resident_lanes,
               time_ms, words_to_limbs)
from .probe_vpu import plain_field_chain, plain_vpu_op

B = (8, 128)
ITERS = 20000
RAW_PER_ITER = 64  # P4 runs 64 steps for each of P3's
# 32-bit multiplies a mul25519 in the card's bound model (the TPU probe
# counted 272 for its 16-bit limbs)
MULS_PER_FIELD_MUL = bm.MULS_PER_FIELD_MUL
CHAINS = {"chain": 1, "ilp4": 4}


def operands(rng: np.random.RandomState, k: int, shape, dev="cpu"):
    """k + 1 operands of raw 16-bit limbs (the k chains' starts, then b),
    drawn as the TPU probe's ``operand()``."""
    return [torch.from_numpy(random_limbs(rng, shape)).to(dev)
            for _ in range(k + 1)]


def chain(a: list, b: torch.Tensor, iters: int) -> list:
    """``iters`` steps of a_c <- mul25519(a_c, b) for each of the 1 or 4
    ``[16, *B]`` uint32 limb tensors in ``a``, through :func:`chain_words`.
    Results on the card are relaxed (below 2^256), the plain version's
    canonical: compare canonical values."""
    for t in a:
        check_limbs(t, "a")
        if t.shape != b.shape:
            raise ValueError("a and b differ in shape")
    check_limbs(b, "b")
    aw = torch.stack([limbs_to_words(t) for t in a])
    out = chain_words(aw, limbs_to_words(b), iters)
    return [words_to_limbs(w, b.shape[1:]) for w in out]


def chain_words(aw: torch.Tensor, bw: torch.Tensor,
                iters: int) -> torch.Tensor:
    """:func:`chain` on word-major words: ``aw`` [k, 8, n] (k = 1 or 4),
    ``bw`` [8, n] uint32.  CUDA: P3; CPU: :func:`plain_chain`."""
    check_words(bw, "b")
    k = aw.shape[0]
    if (aw.dim() != 3 or k not in (1, 4) or aw.shape[1:] != bw.shape
            or aw.dtype != torch.uint32 or not aw.is_contiguous()):
        raise ValueError(f"a: expected contiguous uint32 [1 or 4, 8, n] "
                         f"words, got {aw.dtype} {tuple(aw.shape)}")
    if aw.device != bw.device:
        raise ValueError("a and b lie on different devices")
    n = bw.shape[1]
    if bw.device.type == "cpu":
        b = words_to_limbs(bw, (n,))
        return torch.stack([
            limbs_to_words(t) for t in plain_chain(
                [words_to_limbs(w, (n,)) for w in aw], b, iters)])
    from ..ops import _cuda_build as cb
    from ..ops import msm_cuda as mc

    out = torch.empty_like(aw)
    cb.check(cb.lib().vmpc_cu_probe_chain(k, aw.data_ptr(), bw.data_ptr(),
                                          out.data_ptr(), n, iters,
                                          mc._stream(bw)), "probe_chain")
    LAUNCHES["probe_chain"] += 1
    return out


def plain_chain(a: list, b: torch.Tensor, iters: int) -> list:
    """Plain version of P3: each chain through the plain ``mul25519``."""
    return [plain_field_chain("mul25519", t, b, iters) for t in a]


def raw(x: torch.Tensor, y: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` steps of x <- x * y + 1 mod 2^32 on every element of the
    uint32 tensors.  CUDA: P4; CPU: :func:`plain_raw`."""
    if (x.dtype != torch.uint32 or y.dtype != torch.uint32
            or x.shape != y.shape or x.device != y.device):
        raise ValueError("raw: expected two uint32 tensors of one shape "
                         "and device")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("raw: inputs must be contiguous")
    if x.device.type == "cpu":
        return plain_raw(x, y, steps)
    from ..ops import _cuda_build as cb
    from ..ops import msm_cuda as mc

    out = torch.empty_like(x)
    cb.check(cb.lib().vmpc_cu_probe_raw(x.data_ptr(), y.data_ptr(),
                                        out.data_ptr(), x.numel(), steps,
                                        mc._stream(x)), "probe_raw")
    LAUNCHES["probe_raw"] += 1
    return out


def plain_raw(x: torch.Tensor, y: torch.Tensor, steps: int) -> torch.Tensor:
    """Plain version of P4: exact on int64 with a 32-bit mask."""
    return plain_vpu_op("u32_mul", x, y, steps)


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------


def _resident(dev, kernel: int) -> int:
    from ..ops import _cuda_build as cb

    return resident_lanes(
        dev, cb.lib().vmpc_cu_probe_carrychain_resident(kernel))


def shapes(dev: torch.device) -> dict:
    """{label: {"chain" / "ilp4" / "raw": batch shape after the 16 limbs}}:
    the TPU probe's, and on the card P3 at one lane and both at a lane count
    that fills the card ("full")."""
    out = {"tpu": {k: B for k in ("chain", "ilp4", "raw")}}
    if dev.type == "cuda":
        out["one lane"] = {"chain": (1,), "ilp4": (1,)}
        out["full"] = {
            "chain": (_resident(dev, 0),), "ilp4": (_resident(dev, 1),),
            "raw": (_resident(dev, 2) // 16,)}
    return out


def run(dev=None, iters: int = ITERS) -> list:
    """Time P3 (chain, ilp4) and P4 at each of :func:`shapes`; one dict a
    row."""
    dev = device(dev)
    cuda = dev.type == "cuda"
    rng = np.random.RandomState(7)
    rows = []
    for label, per in shapes(dev).items():
        for name, k in CHAINS.items():
            if name not in per:
                continue
            shape = (16,) + per[name]
            lanes = int(np.prod(per[name]))
            var = []
            for _ in range(4):
                ops = operands(rng, k, shape, dev)
                var.append((torch.stack([limbs_to_words(t)
                                         for t in ops[:k]]),
                            limbs_to_words(ops[k])))
            ms = time_ms(lambda a, b: chain_words(a, b, iters), var)
            rows.append({
                "probe": "P3", "case": name, "shape": label,
                "dims": list(shape), "lanes": lanes, "iters": iters,
                "ms": ms, "fmuls": iters * k,
                "rate": iters * k * lanes / ms * 1e3,
                "model_rate": (model_rate(dev, bm.IMAD_PER_SM_CLK)
                               / MULS_PER_FIELD_MUL if cuda else None)})
        if "raw" in per:
            shape = (16,) + per["raw"]
            lanes = int(np.prod(per["raw"]))
            steps = iters * RAW_PER_ITER
            var = [tuple(operands(rng, 1, shape, dev)) for _ in range(4)]
            ms = time_ms(lambda x, y: raw(x, y, steps), var)
            rows.append({
                "probe": "P4", "case": "raw", "shape": label,
                "dims": list(shape), "lanes": lanes, "iters": steps,
                "ms": ms, "rate": steps * 16 * lanes / ms * 1e3,
                "model_rate": (model_rate(dev, bm.IMAD_PER_SM_CLK)
                               if cuda else None)})
    return rows


def show(rows, dev) -> None:
    """Print the rows as the TPU probe prints its lines, each rate beside
    the model's and the card: per shape, the chain rates, the raw multiply
    rate, each chain's multiply utilisation against raw and ilp4/chain."""
    print(f"card: {card_line(dev)}", flush=True)
    by = {}
    for r in rows:
        by.setdefault(r["shape"], {})[r["case"]] = r
    for label, rs in by.items():
        for name in CHAINS:
            r = rs.get(name)
            if r is None:
                continue
            line = (f"{name} {label} {tuple(r['dims'])}: {r['ms']:.3f} ms"
                    f" for {r['fmuls']} field muls x {r['lanes']} lanes -> "
                    f"{r['rate'] / 1e6:.3f} M fieldmul-lanes/s, "
                    f"{1e6 * r['ms'] / r['fmuls']:.2f} ns a step")
            if r["model_rate"]:
                line += (f" (model {r['model_rate'] / 1e6:.1f} M, "
                         f"{r['rate'] / r['model_rate']:.6f} of it)")
            print(line, flush=True)
        raw_row = rs.get("raw")
        if raw_row is not None:
            line = (f"raw u32 mul {label} {tuple(raw_row['dims'])}: "
                    f"{raw_row['rate'] / 1e12:.3f} T mults/s")
            if raw_row["model_rate"]:
                line += (f" (model {raw_row['model_rate'] / 1e12:.3f}, "
                         f"{raw_row['rate'] / raw_row['model_rate']:.3f} "
                         "of it)")
            print(line, flush=True)
            for name in CHAINS:
                r = rs.get(name)
                if r is None:
                    continue
                util = r["rate"] * MULS_PER_FIELD_MUL / raw_row["rate"]
                print(f"{name} {label}: {r['rate'] / r['lanes']:.0f} field "
                      f"muls/s/lane, multiply-op utilization "
                      f"{100 * util:.1f}% of raw u32 peak "
                      f"({MULS_PER_FIELD_MUL} multiplies a product)",
                      flush=True)
        if "chain" in rs and "ilp4" in rs:
            print(f"ilp4/chain speedup {label}: "
                  f"{rs['ilp4']['rate'] / rs['chain']['rate']:.2f}x "
                  "(>1.5 => latency/scheduling-bound; ~1 => saturated)",
                  flush=True)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("iters", nargs="?", type=int, default=ITERS)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = device(args.device)
    rows = run(dev, args.iters)
    show(rows, dev)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
