"""Microbenchmark probes of the card: the port of the JAX package's
``probes/probe_vpu.py`` (P1, P2) and ``probes/probe_carrychain.py`` (P3,
P4).

They measure what the kernels' bounds assume: the 32-bit integer multiply
and FP32 fused multiply-add rates (P1, P4), the rate of the field products
the kernels run (P2), and whether a chain of dependent products is
latency-bound (P3).  The device work is hand-written CUDA
(``csrc/probe_vpu.cu``, ``csrc/probe_carrychain.cu`` over
``csrc/probe_ops.cuh``); each wrapper counts its launches in
:data:`LAUNCHES` and runs its plain PyTorch version for CPU tensors.

Entry points: ``python -m verifiable_mpc_tpu_torch.probes.probe_vpu`` and
``python -m verifiable_mpc_tpu_torch.probes.probe_carrychain`` (both on
``cuda``; ``--device cpu`` runs the plain versions).
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

from .. import bound_model as bm

LAUNCHES = {"probe_vpu": 0, "probe_field": 0, "probe_chain": 0,
            "probe_raw": 0}

MASK32 = 0xFFFFFFFF


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def device(dev=None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when no
    card is present for ``cuda``."""
    d = torch.device("cuda" if dev is None else dev)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("probes: no CUDA device is available")
    elif d.type != "cpu":
        raise ValueError(f"probes: unsupported device {d}")
    return d


def sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def model_rate(dev: torch.device, per_sm_clk: float) -> float:
    """Operations a second at ``per_sm_clk`` per SM per clock on every SM
    at the boost clock."""
    return sms(dev) * per_sm_clk * bm.BOOST_HZ


def card_line(dev: torch.device) -> str:
    """The card's name and power limit (nvidia-smi), and its SM clock now
    and at most; ``cpu`` for the plain versions."""
    if dev.type != "cuda":
        return "cpu (plain versions)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        out = torch.cuda.get_device_name(dev) + ", power limit unknown"
    return f"{out} (name, power limit, SM clock, max SM clock)"


def resident_lanes(dev: torch.device, threads_per_sm: int) -> int:
    """Lanes that fill the card: every SM at the threads its registers
    allow for the kernel."""
    if threads_per_sm <= 0:
        raise RuntimeError(f"occupancy query failed: error {-threads_per_sm}")
    return sms(dev) * threads_per_sm


def time_ms(fn, variants) -> float:
    """Best time of ``fn(*v)`` over ``variants[1:]`` after a warm-up on
    ``variants[0]``: CUDA events on the card, the host clock on the CPU."""
    fn(*variants[0])
    cuda = variants[0][0].is_cuda
    best = float("inf")
    for v in variants[1:]:
        if cuda:
            torch.cuda.synchronize()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn(*v)
            e.record()
            e.synchronize()
            best = min(best, s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            fn(*v)
            best = min(best, 1e3 * (time.perf_counter() - t0))
    return best


# ---------------------------------------------------------------------------
# layouts: the TPU's limb-major [16, *B] 16-bit limbs <-> the kernels'
# word-major [8, n] 32-bit words
# ---------------------------------------------------------------------------


def check_limbs(t: torch.Tensor, name: str):
    if t.dtype != torch.uint32 or t.dim() < 2 or t.shape[0] != 16:
        raise ValueError(f"{name}: expected uint32 [16, ...] limbs, got "
                         f"{t.dtype} {tuple(t.shape)}")


def check_words(t: torch.Tensor, name: str):
    if t.dtype != torch.uint32 or t.dim() != 2 or t.shape[0] != 8:
        raise ValueError(f"{name}: expected uint32 [8, n] words, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def limbs_to_words(t: torch.Tensor) -> torch.Tensor:
    """[16, *B] uint32 16-bit limbs -> contiguous [8, n] uint32 words."""
    x = t.to(torch.int64).reshape(16, -1)
    return (x[0::2] | (x[1::2] << 16)).to(torch.uint32).contiguous()


def words_to_limbs(w: torch.Tensor, batch_shape) -> torch.Tensor:
    """[8, n] uint32 words -> [16, *batch_shape] uint32 16-bit limbs."""
    x = w.to(torch.int64)
    out = torch.stack([x & 0xFFFF, x >> 16], dim=1).reshape(16, -1)
    return out.reshape(16, *batch_shape).to(torch.uint32)


def random_limbs(rng: np.random.RandomState, shape) -> np.ndarray:
    """Raw 16-bit limbs, as the TPU probes draw them (values up to 2^256,
    about half of them at or above 2^255 - 19)."""
    return rng.randint(0, 1 << 16, shape).astype(np.uint32)
