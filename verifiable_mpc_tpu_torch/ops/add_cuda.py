"""Batched unified Ed25519 addition on Montgomery limbs on the GPU.

Counterpart of the JAX package's ``ops/pallas_kernels.py``
(``pallas_add``, the fused complete Edwards add over ``[n, 16]``
Montgomery limb tiles).  The device work is one kernel hand-written in
CUDA:

=====  ========  ===========================================================
K16    mont_add  p_i + q_i, Montgomery limbs in and out (B8,
                 ``csrc/ed_add_mont.cu``)
=====  ========  ===========================================================

:func:`add` launches it for CUDA tensors and counts the launch in
``msm_cuda.LAUNCHES["mont_add"]``; for CPU tensors it runs
:func:`add_plain`.  Points are 4-tuples (x, y, z, t) of ``[n, 16]``
torch.uint32 tensors of 16-bit limbs in the Montgomery domain
(``ops/limbs_mont.py``); the results are canonical, as the JAX package's.
"""

from __future__ import annotations

import torch

from . import curve_ed as ced
from . import field25519 as fe
from . import limbs_mont as lm
from . import msm_cuda as mc


def _check(coords, name: str):
    if len(coords) != 4:
        raise ValueError(f"{name}: expected 4 coordinates, got {len(coords)}")
    shape = coords[0].shape
    for c in coords:
        if c.dtype != torch.uint32 or c.dim() != 2 or c.shape[1] != 16:
            raise ValueError(f"{name}: expected uint32 [n, 16] limbs, got "
                             f"{c.dtype} {tuple(c.shape)}")
        if c.shape != shape:
            raise ValueError(f"{name}: coordinates differ in shape")
        if not c.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")


def add(p, q) -> tuple:
    """p + q elementwise (add-2008-hwcd-3, complete) on Montgomery limbs:
    the counterpart of ``pallas_add(p, q)`` without the TPU's block.
    CUDA: K16; CPU: :func:`add_plain`."""
    _check(p, "p")
    _check(q, "q")
    if p[0].shape != q[0].shape:
        raise ValueError("p and q differ in shape")
    if mc._same_device(*p, *q).type == "cpu":
        return add_plain(p, q)
    from . import _cuda_build as cb

    n = p[0].shape[0]
    out = tuple(torch.empty_like(p[0]) for _ in range(4))
    cb.check(cb.lib().vmpc_cu_mont_add(
        *(c.data_ptr() for c in (*p, *q, *out)), n, mc._stream(p[0])),
        "mont_add")
    mc.LAUNCHES["mont_add"] += 1
    return out


def add_plain(p, q) -> tuple:
    """Plain version of K16: out of the Montgomery domain (times R^-1),
    the unified add of ``curve_ed``, back in (times R, canonical)."""
    dev = p[0].device
    r_inv = fe.const_rows(lm.R_INV, (), dev)
    r = fe.const_rows(lm.R_MOD_P, (), dev)

    def load(coords):
        return tuple(fe.mul(c.to(torch.int64), r_inv) for c in coords)

    s = ced.add(load(p), load(q))
    return tuple(fe.canon(fe.mul(c, r)).to(torch.uint32) for c in s)
