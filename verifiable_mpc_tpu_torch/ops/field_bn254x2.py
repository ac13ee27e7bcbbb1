"""Arithmetic in GF(p^2) = GF(p)[i] / (i^2 + 1) over the BN256 base field,
in Montgomery form, on int64 tensors (plain PyTorch).

Counterpart of the GF(p^2) functions of the JAX package's
``ops/bn2_pallas.py`` (``_add2``, ``_sub2``, ``_mul2`` by Karatsuba,
``_sq2``, ``_b3mul2``) with the constants of its ``_consts`` (3 b' for the
twist E': y^2 = x^3 + 3 / xi, xi = i + 3, a full GF(p^2) constant).  This
is the plain version beside the CUDA code in ``csrc/fp2_254.cuh``: the CPU
tests and ``enable_gpu(device="cpu")`` run it, and ``chip_smoke.py`` holds
the twist kernels against it on the card.

Layout: ``[..., 32]`` int64, the sixteen 16-bit limbs of the real part c0
then those of the imaginary part c1, each a *relaxed* value of
``ops/field_bn254.py`` (limbs may be negative or above 2^16, any integer
congruent mod p).  Sums and differences work limb by limb and never carry.

Products go to the base field's ``mont_mul`` (limbs below 2^22 in
magnitude in, reduced values out: limbs within (-2^6, 2^17)).  A Karatsuba
product adds the two parts of each operand, so an operand part may be a
sum of at most sixteen reduced values; the twist's group law
(``ops/curve_bn2.py``) keeps within that.  :func:`muls` takes any number of
independent products and squares and issues them as *one* base-field call:
at the small batches of a Horner ladder the plain versions are bound by
the count of tensor ops they issue (PERF.md).
"""

from __future__ import annotations

import torch

from . import field_bn254 as fp
from ..groups.bn256 import B2, P

LIMBS = 2 * fp.LIMBS
R = fp.R
# 3 b' in Montgomery form, as bn2_pallas._consts holds it
B3_0 = int((3 * B2).c0) * R % P
B3_1 = int((3 * B2).c1) * R % P


def const_rows(c0: int, c1: int, shape, device) -> torch.Tensor:
    """The constant c0 + c1 i (each reduced mod 2^256) broadcast to
    ``shape + (32,)``."""
    c0, c1 = c0 % R, c1 % R
    return fp._const(("fp2", c0, c1),
                     fp.int_to_limbs(c0) + fp.int_to_limbs(c1),
                     device).expand(*tuple(shape), LIMBS)


def parts(a):
    """``[..., 32]`` -> (c0, c1), two ``[..., 16]`` views."""
    return a[..., : fp.LIMBS], a[..., fp.LIMBS :]


def join(c0, c1):
    return torch.cat(torch.broadcast_tensors(c0, c1), dim=-1)


def from_u64(t: torch.Tensor) -> torch.Tensor:
    """``[..., 8]`` int64 (u64 bit patterns of c0 then c1) -> ``[..., 32]``
    limbs."""
    return fp.from_u64(t)


def to_u64(a: torch.Tensor) -> torch.Tensor:
    """``[..., 32]`` limbs -> ``[..., 8]`` int64 bit patterns of the
    canonical parts."""
    return fp.to_u64(a.unflatten(-1, (2, fp.LIMBS))).flatten(-2)


def canon(a):
    """Canonical residues of both parts, exact 16-bit limbs."""
    return fp.canon(a.unflatten(-1, (2, fp.LIMBS))).flatten(-2)


# ---------------------------------------------------------------------------
# limb-wise operations (no carries)
# ---------------------------------------------------------------------------


def add(a, b):
    return a + b


def sub(a, b):
    return a - b


def neg(a):
    return -a


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------


def muls(*pairs):
    """Independent Montgomery products in GF(p^2) as one base-field call.

    Each pair is ``(a, b)`` for a * b R^-1 by Karatsuba (3 base-field
    products, i^2 = -1, as ``bn2_pallas._mul2``) or ``(a, None)`` for the
    square (a0 + a1)(a0 - a1) + 2 a0 a1 i (2 products, as ``_sq2``).
    Operand parts may be sums of at most sixteen reduced values."""
    lhs, rhs = [], []
    for a, b in pairs:
        a0, a1 = parts(a)
        if b is None:
            lhs += [a0 + a1, a0]
            rhs += [a0 - a1, a1]
        else:
            b0, b1 = parts(b)
            lhs += [a0, a1, a0 + a1]
            rhs += [b0, b1, b0 + b1]
    ts = torch.broadcast_tensors(*lhs, *rhs)
    k = len(lhs)
    t = fp.mont_mul(torch.stack(ts[:k]), torch.stack(ts[k:])).unbind(0)
    out, i = [], 0
    for _a, b in pairs:
        if b is None:
            m1, m2 = t[i], t[i + 1]
            out.append(join(m1, m2 + m2))
            i += 2
        else:
            t0, t1, t2 = t[i : i + 3]
            out.append(join(t0 - t1, t2 - t0 - t1))  # real, imag
            i += 3
    return out


def mul(a, b):
    return muls((a, b))[0]


def sq(a):
    return muls((a, None))[0]


def b3(device):
    """3 b' in Montgomery form, as an operand of :func:`muls`
    (``bn2_pallas._b3mul2``: Karatsuba against the constant, 3 products)."""
    return const_rows(B3_0, B3_1, (), device)


def mul_b3(a):
    return mul(a, b3(a.device))


def to_mont(a):
    """Both parts times R (mod p)."""
    return fp.to_mont(a.unflatten(-1, (2, fp.LIMBS))).flatten(-2)


def from_mont(a):
    return fp.from_mont(a.unflatten(-1, (2, fp.LIMBS))).flatten(-2)


def inv(a):
    """The inverse of a Montgomery-form value, in Montgomery form: the
    conjugate over the norm a0^2 + a1^2, one base-field Fermat inversion
    (0 maps to 0).  The same steps as ``fp2_inv`` in csrc/fp2_254.cuh."""
    pa = torch.stack(parts(a))
    sq0, sq1 = fp.mont_mul(pa, pa)
    r0, r1 = fp.mont_mul(pa, fp.inv(sq0 + sq1))
    return join(r0, -r1)


def is_zero(a):
    """[...] bool: a == 0 in GF(p^2)."""
    return (canon(a) == 0).all(-1)
