"""Arithmetic mod the BN256 base-field prime p in Montgomery form, on int64
tensors (plain PyTorch).

Counterpart of the JAX package's Montgomery limb functions in
``ops/limbs_lm.py`` (``mont_redc``, ``mont_mul``, ``mont_sq``,
``mont_mul_const``, ``add_mod``, ``sub_mod``, ``neg_mod``) with the
constants of ``ops/bn_pallas._consts`` (R = 2^256, b3 = 9 R mod p).  This is
the plain version beside the CUDA field code in ``csrc/fp254.cuh``: the CPU
tests and ``enable_gpu(device="cpu")`` run it, and ``chip_smoke.py`` holds
the kernels against it on the card.

Layout: ``[..., 16]`` int64, sixteen 16-bit limb positions, least
significant first.  int64 has no multiply-high, so limbs stay narrow.

Values are *relaxed*, to keep the count of tensor ops small (at the small
batches of a Horner ladder the op count, not the arithmetic, sets the
time): limbs may be negative or above 2^16, and a value is any integer
congruent mod p.  :func:`add`, :func:`sub` and :func:`neg` work limb by
limb and never carry.  :func:`mont_mul` accepts limbs below 2^22 in
magnitude and returns a *reduced* value: limbs within (-2^6, 2^17), value
within (-p/1000, p + p/1000).  The group law feeds it sums of at most
sixteen reduced values, so the bounds hold along any chain of group
operations.  Only :func:`canon` returns the canonical residue with exact
16-bit limbs.

Montgomery products: the plain version computes the residue a b R^-1 mod
p, the function of ``mont_mul``, by summing the limb products into
columns and folding the columns' 16-bit chunks onto 16 limbs with tables
of 2^(16 k) R^-1 mod p (exact float64 matrix products), then subtracting
a float64 estimate of the quotient by p (:func:`mont_mul`).  The kernels
reach the same residues by CIOS.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..groups.bn256 import P

R = 1 << 256
LIMBS = 16
MASK = 0xFFFF
_SHIFTS64 = (0, 16, 32, 48)

ONE = R % P  # 1 in Montgomery form
R2 = R * R % P  # to_mont multiplier
B3 = 9 * R % P  # 3 b (b = 3) in Montgomery form
_P_OVER_R = P / R  # float64, for the quotient estimate

_CONSTS = {}


def _const(key, values, device, dtype=torch.int64) -> torch.Tensor:
    """A small constant tensor, cached per device."""
    k = (key, str(device), dtype)
    t = _CONSTS.get(k)
    if t is None:
        t = _CONSTS[k] = torch.tensor(values, dtype=dtype, device=device)
    return t


def int_to_limbs(x: int) -> list:
    return [(x >> (16 * i)) & MASK for i in range(LIMBS)]


def limbs_to_int(row) -> int:
    return sum(int(v) << (16 * i) for i, v in enumerate(row))


def const_rows(c: int, shape, device) -> torch.Tensor:
    """The constant ``c`` (reduced mod 2^256) broadcast to
    ``shape + (16,)``."""
    c %= R
    return _const(c, int_to_limbs(c), device).expand(*tuple(shape), LIMBS)


def from_u64(t: torch.Tensor) -> torch.Tensor:
    """``[..., 4]`` int64 (u64 bit patterns) -> ``[..., 16]`` limbs."""
    sh = _const("shifts64", _SHIFTS64, t.device)
    return ((t[..., None] >> sh) & MASK).flatten(-2)


def to_u64(a: torch.Tensor) -> torch.Tensor:
    """``[..., 16]`` limbs -> ``[..., 4]`` int64 bit patterns of the
    canonical residue."""
    return pack_u64(canon(a))


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
# carries
# ---------------------------------------------------------------------------


def _carry_round(x, wrap: bool):
    """One parallel carry round over the last axis.  ``wrap=False`` drops
    the carry out of the top limb (arithmetic mod 2^(16 * width));
    ``wrap=True`` keeps the top limb unmasked, so the value is unchanged."""
    w = x.shape[-1]
    keep = _const(("keep", w, wrap), [MASK] * (w - 1) + [-1 if wrap else MASK],
                  x.device)
    out = x & keep
    out[..., 1:] += (x[..., :-1] >> 16)
    return out


# ---------------------------------------------------------------------------
# Montgomery multiplication
# ---------------------------------------------------------------------------


def _col_tables(dev):
    """float64 tables of the product: ``cols`` [256, 31] maps limb product
    16 i + j to its column i + j; ``fold`` [93, 16] row 3 k + c holds the
    limbs of 2^(16 (k + c)) R^-1 mod p, for 16-bit chunk c of column k."""
    key = ("cols", str(dev))
    hit = _CONSTS.get(key)
    if hit is None:
        cols = torch.zeros((LIMBS * LIMBS, 2 * LIMBS - 1), dtype=torch.float64)
        for i in range(LIMBS):
            for j in range(LIMBS):
                cols[LIMBS * i + j, i + j] = 1.0
        rinv = pow(R, -1, P)
        fold = [int_to_limbs(pow(2, 16 * (k + c), P) * rinv % P)
                for k in range(2 * LIMBS - 1) for c in range(3)]
        hit = _CONSTS[key] = (cols.to(dev), torch.tensor(
            fold, dtype=torch.float64, device=dev))
    return hit


def _weights(dev, scale: float):
    """2^(16 i - 256) / scale for the limbs i = 0..15, in float64."""
    return _const(("w", scale), [2.0 ** (16 * i - 256) / scale
                                 for i in range(LIMBS)], dev, torch.float64)


def _reduce(x):
    """A value with limbs below 2^52 in magnitude -> a reduced one:
    subtract q p for the quotient q estimated in float64 (its error stays
    below 2^-11, so floor() is off by at most one and the value lands
    within (-p/1000, p + p/1000)), then three carry rounds that keep the
    top limb (limbs then within (-2^6, 2^17))."""
    q = torch.floor(x.to(torch.float64) @ _weights(x.device, _P_OVER_R))
    x = x - q.to(torch.int64)[..., None] * const_rows(P, (), x.device)
    for _ in range(3):
        x = _carry_round(x, True)
    return x


def mont_mul(a, b):
    """a * b * R^-1 mod p (reduced), for limbs below 2^22 in magnitude.

    The limb products (below 2^44) and their 31 column sums (below 2^48)
    are exact in float64, so one float64 product with a 0/1 table gives
    the columns; each column splits into three 16-bit chunks (the top one
    signed), and the chunks fold onto 16 limbs through the table of
    2^(16 k) R^-1 mod p in one more float64 product (every partial sum an
    integer below 2^40).  (The kernels' CIOS computes the same residue;
    this route suits tensor ops.)"""
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    cmap, fold = _col_tables(a.device)
    f64 = torch.float64
    af, bf = a.to(f64), b.to(f64)
    if a[..., 0].numel() <= 4096:
        cols = (af[..., :, None] * bf[..., None, :]).flatten(-2) @ cmap
    else:  # one row of limb products at a time: 16 x less memory
        cols = None
        for i in range(LIMBS):
            part = (af[..., i : i + 1] * bf) @ cmap[LIMBS * i : LIMBS * (i + 1)]
            cols = part if cols is None else cols + part
    c = cols.to(torch.int64)
    chunks = torch.stack([c & MASK, (c >> 16) & MASK, c >> 32], dim=-1)
    return _reduce((chunks.flatten(-2).to(f64) @ fold).to(torch.int64))


def mont_sq(a):
    return mont_mul(a, a)


def mont_mul_const(a, c: int):
    """a * c * R^-1 mod p for a constant ``c`` given in Montgomery form
    (``B3`` for the group law's 3b)."""
    return mont_mul(a, const_rows(c, (), a.device))


def to_mont(a):
    return mont_mul(a, const_rows(R2, (), a.device))


def from_mont(a):
    return mont_mul(a, const_rows(1, (), a.device))


# ---------------------------------------------------------------------------
# canonical residues, inversion
# ---------------------------------------------------------------------------


def _seq_carry(x):
    """Exact sequential carry of ``[..., 17]`` limbs: limbs 0..15 end in
    [0, 2^16), limb 16 keeps the signed rest."""
    limbs = list(x.unbind(-1))
    c = torch.zeros_like(limbs[0])
    for k in range(LIMBS):
        v = limbs[k] + c
        c = v >> 16
        limbs[k] = v & MASK
    limbs[LIMBS] = limbs[LIMBS] + c
    return torch.stack(limbs, dim=-1)


def _sub_p_if_ge(x):
    """Exact ``[..., 17]`` limbs of a value in [0, 2^257) -> the value
    minus p where it is >= p, exact again.  The sign of value - p is the
    sign of its top nonzero limb difference (each is below 2^16 in
    magnitude), read off as the sign of sum_i sign(d_i) 2^i."""
    p17 = _const("p17", int_to_limbs(P) + [0], x.device)
    w = _const("pow2_17", [1 << i for i in range(LIMBS + 1)], x.device)
    ge = (torch.sign(x - p17) * w).sum(-1, keepdim=True) >= 0
    return _seq_carry(x - ge * p17)


def canon(a):
    """Any relaxed value (limbs below 2^52) -> the canonical residue in
    [0, p) with exact 16-bit limbs."""
    p17 = _const("p17", int_to_limbs(P) + [0], a.device)
    x = _reduce(a)  # within (-p/1000, p + p/1000)
    x = _seq_carry(F.pad(x, (0, 1)) + p17)  # within (0, 2.002 p)
    return _sub_p_if_ge(_sub_p_if_ge(x))[..., :LIMBS]


def pack_u64(c):
    """Exact ``[..., 16]`` limbs -> ``[..., 4]`` int64 u64 bit patterns."""
    q = c.unflatten(-1, (4, 4))
    return (q[..., 0] | (q[..., 1] << 16) | (q[..., 2] << 32)
            | (q[..., 3] << 48))


_EXP_BITS = bin(P - 2)[2:]


def inv(a):
    """a^(p-2) by left-to-right square-and-multiply in the Montgomery
    domain: the inverse of a Montgomery-form value, in Montgomery form (0
    maps to 0).  The same chain as ``fp_inv`` in csrc/fp254.cuh."""
    r = a
    for bit in _EXP_BITS[1:]:
        r = mont_sq(r)
        if bit == "1":
            r = mont_mul(r, a)
    return r


def is_zero(a):
    """[...] bool: a == 0 mod p."""
    return (canon(a) == 0).all(-1)
