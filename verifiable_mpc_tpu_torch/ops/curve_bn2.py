"""BN256 twist (G2) group law on tensors (plain PyTorch) and the host <->
device point format.

Counterpart of the JAX package's twist adapter ``ops/bn2_pallas.py``: the
complete projective formulas of Renes-Costello-Batina 2015 for a = 0 over
GF(p^2), Algorithm 7 (add, ``bn2_add_lm``) and Algorithm 9 (double,
``bn2_dbl_lm``), in Montgomery form over ``ops/field_bn254x2.py``, with
``identity`` = (0 : 1 : 0) and ``neg_where``.  The CUDA kernels carry the
same formulas in ``csrc/bn2_kernels.cuh``.

Device formats (shared by the kernels and the plain versions): a point is
a row of 24 int64 holding the u64 limbs of X.c0, X.c1, Y.c0, Y.c1, Z.c0,
Z.c1 (four each, little endian), each part canonical.

- *Input rows*, what the kernels take: jacobian, standard form, exactly the
  rows of ``native._bn2_pts_to_u64``, so encoding is one upload
  (:func:`encode_points`).
- *Working rows*, what the kernels compute on: projective (X Z, Y, Z^3),
  Montgomery form.  K9, K11 and K12 make them from input rows in a first
  launch; :func:`encode_jacobian_rows` is its plain version.
- *Result rows*: normalized, standard form, the affine row (x, y, 1) and the
  identity as (1, 1, 0) -- the rows of ``native._bn2_pts_to_u64`` for
  ``BNTwistPoint(x, y, 1)`` and ``BNTwistPoint.identity``, so decoding is
  one call of ``native._u64_to_bn2_pts``, and a result row is an input row.

The plain versions split a row into three ``[..., 32]`` coordinates
(:func:`split_rows`): the same ``[..., limbs]`` shape as the G1 law's, so
``msm_cuda``'s generic tree sum and Horner take either law.
"""

from __future__ import annotations

import numpy as np
import torch

from . import field_bn254 as fp
from . import field_bn254x2 as fp2
from .curve_ed import to_rows  # noqa: F401 (the same u64 view of rows)

COORDS = 3
ROW = 8 * COORDS  # u64 words per point row
# the identity (0 : 1 : 0) as a working row (1 in Montgomery form), int64
IDENTITY_MONT_ROW = tuple(int(v) for v in np.array(
    [0] * 8 + [(fp.ONE >> (64 * i)) & (2**64 - 1) for i in range(4)]
    + [0] * 12, dtype=np.uint64).view(np.int64))


# ---------------------------------------------------------------------------
# rows <-> coordinates
# ---------------------------------------------------------------------------


def from_u64_rows(rows: np.ndarray, device) -> torch.Tensor:
    """``[n, 24]`` u64 rows -> ``[n, 24]`` int64 device tensor (one copy)."""
    rows = np.ascontiguousarray(rows, dtype=np.uint64)
    if rows.ndim != 2 or rows.shape[1] != ROW:
        raise ValueError(f"expected [n, {ROW}] u64 twist point rows, got "
                         f"{rows.shape}")
    return torch.from_numpy(rows.view(np.int64).copy()).to(device)


def split_rows(rows: torch.Tensor):
    """``[..., 24]`` int64 rows -> 3 x ``[..., 32]`` GF(p^2) coords."""
    return tuple(fp2.from_u64(rows[..., 8 * j : 8 * j + 8])
                 for j in range(COORDS))


def join_rows(coords) -> torch.Tensor:
    """3 relaxed coordinates -> ``[..., 24]`` rows of canonical values (one
    canonicalization for all three)."""
    return torch.cat(fp2.to_u64(torch.stack(torch.broadcast_tensors(*coords)))
                     .unbind(0), dim=-1)


def from_reference_rows(coords, device) -> torch.Tensor:
    """The JAX package's twist device encoding -> the port's input rows.

    ``coords`` are six ``[n, 16]`` uint32 arrays of 16-bit Montgomery limbs
    of a projective point (X.c0, X.c1, Y.c0, Y.c1, Z.c0, Z.c1), as
    ``bn2_pallas._Bn2Adapter.encode`` produces them.  The rows hold the
    same point in jacobian form, (X Z, Y Z^2, Z) in standard form, the
    identity as (1, 1, 0).  Takes numpy only: carrying state over from the
    JAX package never imports it."""
    if len(coords) != 2 * COORDS:
        raise ValueError(f"expected {2 * COORDS} limb arrays, got "
                         f"{len(coords)}")
    cols = []
    for c in coords:
        a = np.ascontiguousarray(np.asarray(c), dtype=np.uint64)
        if a.ndim != 2 or a.shape[1] != 16:
            raise ValueError(f"expected [n, 16] limb arrays, got {a.shape}")
        q = a.reshape(-1, 4, 4)
        cols.append(q[..., 0] | (q[..., 1] << np.uint64(16))
                    | (q[..., 2] << np.uint64(32))
                    | (q[..., 3] << np.uint64(48)))
    x, y, z = split_rows(from_u64_rows(np.concatenate(cols, axis=1), device))
    xz, zz = fp2.muls((x, z), (z, None))
    (yzz,) = fp2.muls((y, zz))
    xz, yzz, z = fp2.from_mont(torch.stack([xz, yzz, z])).unbind(0)
    inf = fp2.is_zero(z)[..., None]
    one = fp2.const_rows(1, 0, (), z.device)
    return join_rows((torch.where(inf, one, xz), torch.where(inf, one, yzz),
                      z))


def to_reference_rows(rows: torch.Tensor):
    """Input rows -> the JAX package's twist encoding: six ``[n, 16]``
    uint32 arrays of 16-bit Montgomery limbs of the projective point
    (canonical values; the inverse of :func:`from_reference_rows` up to
    the projective representative)."""
    u = to_rows(encode_jacobian_rows(rows))
    return tuple(
        np.ascontiguousarray(u[:, 4 * j : 4 * j + 4]).view(np.uint16)
        .astype(np.uint32) for j in range(2 * COORDS)
    )


# ---------------------------------------------------------------------------
# group law (projective, Montgomery form)
# ---------------------------------------------------------------------------


def identity(shape, device):
    zero = fp2.const_rows(0, 0, shape, device)
    return (zero, fp2.const_rows(fp.ONE, 0, shape, device), zero)


def add(p, q):
    """Complete projective addition, RCB15 Algorithm 7 (a = 0), step for
    step as ``bn2_pallas.bn2_add_lm`` (12 GF(p^2) products + 2 by 3 b'),
    in three base-field calls.  Coordinates in: sums of at most six
    reduced values per part; out: the same."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    add_, sub_ = fp2.add, fp2.sub
    t0, t1, t2, pxy, pyz, pxz = fp2.muls(
        (x1, x2), (y1, y2), (z1, z2),
        (add_(x1, y1), add_(x2, y2)), (add_(y1, z1), add_(y2, z2)),
        (add_(x1, z1), add_(x2, z2)))
    t3 = sub_(pxy, add_(t0, t1))  # x1y2 + x2y1
    t4 = sub_(pyz, add_(t1, t2))  # y1z2 + y2z1
    xz = sub_(pxz, add_(t0, t2))  # x1z2 + x2z1
    t0 = add_(add_(t0, t0), t0)  # 3 x1x2
    b3 = fp2.b3(x1.device)
    t2, y3 = fp2.muls((t2, b3), (xz, b3))  # 3b' z1z2, 3b' (x1z2 + x2z1)
    z3 = add_(t1, t2)
    t1 = sub_(t1, t2)
    a, b, c, d, e, f = fp2.muls((t3, t1), (t4, y3), (y3, t0), (t1, z3),
                                (z3, t4), (t0, t3))
    return (sub_(a, b), add_(c, d), add_(e, f))


def dbl(p):
    """Complete projective doubling, RCB15 Algorithm 9 (a = 0), step for
    step as ``bn2_pallas.bn2_dbl_lm`` (6 products, 2 squares and one
    product by 3 b' in GF(p^2)), in three base-field calls."""
    x, y, z = p
    add_ = fp2.add
    t0, t1, zz, xy = fp2.muls((y, None), (y, z), (z, None), (x, y))
    z3 = add_(t0, t0)
    z3 = add_(z3, z3)
    z3 = add_(z3, z3)  # 8 y^2
    (t2,) = fp2.muls((zz, fp2.b3(x.device)))  # 3b' z^2
    y3 = add_(t0, t2)
    t0 = fp2.sub(t0, add_(add_(t2, t2), t2))  # y^2 - 3 (3b' z^2)
    x3, z3, y3m, x3b = fp2.muls((t2, z3), (t1, z3), (t0, y3), (t0, xy))
    return (add_(x3b, x3b), add_(x3, y3m), z3)


def neg_where(mask, p):
    """-(X, Y, Z) = (X, -Y, Z) where ``mask`` (``BN2.neg_where``)."""
    x, y, z = p
    return (x, torch.where(mask[..., None], fp2.neg(y), y), z)


def normalize_rows(p) -> torch.Tensor:
    """Projective Montgomery coordinates -> ``[..., 24]`` standard-form
    affine rows (x, y, 1), the identity as (1, 1, 0): one GF(p^2)
    inversion per point, vectorized (the kernels' ``g2_store_normalized``)."""
    x, y, z = p
    zinv = fp2.from_mont(fp2.inv(z))  # Z^-1, standard form
    xs, ys = fp2.muls((x, zinv), (y, zinv))  # standard form
    inf = fp2.is_zero(z)[..., None]
    dev = x.device
    one = fp2.const_rows(1, 0, (), dev)
    xs = torch.where(inf, one, xs)
    ys = torch.where(inf, one, ys)
    zs = torch.where(inf, fp2.const_rows(0, 0, (), dev), one).expand_as(xs)
    return join_rows((xs, ys, zs))


# ---------------------------------------------------------------------------
# host <-> device
# ---------------------------------------------------------------------------


def encode_jacobian_rows(t: torch.Tensor) -> torch.Tensor:
    """``[..., 24]`` input rows (X, Y, Z), jacobian, standard form ->
    working rows (X Z, Y, Z^3), projective, Montgomery form; an identity
    (Z = 0) becomes (0 : 1 : 0).  The plain version of the kernels' first
    launch (``bn2_encode_one``)."""
    x, y, z = fp2.to_mont(torch.stack(split_rows(t))).unbind(0)
    xz, zz = fp2.muls((x, z), (z, None))
    (z3,) = fp2.muls((zz, z))
    xz, y, z3 = fp2.canon(torch.stack([xz, y, z3])).unbind(0)
    inf = (z3 == 0).all(-1, keepdim=True)
    y = torch.where(inf, fp2.const_rows(fp.ONE, 0, (), t.device), y)
    return torch.cat([fp2.to_u64(c) for c in (xz, y, z3)], dim=-1)


def encode_points(points, device) -> torch.Tensor:
    """BNTwistPoint list -> ``[n, 24]`` int64 input rows on ``device`` (one
    upload; the kernels convert them)."""
    from .. import native

    return from_u64_rows(native._bn2_pts_to_u64(list(points)), device)


def decode_rows(rows) -> list:
    """Normalized ``[n, 24]`` rows (tensor or u64 array) -> BNTwistPoint
    list; the identity row gives exactly ``BNTwistPoint.identity``'s
    coordinates."""
    from .. import native

    if isinstance(rows, torch.Tensor):
        rows = to_rows(rows)
    return native._u64_to_bn2_pts(np.ascontiguousarray(rows,
                                                       dtype=np.uint64))
