"""BN256 G1 group law on tensors (plain PyTorch) and the host <-> device
point format.

Counterpart of the JAX package's BN adapter ``ops/bn_pallas.py``: the
complete projective formulas of Renes-Costello-Batina 2015 for a = 0,
Algorithm 7 (add, ``bn_add_lm``) and Algorithm 9 (double, ``bn_dbl_lm``),
in Montgomery form over ``ops/field_bn254.py``, with ``identity`` = (0:1:0)
and ``neg_where``.  The CUDA kernels carry the same formulas in
``csrc/bn254_kernels.cuh``.

Device formats (shared by the kernels and the plain versions): a point is
a row of 12 int64 holding the u64 limbs of X, Y, Z (four each, little
endian), each coordinate canonical.

- *Input rows*, what the kernels take: jacobian, standard form, exactly the
  rows of ``native._bn_pts_to_u64``, so encoding is one upload
  (:func:`encode_points`).
- *Working rows*, what the kernels compute on: projective (X Z, Y, Z^3),
  Montgomery form (x R mod p).  K5, K7 and K8 make them from input rows
  in a first launch; :func:`encode_jacobian_rows` is its plain version.
- *Result rows*: normalized, standard form, the affine row (x, y, 1) and
  the identity as (1, 1, 0) -- the rows of ``native._bn_pts_to_u64`` for
  ``BNPoint(x, y, 1)`` and ``BNPoint.identity``, so decoding is one call
  of ``native._u64_to_bn_pts``, and a result row is an input row.

The plain versions split a row into three ``[..., 16]`` coordinates
(:func:`split_rows`).
"""

from __future__ import annotations

import numpy as np
import torch

from . import field_bn254 as fp
from .curve_ed import to_rows  # noqa: F401 (the same u64 view of rows)

COORDS = 3
ROW = 4 * COORDS  # u64 words per point row
# the identity (0 : 1 : 0) as a working row (1 in Montgomery form), int64
IDENTITY_MONT_ROW = tuple(int(v) for v in np.array(
    [0] * 4 + [(fp.ONE >> (64 * i)) & (2**64 - 1) for i in range(4)] + [0] * 4,
    dtype=np.uint64).view(np.int64))


# ---------------------------------------------------------------------------
# rows <-> coordinates
# ---------------------------------------------------------------------------


def from_u64_rows(rows: np.ndarray, device) -> torch.Tensor:
    """``[n, 12]`` u64 rows -> ``[n, 12]`` int64 device tensor (one copy)."""
    rows = np.ascontiguousarray(rows, dtype=np.uint64)
    if rows.ndim != 2 or rows.shape[1] != ROW:
        raise ValueError(f"expected [n, {ROW}] u64 point rows, got "
                         f"{rows.shape}")
    return torch.from_numpy(rows.view(np.int64).copy()).to(device)


def split_rows(rows: torch.Tensor):
    """``[..., 12]`` int64 rows -> 3 x ``[..., 16]`` 16-bit-limb coords."""
    return tuple(fp.from_u64(rows[..., 4 * j : 4 * j + 4])
                 for j in range(COORDS))


def join_rows(coords) -> torch.Tensor:
    """3 relaxed coordinates -> ``[..., 12]`` rows of canonical values (one
    canonicalization for all three)."""
    return torch.cat(fp.to_u64(torch.stack(torch.broadcast_tensors(*coords)))
                     .unbind(0), dim=-1)


def from_reference_rows(coords, device) -> torch.Tensor:
    """The JAX package's BN device encoding -> the port's input rows.

    ``coords`` are three ``[n, 16]`` uint32 arrays of 16-bit Montgomery
    limbs of a projective point (X, Y, Z), as ``bn_pallas._BnAdapter.encode``
    and ``_to_mont_rows`` produce them.  The rows hold the same point in
    jacobian form, (X Z, Y Z^2, Z) in standard form, the identity as
    (1, 1, 0).  Takes numpy only: carrying state over from the JAX package
    never imports it."""
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
    xz, zz = _muls((x, z), (z, z))
    (yzz,) = _muls((y, zz))
    xz, yzz, z = (fp.from_mont(c) for c in (xz, yzz, z))
    inf = fp.is_zero(z)[..., None]
    one = fp.const_rows(1, (), z.device)
    return join_rows((torch.where(inf, one, xz), torch.where(inf, one, yzz),
                      z))


def to_reference_rows(rows: torch.Tensor):
    """Input rows -> the JAX package's BN encoding: three ``[n, 16]``
    uint32 arrays of 16-bit Montgomery limbs of the projective point
    (canonical values; the inverse of :func:`from_reference_rows` up to
    the projective representative)."""
    u = to_rows(encode_jacobian_rows(rows))
    return tuple(
        np.ascontiguousarray(u[:, 4 * j : 4 * j + 4]).view(np.uint16)
        .astype(np.uint32) for j in range(COORDS)
    )


# ---------------------------------------------------------------------------
# group law (projective, Montgomery form)
# ---------------------------------------------------------------------------


def identity(shape, device):
    zero = fp.const_rows(0, shape, device)
    return (zero, fp.const_rows(fp.ONE, shape, device), zero)


def _muls(*pairs):
    """Independent Montgomery products as one batched multiply: at the
    small batches of a Horner ladder the op count sets the time."""
    ts = torch.broadcast_tensors(*(t for pair in pairs for t in pair))
    return fp.mont_mul(torch.stack(ts[0::2]), torch.stack(ts[1::2])).unbind(0)


def _b3(*xs):
    return _muls(*((x, fp.const_rows(fp.B3, (), x.device)) for x in xs))


def add(p, q):
    """Complete projective addition, RCB15 Algorithm 7 (a = 0), step for
    step as ``bn_pallas.bn_add_lm`` (12 M + 2 m_b3)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    add_, sub_ = fp.add, fp.sub
    t0, t1, t2, pxy, pyz, pxz = _muls(
        (x1, x2), (y1, y2), (z1, z2),
        (add_(x1, y1), add_(x2, y2)), (add_(y1, z1), add_(y2, z2)),
        (add_(x1, z1), add_(x2, z2)))
    t3 = sub_(pxy, add_(t0, t1))  # x1y2 + x2y1
    t4 = sub_(pyz, add_(t1, t2))  # y1z2 + y2z1
    xz = sub_(pxz, add_(t0, t2))  # x1z2 + x2z1
    t0 = add_(add_(t0, t0), t0)  # 3 x1x2
    t2, y3 = _b3(t2, xz)  # b3 z1z2, b3 (x1z2 + x2z1)
    z3 = add_(t1, t2)
    t1 = sub_(t1, t2)
    a, b, c, d, e, f = _muls((t3, t1), (t4, y3), (y3, t0), (t1, z3),
                             (z3, t4), (t0, t3))
    return (sub_(a, b), add_(c, d), add_(e, f))


def dbl(p):
    """Complete projective doubling, RCB15 Algorithm 9 (a = 0), step for
    step as ``bn_pallas.bn_dbl_lm`` (6 M + 2 S + 1 m_b3)."""
    x, y, z = p
    add_ = fp.add
    t0, t1, zz, xy = _muls((y, y), (y, z), (z, z), (x, y))
    z3 = add_(t0, t0)
    z3 = add_(z3, z3)
    z3 = add_(z3, z3)  # 8 y^2
    (t2,) = _b3(zz)  # b3 z^2
    y3 = add_(t0, t2)
    t0 = fp.sub(t0, add_(add_(t2, t2), t2))  # y^2 - 3 b3 z^2
    x3, z3, y3m, x3b = _muls((t2, z3), (t1, z3), (t0, y3), (t0, xy))
    return (add_(x3b, x3b), add_(x3, y3m), z3)


def neg_where(mask, p):
    """-(X, Y, Z) = (X, -Y, Z) where ``mask``."""
    x, y, z = p
    return (x, torch.where(mask[..., None], fp.neg(y), y), z)


def normalize_rows(p) -> torch.Tensor:
    """Projective Montgomery coordinates -> ``[..., 12]`` standard-form
    affine rows (x, y, 1), the identity as (1, 1, 0): one Fermat inversion
    per point, vectorized (the kernels' ``g1_store_normalized``)."""
    x, y, z = p
    zinv = fp.from_mont(fp.inv(z))  # Z^-1, standard form
    xs, ys = _muls((x, zinv), (y, zinv))  # X Z^-1, Y Z^-1, standard form
    inf = fp.is_zero(z)[..., None]
    dev = x.device
    one = fp.const_rows(1, (), dev)
    xs = torch.where(inf, one, xs)
    ys = torch.where(inf, one, ys)
    zs = torch.where(inf, fp.const_rows(0, (), dev), one).expand_as(xs)
    return join_rows((xs, ys, zs))


# ---------------------------------------------------------------------------
# host <-> device
# ---------------------------------------------------------------------------


def encode_jacobian_rows(t: torch.Tensor) -> torch.Tensor:
    """``[..., 12]`` input rows (X, Y, Z), jacobian, standard form ->
    working rows (X Z, Y, Z^3), projective, Montgomery form; an identity
    (Z = 0) becomes (0 : 1 : 0).  The plain version of the kernels' first
    launch (``bn_encode_kernel``)."""
    x, y, z = _muls(*((c, fp.const_rows(fp.R2, (), t.device))
                      for c in split_rows(t)))  # to Montgomery form
    xz, zz = _muls((x, z), (z, z))
    (z3,) = _muls((zz, z))
    xz, y, z3 = fp.canon(torch.stack([xz, y, z3])).unbind(0)
    inf = (z3 == 0).all(-1, keepdim=True)
    y = torch.where(inf, fp.const_rows(fp.ONE, (), t.device), y)
    return torch.cat([fp.pack_u64(c) for c in (xz, y, z3)], dim=-1)


def encode_points(points, device) -> torch.Tensor:
    """BNPoint list -> ``[n, 12]`` int64 input rows on ``device`` (one
    upload; the kernels convert them)."""
    from .. import native

    return from_u64_rows(native._bn_pts_to_u64(list(points)), device)


def decode_rows(rows) -> list:
    """Normalized ``[n, 12]`` rows (tensor or u64 array) -> BNPoint list;
    the identity row gives exactly ``BNPoint.identity``'s coordinates."""
    from .. import native

    if isinstance(rows, torch.Tensor):
        rows = to_rows(rows)
    return native._u64_to_bn_pts(np.ascontiguousarray(rows, dtype=np.uint64))
