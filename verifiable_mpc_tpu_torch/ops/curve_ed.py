"""Ed25519 group law on tensors (plain PyTorch) and the host <-> device
point format.

Counterpart of the Ed25519 adapter of the JAX package's
``ops/msm_pallas.py`` (``ed_add_lm``, ``ed_dbl_lm``, ``ed_to_pre``,
``ed_add_pre_lm``, ``neg_where_pre``, ``pre_identity``,
``normalize_pack``) and of its ``ops/curve_ed.py`` encode/decode.  The CUDA
kernels carry the same formulas in ``csrc/fe25519.cuh``.

Device format (shared by the kernels and the plain versions): a point is a
row of 16 int64 holding the u64 limbs of x, y, z, t (four each, little
endian) -- exactly the rows of ``native._pts_to_u64``, so uploading a point
vector is one copy.  The plain versions split a row into four
``[..., 16]`` 16-bit-limb coordinates (:func:`split_rows`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..groups.edwards import D, P, TWO_D
from . import field25519 as fe


# ---------------------------------------------------------------------------
# rows <-> coordinates
# ---------------------------------------------------------------------------


def from_reference_rows(rows: np.ndarray, device) -> torch.Tensor:
    """``[n, 16]`` u64 point rows (x, y, z, t; four u64 limbs each, the
    format of ``native._pts_to_u64`` in either package) -> the port's
    ``[n, 16]`` int64 device tensor.  Takes numpy only: carrying state over
    from the JAX package never imports it."""
    rows = np.ascontiguousarray(rows, dtype=np.uint64)
    if rows.ndim != 2 or rows.shape[1] != 16:
        raise ValueError(f"expected [n, 16] u64 point rows, got {rows.shape}")
    return torch.from_numpy(rows.view(np.int64).copy()).to(device)


def to_rows(t: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`from_reference_rows`: ``[..., 16]`` u64 rows."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def split_rows(rows: torch.Tensor):
    """``[..., 16]`` int64 rows -> 4 x ``[..., 16]`` 16-bit-limb coords."""
    return tuple(fe.from_u64(rows[..., 4 * j : 4 * j + 4]) for j in range(4))


def join_rows(coords) -> torch.Tensor:
    """4 canonical coordinates -> ``[..., 16]`` int64 rows."""
    return torch.cat([fe.to_u64(c) for c in coords], dim=-1)


def join_rows_relaxed(coords) -> torch.Tensor:
    """4 relaxed coordinates -> ``[..., 16]`` rows (values reduced below
    2^256, not necessarily canonical: the rows K1 leaves)."""
    return join_rows(tuple(fe.canon(c) for c in coords))


IDENTITY_ROW = (0,) * 4 + (1, 0, 0, 0) + (1, 0, 0, 0) + (0,) * 4
AFF_ROW = 12  # an affine precomputed-form row: y+x, y-x, 2dxy


def split_aff_rows(rows: torch.Tensor):
    """``[..., 12]`` affine precomputed-form rows (y+x, y-x, 2dxy) -> the
    precomputed form (Y+X, Y-X, 2dT, 2Z) with Z = 1, as coordinates."""
    two = fe.const_rows(2, rows.shape[:-1], rows.device)
    return tuple(fe.from_u64(rows[..., 4 * j : 4 * j + 4])
                 for j in range(3)) + (two,)


# ---------------------------------------------------------------------------
# group law (extended coordinates, a = -1)
# ---------------------------------------------------------------------------


def identity(shape, device):
    zero = fe.const_rows(0, shape, device)
    one = fe.const_rows(1, shape, device)
    return (zero, one, one, zero)


def pre_identity(shape, device):
    """The identity (0:1:1:0) in precomputed form: (1, 1, 0, 2)."""
    one = fe.const_rows(1, shape, device)
    return (one, one, fe.const_rows(0, shape, device),
            fe.const_rows(2, shape, device))


def _muls(*pairs):
    """Independent products as one batched multiply: at the small batches
    of a Horner ladder the op count, not the arithmetic, sets the time."""
    ts = torch.broadcast_tensors(*(t for pair in pairs for t in pair))
    a = torch.stack(ts[0::2])
    b = torch.stack(ts[1::2])
    return fe.mul(a, b).unbind(0)


def _finish(e, f, g, h):
    return tuple(_muls((e, f), (g, h), (f, g), (e, h)))


def add(p, q):
    """Complete unified addition add-2008-hwcd-3 (ed_add_lm)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    two_d = fe.const_rows(TWO_D, (), t1.device)
    a, b, t, d = _muls((fe.sub(y1, x1), fe.sub(y2, x2)),
                       (fe.add(y1, x1), fe.add(y2, x2)),
                       (t1, two_d), (fe.add(z1, z1), z2))
    c = fe.mul(t, t2)
    return _finish(fe.sub(b, a), fe.sub(d, c), fe.add(d, c), fe.add(b, a))


def dbl(p):
    """Dedicated doubling dbl-2008-hwcd, a = -1 (ed_dbl_lm)."""
    x1, y1, z1, _ = p
    s = fe.add(x1, y1)
    a, b, sz, ss = _muls((x1, x1), (y1, y1), (z1, z1), (s, s))
    c = fe.add(sz, sz)
    e = fe.sub(fe.sub(ss, a), b)
    g = fe.sub(b, a)
    f = fe.sub(g, c)
    h = fe.neg(fe.add(a, b))
    return _finish(e, f, g, h)


def to_pre(p):
    """Extended -> precomputed form (Y+X, Y-X, 2dT, 2Z) (ed_to_pre)."""
    x, y, z, t = p
    two_d = fe.const_rows(TWO_D, (), t.device)
    return (fe.add(y, x), fe.sub(y, x), fe.mul(t, two_d), fe.add(z, z))


def pre_to_ext(q_pre):
    """Precomputed form -> extended (ge_pre_to_ext): (Y+X, Y-X, 2dT, 2Z)
    gives (2X : 2Y : 2Z : 2T), the same point, with 2T = 2dT / d."""
    ypx, ymx, t2d, z2 = q_pre
    inv_d = fe.const_rows(pow(D, -1, P), (), t2d.device)
    return (fe.sub(ypx, ymx), fe.add(ypx, ymx), z2, fe.mul(t2d, inv_d))


def add_pre(p, q_pre):
    """Mixed addition extended + precomputed (ed_add_pre_lm, 8 muls)."""
    x1, y1, z1, t1 = p
    ypx, ymx, t2d, z2 = q_pre
    a, b, c, d = _muls((fe.sub(y1, x1), ymx), (fe.add(y1, x1), ypx),
                       (t1, t2d), (z1, z2))
    return _finish(fe.sub(b, a), fe.sub(d, c), fe.add(d, c), fe.add(b, a))


def neg_where_pre(mask, q_pre):
    """-(ypx, ymx, t2d, z2) = (ymx, ypx, -t2d, z2) where ``mask``."""
    ypx, ymx, t2d, z2 = q_pre
    m = mask[..., None]
    return (torch.where(m, ymx, ypx), torch.where(m, ypx, ymx),
            torch.where(m, fe.neg(t2d), t2d), z2)


def normalize_rows(p) -> torch.Tensor:
    """Extended coordinates -> canonical affine rows (x, y, 1, x*y)
    (normalize_pack): one Fermat inversion per point, vectorized."""
    x, y, z, _ = p
    zinv = fe.inv(z)
    xz, yz = _muls((x, zinv), (y, zinv))
    xc, yc = fe.canon(xz), fe.canon(yz)
    tc = fe.canon(fe.mul(xc, yc))
    one = fe.const_rows(1, xc.shape[:-1], xc.device)
    return join_rows((xc, yc, one.contiguous(), tc))


def pre_rows(points) -> np.ndarray:
    """Host precomputed-form rows (Y+X, Y-X, 2dT, 2Z) of EdwardsPoints, in
    the point-row layout (K15's table, ``msm_cuda.bexp_table``)."""
    from ..groups.edwards import P

    vals = []
    for pt in points:
        vals += [(pt.y + pt.x) % P, (pt.y - pt.x) % P, TWO_D * pt.t % P,
                 2 * pt.z % P]
    raw = b"".join(v.to_bytes(32, "little") for v in vals)
    return np.frombuffer(raw, dtype=np.uint64).reshape(len(points), 16).copy()


def affine_pre_rows(points) -> np.ndarray:
    """Host affine precomputed-form rows (y+x, y-x, 2dxy) of normalized
    EdwardsPoints (z = 1): ``[n, 12]`` u64 (the comb table of
    ``msm_cuda.comb_table``)."""
    vals = []
    for pt in points:
        if pt.z % P != 1:
            raise ValueError("affine rows need normalized points")
        vals += [(pt.y + pt.x) % P, (pt.y - pt.x) % P, TWO_D * pt.x * pt.y % P]
    raw = b"".join(v.to_bytes(32, "little") for v in vals)
    return np.frombuffer(raw, dtype=np.uint64).reshape(len(points),
                                                       AFF_ROW).copy()


# ---------------------------------------------------------------------------
# host <-> device
# ---------------------------------------------------------------------------


def encode_points(points, device) -> torch.Tensor:
    """EdwardsPoint list -> ``[n, 16]`` int64 device rows."""
    from .. import native

    return from_reference_rows(native._pts_to_u64(list(points)), device)


def decode_rows(rows) -> list:
    """``[n, 16]`` rows (tensor or u64 array) -> EdwardsPoint list."""
    from .. import native

    if isinstance(rows, torch.Tensor):
        rows = to_rows(rows)
    return native._u64_to_pts(np.ascontiguousarray(rows, dtype=np.uint64))
