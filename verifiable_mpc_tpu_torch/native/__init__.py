"""Native host tier: build (g++) and load the C++ Ed25519 library via ctypes.

The reference is pure Python (SURVEY.md preamble); this component is the
framework's own addition: a speed-of-light host path for the group
primitives, used by the dispatch layer for host-side MSM/fold/batch-exp
(e.g. when proving on CPU-only machines, or for the small per-round
commitments where kernel launch overhead dominates).

Build happens on demand with the system toolchain, one g++ per source in
parallel under a file lock, and is cached next to the sources; everything
degrades gracefully to the pure-Python path if no compiler is available.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess

import numpy as np

from .._build import build as _locked_build
from .._build import stale as _stale

_HERE = os.path.dirname(__file__)
_SRCS = [
    os.path.join(_HERE, "ed25519.cc"),
    os.path.join(_HERE, "ed25519_ifma.cc"),
    os.path.join(_HERE, "bn256.cc"),
    os.path.join(_HERE, "ntt.cc"),
    os.path.join(_HERE, "modvec.cc"),
    os.path.join(_HERE, "qr.cc"),
]
_SO = os.path.join(_HERE, "_vmpc_native.so")

_lib = None
_tried = False

# Host scalar tier (vector mod-p ops, resident pivot engine): explicit
# opt-in so the pure-python mode stays pure.  enable_native()/enable_gpu()
# turn it on; full dispatch registration additionally sets REGISTERED
# (the resident engine requires it for proof-coordinate parity with the
# generic loop's MSM backend).
SCALAR_TIER = False
REGISTERED = False


def enable_scalar_tier():
    global SCALAR_TIER
    SCALAR_TIER = available()
    return SCALAR_TIER


def _build() -> bool:
    """The reference's g++ flags, one g++ per source in parallel, under
    the package's locked build (``_build.build``)."""
    try:
        _locked_build(
            _SO, _SRCS, _SRCS,
            lambda src, obj: ["g++", "-O3", "-march=native", "-fopenmp",
                              "-fPIC", "-c", "-o", obj, src],
            lambda objs, out: ["g++", "-shared", "-fopenmp", "-o", out,
                               *objs],
            timeout=300,
        )
    except (OSError, subprocess.SubprocessError, RuntimeError):
        return False
    return True


def load():
    """Return the ctypes library handle, building if needed; None if
    unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if _stale(_SO, _SRCS) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.vmpc_ed_msm.argtypes = [u64p, u64p, ctypes.c_uint64, u64p]
    lib.vmpc_ed_batch_exp.argtypes = [u64p, u64p, ctypes.c_uint64, u64p]
    lib.vmpc_ed_fold.argtypes = [u64p, u64p, u64p, ctypes.c_uint64, u64p]
    lib.vmpc_ed_add.argtypes = [u64p, u64p, u64p]
    lib.vmpc_ed_scalar_mul.argtypes = [u64p, u64p, u64p]
    lib.vmpc_bn_msm.argtypes = [u64p, u64p, ctypes.c_uint64, u64p]
    lib.vmpc_bn_batch_exp.argtypes = [u64p, u64p, ctypes.c_uint64, u64p]
    lib.vmpc_bn_scalar_mul.argtypes = [u64p, u64p, u64p]
    lib.vmpc_bn2_msm.argtypes = [u64p, u64p, ctypes.c_uint64, u64p]
    lib.vmpc_bn2_batch_exp.argtypes = [u64p, u64p, ctypes.c_uint64, u64p]
    lib.vmpc_bn_comb_table.argtypes = [u64p, ctypes.c_int, u64p]
    lib.vmpc_bn2_comb_table.argtypes = [u64p, ctypes.c_int, u64p]
    lib.vmpc_ntt_poly_mul.argtypes = [
        u64p,
        ctypes.c_uint64,
        u64p,
        ctypes.c_uint64,
        u64p,
    ]
    lib.vmpc_modvec_dot.argtypes = [u64p, u64p, u64p, ctypes.c_uint64, u64p]
    lib.vmpc_modvec_axpy.argtypes = [
        u64p, u64p, u64p, u64p, ctypes.c_uint64, u64p,
    ]
    lib.vmpc_modvec_scale.argtypes = [u64p, u64p, u64p, ctypes.c_uint64, u64p]
    lib.vmpc_modvec_weighted_sum.argtypes = [
        u64p, u64p, u64p, ctypes.c_uint64, ctypes.c_uint64, u64p,
    ]
    lib.vmpc_modvec_hadamard.argtypes = [
        u64p, u64p, u64p, ctypes.c_uint64, u64p,
    ]
    lib.vmpc_modvec_mul_triples.argtypes = [
        u64p, ctypes.c_uint64, ctypes.c_uint64,
        u64p, u64p, u64p, u64p,
        u64p, u64p, u64p, u64p,
        u64p, u64p, u64p,
    ]
    lib.vmpc_lagrange_consecutive.argtypes = [
        u64p, ctypes.c_uint64, ctypes.c_uint64, u64p, u64p,
    ]
    lib.vmpc_modvec_csr_dot.argtypes = [
        u64p, ctypes.c_uint64, u64p, u64p, u64p, u64p, u64p,
    ]
    lib.vmpc_modvec_powers.argtypes = [u64p, u64p, ctypes.c_uint64, u64p]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.vmpc_ed_batch_normalize.argtypes = [u64p, ctypes.c_uint64]
    lib.vmpc_ed_hash_encode.argtypes = [u64p, ctypes.c_uint64, u8p, u64p]
    lib.vmpc_ed_rows_fill_t.argtypes = [u64p, ctypes.c_uint64]
    lib.vmpc_recode_signed4.argtypes = [
        u64p, ctypes.c_uint64, u64p, u64p,
        ctypes.POINTER(ctypes.c_int8),
    ]
    lib.vmpc_recode_signed4.restype = ctypes.c_int
    lib.vmpc_recode_signed4_packed.argtypes = [
        u64p, ctypes.c_uint64, u64p, u64p, u8p,
    ]
    lib.vmpc_recode_signed4_packed.restype = ctypes.c_longlong
    lib.vmpc_qr_multiexp.argtypes = [u64p, u64p, u64p, ctypes.c_uint64, u64p]
    lib.vmpc_qr_batch_exp.argtypes = [u64p, u64p, u64p, ctypes.c_uint64, u64p]
    lib.vmpc_qr_fold.argtypes = [
        u64p, u64p, u64p, u64p, ctypes.c_uint64, u64p,
    ]
    lib.vmpc_modvec_hash_encode_signed.argtypes = [
        u64p, u64p, ctypes.c_uint64, u8p, u64p,
    ]
    lib.vmpc_shift_evaluations.argtypes = [
        u64p, u64p, ctypes.c_uint64, ctypes.c_longlong, ctypes.c_uint64,
        u64p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------


def _pts_to_u64(points) -> np.ndarray:
    fs = fastser()
    if fs is not None and isinstance(points, list) and points:
        raw = fs.ed_pts_to_u64(points, type(points[0]))
        if raw is not None:
            return np.frombuffer(raw, dtype=np.uint64).reshape(
                len(points), 16
            )
    n = len(points)
    out = np.empty((n, 16), dtype=np.uint64)
    mask = (1 << 64) - 1
    for i, p in enumerate(points):
        for j, c in enumerate((p.x, p.y, p.z, p.t)):
            out[i, 4 * j + 0] = c & mask
            out[i, 4 * j + 1] = (c >> 64) & mask
            out[i, 4 * j + 2] = (c >> 128) & mask
            out[i, 4 * j + 3] = (c >> 192) & mask
    return out


def _u64_to_pts(arr) -> list:
    from ..groups.edwards import EdwardsPoint

    fs = fastser()
    if fs is not None:
        return fs.u64_to_ed_pts(
            np.ascontiguousarray(arr, dtype=np.uint64), EdwardsPoint
        )
    out = []
    for row in arr:
        coords = []
        for j in range(4):
            v = 0
            for k in range(3, -1, -1):
                v = (v << 64) | int(row[4 * j + k])
            coords.append(v)
        out.append(EdwardsPoint(*coords))
    return out


def _scalars_to_u64(scalars, order) -> np.ndarray:
    fs = fastser()
    if fs is not None and isinstance(scalars, (list, tuple)) and scalars:
        ftype = None
        first = scalars[0]
        if type(first) is not int:
            from ..fields import FiniteFieldElement

            # int(field elem) is its signed representative; (v - p) % order
            # == v when the field modulus equals the order, which is the
            # only case the protocols feed here — verify and fall through
            # otherwise
            if (
                isinstance(first, FiniteFieldElement)
                and type(first).modulus == order
            ):
                ftype = type(first)
        raw = fs.vals_to_u64x4(scalars, ftype, order)
        if raw is not None:
            return np.frombuffer(raw, dtype=np.uint64).reshape(
                len(scalars), 4
            )
    n = len(scalars)
    out = np.empty((n, 4), dtype=np.uint64)
    mask = (1 << 64) - 1
    for i, s in enumerate(scalars):
        s = int(s) % order
        out[i, 0] = s & mask
        out[i, 1] = (s >> 64) & mask
        out[i, 2] = (s >> 128) & mask
        out[i, 3] = (s >> 192) & mask
    return out


def _u64p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


# ---------------------------------------------------------------------------
# high-level ops
# ---------------------------------------------------------------------------


def ed_msm(points, scalars):
    from ..groups.edwards import ELL

    lib = load()
    pts = _pts_to_u64(points)
    sc = _scalars_to_u64(scalars, ELL)
    out = np.zeros(16, dtype=np.uint64)
    lib.vmpc_ed_msm(_u64p(pts), _u64p(sc), len(points), _u64p(out))
    return _u64_to_pts(out[None])[0]


def ed_batch_exp(base, exponents):
    from ..groups.edwards import ELL

    lib = load()
    b = _pts_to_u64([base])
    ex = _scalars_to_u64(exponents, ELL)
    out = np.zeros((len(exponents), 16), dtype=np.uint64)
    lib.vmpc_ed_batch_exp(_u64p(b), _u64p(ex), len(exponents), _u64p(out))
    return _u64_to_pts(out)


def ed_fold(g_l, g_r, c):
    from ..groups.edwards import ELL

    lib = load()
    gl = _pts_to_u64(g_l)
    gr = _pts_to_u64(g_r)
    cc = _scalars_to_u64([c], ELL)
    out = np.zeros((len(g_l), 16), dtype=np.uint64)
    lib.vmpc_ed_fold(_u64p(gl), _u64p(gr), _u64p(cc), len(g_l), _u64p(out))
    return _u64_to_pts(out)


# ---------------------------------------------------------------------------
# BN256 (G1 + twist)
# ---------------------------------------------------------------------------


def _int_to_u64x4(v: int, out, off):
    mask = (1 << 64) - 1
    out[off + 0] = v & mask
    out[off + 1] = (v >> 64) & mask
    out[off + 2] = (v >> 128) & mask
    out[off + 3] = (v >> 192) & mask


def _u64x4_to_int(row, off) -> int:
    v = 0
    for k in range(3, -1, -1):
        v = (v << 64) | int(row[off + k])
    return v


def _bn_pts_to_u64(points) -> np.ndarray:
    fs = fastser()
    if fs is not None and isinstance(points, list) and points:
        raw = fs.bn_pts_to_u64(points, type(points[0]))
        if raw is not None:
            return np.frombuffer(raw, dtype=np.uint64).reshape(
                len(points), 12
            )
    out = np.empty((len(points), 12), dtype=np.uint64)
    for i, p in enumerate(points):
        for j, c in enumerate((p.x, p.y, p.z)):
            _int_to_u64x4(c.value, out[i], 4 * j)
    return out


def _u64_to_bn_pts(arr) -> list:
    from ..groups.bn256 import BNPoint, GFp

    fs = fastser()
    if fs is not None:
        return fs.u64_to_bn_pts(
            np.ascontiguousarray(arr, dtype=np.uint64), BNPoint, GFp
        )
    out = []
    for row in arr:
        coords = [_u64x4_to_int(row, 4 * j) for j in range(3)]
        out.append(BNPoint(*coords, check=False))
    return out


def _bn2_pts_to_u64(points) -> np.ndarray:
    fs = fastser()
    if fs is not None and isinstance(points, list) and points:
        raw = fs.bn2_pts_to_u64(points, type(points[0]))
        if raw is not None:
            return np.frombuffer(raw, dtype=np.uint64).reshape(
                len(points), 24
            )
    out = np.empty((len(points), 24), dtype=np.uint64)
    for i, p in enumerate(points):
        for j, c in enumerate((p.x, p.y, p.z)):
            _int_to_u64x4(c.c0, out[i], 8 * j)
            _int_to_u64x4(c.c1, out[i], 8 * j + 4)
    return out


def _u64_to_bn2_pts(arr) -> list:
    from ..groups.bn256 import BNTwistPoint, GFp2

    fs = fastser()
    if fs is not None:
        return fs.u64_to_bn2_pts(
            np.ascontiguousarray(arr, dtype=np.uint64), BNTwistPoint, GFp2
        )
    out = []
    for row in arr:
        coords = [
            GFp2(_u64x4_to_int(row, 8 * j), _u64x4_to_int(row, 8 * j + 4))
            for j in range(3)
        ]
        out.append(BNTwistPoint(*coords, check=False))
    return out


def bn_msm(points, scalars):
    from ..groups.bn256 import ORDER

    lib = load()
    pts = _bn_pts_to_u64(points)
    sc = _scalars_to_u64(scalars, ORDER)
    out = np.zeros(12, dtype=np.uint64)
    lib.vmpc_bn_msm(_u64p(pts), _u64p(sc), len(points), _u64p(out))
    return _u64_to_bn_pts(out[None])[0]


def bn_batch_exp(base, exponents):
    from ..groups.bn256 import ORDER

    lib = load()
    b = _bn_pts_to_u64([base])
    ex = _scalars_to_u64(exponents, ORDER)
    out = np.zeros((len(exponents), 12), dtype=np.uint64)
    lib.vmpc_bn_batch_exp(_u64p(b), _u64p(ex), len(exponents), _u64p(out))
    return _u64_to_bn_pts(out)


def bn2_msm(points, scalars):
    from ..groups.bn256 import ORDER

    lib = load()
    pts = _bn2_pts_to_u64(points)
    sc = _scalars_to_u64(scalars, ORDER)
    out = np.zeros(24, dtype=np.uint64)
    lib.vmpc_bn2_msm(_u64p(pts), _u64p(sc), len(points), _u64p(out))
    return _u64_to_bn2_pts(out[None])[0]


def bn2_batch_exp(base, exponents):
    from ..groups.bn256 import ORDER

    lib = load()
    b = _bn2_pts_to_u64([base])
    ex = _scalars_to_u64(exponents, ORDER)
    out = np.zeros((len(exponents), 24), dtype=np.uint64)
    lib.vmpc_bn2_batch_exp(_u64p(b), _u64p(ex), len(exponents), _u64p(out))
    return _u64_to_bn2_pts(out)


def bn_comb_table(base, nw: int) -> np.ndarray:
    """[nw*9, 12] rows of the G1 fixed-base comb table, most significant
    window first: row w*9 + m = m * 16^(nw-1-w) * base, affine (z = 1),
    the identity all zero."""
    lib = load()
    b = np.ascontiguousarray(_bn_pts_to_u64([base]))
    out = np.zeros((nw * 9, 12), dtype=np.uint64)
    lib.vmpc_bn_comb_table(_u64p(b), nw, _u64p(out))
    return out


def bn2_comb_table(base, nw: int) -> np.ndarray:
    """[nw*9, 24] rows of the twist's fixed-base comb table, as
    :func:`bn_comb_table`."""
    lib = load()
    b = np.ascontiguousarray(_bn2_pts_to_u64([base]))
    out = np.zeros((nw * 9, 24), dtype=np.uint64)
    lib.vmpc_bn2_comb_table(_u64p(b), nw, _u64p(out))
    return out


# ---------------------------------------------------------------------------
# vector modular arithmetic (Barrett, runtime <=256-bit modulus)
# ---------------------------------------------------------------------------

_MODVEC_CTX: dict = {}


def _modvec_ctx(p: int):
    """p[4] | mu[6] | r512[4] context buffer for modulus p (cached)."""
    ctx = _MODVEC_CTX.get(p)
    if ctx is None:
        assert (1 << 192) <= p < (1 << 256), "modulus out of modvec range"
        mu = (1 << 512) // p
        r512 = (1 << 512) % p
        buf = np.empty(14, dtype=np.uint64)
        _int_to_u64x4(p, buf, 0)
        mask = (1 << 64) - 1
        for j in range(6):
            buf[4 + j] = (mu >> (64 * j)) & mask
        _int_to_u64x4(r512, buf, 10)
        ctx = _MODVEC_CTX[p] = buf
    return ctx


def _ints_to_u64x4(xs, p) -> np.ndarray:
    fs = fastser()
    if fs is not None and isinstance(xs, (list, tuple)):
        raw = fs.vals_to_u64x4(xs, None, p)
        if raw is not None:
            return np.frombuffer(raw, dtype=np.uint64).reshape(len(xs), 4)
    n = len(xs)
    buf = bytearray(n * 32)
    for i, x in enumerate(xs):
        v = x if 0 <= x < p else x % p
        buf[i * 32 : (i + 1) * 32] = v.to_bytes(32, "little")
    return np.frombuffer(bytes(buf), dtype=np.uint64).reshape(n, 4)


def _u64x4_to_ints(arr) -> list:
    fs = fastser()
    if fs is not None:
        return fs.u64x4_to_ints(np.ascontiguousarray(arr, dtype=np.uint64))
    raw = np.ascontiguousarray(arr).tobytes()
    return [
        int.from_bytes(raw[i * 32 : (i + 1) * 32], "little")
        for i in range(len(raw) // 32)
    ]


def vals_to_arr(xs, ftype, p: int, int_mode: int = 1):
    """[n,4] u64 rows for a list of ints / exact-ftype field elements in ONE
    C pass, or None if an element is foreign (caller falls back).
    int_mode: 0 = reject plain ints, 1 = allow, 2 = allow only int 0."""
    fs = fastser()
    if fs is None or type(xs) not in (list, tuple):
        return None
    raw = fs.vals_to_u64x4(xs, ftype, p, int_mode)
    if raw is None:
        return None
    return np.frombuffer(raw, dtype=np.uint64).reshape(len(xs), 4)


def arr_to_vals(arr, ftype) -> list:
    """Reduced [n,4] u64 rows -> list of ftype field elements (C
    construction, skips __init__; rows must already be in [0, modulus))."""
    fs = fastser()
    raw = np.ascontiguousarray(arr, dtype=np.uint64)
    if fs is not None:
        return fs.u64x4_to_vals(raw, ftype)
    return [ftype(v) for v in _u64x4_to_ints(raw)]


def modvec_mul_triples(p: int, n_in: int, m: int, lptr, lidx, lcoef, lconst,
                       rptr, ridx, rcoef, rconst, vals):
    """Run the sequential mul-gate triples pass in C.

    ``vals`` is an [n_in + m, 4] u64 array with the input rows prefilled;
    gamma rows are written in place.  Returns (alpha, beta) arrays [m,4]."""
    lib = load()
    alpha = np.empty((m, 4), dtype=np.uint64)
    beta = np.empty((m, 4), dtype=np.uint64)
    lib.vmpc_modvec_mul_triples(
        _u64p(_modvec_ctx(p)), n_in, m,
        _u64p(lptr), _u64p(lidx), _u64p(lcoef), _u64p(lconst),
        _u64p(rptr), _u64p(ridx), _u64p(rcoef), _u64p(rconst),
        _u64p(vals), _u64p(alpha), _u64p(beta),
    )
    return alpha, beta


def lagrange_consecutive_arr(p: int, a: int, n: int, c: int):
    """Lagrange basis row over consecutive nodes a..a+n-1 at point c as a
    reduced [n,4] u64 array."""
    lib = load()
    c4 = _ints_to_u64x4([c % p], p)
    out = np.empty((n, 4), dtype=np.uint64)
    lib.vmpc_lagrange_consecutive(
        _u64p(_modvec_ctx(p)), a, n, _u64p(c4), _u64p(out)
    )
    return out


def lagrange_consecutive(p: int, a: int, n: int, c: int):
    """Same row as [n] reduced Python ints, identical to the pure-Python
    closed form (recombine._lagrange_row_consecutive)."""
    return _u64x4_to_ints(lagrange_consecutive_arr(p, a, n, c))


def modvec_csr_dot(p: int, ptr, idx, coef, vec):
    """out[i] = sum_e coef[e] * vec[idx[e]] mod p over CSR rows."""
    lib = load()
    nrows = len(ptr) - 1
    out = np.empty((nrows, 4), dtype=np.uint64)
    lib.vmpc_modvec_csr_dot(
        _u64p(_modvec_ctx(p)), nrows,
        _u64p(ptr), _u64p(idx), _u64p(coef), _u64p(vec), _u64p(out),
    )
    return out


def modvec_powers(p: int, base: int, count: int):
    """[base^0, ..., base^(count-1)] mod p as a [count,4] u64 array."""
    lib = load()
    b4 = _ints_to_u64x4([base % p], p)
    out = np.empty((count, 4), dtype=np.uint64)
    lib.vmpc_modvec_powers(_u64p(_modvec_ctx(p)), _u64p(b4), count, _u64p(out))
    return out


def mod_dot(a, b, p: int) -> int:
    """sum(a_i * b_i) mod p over int lists."""
    lib = load()
    n = len(a)
    if n == 0:
        return 0
    aa = _ints_to_u64x4(a, p)
    bb = _ints_to_u64x4(b, p)
    out = np.zeros(4, dtype=np.uint64)
    lib.vmpc_modvec_dot(_u64p(_modvec_ctx(p)), _u64p(aa), _u64p(bb), n,
                        _u64p(out))
    return _u64x4_to_ints(out)[0]


def mod_axpy(c: int, x, y, p: int) -> list:
    """[(c*x_i + y_i) mod p]."""
    lib = load()
    n = len(x)
    cc = _ints_to_u64x4([c], p)
    xx = _ints_to_u64x4(x, p)
    yy = _ints_to_u64x4(y, p)
    out = np.zeros((n, 4), dtype=np.uint64)
    lib.vmpc_modvec_axpy(_u64p(_modvec_ctx(p)), _u64p(cc), _u64p(xx),
                         _u64p(yy), n, _u64p(out))
    return _u64x4_to_ints(out)


def mod_scale(c: int, x, p: int) -> list:
    """[c*x_i mod p]."""
    lib = load()
    n = len(x)
    cc = _ints_to_u64x4([c], p)
    xx = _ints_to_u64x4(x, p)
    out = np.zeros((n, 4), dtype=np.uint64)
    lib.vmpc_modvec_scale(_u64p(_modvec_ctx(p)), _u64p(cc), _u64p(xx), n,
                          _u64p(out))
    return _u64x4_to_ints(out)


def mod_weighted_sum(w, rows, p: int) -> list:
    """[sum_i w_i * rows[i][j] mod p for j] — the nullity combine."""
    lib = load()
    s = len(rows)
    n = len(rows[0])
    ww = _ints_to_u64x4(w, p)
    flat = []
    for r in rows:
        flat.extend(r)
    rr = _ints_to_u64x4(flat, p)
    out = np.zeros((n, 4), dtype=np.uint64)
    lib.vmpc_modvec_weighted_sum(_u64p(_modvec_ctx(p)), _u64p(ww), _u64p(rr),
                                 s, n, _u64p(out))
    return _u64x4_to_ints(out)


# ---------------------------------------------------------------------------
# array-level primitives for the resident protocol engine (no Python-int
# conversion: inputs/outputs stay u64 limb arrays across protocol rounds)
# ---------------------------------------------------------------------------

def _u8p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def ed_msm_arr(pts: np.ndarray, scalars: np.ndarray) -> np.ndarray:
    """MSM over [n,16] plain-coord points and [n,4] scalars -> [16] point."""
    lib = load()
    out = np.zeros(16, dtype=np.uint64)
    lib.vmpc_ed_msm(_u64p(pts), _u64p(scalars), len(pts), _u64p(out))
    return out


def ed_fold_arr(gl: np.ndarray, gr: np.ndarray, c4: np.ndarray) -> np.ndarray:
    """[gl_i^c * gr_i] over [n,16] arrays; returns unnormalized [n,16]."""
    lib = load()
    n = len(gl)
    out = np.empty((n, 16), dtype=np.uint64)
    lib.vmpc_ed_fold(_u64p(gl), _u64p(gr), _u64p(c4), n, _u64p(out))
    return out


def ed_batch_normalize_arr(pts: np.ndarray) -> np.ndarray:
    """In-place affine normalization of [n,16] plain-coord points."""
    lib = load()
    lib.vmpc_ed_batch_normalize(_u64p(pts), len(pts))
    return pts


def ed_hash_encode_arr(pts: np.ndarray) -> bytes:
    """Canonical hash encoding (T_ED + 4 signed ints each) of [n,16]
    normalized points — byte-identical to serialization._hash_list_fast
    over the equivalent EdwardsPoint list."""
    lib = load()
    n = len(pts)
    buf = np.empty(n * 149, dtype=np.uint8)
    outlen = np.zeros(1, dtype=np.uint64)
    lib.vmpc_ed_hash_encode(_u64p(pts), n, _u8p(buf), _u64p(outlen))
    return buf[: int(outlen[0])].tobytes()


def ed_rows_fill_t_arr(rows: np.ndarray) -> np.ndarray:
    """In-place: [n,16] rows with canonical x, y set -> z = 1 and
    t = x*y mod p (canonical) filled.  The extended-row completion for
    the GPU engine's two-coordinate canonical downloads."""
    lib = load()
    lib.vmpc_ed_rows_fill_t(_u64p(rows), len(rows))
    return rows


@functools.lru_cache(maxsize=None)
def _order_half_limbs(order: int):
    return (
        _ints_to_u64x4([order], 1 << 256),
        _ints_to_u64x4([order // 2], 1 << 256),
    )


def recode_signed4_arr(scalars: np.ndarray, order: int) -> np.ndarray:
    """[n,4] u64 canonical residues -> [64,n] int8 signed digits (MSB-first),
    byte-identical to ops/msm_cuda.digits_signed_from_u64x4."""
    lib = load()
    n = len(scalars)
    o4, h4 = _order_half_limbs(order)
    out = np.empty((64, n), dtype=np.int8)
    rc = lib.vmpc_recode_signed4(
        _u64p(np.ascontiguousarray(scalars, np.uint64)), n, _u64p(o4),
        _u64p(h4), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
    )
    assert rc == 0, "scalar overflow in signed recoding"
    return out


def recode_signed4_packed_arr(scalars: np.ndarray, order: int):
    """[n,4] u64 canonical residues -> ([32,n] u8 offset-7 nibble-packed
    MSB-first digit rows, windows_needed).  One C pass replacing recode +
    ops/msm_cuda.pack_digits."""
    lib = load()
    n = len(scalars)
    o4, h4 = _order_half_limbs(order)
    out = np.empty((32, n), dtype=np.uint8)
    wn = lib.vmpc_recode_signed4_packed(
        _u64p(np.ascontiguousarray(scalars, np.uint64)), n, _u64p(o4),
        _u64p(h4), _u8p(out),
    )
    assert wn > 0, "scalar overflow in signed recoding"
    return out, int(wn)


def mod_hash_encode_signed_arr(vals: np.ndarray, p: int) -> bytes:
    """Canonical hash encoding (T_INT, signed representative) of [n,4]
    reduced field values — byte-identical to hashing the gf-element list."""
    lib = load()
    n = len(vals)
    buf = np.empty(n * 38, dtype=np.uint8)
    outlen = np.zeros(1, dtype=np.uint64)
    lib.vmpc_modvec_hash_encode_signed(
        _u64p(_modvec_ctx(p)), _u64p(vals), n, _u8p(buf), _u64p(outlen)
    )
    return buf[: int(outlen[0])].tobytes()


def mod_dot_arr(a: np.ndarray, b: np.ndarray, p: int) -> int:
    lib = load()
    out = np.zeros(4, dtype=np.uint64)
    lib.vmpc_modvec_dot(_u64p(_modvec_ctx(p)), _u64p(a), _u64p(b), len(a),
                        _u64p(out))
    return _u64x4_to_ints(out)[0]


def mod_axpy_arr(c: int, x: np.ndarray, y: np.ndarray, p: int) -> np.ndarray:
    lib = load()
    n = len(x)
    cc = _ints_to_u64x4([c], p)
    out = np.empty((n, 4), dtype=np.uint64)
    lib.vmpc_modvec_axpy(_u64p(_modvec_ctx(p)), _u64p(cc), _u64p(x), _u64p(y),
                         n, _u64p(out))
    return out


def mod_scale_arr(c: int, x: np.ndarray, p: int) -> np.ndarray:
    lib = load()
    n = len(x)
    cc = _ints_to_u64x4([c], p)
    out = np.empty((n, 4), dtype=np.uint64)
    lib.vmpc_modvec_scale(_u64p(_modvec_ctx(p)), _u64p(cc), _u64p(x), n,
                          _u64p(out))
    return out


def mod_weighted_sum_arr(w: np.ndarray, rows: np.ndarray, s: int, n: int,
                         p: int) -> np.ndarray:
    lib = load()
    out = np.empty((n, 4), dtype=np.uint64)
    lib.vmpc_modvec_weighted_sum(_u64p(_modvec_ctx(p)), _u64p(w), _u64p(rows),
                                 s, n, _u64p(out))
    return out


def mod_hadamard_arr(a: np.ndarray, b: np.ndarray, p: int) -> np.ndarray:
    lib = load()
    n = len(a)
    out = np.empty((n, 4), dtype=np.uint64)
    lib.vmpc_modvec_hadamard(_u64p(_modvec_ctx(p)), _u64p(a), _u64p(b), n,
                             _u64p(out))
    return out


def shift_evaluations_arr(vals: np.ndarray, s: int, count: int,
                          p: int) -> np.ndarray:
    """[f(base+s+i)]_{i<count} from consecutive samples (fastpoly
    shift-of-evaluations, fully in C: factorials, batch inverses, CRT-NTT
    convolution, W ladder)."""
    lib = load()
    out = np.empty((count, 4), dtype=np.uint64)
    lib.vmpc_shift_evaluations(
        _u64p(_modvec_ctx(p)), _u64p(np.ascontiguousarray(vals)),
        len(vals), s, count, _u64p(out)
    )
    return out


def shift_evaluations_ints(vals, s: int, count: int, p: int) -> list:
    return _u64x4_to_ints(
        shift_evaluations_arr(_ints_to_u64x4(vals, p), s, count, p)
    )


def mod_hadamard(a, b, p: int) -> list:
    """[a_i * b_i mod p]."""
    lib = load()
    n = len(a)
    aa = _ints_to_u64x4(a, p)
    bb = _ints_to_u64x4(b, p)
    out = np.zeros((n, 4), dtype=np.uint64)
    lib.vmpc_modvec_hadamard(_u64p(_modvec_ctx(p)), _u64p(aa), _u64p(bb), n,
                             _u64p(out))
    return _u64x4_to_ints(out)


# ---------------------------------------------------------------------------
# exact integer polynomial products (9-prime CRT NTT)
# ---------------------------------------------------------------------------

NTT_LIMBS = 9  # 9 x u64 = 576-bit transport; values must stay < ~2^558
NTT_MAX_COEFF_BITS = 556


def _ints_to_u64x9(xs) -> np.ndarray:
    n = len(xs)
    buf = bytearray(n * 72)
    for i, x in enumerate(xs):
        buf[i * 72 : (i + 1) * 72] = int(x).to_bytes(72, "little")
    return np.frombuffer(bytes(buf), dtype=np.uint64).reshape(n, 9).copy()


def _u64x9_to_ints(arr) -> list:
    raw = np.ascontiguousarray(arr).tobytes()
    return [
        int.from_bytes(raw[i * 72 : (i + 1) * 72], "little")
        for i in range(arr.shape[0])
    ]


def ntt_poly_mul_ints(a, b) -> list:
    """Exact product of integer polynomials (coefficients < ~2^278 each so
    the CRT bound holds for the protocol fields)."""
    lib = load()
    na, nb = len(a), len(b)
    assert (
        min(na, nb) * max(max(a, default=1), 1) * max(max(b, default=1), 1)
    ).bit_length() <= NTT_MAX_COEFF_BITS, (
        "coefficients too large for exact CRT recovery"
    )
    arr_a = _ints_to_u64x9(a)
    arr_b = _ints_to_u64x9(b)
    out = np.zeros((na + nb - 1, 9), dtype=np.uint64)
    lib.vmpc_ntt_poly_mul(_u64p(arr_a), na, _u64p(arr_b), nb, _u64p(out))
    return _u64x9_to_ints(out)


# ---------------------------------------------------------------------------
# QR (quadratic residues mod a 1024-bit safe prime): Pippenger multiexp,
# fixed-base comb and the protocol-4 fold in 16-limb Montgomery C
# (native/qr.cc).  The reference runs these as Python pow() loops.
# ---------------------------------------------------------------------------


def _ints_to_u64x16(vals, mod: int) -> np.ndarray:
    n = len(vals)
    buf = bytearray(n * 128)
    for i, v in enumerate(vals):
        buf[i * 128 : (i + 1) * 128] = (int(v) % mod).to_bytes(128, "little")
    return np.frombuffer(bytes(buf), dtype=np.uint64).reshape(n, 16).copy()


def _u64x16_to_ints(arr: np.ndarray) -> list:
    raw = np.ascontiguousarray(arr, np.uint64).tobytes()
    return [
        int.from_bytes(raw[i * 128 : (i + 1) * 128], "little")
        for i in range(len(raw) // 128)
    ]


def _qr_p16(cls) -> np.ndarray:
    return _ints_to_u64x16([cls.modulus], 1 << 1024)


def qr_multiexp(cls, bases, exponents):
    lib = load()
    n = len(bases)
    b = _ints_to_u64x16([x.value for x in bases], cls.modulus)
    e = _ints_to_u64x16([int(x) for x in exponents], cls.order)
    out = np.zeros(16, dtype=np.uint64)
    lib.vmpc_qr_multiexp(_u64p(_qr_p16(cls)), _u64p(b), _u64p(e), n,
                         _u64p(out))
    return cls(_u64x16_to_ints(out)[0])


def qr_batch_exp(base, exponents) -> list:
    cls = type(base)
    lib = load()
    n = len(exponents)
    b = _ints_to_u64x16([base.value], cls.modulus)
    e = _ints_to_u64x16([int(x) for x in exponents], cls.order)
    out = np.zeros((n, 16), dtype=np.uint64)
    lib.vmpc_qr_batch_exp(_u64p(_qr_p16(cls)), _u64p(b), _u64p(e), n,
                          _u64p(out))
    return [cls(v) for v in _u64x16_to_ints(out)]


def qr_fold(g_l, g_r, c) -> list:
    cls = type(g_l[0])
    lib = load()
    n = len(g_l)
    gl = _ints_to_u64x16([x.value for x in g_l], cls.modulus)
    gr = _ints_to_u64x16([x.value for x in g_r], cls.modulus)
    cc = _ints_to_u64x16([int(c)], cls.order)
    out = np.zeros((n, 16), dtype=np.uint64)
    lib.vmpc_qr_fold(_u64p(_qr_p16(cls)), _u64p(gl), _u64p(gr), _u64p(cc), n,
                     _u64p(out))
    return [cls(v) for v in _u64x16_to_ints(out)]


def register_qr(cls, min_batch: int = 32) -> bool:
    """Install the QR C kernels as this class's dispatch backends (called
    by the QuadraticResidues factory once the native tier is enabled).
    Values are canonical residues either way, so proofs/transcripts are
    byte-identical to the Python pow() path."""
    if cls.modulus.bit_length() > 1024 or not available():
        return False
    from ..ops import dispatch

    dispatch.register_msm_backend(
        cls, lambda b, e: qr_multiexp(cls, b, e), min_batch
    )
    dispatch.register_fold_backend(
        cls, lambda gl, gr, c: qr_fold(gl, gr, c), min_batch
    )
    dispatch.register_batch_exp_backend(
        cls, lambda b, e: qr_batch_exp(b, e), min_batch
    )
    return True


_FASTSER_SRC = os.path.join(_HERE, "_fastser.c")
_FASTSER_SO = os.path.join(_HERE, "_fastser.so")
_fastser = None
_fastser_tried = False


def fastser():
    """CPython C-API extension for the per-element hot loops (transcript
    encoding, bigint<->limb conversion); None if unavailable.  Built on
    demand like the ctypes library; callers keep a pure-Python fallback."""
    global _fastser, _fastser_tried
    if _fastser is not None or _fastser_tried:
        return _fastser
    _fastser_tried = True
    import importlib.util
    import sysconfig

    if _stale(_FASTSER_SO, [_FASTSER_SRC]):
        inc = sysconfig.get_paths()["include"]
        try:
            _locked_build(
                _FASTSER_SO, [_FASTSER_SRC], [_FASTSER_SRC],
                lambda src, obj: ["gcc", "-O2", "-fPIC", f"-I{inc}", "-c",
                                  "-o", obj, src],
                lambda objs, out: ["gcc", "-shared", "-o", out, *objs],
                timeout=120,
            )
        except (OSError, subprocess.SubprocessError, RuntimeError):
            return None
    try:
        spec = importlib.util.spec_from_file_location(
            "verifiable_mpc_tpu_torch.native._fastser", _FASTSER_SO
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except Exception:
        return None
    _fastser = mod
    return _fastser


def register(min_batch: int = 8):
    """Install the native library as the host dispatch backend for Ed25519
    and the BN256 curves."""
    global REGISTERED
    if not available():
        return False
    enable_scalar_tier()
    REGISTERED = True
    from ..groups.bn256 import BNPoint, BNTwistPoint
    from ..groups.edwards import EdwardsPoint
    from ..ops import dispatch

    dispatch.register_msm_backend(EdwardsPoint, ed_msm, min_batch)
    dispatch.register_fold_backend(EdwardsPoint, ed_fold, min_batch)
    dispatch.register_batch_exp_backend(EdwardsPoint, ed_batch_exp, min_batch)
    dispatch.register_msm_backend(BNPoint, bn_msm, min_batch)
    dispatch.register_batch_exp_backend(BNPoint, bn_batch_exp, min_batch)
    dispatch.register_msm_backend(BNTwistPoint, bn2_msm, min_batch)
    dispatch.register_batch_exp_backend(BNTwistPoint, bn2_batch_exp, min_batch)
    # QR classes are created per modulus by the lru-cached factory: install
    # the C tier for any that already exist (the factory registers classes
    # created after this point itself)
    from ..groups import qr as _qr

    for cls in _qr._created_classes():
        register_qr(cls)
    return True
