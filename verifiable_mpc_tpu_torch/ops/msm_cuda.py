"""Ed25519 MSM, generator fold and fixed-base comb on the GPU.

Counterpart of the Ed25519 path of the JAX package's ``ops/msm_pallas.py``:
signed recoding (``_scalar_digits_signed``, ``_digits_signed_from_u64x4``),
``msm`` / ``msm_async``, ``fold``, ``batch_exp`` (the shared-base ladder),
``batch_exp_comb`` with its comb table, ``ed_encode_cached`` and
``register``.  The device work is five kernels hand-written in CUDA
(``csrc/*.cu``, one source each):

=====  =====================  ==========================================
K1     msm_accumulate         4-bit signed-window accumulation (B1)
K2     msm_tail               window reduction + split Horner + normalize (B2)
K3     fold                   g_l^c * g_r + batch normalize (B3)
K4     comb                   fixed-base comb + batch normalize (B5)
K15    bexp                   shared-base signed-window ladder (B4)
=====  =====================  ==========================================

Each wrapper (:func:`msm_rows`, :func:`fold_rows`, :func:`comb_rows`,
:func:`bexp_rows`) launches its kernels for a CUDA tensor and counts the
launch in :data:`LAUNCHES`; for a CPU tensor it runs the plain PyTorch
version beside it (:func:`msm_plain`, :func:`fold_plain`,
:func:`comb_plain`, :func:`bexp_plain`), which computes the same function
with tensor ops.  A CUDA tensor never reaches
a plain version, and a failed build or launch raises.

Points travel as ``[n, 16]`` int64 rows (``ops/curve_ed.py``); every result
leaves the kernels normalized (z = 1, canonical residues), so nothing that
reaches a Fiat-Shamir hash depends on the backend's representation.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..fields import FiniteFieldElement
from ..groups.edwards import ELL, EdwardsPoint
from . import curve_ed as ced
from . import dispatch

WINDOW = 4
NWINDOWS = 64  # 256 / WINDOW
TABLE_S = (1 << (WINDOW - 1)) + 1  # 0..8: signed-digit table
# the folds K3, K7 and K12: c's width-5 NAF, one digit more than the
# order's bits (254 for Ed25519's l, 257 for the 256-bit BN order), at
# most MAX_FOLD_DIGITS (FOLD_DIGITS in csrc/digits.cuh)
MAX_FOLD_DIGITS = 257
FOLD_NAF_WIDTH = 5
# the folds' threads an SM, by kernel (fold_threads): K3 fewer than its
# registers allow (384), which ran faster on an H100 (chip_variants.py's
# k3_wave384 and k3_wave128, PERF.md); K7 and K12 all that theirs allow
# (their __launch_bounds__ decide it; k7_wave*, k12_wave*)
FOLD_SM_THREADS = {"fold": 256, "bn_fold": None, "bn2_fold": None}
# points one (window, slice) thread of K1's and K5's window accumulation
# walks (32: 3-5 % less time than 16 for K1 + K2 and K5 + K6 at 2^17
# points on an H100, PERF.md; K9 takes its own, msm_bn2_cuda)
ACCUM_POINTS_PER_THREAD = 32
# the threads of a reduce block of K2 and K6 (REDUCE_THREADS in
# csrc/msm_tail.cu, BN_REDUCE_THREADS in csrc/bn_msm_tail.cu), and the adds
# a thread of K2's makes before its tree (K6's: 8; measured on an H100,
# chip_variants.py's k2_r*, PERF.md)
TAIL_REDUCE_THREADS = 128
TAIL_ADDS = 16
# K4's threads an SM: fewer than its registers allow (640), which ran
# faster on an H100 (chip_variants.py's k4_wave*, PERF.md)
COMB_SM_THREADS = 384

# kernel launches, counted by the wrappers where they launch (never by the
# plain versions); the bn_* ones by ops/msm_bn_cuda.py, the bn2_* ones by
# ops/msm_bn2_cuda.py, the bucket_* ones by ops/msm_bucket_cuda.py and
# mont_add by ops/add_cuda.py
LAUNCHES = {"msm_accumulate": 0, "msm_tail": 0, "fold": 0, "comb": 0,
            "bn_msm_accumulate": 0, "bn_msm_tail": 0, "bn_fold": 0,
            "bn_comb": 0, "bn2_msm_accumulate": 0, "bn2_msm_tail": 0,
            "bn2_bexp": 0, "bn2_fold": 0, "bucket_accumulate": 0,
            "bucket_reduce": 0, "bexp": 0, "mont_add": 0}

DEVICE = None  # set by register()
REGISTERED = False


def current_device(dev=None) -> torch.device:
    """``dev`` when given, else the device ``enable_gpu`` chose.  Before
    ``enable_gpu()`` (or ``enable_gpu(device="cpu")``) there is none and
    this raises: an entry point never runs on the CPU unasked."""
    if dev is not None:
        return torch.device(dev)
    if DEVICE is None:
        raise RuntimeError("no device chosen: call enable_gpu() first "
                           "(enable_gpu(device='cpu') for the plain "
                           "versions)")
    return DEVICE


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# scalar recoding (host)
# ---------------------------------------------------------------------------


def scalar_digits(scalars, order: int = ELL) -> np.ndarray:
    """[N] ints -> [NWINDOWS, N] unsigned 4-bit digits, most significant
    window first (``ops/msm._scalar_digits``)."""
    raw = b"".join((int(s) % order).to_bytes(32, "little") for s in scalars)
    by = np.frombuffer(raw, dtype=np.uint8).reshape(len(scalars), 32)
    digits = np.empty((len(scalars), NWINDOWS), np.uint32)
    digits[:, 0::2] = by & 15
    digits[:, 1::2] = by >> 4
    return np.ascontiguousarray(digits[:, ::-1].T)


def fold_digits(c: int, order: int = ELL) -> np.ndarray:
    """c mod ``order`` -> [m] int8, its width-5 NAF (the digits of K3, and
    of K7 and K12 with the BN order), most significant first: every digit
    0 or odd in [-15, 15], at most one nonzero in any five,
    sum_b d_b 2^(m - 1 - b) = c mod order.  m is one more than the
    order's bits (a NAF may run one digit past the top bit: 257 for the
    256-bit BN order).  c is not balanced against the order (as
    :func:`scalar_digits_signed` does), so the fold does not rest on its
    points lying in the order's subgroup."""
    m = order.bit_length() + 1
    if order < 2 or m > MAX_FOLD_DIGITS:
        raise ValueError(f"fold order of {order.bit_length()} bits")
    c %= order
    w = 1 << FOLD_NAF_WIDTH
    out = np.zeros(m, np.int8)
    b = 0
    while c:
        d = 0
        if c & 1:
            d = c % w
            if d >= w // 2:
                d -= w
            c -= d
        out[b] = d
        c >>= 1
        b += 1
    return np.ascontiguousarray(out[::-1])


def fold_challenges(order: int = ELL) -> dict:
    """The folds' edge challenges for ``order``, by name: 0, 1, 8 (one
    nonzero NAF digit), 9, order - 1, one with runs of zeros (the nibble 7
    in every third 4-bit window from window 20, least significant first)
    and, where it lies below the order (the 256-bit BN order, not
    Ed25519's l), 17 * 2^(bits - 5), whose width-5 NAF takes a digit past
    the order's top bit."""
    top = 17 << (order.bit_length() - 5)
    out = {"c0": 0, "c1": 1, "c8": 8, "c9": 9, "order-1": order - 1,
           "zero-run": sum(7 << (4 * w) for w in range(20, 63, 3))}
    if top < order:
        out["top-digit"] = top
    return out


def scalar_digits_signed(scalars, order: int = ELL) -> np.ndarray:
    """[N] ints -> [NWINDOWS, N] int8 signed digits in [-7, 8], most
    significant window first.

    A digit above the threshold borrows 16 from the next window, so the
    table holds 0..8.  Scalars above order/2 recode order - s with all
    digits negated; those columns borrow at d >= 8 (pre-negation digits in
    [-8, 7]), the others at d > 8, so after negation every digit is in
    [-7, 8] -- the 16 values an offset-7 nibble holds (a single d > 8 rule
    would emit -8 on negated columns, which packs as +8)."""
    reduced = np.array([int(s) % order for s in scalars], dtype=object)
    neg = reduced > order // 2
    balanced = np.where(neg, order - reduced, reduced)
    digs = scalar_digits(list(balanced), order)[::-1].astype(np.int64)
    thresh = np.where(neg, 8, 9)
    carry = np.zeros(digs.shape[1], np.int64)
    out = np.empty_like(digs)
    for w in range(digs.shape[0]):
        d = digs[w] + carry
        carry = (d >= thresh).astype(np.int64)
        out[w] = d - 16 * carry
    assert not carry.any(), "scalar overflow in signed recoding"
    out[:, neg] = -out[:, neg]
    assert out.min(initial=0) >= -7 and out.max(initial=0) <= 8
    return np.ascontiguousarray(out[::-1].astype(np.int8))


def _order_limbs(order: int):
    mask = (1 << 64) - 1
    o = np.array([(order >> (64 * i)) & mask for i in range(4)], np.uint64)
    h = np.array([((order // 2) >> (64 * i)) & mask for i in range(4)],
                 np.uint64)
    return o, h


def digits_signed_from_u64x4(arr: np.ndarray, order: int = ELL) -> np.ndarray:
    """[m, 4] u64 canonical residues -> [64, m] int8 signed digits,
    identical to :func:`scalar_digits_signed` (vectorized over the
    columns; ``native.recode_signed4_packed_arr`` is its C twin)."""
    o_l, h_l = _order_limbs(order)
    a = np.ascontiguousarray(arr, np.uint64)
    m = a.shape[0]
    neg = np.zeros(m, bool)
    tie = np.ones(m, bool)
    for j in (3, 2, 1, 0):
        gt = a[:, j] > h_l[j]
        lt = a[:, j] < h_l[j]
        neg |= tie & gt
        tie &= ~gt & ~lt
    bal = a.copy()
    if neg.any():
        borrow = np.zeros(m, np.uint64)
        sub = np.empty_like(a)
        for j in range(4):
            aj = a[:, j]
            sub[:, j] = o_l[j] - aj - borrow  # u64 wraparound = 2's comp
            borrow = (
                (aj > o_l[j]) | ((aj == o_l[j]) & (borrow == 1))
            ).astype(np.uint64)
        bal[neg] = sub[neg]
    digs = np.empty((64, m), np.int16)
    for j in range(4):
        col = bal[:, j]
        for k in range(16):
            digs[16 * j + k] = (
                (col >> np.uint64(4 * k)) & np.uint64(0xF)
            ).astype(np.int16)
    thresh = np.where(neg, np.int16(8), np.int16(9))
    carry = np.zeros(m, np.int16)
    for w in range(64):
        d = digs[w] + carry
        carry = (d >= thresh).astype(np.int16)
        digs[w] = d - 16 * carry
    assert not carry.any(), "scalar overflow in signed recoding"
    digs[:, neg] = -digs[:, neg]
    return np.ascontiguousarray(digs[::-1].astype(np.int8))


def pack_digits(digits: np.ndarray) -> np.ndarray:
    """[W, ...] int8 digits in [-7, 8] -> [W/2, ...] uint8: window 2r in
    the low nibble of byte r, window 2r+1 in the high one, each + 7."""
    assert digits.shape[0] % 2 == 0
    lo, hi = int(digits.min(initial=0)), int(digits.max(initial=0))
    assert -7 <= lo and hi <= 8, f"digit range [{lo}, {hi}] is not [-7, 8]"
    off = digits.astype(np.int16) + 7
    return (off[0::2] | (off[1::2] << 4)).astype(np.uint8)


def unpack_digits(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_digits` on a tensor: [..., R, n] uint8 ->
    [..., 2R, n] int64."""
    p = packed.to(torch.int64)
    lo, hi = (p & 15) - 7, (p >> 4) - 7
    out = torch.stack([lo, hi], dim=-2)  # [..., R, 2, n]
    return out.flatten(-3, -2)


def scalars_to_u64x4(scalars, order: int = ELL) -> np.ndarray:
    """[n, 4] u64 canonical residues of int / field-element scalars (one C
    pass for field elements of the order's field)."""
    from .. import native

    for s in scalars[:4]:
        ff = type(s)
        if isinstance(s, FiniteFieldElement) and getattr(ff, "modulus", 0) == order:
            arr = native.vals_to_arr(scalars, ff, order, int_mode=1)
            if arr is not None:
                return arr
            break
    return native._ints_to_u64x4([int(s) for s in scalars], order)


def packed_digits(arr: np.ndarray, order: int = ELL):
    """[n, 4] u64 residues -> (packed digits [nw/2, n] u8, nw), with nw = 8
    when every scalar fits 8 signed windows, else 64."""
    from .. import native

    if native.load() is not None:
        pk, wn = native.recode_signed4_packed_arr(arr, order)
    else:
        digs = digits_signed_from_u64x4(arr, order)
        nz = np.flatnonzero(digs.any(axis=1))
        wn = NWINDOWS - int(nz[0]) if nz.size else 1
        pk = pack_digits(digs)
    nw = 8 if wn <= 8 else NWINDOWS
    return np.ascontiguousarray(pk[(NWINDOWS - nw) // 2 :]), nw


# ---------------------------------------------------------------------------
# kernel wrappers (tensor level)
# ---------------------------------------------------------------------------


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def one_wave(n: int, per_sm: int, dev: torch.device) -> int:
    """min(n, the threads of a kernel that holds ``per_sm`` threads on an
    SM, on every SM of the card): a grid that runs in one wave.  ``per_sm``
    is an occupancy query's result; a value <= 0 is a CUDA error."""
    if per_sm <= 0:
        raise RuntimeError(f"occupancy query failed: error {-per_sm}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return min(n, per_sm * sms)


def _check_rows(t: torch.Tensor, name: str, dims: int, width: int = 16):
    if t.dtype != torch.int64 or t.dim() != dims or t.shape[-1] != width:
        raise ValueError(f"{name}: expected int64 [..., {width}] rows of "
                         f"rank {dims}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_digits(d: torch.Tensor, name: str, shape):
    if d.dtype != torch.uint8 or tuple(d.shape) != tuple(shape):
        raise ValueError(f"{name}: expected uint8 {tuple(shape)}, got "
                         f"{d.dtype} {tuple(d.shape)}")
    if not d.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _same_device(*ts):
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("inputs lie on different devices")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def slices_for(n: int, per_thread: int) -> int:
    """A window accumulation's slice count: each (window, slice) thread
    walks about ``per_thread`` points (K1 and K5 take
    ACCUM_POINTS_PER_THREAD, K9 msm_bn2_cuda's)."""
    return max(1, -(-n // per_thread))


def msm_accumulate(points: torch.Tensor, digits: torch.Tensor,
                   S: int) -> torch.Tensor:
    """K1: window accumulators [B, nw, S, 16] (extended rows, not
    normalized) of B MSMs; slice s holds points s, s + S, s + 2S, ...
    points [B, n, 16] rows, digits [B, nw/2, n] packed signed windows.

    Allocates the accumulators and a scratch table [B, n, 8, 16] (each
    point's multiples 1..8 in precomputed form, 1 KB a point: 268 MB at
    B = 2, n = 2^17), which the first of K1's two launches fills and the
    second reads, one entry per (window, point).
    CPU: :func:`msm_accumulate_plain`."""
    _check_rows(points, "points", 3)
    B, n, _ = points.shape
    _check_digits(digits, "digits", (B, digits.shape[1], n))
    nw = 2 * digits.shape[1]
    if not 0 < nw <= NWINDOWS or not 0 < S:
        raise ValueError(f"window count {nw} / slice count {S}")
    if _same_device(points, digits).type == "cpu":
        return msm_accumulate_plain(points, digits, S)
    from . import _cuda_build as cb

    tbl = torch.empty((B, n, TABLE_S - 1, 16), dtype=torch.int64,
                      device=points.device)
    acc = torch.empty((B, nw, S, 16), dtype=torch.int64, device=points.device)
    cb.check(cb.lib().vmpc_cu_msm_accum(
        points.data_ptr(), tbl.data_ptr(), digits.data_ptr(), acc.data_ptr(),
        B, n, nw, S, _stream(points)), "msm_accumulate")
    LAUNCHES["msm_accumulate"] += 1
    return acc


def tail_split(S: int, adds: int = TAIL_ADDS) -> int:
    """The chunk count R a window of K2's (and, with ``adds`` = 8, K6's)
    reduce launch: about ``adds`` adds a thread of a reduce block before
    its tree (K2: R = 2 at S = 4096, K6: 4; measured on the H100,
    PERF.md)."""
    return max(1, -(-S // (adds * TAIL_REDUCE_THREADS)))


def msm_tail(acc: torch.Tensor) -> torch.Tensor:
    """K2: accumulators [B, nw, S, 16] -> [B, 16] canonical rows of
    sum_w 16^(nw-1-w) sum_s acc[w, s]: a reduce launch into R chunks a
    window (:func:`tail_split`), then one block a batch combines them.
    CPU: :func:`msm_tail_plain`."""
    _check_rows(acc, "acc", 4)
    B, nw, S, _ = acc.shape
    if not 0 < nw <= NWINDOWS or not S:
        raise ValueError(f"window count {nw} / slice count {S}")
    if _same_device(acc).type == "cpu":
        return msm_tail_plain(acc)
    from . import _cuda_build as cb

    R = tail_split(S)
    part = torch.empty((B, nw, R, 16), dtype=torch.int64, device=acc.device)
    out = torch.empty((B, 16), dtype=torch.int64, device=acc.device)
    cb.check(cb.lib().vmpc_cu_msm_tail(
        acc.data_ptr(), part.data_ptr(), out.data_ptr(), B, nw, S, R,
        _stream(acc)), "msm_tail")
    LAUNCHES["msm_tail"] += 1
    return out


def msm_rows(points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """sum_i d_i * P_i for B independent MSMs -> [B, 16] canonical rows
    (K1 then K2)."""
    return msm_tail(msm_accumulate(
        points, digits, slices_for(points.shape[1], ACCUM_POINTS_PER_THREAD)))


def check_fold_digits(cdigits) -> np.ndarray:
    """The fold digits of K3, K7 and K12 as contiguous int8, after checking
    them: at most MAX_FOLD_DIGITS, each 0 or odd in [-15, 15]
    (:func:`fold_digits`)."""
    cdig = np.asarray(cdigits)
    half = 1 << (FOLD_NAF_WIDTH - 1)
    if (cdig.size > MAX_FOLD_DIGITS
            or not np.issubdtype(cdig.dtype, np.integer)
            or (cdig % 2 == 0)[cdig != 0].any()
            or np.abs(cdig.astype(np.int64)).max(initial=0) >= half):
        raise ValueError(f"fold digits must be <= {MAX_FOLD_DIGITS} NAF "
                         f"digits, 0 or odd below {half} in magnitude")
    return np.ascontiguousarray(cdig, dtype=np.int8).reshape(-1)


def fold_rows(gl: torch.Tensor, gr: torch.Tensor,
              cdigits: np.ndarray) -> torch.Tensor:
    """[gl_i^c * gr_i] as canonical rows; ``cdigits``: c's width-5 NAF,
    most significant first (:func:`fold_digits`).  CUDA: K3, G =
    :func:`fold_threads` threads, thread g folding the elements g, g + G,
    ... and normalizing them with one inversion; CPU: :func:`fold_plain`."""
    _check_rows(gl, "gl", 2)
    _check_rows(gr, "gr", 2)
    if gl.shape != gr.shape:
        raise ValueError("gl and gr differ in shape")
    cdig = check_fold_digits(cdigits)
    if _same_device(gl, gr).type == "cpu":
        return fold_plain(gl, gr, cdig)
    from . import _cuda_build as cb

    n = gl.shape[0]
    out = torch.empty((n, 16), dtype=torch.int64, device=gl.device)
    if not n:
        return out
    pre = torch.empty((n, 4), dtype=torch.int64, device=gl.device)
    cb.check(cb.lib().vmpc_cu_fold_norm(
        gl.data_ptr(), gr.data_ptr(), cdig.ctypes.data, len(cdig),
        fold_threads(n, gl.device), pre.data_ptr(), out.data_ptr(), n,
        _stream(gl)), "fold")
    LAUNCHES["fold"] += 1
    return out


def fold_threads(n: int, dev: torch.device, kernel: str = "fold") -> int:
    """The thread count G of the fold ``kernel`` (``fold`` K3, ``bn_fold``
    K7, ``bn2_fold`` K12) for n elements: one wave (:func:`one_wave`) of
    what its registers allow an SM (``vmpc_cu_<kernel>_resident``), at
    most FOLD_SM_THREADS[kernel] where that is set."""
    from . import _cuda_build as cb

    per_sm = getattr(cb.lib(), f"vmpc_cu_{kernel}_resident")()
    cap = FOLD_SM_THREADS[kernel]
    return one_wave(n, per_sm if cap is None else min(per_sm, cap), dev)


def comb_rows(table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Fixed-base comb: table [nw*9, 12] affine precomputed-form rows (row
    w*9+m = m * 16^(nw-1-w) * base, :func:`comb_table`), digits [nw/2, n]
    packed -> [n, 16] canonical rows.  CUDA: K4, G = :func:`comb_threads`
    threads, thread g summing the exponents g, g + G, ... and normalizing
    them with one inversion; CPU: :func:`comb_plain`."""
    _check_rows(table, "table", 2, ced.AFF_ROW)
    nw = table.shape[0] // TABLE_S
    if nw * TABLE_S != table.shape[0] or nw % 2 or not 0 < nw <= NWINDOWS:
        raise ValueError(f"comb table of {table.shape[0]} rows")
    _check_digits(digits, "digits", (nw // 2, digits.shape[-1]))
    if _same_device(table, digits).type == "cpu":
        return comb_plain(table, digits)
    from . import _cuda_build as cb

    n = digits.shape[1]
    out = torch.empty((n, 16), dtype=torch.int64, device=table.device)
    if not n:
        return out
    pre = torch.empty((n, 4), dtype=torch.int64, device=table.device)
    cb.check(cb.lib().vmpc_cu_comb_norm(
        table.data_ptr(), digits.data_ptr(), n, nw,
        comb_threads(n, table.device), pre.data_ptr(), out.data_ptr(),
        _stream(table)), "comb")
    LAUNCHES["comb"] += 1
    return out


def comb_threads(n: int, dev: torch.device) -> int:
    """K4's thread count G for n exponents: one wave (:func:`one_wave`) of
    at most COMB_SM_THREADS an SM."""
    from . import _cuda_build as cb

    return one_wave(n, min(cb.lib().vmpc_cu_comb_resident(),
                           COMB_SM_THREADS), dev)


def bexp_rows(table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """base^e_i for a shared base: table [9, 16] precomputed-form rows (row
    m = m * base), digits [nw/2, n] packed signed windows of the exponents
    -> [n, 16] canonical rows.  CUDA: K15; CPU: :func:`bexp_plain`."""
    _check_rows(table, "table", 2)
    if table.shape[0] != TABLE_S:
        raise ValueError(f"batch-exp table of {table.shape[0]} rows, not "
                         f"{TABLE_S}")
    _check_digits(digits, "digits", (digits.shape[0], digits.shape[-1]))
    nw = 2 * digits.shape[0]
    if not 0 < nw <= NWINDOWS or not digits.shape[1]:
        raise ValueError(f"window count {nw} / {digits.shape[1]} exponents")
    if _same_device(table, digits).type == "cpu":
        return bexp_plain(table, digits)
    from . import _cuda_build as cb

    n = digits.shape[1]
    out = torch.empty((n, 16), dtype=torch.int64, device=table.device)
    cb.check(cb.lib().vmpc_cu_bexp_norm(table.data_ptr(), digits.data_ptr(),
                                        n, nw, out.data_ptr(),
                                        _stream(table)), "bexp")
    LAUNCHES["bexp"] += 1
    return out


# ---------------------------------------------------------------------------
# plain versions (tensor ops; the CPU path and the kernels' yardstick)
# ---------------------------------------------------------------------------


def _tree_sum(p, dim: int, law=ced):
    """Group sum of points along batch dim ``dim`` (pairwise), under the
    group law of module ``law`` (``curve_ed`` or ``curve_bn``)."""
    while p[0].shape[dim] > 1:
        m = p[0].shape[dim]
        if m % 2:
            shape = list(p[0].shape[:-1])
            shape[dim] = 1
            pad = law.identity(tuple(shape), p[0].device)
            p = tuple(torch.cat([a, b], dim=dim) for a, b in zip(p, pad))
        even = tuple(a.narrow(dim, 0, a.shape[dim] // 2 * 2) for a in p)
        lo = tuple(a.unflatten(dim, (-1, 2)).select(dim + 1, 0) for a in even)
        hi = tuple(a.unflatten(dim, (-1, 2)).select(dim + 1, 1) for a in even)
        p = law.add(lo, hi)
    return tuple(a.select(dim, 0) for a in p)


def _horner(sums, nw: int, law=ced, bits: int = WINDOW):
    """sum_w 2^(bits (nw-1-w)) S_w over window sums [..., nw] (MSB
    first)."""
    h = law.identity(sums[0].shape[:-2], sums[0].device)
    for w in range(nw):
        for _ in range(bits):
            h = law.dbl(h)
        h = law.add(h, tuple(c[..., w, :] for c in sums))
    return h


_PLAIN_BLOCK = 1 << 20  # (point, window) pairs a plain step holds at once


def bn_comb_plain(table: torch.Tensor, digits: torch.Tensor,
                  law) -> torch.Tensor:
    """The plain fixed-base comb over a BN curve (``law``: ``curve_bn`` for
    K8, ``curve_bn2`` for K11): the table's working rows, select
    T[w][|d_w(e_i)|] for every window, negate for d < 0, sum over the
    windows, normalize (in blocks of exponents)."""
    table = law.encode_jacobian_rows(table)
    nw = 2 * digits.shape[0]
    n = digits.shape[1]
    d = unpack_digits(digits)  # [nw, n]
    base = torch.arange(nw, device=d.device)[:, None] * TABLE_S
    step = max(1, _PLAIN_BLOCK // nw)
    out = []
    for i0 in range(0, n, step):
        db = d[:, i0 : i0 + step]
        m = db.shape[1]
        rows = table[(base + db.abs()).reshape(-1)].reshape(nw, m, law.ROW)
        sel = law.neg_where(db < 0, law.split_rows(rows))
        out.append(law.normalize_rows(_tree_sum(sel, 0, law)))
    return torch.cat(out, dim=0)


def bn_fold_plain(gl: torch.Tensor, gr: torch.Tensor, cdig: np.ndarray,
                  law) -> torch.Tensor:
    """The plain fold over a BN curve (``law``: ``curve_bn`` for K7,
    ``curve_bn2`` for K12): the working rows of gl, the table of its odd
    multiples 1, 3, ... up to the largest |digit| of c (a doubling and the
    adds), the sum started from the first nonzero NAF digit's entry, then
    per digit a doubling and for a nonzero one an add of +-T[(|d| - 1) /
    2], the add of gr's working rows, normalize."""
    n = gl.shape[0]
    nz = np.flatnonzero(cdig)
    if nz.size:
        g = law.split_rows(law.encode_jacobian_rows(gl))
        step = law.dbl(g)
        tbl = [g]
        for _ in range(int(np.abs(cdig.astype(np.int16)).max()) // 2):
            tbl.append(law.add(tbl[-1], step))
        neg = torch.ones((n,), dtype=torch.bool, device=gl.device)

        def entry(d):
            q = tbl[(abs(d) - 1) // 2]
            return q if d > 0 else law.neg_where(neg, q)

        acc = entry(int(cdig[nz[0]]))
        for d in cdig[nz[0] + 1:]:
            acc = law.dbl(acc)
            if d:
                acc = law.add(acc, entry(int(d)))
    else:
        acc = law.identity((n,), gl.device)
    return law.normalize_rows(law.add(
        acc, law.split_rows(law.encode_jacobian_rows(gr))))


def bn_comb_table(cache: dict, base, nw: int, device, build) -> torch.Tensor:
    """The comb table of ``base`` for ``nw`` windows on ``device``: from
    ``cache`` (keyed by the normalized base, nw and device), else the u64
    rows ``build(base, nw)`` gives (a C++ tier function), kept there."""
    device = current_device(device)
    key = (repr(base.normalize()), nw, str(device))
    hit = cache.get(key)
    if hit is None:
        hit = cache[key] = torch.from_numpy(
            build(base, nw).view(np.int64)).to(device)
    return hit


def msm_accumulate_plain(points: torch.Tensor, digits: torch.Tensor,
                         S: int) -> torch.Tensor:
    """Plain version of K1: the 0..8 precomputed-form table of each point,
    the signed selection per (window, point), summed into the (window,
    slice) accumulators; points are taken in blocks of whole rows of S."""
    B, n, _ = points.shape
    nw = 2 * digits.shape[1]
    dev = points.device
    J = -(-n // S)
    pad = J * S - n
    d = unpack_digits(digits)  # [B, nw, n]
    if pad:
        ident = torch.tensor(ced.IDENTITY_ROW, dtype=torch.int64, device=dev)
        points = torch.cat([points, ident.expand(B, pad, 16)], dim=1)
        d = torch.cat([d, d.new_zeros(B, nw, pad)], dim=2)
    acc = ced.identity((B, nw, S), dev)
    step = max(1, _PLAIN_BLOCK // (B * nw * S))
    for j0 in range(0, J, step):
        j1 = min(J, j0 + step)
        blk = points[:, j0 * S : j1 * S]  # [B, m, 16], m = (j1-j0)*S
        m = blk.shape[1]
        p = ced.split_rows(blk)
        pre1 = ced.to_pre(p)
        tbl = [ced.pre_identity((B, m), dev), pre1]
        cur = p
        for _ in range(2, TABLE_S):
            cur = ced.add_pre(cur, pre1)
            tbl.append(ced.to_pre(cur))
        db = d[:, :, j0 * S : j1 * S]  # [B, nw, m]
        idx = db.abs().transpose(1, 2)[..., None].expand(B, m, nw, 16)
        sel = tuple(
            torch.gather(torch.stack([t[c] for t in tbl], dim=2), 2, idx)
            .transpose(1, 2)
            for c in range(4)
        )  # [B, nw, m, 16]
        sel = ced.neg_where_pre(db < 0, sel)
        part = ced.add_pre(ced.identity((B, nw, m), dev), sel)
        part = _tree_sum(tuple(c.unflatten(2, (j1 - j0, S)) for c in part), 2)
        acc = ced.add(acc, part)
    return ced.join_rows_relaxed(acc)


def msm_tail_plain(acc: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: sum the slices of each window, Horner over the
    windows, normalize."""
    nw = acc.shape[1]
    sums = _tree_sum(ced.split_rows(acc), 2)  # [B, nw, 16]
    return ced.normalize_rows(_horner(sums, nw))


def msm_plain(points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 + K2."""
    return msm_tail_plain(
        msm_accumulate_plain(points, digits, slices_for(
            points.shape[1], ACCUM_POINTS_PER_THREAD))
    )


def fold_plain(gl: torch.Tensor, gr: torch.Tensor,
               cdig: np.ndarray) -> torch.Tensor:
    """Plain version of K3: the table of gl's odd multiples 1, 3, ... (up
    to the largest |digit| of c) in precomputed form, the sum started from
    the first nonzero digit's entry, then per digit a doubling and for a
    nonzero one a mixed add of +-T[(|d| - 1) / 2], add gr, normalize."""
    n = gl.shape[0]
    nz = np.flatnonzero(cdig)
    if nz.size:
        g = ced.split_rows(gl)
        tbl = [ced.to_pre(g)]
        step = ced.to_pre(ced.dbl(g))
        cur = g
        for _ in range(int(np.abs(cdig.astype(np.int16)).max()) // 2):
            cur = ced.add_pre(cur, step)
            tbl.append(ced.to_pre(cur))

        def entry(d):
            q = tbl[(abs(d) - 1) // 2]
            if d > 0:
                return q
            return ced.neg_where_pre(
                torch.ones((n,), dtype=torch.bool, device=gl.device), q)

        acc = ced.pre_to_ext(entry(int(cdig[nz[0]])))
        for d in cdig[nz[0] + 1:]:
            acc = ced.dbl(acc)
            if d:
                acc = ced.add_pre(acc, entry(int(d)))
    else:
        acc = ced.identity((n,), gl.device)
    return ced.normalize_rows(ced.add(acc, ced.split_rows(gr)))


def comb_plain(table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: select T[w][d_w(e_i)] (affine rows) for every
    window, negate for d < 0, sum over the windows, normalize (in blocks
    of exponents)."""
    nw = 2 * digits.shape[0]
    n = digits.shape[1]
    d = unpack_digits(digits)  # [nw, n]
    base = torch.arange(nw, device=d.device)[:, None] * TABLE_S
    step = max(1, _PLAIN_BLOCK // nw)
    out = []
    for i0 in range(0, n, step):
        db = d[:, i0 : i0 + step]
        m = db.shape[1]
        rows = table[(base + db.abs()).reshape(-1)].reshape(nw, m,
                                                             ced.AFF_ROW)
        sel = ced.neg_where_pre(db < 0, ced.split_aff_rows(rows))
        acc = ced.add_pre(ced.identity((nw, m), table.device), sel)
        out.append(ced.normalize_rows(_tree_sum(acc, 0)))
    return torch.cat(out, dim=0)


def bexp_plain(table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Plain version of K15: per exponent 4 doublings and a mixed add of
    +-T[|d|] per window, normalize (in blocks of exponents)."""
    tbl = ced.split_rows(table)  # 4 x [9, 16]
    nw = 2 * digits.shape[0]
    n = digits.shape[1]
    d = unpack_digits(digits)  # [nw, n]
    step = max(1, _PLAIN_BLOCK // nw)
    out = []
    for i0 in range(0, n, step):
        db = d[:, i0 : i0 + step]
        acc = ced.identity((db.shape[1],), table.device)
        for w in range(nw):
            for _ in range(WINDOW):
                acc = ced.dbl(acc)
            sel = ced.neg_where_pre(db[w] < 0,
                                    tuple(c[db[w].abs()] for c in tbl))
            acc = ced.add_pre(acc, sel)
        out.append(ced.normalize_rows(acc))
    return torch.cat(out, dim=0)


# ---------------------------------------------------------------------------
# point-level API (the dispatch backends)
# ---------------------------------------------------------------------------

_ED_ENC_CACHE = collections.OrderedDict()
_ED_ENC_CACHE_MAX = 4


def ed_encode_cached(points, device=None):
    """(host [n, 16] u64 rows, device [n, 16] int64 rows) for an Ed25519
    point list, LRU-cached by element identity: one prove walks the same
    generator vector for the z-commitment, protocol 5's A and the resident
    engine.  The value keeps the list alive, so the id key cannot alias."""
    from .. import native

    device = current_device(device)
    key = (tuple(map(id, points)), str(device))
    hit = _ED_ENC_CACHE.get(key)
    if hit is not None:
        _ED_ENC_CACHE.move_to_end(key)
        return hit[0], hit[1]
    rows = native._pts_to_u64(list(points))
    dev = ced.from_reference_rows(rows, device)
    _ED_ENC_CACHE[key] = (rows, dev, list(points))
    while len(_ED_ENC_CACHE) > _ED_ENC_CACHE_MAX:
        _ED_ENC_CACHE.popitem(last=False)
    return rows, dev


def _device_points(points):
    from .. import native

    if len(points) >= 4096 and native.fastser() is not None:
        return ed_encode_cached(points)[1]
    return ced.encode_points(points, current_device())


def _msm_launch(points, scalars):
    n = len(points)
    assert n == len(scalars)
    pk, _nw = packed_digits(scalars_to_u64x4(scalars, ELL), ELL)
    digits = torch.from_numpy(pk).to(current_device())
    return msm_rows(_device_points(points)[None], digits[None])


def msm(points, scalars) -> EdwardsPoint:
    """prod points[i] ** scalars[i] (Ed25519) through K1 + K2."""
    return ced.decode_rows(_msm_launch(points, scalars))[0]


def msm_async(points, scalars):
    """Launch an MSM; the returned thunk waits for it and decodes, so the
    device work overlaps whatever the caller does first."""
    out = _msm_launch(points, scalars)
    return lambda: ced.decode_rows(out)[0]


def fold(g_l, g_r, c: int) -> list:
    """[g_l[i] ** c * g_r[i]] (normalized) through K3."""
    assert len(g_l) == len(g_r)
    dev = current_device()
    out = fold_rows(ced.encode_points(g_l, dev), ced.encode_points(g_r, dev),
                    fold_digits(int(c)))
    return ced.decode_rows(out)


_COMB_TABLES = {}  # (repr of the normalized base, nw, device) -> table


def _comb_table_build(base, nw: int) -> np.ndarray:
    """Rows MSB-first, row w holding d * (16^(nw-1-w) * base) for d = 0..8,
    in affine precomputed form (~nw * 8 host group operations and one
    batch normalization, cached per base)."""
    ident = EdwardsPoint.identity
    rows = []
    base_w = base
    for _ in range(nw):
        row = [ident, base_w]
        for _m in range(2, TABLE_S):
            row.append(row[-1] * base_w)
        rows.append(row)
        eight = row[TABLE_S - 1]
        base_w = eight * eight  # 16 * base_w
    rows.reverse()
    return ced.affine_pre_rows(EdwardsPoint.batch_normalize(
        [pt for row in rows for pt in row]))


def comb_table(base, nw: int, device=None) -> torch.Tensor:
    """[nw*9, 12] affine precomputed-form rows of the comb of ``base`` for
    ``nw`` windows on ``device`` (:func:`_comb_table_build`), cached by the
    normalized base, nw and device."""
    device = current_device(device)
    key = (repr(base.normalize()), nw, str(device))
    hit = _COMB_TABLES.get(key)
    if hit is None:
        hit = _COMB_TABLES[key] = torch.from_numpy(
            _comb_table_build(base, nw).view(np.int64)).to(device)
    return hit


def batch_exp_comb(base, exponents) -> list:
    """[base ** e for e in exponents] (normalized) through K4."""
    from .. import native

    dev = current_device()
    arr = native._ints_to_u64x4([int(e) for e in exponents], ELL)
    pk, nw = packed_digits(arr, ELL)
    out = comb_rows(comb_table(base, nw), torch.from_numpy(pk).to(dev))
    return ced.decode_rows(out)


def bexp_table(base, device=None) -> torch.Tensor:
    """[9, 16] precomputed-form rows of m * base for m = 0..8, built on the
    host (7 group operations, as ``_batch_exp_generic`` builds its table)."""
    pts = [EdwardsPoint.identity, base]
    for _ in range(2, TABLE_S):
        pts.append(pts[-1] * base)
    return ced.from_reference_rows(ced.pre_rows(pts), current_device(device))


def batch_exp(base, exponents) -> list:
    """[base ** e for e in exponents] (normalized) through K15, the
    counterpart of ``msm_pallas.batch_exp``: exponents reduced mod the
    order and recoded into signed 4-bit windows.  Registered nowhere, as
    in the JAX package (the comb, :func:`batch_exp_comb`, serves the
    dispatch)."""
    dev = current_device()
    pk, _nw = packed_digits(scalars_to_u64x4(list(exponents), ELL), ELL)
    out = bexp_rows(bexp_table(base), torch.from_numpy(pk).to(dev))
    return ced.decode_rows(out)


def register(device, min_batch: int = 512):
    """Run the kernels on ``device`` and install K1 + K2 as the Ed25519
    MSM-async backend.  ``enable_gpu`` installs :func:`msm`, :func:`fold`
    and :func:`batch_exp_comb` itself, tiered with the C++ host tier;
    ``enable_native`` removes the async backend again."""
    global DEVICE, REGISTERED
    DEVICE = torch.device(device)
    REGISTERED = True
    dispatch.register_msm_async_backend(EdwardsPoint, msm_async, min_batch)
