"""BN256 twist (G2) MSM, fixed-base batch exponentiation and generator fold
on the GPU.

Counterpart of the JAX package's ``ops/bn2_pallas.py`` (``msm``, ``fold``,
``batch_exp``, ``register``) and of ``msm_pallas._batch_exp_generic``: the
curve-generic kernels of ``ops/msm_pallas.py`` with the twist adapter.  The
device work is four kernels hand-written in CUDA (``csrc/bn2_*.cu``, one
source each, over ``csrc/fp2_254.cuh`` and ``csrc/bn2_kernels.cuh``):

=====  ======================  ===========================================
K9     bn2_msm_accumulate      4-bit signed-window accumulation (B1, BN2)
K10    bn2_msm_tail            window reduction + split Horner + normalize (B2)
K11    bn2_bexp                fixed-base comb + batch normalize (B4, BN2)
K12    bn2_fold                g_l^c * g_r + batch normalize (B3, BN2)
=====  ======================  ===========================================

Each wrapper (:func:`msm_rows`, :func:`bexp_rows`, :func:`fold_rows`)
launches its kernels for a CUDA tensor and counts the launch in
``msm_cuda.LAUNCHES``; for a CPU tensor it runs the plain PyTorch version
beside it (:func:`msm_plain`, :func:`bexp_plain`, :func:`fold_plain`).  A
CUDA tensor never reaches a plain version, and a failed build or launch
raises.

Points travel as ``[n, 24]`` int64 input rows (``ops/curve_bn2.py``):
jacobian, standard form, as ``native._bn2_pts_to_u64`` gives them.  K9 and
K11 turn them into working rows (projective, Montgomery form) in a first
launch (K9 the affine entries of each point's multiples 1..8, K11 the rows
of its comb table, which the C++ tier builds and :func:`bexp_table`
caches per base), K12 as each thread loads them, and every result leaves
the kernels normalized in standard form, the identity as exactly
``BNTwistPoint.identity``'s (1, 1, 0), which is an input row again.
Scalars are recoded against the BN group order (``bn256.ORDER``), with the
-8 digit guard of ``msm_cuda``'s recoding.

K12 is K7's design (K3's) over GF(p^2): the fold challenge c as the
width-5 NAF of c mod the BN order (``msm_cuda.fold_digits(c, ORDER)``),
each element's table of its odd multiples 1, 3, ..., 15 (one doubling and
7 adds, 1.5 KB of local memory), the sum from the first nonzero digit,
and one wave of ``msm_cuda.fold_threads`` threads, each normalizing its
elements g, g + G, ... with one GF(p^2) inversion.
"""

from __future__ import annotations

import numpy as np
import torch

from ..groups.bn256 import ORDER, BNTwistPoint
from . import curve_bn2 as cb2
from . import field_bn254x2 as fp2
from . import msm_cuda as mc

TABLE_S = mc.TABLE_S  # signed-digit table 0..8
ROW = cb2.ROW
ENTRY = 16  # K9's affine table entry (x R, y R)
# K9's points a thread (16, 32 and 64 measured on the H100, PERF.md)
ACCUM_POINTS_PER_THREAD = 64
# K9's normalization launch: one wave of at most this many threads an SM
# (fewer than its registers allow, 384: 128, 256 and 384 measured on the
# H100, PERF.md)
TABLE_SM_THREADS = 256
# K10 (csrc/bn2_msm_tail.cu): the threads of a reduce block
TAIL_REDUCE_THREADS = 128


# ---------------------------------------------------------------------------
# kernel wrappers (tensor level)
# ---------------------------------------------------------------------------


def msm_accumulate(points: torch.Tensor, digits: torch.Tensor,
                   S: int) -> torch.Tensor:
    """K9: window accumulators [B, nw, S, 24] (working rows, not
    normalized) of B MSMs; slice s holds points s, s + S, s + 2S, ...
    points [B, n, 24] input rows, digits [B, nw/2, n] packed signed
    windows.

    Allocates the accumulators, a scratch table [B, n, 8, 16] (each
    point's multiples 1..8 as affine entries, 1 KB a point: 134 MB at
    n = 2^17) and the first launch's scratch of the same size (each
    entry's Z and the running product of its thread's Z's); the first two
    of K9's three launches fill the table (the second, the normalization,
    with :func:`table_threads` threads) and the third reads it, one entry
    per (window, point).
    CPU: :func:`msm_accumulate_plain`."""
    mc._check_rows(points, "points", 3, ROW)
    B, n, _ = points.shape
    mc._check_digits(digits, "digits", (B, digits.shape[1], n))
    nw = 2 * digits.shape[1]
    if not 0 < nw <= mc.NWINDOWS or not 0 < S or not n:
        raise ValueError(f"window count {nw} / slice count {S} / {n} points")
    if mc._same_device(points, digits).type == "cpu":
        return msm_accumulate_plain(points, digits, S)
    from . import _cuda_build as cb

    tbl = torch.empty((B, n, TABLE_S - 1, ENTRY), dtype=torch.int64,
                      device=points.device)
    pre = torch.empty_like(tbl)
    acc = torch.empty((B, nw, S, ROW), dtype=torch.int64,
                      device=points.device)
    cb.check(cb.lib().vmpc_cu_bn2_msm_accum(
        points.data_ptr(), tbl.data_ptr(), pre.data_ptr(), digits.data_ptr(),
        acc.data_ptr(), B, n, nw, S, table_threads(B * n, points.device),
        mc._stream(points)), "bn2_msm_accumulate")
    mc.LAUNCHES["bn2_msm_accumulate"] += 1
    return acc


def table_threads(rows: int, dev: torch.device) -> int:
    """The thread count G of K9's normalization launch for ``rows`` points:
    one wave (``msm_cuda.one_wave``) of at most TABLE_SM_THREADS an SM;
    thread g normalizes the entries of the points g, g + G, g + 2G, ...
    with one inversion."""
    from . import _cuda_build as cb

    return mc.one_wave(rows, min(cb.lib().vmpc_cu_bn2_table_resident(),
                                 TABLE_SM_THREADS), dev)


def tail_split(S: int) -> int:
    """K10's chunk count R a window: 4 (256 reduce blocks at nw = 64, one
    wave; 1, 2, 4 and 8 measured on the H100 at S = 2048 and 4096,
    PERF.md), fewer where a chunk would hold fewer accumulators than a
    reduce block has threads."""
    return max(1, min(4, S // TAIL_REDUCE_THREADS))


def msm_tail(acc: torch.Tensor) -> torch.Tensor:
    """K10: accumulators [B, nw, S, 24] -> [B, 24] normalized rows of
    sum_w 16^(nw-1-w) sum_s acc[w, s]: a reduce launch into R chunks a
    window (:func:`tail_split`), then one block a batch combines them.
    CPU: :func:`msm_tail_plain`."""
    mc._check_rows(acc, "acc", 4, ROW)
    B, nw, S, _ = acc.shape
    if not 0 < nw <= mc.NWINDOWS or not S:
        raise ValueError(f"window count {nw} / slice count {S}")
    if mc._same_device(acc).type == "cpu":
        return msm_tail_plain(acc)
    from . import _cuda_build as cb

    R = tail_split(S)
    part = torch.empty((B, nw, R, ROW), dtype=torch.int64, device=acc.device)
    out = torch.empty((B, ROW), dtype=torch.int64, device=acc.device)
    cb.check(cb.lib().vmpc_cu_bn2_msm_tail(
        acc.data_ptr(), part.data_ptr(), out.data_ptr(), B, nw, S, R,
        mc._stream(acc)), "bn2_msm_tail")
    mc.LAUNCHES["bn2_msm_tail"] += 1
    return out


def msm_slices(n: int) -> int:
    """K9's slice count for n points (ACCUM_POINTS_PER_THREAD a thread)."""
    return mc.slices_for(n, ACCUM_POINTS_PER_THREAD)


def msm_rows(points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """sum_i d_i * P_i for B independent MSMs -> [B, 24] normalized rows
    (K9 then K10)."""
    return msm_tail(msm_accumulate(points, digits,
                                   msm_slices(points.shape[1])))


def bexp_rows(table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """base^e_i for a shared base by its fixed-base comb: table [nw*9, 24]
    input rows (row w*9 + m = m * 16^(nw-1-w) * base, :func:`bexp_table`),
    digits [nw/2, n] packed signed windows of the exponents -> [n, 24]
    normalized rows.  CUDA: K11; CPU: :func:`bexp_plain`."""
    mc._check_rows(table, "table", 2, ROW)
    nw = table.shape[0] // TABLE_S
    if nw * TABLE_S != table.shape[0] or nw % 2 or not 0 < nw <= mc.NWINDOWS:
        raise ValueError(f"comb table of {table.shape[0]} rows")
    mc._check_digits(digits, "digits", (nw // 2, digits.shape[-1]))
    if not digits.shape[1]:
        raise ValueError("no exponents")
    if mc._same_device(table, digits).type == "cpu":
        return bexp_plain(table, digits)
    from . import _cuda_build as cb

    n = digits.shape[1]
    work = torch.empty_like(table)
    pre = torch.empty((n, 8), dtype=torch.int64, device=table.device)
    out = torch.empty((n, ROW), dtype=torch.int64, device=table.device)
    cb.check(cb.lib().vmpc_cu_bn2_bexp(
        table.data_ptr(), work.data_ptr(), digits.data_ptr(), n, nw,
        bexp_threads(n, table.device), pre.data_ptr(), out.data_ptr(),
        mc._stream(table)), "bn2_bexp")
    mc.LAUNCHES["bn2_bexp"] += 1
    return out


def bexp_threads(n: int, dev: torch.device) -> int:
    """K11's thread count G for n exponents: one wave
    (``msm_cuda.one_wave``); thread g sums the exponents g, g + G, g + 2G,
    ... and normalizes them with one inversion."""
    from . import _cuda_build as cb

    return mc.one_wave(n, cb.lib().vmpc_cu_bn2_bexp_resident(), dev)


def fold_rows(gl: torch.Tensor, gr: torch.Tensor,
              cdigits: np.ndarray) -> torch.Tensor:
    """[gl_i^c * gr_i] as normalized rows; ``cdigits``: the width-5 NAF of
    c mod the BN order, most significant first (``msm_cuda.fold_digits(c,
    ORDER)``).  CUDA: K12, G = ``msm_cuda.fold_threads`` threads, thread g
    folding the elements g, g + G, ... and normalizing them with one
    inversion; CPU: :func:`fold_plain`."""
    mc._check_rows(gl, "gl", 2, ROW)
    mc._check_rows(gr, "gr", 2, ROW)
    if gl.shape != gr.shape or not gl.shape[0]:
        raise ValueError("gl and gr differ in shape or are empty")
    cdig = mc.check_fold_digits(cdigits)
    if mc._same_device(gl, gr).type == "cpu":
        return fold_plain(gl, gr, cdig)
    from . import _cuda_build as cb

    n = gl.shape[0]
    pre = torch.empty((n, 8), dtype=torch.int64, device=gl.device)
    out = torch.empty((n, ROW), dtype=torch.int64, device=gl.device)
    cb.check(cb.lib().vmpc_cu_bn2_fold_norm(
        gl.data_ptr(), gr.data_ptr(), cdig.ctypes.data, len(cdig),
        mc.fold_threads(n, gl.device, "bn2_fold"), pre.data_ptr(),
        out.data_ptr(), n, mc._stream(gl)), "bn2_fold")
    mc.LAUNCHES["bn2_fold"] += 1
    return out



# ---------------------------------------------------------------------------
# plain versions (tensor ops; the CPU path and the kernels' yardstick)
# ---------------------------------------------------------------------------


def _multiples(p):
    """[identity, p, 2p, ..., 8p] (working coordinates)."""
    tbl = [cb2.identity(p[0].shape[:-1], p[0].device), p]
    for _ in range(2, TABLE_S):
        tbl.append(cb2.add(tbl[-1], p))
    return tbl


def msm_accumulate_plain(points: torch.Tensor, digits: torch.Tensor,
                         S: int) -> torch.Tensor:
    """Plain version of K9: the working rows of each point's multiples
    0..8, the signed selection per (window, point), summed into the
    (window, slice) accumulators; points are taken in blocks of whole rows
    of S."""
    points = cb2.encode_jacobian_rows(points)
    B, n, _ = points.shape
    nw = 2 * digits.shape[1]
    dev = points.device
    J = -(-n // S)
    d = mc.unpack_digits(digits)  # [B, nw, n]
    if J * S > n:  # pad with identities and zero digits
        ident = torch.tensor(cb2.IDENTITY_MONT_ROW, dtype=torch.int64,
                             device=dev)
        points = torch.cat([points, ident.expand(B, J * S - n, ROW)], dim=1)
        d = torch.cat([d, d.new_zeros(B, nw, J * S - n)], dim=2)
    acc = cb2.identity((B, nw, S), dev)
    step = max(1, mc._PLAIN_BLOCK // (B * nw * S))
    for j0 in range(0, J, step):
        j1 = min(J, j0 + step)
        m = (j1 - j0) * S
        tbl = _multiples(cb2.split_rows(points[:, j0 * S : j1 * S]))
        db = d[:, :, j0 * S : j1 * S]  # [B, nw, m]
        idx = db.abs().transpose(1, 2)[..., None].expand(B, m, nw,
                                                         fp2.LIMBS)
        sel = tuple(torch.gather(torch.stack([t[c] for t in tbl], dim=2),
                                 2, idx).transpose(1, 2)
                    for c in range(cb2.COORDS))  # [B, nw, m, 32]
        sel = cb2.neg_where(db < 0, sel)
        part = mc._tree_sum(
            tuple(c.unflatten(2, (j1 - j0, S)) for c in sel), 2, cb2)
        acc = cb2.add(acc, part)
    return cb2.join_rows(acc)


def msm_tail_plain(acc: torch.Tensor) -> torch.Tensor:
    """Plain version of K10: sum the slices of each window, Horner over the
    windows, normalize."""
    nw = acc.shape[1]
    sums = mc._tree_sum(cb2.split_rows(acc), 2, cb2)  # [B, nw, 32]
    return cb2.normalize_rows(mc._horner(sums, nw, cb2))


def msm_plain(points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Plain version of K9 + K10."""
    return msm_tail_plain(
        msm_accumulate_plain(points, digits, msm_slices(points.shape[1])))


def bexp_plain(table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Plain version of K11: the comb of ``msm_cuda.bn_comb_plain`` over the
    twist."""
    return mc.bn_comb_plain(table, digits, cb2)


def fold_plain(gl: torch.Tensor, gr: torch.Tensor,
               cdig: np.ndarray) -> torch.Tensor:
    """Plain version of K12: the fold of ``msm_cuda.bn_fold_plain`` over
    the twist."""
    return mc.bn_fold_plain(gl, gr, cdig, cb2)


# ---------------------------------------------------------------------------
# point-level API (the dispatch backends)
# ---------------------------------------------------------------------------


def _digits(scalars):
    """Packed signed digits of scalars (ints, negative ones included, or
    field elements) reduced mod the BN order, and their window count."""
    from .. import native

    return mc.packed_digits(native._scalars_to_u64(list(scalars), ORDER),
                            ORDER)


def msm(points, scalars) -> BNTwistPoint:
    """prod points[i] ** scalars[i] on the twist through K9 + K10."""
    assert len(points) == len(scalars)
    dev = mc.current_device()
    pk, _nw = _digits(scalars)
    digits = torch.from_numpy(pk).to(dev)
    out = msm_rows(cb2.encode_points(points, dev)[None], digits[None])
    return cb2.decode_rows(out)[0]


def fold(g_l, g_r, c: int) -> list:
    """[g_l[i] ** c * g_r[i]] (normalized) through K12."""
    assert len(g_l) == len(g_r)
    cdig = mc.fold_digits(int(c), ORDER)
    dev = mc.current_device()
    out = fold_rows(cb2.encode_points(g_l, dev), cb2.encode_points(g_r, dev),
                    cdig)
    return cb2.decode_rows(out)


_COMB_TABLES = {}  # (repr of the normalized base, nw, device) -> table


def bexp_table(base, nw: int, device=None) -> torch.Tensor:
    """[nw*9, 24] input rows of the base's comb table, row w*9 + m = m *
    16^(nw-1-w) * base, affine, built by the C++ tier (4 (nw - 1)
    doublings, 7 nw adds, one batch inversion) and cached per base."""
    from .. import native

    return mc.bn_comb_table(_COMB_TABLES, base, nw, device,
                            native.bn2_comb_table)


def batch_exp(base, exponents) -> list:
    """[base ** e for e in exponents] (normalized) through K11."""
    dev = mc.current_device()
    pk, nw = _digits(exponents)
    out = bexp_rows(bexp_table(base, nw), torch.from_numpy(pk).to(dev))
    return cb2.decode_rows(out)
