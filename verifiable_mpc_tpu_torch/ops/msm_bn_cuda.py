"""BN256 G1 MSM, generator fold and fixed-base comb on the GPU.

Counterpart of the JAX package's ``ops/bn_pallas.py`` (``msm``, ``fold``,
``batch_exp_comb``, ``register``): the curve-generic kernels of
``ops/msm_pallas.py`` with the BN adapter.  The device work is four kernels
hand-written in CUDA (``csrc/bn_*.cu``, one source each, over
``csrc/fp254.cuh`` and ``csrc/bn254_kernels.cuh``):

=====  =====================  ==========================================
K5     bn_msm_accumulate      4-bit signed-window accumulation (B1, BN)
K6     bn_msm_tail            window reduction + split Horner + normalize (B2)
K7     bn_fold                g_l^c * g_r + batch normalize (B3, BN)
K8     bn_comb                fixed-base comb + batch normalize (B5, BN)
=====  =====================  ==========================================

Each wrapper (:func:`msm_rows`, :func:`fold_rows`, :func:`comb_rows`)
launches its kernels for a CUDA tensor and counts the launch in
``msm_cuda.LAUNCHES``; for a CPU tensor it runs the plain PyTorch version
beside it (:func:`msm_plain`, :func:`fold_plain`, :func:`comb_plain`).  A
CUDA tensor never reaches a plain version, and a failed build or launch
raises.

Points travel as ``[n, 12]`` int64 input rows (``ops/curve_bn.py``):
jacobian, standard form, as ``native._bn_pts_to_u64`` gives them.  K5 and
K8 turn them into working rows (projective, Montgomery form) in a first
launch, K7 as each thread loads them, and every result leaves the kernels
normalized in standard form, the identity as exactly
``BNPoint.identity``'s (1, 1, 0), which is an input row again.  Scalars
are recoded against the BN group order (``bn256.ORDER``), never the
Ed25519 default of the shared digit helpers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..groups.bn256 import ORDER, BNPoint
from . import curve_bn as cbn
from . import msm_cuda as mc

TABLE_S = mc.TABLE_S  # signed-digit table 0..8
ROW = cbn.ROW
# K6 (csrc/bn_msm_tail.cu): the window groups of the combination
# (TAIL_GROUPS there), and the adds a thread of its reduce makes before
# its tree (msm_cuda.tail_split)
TAIL_GROUPS = 8
TAIL_ADDS = 8


# ---------------------------------------------------------------------------
# kernel wrappers (tensor level)
# ---------------------------------------------------------------------------


def msm_accumulate(points: torch.Tensor, digits: torch.Tensor,
                   S: int) -> torch.Tensor:
    """K5: window accumulators [B, nw, S, 12] (working rows, not
    normalized) of B MSMs; slice s holds points s, s + S, s + 2S, ...
    points [B, n, 12] input rows, digits [B, nw/2, n] packed signed
    windows.

    Allocates the accumulators and a scratch table [B, n, 8, 12] (each
    point's multiples 1..8 as working rows, 768 bytes a point: 100 MB at
    n = 2^17), which the first of K5's two launches fills from the input
    rows and the second reads, one entry per (window, point).
    CPU: :func:`msm_accumulate_plain`."""
    mc._check_rows(points, "points", 3, ROW)
    B, n, _ = points.shape
    mc._check_digits(digits, "digits", (B, digits.shape[1], n))
    nw = 2 * digits.shape[1]
    if not 0 < nw <= mc.NWINDOWS or not 0 < S:
        raise ValueError(f"window count {nw} / slice count {S}")
    if mc._same_device(points, digits).type == "cpu":
        return msm_accumulate_plain(points, digits, S)
    from . import _cuda_build as cb

    tbl = torch.empty((B, n, TABLE_S - 1, ROW), dtype=torch.int64,
                      device=points.device)
    acc = torch.empty((B, nw, S, ROW), dtype=torch.int64,
                      device=points.device)
    cb.check(cb.lib().vmpc_cu_bn_msm_accum(
        points.data_ptr(), tbl.data_ptr(), digits.data_ptr(),
        acc.data_ptr(), B, n, nw, S, mc._stream(points)),
        "bn_msm_accumulate")
    mc.LAUNCHES["bn_msm_accumulate"] += 1
    return acc


def msm_tail(acc: torch.Tensor) -> torch.Tensor:
    """K6: accumulators [B, nw, S, 12] -> [B, 12] normalized rows of
    sum_w 16^(nw-1-w) sum_s acc[w, s]: a reduce launch into R chunks a
    window (``msm_cuda.tail_split``), then one block a batch combines
    them.  CPU: :func:`msm_tail_plain`."""
    mc._check_rows(acc, "acc", 4, ROW)
    B, nw, S, _ = acc.shape
    if not 0 < nw <= mc.NWINDOWS or not S:
        raise ValueError(f"window count {nw} / slice count {S}")
    if mc._same_device(acc).type == "cpu":
        return msm_tail_plain(acc)
    from . import _cuda_build as cb

    R = mc.tail_split(S, TAIL_ADDS)
    part = torch.empty((B, nw, R, ROW), dtype=torch.int64, device=acc.device)
    out = torch.empty((B, ROW), dtype=torch.int64, device=acc.device)
    cb.check(cb.lib().vmpc_cu_bn_msm_tail(
        acc.data_ptr(), part.data_ptr(), out.data_ptr(), B, nw, S, R,
        mc._stream(acc)), "bn_msm_tail")
    mc.LAUNCHES["bn_msm_tail"] += 1
    return out


def msm_rows(points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """sum_i d_i * P_i for B independent MSMs -> [B, 12] normalized rows
    (K5 then K6)."""
    return msm_tail(msm_accumulate(points, digits, mc.slices_for(
        points.shape[1], mc.ACCUM_POINTS_PER_THREAD)))


def fold_rows(gl: torch.Tensor, gr: torch.Tensor,
              cdigits: np.ndarray) -> torch.Tensor:
    """[gl_i^c * gr_i] as normalized rows; ``cdigits``: the width-5 NAF of
    c mod the BN order, most significant first (``msm_cuda.fold_digits(c,
    ORDER)``).  CUDA: K7, G = ``msm_cuda.fold_threads`` threads, thread g
    folding the elements g, g + G, ... and normalizing them with one
    inversion; CPU: :func:`fold_plain`."""
    mc._check_rows(gl, "gl", 2, ROW)
    mc._check_rows(gr, "gr", 2, ROW)
    if gl.shape != gr.shape:
        raise ValueError("gl and gr differ in shape")
    cdig = mc.check_fold_digits(cdigits)
    if mc._same_device(gl, gr).type == "cpu":
        return fold_plain(gl, gr, cdig)
    from . import _cuda_build as cb

    n = gl.shape[0]
    out = torch.empty((n, ROW), dtype=torch.int64, device=gl.device)
    if not n:
        return out
    pre = torch.empty((n, 4), dtype=torch.int64, device=gl.device)
    cb.check(cb.lib().vmpc_cu_bn_fold_norm(
        gl.data_ptr(), gr.data_ptr(), cdig.ctypes.data, len(cdig),
        mc.fold_threads(n, gl.device, "bn_fold"), pre.data_ptr(),
        out.data_ptr(), n, mc._stream(gl)), "bn_fold")
    mc.LAUNCHES["bn_fold"] += 1
    return out



def comb_rows(table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Fixed-base comb: table [nw*9, 12] input rows (row w*9+m = m *
    16^(nw-1-w) * base, :func:`comb_table`), digits [nw/2, n] packed ->
    [n, 12] normalized rows.  CUDA: K8; CPU: :func:`comb_plain`."""
    mc._check_rows(table, "table", 2, ROW)
    nw = table.shape[0] // TABLE_S
    if nw * TABLE_S != table.shape[0] or nw % 2 or not 0 < nw <= mc.NWINDOWS:
        raise ValueError(f"comb table of {table.shape[0]} rows")
    mc._check_digits(digits, "digits", (nw // 2, digits.shape[-1]))
    if mc._same_device(table, digits).type == "cpu":
        return comb_plain(table, digits)
    from . import _cuda_build as cb

    n = digits.shape[1]
    work = torch.empty_like(table)
    pre = torch.empty((n, 4), dtype=torch.int64, device=table.device)
    out = torch.empty((n, ROW), dtype=torch.int64, device=table.device)
    cb.check(cb.lib().vmpc_cu_bn_comb_norm(
        table.data_ptr(), work.data_ptr(), digits.data_ptr(), n, nw,
        comb_threads(n, table.device), pre.data_ptr(), out.data_ptr(),
        mc._stream(table)), "bn_comb")
    mc.LAUNCHES["bn_comb"] += 1
    return out


def comb_threads(n: int, dev: torch.device) -> int:
    """K8's thread count G for n exponents: one wave
    (``msm_cuda.one_wave``); thread g sums the exponents g, g + G, g + 2G,
    ... and normalizes them with one inversion."""
    from . import _cuda_build as cb

    return mc.one_wave(n, cb.lib().vmpc_cu_bn_comb_resident(), dev)


# ---------------------------------------------------------------------------
# plain versions (tensor ops; the CPU path and the kernels' yardstick)
# ---------------------------------------------------------------------------


def _stack_points(pts, dim: int):
    return tuple(torch.stack([p[c] for p in pts], dim=dim) for c in range(3))


def msm_accumulate_plain(points: torch.Tensor, digits: torch.Tensor,
                         S: int) -> torch.Tensor:
    """Plain version of K5: the working rows of the points, the 0..8
    table of each point, the signed selection per (window, point), summed
    into the (window, slice) accumulators; points are taken in blocks of
    whole rows of S."""
    points = cbn.encode_jacobian_rows(points)
    B, n, _ = points.shape
    nw = 2 * digits.shape[1]
    dev = points.device
    J = -(-n // S)
    d = mc.unpack_digits(digits)  # [B, nw, n]
    if J * S > n:  # pad with identities and zero digits
        ident = torch.tensor(cbn.IDENTITY_MONT_ROW, dtype=torch.int64,
                             device=dev)
        points = torch.cat([points, ident.expand(B, J * S - n, ROW)], dim=1)
        d = torch.cat([d, d.new_zeros(B, nw, J * S - n)], dim=2)
    acc = cbn.identity((B, nw, S), dev)
    step = max(1, mc._PLAIN_BLOCK // (B * nw * S))
    for j0 in range(0, J, step):
        j1 = min(J, j0 + step)
        m = (j1 - j0) * S
        p = cbn.split_rows(points[:, j0 * S : j1 * S])  # [B, m, 16] each
        tbl = [cbn.identity((B, m), dev), p]
        for _ in range(2, TABLE_S):
            tbl.append(cbn.add(tbl[-1], p))
        db = d[:, :, j0 * S : j1 * S]  # [B, nw, m]
        idx = db.abs().transpose(1, 2)[..., None].expand(B, m, nw, 16)
        stacked = _stack_points(tbl, 2)  # [B, m, 9, 16]
        sel = tuple(torch.gather(c, 2, idx).transpose(1, 2)
                    for c in stacked)  # [B, nw, m, 16]
        sel = cbn.neg_where(db < 0, sel)
        part = mc._tree_sum(
            tuple(c.unflatten(2, (j1 - j0, S)) for c in sel), 2, cbn)
        acc = cbn.add(acc, part)
    return cbn.join_rows(acc)


def tail_spans(nw: int) -> list:
    """The windows [a, b) of K6's window groups: ceil(nw / TAIL_GROUPS)
    each, the last ones shorter or empty (``tail_span``)."""
    k = -(-nw // TAIL_GROUPS)
    return [(min(j * k, nw), min(j * k + k, nw)) for j in range(TAIL_GROUPS)]


def msm_tail_plain(acc: torch.Tensor, R: int = None) -> torch.Tensor:
    """Plain version of K6: each window's S slices summed in R chunks
    (``msm_cuda.tail_split``), the chunks' partials summed; a Horner over
    each window group (:func:`tail_spans`); the groups' sums shifted and
    added (16^(nw - b) H for the group ending at b); normalize."""
    B, nw, S, _ = acc.shape
    dev = acc.device
    R = R or mc.tail_split(S, TAIL_ADDS)
    chunk = -(-S // R)
    p = cbn.split_rows(acc)
    if R * chunk > S:
        p = tuple(torch.cat([c, i], dim=2) for c, i in zip(
            p, cbn.identity((B, nw, R * chunk - S), dev)))
    part = mc._tree_sum(tuple(c.unflatten(2, (R, chunk)) for c in p), 3,
                        cbn)  # [B, nw, R]
    sums = mc._tree_sum(part, 2, cbn)  # [B, nw]
    spans = [(a, b) for a, b in tail_spans(nw) if a < b]
    k = spans[0][1]
    # each group's windows, led by identities up to k (no change to its sum)
    idx = torch.tensor([[nw] * (k - b + a) + list(range(a, b))
                        for a, b in spans], device=dev)
    ext = tuple(torch.cat([c, i], dim=1) for c, i in zip(
        sums, cbn.identity((B, 1), dev)))
    h = mc._horner(tuple(c[:, idx] for c in ext), k, cbn)  # [B, groups]
    out = tuple(c[:, 0] for c in h)
    for j in range(1, len(spans)):
        for _ in range(4 * (spans[j][1] - spans[j - 1][1])):
            out = cbn.dbl(out)
        out = cbn.add(out, tuple(c[:, j] for c in h))
    return cbn.normalize_rows(out)


def msm_plain(points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 + K6."""
    return msm_tail_plain(
        msm_accumulate_plain(points, digits, mc.slices_for(
            points.shape[1], mc.ACCUM_POINTS_PER_THREAD)))


def fold_plain(gl: torch.Tensor, gr: torch.Tensor,
               cdig: np.ndarray) -> torch.Tensor:
    """Plain version of K7: the fold of ``msm_cuda.bn_fold_plain`` over
    G1."""
    return mc.bn_fold_plain(gl, gr, cdig, cbn)


def comb_plain(table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: the comb of ``msm_cuda.bn_comb_plain`` over
    G1."""
    return mc.bn_comb_plain(table, digits, cbn)


# ---------------------------------------------------------------------------
# point-level API (the dispatch backends)
# ---------------------------------------------------------------------------


def _digits(scalars):
    """Packed signed digits of scalars (ints, negative ones included, or
    field elements) reduced mod the BN order, and their window count."""
    from .. import native

    return mc.packed_digits(native._scalars_to_u64(list(scalars), ORDER),
                            ORDER)


def msm(points, scalars) -> BNPoint:
    """prod points[i] ** scalars[i] (BN256 G1) through K5 + K6."""
    assert len(points) == len(scalars)
    dev = mc.current_device()
    pk, _nw = _digits(scalars)
    digits = torch.from_numpy(pk).to(dev)
    out = msm_rows(cbn.encode_points(points, dev)[None], digits[None])
    return cbn.decode_rows(out)[0]


def fold(g_l, g_r, c: int) -> list:
    """[g_l[i] ** c * g_r[i]] (normalized) through K7."""
    assert len(g_l) == len(g_r)
    cdig = mc.fold_digits(int(c), ORDER)
    dev = mc.current_device()
    out = fold_rows(cbn.encode_points(g_l, dev), cbn.encode_points(g_r, dev),
                    cdig)
    return cbn.decode_rows(out)


_COMB_TABLES = {}  # (repr of the normalized base, nw, device) -> table


def comb_table(base, nw: int, device=None) -> torch.Tensor:
    """[nw*9, 12] input rows of the base's comb table, row w*9 + m = m *
    16^(nw-1-w) * base, affine, built by the C++ tier (4 (nw - 1)
    doublings, 7 nw adds, one batch inversion) and cached per base."""
    from .. import native

    return mc.bn_comb_table(_COMB_TABLES, base, nw, device,
                            native.bn_comb_table)


def batch_exp_comb(base, exponents) -> list:
    """[base ** e for e in exponents] (normalized) through K8."""
    dev = mc.current_device()
    pk, nw = _digits(exponents)
    out = comb_rows(comb_table(base, nw), torch.from_numpy(pk).to(dev))
    return cbn.decode_rows(out)
