"""Bucket-method (Pippenger) Ed25519 MSM on the GPU, 8-bit signed windows.

Counterpart of the JAX package's ``ops/msm_bucket.py``: signed radix-256
recoding (``_scalar_digits_signed8``), the bucket layout
(``_bucket_layout``), ``msm`` and ``register``.  Each point costs one add
per nonzero window digit (32 per point at full width) instead of the
windowed MSM's table and per-window selection; the points are gathered
into (window, bucket) columns by a compact layout: the nonzero digits'
point indices, sorted by column, and the columns' offsets
(:func:`compact_layout`).  The device work is two kernels hand-written in
CUDA:

=====  ===================  ==============================================
K13    bucket_accumulate    (window, bucket) column sums of the gathered,
                            sign-flipped points, the same number of
                            entries a thread, crossing columns combined by
                            a tree (B6, ``csrc/bucket_accum.cu``)
K14    bucket_reduce        per window sum_b (b+1) B_b as a suffix scan and
                            a lane sum on lane groups, then K2's
                            combination with 8-bit windows, normalize (B7,
                            ``csrc/bucket_reduce.cu``)
=====  ===================  ==============================================

Each wrapper launches its kernel for a CUDA tensor and counts the launch
in ``msm_cuda.LAUNCHES``; for a CPU tensor it runs the plain PyTorch
version beside it (:func:`bucket_accumulate_plain`,
:func:`bucket_reduce_plain`).  The layout is tensor code that runs where
its digits lie, so on the card the entry list never crosses the bus.
:func:`bucket_layout`, the JAX package's padded ``[nw, D, lanes]`` form,
stays for the tests that hold the recoding against the JAX package; no
MSM builds it.

As in the JAX package the backend is opt-in: ``enable_gpu()`` does not
install it, :func:`register` does, for synchronous MSMs only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..groups.edwards import ELL, EdwardsPoint
from . import curve_ed as ced
from . import dispatch
from . import msm_cuda as mc

WINDOW8 = 8
NW8 = 32  # 256 / 8
LANES = 128  # bucket magnitudes 1..128
ACCUM_ENTRIES = 64  # K13: entries of the flat list one thread sums
_SIGN = -(1 << 31)  # an entry's top bit: its digit is negative
_INDEX = (1 << 31) - 1


# ---------------------------------------------------------------------------
# recoding and layout
# ---------------------------------------------------------------------------


_FLIP = -(1 << 63)  # u64 order as int64 order: flip the top bit


def _u64_as_i64(v: int) -> int:
    return v - (1 << 64) if v >> 63 else v


def digits_signed8(rows: torch.Tensor, order: int = ELL) -> torch.Tensor:
    """[m, 4] int64 tensor (the u64 bit patterns of canonical residues, as
    ``msm_cuda.scalars_to_u64x4`` gives them) -> [NW8, m] int32 signed
    radix-256 digits, most significant window first, on the rows' device.

    Equal to the JAX package's ``_scalar_digits_signed8``: the bytes of the
    balanced value |s| <= order / 2 (order - s for s above order / 2), a
    digit above 128 borrowing 256 from the next window, every digit of a
    balanced-negative scalar negated.  Digits lie in [-127, 128] before
    that negation, so a negated column can carry -128.  Tensor code: on
    the card the u64 rows are what crosses the bus."""
    dev = rows.device
    m = rows.shape[0]
    limbs = lambda v: [_u64_as_i64((v >> (64 * j)) & ((1 << 64) - 1))  # noqa: E731
                       for j in range(4)]
    a = rows ^ _FLIP
    h = torch.tensor(limbs(order // 2), dtype=torch.int64, device=dev) ^ _FLIP
    o = torch.tensor(limbs(order), dtype=torch.int64, device=dev)
    neg = torch.zeros(m, dtype=torch.bool, device=dev)
    tie = torch.ones_like(neg)
    for j in (3, 2, 1, 0):  # s > order // 2, from the top limb
        neg |= tie & (a[:, j] > h[j])
        tie &= a[:, j] == h[j]
    # order - s limb by limb (int64 wraps as u64 does); a borrow where
    # s_j > o_j, or s_j == o_j with a borrow in
    bal = torch.empty_like(rows)
    borrow = torch.zeros(m, dtype=torch.int64, device=dev)
    for j in range(4):
        sub = o[j] - rows[:, j] - borrow
        borrow = ((a[:, j] > (o[j] ^ _FLIP))
                  | ((rows[:, j] == o[j]) & (borrow == 1))).long()
        bal[:, j] = torch.where(neg, sub, rows[:, j])
    shifts = torch.arange(0, 64, 8, device=dev)
    by = ((bal[:, :, None] >> shifts) & 255).reshape(m, 32).T.int()
    by = by.contiguous()
    out = torch.empty((NW8, m), dtype=torch.int32, device=dev)
    carry = torch.zeros(m, dtype=torch.int32, device=dev)
    for w in range(NW8):  # least significant first
        d = by[w] + carry
        carry = (d > LANES).int()
        out[NW8 - 1 - w] = d - 256 * carry
    if bool(carry.any()):
        raise ValueError("scalar overflow in signed radix-256 recoding")
    return out * (1 - 2 * neg.int())


def _u64_rows(scalars, order: int, device) -> torch.Tensor:
    """[n, 4] int64 tensor of the scalars' canonical residues (one C
    conversion pass on the host) on ``device``."""
    arr = mc.scalars_to_u64x4(list(scalars), order)
    return torch.from_numpy(arr.view(np.int64).copy()).to(device)


def scalar_digits_signed8(scalars, order: int = ELL) -> np.ndarray:
    """[N] ints or field elements -> [NW8, N] int32 digits (numpy), the
    counterpart of ``_scalar_digits_signed8``: one C conversion pass, then
    :func:`digits_signed8` on the CPU."""
    return digits_signed8(_u64_rows(scalars, order, "cpu"), order).numpy()


def bucket_layout(digits, dt: int, lanes: int = LANES):
    """Signed digits [NW, n] (array or tensor) -> (perm, sgn, D), perm and
    sgn int32 tensors [NW, D, lanes] on the digits' device.

    Column b of window w lists in rows 0..count-1 the indices of the points
    whose digit magnitude is b + 1, in index order (a stable sort); -1 marks
    padding, and sgn is 1 where the digit is negative.  D is the deepest
    column (at least 1) rounded up to a multiple of ``dt``.  Element for
    element the arrays of the JAX package's ``_bucket_layout``."""
    d = torch.as_tensor(digits).to(torch.int32)
    nw, n = d.shape
    dev = d.device
    mags = d.abs()
    if n and int(mags.max()) > lanes:
        raise ValueError("digit magnitude exceeds the bucket range")
    ms, order_idx = torch.sort(mags, dim=1, stable=True)  # [nw, n]
    # each magnitude's first index in the sorted rows (no atomics: most
    # digits of the top window share nine buckets)
    vals = torch.arange(lanes + 2, dtype=ms.dtype, device=dev)
    bounds = torch.searchsorted(ms, vals.expand(nw, -1).contiguous())
    dmax = max(1, int((bounds[:, 2:] - bounds[:, 1:-1]).max()))
    D = -(-dmax // dt) * dt
    ms = ms.long()
    pos = torch.arange(n, device=dev)[None] - torch.gather(bounds, 1, ms)
    nz = ms > 0
    # zero digits go to an extra column (row 0) that is cut off at the end
    col = torch.where(nz, ms - 1, lanes)
    row = torch.where(nz, pos, 0)
    w_idx = torch.arange(nw, device=dev)[:, None]
    flat = ((w_idx * D + row) * (lanes + 1) + col).reshape(-1)
    perm = torch.full((nw * D * (lanes + 1),), -1, dtype=torch.int32,
                      device=dev)
    sgn = torch.zeros_like(perm)
    perm.scatter_(0, flat, order_idx.to(torch.int32).reshape(-1))
    sgn.scatter_(0, flat, (torch.gather(d, 1, order_idx) < 0).to(torch.int32)
                 .reshape(-1))
    shape = (nw, D, lanes + 1)
    perm = perm.view(shape)[..., :lanes].contiguous()
    sgn = sgn.view(shape)[..., :lanes].contiguous()
    return perm, sgn, D


def compact_layout(digits, lanes: int = LANES):
    """Signed digits [NW, n] (array or tensor) -> (entries, offsets, count)
    on the digits' device, the layout K13 reads.

    ``entries`` int32 [count]: for each window (most significant first)
    the indices of the points whose digit is nonzero, in (bucket, index)
    order (bucket b holds magnitude b + 1; a stable sort), an index with
    its top bit set (the entry negative) where the digit is negative.
    ``offsets`` int32 [NW * lanes + 1]: column c = w * lanes + b holds the
    entries offsets[c] .. offsets[c + 1] - 1.  ``count``: the number of
    nonzero digits.  Expanded to the padded form it is, element for
    element, :func:`bucket_layout`'s (the JAX package's
    ``_bucket_layout``) without its padding: no array is sized by the
    deepest column.  Tensor code: the stable sort and ``searchsorted`` of
    :func:`bucket_layout`, then one boolean selection."""
    d = torch.as_tensor(digits).to(torch.int32)
    nw, n = d.shape
    dev = d.device
    mags = d.abs()
    if n and int(mags.max()) > lanes:
        raise ValueError("digit magnitude exceeds the bucket range")
    ms, order_idx = torch.sort(mags, dim=1, stable=True)  # [nw, n]
    # each magnitude's first index in the sorted rows
    vals = torch.arange(1, lanes + 2, dtype=ms.dtype, device=dev)
    bounds = torch.searchsorted(ms, vals.expand(nw, -1).contiguous())
    offsets = torch.zeros(nw * lanes + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum((bounds[:, 1:] - bounds[:, :-1]).reshape(-1),
                               0)
    idx = order_idx.to(torch.int32)
    neg = torch.gather(d, 1, order_idx) < 0
    entries = torch.where(neg, idx | _SIGN, idx)[ms > 0]
    return entries, offsets, entries.numel()


def trim_windows(digits):
    """Drop the all-zero leading (most significant) windows of digits
    [NW8, n] (array or tensor): the exact window count, at least 1 (the
    TPU's {4, 32} choice only served its compile cache)."""
    nz = torch.nonzero(torch.as_tensor(digits).any(dim=1))
    nw = NW8 - int(nz[0, 0]) if nz.numel() else 1
    return digits[NW8 - nw :]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_layout(entries: torch.Tensor, offsets: torch.Tensor, lanes: int,
                  n: int):
    """The compact layout's types and shapes, then (one read from the
    device) offsets monotone from 0 to the entry count and every entry's
    index below n."""
    for t, name in ((entries, "entries"), (offsets, "offsets")):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name}: expected int32 [m], got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if not 0 < lanes <= LANES:
        raise ValueError(f"{lanes} buckets a window, not 1..{LANES}")
    cols = offsets.numel() - 1
    if cols < lanes or cols % lanes:
        raise ValueError(f"offsets: {cols + 1} entries, not nw * {lanes} + 1")
    start, end, down, index = torch.stack([
        offsets[0] != 0, offsets[-1] != entries.numel(),
        (offsets[1:] < offsets[:-1]).any(),
        ((entries & _INDEX) >= n).any()]).tolist()
    if start or end or down:
        raise ValueError("offsets: not monotone from 0 to the entry count")
    if index:
        raise ValueError("entries index past the points")


def bucket_accumulate(points: torch.Tensor, entries: torch.Tensor,
                      offsets: torch.Tensor, lanes: int = LANES
                      ) -> torch.Tensor:
    """K13: bucket sums [nw, lanes, 16] (extended rows, not normalized) over
    the compact layout (:func:`compact_layout`; nw = (offsets.numel() - 1)
    / lanes): column c adds the points of its entries, negated where an
    entry is negative.  points [n, 16] rows.  CPU:
    :func:`bucket_accumulate_plain`."""
    mc._check_rows(points, "points", 2)
    _check_layout(entries, offsets, lanes, points.shape[0])
    if mc._same_device(points, entries, offsets).type == "cpu":
        return bucket_accumulate_plain(points, entries, offsets, lanes)
    from . import _cuda_build as cb

    n = points.shape[0]
    count = entries.numel()
    nw = (offsets.numel() - 1) // lanes
    dev = points.device
    pre = torch.empty_like(points)
    part = torch.empty((-(-count // ACCUM_ENTRIES), 2, 16), dtype=torch.int64,
                       device=dev)
    out = torch.empty((nw, lanes, 16), dtype=torch.int64, device=dev)
    cb.check(cb.lib().vmpc_cu_bucket_accum(
        points.data_ptr(), pre.data_ptr(), entries.data_ptr(),
        offsets.data_ptr(), part.data_ptr(), out.data_ptr(), n, nw, lanes,
        count, ACCUM_ENTRIES, mc._stream(points)), "bucket_accumulate")
    mc.LAUNCHES["bucket_accumulate"] += 1
    return out


def bucket_reduce(buckets: torch.Tensor) -> torch.Tensor:
    """K14: bucket sums [nw, lanes, 16] (column b holding magnitude b + 1,
    windows most significant first) -> [1, 16] canonical row of
    sum_w 2^(8 (nw-1-w)) sum_b (b+1) B[w, b].  CPU:
    :func:`bucket_reduce_plain`."""
    mc._check_rows(buckets, "buckets", 3)
    nw, lanes, _ = buckets.shape
    if not 0 < lanes <= LANES or not 0 < nw <= NW8:
        raise ValueError(f"{nw} windows of {lanes} buckets")
    if mc._same_device(buckets).type == "cpu":
        return bucket_reduce_plain(buckets)
    from . import _cuda_build as cb

    dev = buckets.device
    wsum = torch.empty((nw, 16), dtype=torch.int64, device=dev)
    out = torch.empty((1, 16), dtype=torch.int64, device=dev)
    cb.check(cb.lib().vmpc_cu_bucket_reduce(
        buckets.data_ptr(), wsum.data_ptr(), out.data_ptr(), nw, lanes,
        mc._stream(buckets)), "bucket_reduce")
    mc.LAUNCHES["bucket_reduce"] += 1
    return out


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def bucket_accumulate_plain(points: torch.Tensor, entries: torch.Tensor,
                            offsets: torch.Tensor, lanes: int = LANES
                            ) -> torch.Tensor:
    """Plain version of K13: every entry (already in column order) as its
    point's precomputed form, sign-flipped and made extended by a mixed add
    to the identity; then a segmented tree sum, each round adding
    neighbours within a column, until one point a column is left; empty
    columns the identity."""
    cols = offsets.numel() - 1
    nw = cols // lanes
    dev = points.device
    cnt = (offsets[1:] - offsets[:-1]).long()
    col = torch.repeat_interleave(torch.arange(cols, device=dev), cnt)
    idx = (entries & _INDEX).long()
    neg = entries < 0
    rank = torch.arange(col.numel(), device=dev) - offsets[:-1].long()[col]
    pre = ced.to_pre(ced.split_rows(points))
    x = _blocked(lambda i: ced.add_pre(
        ced.identity(i.shape, dev),
        ced.neg_where_pre(neg[i], tuple(c[idx[i]] for c in pre))),
        col.numel(), dev)
    while col.numel() and int(rank.max()) > 0:
        left = torch.nonzero(rank % 2 == 0).squeeze(1)
        pair = left[rank[left] + 1 < cnt[col[left]]]
        x = tuple(c[left] for c in x) if not pair.numel() else _pair_sums(
            x, left, pair)
        col, rank = col[left], rank[left] // 2
        cnt = (cnt + 1) // 2
    acc = tuple(c.contiguous().clone() for c in ced.identity((cols,), dev))
    for a, v in zip(acc, x):
        a[col] = v
    return ced.join_rows_relaxed(tuple(c.view(nw, lanes, 16) for c in acc))


def _blocked(fn, m: int, dev):
    """fn over the index ranges of m entries, _PLAIN_BLOCK at a time,
    concatenated (bounds the plain versions' temporaries)."""
    parts = [fn(torch.arange(i, min(m, i + mc._PLAIN_BLOCK), device=dev))
             for i in range(0, m, mc._PLAIN_BLOCK)]
    if not parts:
        return ced.identity((0,), dev)
    return tuple(torch.cat(c) for c in zip(*parts))


def _pair_sums(x, left, pair):
    """x at the ``left`` positions, where ``pair`` (a subset of them) also
    adds its right neighbour."""
    out = tuple(c[left] for c in x)
    where = torch.searchsorted(left, pair)
    s = _blocked(lambda i: ced.add(tuple(c[pair[i]] for c in x),
                                   tuple(c[pair[i] + 1] for c in x)),
                 pair.numel(), left.device)
    for o, v in zip(out, s):
        o[where] = v
    return out


def bucket_reduce_plain(buckets: torch.Tensor) -> torch.Tensor:
    """Plain version of K14: the inclusive suffix scan over each window's
    buckets (Hillis-Steele, the identity shifted in), the sum over the
    buckets, Horner with 8 doublings a window, normalize."""
    nw, lanes, _ = buckets.shape
    x = ced.split_rows(buckets)  # 4 x [nw, lanes, 16]
    shift = 1
    while shift < lanes:
        pad = ced.identity((nw, shift), buckets.device)
        rolled = tuple(torch.cat([c[:, shift:], p], dim=1)
                       for c, p in zip(x, pad))
        x = ced.add(x, rolled)
        shift *= 2
    sums = mc._tree_sum(x, 1)  # 4 x [nw, 16]
    h = mc._horner(tuple(c[None] for c in sums), nw, bits=WINDOW8)
    return ced.normalize_rows(h)


# ---------------------------------------------------------------------------
# point-level API (the dispatch backend)
# ---------------------------------------------------------------------------


def layout_for(scalars, dt: int = 8, lanes: int = LANES, device=None):
    """The scalars' u64 rows (one C pass on the host), then the recoding,
    the window trim and the compact layout on ``device`` (by default the
    one ``enable_gpu`` chose; before it this raises): (entries, offsets,
    count) of :func:`compact_layout`, or None when every scalar is 0 mod
    the order.  ``dt`` is the JAX package's depth tile; the compact layout
    has no depth to round, so it is not used."""
    rows = _u64_rows(scalars, ELL, mc.current_device(device))
    digits = trim_windows(digits_signed8(rows))
    if not bool(digits.any()):
        return None
    return compact_layout(digits, lanes)


def msm(points, scalars, dt: int = 8, lanes: int = LANES) -> EdwardsPoint:
    """prod points[i] ** scalars[i] (Ed25519) through K13 + K14, on the
    device ``enable_gpu`` chose (before it this raises).  ``dt`` and
    ``lanes`` are the JAX package's parameters: the compact layout does not
    use ``dt``, and ``lanes`` below 128 only serves the tests' small
    layouts."""
    assert len(points) == len(scalars)
    lay = layout_for(scalars, dt, lanes)
    if lay is None:
        return EdwardsPoint.identity
    entries, offsets, _count = lay
    buckets = bucket_accumulate(mc._device_points(points), entries, offsets,
                                lanes)
    return ced.decode_rows(bucket_reduce(buckets))[0]


def register(min_batch: int = 4096, dt: int = 8):
    """Install the bucket MSM for synchronous Ed25519 MSMs of at least
    ``min_batch`` points; smaller ones stay on the backend installed before
    (after ``enable_gpu()``, K1 + K2 tiered with the C++ tier).  The async
    MSM backend is left as it is, as in the JAX package.  The MSMs run on
    the device ``enable_gpu`` chose: before it this raises.  ``dt`` is the
    JAX package's depth tile, passed on to :func:`msm`; the compact layout
    does not use it."""
    mc.current_device()
    windowed = dispatch._MSM_BACKENDS.get(EdwardsPoint)

    def backend(pts, sc):
        if len(pts) >= min_batch:
            return msm(pts, sc, dt=dt)
        if windowed is not None:
            return windowed[0](pts, sc)
        return dispatch._host_multiexp(pts, sc)

    dispatch.register_msm_backend(
        EdwardsPoint, backend, windowed[1] if windowed else min_batch
    )
