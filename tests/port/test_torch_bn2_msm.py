"""The plain versions of the port's BN256 twist (G2) MSM, batch-exp and
fold kernels (ops/msm_bn2_cuda.py) and its point encoding against the JAX
package: its host group law and its C++ tier (native.bn2_msm /
bn2_batch_exp), on the same seed-made points and scalars; malformed inputs
and enable_gpu's twist tiers.  Edge scalars (0, 1, order/2 +- 1, order -
2, order - 1, negative ones), identity inputs and points with Z != 1 are
in every batch; the tolerance is exact equality of normalized points.
(The group law itself: test_torch_bn2_curve.py.)"""

import random
import types

import numpy as np
import pytest

from verifiable_mpc_tpu import native as ref_native
from verifiable_mpc_tpu.groups.bn256 import GFp2 as RefGFp2
from verifiable_mpc_tpu.groups.bn256 import ORDER, P
from verifiable_mpc_tpu.groups.bn256 import BNTwistPoint as RefPoint
from verifiable_mpc_tpu_torch import native
from verifiable_mpc_tpu_torch.groups.bn256 import GFp2, BNTwistPoint

from test_torch_bn_field import load_reference_native
from test_torch_bn_msm import FOLD_CHALLENGES

EDGE = [0, 1, ORDER // 2 - 1, ORDER // 2, ORDER // 2 + 1, ORDER - 2,
        ORDER - 1, -1, -ORDER // 3]


@pytest.fixture(scope="module")
def k():
    """torch and the port's device-side modules, imported here and not at
    collection (every xdist worker collects this file); the plain versions
    run on the CPU, torch on one thread."""
    import torch

    from verifiable_mpc_tpu_torch.ops import curve_bn2, msm_bn2_cuda, msm_cuda

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = msm_cuda.DEVICE
    msm_cuda.DEVICE = torch.device("cpu")
    assert native.load() is not None and load_reference_native() is not None
    yield types.SimpleNamespace(torch=torch, cb2=curve_bn2, mb2=msm_bn2_cuda,
                                mc=msm_cuda)
    msm_cuda.DEVICE = saved
    torch.set_num_threads(n)


def _scalars(n, seed):
    rng = random.Random(seed)
    return (EDGE + [rng.randrange(ORDER) for _ in range(n)])[:n]


def _ref_points(n, seed, identity_at=()):
    """n reference twist points from the C++ tier, every third one in
    jacobian coordinates with Z != 1; identities where asked."""
    rng = random.Random(seed)
    pts = ref_native.bn2_batch_exp(
        RefPoint.generator, [rng.randrange(1, ORDER) for _ in range(n)])
    for i in range(1, n, 3):
        lam = RefGFp2(rng.randrange(2, P), rng.randrange(P))
        q = pts[i].normalize()  # (x, y, 1) ~ (l^2 x, l^3 y, l)
        pts[i] = RefPoint(q.x * lam * lam, q.y * lam * lam * lam, lam,
                          check=False)
    for i in identity_at:
        if i < n:
            pts[i] = RefPoint.identity
    return pts


def _port(p):
    return BNTwistPoint(*(GFp2(int(c.c0), int(c.c1)) for c in (p.x, p.y, p.z)),
                        check=False)


def _affine(p):
    q = p.normalize()
    return tuple((int(c.c0), int(c.c1)) for c in (q.x, q.y, q.z))


# ---------------------------------------------------------------------------
# the encoding launch's plain version
# ---------------------------------------------------------------------------


def test_encoding_of_jacobian_points(k):
    """Input rows with Z != 1 and the identity: their working rows (the
    plain version of the kernels' first launch) normalize to the host's
    affine points; encoding is one upload of native._bn2_pts_to_u64."""
    pts = [_port(p) for p in _ref_points(12, 8, identity_at=(0, 5))]
    rows = k.cb2.encode_points(pts, "cpu")
    assert np.array_equal(k.cb2.to_rows(rows), native._bn2_pts_to_u64(pts))
    work = k.cb2.encode_jacobian_rows(rows)
    got = k.cb2.decode_rows(k.cb2.normalize_rows(k.cb2.split_rows(work)))
    assert [_affine(p) for p in got] == [_affine(p) for p in pts]
    assert all(pts[i].z != GFp2(1) for i in (1, 4, 7))


# ---------------------------------------------------------------------------
# the plain versions of K9-K12
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 17, 64, 70])
def test_msm_plain_matches_reference(n, k):
    """The plain K9 + K10 at K9's slice count (msm_slices); at n = 70 (more
    than one slice) slice 1's digits are all zero and so are point 9's,
    besides the identity input and the edge scalars."""
    pts = _ref_points(n, n, identity_at=(3,))
    sc = _scalars(n, n + 1)
    if n == 70:
        S = k.mb2.msm_slices(n)
        assert S > 1
        sc[1::S] = [0] * len(sc[1::S])
        sc[9] = 0
    got = k.mb2.msm([_port(p) for p in pts], sc)
    expect = ref_native.bn2_msm(pts, sc)
    if n == 1:
        assert _affine(expect) == _affine(pts[0] ** (sc[0] % ORDER))
    assert _affine(got) == _affine(expect)
    assert got.z in (GFp2(0), GFp2(1))  # normalized


@pytest.mark.parametrize("n", [1, 17, 64])
def test_batch_exp_plain_matches_reference(n, k):
    """K11's plain version: the base's comb table from the C++ tier, one
    signed entry a window summed; scalar 0 gives exactly the identity."""
    base = _ref_points(1, 4 * n)[0]
    exps = _scalars(n, 4 * n + 1)
    got = k.mb2.batch_exp(_port(base), exps)
    expect = ref_native.bn2_batch_exp(base, exps)
    assert [_affine(p) for p in got] == [_affine(p) for p in expect]
    if n == 17:
        assert [_affine(p) for p in expect] == [
            _affine(base ** (e % ORDER)) for e in exps]
    zero = [i for i, e in enumerate(exps) if e % ORDER == 0]
    assert all(repr(got[i]) == repr(BNTwistPoint.identity) for i in zero)


# n and the challenge (None: a random one) of each fold case: the edge
# challenges of msm_cuda.fold_challenges(ORDER), by name, at n = 3; at
# n = 6 element 4's gr makes gl^c * gr the identity.  gl is the identity
# at index 2, gr at index 5.
FOLD_CASES = {"1": (1, None), "17": (17, None), "64": (64, None),
              "sum-identity": (6, None),
              **{name: (3, name) for name in FOLD_CHALLENGES}}


@pytest.mark.parametrize("n", list(FOLD_CASES))
def test_fold_plain_matches_reference(n, k):
    """K12's plain version through fold() against the JAX package's host
    law (n <= 6) or its C++ tier's MSM of (gl_i, gr_i) by (c, 1)."""
    name, (n, c) = n, FOLD_CASES[n]
    gl = _ref_points(n, 2 * n, identity_at=(2,))
    gr = _ref_points(n, 2 * n + 1, identity_at=(5,))
    if c is None:
        c = _scalars(n + 9, 3 * n)[-1]
    else:
        c = k.mc.fold_challenges(ORDER)[c]
    if name == "sum-identity":
        gr[4] = -(gl[4] ** c)
    got = k.mb2.fold([_port(p) for p in gl], [_port(p) for p in gr], c)
    if n <= 6:
        expect = [a ** c * b for a, b in zip(gl, gr)]
    else:
        expect = [ref_native.bn2_msm([a, b], [c, 1]) for a, b in zip(gl, gr)]
    assert [_affine(p) for p in got] == [_affine(p) for p in expect]
    if name == "sum-identity":
        assert repr(got[4]) == repr(BNTwistPoint.identity)


def test_comb_table_rows_match_host_law(k):
    """The twist comb table (native.bn2_comb_table through bexp_table) at
    nw = 8: row w*9 + m is m * 16^(nw-1-w) * base by the JAX package's host
    law, affine, the identity for m = 0."""
    base = _ref_points(1, 31)[0]
    nw = 8
    rows = k.mb2.bexp_table(_port(base), nw, "cpu")
    assert tuple(rows.shape) == (nw * 9, 24)
    got = k.cb2.decode_rows(rows)
    expect = [base ** (m * 16 ** (nw - 1 - w)) if m else RefPoint.identity
              for w in range(nw) for m in range(9)]
    assert [_affine(p) for p in got] == [_affine(p) for p in expect]
    assert all(p.z == GFp2(0 if i % 9 == 0 else 1) for i, p in enumerate(got))


def test_batch_exp_of_identity_base(k):
    got = k.mb2.batch_exp(BNTwistPoint.identity, _scalars(5, 9))
    assert all(repr(p) == repr(BNTwistPoint.identity) for p in got)


# ---------------------------------------------------------------------------
# malformed inputs and the dispatch tiers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", ["dtype", "width", "contiguity", "digits",
                                 "table", "fold_shape", "fold_digits"])
def test_wrappers_reject_malformed_inputs(bad, k):
    torch = k.torch
    pts = k.cb2.encode_points([_port(p) for p in _ref_points(4, 5)], "cpu")
    dig = torch.zeros((4, 4), dtype=torch.uint8)
    table = k.mb2.bexp_table(BNTwistPoint.generator, 8, "cpu")
    cdig = np.zeros(64, np.uint8)
    if bad == "dtype":
        call = lambda: k.mb2.msm_rows(pts.to(torch.int32)[None],  # noqa
                                      dig[None])
    elif bad == "width":
        call = lambda: k.mb2.msm_rows(  # noqa: E731
            torch.zeros((1, 4, 12), dtype=torch.int64), dig[None])
    elif bad == "contiguity":
        call = lambda: k.mb2.fold_rows(pts[::2], pts[1::2], cdig)  # noqa
    elif bad == "digits":
        call = lambda: k.mb2.bexp_rows(table, dig.to(torch.int64))  # noqa
    elif bad == "table":
        call = lambda: k.mb2.bexp_rows(table[:-1], dig)  # noqa: E731
    elif bad == "fold_shape":
        call = lambda: k.mb2.fold_rows(pts, pts[:3], cdig)  # noqa: E731
    else:
        call = lambda: k.mb2.fold_rows(pts, pts, cdig + 16)  # noqa: E731
    with pytest.raises(ValueError):
        call()


def test_enable_gpu_tiers_twist_backends(k, monkeypatch):
    """enable_gpu routes a twist MSM or batch-exp of BN2_MIN_BATCH or more
    to the kernels' wrappers, smaller ones to the C++ tier, and a twist
    fold of min_msm_batch or more to K12's wrapper; enable_native puts the
    C++ tier back and takes the twist fold away."""
    import verifiable_mpc_tpu_torch as port
    from verifiable_mpc_tpu_torch.ops import dispatch

    calls = []
    for mod, name in ((k.mb2, "msm"), (k.mb2, "batch_exp"),
                      (k.mb2, "fold"), (native, "bn2_msm"),
                      (native, "bn2_batch_exp")):
        tag = f"{'gpu' if mod is k.mb2 else 'c++'}.{name}"
        monkeypatch.setattr(mod, name, lambda *a, _t=tag: calls.append(_t))
    monkeypatch.setattr(port, "BN2_MIN_BATCH", 6)
    try:
        port.enable_gpu(device="cpu", min_msm_batch=4)
        g = BNTwistPoint.generator
        for n in (5, 6):
            dispatch._MSM_BACKENDS[BNTwistPoint][0]([g] * n, [1] * n)
            dispatch._BATCH_EXP_BACKENDS[BNTwistPoint][0](g, [1] * n)
        assert dispatch._FOLD_BACKENDS[BNTwistPoint][1] == 4
        dispatch._FOLD_BACKENDS[BNTwistPoint][0]([g] * 4, [g] * 4, 3)
        assert calls == ["c++.bn2_msm", "c++.bn2_batch_exp", "gpu.msm",
                         "gpu.batch_exp", "gpu.fold"]
    finally:
        monkeypatch.undo()
        port.enable_native()
    assert BNTwistPoint not in dispatch._FOLD_BACKENDS
    assert dispatch._MSM_BACKENDS[BNTwistPoint][0] is native.bn2_msm
    assert dispatch._BATCH_EXP_BACKENDS[BNTwistPoint][0] is (
        native.bn2_batch_exp)
