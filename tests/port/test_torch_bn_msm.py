"""The port's BN256 G1 group law (ops/curve_bn.py) and the plain versions
of its MSM, fold and comb kernels (ops/msm_bn_cuda.py) against the JAX
package: its BN adapter's complete formulas (bn_pallas.bn_add_lm /
bn_dbl_lm, evaluated eagerly), its recoding, its host group law, its
dispatch._host_multiexp and its C++ tier (native.bn_msm / bn_batch_exp),
on the same seed-made points and scalars.  Edge scalars (0, 1, order/2 +-
1, order - 2, order - 1, negative ones) and identity inputs are in every
batch; the tolerance is exact equality of normalized points."""

import random
import types

import jax.numpy as jnp
import numpy as np
import pytest

from verifiable_mpc_tpu import native as ref_native
from verifiable_mpc_tpu.groups.bn256 import ORDER, BNPoint as RefPoint
from verifiable_mpc_tpu.ops import bn_pallas as ref_bp
from verifiable_mpc_tpu.ops import dispatch as ref_dispatch
from verifiable_mpc_tpu.ops import msm as ref_msm
from verifiable_mpc_tpu.ops import msm_pallas as ref_mp
from verifiable_mpc_tpu_torch import native
from verifiable_mpc_tpu_torch.groups.bn256 import BNPoint

from test_torch_bn_field import load_reference_native

EDGE = [0, 1, ORDER // 2 - 1, ORDER // 2, ORDER // 2 + 1, ORDER - 2,
        ORDER - 1, -1, -ORDER // 3]
LANES = 81  # the JAX-side group law runs eagerly on one shape


# the names of msm_cuda.fold_challenges(ORDER): the folds' edge
# challenges, "top-digit"'s NAF a digit past the order's top bit (the
# values are read in the tests, where the port's modules are imported)
FOLD_CHALLENGES = ("c0", "c1", "c8", "c9", "order-1", "zero-run",
                   "top-digit")


@pytest.fixture(scope="module")
def k():
    """torch and the port's device-side modules, imported here and not at
    collection (every xdist worker collects this file); the plain versions
    run on the CPU."""
    import torch

    from verifiable_mpc_tpu_torch.ops import curve_bn, msm_bn_cuda, msm_cuda

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = msm_cuda.DEVICE
    msm_cuda.DEVICE = torch.device("cpu")
    assert native.load() is not None and load_reference_native() is not None
    yield types.SimpleNamespace(torch=torch, cbn=curve_bn, mb=msm_bn_cuda,
                                mc=msm_cuda)
    msm_cuda.DEVICE = saved
    torch.set_num_threads(n)


def _scalars(n, seed):
    rng = random.Random(seed)
    return (EDGE + [rng.randrange(ORDER) for _ in range(n)])[:n]


def _ref_points(n, seed, identity_at=()):
    """n reference points from the C++ tier, every third one in jacobian
    coordinates with Z != 1; identities where asked."""
    rng = random.Random(seed)
    pts = ref_native.bn_batch_exp(
        RefPoint.generator, [rng.randrange(1, ORDER) for _ in range(n)])
    for i in range(1, n, 3):
        lam = rng.randrange(2, ORDER)  # (x, y, 1) ~ (l^2 x, l^3 y, l)
        q = pts[i].normalize()
        x, y = int(q.x), int(q.y)
        pts[i] = RefPoint(x * lam**2, y * lam**3, lam, check=False)
    for i in identity_at:
        if i < n:
            pts[i] = RefPoint.identity
    return pts


def _port(p):
    return BNPoint(p.x.value, p.y.value, p.z.value, check=False)


def _affine(p):
    q = p.normalize()
    return (int(q.x), int(q.y), int(q.z))


# ---------------------------------------------------------------------------
# recoding against the BN order
# ---------------------------------------------------------------------------

RECODE_SETS = {
    "edge": [s % ORDER for s in EDGE],
    "near-half": [ORDER // 2 + d for d in range(-40, 41)],
    "random": _scalars(200, 11)[len(EDGE):],
}


@pytest.mark.parametrize("name", sorted(RECODE_SETS))
def test_signed_recoding_against_bn_order(name, k):
    """Digits against bn256.ORDER (never Ed25519's ELL), the -8 nibble
    borrow on both sides of order/2, and the C twin's packing."""
    sc = RECODE_SETS[name]
    expect = ref_mp._scalar_digits_signed(sc, ORDER)
    assert np.array_equal(k.mc.scalar_digits_signed(sc, ORDER), expect)
    arr = native._scalars_to_u64(sc, ORDER)
    assert np.array_equal(k.mc.digits_signed_from_u64x4(arr, ORDER), expect)
    pk, nw = k.mc.packed_digits(arr, ORDER)
    assert np.array_equal(pk, ref_mp._pack_digits(expect)[(64 - nw) // 2:])


# ---------------------------------------------------------------------------
# group law: RCB15 against bn_add_lm / bn_dbl_lm and the host law
# ---------------------------------------------------------------------------


def _lane_points(seed):
    """LANES point pairs: random, identity on either side, P + P, P - P."""
    a = _ref_points(LANES, seed)
    b = _ref_points(LANES, seed + 1)
    a[0] = RefPoint.identity
    b[1] = RefPoint.identity
    a[2] = b[2] = RefPoint.identity
    b[3] = a[3]
    b[4] = a[4] ** (ORDER - 1)
    return a, b


@pytest.mark.parametrize("op", ["add", "dbl"])
def test_group_law_matches_bn_pallas_and_host(op, k):
    a, b = _lane_points(5)
    expect = [_affine(x * y) for x, y in zip(a, b)] if op == "add" else [
        _affine(x * x) for x in a]
    ta = k.cbn.encode_points([_port(p) for p in a], "cpu")
    tb = k.cbn.encode_points([_port(p) for p in b], "cpu")
    pa, pb = (k.cbn.split_rows(k.cbn.encode_jacobian_rows(t))
              for t in (ta, tb))
    got = k.cbn.add(pa, pb) if op == "add" else k.cbn.dbl(pa)
    assert [_affine(p) for p in k.cbn.decode_rows(
        k.cbn.normalize_rows(got))] == expect
    # the JAX package's formulas on its own encoding, carried across
    consts = ref_bp._consts()
    ea = tuple(jnp.asarray(c).T for c in ref_bp.BN.encode(a))
    eb = tuple(jnp.asarray(c).T for c in ref_bp.BN.encode(b))
    out = (ref_bp.bn_add_lm(ea, eb, consts) if op == "add"
           else ref_bp.bn_dbl_lm(ea, consts))
    rows = k.cbn.from_reference_rows([np.asarray(c).T for c in out], "cpu")
    assert [_affine(p) for p in k.cbn.decode_rows(rows)] == expect


def test_reference_rows_round_trip(k):
    """_BnAdapter.encode's three [n, 16] Montgomery limb arrays cross into
    the port's input rows and back unchanged; the rows decode to the
    points, and their working rows normalize to them."""
    pts = _ref_points(9, 3, identity_at=(4,))
    enc = [np.asarray(c) for c in ref_bp.BN.encode(pts)]
    rows = k.cbn.from_reference_rows(enc, "cpu")
    assert rows.shape == (9, 12) and rows.dtype == k.torch.int64
    back = k.cbn.to_reference_rows(rows)
    assert all(np.array_equal(x, y) for x, y in zip(back, enc))
    expect = [_affine(p) for p in pts]
    assert [_affine(p) for p in k.cbn.decode_rows(rows)] == expect
    got = k.cbn.decode_rows(k.cbn.normalize_rows(
        k.cbn.split_rows(k.cbn.encode_jacobian_rows(rows))))
    assert [_affine(p) for p in got] == expect
    assert repr(got[4]) == repr(BNPoint.identity)


def test_encoding_of_jacobian_points(k):
    """Input rows with Z != 1 and the identity: their working rows (the
    plain version of the kernels' first launch) normalize to the host's
    affine points; encoding is one upload of native._bn_pts_to_u64."""
    pts = [_port(p) for p in _ref_points(12, 8, identity_at=(0, 5))]
    rows = k.cbn.encode_points(pts, "cpu")
    assert np.array_equal(k.cbn.to_rows(rows), native._bn_pts_to_u64(pts))
    work = k.cbn.encode_jacobian_rows(rows)
    got = k.cbn.decode_rows(k.cbn.normalize_rows(k.cbn.split_rows(work)))
    assert [_affine(p) for p in got] == [_affine(p) for p in pts]
    assert all(pts[i].z != 1 for i in (1, 4, 7))


# ---------------------------------------------------------------------------
# the plain versions of K5-K8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 17, 64])
def test_msm_plain_matches_reference(n, k):
    pts = _ref_points(n, n, identity_at=(3,))
    sc = _scalars(n, n + 1)
    got = k.mb.msm([_port(p) for p in pts], sc)
    if n <= 17:
        expect = ref_dispatch._host_multiexp(pts, [s % ORDER for s in sc])
    else:
        expect = ref_native.bn_msm(pts, sc)
    assert _affine(got) == _affine(expect)
    assert _affine(got) == _affine(native.bn_msm([_port(p) for p in pts], sc))
    assert got.z in (0, 1)  # normalized


def test_msm_plain_with_a_ragged_last_slice_matches_reference(k):
    """K5's slicing at 32 points a thread (ACCUM_POINTS_PER_THREAD): 70
    points in S = 3 slices, the last one a point short."""
    n = 70
    assert n % k.mc.slices_for(n, k.mc.ACCUM_POINTS_PER_THREAD)
    pts = _ref_points(n, 2 * n, identity_at=(69,))
    sc = _scalars(n, 2 * n + 1)
    got = k.mb.msm([_port(p) for p in pts], sc)
    assert _affine(got) == _affine(ref_native.bn_msm(pts, sc))


@pytest.mark.parametrize("nw,S,R", [(64, 3, 2), (9, 5, None)])
def test_msm_tail_plain_matches_reference(nw, S, R, k):
    """K6's plain version (the window's S slices in R chunks, a Horner over
    each window group, the groups shifted and added) at B = 2 with window 1
    all identities, against the JAX package's C++ MSM of the accumulators
    by 16^(nw-1-w); nw = 9 leaves the last group one window and empty
    groups after it."""
    B = 2
    pts = _ref_points(B * nw * S, nw + S)
    for b in range(B):
        for s in range(S):
            pts[(b * nw + 1) * S + s] = RefPoint.identity
    acc = k.cbn.encode_jacobian_rows(k.cbn.encode_points(
        [_port(p) for p in pts], "cpu")).reshape(B, nw, S, 12)
    got = k.cbn.decode_rows(k.mb.msm_tail_plain(acc, R))
    sc = [16 ** (nw - 1 - w) for w in range(nw) for _ in range(S)]
    for b in range(B):
        expect = ref_native.bn_msm(pts[b * nw * S:(b + 1) * nw * S], sc)
        assert _affine(got[b]) == _affine(expect)
        assert got[b].z in (0, 1)  # normalized


@pytest.mark.parametrize("name", sorted(FOLD_CHALLENGES) + ["random"])
def test_fold_digits_match_reference_integer(name, k):
    """K7's and K12's digits, the width-5 NAF of c mod ORDER (257 digits,
    most significant first: the order has 256 bits), rebuild the integer
    of the JAX package's unsigned windows of c (ops/msm._scalar_digits),
    each digit 0 or odd in [-15, 15], at most one nonzero in any five."""
    edges = k.mc.fold_challenges(ORDER)
    assert sorted(edges) == sorted(FOLD_CHALLENGES)
    c = edges.get(name, random.Random(9).randrange(ORDER))
    windows = ref_msm._scalar_digits([c], ORDER)[:, 0]
    want = sum(int(d) << (4 * (63 - w)) for w, d in enumerate(windows))
    d = k.mc.fold_digits(c, ORDER)
    assert d.dtype == np.int8 and d.shape == (257,)
    assert sum(int(x) << (256 - i) for i, x in enumerate(d)) == want
    nz = np.flatnonzero(d)
    assert (np.abs(d[nz]) <= 15).all() and (d[nz] % 2 == 1).all()
    assert (np.diff(nz) >= 5).all()
    assert (d[0] != 0) == (name == "top-digit")


# n and the challenge (None: a random one) of each fold case: the edge
# challenges (by name) at n = 4; at n = 6 element 4's gr makes gl^c * gr
# the identity.  gl is the identity at index 2, gr at index 5.
FOLD_CASES = {"1": (1, None), "17": (17, None), "64": (64, None),
              "sum-identity": (6, None),
              **{name: (4, name) for name in FOLD_CHALLENGES}}


@pytest.mark.parametrize("n", list(FOLD_CASES))
def test_fold_plain_matches_reference(n, k):
    """K7's plain version through fold() against the JAX package's host
    law (n <= 17) or its C++ tier's MSM of (gl_i, gr_i) by (c, 1)."""
    name, (n, c) = n, FOLD_CASES[n]
    gl = _ref_points(n, 2 * n, identity_at=(2,))
    gr = _ref_points(n, 2 * n + 1, identity_at=(5,))
    if c is None:
        c = _scalars(n + 9, 3 * n)[-1]
    else:
        c = k.mc.fold_challenges(ORDER)[c]
    if name == "sum-identity":
        gr[4] = -(gl[4] ** c)
    got = k.mb.fold([_port(p) for p in gl], [_port(p) for p in gr], c)
    if n <= 17:
        expect = [a ** c * b for a, b in zip(gl, gr)]
    else:
        expect = [ref_native.bn_msm([a, b], [c, 1]) for a, b in zip(gl, gr)]
    assert [_affine(p) for p in got] == [_affine(p) for p in expect]
    if name == "sum-identity":
        assert repr(got[4]) == repr(BNPoint.identity)


@pytest.mark.parametrize("n", [1, 17, 64])
def test_comb_plain_matches_reference(n, k):
    base = _ref_points(1, 4 * n)[0]
    exps = _scalars(n, 4 * n + 1)
    got = k.mb.batch_exp_comb(_port(base), exps)
    expect = ref_native.bn_batch_exp(base, exps)
    if n <= 17:
        assert [_affine(p) for p in expect] == [
            _affine(base ** (e % ORDER)) for e in exps]
    assert [_affine(p) for p in got] == [_affine(p) for p in expect]
    zero = [i for i, e in enumerate(exps) if e % ORDER == 0]
    assert all(repr(got[i]) == repr(BNPoint.identity) for i in zero)


def test_comb_table_rows_match_host_law(k):
    """The G1 comb table (native.bn_comb_table through comb_table) at
    nw = 8: row w*9 + m is m * 16^(nw-1-w) * base by the JAX package's host
    law, affine, the identity for m = 0."""
    base = _ref_points(1, 31)[0]
    nw = 8
    rows = k.mb.comb_table(_port(base), nw, "cpu")
    assert tuple(rows.shape) == (nw * 9, 12)
    got = k.cbn.decode_rows(rows)
    expect = [base ** (m * 16 ** (nw - 1 - w)) if m else RefPoint.identity
              for w in range(nw) for m in range(9)]
    assert [_affine(p) for p in got] == [_affine(p) for p in expect]
    assert all(int(p.z) == (0 if i % 9 == 0 else 1)
               for i, p in enumerate(got))


def test_comb_of_identity_base(k):
    got = k.mb.batch_exp_comb(BNPoint.identity, _scalars(5, 9))
    assert all(repr(p) == repr(BNPoint.identity) for p in got)


@pytest.mark.parametrize("bad", ["dtype", "width", "contiguity", "digits"])
def test_wrappers_reject_malformed_inputs(bad, k):
    pts = k.cbn.encode_points([_port(p) for p in _ref_points(4, 5)],
                              "cpu")[None]
    dig = k.torch.zeros((1, 4, 4), dtype=k.torch.uint8)
    if bad == "dtype":
        pts = pts.to(k.torch.int32)
    elif bad == "width":
        pts = k.torch.zeros((1, 4, 16), dtype=k.torch.int64)
    elif bad == "contiguity":
        pts = pts[:, ::2]
    else:
        dig = dig.to(k.torch.int64)
    with pytest.raises(ValueError):
        k.mb.msm_rows(pts, dig)


def test_enable_gpu_tiers_bn_backends(k, monkeypatch):
    """enable_gpu routes a BN MSM of BN_MIN_MSM_BATCH points or more, and a
    batch-exp or fold of min_msm_batch or more, to the kernels' wrappers,
    smaller ones to the C++ tier (the fold: to the host loop);
    enable_native puts the C++ tier back and takes the BN fold away."""
    import verifiable_mpc_tpu_torch as port
    from verifiable_mpc_tpu_torch.ops import dispatch

    calls = []
    for mod, name in ((k.mb, "msm"), (k.mb, "batch_exp_comb"),
                      (k.mb, "fold"), (native, "bn_msm"),
                      (native, "bn_batch_exp")):
        tag = f"{'gpu' if mod is k.mb else 'c++'}.{name}"
        monkeypatch.setattr(mod, name, lambda *a, _t=tag: calls.append(_t))
    assert port.BN_MIN_MSM_BATCH >= port.MIN_MSM_BATCH
    monkeypatch.setattr(port, "BN_MIN_MSM_BATCH", 6)
    try:
        port.enable_gpu(device="cpu", min_msm_batch=4)
        g = BNPoint.generator
        for n in (5, 6):
            dispatch._MSM_BACKENDS[BNPoint][0]([g] * n, [1] * n)
        for n in (3, 4):
            dispatch._BATCH_EXP_BACKENDS[BNPoint][0](g, [1] * n)
        assert dispatch._FOLD_BACKENDS[BNPoint][1] == 4
        dispatch._FOLD_BACKENDS[BNPoint][0]([g] * 4, [g] * 4, 3)
        assert calls == ["c++.bn_msm", "gpu.msm", "c++.bn_batch_exp",
                         "gpu.batch_exp_comb", "gpu.fold"]
    finally:
        monkeypatch.undo()
        port.enable_native()
    assert BNPoint not in dispatch._FOLD_BACKENDS
    assert dispatch._MSM_BACKENDS[BNPoint][0] is native.bn_msm
