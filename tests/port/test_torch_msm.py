"""The port's signed recoding and the plain versions of its MSM, fold and
comb kernels (ops/msm_cuda.py), through the port's dispatch, against the
JAX package's recoding and host group law on the same seed-made points
and scalars (edge scalars included: 0, 1, order/2 +- 1, order - 2,
order - 1)."""

import random
import types

import numpy as np
import pytest

from verifiable_mpc_tpu import native as ref_native
from verifiable_mpc_tpu.groups.edwards import ELL, EdwardsPoint as RefPoint
from verifiable_mpc_tpu.ops import dispatch as ref_dispatch
from verifiable_mpc_tpu.ops import msm as ref_msm
from verifiable_mpc_tpu.ops import msm_pallas as ref_mp
from verifiable_mpc_tpu_torch import native
from verifiable_mpc_tpu_torch.groups.edwards import EdwardsPoint
from verifiable_mpc_tpu_torch.ops import dispatch

from test_torch_bn_field import load_reference_native

EDGE = [0, 1, ELL // 2 - 1, ELL // 2, ELL // 2 + 1, ELL - 2, ELL - 1]


@pytest.fixture(scope="module")
def k():
    """torch and the port's device-side modules, imported here and not at
    collection: every xdist worker collects this file, and the CPU suite
    runs close to the host's memory limit (torch adds ~170 MB to a
    process)."""
    import torch

    from verifiable_mpc_tpu_torch.ops import curve_ed, msm_cuda

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield types.SimpleNamespace(torch=torch, ced=curve_ed, mc=msm_cuda)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plain_backends(k):
    """The plain versions as the port's Ed25519 dispatch backends (every
    batch size), on the CPU; the C++ tier does the host conversions."""
    mc = k.mc
    assert native.load() is not None
    tables = (dispatch._MSM_BACKENDS, dispatch._MSM_ASYNC_BACKENDS,
              dispatch._FOLD_BACKENDS, dispatch._BATCH_EXP_BACKENDS)
    saved = [dict(t) for t in tables], mc.DEVICE, mc.REGISTERED
    mc.register("cpu", min_batch=1)
    dispatch.register_msm_backend(EdwardsPoint, mc.msm, 1)
    dispatch.register_fold_backend(EdwardsPoint, mc.fold, 1)
    dispatch.register_batch_exp_backend(EdwardsPoint, mc.batch_exp_comb, 1)
    yield
    for table, old in zip(tables, saved[0]):
        table.clear()
        table.update(old)
    mc.DEVICE, mc.REGISTERED = saved[1], saved[2]


def _scalars(n, seed):
    rng = random.Random(seed)
    return (EDGE[::-1] + [rng.randrange(ELL) for _ in range(n)])[:n]


def _ref_points(n, seed):
    """n distinct reference points: a walk over four random steps."""
    rng = random.Random(seed)
    steps = [RefPoint.generator ** rng.randrange(1, ELL) for _ in range(4)]
    pts = [steps[0]]
    for i in range(1, n):
        pts.append(pts[-1] + steps[i % 4])
    return pts


def _port(p):
    return EdwardsPoint(p.x, p.y, p.z, p.t)


def _affine(p):
    q = p.normalize()
    return (q.x, q.y)


def _rows(points) -> np.ndarray:
    raw = b"".join(c.to_bytes(32, "little")
                   for p in points for c in (p.x, p.y, p.z, p.t))
    return np.frombuffer(raw, dtype=np.uint64).reshape(len(points), 16)


# ---------------------------------------------------------------------------
# signed recoding
# ---------------------------------------------------------------------------

RECODE_SETS = {
    "edge": EDGE,
    "near-half": [ELL // 2 + d for d in range(-40, 41)],
    "random": _scalars(200, 11),
}


@pytest.mark.parametrize("name", sorted(RECODE_SETS))
def test_signed_recoding_matches_reference(name, k):
    sc = RECODE_SETS[name]
    got = k.mc.scalar_digits_signed(sc)
    assert np.array_equal(got, ref_mp._scalar_digits_signed(sc, ELL))
    arr = native._ints_to_u64x4(sc, ELL)
    assert np.array_equal(k.mc.digits_signed_from_u64x4(arr, ELL), got)
    assert got.min() >= -7 and got.max() <= 8


@pytest.mark.parametrize("name", sorted(RECODE_SETS))
def test_packed_digits_match_reference_and_round_trip(name, k):
    """The offset-7 nibble packing: a -8 would read back as +8, so the
    recoding must keep every digit in [-7, 8] on negated columns too."""
    sc = RECODE_SETS[name]
    signed = ref_mp._scalar_digits_signed(sc, ELL)
    pk, nw = k.mc.packed_digits(native._ints_to_u64x4(sc, ELL))
    expect = ref_mp._pack_digits(signed)[(64 - nw) // 2:]
    assert np.array_equal(pk, expect)
    back = k.mc.unpack_digits(k.torch.from_numpy(pk)).numpy()
    assert np.array_equal(back, signed[64 - nw:])


@pytest.mark.parametrize("name", sorted(RECODE_SETS))
def test_unsigned_fold_digits_match_reference(name, k):
    sc = RECODE_SETS[name]
    assert np.array_equal(k.mc.scalar_digits(sc),
                          ref_msm._scalar_digits(sc, ELL))


# K3's challenges: the smallest, 8 (one nonzero NAF digit) and 9, the
# largest, and one with runs of zeros (the nibble 7 in every third 4-bit
# window from window 2, least significant first; about 2^119, which keeps
# the plain ladders of this file short)
FOLD_CHALLENGES = {"c0": 0, "c1": 1, "c8": 8, "c9": 9, "cl-1": ELL - 1,
                   "zero-run": sum(7 << (4 * w) for w in range(2, 32, 3))}


@pytest.mark.parametrize("name", sorted(FOLD_CHALLENGES))
def test_fold_digits_rebuild_the_challenge(name, k):
    """K3's digits, c's width-5 NAF (not balanced against the order): 254
    digits (one more than l's bits), most significant first, each 0 or odd
    in [-15, 15], at most one nonzero in any five, that rebuild c."""
    c = FOLD_CHALLENGES[name]
    d = k.mc.fold_digits(c)
    assert d.dtype == np.int8 and d.shape == (ELL.bit_length() + 1,) == (254,)
    assert sum(int(x) << (253 - i) for i, x in enumerate(d)) == c % ELL
    nz = np.flatnonzero(d)
    assert (np.abs(d[nz]) <= 15).all() and (d[nz] % 2 == 1).all()
    assert (np.diff(nz) >= 5).all()
    if name == "zero-run":
        assert (d == 0).sum() > 220


# ---------------------------------------------------------------------------
# the plain versions through the dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 300])
def test_msm_plain_matches_host_multiexp(n, plain_backends):
    pts = _ref_points(n, n)
    sc = _scalars(n, n + 1)
    expect = ref_dispatch._host_multiexp(pts, sc)
    got = dispatch.multiexp([_port(p) for p in pts], sc)
    assert _affine(got) == _affine(expect)


def test_msm_plain_with_a_ragged_last_slice_matches_host(plain_backends, k):
    """K1's slicing at 32 points a thread (ACCUM_POINTS_PER_THREAD): 70
    points in S = 3 slices, the last one a point short."""
    n = 70
    assert n % k.mc.slices_for(n, k.mc.ACCUM_POINTS_PER_THREAD)
    pts = _ref_points(n, 2 * n)
    sc = _scalars(n, 2 * n + 1)
    expect = ref_dispatch._host_multiexp(pts, sc)
    got = dispatch.multiexp([_port(p) for p in pts], sc)
    assert _affine(got) == _affine(expect)


@pytest.mark.parametrize("n,challenge", [
    pytest.param(n, c, id=f"{n}" + (f"-{c}" if c else ""))
    for n in (1, 7, 300) for c in [None] + sorted(FOLD_CHALLENGES)])
def test_fold_plain_matches_reference_fold(n, challenge, plain_backends):
    """K3's plain version through the dispatch against the JAX package's
    fold (its host law for a random c, its C++ tier for the edge
    challenges)."""
    gl, gr = _ref_points(n, 2 * n), _ref_points(n, 2 * n + 1)
    if challenge is None:
        c = _scalars(n + 3, 3 * n)[-1]
        expect = [a ** c * b for a, b in zip(gl, gr)]
    else:
        c = FOLD_CHALLENGES[challenge]
        assert load_reference_native() is not None
        expect = ref_native.ed_fold(gl, gr, c)
    got = dispatch.fold_generators([_port(p) for p in gl],
                                   [_port(p) for p in gr], c)
    assert [_affine(p) for p in got] == [_affine(p) for p in expect]
    assert all(p.z == 1 for p in got)


@pytest.mark.parametrize("n", [1, 7, 300])
def test_comb_plain_matches_reference_batch_exp(n, plain_backends):
    base = _ref_points(1, 4 * n)[0]
    exps = _scalars(n, 4 * n + 1)
    expect = [base ** e for e in exps]
    got = dispatch.batch_exp(_port(base), exps)
    assert [_affine(p) for p in got] == [_affine(p) for p in expect]


# K4's edge exponents: 0 (the identity), ELL - 1 (one digit, negated) and
# one whose digits are 0 from window 1 to window 61 (a run of zeros)
COMB_EDGES = {"zero": [0, 0, 5], "order-1": [ELL - 1, 1, ELL - 2],
              "zero-run": [(1 << 250) + 3, 9, 7 << 200]}


@pytest.mark.parametrize("name", sorted(COMB_EDGES))
def test_comb_affine_table_matches_reference_batch_exp(name, plain_backends,
                                                       k):
    """K4's affine table (y+x, y-x, 2dxy of normalized multiples) through
    the dispatch at the edge exponents, against the reference package's
    host law."""
    base = _ref_points(1, 19)[0]
    exps = COMB_EDGES[name]
    table = k.mc.comb_table(_port(base), 64, "cpu")
    assert table.shape == (64 * 9, 12)
    got = dispatch.batch_exp(_port(base), exps)
    assert [_affine(p) for p in got] == [_affine(base ** e) for e in exps]
    assert all(p.z == 1 for p in got)


@pytest.mark.parametrize("n", [1, 5])
def test_reference_rows_round_trip(n, k):
    rows = _rows(_ref_points(n, 99))
    t = k.ced.from_reference_rows(rows, "cpu")
    assert t.dtype == k.torch.int64 and t.shape == (n, 16)
    assert np.array_equal(k.ced.to_rows(t), rows)
    assert [_affine(p) for p in k.ced.decode_rows(t)] == [
        _affine(p) for p in _ref_points(n, 99)
    ]


@pytest.mark.parametrize(
    "bad", ["dtype", "shape", "contiguity", "digits", "rows"],
)
def test_wrappers_reject_malformed_inputs(bad, k):
    if bad == "rows":
        with pytest.raises(ValueError):
            k.ced.from_reference_rows(np.zeros((2, 8), np.uint64), "cpu")
        return
    pts = k.ced.from_reference_rows(_rows(_ref_points(4, 5)), "cpu")[None]
    dig = k.torch.zeros((1, 4, 4), dtype=k.torch.uint8)
    if bad == "dtype":
        pts = pts.to(k.torch.int32)
    elif bad == "shape":
        pts = pts[..., :8]
    elif bad == "contiguity":
        pts = pts[:, ::2]
    else:
        dig = dig.to(k.torch.int64)
    with pytest.raises(ValueError):
        k.mc.msm_rows(pts, dig)
