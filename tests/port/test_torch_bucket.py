"""The port's bucket-method Ed25519 MSM (ops/msm_bucket_cuda.py) against
the JAX package's ops/msm_bucket.py: the signed radix-256 recoding, the
padded bucket layout and the compact layout K13 reads (expanded to the
padded form) element for element (lanes 128 and 4), the plain
versions of K13 + K14 against the JAX package's C++ tier
(native.ed_msm) and host multiexp, register()'s tiering, and a 2^6
flagship prove with the bucket backend registered, whose normalized proof
bytes equal the JAX package's enable_native() prove.  The JAX package's
own functions compared here are numpy (no interpret-mode kernel runs);
the tolerance is exact equality."""

import random
import types

import numpy as np
import pytest

from verifiable_mpc_tpu import native as ref_native
from verifiable_mpc_tpu.groups.edwards import ELL, P
from verifiable_mpc_tpu.groups.edwards import EdwardsPoint as RefPoint
from verifiable_mpc_tpu.ops import dispatch as ref_dispatch
from verifiable_mpc_tpu.ops import msm_bucket as ref_mb
from verifiable_mpc_tpu_torch import native
from verifiable_mpc_tpu_torch.groups.edwards import EdwardsPoint
from verifiable_mpc_tpu_torch.ops import dispatch

from test_torch_bn_field import load_reference_native
from test_torch_pivot import (  # noqa: F401 (fixtures)
    PC, SEED, _canonical, _setup, pivot_gpu, reference_proof)

# 0, 1, the balanced edges, and scalars whose radix-256 digits reach 128
# and -128 (128 + 128 * 256 is two 128 digits; order - 128 negates one)
EDGE = [0, 1, ELL // 2 - 1, ELL // 2, ELL // 2 + 1, ELL - 2, ELL - 1,
        128, 128 + (128 << 8), ELL - 128, ELL - (128 << 8) - 128, -1,
        ELL + 5]


@pytest.fixture(scope="module")
def k():
    """torch and the port's device-side modules, imported here and not at
    collection (every xdist worker collects this file); the plain versions
    run on the CPU, torch on one thread."""
    import torch

    from verifiable_mpc_tpu_torch.ops import (curve_ed, msm_bucket_cuda,
                                              msm_cuda)

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = msm_cuda.DEVICE
    msm_cuda.DEVICE = torch.device("cpu")
    yield types.SimpleNamespace(torch=torch, ced=curve_ed, bk=msm_bucket_cuda,
                                mc=msm_cuda)
    msm_cuda.DEVICE = saved
    torch.set_num_threads(n)


def _scalars(n, seed):
    rng = random.Random(seed)
    return (EDGE + [rng.randrange(ELL) for _ in range(n)])[:n]


def _small_digit_scalars(n, seed, nw=3, top=4):
    """Scalars whose radix-256 digits all have magnitude <= top (the
    lanes = 4 layout), a few negated so that their digits flip sign."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        v = 0
        for _ in range(nw):
            v = (v << 8) + rng.randrange(top + 1)
        out.append(ELL - v if i % 3 == 1 else v)
    return out


def _u64x4(scalars) -> np.ndarray:
    """Residues mod the order as [n, 4] u64, without the C tier."""
    raw = b"".join((int(s) % ELL).to_bytes(32, "little") for s in scalars)
    return np.frombuffer(raw, dtype=np.uint64).reshape(len(scalars), 4)


def _ref_points(n, seed):
    """n reference points from the JAX package's C++ tier, every third one
    with Z != 1 and point 2 the identity."""
    rng = random.Random(seed)
    pts = ref_native.ed_batch_exp(RefPoint.generator,
                                  [rng.randrange(1, ELL) for _ in range(n)])
    if n > 2:
        pts[2] = RefPoint.identity
    for i in range(0, n, 3):
        lam, q = rng.randrange(2, P), pts[i]
        pts[i] = RefPoint(q.x * lam, q.y * lam, q.z * lam, q.t * lam)
    return pts


def _port(p):
    return EdwardsPoint(p.x, p.y, p.z, p.t)


def _affine(p):
    q = p.normalize()
    return (q.x, q.y)


# ---------------------------------------------------------------------------
# recoding and layout
# ---------------------------------------------------------------------------

RECODE_SETS = {
    "edge": EDGE,
    "near-half": [ELL // 2 + d for d in range(-40, 41)],
    "random": _scalars(300, 11),
    "small-digits": _small_digit_scalars(60, 12),
}


@pytest.mark.parametrize("name", sorted(RECODE_SETS))
def test_signed8_digits_match_reference(name, k):
    sc = RECODE_SETS[name]
    expect = ref_mb._scalar_digits_signed8(sc, ELL)
    got = k.bk.digits_signed8(
        k.torch.from_numpy(_u64x4(sc).view(np.int64).copy())).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, expect)
    assert np.array_equal(k.bk.scalar_digits_signed8(sc), expect)
    assert np.abs(got).max(initial=0) <= 128


def test_digits_reach_128_and_minus_128(k):
    d = k.bk.scalar_digits_signed8(EDGE)
    assert d.max() == 128 and d.min() == -128


@pytest.mark.parametrize("lanes,dt,name", [
    (128, 8, "edge"), (128, 8, "random"), (128, 3, "near-half"),
    (128, 1, "random"), (4, 2, "small-digits"), (4, 8, "small-digits"),
])
def test_bucket_layout_matches_reference(lanes, dt, name, k):
    digits = ref_mb._scalar_digits_signed8(RECODE_SETS[name], ELL)
    perm, sgn, D = ref_mb._bucket_layout(digits, dt, lanes)
    got_perm, got_sgn, got_d = k.bk.bucket_layout(digits, dt, lanes)
    assert got_d == D
    assert got_perm.dtype == k.torch.int32 and got_sgn.dtype == k.torch.int32
    assert np.array_equal(got_perm.numpy(), perm)
    assert np.array_equal(got_sgn.numpy(), sgn)


def test_bucket_layout_rejects_digits_past_its_lanes(k):
    digits = ref_mb._scalar_digits_signed8([5], ELL)
    with pytest.raises(ValueError):
        k.bk.bucket_layout(digits, 8, 4)
    with pytest.raises(ValueError):
        k.bk.compact_layout(digits, 4)


def _expand(entries, offsets, nw, lanes, dt):
    """The compact layout as the padded [nw, D, lanes] perm and sgn of
    _bucket_layout (D the deepest column, at least 1, rounded up to dt)."""
    ent, off = entries.numpy(), offsets.numpy()
    depth = max(1, int(np.diff(off).max(initial=0)))
    D = -(-depth // dt) * dt
    perm = np.full((nw, D, lanes), -1, np.int32)
    sgn = np.zeros_like(perm)
    for c in range(nw * lanes):
        w, b = divmod(c, lanes)
        col = ent[off[c]:off[c + 1]]
        perm[w, :col.size, b] = col & 0x7FFFFFFF
        sgn[w, :col.size, b] = col < 0
    return perm, sgn


@pytest.mark.parametrize("lanes,dt,name", [
    (128, 8, "edge"), (128, 8, "random"), (128, 2, "near-half"),
    (128, 2, "single-window"), (4, 2, "small-digits"),
    (4, 8, "small-digits"), (4, 8, "single-window"),
])
def test_compact_layout_matches_reference(lanes, dt, name, k):
    """The compact layout, expanded, equals _bucket_layout element for
    element: digits 128 and -128 ("edge"), empty columns (every set but
    "random" leaves some; lanes 4 many), a single-window MSM (scalars
    below 4, trimmed to one window).  Its count is the nonzero digits',
    its offsets monotone from 0 to the count."""
    sc = ([0, 1, 2, 3, ELL - 1, ELL - 3, 2] if name == "single-window"
          else RECODE_SETS[name])
    digits = ref_mb._scalar_digits_signed8(sc, ELL)
    if name == "single-window":
        digits = np.asarray(k.bk.trim_windows(digits))
        assert digits.shape[0] == 1
    nw = digits.shape[0]
    perm, sgn, _D = ref_mb._bucket_layout(digits, dt, lanes)
    entries, offsets, count = k.bk.compact_layout(digits, lanes)
    assert entries.dtype == k.torch.int32 and offsets.dtype == k.torch.int32
    assert offsets.shape == (nw * lanes + 1,)
    assert count == entries.numel() == int(np.count_nonzero(digits))
    off = offsets.numpy()
    assert off[0] == 0 and off[-1] == count and (np.diff(off) >= 0).all()
    if name != "random":
        assert (np.diff(off) == 0).any(), "no empty column covered"
    got_perm, got_sgn = _expand(entries, offsets, nw, lanes, dt)
    assert np.array_equal(got_perm, perm) and np.array_equal(got_sgn, sgn)


@pytest.mark.parametrize("nw", [1, 3, 32])
def test_trim_keeps_exactly_the_windows_needed(nw, k):
    sc = [1 << (8 * (nw - 1))] if nw > 1 else [7]
    d = k.bk.trim_windows(k.bk.scalar_digits_signed8(sc))
    assert d.shape == (nw, 1) and d[0, 0] != 0
    zero = k.bk.trim_windows(k.bk.scalar_digits_signed8([0, 0]))
    assert zero.shape == (1, 2) and not zero.any()


# ---------------------------------------------------------------------------
# the plain K13 + K14
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 17, 64])
def test_plain_bucket_msm_matches_native_and_host(n, k):
    assert load_reference_native() is not None and native.load() is not None
    pts = _ref_points(n, n)
    sc = _scalars(n, n + 1)
    expect = ref_native.ed_msm(pts, sc)
    got = k.bk.msm([_port(p) for p in pts], sc)
    assert _affine(got) == _affine(expect)
    assert _affine(got) == _affine(ref_dispatch._host_multiexp(pts, sc))


@pytest.mark.parametrize("n", [1, 17, 64])
def test_plain_bucket_msm_lanes4_matches_native(n, k):
    """lanes = 4, as the JAX package's own pipeline test runs it: small
    digits, dt = 2, the plain kernels' work small."""
    assert load_reference_native() is not None
    pts = _ref_points(n, 5 * n)
    sc = _small_digit_scalars(n, 5 * n + 1)
    got = k.bk.msm([_port(p) for p in pts], sc, dt=2, lanes=4)
    assert _affine(got) == _affine(ref_native.ed_msm(pts, sc))


def test_all_zero_scalars_give_the_identity(k):
    pts = [_port(p) for p in _ref_points(3, 1)]
    assert k.bk.msm(pts, [0, ELL, -ELL]) == EdwardsPoint.identity


def test_plain_kernels_hold_their_steps(k):
    """K13's plain version against a direct sum of each column, and K14's
    against sum_w 256^(nw-1-w) sum_b (b+1) B[w, b] by the host law."""
    pts = [_port(p) for p in _ref_points(9, 21)]
    sc = _small_digit_scalars(9, 22, nw=2)
    digits = k.bk.trim_windows(k.bk.scalar_digits_signed8(sc))
    lanes = 4
    entries, offsets, _count = k.bk.compact_layout(digits, lanes)
    rows = k.ced.encode_points(pts, "cpu")
    buckets = k.ced.decode_rows(k.bk.bucket_accumulate(
        rows, entries, offsets, lanes).reshape(-1, 16))
    nw = digits.shape[0]
    expect = []
    for w in range(nw):
        for b in range(lanes):
            acc = EdwardsPoint.identity
            c = w * lanes + b
            for e in entries[offsets[c]:offsets[c + 1]].tolist():
                i = e & 0x7FFFFFFF
                acc = acc * (pts[i] ** (ELL - 1 if e < 0 else 1))
            expect.append(acc)
    assert [_affine(p) for p in buckets] == [_affine(p) for p in expect]
    total = EdwardsPoint.identity
    for w in range(nw):
        total = total ** 256
        for b in range(lanes):
            total = total * expect[w * lanes + b] ** (b + 1)
    got = k.bk.bucket_reduce(k.bk.bucket_accumulate(rows, entries, offsets,
                                                    lanes))
    assert _affine(k.ced.decode_rows(got)[0]) == _affine(total)


@pytest.mark.parametrize("bad", ["points", "entries-dtype", "shapes",
                                 "lanes", "contiguity", "index", "offsets",
                                 "buckets", "windows"])
def test_wrappers_reject_malformed_inputs(bad, k):
    t = k.torch
    pts = k.ced.encode_points([_port(p) for p in _ref_points(4, 2)], "cpu")
    # two windows of four buckets: entries 0, 3, -2 (negated 2), 1
    entries = t.tensor([0, 3, 2 | -(1 << 31), 1], dtype=t.int32)
    offsets = t.tensor([0, 2, 2, 3, 3, 3, 3, 4, 4], dtype=t.int32)
    lanes = 4
    k.bk.bucket_accumulate(pts, entries, offsets, lanes)  # well formed
    if bad in ("buckets", "windows"):
        shape = (2, 129, 16) if bad == "buckets" else (33, 4, 16)
        with pytest.raises(ValueError):
            k.bk.bucket_reduce(t.zeros(shape, dtype=t.int64))
        return
    if bad == "points":
        pts = pts.to(t.int32)
    elif bad == "entries-dtype":
        entries = entries.to(t.int64)
    elif bad == "shapes":
        offsets = offsets[:-1].contiguous()  # not nw * lanes + 1
    elif bad == "lanes":
        lanes = 129
    elif bad == "index":
        entries[1] = 4  # one past the four points
    elif bad == "offsets":
        offsets[3] = 1  # not monotone
    else:
        entries = t.stack([entries, entries], 1)[:, 0]
    with pytest.raises(ValueError):
        k.bk.bucket_accumulate(pts, entries, offsets, lanes)


# ---------------------------------------------------------------------------
# registration and the flagship
# ---------------------------------------------------------------------------


@pytest.fixture
def saved_backends():
    tables = (dispatch._MSM_BACKENDS, dispatch._MSM_ASYNC_BACKENDS)
    saved = [dict(t) for t in tables]
    yield
    for table, old in zip(tables, saved):
        table.clear()
        table.update(old)


@pytest.fixture
def counted_bucket(k, monkeypatch):
    """The bucket backend's calls, counted by the size of each: the
    registered backend looks msm up when it runs."""
    calls = []
    real = k.bk.msm

    def msm(pts, sc, **kw):
        calls.append(len(pts))
        return real(pts, sc, **kw)

    monkeypatch.setattr(k.bk, "msm", msm)
    return calls


def test_register_keeps_small_batches_on_the_backend_before(
        k, saved_backends, counted_bucket):
    """As the JAX package's test_bucket_msm_register_small_falls_back:
    below min_batch the backend installed before serves the call."""
    before = []

    def fake(pts, sc):
        before.append(len(pts))
        return dispatch._host_multiexp(pts, sc)

    dispatch.register_msm_backend(EdwardsPoint, fake, 4)
    k.bk.register(min_batch=16)
    assert dispatch._MSM_BACKENDS[EdwardsPoint][1] == 4
    pts = [_port(p) for p in _ref_points(20, 3)]
    sc = _scalars(20, 4)
    small = dispatch.multiexp(pts[:8], sc[:8])
    assert before == [8] and counted_bucket == []
    assert small == dispatch._host_multiexp(pts[:8], sc[:8])
    large = dispatch.multiexp(pts, sc)
    assert before == [8] and counted_bucket == [20]
    assert _affine(large) == _affine(dispatch._host_multiexp(pts, sc))


@pytest.mark.parametrize("entry", ["register", "msm", "layout_for"])
def test_bucket_entry_points_raise_before_enable_gpu(
        entry, k, saved_backends, monkeypatch):
    """With no device chosen (no enable_gpu() yet) register(), msm() and
    layout_for() raise, and register() installs nothing: the bucket MSM
    never runs on the CPU unasked."""
    monkeypatch.setattr(k.mc, "DEVICE", None)
    before = dict(dispatch._MSM_BACKENDS)
    g = EdwardsPoint.generator
    call = {"register": lambda: k.bk.register(),
            "msm": lambda: k.bk.msm([g, g], [1, 2]),
            "layout_for": lambda: k.bk.layout_for([1, 2])}[entry]
    with pytest.raises(RuntimeError, match="enable_gpu"):
        call()
    assert dispatch._MSM_BACKENDS == before


def test_enable_gpu_leaves_the_bucket_unregistered(k, counted_bucket):
    import verifiable_mpc_tpu_torch as port

    port.enable_gpu(device="cpu", min_msm_batch=8)
    try:
        pts = [_port(p) for p in _ref_points(16, 6)]
        sc = _scalars(16, 7)
        got = dispatch.multiexp(pts, sc)
        assert counted_bucket == []
        assert _affine(got) == _affine(native.ed_msm(pts, sc))
    finally:
        port.enable_native()


def test_flagship_with_bucket_matches_reference_native_bytes(
        k, reference_proof, pivot_gpu, monkeypatch,  # noqa: F811
        counted_bucket):
    """A 2^6 prove with enable_gpu(device="cpu") and the bucket backend
    registered from 8 points (protocol 5's commitment A goes through it)
    gives the JAX package's enable_native() proof bytes once normalized."""
    import verifiable_mpc_tpu_torch as port
    import verifiable_mpc_tpu_torch.ac20.circuit_builder as cb
    import verifiable_mpc_tpu_torch.ac20.circuit_sat_cb as cs
    from verifiable_mpc_tpu_torch import rng, serialization
    from verifiable_mpc_tpu_torch.fields import GF
    from verifiable_mpc_tpu_torch.groups import EllipticCurve

    gens_bytes, _raw, ref_bytes = reference_proof
    # the backends first, as in test_torch_pivot: the generators' bytes
    # hold projective representatives, which the C++ tier picks as the
    # reference's does (the pure host path picks others)
    port.enable_gpu(device="cpu")
    try:
        gf, circuit, x, gens = _setup(cb, cs, GF, EllipticCurve, rng)
        assert serialization.dumps(gens) == gens_bytes
        monkeypatch.setattr(pivot_gpu, "_CUTOVER", 8)
        k.bk.register(min_batch=8)
        runs0 = pivot_gpu.ENGINE_RUNS
        with rng.deterministic(SEED + 1):
            proof = cs.circuit_sat_prover(gens, circuit, x, gf, PC)
        assert pivot_gpu.ENGINE_RUNS > runs0, "the engine declined the prove"
        assert counted_bucket, "the bucket backend served no call"
        assert serialization.dumps(_canonical(proof)) == ref_bytes
    finally:
        port.enable_native()
