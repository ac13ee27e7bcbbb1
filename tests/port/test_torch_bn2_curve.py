"""The port's BN256 twist (G2) group law (ops/curve_bn2.py) against the
JAX package: its twist adapter's complete formulas (bn2_pallas.bn2_add_lm
/ bn2_dbl_lm / BN2.neg_where, evaluated eagerly on one shape), its
encoding (BN2.encode / decode_many) and its host group law, on the same
seed-made points: random ones, a third of them with Z != 1, identity + P,
P + P and P - P.  The tolerance is exact equality of normalized points.

The points come from the host law and the rows are packed with numpy, so
this module needs no C++ tier: it runs first in tests/port and starts the
C++ tiers' builds for the later modules (start_builds)."""

import random
import types

import jax.numpy as jnp
import numpy as np
import pytest

from verifiable_mpc_tpu.groups.bn256 import GFp2, ORDER, P
from verifiable_mpc_tpu.groups.bn256 import BNTwistPoint as RefPoint
from verifiable_mpc_tpu.ops import bn2_pallas as ref_b2

from test_torch_bn_field import start_builds

LANES = 81  # the JAX-side group law runs eagerly on one shape
MASK64 = (1 << 64) - 1


@pytest.fixture(scope="module")
def k():
    """torch and ops.curve_bn2, imported here and not at collection (every
    xdist worker collects this file); torch on one thread."""
    import torch

    from verifiable_mpc_tpu_torch.ops import curve_bn2

    start_builds()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield types.SimpleNamespace(torch=torch, cb2=curve_bn2)
    torch.set_num_threads(n)


def _points(n, seed):
    """n twist points by the host law (a walk of random steps), every
    third one in jacobian coordinates with Z != 1."""
    rng = random.Random(seed)
    g = RefPoint.generator
    p, h = g ** rng.randrange(1, ORDER), g ** rng.randrange(1, ORDER)
    out = []
    for i in range(n):
        p = p * h
        if i % 3 == 1:
            lam = GFp2(rng.randrange(2, P), rng.randrange(P))
            q = p.normalize()  # (x, y, 1) ~ (l^2 x, l^3 y, l)
            out.append(RefPoint(q.x * lam * lam, q.y * lam * lam * lam, lam,
                                check=False))
        else:
            out.append(p)
    return out


def _lane_points(seed):
    """LANES point pairs: random, identity on either side, P + P, P - P."""
    a = _points(LANES, seed)
    b = _points(LANES, seed + 1)
    a[0] = RefPoint.identity
    b[1] = RefPoint.identity
    a[2] = b[2] = RefPoint.identity
    b[3] = a[3]
    b[4] = a[4] ** (ORDER - 1)
    return a, b


def _rows(k, pts):
    """Input rows (the format of native._bn2_pts_to_u64), packed here."""
    arr = np.zeros((len(pts), 24), np.uint64)
    for i, p in enumerate(pts):
        vals = [int(v) for c in (p.x, p.y, p.z) for v in (c.c0, c.c1)]
        arr[i] = [(v >> (64 * w)) & MASK64 for v in vals for w in range(4)]
    return k.cb2.from_u64_rows(arr, "cpu")


def _affine(p):
    """The normalized point's parts; the identity as (1, 1, 0)."""
    if RefPoint._is_identity(p):
        return ((1, 0), (1, 0), (0, 0))
    q = p.normalize()
    return tuple((int(c.c0), int(c.c1)) for c in (q.x, q.y, q.z))


def _row_affine(k, rows):
    """Normalized rows -> the same tuples."""
    u = k.cb2.to_rows(rows)
    return [tuple(tuple(sum(int(r[8 * j + 4 * h + w]) << (64 * w)
                            for w in range(4)) for h in (0, 1))
                  for j in range(3)) for r in u]


@pytest.mark.parametrize("op", ["add", "dbl", "neg_where"])
def test_group_law_matches_bn2_pallas_and_host(op, k):
    """identity + P, P + P and P - P included; neg_where flips every other
    lane."""
    a, b = _lane_points(5)
    mask = np.arange(LANES) % 2 == 0
    if op == "add":
        expect = [_affine(x * y) for x, y in zip(a, b)]
    elif op == "dbl":
        expect = [_affine(x * x) for x in a]
    else:
        expect = [_affine(x ** -1 if m else x) for x, m in zip(a, mask)]
    pa, pb = (k.cb2.split_rows(k.cb2.encode_jacobian_rows(_rows(k, pts)))
              for pts in (a, b))
    if op == "add":
        got = k.cb2.add(pa, pb)
    elif op == "dbl":
        got = k.cb2.dbl(pa)
    else:
        got = k.cb2.neg_where(k.torch.from_numpy(mask), pa)
    assert _row_affine(k, k.cb2.normalize_rows(got)) == expect
    # the JAX package's formulas on its own encoding, carried across
    consts = ref_b2._consts()
    ea = tuple(jnp.asarray(c).T for c in ref_b2.BN2.encode(a))
    eb = tuple(jnp.asarray(c).T for c in ref_b2.BN2.encode(b))
    if op == "add":
        out = ref_b2.bn2_add_lm(ea, eb, consts)
    elif op == "dbl":
        out = ref_b2.bn2_dbl_lm(ea, consts)
    else:
        out = ref_b2.BN2.neg_where(jnp.asarray(mask)[None], ea, consts)
    rows = k.cb2.from_reference_rows([np.asarray(c).T for c in out], "cpu")
    work = k.cb2.split_rows(k.cb2.encode_jacobian_rows(rows))
    assert _row_affine(k, k.cb2.normalize_rows(work)) == expect


def test_chained_group_law_stays_reduced(k):
    """Forty rounds of P <- 2P + Q in the plain law (the relaxed values'
    worst chain) equal the host law, with limbs within six reduced terms."""
    a, b = _lane_points(9)
    a, b = a[:8], b[:8]
    pa, pb = (k.cb2.split_rows(k.cb2.encode_jacobian_rows(_rows(k, pts)))
              for pts in (a, b))
    for _ in range(40):
        pa = k.cb2.add(k.cb2.dbl(pa), pb)
        a = [x * x * y for x, y in zip(a, b)]
        assert max(int(c.abs().max()) for c in pa) < 6 << 17
    assert _row_affine(k, k.cb2.normalize_rows(pa)) == [_affine(p)
                                                        for p in a]


def test_reference_rows_round_trip(k):
    """BN2.encode's six [n, 16] Montgomery limb arrays cross into the
    port's input rows and back unchanged; the rows hold the points (the
    identity as exactly (1, 1, 0)), and BN2.decode_many reads the
    returned arrays as the same points."""
    pts = _points(9, 3)
    pts[4] = RefPoint.identity
    enc = [np.asarray(c) for c in ref_b2.BN2.encode(pts)]
    rows = k.cb2.from_reference_rows(enc, "cpu")
    assert rows.shape == (9, 24) and rows.dtype == k.torch.int64
    back = k.cb2.to_reference_rows(rows)
    assert all(np.array_equal(x, y) for x, y in zip(back, enc))
    expect = [_affine(p) for p in pts]
    ref_back = ref_b2.BN2.decode_many(tuple(jnp.asarray(c) for c in back))
    assert [_affine(p) for p in ref_back] == expect
    work = k.cb2.split_rows(k.cb2.encode_jacobian_rows(rows))
    assert _row_affine(k, k.cb2.normalize_rows(work)) == expect
    assert _row_affine(k, rows)[4] == ((1, 0), (1, 0), (0, 0))
