"""The port's plain GF(p^2) arithmetic over the BN256 base field in
Montgomery form (ops/field_bn254x2.py) against Python integers and the JAX
package's twist field functions (bn2_pallas._mul2 / _sq2 / _b3mul2 /
_add2 / _sub2, run eagerly on one shape) on the same values: pairs of edge
values (0, 1, p - 1, (p - 1) / 2, ...), random values, sums that carry out
of bit 256, and chains of the twist law's pattern of uncarried sums feeding
Karatsuba products."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from verifiable_mpc_tpu.groups.bn256 import B2, P
from verifiable_mpc_tpu.ops import bn2_pallas as ref_b2
from verifiable_mpc_tpu.ops import limbs_lm as lm

from test_torch_bn_field import join_builds, start_builds

R = 1 << 256
R_INV = pow(R, -1, P)
EDGE = [0, 1, 2, P // 2, P // 2 + 1, P - 3, P - 2, P - 1, R - 1 - P]
# 81 GF(p^2) values: every pair of edge parts; the JAX side runs eagerly
# on this one shape (81 lanes, as the BN field tests), so it compiles each
# primitive once
VALS = [(a, b) for a in EDGE for b in EDGE]
_rng = random.Random(12)
RANDOM = [(_rng.randrange(P), _rng.randrange(P)) for _ in range(len(VALS))]
B3 = 3 * B2  # 3 b' = 9 / xi
RELAXED = [(P, R - 1), (R - 2, P + 1), (2 * P - R + 5, R - 1 - P),
           (R - 1, 0)]


@pytest.fixture(scope="module")
def tf2():
    """(torch, ops.field_bn254x2), imported here and not at collection
    (every xdist worker collects this file); torch on one thread.

    Its module needs no C++ tier: it starts their builds (if an earlier
    module has not) and joins them when it ends, so the next module,
    test_torch_bn2_host.py or test_torch_bn2_msm.py, finds them built."""
    import torch

    from verifiable_mpc_tpu_torch.ops import field_bn254x2 as fp2

    start_builds()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch, fp2
    torch.set_num_threads(n)
    join_builds()


def _limbs(v):
    return [(v >> (16 * i)) & 0xFFFF for i in range(16)]


def _port(tf2, vals):
    torch = tf2[0]
    return torch.tensor([_limbs(a) + _limbs(b) for a, b in vals],
                        dtype=torch.int64)


def _port_ints(tf2, t):
    rows = tf2[1].canon(t).tolist()
    return [(sum(int(x) << (16 * i) for i, x in enumerate(r[:16])),
             sum(int(x) << (16 * i) for i, x in enumerate(r[16:])))
            for r in rows]


def _ref(vals):
    """JAX-side GF(p^2) value: (real, imaginary) limb-major [16, 81]."""
    return tuple(jnp.asarray(np.array([lm.int_to_scalar_limbs(v[j] % R)
                                       for v in vals], np.uint32).T)
                 for j in (0, 1))


def _ref_ints(a):
    parts = [[sum(int(x) << (16 * k) for k, x in enumerate(r))
              for r in np.asarray(c).T] for c in a]
    return [(x % P, y % P) for x, y in zip(*parts)]


def _mont(a, b):
    """(a0 + a1 i)(b0 + b1 i) R^-1 mod p, parts."""
    return ((a[0] * b[0] - a[1] * b[1]) * R_INV % P,
            (a[0] * b[1] + a[1] * b[0]) * R_INV % P)


B3_MONT = (int(B3.c0) * R % P, int(B3.c1) * R % P)
OPS = {
    "mul": (lambda f, a, b: f.mul(a, b),
            lambda a, b, k: ref_b2._mul2(a, b, k), _mont),
    "sq": (lambda f, a, b: f.sq(a), lambda a, b, k: ref_b2._sq2(a, k),
           lambda a, b: _mont(a, a)),
    "mul_b3": (lambda f, a, b: f.mul_b3(a),
               lambda a, b, k: ref_b2._b3mul2(a, k),
               lambda a, b: _mont(a, B3_MONT)),
    "add": (lambda f, a, b: f.add(a, b),
            lambda a, b, k: ref_b2._add2(a, b, k),
            lambda a, b: ((a[0] + b[0]) % P, (a[1] + b[1]) % P)),
    "sub": (lambda f, a, b: f.sub(a, b),
            lambda a, b, k: ref_b2._sub2(a, b, k),
            lambda a, b: ((a[0] - b[0]) % P, (a[1] - b[1]) % P)),
}


@pytest.mark.parametrize("values", ["edge", "random"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_op_matches_ints_and_bn2_pallas(op, values, tf2):
    """Every lane through the port, Python ints and the JAX package's
    eager twist field function (canonical inputs there, as its encoding
    gives them)."""
    vals = VALS if values == "edge" else RANDOM
    vals = [(a % P, b % P) for a, b in vals]
    ws = vals[::-1]
    port_fn, ref_fn, int_fn = OPS[op]
    expect = [int_fn(a, b) for a, b in zip(vals, ws)]
    got = port_fn(tf2[1], _port(tf2, vals), _port(tf2, ws))
    assert _port_ints(tf2, got) == expect
    out = ref_fn(_ref(vals), _ref(ws), ref_b2._consts())
    assert _ref_ints(out) == expect


def test_constants_match_bn2_pallas(tf2):
    fp2 = tf2[1]
    k = ref_b2._consts()
    for name, v in (("b3_0", fp2.B3_0), ("b3_1", fp2.B3_1),
                    ("b3_01", (fp2.B3_0 + fp2.B3_1) % P)):
        assert sum(int(x) << (16 * i) for i, x in enumerate(k[name])) == v


def test_relaxed_representatives_and_stacked_products(tf2):
    """Parts in [p, 2^256) and negative limbs read back as the canonical
    residue; several products and squares in one muls() call equal them
    one by one."""
    torch, fp2 = tf2
    vals = RELAXED + VALS
    assert _port_ints(tf2, _port(tf2, vals)) == [(a % P, b % P)
                                                 for a, b in vals]
    assert _port_ints(tf2, -_port(tf2, vals)) == [(-a % P, -b % P)
                                                  for a, b in vals]
    a, b = _port(tf2, RANDOM), _port(tf2, RANDOM[::-1])
    m, s, c = fp2.muls((a, b), (b, None), (a, fp2.b3(a.device)))
    assert torch.equal(fp2.canon(m), fp2.canon(fp2.mul(a, b)))
    assert torch.equal(fp2.canon(s), fp2.canon(fp2.sq(b)))
    assert torch.equal(fp2.canon(c), fp2.canon(fp2.mul_b3(a)))


def test_inverse_matches_pow(tf2):
    """Conjugate over the norm: a * a^-1 = 1 in Montgomery form; 0 -> 0."""
    fp2 = tf2[1]
    vals = [(a % P, b % P) for a, b in VALS[:20] + RANDOM[:20]]
    got = _port_ints(tf2, fp2.inv(_port(tf2, vals)))
    for a, r in zip(vals, got):
        if a == (0, 0):
            assert r == (0, 0)
        else:
            assert _mont(a, r) == (R % P, 0), a


def test_chained_karatsuba_stays_exact(tf2):
    """Uncarried sums of fifteen reduced values a part (a product's part
    is a sum of up to three) feeding Karatsuba products, forty times over
    (past the twist law's worst pattern, which stays within nine): exact
    residues, and the products' limbs stay reduced."""
    fp2 = tf2[1]
    x, y = _port(tf2, RANDOM), _port(tf2, VALS)
    xi = [(a % P, b % P) for a, b in RANDOM]
    yi = [(a % P, b % P) for a, b in VALS]
    for _ in range(40):
        s = fp2.add(x, y)
        s = fp2.add(fp2.add(s, s), x)  # 3 x + 2 y
        x, y = fp2.mul(s, fp2.sub(y, x)), fp2.sq(x)
        xi, yi = ([_mont(((3 * a[0] + 2 * b[0]) % P,
                          (3 * a[1] + 2 * b[1]) % P),
                         ((b[0] - a[0]) % P, (b[1] - a[1]) % P))
                   for a, b in zip(xi, yi)],
                  [_mont(a, a) for a in xi])
    assert _port_ints(tf2, x) == xi
    assert _port_ints(tf2, y) == yi
    assert int(x.abs().max()) < 3 << 17


@pytest.mark.parametrize("v", [(0, 0), (1, P - 1), (R - 1, 2), RANDOM[0]])
def test_u64_rows_round_trip(v, tf2):
    torch, fp2 = tf2
    limbs = [(v[j] >> (64 * i)) & ((1 << 64) - 1)
             for j in (0, 1) for i in range(4)]
    t = torch.from_numpy(np.array([limbs], np.uint64).view(np.int64))
    split = fp2.from_u64(t)
    assert split.shape == (1, 32)
    back = fp2.to_u64(split).numpy().view(np.uint64)[0]
    got = tuple(sum(int(x) << (64 * i) for i, x in enumerate(back[4 * j:
                                                                4 * j + 4]))
                for j in (0, 1))
    assert got == (v[0] % P, v[1] % P)
