"""The port's plain BN256 base-field arithmetic in Montgomery form
(ops/field_bn254.py) against Python integers and the JAX package's
limbs_lm Montgomery functions on the same values: edge values (0, 1,
p - 1, p - 2, (p - 1) / 2, ...), products of values near p, differences
a - b with a < b, relaxed representatives in [p, 2^256), and long chains
of the group law's pattern of uncarried sums feeding products."""

import random
import threading

import jax.numpy as jnp
import numpy as np
import pytest

from verifiable_mpc_tpu import native as ref_native
from verifiable_mpc_tpu.groups.bn256 import P
from verifiable_mpc_tpu.ops import limbs_lm as lm
from verifiable_mpc_tpu_torch import _build, native

R = 1 << 256
R_INV = pow(R, -1, P)
EDGE = [0, 1, 2, 3, P // 2, P // 2 + 1, P - 3, P - 2, P - 1]
RANDOM = [random.Random(11).randrange(P) for _ in range(len(EDGE))]
RELAXED = [P, P + 1, 2 * P - 1 if 2 * P < R else R - 1, R - 2, R - 1]
P_LIMBS = lm.int_to_scalar_limbs(P)
NP_LIMBS = lm.int_to_scalar_limbs((-pow(P, -1, R)) % R)
# every JAX-side call runs eagerly on 81 lanes (9 x 9 value pairs):
# eager JAX compiles each primitive once per shape, so one shape keeps the
# reference's cost to one compile of each function (jit of these
# functions costs seconds per function, of bn_add_lm tens of seconds)
LANES = len(EDGE) ** 2


def load_reference_native():
    """The JAX package's C++ tier, loaded (the port's tests that run the
    JAX package's enable_native() call this first).

    It is built as its ``native._build`` builds it (the same sources and
    g++ flags) but one g++ per source in parallel, under the port's locked
    build.  The JAX package builds without a lock, and under xdist every
    worker builds it while collecting tests/test_native.py, so a worker
    can load a library that another is still writing and keep None for
    good: once the locked build is done, a failed load is tried again."""
    _build.build(
        ref_native._SO, ref_native._SRCS, ref_native._SRCS,
        lambda src, obj: ["g++", "-O3", "-march=native", "-fopenmp",
                          "-fPIC", "-c", "-o", obj, src],
        lambda objs, out: ["g++", "-shared", "-fopenmp", "-o", out, *objs],
        timeout=300)
    if ref_native.load() is None:
        ref_native._tried = False
    return ref_native.load()


_BUILDS = []


def start_builds():
    """Start the builds of the two C++ tiers that the port's tests load
    (the port's, and the JAX package's with its own flags), once per
    process, in threads: the first modules of tests/port need neither, so
    the builds run beside their eager JAX compiles."""
    if not _BUILDS:
        _BUILDS.extend(threading.Thread(target=f)
                       for f in (native.load, load_reference_native))
        for b in _BUILDS:
            b.start()


def join_builds():
    for b in _BUILDS:
        b.join()


@pytest.fixture(scope="module")
def tfp():
    """(torch, ops.field_bn254), imported here and not at collection:
    every xdist worker collects this file, and the CPU suite runs close to
    the host's memory limit (torch adds ~170 MB to a process).

    Its module needs no C++ tier, so it starts their builds
    (:func:`start_builds`, if an earlier module has not) and joins them
    when it ends."""
    import torch

    from verifiable_mpc_tpu_torch.ops import field_bn254 as fp

    start_builds()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch, fp
    torch.set_num_threads(n)
    join_builds()


def _port(tfp, vals):
    torch, fp = tfp
    return torch.tensor([fp.int_to_limbs(v) for v in vals], dtype=torch.int64)


def _port_ints(tfp, t):
    fp = tfp[1]
    return [fp.limbs_to_int(r) for r in fp.canon(t).tolist()]


def _ref(vals):
    assert len(vals) == LANES
    return jnp.asarray(
        np.array([lm.int_to_scalar_limbs(v) for v in vals], np.uint32).T)


def _ref_ints(a):
    return [sum(int(x) << (16 * k) for k, x in enumerate(r))
            for r in np.asarray(a).T]


BINARY = {
    "mont_mul": ("mont_mul",
                 lambda a, b: lm.mont_mul(a, b, P_LIMBS, NP_LIMBS),
                 lambda a, b: a * b * R_INV),
    "add": ("add", lambda a, b: lm.add_mod(a, b, P_LIMBS),
            lambda a, b: a + b),
    "sub": ("sub", lambda a, b: lm.sub_mod(a, b, P_LIMBS),
            lambda a, b: a - b),
}


@pytest.mark.parametrize("values", ["edge", "random"])
@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_op_matches_ints_and_limbs_lm(op, values, tfp):
    """Every pair of values (a - b with a < b, products of values near p
    included), through the port, Python ints and the JAX package."""
    vals = EDGE if values == "edge" else RANDOM
    name, ref_fn, int_fn = BINARY[op]
    xs = [a for a in vals for _ in vals]
    ys = [b for _ in vals for b in vals]
    expect = [int_fn(a, b) % P for a, b in zip(xs, ys)]
    got = getattr(tfp[1], name)(_port(tfp, xs), _port(tfp, ys))
    assert _port_ints(tfp, got) == expect
    assert _ref_ints(ref_fn(_ref(xs), _ref(ys))) == expect


@pytest.mark.parametrize("values", ["edge", "random"])
@pytest.mark.parametrize("op", ["mont_sq", "neg", "to_mont", "from_mont"])
def test_unary_op_matches_ints(op, values, tfp):
    vals = EDGE if values == "edge" else RANDOM
    int_fn = {"mont_sq": lambda a: a * a * R_INV, "neg": lambda a: -a,
              "to_mont": lambda a: a * R, "from_mont": lambda a: a * R_INV}
    expect = [int_fn[op](v) % P for v in vals]
    got = getattr(tfp[1], op)(_port(tfp, vals))
    assert _port_ints(tfp, got) == expect
    if op == "mont_sq":
        ref = lm.mont_sq(_ref(vals * len(vals)), P_LIMBS, NP_LIMBS)
        assert _ref_ints(ref) == expect * len(vals)


def test_mont_mul_const_b3(tfp):
    """3 b in Montgomery form, the constant of bn_pallas._consts."""
    fp = tfp[1]
    vals = EDGE + RANDOM
    assert fp.B3 == 9 * R % P
    assert fp.ONE == R % P
    got = fp.mont_mul_const(_port(tfp, vals), fp.B3)
    assert _port_ints(tfp, got) == [v * 9 % P for v in vals]


def test_canon_of_relaxed_representatives(tfp):
    """Limbs of values in [p, 2^256) (and negative limbs) read back as the
    canonical residue."""
    torch, fp = tfp
    vals = EDGE + RELAXED
    assert _port_ints(tfp, _port(tfp, vals)) == [v % P for v in vals]
    neg = -_port(tfp, vals)
    assert _port_ints(tfp, neg) == [-v % P for v in vals]


def test_inverse_matches_pow(tfp):
    fp = tfp[1]
    vals = [v for v in EDGE + RANDOM if v % P]
    got = fp.from_mont(fp.inv(fp.to_mont(_port(tfp, vals))))
    assert _port_ints(tfp, got) == [pow(v, P - 2, P) for v in vals]
    assert _port_ints(tfp, fp.inv(_port(tfp, [0]))) == [0]


def test_chained_ops_stay_exact(tfp):
    """Sixteen-fold uncarried sums and differences feeding products, fifty
    times over (the group law's worst pattern): exact residues."""
    fp = tfp[1]
    vals = EDGE + RANDOM
    x, y = _port(tfp, vals), _port(tfp, vals[::-1])
    xi, yi = list(vals), list(vals[::-1])
    for _ in range(50):
        s = fp.add(x, y)
        for _k in range(3):
            s = fp.add(s, s)  # 8 (x + y): sixteen reduced terms
        x, y = fp.mont_mul(s, fp.sub(y, x)), fp.mont_sq(x)
        xi, yi = ([8 * (a + b) * (b - a) * R_INV % P for a, b in zip(xi, yi)],
                  [a * a * R_INV % P for a in xi])
    assert _port_ints(tfp, x) == xi
    assert _port_ints(tfp, y) == yi
    assert int(x.abs().max()) < 1 << 17


@pytest.mark.parametrize("v", [0, 1, P - 1, R - 1, RANDOM[0]])
def test_u64_rows_round_trip(v, tfp):
    torch, fp = tfp
    limbs = [(v >> (64 * i)) & ((1 << 64) - 1) for i in range(4)]
    t = torch.from_numpy(np.array([limbs], np.uint64).view(np.int64))
    split = fp.from_u64(t)
    assert fp.limbs_to_int(split[0].tolist()) == v
    back = fp.to_u64(split).numpy().view(np.uint64)[0]
    assert sum(int(x) << (64 * i) for i, x in enumerate(back)) == v % P


def test_large_batch_route_matches_small(tfp):
    """mont_mul's row-at-a-time route (large batches) equals the
    outer-product route on the same values."""
    torch, fp = tfp
    rng = random.Random(5)
    vals = [rng.randrange(P) for _ in range(4100)]
    a, b = _port(tfp, vals), _port(tfp, vals[::-1])
    big = fp.mont_mul(a, b)
    small = torch.cat([fp.mont_mul(a[i : i + 1000], b[i : i + 1000])
                       for i in range(0, 4100, 1000)])
    assert torch.equal(fp.canon(big), fp.canon(small))
    assert _port_ints(tfp, big[:20]) == [
        x * y * R_INV % P for x, y in zip(vals[:20], vals[::-1][:20])]
