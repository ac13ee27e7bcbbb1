"""The probe slice on the CPU: the plain versions beside the probe kernels
P1-P4 (verifiable_mpc_tpu_torch/probes) against the bodies the JAX
package's probes time (probes/probe_vpu.py, probes/probe_carrychain.py),
run on the CPU on inputs drawn from numpy seeds.  u32 results must be
equal, field results equal as canonical residues (inputs at or above p
included, as the TPU probes draw raw 16-bit limbs), f32 results within
F32_ULPS units in the last place (one fused rounding a step against the
JAX body's two).  The probes' entry points refuse to run without a card
unless device="cpu" is given."""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from verifiable_mpc_tpu.groups.bn256 import P as P_BN
from verifiable_mpc_tpu.groups.edwards import P as ED_P
from verifiable_mpc_tpu.ops import limbs_lm

R = 1 << 256
F32_ULPS = 4
FIELD_BATCH = (16, 4, 64)
FIELD_STEPS = 4

# probe_vpu.py:53-59 builds these bodies inside main(); restated here
JAX_BODIES = {
    "u32_mul_split": lambda x, y: ((x * y) & 0xFFFF) + ((x * y) >> 16),
    "u32_mul": lambda x, y: x * y + jnp.uint32(1),
    "u32_add": lambda x, y: (x + y) ^ x,
    "f32_fma": lambda x, y: x * y + x,
}


@pytest.fixture(scope="module")
def pr():
    """torch and the probe modules, imported here and not at collection
    (every xdist worker collects this file)."""
    import torch

    from verifiable_mpc_tpu_torch import probes
    from verifiable_mpc_tpu_torch.probes import probe_carrychain, probe_vpu

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield types.SimpleNamespace(torch=torch, probes=probes, pv=probe_vpu,
                                pc=probe_carrychain)
    torch.set_num_threads(n)


def _ints(limbs):
    """[16, *B] limbs (numpy or torch) -> Python ints."""
    a = np.asarray(limbs).astype(np.int64).reshape(16, -1)
    return [sum(int(a[k, i]) << (16 * k) for k in range(16))
            for i in range(a.shape[1])]


def _field_operands(seed):
    """Raw 16-bit limbs, with lanes at and above p25519 and p_bn and the
    largest value placed in the batch."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 1 << 16, FIELD_BATCH).astype(np.uint32)
    y = rng.randint(0, 1 << 16, FIELD_BATCH).astype(np.uint32)
    for i, v in enumerate((ED_P, ED_P + 1, R - 1, P_BN, 2 * P_BN)):
        x[:, 0, i] = [(v >> (16 * k)) & 0xFFFF for k in range(16)]
    xs = _ints(x)
    assert sum(v >= ED_P for v in xs) > len(xs) // 3
    return x, y


@pytest.mark.parametrize("name", list(JAX_BODIES))
def test_vpu_plain_matches_jax_body(pr, name):
    rng = np.random.RandomState(11)
    shape = (8, 128)
    if name == "f32_fma":
        x = rng.rand(*shape).astype(np.float32)
        y = rng.rand(*shape).astype(np.float32)
    else:
        x = rng.randint(1, 1 << 15, shape).astype(np.uint32)
        y = rng.randint(1, 1 << 15, shape).astype(np.uint32)
    body = JAX_BODIES[name]
    yj = jnp.asarray(y)
    want = np.asarray(jax.lax.fori_loop(0, 3, lambda _, v: body(v, yj),
                                        jnp.asarray(x)))
    got = pr.pv.plain_vpu_op(name, pr.torch.from_numpy(x),
                             pr.torch.from_numpy(y), 3).numpy()
    if name == "f32_fma":
        ulps = np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32).astype(np.int64))
        assert ulps.max() <= F32_ULPS
    else:
        assert np.array_equal(got, want)


def test_vpu_plain_matches_python_ints_across_wraparound(pr):
    """Full 32-bit inputs (products far above 2^32) against Python ints."""
    rng = np.random.RandomState(12)
    x = rng.randint(0, 1 << 32, 64, dtype=np.int64)
    y = rng.randint(0, 1 << 32, 64, dtype=np.int64)
    x[:2], y[:2] = (1 << 32) - 1, (1 << 32) - 1
    step = {"u32_mul_split": lambda a, b: ((a * b) % (1 << 32) & 0xFFFF)
            + ((a * b) % (1 << 32) >> 16),
            "u32_mul": lambda a, b: (a * b + 1) % (1 << 32),
            "u32_add": lambda a, b: ((a + b) % (1 << 32)) ^ a}
    for name, fn in step.items():
        want = []
        for a, b in zip(x.tolist(), y.tolist()):
            for _ in range(5):
                a = fn(a, b)
            want.append(a)
        got = pr.pv.plain_vpu_op(
            name, pr.torch.from_numpy(x.astype(np.uint32)),
            pr.torch.from_numpy(y.astype(np.uint32)), 5)
        assert got.to(pr.torch.int64).tolist() == want, name


@pytest.fixture(scope="module")
def jax_products():
    """probe_vpu.py:75-79's products, jitted: mul25519, and mont_mul with
    p25519's constants (R = 2^256)."""
    p_limbs = limbs_lm.int_to_scalar_limbs(ED_P)
    n_prime = limbs_lm.int_to_scalar_limbs((-pow(ED_P, -1, R)) % R)
    return {
        "mul25519": jax.jit(limbs_lm.mul25519),
        "mont_mul": jax.jit(lambda a, b: limbs_lm.mont_mul(
            a, b, p_limbs, n_prime)),
    }


def _want(name, x, y, steps):
    """x * (y * s)^steps mod p on Python ints: s = 1 for mul25519, R^-1
    for the Montgomery products."""
    p = P_BN if name == "fp_mul" else ED_P
    s = 1 if name == "mul25519" else pow(R, -1, p)
    return [xv * pow(yv * s, steps, p) % p
            for xv, yv in zip(_ints(x), _ints(y))]


@pytest.mark.parametrize("name", ["mul25519", "mont_mul"])
def test_field_plain_matches_jax_product(pr, jax_products, name):
    x, y = _field_operands(13)
    a = jnp.asarray(x)
    for _ in range(FIELD_STEPS):
        a = jax_products[name](a, jnp.asarray(y))
    want = [v % ED_P for v in _ints(a)]
    assert want == _want(name, x, y, FIELD_STEPS)
    got = pr.pv.plain_field_chain(name, pr.torch.from_numpy(x),
                                  pr.torch.from_numpy(y), FIELD_STEPS)
    assert _ints(got.numpy()) == want
    # the kernel's results are relaxed: canonical() reduces them
    assert pr.torch.equal(pr.pv.canonical(name, got), got)


def test_bn_product_plain_matches_python_ints(pr):
    """The third P2 row, fp_mul (BN256's Montgomery product), on inputs at
    and above that p."""
    x, y = _field_operands(16)
    got = pr.pv.plain_field_chain("fp_mul", pr.torch.from_numpy(x),
                                  pr.torch.from_numpy(y), FIELD_STEPS)
    assert _ints(got.numpy()) == _want("fp_mul", x, y, FIELD_STEPS)


def test_chain_plain_matches_jax_mul25519(pr, jax_products):
    """P3's chains (one and four) against jitted limbs_lm.mul25519."""
    fn = jax_products["mul25519"]
    rng = np.random.RandomState(7)
    ops = pr.pc.operands(rng, 4, FIELD_BATCH)
    got = pr.pc.chain(ops[:4], ops[4], FIELD_STEPS)
    (one,) = pr.pc.chain(ops[:1], ops[4], FIELD_STEPS)
    assert pr.torch.equal(one, got[0])
    b = jnp.asarray(ops[4].numpy())
    for a0, g in zip(ops[:4], got):
        a = jnp.asarray(a0.numpy())
        for _ in range(FIELD_STEPS):
            a = fn(a, b)
        assert _ints(g.numpy()) == [v % ED_P for v in _ints(a)]


def test_word_layout_round_trip(pr):
    x, _y = _field_operands(14)
    t = pr.torch.from_numpy(x)
    w = pr.probes.limbs_to_words(t)
    assert tuple(w.shape) == (8, 4 * 64)
    assert pr.torch.equal(pr.probes.words_to_limbs(w, t.shape[1:]), t)
    vals = _ints(x)
    wi = w.to(pr.torch.int64).numpy()
    assert vals == [sum(int(wi[k, i]) << (32 * k) for k in range(8))
                    for i in range(wi.shape[1])]


def test_raw_plain_matches_numpy(pr):
    rng = np.random.RandomState(15)
    x = rng.randint(0, 1 << 16, (16, 8, 16)).astype(np.uint32)
    y = rng.randint(0, 1 << 16, (16, 8, 16)).astype(np.uint32)
    want = x.copy()
    for _ in range(100):
        want = want * y + np.uint32(1)
    got = pr.pc.plain_raw(pr.torch.from_numpy(x), pr.torch.from_numpy(y), 100)
    assert np.array_equal(got.numpy(), want)


def test_wrappers_take_the_plain_version_on_the_cpu(pr):
    """The kernel wrappers on CPU tensors give the plain versions' results
    and launch nothing."""
    pr.probes.reset_launches()
    xu, yu, xf, yf, xm, ym = pr.pv.inputs((2, 64), (16, 2, 8), seed=3)
    for name in pr.pv.CASES:
        x, y = (xf, yf) if name == "f32_fma" else (xu, yu)
        assert pr.torch.equal(pr.pv.vpu_op(name, x, y, 17),
                              pr.pv.plain_vpu_op(name, x, y, 17))
    assert pr.torch.equal(pr.pv.field_chain("mont_mul", xm, ym, 2),
                          pr.pv.plain_field_chain("mont_mul", xm, ym, 2))
    assert pr.torch.equal(pr.pc.raw(xu, yu, 9), pr.pc.plain_raw(xu, yu, 9))
    assert set(pr.probes.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):
        pr.pv.vpu_op("u32_mul", xf, yf, 1)
    with pytest.raises(ValueError):
        pr.pc.chain_words(pr.torch.zeros((2, 8, 4), dtype=pr.torch.uint32),
                          pr.torch.zeros((8, 4), dtype=pr.torch.uint32), 1)


@pytest.mark.parametrize("module", ["probe_vpu", "probe_carrychain"])
def test_entry_points_need_a_card_unless_cpu(pr, module, capsys):
    mod = getattr(pr, "pv" if module == "probe_vpu" else "pc")
    if pr.torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run()
    if module == "probe_vpu":  # its main() takes the TPU probe's counts
        dev = pr.torch.device("cpu")
        rows = mod.run("cpu", iters=2, field_iters=1)
        mod.show(rows, dev)
    else:
        rows = mod.main(["2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "card: cpu" in out and rows
    assert all(r["model_rate"] is None and r["shape"] == "tpu" for r in rows)
