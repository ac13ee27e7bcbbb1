"""The port's Montgomery-limb Ed25519 add (K16: ops/add_cuda.py add and
add_plain) and its host conversions (ops/limbs_mont.py) against the JAX
package: ops/limbs.py's limb conversions and Montgomery context,
ops/curve_ed.py's encode_points / decode_points limb for limb, and
curve_ed.add_with_constants (the body of pallas_kernels._add_kernel) run
eagerly on one batch of eight, never through its interpret-mode kernel.
The batch holds the identity, a doubling (p + p), p + (-p) and points with
Z != 1; the tolerance is exact equality of limbs."""

import random
import types

import numpy as np
import pytest

from verifiable_mpc_tpu.groups.edwards import ELL, P
from verifiable_mpc_tpu.groups.edwards import EdwardsPoint as RefPoint
from verifiable_mpc_tpu.ops import curve_ed as ref_ced
from verifiable_mpc_tpu.ops import limbs as ref_lb
from verifiable_mpc_tpu_torch.groups.edwards import EdwardsPoint

N = 8  # one batch shape: each JAX primitive compiles once


def _ref_batch(seed):
    rng = random.Random(seed)
    p = [RefPoint.generator ** rng.randrange(1, ELL) for _ in range(N)]
    q = [RefPoint.generator ** rng.randrange(1, ELL) for _ in range(N)]
    q[0] = RefPoint.identity
    q[1] = p[1]  # a doubling
    q[2] = p[2] ** (ELL - 1)  # p + (-p) = identity
    for i in range(3, N, 2):
        lam, a = rng.randrange(2, P), p[i]
        p[i] = RefPoint(a.x * lam, a.y * lam, a.z * lam, a.t * lam)
    return p, q


def _port(pt):
    return EdwardsPoint(pt.x, pt.y, pt.z, pt.t)


@pytest.fixture(scope="module")
def k():
    import torch

    from verifiable_mpc_tpu_torch.ops import add_cuda, limbs_mont

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield types.SimpleNamespace(torch=torch, add=add_cuda, lm=limbs_mont)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's encodings and its add of one batch, computed once
    (its jitted to_mont / from_mont and its eager add compile per shape)."""
    import jax.numpy as jnp

    p, q = _ref_batch(5)
    ep, eq = ref_ced.encode_points(p), ref_ced.encode_points(q)
    c = ref_ced.ctx()
    out = ref_ced.add_with_constants(
        ep, eq, jnp.asarray(c.p_limbs), jnp.asarray(c.n_prime_limbs),
        jnp.asarray(np.asarray(c.two_d_mont)))
    return types.SimpleNamespace(
        p=p, q=q, ep=tuple(np.array(a) for a in ep),
        eq=tuple(np.array(a) for a in eq),
        out=tuple(np.array(a) for a in out),
        decoded=ref_ced.decode_points(ep))


LIMB_EDGE = [0, 1, 0xFFFF, 1 << 16, P - 1, P, P + 1, 2 * P - 1,
             (1 << 255) - 1, (1 << 256) - 38, (1 << 256) - 1]


def test_limb_conversions_match_reference(k):
    got = k.lm.ints_to_limbs(LIMB_EDGE)
    assert got.dtype == np.uint32
    assert np.array_equal(got, ref_lb.ints_to_limbs(LIMB_EDGE))
    assert k.lm.limbs_to_ints(got) == ref_lb.limbs_to_ints(got) == LIMB_EDGE


def test_mont_round_trip_matches_reference_limb_for_limb(k, ref):
    mp = k.lm.encode_points([_port(a) for a in ref.p])
    mq = k.lm.encode_points([_port(a) for a in ref.q])
    for got, want in zip(mp + mq, ref.ep + ref.eq):
        assert got.dtype == np.uint32 and np.array_equal(got, want)
    back = k.lm.decode_points(ref.ep)
    assert [(a.x, a.y, a.z, a.t) for a in back] == [
        (a.x, a.y, a.z, a.t) for a in ref.decoded]


def test_to_and_from_mont_match_reference_context(k, ref):
    """to_mont / from_mont on the batch's limbs against the JAX package's
    Montgomery context on the same shape (its jitted REDC)."""
    c = ref_ced.ctx()
    plain = ref_lb.ints_to_limbs([a.x for a in ref.p])
    assert np.array_equal(k.lm.to_mont(plain),
                          np.asarray(c._jit("to_mont", c.to_mont)(plain)))
    assert np.array_equal(
        k.lm.from_mont(ref.ep[0]),
        np.asarray(c._jit("from_mont", c.from_mont)(ref.ep[0])))


def test_plain_add_matches_reference_add_with_constants(k, ref):
    t = k.torch
    out = k.add.add(tuple(t.from_numpy(a) for a in ref.ep),
                    tuple(t.from_numpy(a) for a in ref.eq))
    for got, want in zip(out, ref.out):
        assert got.dtype == t.uint32 and np.array_equal(got.numpy(), want)
    law = [_port(a) * _port(b) for a, b in zip(ref.p, ref.q)]
    assert k.lm.decode_points(tuple(c.numpy() for c in out)) == law
    assert k.lm.decode_points(tuple(c.numpy() for c in out))[2] == \
        EdwardsPoint.identity


@pytest.mark.parametrize("bad", ["count", "dtype", "width", "shapes",
                                 "contiguity"])
def test_add_rejects_malformed_inputs(bad, k, ref):
    t = k.torch
    p = [t.from_numpy(a) for a in ref.ep]
    q = [t.from_numpy(a) for a in ref.eq]
    if bad == "count":
        p = p[:3]
    elif bad == "dtype":
        p[0] = p[0].to(t.int64)
    elif bad == "width":
        q[1] = q[1][:, :8]
    elif bad == "shapes":
        q = [c[:4] for c in q]
    else:
        p[3] = t.from_numpy(np.asfortranarray(ref.ep[3]))
    with pytest.raises(ValueError):
        k.add.add(tuple(p), tuple(q))
