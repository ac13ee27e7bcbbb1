"""The plain version of the port's Ed25519 shared-base batch exponentiation
(K15: ops/msm_cuda.py batch_exp, bexp_rows, bexp_plain) against the JAX
package's msm_pallas.batch_exp path without its interpret-mode kernel:
the signed 4-bit recoding it uses (_scalar_digits_signed_any, exponents
reduced mod the order, negative and oversized ones included), its C++
tier (native.ed_batch_exp) and its host group law (__pow__), on the same
seed-made base and exponents.  The tolerance is exact equality.

As the first module of tests/port it starts the two C++ tiers' builds
(``start_builds``) and runs its recoding checks, which need neither,
before it waits for them."""

import random
import types

import numpy as np
import pytest

from verifiable_mpc_tpu import native as ref_native
from verifiable_mpc_tpu.groups.edwards import ELL
from verifiable_mpc_tpu.groups.edwards import EdwardsPoint as RefPoint
from verifiable_mpc_tpu.ops import msm_pallas as ref_mp
from verifiable_mpc_tpu_torch import native
from verifiable_mpc_tpu_torch.groups.edwards import EdwardsPoint

from test_torch_bn_field import (join_builds, load_reference_native,
                                 start_builds)

EDGE = [0, 1, ELL // 2 - 1, ELL // 2, ELL // 2 + 1, ELL - 2, ELL - 1, -1,
        -ELL // 3, ELL, ELL + 5, 3 * ELL - 1]


@pytest.fixture(scope="module")
def k():
    """torch and the port's device-side modules, imported here and not at
    collection (every xdist worker collects this file); the plain version
    runs on the CPU, torch on one thread."""
    import torch

    from verifiable_mpc_tpu_torch.ops import curve_ed, msm_cuda

    start_builds()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = msm_cuda.DEVICE
    msm_cuda.DEVICE = torch.device("cpu")
    yield types.SimpleNamespace(torch=torch, ced=curve_ed, mc=msm_cuda)
    msm_cuda.DEVICE = saved
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiers(k):
    join_builds()
    assert native.load() is not None and load_reference_native() is not None


def _exponents(n, seed):
    rng = random.Random(seed)
    return (EDGE + [rng.randrange(ELL) for _ in range(n)])[:n]


def _u64x4(scalars) -> np.ndarray:
    raw = b"".join((int(s) % ELL).to_bytes(32, "little") for s in scalars)
    return np.frombuffer(raw, dtype=np.uint64).reshape(len(scalars), 4)


RECODE_SETS = {
    "edge": EDGE,
    "near-half": [ELL // 2 + d for d in range(-40, 41)],
    "random": _exponents(200, 31),
    "short": [7, 255, 1 << 20, (1 << 32) - 1, ELL - 9],
}


@pytest.mark.parametrize("name", sorted(RECODE_SETS))
def test_recoding_matches_scalar_digits_signed_any(name, k):
    """The digits K15 reads: exponents reduced mod the order, recoded by
    the port's signed 4-bit recoder, trimmed to 8 windows when they fit,
    as _batch_exp_generic trims them on the TPU."""
    sc = RECODE_SETS[name]
    expect = ref_mp._scalar_digits_signed_any(sc, ELL)
    got = k.mc.digits_signed_from_u64x4(_u64x4(sc))
    assert np.array_equal(got, expect)
    nz = np.flatnonzero(expect.any(axis=1))
    needed = 64 - nz[0] if nz.size else 1
    nw = 8 if needed <= 8 else 64
    pk = k.mc.pack_digits(got[64 - nw:])
    back = k.mc.unpack_digits(k.torch.from_numpy(pk)).numpy()
    assert np.array_equal(back, expect[64 - nw:])


@pytest.mark.parametrize("n", [1, 17, 64])
def test_plain_batch_exp_matches_native_and_pow(n, k, tiers):
    rng = random.Random(n)
    base = RefPoint.generator ** rng.randrange(1, ELL)
    exps = _exponents(n, n + 7)
    pk, nw = k.mc.packed_digits(native._ints_to_u64x4(exps, ELL))
    ref_digits = ref_mp._scalar_digits_signed_any(exps, ELL)[64 - nw:]
    assert np.array_equal(
        k.mc.unpack_digits(k.torch.from_numpy(pk)).numpy(), ref_digits)
    got = k.mc.batch_exp(EdwardsPoint(base.x, base.y, base.z, base.t), exps)
    assert all(p.z == 1 for p in got)
    expect = ref_native.ed_batch_exp(base, exps)
    assert [(p.x, p.y) for p in got] == [
        (q.normalize().x, q.normalize().y) for q in expect]
    law = [base ** e for e in exps[:8]]
    assert [(p.x, p.y) for p in got[:8]] == [
        (q.normalize().x, q.normalize().y) for q in law]


def test_table_rows_are_the_multiples_0_to_8(k):
    base = EdwardsPoint.generator ** 99
    table = k.mc.bexp_table(base, "cpu")
    assert tuple(table.shape) == (9, 16)
    from verifiable_mpc_tpu_torch.ops.curve_ed import pre_rows

    want = pre_rows([EdwardsPoint.identity] + [base ** m for m in range(1, 9)])
    got = k.ced.to_rows(table)
    for m in range(9):  # same points; precomputed forms up to scale
        a = k.ced.split_rows(k.torch.from_numpy(got[m:m + 1].view(np.int64)))
        b = k.ced.split_rows(k.torch.from_numpy(want[m:m + 1].view(np.int64)))
        ext = [k.ced.add_pre(k.ced.identity((1,), "cpu"), q) for q in (a, b)]
        na, nb = (k.ced.normalize_rows(e) for e in ext)
        assert k.torch.equal(na, nb)


@pytest.mark.parametrize("bad", ["rows", "dtype", "digits", "windows"])
def test_bexp_rows_rejects_malformed_inputs(bad, k):
    t = k.torch
    table = k.mc.bexp_table(EdwardsPoint.generator, "cpu")
    dig = t.zeros((4, 3), dtype=t.uint8)
    if bad == "rows":
        table = table[:8]
    elif bad == "dtype":
        table = table.to(t.int32)
    elif bad == "digits":
        dig = dig.to(t.int16)
    else:
        dig = t.zeros((33, 3), dtype=t.uint8)
    with pytest.raises(ValueError):
        k.mc.bexp_rows(table, dig)


# every entry point that picks its device itself, called with two points
ENTRY_POINTS = {
    "ed.msm": lambda m, g: m.mc.msm([g, g], [1, 2]),
    "ed.msm_async": lambda m, g: m.mc.msm_async([g, g], [1, 2]),
    "ed.fold": lambda m, g: m.mc.fold([g, g], [g, g], 3),
    "ed.batch_exp_comb": lambda m, g: m.mc.batch_exp_comb(g, [1, 2]),
    "ed.batch_exp": lambda m, g: m.mc.batch_exp(g, [1, 2]),
    "ed.bexp_table": lambda m, g: m.mc.bexp_table(g),
    "ed.encode_cached": lambda m, g: m.mc.ed_encode_cached([g, g]),
    "bn.msm": lambda m, g: m.bn.msm([m.bn.BNPoint.generator] * 2, [1, 2]),
    "bn2.batch_exp": lambda m, g: m.bn2.batch_exp(
        m.bn2.BNTwistPoint.generator, [1, 2]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_raise_before_enable_gpu(name, k, monkeypatch):
    """With no device chosen (no enable_gpu() yet) an entry point raises
    instead of running its plain version on the CPU unasked."""
    from verifiable_mpc_tpu_torch.ops import msm_bn2_cuda, msm_bn_cuda

    monkeypatch.setattr(k.mc, "DEVICE", None)
    launches = dict(k.mc.LAUNCHES)
    m = types.SimpleNamespace(mc=k.mc, bn=msm_bn_cuda, bn2=msm_bn2_cuda)
    with pytest.raises(RuntimeError, match="enable_gpu"):
        ENTRY_POINTS[name](m, EdwardsPoint.generator)
    assert k.mc.LAUNCHES == launches
