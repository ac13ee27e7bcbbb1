"""The whole slice on the CPU: the port's resident protocol-4 engine
(ac20/pivot_gpu.py) running the plain versions of its kernels
(enable_gpu(device="cpu")) proves an AC20 compressed-pivot Ed25519
circuit of 2^6 multiplications with the same normalized proof bytes as
the JAX package's enable_native() prove under one seed, and verifies
proofs through the same engine.  The cut-over is lowered to 8 so that the
engine runs its rounds at this size; ENGINE_RUNS shows it did."""

import pytest

import verifiable_mpc_tpu as ref
import verifiable_mpc_tpu.ac20.circuit_builder as ref_cb
import verifiable_mpc_tpu.ac20.circuit_sat_cb as ref_cs
from verifiable_mpc_tpu import native as ref_native
from verifiable_mpc_tpu import rng as ref_rng
from verifiable_mpc_tpu import serialization as ref_ser
from verifiable_mpc_tpu.fields import GF as RefGF
from verifiable_mpc_tpu.groups import EllipticCurve as RefCurve
from verifiable_mpc_tpu.ops import dispatch as ref_dispatch
from verifiable_mpc_tpu.tools import poly as ref_poly

import verifiable_mpc_tpu_torch as port
import verifiable_mpc_tpu_torch.ac20.circuit_builder as cb
import verifiable_mpc_tpu_torch.ac20.circuit_sat_cb as cs
from verifiable_mpc_tpu_torch import rng, serialization
from verifiable_mpc_tpu_torch.fields import GF
from verifiable_mpc_tpu_torch.groups import EllipticCurve
from verifiable_mpc_tpu_torch.groups.edwards import EdwardsPoint

from test_torch_bn_field import load_reference_native

LOG2_MULS = 6
SEED = 20261016
PC = cs.PivotChoice.compressed


@pytest.fixture(scope="module")
def pivot_gpu():
    """The port's engine module, which imports torch: imported here and not
    at collection, because every xdist worker collects this file and the
    CPU suite runs close to the host's memory limit (torch adds ~170 MB to
    a process)."""
    import torch

    from verifiable_mpc_tpu_torch.ac20 import pivot_gpu as engine

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield engine
    torch.set_num_threads(n)


def _chain(cb_mod, gf, n_muls):
    circuit = cb_mod.Circuit()
    x = cb_mod.CircuitVar(gf(3), circuit, "x")
    acc = x
    for _ in range(n_muls - 1):
        acc = acc * acc + 1
    (acc * x).label_output("out")
    return circuit


def _setup(cb_mod, cs_mod, gf_cls, curve, rng_mod):
    group = curve("Ed25519", "projective")
    gf = gf_cls(group.order)
    circuit = _chain(cb_mod, gf, 1 << LOG2_MULS)
    x = circuit.initial_inputs()
    _ok, padding, g_length = cs_mod.check_input_length_power_of_2(x, circuit)
    for i in range(padding):
        cb_mod.CircuitVar(gf(0), circuit, "unused_" + str(i))
    with rng_mod.deterministic(SEED):
        gens = cs_mod.create_generators(g_length, cs_mod.PivotChoice.compressed,
                                        group)
    return gf, circuit, circuit.initial_inputs(), gens


def _canonical(obj):
    """Points normalized: backends pick different projective
    representatives of one element; every hash sees the normalized one."""
    if hasattr(obj, "normalize"):
        return obj.normalize()
    if isinstance(obj, dict):
        return {k: _canonical(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_canonical(v) for v in obj)
    return obj


def _verified(v):
    return all(all(x.values()) if isinstance(x, dict) else bool(x)
               for x in v.values())


@pytest.fixture(scope="module")
def reference_proof():
    """The JAX package's enable_native() prove, with its global backend
    state restored afterwards."""
    saved = (dict(ref_dispatch._MSM_BACKENDS), dict(ref_dispatch._FOLD_BACKENDS),
             dict(ref_dispatch._BATCH_EXP_BACKENDS),
             dict(ref_dispatch._MSM_ASYNC_BACKENDS),
             ref_native.SCALAR_TIER, ref_native.REGISTERED,
             list(ref_poly._NTT_MUL_BACKEND))
    try:
        assert load_reference_native() is not None and ref.enable_native()
        gf, circuit, x, gens = _setup(ref_cb, ref_cs, RefGF, RefCurve, ref_rng)
        with ref_rng.deterministic(SEED + 1):
            proof = ref_cs.circuit_sat_prover(gens, circuit, x, gf,
                                              ref_cs.PivotChoice.compressed)
        return ref_ser.dumps(gens), ref_ser.dumps(proof), ref_ser.dumps(
            _canonical(proof))
    finally:
        for table, old in zip(
            (ref_dispatch._MSM_BACKENDS, ref_dispatch._FOLD_BACKENDS,
             ref_dispatch._BATCH_EXP_BACKENDS,
             ref_dispatch._MSM_ASYNC_BACKENDS), saved[:4]
        ):
            table.clear()
            table.update(old)
        ref_native.SCALAR_TIER, ref_native.REGISTERED = saved[4:6]
        ref_poly._NTT_MUL_BACKEND[:] = saved[6]


@pytest.fixture
def gpu_engine_on_cpu(monkeypatch, pivot_gpu):
    port.enable_gpu(device="cpu")
    monkeypatch.setattr(pivot_gpu, "_CUTOVER", 8)
    yield
    port.enable_native()


def test_prove_matches_reference_native_bytes(reference_proof, monkeypatch,
                                              pivot_gpu):
    """The plain comb (K4) makes the generators (every batch of 8 or more
    on the plain kernels): they equal the reference's once normalized (the
    comb returns normalized points, the C++ tier projective ones).  The
    protocol hashes the generators as given, so the prove takes the
    reference's, loaded through the serialization (docs/TRANSCRIPTS.md),
    and its normalized proof bytes equal the reference's."""
    from verifiable_mpc_tpu_torch.ops import msm_cuda

    gens_bytes, _raw, ref_bytes = reference_proof
    combs = []
    comb_rows = msm_cuda.comb_rows
    monkeypatch.setattr(msm_cuda, "comb_rows",
                        lambda *a: combs.append(1) or comb_rows(*a))
    port.enable_gpu(device="cpu", min_msm_batch=8)
    try:
        monkeypatch.setattr(pivot_gpu, "_CUTOVER", 8)
        gf, circuit, x, gens = _setup(cb, cs, GF, EllipticCurve, rng)
        assert combs, "the plain comb did not make the generators"
        ref_gens = serialization.loads(gens_bytes)
        assert serialization.dumps(_canonical(gens)) == serialization.dumps(
            _canonical(ref_gens))
        runs0 = pivot_gpu.ENGINE_RUNS
        with rng.deterministic(SEED + 1):
            proof = cs.circuit_sat_prover(ref_gens, circuit, x, gf, PC)
        assert pivot_gpu.ENGINE_RUNS > runs0, "the engine declined the prove"
        assert serialization.dumps(_canonical(proof)) == ref_bytes
    finally:
        port.enable_native()


def test_enable_native_removes_the_gpu_async_msm(pivot_gpu, monkeypatch):
    """enable_gpu() installs K1 + K2 as the Ed25519 MSM-async backend (a
    600-point multiexp_async reaches msm_cuda); enable_native() removes
    it, so the same call is the C++ tier's."""
    import random

    from verifiable_mpc_tpu_torch import native
    from verifiable_mpc_tpu_torch.groups.edwards import ELL
    from verifiable_mpc_tpu_torch.ops import dispatch, msm_cuda

    calls = []
    launch = msm_cuda._msm_launch
    monkeypatch.setattr(msm_cuda, "_msm_launch",
                        lambda p, e: calls.append(len(p)) or launch(p, e))
    rnd = random.Random(SEED)
    pts = native.ed_batch_exp(EdwardsPoint.generator,
                              [rnd.randrange(1, ELL) for _ in range(600)])
    exps = [rnd.randrange(ELL) for _ in range(600)]
    port.enable_gpu(device="cpu")
    try:
        want = dispatch.multiexp_async(pts, exps)()
        assert calls == [600]
        port.enable_native()
        assert EdwardsPoint not in dispatch._MSM_ASYNC_BACKENDS
        got = dispatch.multiexp_async(pts, exps)()
        assert calls == [600], "enable_native() left the GPU async MSM"
        assert got.normalize() == want.normalize()
    finally:
        port.enable_native()


@pytest.mark.parametrize("tamper", [False, True], ids=["as-is", "tampered"])
def test_engine_verifies_reference_proof(reference_proof, gpu_engine_on_cpu,
                                         pivot_gpu, tamper):
    """The reference's proof, carried over through the shared
    serialization format, verifies through the port's engine; a proof
    with one round message replaced does not."""
    gens_bytes, raw_bytes, _canon = reference_proof
    gf, circuit, _x, _gens = _setup(cb, cs, GF, EllipticCurve, rng)
    gens = serialization.loads(gens_bytes)
    proof = serialization.loads(raw_bytes)
    if tamper:
        pp = proof["pivot_proof"]
        pp["A1"] = pp["A1"] * EdwardsPoint.generator
    runs0 = pivot_gpu.ENGINE_RUNS
    ver = cs.circuit_sat_verifier(proof, gens, circuit, gf, PC)
    assert pivot_gpu.ENGINE_RUNS > runs0, "the engine declined the verify"
    assert _verified(ver) is not tamper


def test_engine_declines_when_disabled_small_or_not_pow2(monkeypatch,
                                                         pivot_gpu):
    gf = GF(EdwardsPoint.order)
    g = EdwardsPoint.generator
    port.enable_gpu(device="cpu")
    try:
        monkeypatch.setattr(pivot_gpu, "_CUTOVER", 8)
        assert pivot_gpu._engine_ok([g] * 16, g, gf)
        assert not pivot_gpu._engine_ok([g] * 8, g, gf)
        assert not pivot_gpu._engine_ok([g] * 24, g, gf)
        monkeypatch.setattr(pivot_gpu, "ENABLED", False)
        assert pivot_gpu.try_protocol_4_prover(
            [g] * 16, g, g, None, None, gf, {}, 0) is None
    finally:
        port.enable_native()
