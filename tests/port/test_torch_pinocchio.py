"""The BN256 slices on the CPU: Pinocchio key generation and proving of a
chain circuit through the port's enable_gpu(device="cpu") -- the plain
versions of kernels K5-K8 serve every G1 MSM and fixed-base batch of 8 or
more, those of the twist's K9-K11 every twist MSM and batch-exp of 8 or
more -- against the JAX package's enable_native() run under one seed.
Every normalized evaluation-key entry (twist entries included) and proof
element must be equal, the proof must verify, and the launch counts of the
plain path stay 0 (plain versions launch nothing) while the dispatch shows
the plain backends served the calls, G1 and twist counted apart."""

import contextlib
import types

import pytest

import verifiable_mpc_tpu as ref
import verifiable_mpc_tpu.trinocchio.pynocchio as ref_pyn
import verifiable_mpc_tpu.trinocchio.qap_fast as ref_qf
from verifiable_mpc_tpu import native as ref_native
from verifiable_mpc_tpu import rng as ref_rng
from verifiable_mpc_tpu import serialization as ref_ser
from verifiable_mpc_tpu.fields import GF as RefGF
from verifiable_mpc_tpu.groups import EllipticCurve as RefCurve
from verifiable_mpc_tpu.ops import dispatch as ref_dispatch
from verifiable_mpc_tpu.tools import poly as ref_poly

import verifiable_mpc_tpu.ac20.circuit_builder as ref_cb
import verifiable_mpc_tpu.ac20.circuit_sat_cb as ref_cs
import verifiable_mpc_tpu.tools.code_to_qap as ref_c2q
import verifiable_mpc_tpu_torch as port
import verifiable_mpc_tpu_torch.ac20.circuit_builder as cb
import verifiable_mpc_tpu_torch.ac20.circuit_sat_cb as cs
import verifiable_mpc_tpu_torch.tools.code_to_qap as c2q
import verifiable_mpc_tpu_torch.trinocchio.pynocchio as pyn
import verifiable_mpc_tpu_torch.trinocchio.qap_fast as qf
from verifiable_mpc_tpu_torch import rng, serialization
from verifiable_mpc_tpu_torch.fields import GF
from verifiable_mpc_tpu_torch.groups import EllipticCurve

from test_torch_bn_field import load_reference_native

LOG2_MULS = 3
SEED = 20261017
# the KoE pivot's chain: 2 multiplications give a vector of 15, the fewest
# that reach the lowered thresholds (8), so the plain K5 + K6 and K9 + K10
# compute the KoE commitment (a single one gives 7)
KOE_MULS = 2


def chain_code(n_muls: int) -> str:
    """x_{i+1} = x_i * x_i + 1 chain with n_muls mul gates (the circuit of
    bench_snark.chain_code)."""
    lines = ["def qeval(x):", "    a0 = x * x + 1"]
    for i in range(1, n_muls - 1):
        lines.append(f"    a{i} = a{i-1} * a{i-1} + 1")
    lines.append(f"    return a{n_muls-2} * x")
    return "\n".join(lines) + "\n"


def _canonical(obj):
    if hasattr(obj, "normalize"):
        return obj.normalize()
    if isinstance(obj, dict):
        return {k: _canonical(v) for k, v in obj.items()}
    return obj


def _setup(qf_mod, pyn_mod, gf_cls, curve):
    g1 = curve("BN256", "jacobian")
    g2 = curve("BN256_twist", "jacobian")
    gf = gf_cls(g1.order)
    gf.is_signed = False
    qap = qf_mod.SparseQAP(chain_code(1 << LOG2_MULS), gf)
    return g1, g2, gf, qap


def _keygen(qf_mod, pyn_mod, g1, g2, qap, rng_mod):
    with rng_mod.deterministic(SEED):
        td = pyn_mod.Trapdoor(g1.order)
        gen = pyn_mod.Generators(td, g1.generator, g2.generator)
        return qf_mod.generate_keys_fast(td, qap, gen)


def _prove(qf_mod, pyn_mod, g1, gf, qap, evalkey, rng_mod):
    c = qap.calculate_witness([gf(3)])
    with rng_mod.deterministic(SEED + 1):
        deltas = pyn_mod.SampleDeltas(g1.order)
        return c, qf_mod.compute_proof_fast(qap, c, evalkey, deltas)


def _dense_evalkey(c2q_mod, pyn_mod, g1, g2, gf, rng_mod):
    """The reference-shaped key path: a dense QAP (tools/code_to_qap) and
    pynocchio.generate_evalkey, at 2^2 multiplications."""
    qap = c2q_mod.QAP(chain_code(4), gf)
    with rng_mod.deterministic(SEED + 2):
        td = pyn_mod.Trapdoor(g1.order)
        gen = pyn_mod.Generators(td, g1.generator, g2.generator)
        return pyn_mod.generate_evalkey(td, qap, gen)


@pytest.fixture(scope="module")
def reference_run():
    """The JAX package's enable_native() keygen + prove (normalized
    evalkey and proof bytes), with its global backend state restored."""
    tables = (ref_dispatch._MSM_BACKENDS, ref_dispatch._FOLD_BACKENDS,
              ref_dispatch._BATCH_EXP_BACKENDS,
              ref_dispatch._MSM_ASYNC_BACKENDS)
    saved = ([dict(t) for t in tables], ref_native.SCALAR_TIER,
             ref_native.REGISTERED, list(ref_poly._NTT_MUL_BACKEND))
    try:
        assert load_reference_native() is not None and ref.enable_native()
        g1, g2, gf, qap = _setup(ref_qf, ref_pyn, RefGF, RefCurve)
        evalkey, _verikey = _keygen(ref_qf, ref_pyn, g1, g2, qap, ref_rng)
        _c, proof = _prove(ref_qf, ref_pyn, g1, gf, qap, evalkey, ref_rng)
        dense = _dense_evalkey(ref_c2q, ref_pyn, g1, g2, gf, ref_rng)
        return (ref_ser.dumps(_canonical(evalkey)),
                ref_ser.dumps(_canonical(proof)),
                ref_ser.dumps(_canonical(dense)))
    finally:
        for table, old in zip(tables, saved[0]):
            table.clear()
            table.update(old)
        ref_native.SCALAR_TIER, ref_native.REGISTERED = saved[1:3]
        ref_poly._NTT_MUL_BACKEND[:] = saved[3]


@contextlib.contextmanager
def _signed(gf):
    """GF(p) is one class per modulus, and _setup turns its is_signed off
    for Pinocchio: the KoE transcript hashes field elements by their
    representatives, so its prove and verify run with the default (signed)
    whichever tests of the module ran before them in the process."""
    old = gf.is_signed
    gf.is_signed = True
    try:
        yield
    finally:
        gf.is_signed = old


def _koe_prove(cb_mod, cs_mod, gf_cls, curve, rng_mod):
    """(generators, circuit, gf, proof) of AC20 circuit satisfiability with
    the KoE pivot over BN256, a chain of KOE_MULS multiplications padded as
    bench_ac20.py --pivot koe pads it."""
    group = [curve("BN256", "jacobian"), curve("BN256_twist", "jacobian")]
    gf = gf_cls(group[0].order)
    circuit = cb_mod.Circuit()
    x = cb_mod.CircuitVar(gf(3), circuit, "x")
    acc = x
    for _ in range(KOE_MULS - 1):
        acc = acc * acc + 1
    (acc * x).label_output("out")
    inputs = circuit.initial_inputs()
    _ok, padding, g_length = cs_mod.check_input_length_power_of_2(inputs,
                                                                  circuit)
    for i in range(padding):
        cb_mod.CircuitVar(gf(0), circuit, "unused_" + str(i))
    pc = cs_mod.PivotChoice.koe
    with _signed(gf), rng_mod.deterministic(SEED + 3):
        gens = cs_mod.create_generators(g_length, pc, group)
    with _signed(gf), rng_mod.deterministic(SEED + 4):
        proof = cs_mod.circuit_sat_prover(gens, circuit,
                                          circuit.initial_inputs(), gf, pc)
    return gens, circuit, gf, proof


@pytest.fixture(scope="module")
def reference_koe(monkeypatch_module):
    """The JAX package's enable_native() KoE prove, normalized bytes.  The
    protocol hashes the KoE commitment {P, pi} as the backend returned it
    (circuit_sat_cb.py:91-97), and the port's kernels return normalized
    points: the C++ tier's BN and twist MSM results are normalized here,
    in this process only, before enable_native() installs them."""
    for name in ("bn_msm", "bn2_msm"):
        fn = getattr(ref_native, name)
        monkeypatch_module.setattr(
            ref_native, name, lambda *a, _fn=fn: _fn(*a).normalize())
    tables = (ref_dispatch._MSM_BACKENDS, ref_dispatch._FOLD_BACKENDS,
              ref_dispatch._BATCH_EXP_BACKENDS,
              ref_dispatch._MSM_ASYNC_BACKENDS)
    saved = ([dict(t) for t in tables], ref_native.SCALAR_TIER,
             ref_native.REGISTERED, list(ref_poly._NTT_MUL_BACKEND))
    try:
        assert load_reference_native() is not None and ref.enable_native()
        _gens, _circuit, _gf, proof = _koe_prove(ref_cb, ref_cs, RefGF,
                                                 RefCurve, ref_rng)
        return ref_ser.dumps(_canonical(proof))
    finally:
        for table, old in zip(tables, saved[0]):
            table.clear()
            table.update(old)
        ref_native.SCALAR_TIER, ref_native.REGISTERED = saved[1:3]
        ref_poly._NTT_MUL_BACKEND[:] = saved[3]


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def port_backend():
    """enable_gpu on the CPU (the plain versions of K5-K11 behind the
    dispatch, batches from 8: the BN and twist thresholds lowered as the
    pivot tests lower the engine's cut-over), counting which backend served
    each G1 and each twist call; enable_native afterwards."""
    import torch

    from verifiable_mpc_tpu_torch.groups.bn256 import BNPoint, BNTwistPoint
    from verifiable_mpc_tpu_torch.ops import (dispatch, msm_bn2_cuda,
                                              msm_bn_cuda, msm_cuda)

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    served = {"msm": 0, "batch_exp": 0, "twist_msm": 0,
              "twist_batch_exp": 0}
    wrapped = ((msm_bn_cuda, "msm", "msm"),
               (msm_bn_cuda, "batch_exp_comb", "batch_exp"),
               (msm_bn2_cuda, "msm", "twist_msm"),
               (msm_bn2_cuda, "batch_exp", "twist_batch_exp"))
    real = [getattr(mod, name) for mod, name, _key in wrapped]

    def counted(fn, key):
        def call(*args):
            served[key] += 1
            return fn(*args)

        return call

    for (mod, name, key), fn in zip(wrapped, real):
        setattr(mod, name, counted(fn, key))
    thresholds = (port.BN_MIN_MSM_BATCH, port.BN2_MIN_BATCH)
    port.BN_MIN_MSM_BATCH = port.BN2_MIN_BATCH = 8
    try:
        port.enable_gpu(device="cpu", min_msm_batch=8)
        assert BNPoint in dispatch._FOLD_BACKENDS
        assert BNTwistPoint in dispatch._FOLD_BACKENDS
        msm_cuda.reset_launches()
        yield types.SimpleNamespace(served=served, launches=msm_cuda.LAUNCHES)
    finally:
        for (mod, name, _key), fn in zip(wrapped, real):
            setattr(mod, name, fn)
        port.BN_MIN_MSM_BATCH, port.BN2_MIN_BATCH = thresholds
        port.enable_native()
        torch.set_num_threads(n)
    # enable_native: the folds step aside
    assert BNPoint not in dispatch._FOLD_BACKENDS
    assert BNTwistPoint not in dispatch._FOLD_BACKENDS


@pytest.fixture(scope="module")
def port_keys(port_backend):
    g1, g2, gf, qap = _setup(qf, pyn, GF, EllipticCurve)
    evalkey, verikey = _keygen(qf, pyn, g1, g2, qap, rng)
    served = dict(port_backend.served)
    return types.SimpleNamespace(g1=g1, gf=gf, qap=qap, evalkey=evalkey,
                                 verikey=verikey, served=served)


@pytest.fixture(scope="module")
def port_proof(port_backend, port_keys):
    k = port_keys
    before = dict(port_backend.served)
    c, proof = _prove(qf, pyn, k.g1, k.gf, k.qap, k.evalkey, rng)
    served = {key: v - before[key] for key, v in port_backend.served.items()}
    return types.SimpleNamespace(c=c, proof=proof, served=served,
                                 launches=dict(port_backend.launches))


def test_plain_kernels_served_keygen(port_keys):
    """Keygen's five G1 fills, beta row, s-powers and Lagrange section are
    fixed-base batches (K8's plain version); its twist fill (the w-terms)
    is one twist batch-exp (K11's plain version)."""
    assert len(list(port_keys.qap.indices_mid)) >= 8, "below the threshold"
    assert port_keys.served == {"msm": 0, "batch_exp": 8, "twist_msm": 0,
                                "twist_batch_exp": 1}


def test_plain_kernels_served_prove(port_proof):
    """The prove's six G1 mid MSMs and the h MSM are K5 + K6's plain
    versions, its twist MSM (wmid_g2) K9 + K10's; plain versions launch no
    kernel."""
    assert port_proof.served == {"msm": 7, "batch_exp": 0, "twist_msm": 1,
                                 "twist_batch_exp": 0}
    assert not any(port_proof.launches.values())


def test_evalkey_matches_reference(reference_run, port_keys):
    got = serialization.dumps(_canonical(port_keys.evalkey))
    assert got == reference_run[0]


def test_proof_matches_reference(reference_run, port_proof):
    got = serialization.dumps(_canonical(port_proof.proof))
    assert got == reference_run[1]


def test_dense_evalkey_matches_reference(reference_run, port_backend,
                                        port_keys):
    """generate_evalkey over tools/code_to_qap's dense QAP: its fixed-base
    batches of 8 or more go through K8's plain version."""
    k = port_keys
    g2 = EllipticCurve("BN256_twist", "jacobian")
    before = port_backend.served["batch_exp"]
    ek = _dense_evalkey(c2q, pyn, k.g1, g2, k.gf, rng)
    assert port_backend.served["batch_exp"] > before
    assert serialization.dumps(_canonical(ek)) == reference_run[2]


def test_proof_verifies(port_keys, port_proof):
    k = port_keys
    ver = pyn.verify(k.qap, k.verikey, port_proof.proof,
                     port_proof.c[: k.qap.out_ix + 1])
    assert all(ver.values()), ver


def test_koe_matches_reference_normalized_bytes(reference_koe, port_backend):
    """The KoE pivot through the plain kernels: K8 and K11 make the
    generators, K5 + K6 and K9 + K10 the commitment and the opening; the
    normalized proof bytes equal the reference's (its BN and twist MSM
    results normalized, see reference_koe) and the proof verifies."""
    before = dict(port_backend.served)
    gens, circuit, gf, proof = _koe_prove(cb, cs, GF, EllipticCurve, rng)
    served = {k: v - before[k] for k, v in port_backend.served.items()}
    assert served["msm"] >= 2 and served["twist_msm"] >= 1, served
    assert served["batch_exp"] >= 1 and served["twist_batch_exp"] >= 1
    assert serialization.dumps(_canonical(proof)) == reference_koe
    with _signed(gf):
        ver = cs.circuit_sat_verifier(proof, gens, circuit, gf,
                                      cs.PivotChoice.koe)
    assert all(all(v.values()) if isinstance(v, dict) else bool(v)
               for v in ver.values())
