"""Pinocchio [PGHR13] zk-SNARK (Protocol 2) over BN256.

Behavior parity with reference
verifiable_mpc/trinocchio/pynocchio.py: trapdoor (:36-49),
ZK blinding deltas (:52-58), generators (:61-69), evaluation/verification
keys (:101-200), proof (:228-273; 8 MSMs) and the pairing-check verifier
(:276-325; 11 pairings).  H-check and ZK h-polynomial construction follow
Trinocchio (eprint 2015/480).

Deviations: every per-index exponentiation loop is expressed as a
batched scalar-vector kernel call (``ops.dispatch``), and the witness-sized
proof MSMs go through :func:`multiexp` — these are the hot spots at
2^16-gate QAPs.
"""

from __future__ import annotations

from .. import rng
from ..groups import FiniteGroupElement
from ..groups.pairing import optimal_ate
from ..ops.dispatch import multiexp
from ..tools import poly as qc

point_add = FiniteGroupElement.__matmul__


class Trapdoor:
    def __init__(self, modulus):
        r_v, r_w, s, alpha_v, alpha_w, alpha_y, beta, gamma = (
            rng.randrange(modulus) for _ in range(8)
        )
        self.r_v = r_v
        self.r_w = r_w
        self.r_y = r_v * r_w % modulus
        self.s = s
        self.alpha_v = alpha_v
        self.alpha_w = alpha_w
        self.alpha_y = alpha_y
        self.beta = beta
        self.gamma = gamma


class SampleDeltas:
    def __init__(self, modulus):
        self.v, self.w, self.y = (rng.randrange(modulus) for _ in range(3))


class Generators:
    def __init__(self, td, g1, g2):
        self.g1 = g1
        self.g2 = g2
        self.g1_v = td.r_v * g1
        self.g1_w = td.r_w * g1
        self.g2_w = td.r_w * g2
        self.g1_y = td.r_y * g1
        self.g2_y = td.r_y * g2


def pairing(a, b):
    """First input on the base curve, second on the twist
    (Pinocchio/Trinocchio notation, reference pynocchio.py:72-77)."""
    return optimal_ate(b, a)


def apply_to_list(op, inputs):
    """Binary-tree application of op (reference pynocchio.py:82-91)."""
    n = len(inputs)
    if n == 1:
        return inputs[0]
    m0 = apply_to_list(op, inputs[: n // 2])
    m1 = apply_to_list(op, inputs[n // 2 :])
    return op(m0, m1)


def g_eval(gen, poly, s, alpha=1):
    """poly(s) * alpha scaled onto gen (reference pynocchio.py:94-98)."""
    poly_at_s = poly.eval(s)
    return int(alpha * poly_at_s) * gen


def _batch_g_eval(gen, polys, s, alpha=1, field=None):
    """Evaluate many polys at s and scale gen by each value in one batch."""
    from ..ops.dispatch import batch_exp

    scalars = [int(alpha * p.eval(s)) for p in polys]
    return batch_exp(gen, scalars)


def generate_evalkey(td, qap, gen):
    """Public evaluation key (reference pynocchio.py:101-167).

    w-terms live on the twist curve; the per-family exponentiations are
    batched fixed-base kernels.
    """
    mid = list(qap.indices_mid)
    v_mid = [qap.v[i] for i in mid]
    w_mid = [qap.w[i] for i in mid]
    y_mid = [qap.y[i] for i in mid]

    v_g1_pts = _batch_g_eval(gen.g1_v, v_mid, td.s)
    w_g2_pts = _batch_g_eval(gen.g2_w, w_mid, td.s)
    y_g1_pts = _batch_g_eval(gen.g1_y, y_mid, td.s)
    av_g1_pts = _batch_g_eval(gen.g1_v, v_mid, td.s, td.alpha_v)
    aw_g1_pts = _batch_g_eval(gen.g1_w, w_mid, td.s, td.alpha_w)
    ay_g1_pts = _batch_g_eval(gen.g1_y, y_mid, td.s, td.alpha_y)

    evalkey = {}
    for j, i in enumerate(mid):
        evalkey[f"r_v*v{i}*g1"] = v_g1_pts[j]
        evalkey[f"r_w*w{i}*g2"] = w_g2_pts[j]
        evalkey[f"r_y*y{i}*g1"] = y_g1_pts[j]
        evalkey[f"r_v*alpha_v*v{i}*g1"] = av_g1_pts[j]
        evalkey[f"r_w*alpha_w*w{i}*g1"] = aw_g1_pts[j]
        evalkey[f"r_y*alpha_y*y{i}*g1"] = ay_g1_pts[j]

    # beta-combined terms: the sum of the three per-family points equals a
    # single g1 exponentiation by the combined scalar, so this is one more
    # batched fixed-base call (was the only unbatched per-index loop here)
    from ..ops.dispatch import batch_exp

    modulus = qap.field.modulus
    beta_scalars = [
        (
            td.r_v * td.beta * int(qap.v[i].eval(td.s))
            + td.r_w * td.beta * int(qap.w[i].eval(td.s))
            + td.r_y * td.beta * int(qap.y[i].eval(td.s))
        )
        % modulus
        for i in mid
    ]
    beta_pts = batch_exp(gen.g1, beta_scalars)
    for j, i in enumerate(mid):
        evalkey[f"r_v*beta*v+r_w*beta*w+r_y*beta*y{i}_g1"] = beta_pts[j]

    # powers of s
    s_powers = []
    acc = 1
    for i in range(qap.d + 1):
        s_powers.append(acc)
        acc = acc * td.s % modulus
    s_pts = batch_exp(gen.g1, s_powers)
    for i in range(qap.d + 1):
        evalkey[f"s^{i}*g1"] = s_pts[i]

    # ZK blinding elements
    evalkey.update(
        {
            "r_v*t*g1": g_eval(gen.g1_v, qap.t, td.s),
            "r_w*t*g2": g_eval(gen.g2_w, qap.t, td.s),
            "r_y*t*g1": g_eval(gen.g1_y, qap.t, td.s),
            "r_v*alpha_v*t*g1": g_eval(gen.g1_v, qap.t, td.s, td.alpha_v),
            "r_w*alpha_w*t*g1": g_eval(gen.g1_w, qap.t, td.s, td.alpha_w),
            "r_y*alpha_y*t*g1": g_eval(gen.g1_y, qap.t, td.s, td.alpha_y),
            "r_v*beta*t*g1": g_eval(gen.g1_v, qap.t, td.s, td.beta),
            "r_w*beta*t*g1": g_eval(gen.g1_w, qap.t, td.s, td.beta),
            "r_y*beta*t*g1": g_eval(gen.g1_y, qap.t, td.s, td.beta),
            "t*g1": g_eval(gen.g1, qap.t, td.s),
        }
    )
    return evalkey


def generate_verikey(td, qap, gen):
    """Public verification key (reference pynocchio.py:170-200)."""
    verikey = {
        "g1": gen.g1,
        "g2": gen.g2,
        "alpha_v*g2": td.alpha_v * gen.g2,
        "alpha_w*g1": td.alpha_w * gen.g1,
        "alpha_y*g2": td.alpha_y * gen.g2,
        "gamma*g2": td.gamma * gen.g2,
        "beta*gamma*g1": (td.beta * td.gamma) * gen.g1,
        "beta*gamma*g2": (td.beta * td.gamma) * gen.g2,
        "r_y*t*g2": g_eval(gen.g2_y, qap.t, td.s),
    }
    for i in qap.indices_io_and_0:
        verikey[f"r_v*v{i}*g1"] = g_eval(gen.g1_v, qap.v[i], td.s)
        verikey[f"r_w*w{i}*g2"] = g_eval(gen.g2_w, qap.w[i], td.s)
        verikey[f"r_y*y{i}*g1"] = g_eval(gen.g1_y, qap.y[i], td.s)
    return verikey


def compute_p_poly(qap, c):
    """p = (sum c_i v_i)(sum c_i w_i) - sum c_i y_i (reference :203-211)."""
    v_terms = apply_to_list(qc.add_polys, [qap.v[i] * c[i] for i in qap.indices])
    w_terms = apply_to_list(qc.add_polys, [qap.w[i] * c[i] for i in qap.indices])
    y_terms = apply_to_list(qc.add_polys, [qap.y[i] * c[i] for i in qap.indices])
    return (v_terms * w_terms) - y_terms


def compute_h_zk_terms(qap, c, deltas):
    """ZK correction terms for h (reference :214-225, Trinocchio style)."""
    v_terms = apply_to_list(
        qc.add_polys, [qap.w[i] * (c[i] * deltas.v) for i in qap.indices]
    )
    w_terms = apply_to_list(
        qc.add_polys, [qap.v[i] * (c[i] * deltas.w) for i in qap.indices]
    )
    return v_terms + w_terms + qap.t * (deltas.v * deltas.w) - qc.Poly([deltas.y])


def compute_proof(qap, c, h, evalkey, deltas=None, h_g1=None):
    """The 8 proof MSMs (reference :228-273), via the MSM dispatcher.

    ``h_g1`` overrides the h-polynomial MSM with a precomputed h(s)*g1
    (qap_fast's evaluation-form prover commits h through a Lagrange-basis
    key section instead of the power basis — same group element)."""
    mid = list(qap.indices_mid)
    c_mid = [int(c[i]) for i in mid]

    def mid_msm(key_fmt):
        return multiexp([evalkey[key_fmt.format(i)] for i in mid], c_mid)

    vmid_g1 = mid_msm("r_v*v{}*g1")
    wmid_g2 = mid_msm("r_w*w{}*g2")
    ymid_g1 = mid_msm("r_y*y{}*g1")
    alphavmid_g1 = mid_msm("r_v*alpha_v*v{}*g1")
    alphawmid_g1 = mid_msm("r_w*alpha_w*w{}*g1")
    alphaymid_g1 = mid_msm("r_y*alpha_y*y{}*g1")
    betavwymid_g1 = mid_msm("r_v*beta*v+r_w*beta*w+r_y*beta*y{}_g1")
    if h_g1 is None:
        h_g1 = multiexp(
            [evalkey[f"s^{i}*g1"] for i in range(len(h))],
            [int(h.coeffs[i]) for i in range(len(h))],
        )

    if deltas is not None:
        vmid_g1 = vmid_g1 + deltas.v * evalkey["r_v*t*g1"]
        wmid_g2 = wmid_g2 + deltas.w * evalkey["r_w*t*g2"]
        ymid_g1 = ymid_g1 + deltas.y * evalkey["r_y*t*g1"]
        alphavmid_g1 = alphavmid_g1 + deltas.v * evalkey["r_v*alpha_v*t*g1"]
        alphawmid_g1 = alphawmid_g1 + deltas.w * evalkey["r_w*alpha_w*t*g1"]
        alphaymid_g1 = alphaymid_g1 + deltas.y * evalkey["r_y*alpha_y*t*g1"]
        betavwymid_g1 = (
            betavwymid_g1
            + deltas.v * evalkey["r_v*beta*t*g1"]
            + deltas.w * evalkey["r_w*beta*t*g1"]
            + deltas.y * evalkey["r_y*beta*t*g1"]
        )

    return {
        "r_v*v_mid*g1": vmid_g1,
        "r_w*w_mid*g2": wmid_g2,
        "r_y*y_mid*g1": ymid_g1,
        "r_v*alpha_v*v_mid*g1": alphavmid_g1,
        "r_w*alpha_w*w_mid*g1": alphawmid_g1,
        "r_y*alpha_y*y_mid*g1": alphaymid_g1,
        "r_v*beta*v_mid+r_w*beta*w_mid+r_y*beta*y_mid*g1": betavwymid_g1,
        "h*g1": h_g1,
    }


def verify(qap, verikey, proof, c):
    """Divisibility + linear-combination + same-witness checks; 11 pairings
    (reference pynocchio.py:276-325)."""
    verification = {}

    io = list(qap.indices_io)
    c_io = [int(c[i]) for i in io]
    vio_g1 = multiexp([verikey[f"r_v*v{i}*g1"] for i in io], c_io)
    wio_g2 = multiexp([verikey[f"r_w*w{i}*g2"] for i in io], c_io)
    yio_g1 = multiexp([verikey[f"r_y*y{i}*g1"] for i in io], c_io)

    lhs1 = pairing(
        verikey["r_v*v0*g1"] + vio_g1 + proof["r_v*v_mid*g1"],
        verikey["r_w*w0*g2"] + wio_g2 + proof["r_w*w_mid*g2"],
    )
    lhs2 = pairing(yio_g1 + proof["r_y*y_mid*g1"], verikey["g2"]).inverse()
    rhs = pairing(proof["h*g1"], verikey["r_y*t*g2"])
    verification["H"] = lhs1 * lhs2 == rhs

    lhs = pairing(proof["r_v*v_mid*g1"], verikey["alpha_v*g2"])
    rhs = pairing(proof["r_v*alpha_v*v_mid*g1"], verikey["g2"])
    verification["V"] = lhs == rhs

    lhs = pairing(verikey["alpha_w*g1"], proof["r_w*w_mid*g2"])
    rhs = pairing(proof["r_w*alpha_w*w_mid*g1"], verikey["g2"])
    verification["W"] = lhs == rhs

    lhs = pairing(proof["r_y*alpha_y*y_mid*g1"], verikey["g2"])
    rhs = pairing(proof["r_y*y_mid*g1"], verikey["alpha_y*g2"])
    verification["Y"] = lhs == rhs

    lhs = pairing(
        proof["r_v*beta*v_mid+r_w*beta*w_mid+r_y*beta*y_mid*g1"], verikey["gamma*g2"]
    )
    rhs1 = pairing(
        proof["r_v*v_mid*g1"] + proof["r_y*y_mid*g1"], verikey["beta*gamma*g2"]
    )
    rhs2 = pairing(verikey["beta*gamma*g1"], proof["r_w*w_mid*g2"])
    verification["Z"] = lhs == rhs1 * rhs2

    return verification
