"""Sparse QAP: quasi-linear Pinocchio key generation and proving.

The reference materializes every QAP polynomial by O(d^2) Lagrange
interpolation per R1CS column and evaluates p by O(m*d) polynomial sums
(reference qap_creator.py:154-176, pynocchio.py:203-211) — infeasible at
2^16 gates.  This module works in *evaluation form* with the sparse R1CS
matrices (the standard production-SNARK layout):

* key generation needs only v_i(s)/w_i(s)/y_i(s): one O(d) Lagrange-basis
  vector at s and one sparse matvec per column — no polynomials built;
* the prover computes V = sum c_i v_i (etc.) as sparse matvecs of
  *evaluations* over the 1..d domain, interpolates once (subproduct trees),
  multiplies with NTT and divides by t with Newton inversion:
  O(d log^2 d) total.

The produced keys/proofs are interchangeable with the dense path
(tests assert equality on small instances).
"""

from __future__ import annotations

from ..fields import GF
from ..tools import code_to_r1cs as c2r
from ..tools import fastpoly
from ..tools import poly as qc
from ..ac20.recombine import _recombination_vectors


class SparseQAP:
    """QAP over the 1..d interpolation domain, kept in sparse R1CS form.

    Exposes the same index partitions as the dense QAP
    (reference code_to_qap.py:30-34) so key/proof code is shared.
    """

    def __init__(self, code, field):
        inputs, body = c2r.extract_inputs_and_body(c2r.parse(code))
        flatcode = c2r.flatten_body(body)
        varnames = c2r.get_var_placement(inputs, flatcode)
        self.field = field
        self.p = field.modulus
        self.inputs = inputs
        self.flatcode = flatcode
        self.varnames = varnames
        self.d = len(flatcode)
        self.m = len(varnames) - 1
        self.out_ix = varnames.index("~out")
        self.indices = range(self.m + 1)
        self.indices_io_and_0 = range(0, self.out_ix + 1)
        self.indices_io = range(1, self.out_ix + 1)
        self.indices_mid = range(self.out_ix + 1, self.m + 1)

        # sparse columns straight from the flatcode (the dense d x (m+1)
        # matrices of flatcode_to_r1cs are O(d*m) — infeasible at 2^16)
        a_cols, b_cols, c_cols = c2r.flatcode_to_r1cs_cols(
            inputs, flatcode, varnames
        )

        def reduce_cols(cols):
            return [[(j, v % self.p) for j, v in col] for col in cols]

        self.A_cols = reduce_cols(a_cols)
        self.B_cols = reduce_cols(b_cols)
        self.C_cols = reduce_cols(c_cols)
        self._t_coeffs = None

    # -- target polynomial --------------------------------------------------
    def t_coeffs(self):
        """t = prod_{j=1..d} (X - j), built with a product tree."""
        if self._t_coeffs is None:
            level = [[(-j) % self.p, 1] for j in range(1, self.d + 1)]
            while len(level) > 1:
                nxt = []
                for i in range(0, len(level) - 1, 2):
                    nxt.append(fastpoly.poly_mul(level[i], level[i + 1], self.p))
                if len(level) % 2 == 1:
                    nxt.append(level[-1])
                level = nxt
            self._t_coeffs = level[0] if level else [1]
        return self._t_coeffs

    @property
    def t(self):
        return qc.Poly([self.field(c) for c in self.t_coeffs()])

    # -- evaluation helpers --------------------------------------------------
    def basis_at(self, s: int):
        """[lambda_j(s) for j = 1..d] in O(d) (consecutive-node fast path)."""
        row = _recombination_vectors(self.field, tuple(range(1, self.d + 1)), (int(s),))
        return row[0]

    def vwy_at(self, s: int):
        """(v_i(s), w_i(s), y_i(s)) for all i, via sparse matvecs."""
        arrs = self.vwy_at_arr(s)
        if arrs is not None:
            from .. import native

            return tuple(native._u64x4_to_ints(a) for a in arrs)
        lam = self.basis_at(s)
        p = self.p

        def col_eval(cols):
            out = [0] * (self.m + 1)
            for i, col in enumerate(cols):
                acc = 0
                for j, coeff in col:
                    acc += coeff * lam[j]
                out[i] = acc % p
            return out

        return col_eval(self.A_cols), col_eval(self.B_cols), col_eval(self.C_cols)

    def vwy_at_arr(self, s: int):
        """(v, w, y) basis evaluations as [m+1,4] u64 arrays via the C CSR
        matvec, or None without the native tier.  Same reduced values as
        the Python column loop."""
        from .. import native

        if not native.SCALAR_TIER or self.m < 256:
            return None
        import numpy as np

        p = self.p
        csr = getattr(self, "_vwy_csr", None)
        if csr is None:
            csr = []
            for cols in (self.A_cols, self.B_cols, self.C_cols):
                ptr = np.empty(len(cols) + 1, dtype=np.uint64)
                ptr[0] = 0
                idx = []
                coef = []
                for i, col in enumerate(cols):
                    for j, c in col:
                        idx.append(j)
                        coef.append(int(c) % p)
                    ptr[i + 1] = len(idx)
                csr.append(
                    (
                        ptr,
                        np.asarray(idx, dtype=np.uint64),
                        native._ints_to_u64x4(coef, p),
                    )
                )
            self._vwy_csr = csr
        lam_arr = native.lagrange_consecutive_arr(p, 1, self.d, int(s))
        return tuple(
            native.modvec_csr_dot(p, ptr, idx, coef, lam_arr)
            for ptr, idx, coef in csr
        )

    def calculate_witness(self, input_vars):
        witness = c2r.assign_variables(self.inputs, input_vars, self.flatcode)
        assert int(witness[0]) == 1, "First coordinate of witness != 1"
        return witness

    # -- prover-side evaluations --------------------------------------------
    def vwy_evals(self, c_vals):
        """Evaluations of V = sum c_i v_i, W, Y over rows 1..d: these are
        exactly the sparse R1CS row combinations A_j . c, B_j . c, C_j . c."""
        p = self.p
        c_int = [int(v) % p for v in c_vals]
        V = [0] * self.d
        W = [0] * self.d
        Y = [0] * self.d
        for cols, out in ((self.A_cols, V), (self.B_cols, W), (self.C_cols, Y)):
            for i, col in enumerate(cols):
                ci = c_int[i]
                if ci == 0:
                    continue
                for j, coeff in col:
                    out[j] = (out[j] + coeff * ci) % p
        return V, W, Y

    def h_coeffs(self, c_vals):
        """Coefficients of h = (V*W - Y) / t, exact division, O(d log^2 d)."""
        p = self.p
        V, W, Y = self.vwy_evals(c_vals)
        pts = list(range(1, self.d + 1))
        v_poly = fastpoly.interpolate(pts, V, p)
        w_poly = fastpoly.interpolate(pts, W, p)
        y_poly = fastpoly.interpolate(pts, Y, p)
        prod = fastpoly.poly_mul(v_poly, w_poly, p)
        p_poly = [
            (a - b) % p
            for a, b in zip(prod, y_poly + [0] * (len(prod) - len(y_poly)))
        ]
        q, r = fastpoly.poly_divmod(p_poly, self.t_coeffs(), p)
        assert all(x == 0 for x in r), "p(x) not divisible by t(x): bad witness"
        return q

    # -- evaluation-form h (no interpolation anywhere) ------------------------
    def lag_nodes(self):
        """The shifted evaluation domain d+1 .. 2d+1 (d+1 points): enough for
        the ZK-corrected h' = h + dv*W + dw*V + dv*dw*t - dy of degree d."""
        return range(self.d + 1, 2 * self.d + 2)

    def t_at_nodes(self):
        """[t(x) for x in lag_nodes()]: t(x) = prod_{j=1..d}(x-j) stepped
        incrementally, t(x+1) = t(x)*x/(x-d) — O(d) with one batch inverse."""
        p = self.p
        d = self.d
        nodes = list(self.lag_nodes())
        inv = fastpoly.batch_inverse([(x - d - 1) % p for x in nodes[1:]], p)
        t0 = 1
        for j in range(1, d + 1):  # t(d+1) = d!
            t0 = t0 * j % p
        out = [t0]
        for i, x in enumerate(nodes[:-1]):
            out.append(out[-1] * (x % p) % p * inv[i] % p)
        return out

    def h_evals(self, c_vals, deltas=None):
        """[h'(x) for x in lag_nodes()] fully in evaluation form: V/W/Y
        extended from 1..d by shift-of-evaluations (one C NTT convolution
        each), h = (V*W - Y)/t pointwise, ZK corrections pointwise.

        Replaces the interpolate->multiply->divide route of h_coeffs (its
        subproduct trees dominated the prover).  The coefficient path's
        remainder-zero assert is subsumed by the verifier's divisibility
        pairing check (reference pynocchio.py:276-325)."""
        p = self.p
        d = self.d
        count = d + 1
        V, W, Y = self.vwy_evals(c_vals)
        V_hi = fastpoly.shift_evaluations(V, 1, d + 1, count, p)
        W_hi = fastpoly.shift_evaluations(W, 1, d + 1, count, p)
        Y_hi = fastpoly.shift_evaluations(Y, 1, d + 1, count, p)
        t_vals = self.t_at_nodes()
        t_inv = fastpoly.batch_inverse(t_vals, p)
        out = [
            (v * w - y) % p * ti % p
            for v, w, y, ti in zip(V_hi, W_hi, Y_hi, t_inv)
        ]
        if deltas is not None:
            dv, dw = int(deltas.v) % p, int(deltas.w) % p
            dy = int(deltas.y) % p
            dvdw = dv * dw % p
            out = [
                (h + dv * w + dw * v + dvdw * t - dy) % p
                for h, v, w, t in zip(out, V_hi, W_hi, t_vals)
            ]
        return out


def generate_keys_fast(td, qap: SparseQAP, gen):
    """Evaluation-form key generation: one basis vector at td.s + sparse
    matvecs + batched fixed-base exponentiations (same key format as
    reference pynocchio.py:101-200)."""
    from ..ops.dispatch import batch_exp
    from ..tools.fastpoly import _horner

    from .. import native

    p = qap.p
    s = td.s % p
    arrs = qap.vwy_at_arr(s)  # C CSR matvecs; None without the native tier
    # t(s) = prod_{j=1..d} (s - j) directly: materializing t's COEFFICIENTS
    # (a d-leaf product tree, ~6 s at 2^17) just to Horner-evaluate one
    # point was the single largest keygen cost — and the evaluation-form
    # prover never needs the coefficients either (t_at_nodes steps values)
    t_s = 1
    for j in range(1, qap.d + 1):
        t_s = t_s * (s - j) % p

    mid = list(qap.indices_mid)
    evalkey = {}

    if arrs is not None:
        import numpy as np

        v_a, w_a, y_a = arrs
        mid_ix = np.asarray(mid, dtype=np.intp)

        def scaled_mid(scale, arr):
            # one C scale pass over the mid rows instead of a Python
            # bigint multiply-reduce per index
            sel = np.ascontiguousarray(arr[mid_ix])
            return native._u64x4_to_ints(
                native.mod_scale_arr(scale % p, sel, p)
            )

        def vals_for(arr):
            return native._u64x4_to_ints(arr)

        v_s, w_s, y_s = vals_for(v_a), vals_for(w_a), vals_for(y_a)

        def fill(fmt, base, scale, arr):
            pts = batch_exp(base, scaled_mid(scale, arr))
            for idx, pt in zip(mid, pts):
                evalkey[fmt.format(idx)] = pt

        fill("r_v*v{}*g1", gen.g1, td.r_v, v_a)
        fill("r_w*w{}*g2", gen.g2, td.r_w, w_a)
        fill("r_y*y{}*g1", gen.g1, td.r_y, y_a)
        fill("r_v*alpha_v*v{}*g1", gen.g1, td.r_v * td.alpha_v % p, v_a)
        fill("r_w*alpha_w*w{}*g1", gen.g1, td.r_w * td.alpha_w % p, w_a)
        fill("r_y*alpha_y*y{}*g1", gen.g1, td.r_y * td.alpha_y % p, y_a)
        # beta-combined rows: one 3-row C weighted sum
        wts = native._ints_to_u64x4(
            [td.r_v * td.beta % p, td.r_w * td.beta % p,
             td.r_y * td.beta % p], p,
        )
        flat = np.concatenate([v_a, w_a, y_a])
        beta_arr = native.mod_weighted_sum_arr(
            wts, flat, 3, qap.m + 1, p
        )
        beta_sel = native._u64x4_to_ints(
            np.ascontiguousarray(beta_arr[mid_ix])
        )
        pts = batch_exp(gen.g1, beta_sel)
        for idx, pt in zip(mid, pts):
            evalkey[f"r_v*beta*v+r_w*beta*w+r_y*beta*y{idx}_g1"] = pt

        s_powers = native._u64x4_to_ints(
            native.modvec_powers(p, s, qap.d + 1)
        )
    else:
        v_s, w_s, y_s = qap.vwy_at(s)

        def fill(fmt, base, scale, vals):
            scalars = [scale * int(vals[i]) % p for i in mid]
            pts = batch_exp(base, scalars)
            for idx, pt in zip(mid, pts):
                evalkey[fmt.format(idx)] = pt

        fill("r_v*v{}*g1", gen.g1, td.r_v, v_s)
        fill("r_w*w{}*g2", gen.g2, td.r_w, w_s)
        fill("r_y*y{}*g1", gen.g1, td.r_y, y_s)
        fill("r_v*alpha_v*v{}*g1", gen.g1, td.r_v * td.alpha_v % p, v_s)
        fill("r_w*alpha_w*w{}*g1", gen.g1, td.r_w * td.alpha_w % p, w_s)
        fill("r_y*alpha_y*y{}*g1", gen.g1, td.r_y * td.alpha_y % p, y_s)
        beta_combined = [
            (td.r_v * td.beta * int(v_s[i]) + td.r_w * td.beta * int(w_s[i])
             + td.r_y * td.beta * int(y_s[i])) % p
            for i in range(qap.m + 1)
        ]
        pts = batch_exp(gen.g1, [beta_combined[i] for i in mid])
        for idx, pt in zip(mid, pts):
            evalkey[f"r_v*beta*v+r_w*beta*w+r_y*beta*y{idx}_g1"] = pt

        s_powers = []
        acc = 1
        for _ in range(qap.d + 1):
            s_powers.append(acc)
            acc = acc * s % p
    pts = batch_exp(gen.g1, s_powers)
    for i, pt in enumerate(pts):
        evalkey[f"s^{i}*g1"] = pt

    # Lagrange-basis section over the shifted domain d+1..2d+1: lets the
    # prover commit h directly from evaluations (h(s)*g1 = sum h(x_j)
    # lambda_j(s) * g1 — the identical group element the power-basis MSM
    # yields), skipping all interpolation.  The power-basis entries above
    # are kept for the reference-shaped coefficient path.
    nodes = tuple(qap.lag_nodes())
    lam = _recombination_vectors(qap.field, nodes, (s,))[0]
    pts = batch_exp(gen.g1, [int(v) % p for v in lam])
    for x, pt in zip(nodes, pts):
        evalkey[f"lag{x}*g1"] = pt

    evalkey["r_v*t*g1"] = gen.g1 ** (td.r_v * t_s % p)
    evalkey["r_w*t*g2"] = gen.g2 ** (td.r_w * t_s % p)
    evalkey["r_y*t*g1"] = gen.g1 ** (td.r_y * t_s % p)
    evalkey["r_v*alpha_v*t*g1"] = gen.g1 ** (td.r_v * td.alpha_v * t_s % p)
    evalkey["r_w*alpha_w*t*g1"] = gen.g1 ** (td.r_w * td.alpha_w * t_s % p)
    evalkey["r_y*alpha_y*t*g1"] = gen.g1 ** (td.r_y * td.alpha_y * t_s % p)
    evalkey["r_v*beta*t*g1"] = gen.g1 ** (td.r_v * td.beta * t_s % p)
    evalkey["r_w*beta*t*g1"] = gen.g1 ** (td.r_w * td.beta * t_s % p)
    evalkey["r_y*beta*t*g1"] = gen.g1 ** (td.r_y * td.beta * t_s % p)
    evalkey["t*g1"] = gen.g1 ** t_s

    verikey = {
        "g1": gen.g1,
        "g2": gen.g2,
        "alpha_v*g2": td.alpha_v * gen.g2,
        "alpha_w*g1": td.alpha_w * gen.g1,
        "alpha_y*g2": td.alpha_y * gen.g2,
        "gamma*g2": td.gamma * gen.g2,
        "beta*gamma*g1": (td.beta * td.gamma) * gen.g1,
        "beta*gamma*g2": (td.beta * td.gamma) * gen.g2,
        "r_y*t*g2": gen.g2 ** (td.r_y * t_s % p),
    }
    for i in qap.indices_io_and_0:
        verikey[f"r_v*v{i}*g1"] = gen.g1 ** (td.r_v * int(v_s[i]) % p)
        verikey[f"r_w*w{i}*g2"] = gen.g2 ** (td.r_w * int(w_s[i]) % p)
        verikey[f"r_y*y{i}*g1"] = gen.g1 ** (td.r_y * int(y_s[i]) % p)
    return evalkey, verikey


def compute_proof_fast(qap: SparseQAP, c_vals, evalkey, deltas=None,
                       h_eval_vals=None):
    """Prover via evaluation-form h and the shared MSM path.

    With a Lagrange key section present (generate_keys_fast), h never
    leaves evaluation form: no interpolation, no polynomial division —
    h(s)*g1 is one MSM over the lag entries.  ``h_eval_vals`` injects
    precomputed/share-local h evaluations (Trinocchio parties).  Falls
    back to the coefficient route on power-basis-only keys."""
    from . import pynocchio
    from ..ops.dispatch import multiexp

    nodes = list(qap.lag_nodes())
    if f"lag{nodes[0]}*g1" in evalkey:
        if h_eval_vals is None:
            h_eval_vals = qap.h_evals(c_vals, deltas)
        h_g1 = multiexp(
            [evalkey[f"lag{x}*g1"] for x in nodes],
            [int(v) for v in h_eval_vals],
        )
        return pynocchio.compute_proof(
            qap, c_vals, None, evalkey, deltas, h_g1=h_g1
        )
    h = qc.Poly([qap.field(x) for x in qap.h_coeffs(c_vals)])
    if deltas is not None:
        h = h + pynocchio_h_zk_terms(qap, c_vals, deltas)
    return pynocchio.compute_proof(qap, c_vals, h, evalkey, deltas)


def pynocchio_h_zk_terms(qap: SparseQAP, c_vals, deltas):
    """ZK correction terms (reference pynocchio.py:214-225) in sparse form:
    delta_v*W + delta_w*V + delta_v*delta_w*t - delta_y."""
    p = qap.p
    V, W, Y = qap.vwy_evals(c_vals)
    pts = list(range(1, qap.d + 1))
    v_poly = fastpoly.interpolate(pts, V, p)
    w_poly = fastpoly.interpolate(pts, W, p)
    out_len = max(len(v_poly), len(w_poly), len(qap.t_coeffs()))
    out = [0] * out_len
    for i, c in enumerate(w_poly):
        out[i] = (out[i] + deltas.v * c) % p
    for i, c in enumerate(v_poly):
        out[i] = (out[i] + deltas.w * c) % p
    for i, c in enumerate(qap.t_coeffs()):
        out[i] = (out[i] + deltas.v * deltas.w % p * c) % p
    out[0] = (out[0] - deltas.y) % p
    return qc.Poly([qap.field(x) for x in out])
