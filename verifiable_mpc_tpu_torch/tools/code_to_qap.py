"""Bundle code-string -> R1CS -> QAP (reference tools/code_to_qap.py)."""

from __future__ import annotations

from . import code_to_r1cs as c2r
from . import poly as qc


class QAP:
    """Quadratic arithmetic program for a code-string circuit.

    Attribute parity with the reference QAP class (code_to_qap.py:5-39):
    v/w/y polynomial lists, target t, index partitions indices_io/indices_mid.
    """

    def __init__(self, code, field):
        inputs, body = c2r.extract_inputs_and_body(c2r.parse(code))
        flatcode = c2r.flatten_body(body)
        varnames = c2r.get_var_placement(inputs, flatcode)
        V, W, Y = c2r.flatcode_to_r1cs(inputs, flatcode)
        V = [[field(x) for x in row] for row in V]
        W = [[field(x) for x in row] for row in W]
        Y = [[field(x) for x in row] for row in Y]
        v, w, y, t = qc.r1cs_to_qap_ff(V, W, Y, field)
        self.v = [qc.Poly(coeffs) for coeffs in v]
        self.w = [qc.Poly(coeffs) for coeffs in w]
        self.y = [qc.Poly(coeffs) for coeffs in y]
        self.t = qc.Poly(t)
        self.field = field
        self.inputs = inputs
        self.flatcode = flatcode
        self.varnames = varnames
        self.d = len(flatcode)
        self.m = len(varnames) - 1  # `~one` not counted
        self.out_ix = varnames.index("~out")
        self.indices = range(self.m + 1)
        self.indices_io_and_0 = range(0, self.out_ix + 1)  # includes "one"
        self.indices_io = range(1, self.out_ix + 1)
        self.indices_mid = range(self.out_ix + 1, self.m + 1)

    def calculate_witness(self, input_vars):
        witness = c2r.assign_variables(self.inputs, input_vars, self.flatcode)
        assert int(witness[0]) == 1, "First coordinate of witness != 1"
        return witness


def calculate_witness(code, input_vars):
    inputs, body = c2r.extract_inputs_and_body(c2r.parse(code))
    flatcode = c2r.flatten_body(body)
    return c2r.assign_variables(inputs, input_vars, flatcode)
