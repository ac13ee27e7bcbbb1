"""Trinocchio globals: BN256 curve setup for the multi-party SNARK.

Parity with reference verifiable_mpc/trinocchio/trinocchio.py
(:13-34): curve handles, modulus and the generic point-add operator used for
exponent-space recombination.
"""

from ..groups import EllipticCurve, FiniteGroupElement

bn_curve = EllipticCurve("BN256", "jacobian")
g1 = bn_curve.generator
bn_twist = EllipticCurve("BN256_twist", "jacobian")
g2 = bn_twist.generator
modulus = bn_curve.order
point_add = FiniteGroupElement.__matmul__
