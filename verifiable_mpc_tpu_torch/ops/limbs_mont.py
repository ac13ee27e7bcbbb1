"""Montgomery limbs of GF(2^255 - 19) on the host: the JAX package's
format for the unified-add kernel (B8).

The port's own copy of what it needs from the JAX package's
``ops/limbs.py`` (``ints_to_limbs``, ``limbs_to_ints``, the Montgomery
context's ``to_mont`` / ``from_mont``) and ``ops/curve_ed.py``
(``encode_points`` / ``decode_points``): a value is sixteen 16-bit limbs,
least significant first, held in uint32, and a point is four ``[n, 16]``
arrays x, y, z, t in the Montgomery domain, x * R mod p with R = 2^256.
Those functions reduce canonically, so the limbs here equal theirs limb
for limb.  numpy only: the arrays carry points between the JAX package's
Montgomery coordinates and the port, in both directions, without either
importing the other.
"""

from __future__ import annotations

import numpy as np

from ..groups.edwards import P, EdwardsPoint

LIMB_BITS = 16
LIMBS = 16  # 256 bits
R = 1 << (LIMB_BITS * LIMBS)
R_MOD_P = R % P  # 38
R_INV = pow(R, -1, P)


def ints_to_limbs(xs, limbs: int = LIMBS) -> np.ndarray:
    """Non-negative ints below 2^(16 limbs) -> [n, limbs] uint32 limbs."""
    nbytes = limbs * LIMB_BITS // 8
    raw = b"".join(int(x).to_bytes(nbytes, "little") for x in xs)
    arr = np.frombuffer(raw, dtype="<u2").reshape(len(xs), limbs)
    return arr.astype(np.uint32)


def limbs_to_ints(arr) -> list:
    """[n, limbs] limbs below 2^16 -> ints."""
    a = np.ascontiguousarray(np.asarray(arr).astype("<u2"))
    nbytes = a.shape[1] * 2
    raw = a.tobytes()
    return [int.from_bytes(raw[i * nbytes : (i + 1) * nbytes], "little")
            for i in range(a.shape[0])]


def to_mont(arr) -> np.ndarray:
    """Limbs of x (x < 2^256) -> limbs of x * R mod p."""
    return ints_to_limbs([x * R_MOD_P % P for x in limbs_to_ints(arr)])


def from_mont(arr) -> np.ndarray:
    """Limbs of a Montgomery value -> limbs of value * R^-1 mod p."""
    return ints_to_limbs([x * R_INV % P for x in limbs_to_ints(arr)])


def encode_points(points) -> tuple:
    """EdwardsPoint list -> Montgomery limbs (x, y, z, t), [n, 16] uint32
    each."""
    coords = ([pt.x for pt in points], [pt.y for pt in points],
              [pt.z for pt in points], [pt.t for pt in points])
    return tuple(to_mont(ints_to_limbs(c)) for c in coords)


def decode_points(coords) -> list:
    """Montgomery limbs (x, y, z, t) -> EdwardsPoint list."""
    vals = [limbs_to_ints(from_mont(c)) for c in coords]
    return [EdwardsPoint(x, y, z, t) for x, y, z, t in zip(*vals)]
