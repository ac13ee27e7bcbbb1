"""GPU-resident engine for the Protocol-4 compression loop (Ed25519).

Counterpart of the JAX package's ``ac20/pivot_tpu.py``.  The generator
vector stays on the device as ``[n, 16]`` rows across rounds (reference
compressed_pivot.py:29-86 / :148-202), and each round runs

* both A/B MSMs of the round in one K1 + K2 launch (:func:`_round_msms`),
  without the k^y term, which the host multiplies in (the commitment is a
  product, so the group element and its normalized hash bytes are the
  same);
* the generator fold with its batch normalization (K3), which returns the
  canonical z = 1 rows both as the next round's resident state and, after
  one download, as the input of the host Fiat-Shamir hash of g_hat,

while the O(n) scalar work (linear-form dots, z / L folds) stays on the
C++ vector tier exactly as in ``pivot_native``.  The round challenges use
``pivot_native``'s encoding over the same canonical rows, so proofs match
the C++ engine's byte for byte once points are normalized.

Below ``_CUTOVER`` the remaining rounds hand off to
``compressed_pivot.protocol_4_*`` (the C++ resident engine when
available).  :data:`ENGINE_RUNS` counts the loops this engine ran, so a
caller can show the GPU path was taken rather than silently declined.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .. import native
from ..groups.edwards import ELL, EdwardsPoint
from . import pivot

logger_cp_hin = logging.getLogger("compressed_pivot_hash_inputs")
logger_cp_hout = logging.getLogger("compressed_pivot_hash_outputs")

ENABLED = False
ENGINE_RUNS = 0
# smallest half-size the engine folds on the device: below it a round is
# cheaper on the C++ tier.  chip_smoke.py's cut-over phase times one round
# both ways; 1024 is the smallest half at which the card won in every H100
# run so far, on hosts of different speed (PERF.md's cut-over paragraph)
_CUTOVER = 1024


def enable():
    """Called by ``enable_gpu()``: the engine needs the C++ scalar tier."""
    global ENABLED
    ENABLED = native.enable_scalar_tier()
    return ENABLED


def _engine_ok(g_hat, k, gf):
    from ..ops import msm_cuda
    from . import ref_transcript

    if not ENABLED or ref_transcript.ACTIVE or msm_cuda.DEVICE is None:
        return False
    if gf.modulus != ELL or not native.SCALAR_TIER:
        return False
    n = len(g_hat)
    if n < 2 * _CUTOVER or n & (n - 1):
        return False
    if type(k) is not EdwardsPoint or type(g_hat[0]) is not EdwardsPoint:
        return False
    if logger_cp_hin.isEnabledFor(logging.DEBUG) or logger_cp_hout.isEnabledFor(
        logging.DEBUG
    ):
        return False
    return True


def _resident(g_hat):
    """(host rows, device rows) of the generator vector."""
    from ..ops import curve_ed as ced
    from ..ops import msm_cuda

    if native.fastser() is not None:
        return msm_cuda.ed_encode_cached(g_hat)
    rows = native._pts_to_u64(g_hat)
    return rows, ced.from_reference_rows(rows, msm_cuda.DEVICE)


def _round_msms(g_dev: torch.Tensor, z_arr: np.ndarray) -> torch.Tensor:
    """Round r's A (z[:half] over g[half:]) and B (z[half:] over g[:half])
    in one launch -> [2, 16] canonical rows on the device."""
    from ..ops import msm_cuda

    half = z_arr.shape[0] // 2
    pk, _nw = msm_cuda.packed_digits(z_arr, ELL)
    d2 = np.stack([pk[:, :half], pk[:, half:]])
    digits = torch.from_numpy(d2).to(g_dev.device)
    pts = torch.stack([g_dev[half:], g_dev[:half]])
    return msm_cuda.msm_rows(pts, digits)


def _fold(g_dev: torch.Tensor, c: int) -> torch.Tensor:
    from ..ops import msm_cuda

    half = g_dev.shape[0] // 2
    return msm_cuda.fold_rows(g_dev[:half], g_dev[half:],
                              msm_cuda.fold_digits(int(c)))


def _k_pow(k_arr: np.ndarray, y_can: int) -> EdwardsPoint:
    """k ** y via the C scalar ladder (host tail of the round MSMs)."""
    lib = native.load()
    s4 = native._ints_to_u64x4([y_can % ELL], ELL)
    out = np.empty(16, np.uint64)
    lib.vmpc_ed_scalar_mul(
        native._u64p(k_arr), native._u64p(s4), native._u64p(out)
    )
    return native._u64_to_pts(out.reshape(1, 16))[0]


def _rows(t: torch.Tensor) -> np.ndarray:
    from ..ops import curve_ed as ced

    return np.ascontiguousarray(ced.to_rows(t))


def try_protocol_4_prover(g_hat, k, Q, L_tilde, z_hat, gf, proof, round_i,
                          transcript="v1", c_prev=0):
    """GPU-resident prover rounds down to _CUTOVER, then hand off; None if
    the inputs don't qualify (the caller falls through to pivot_native)."""
    global ENGINE_RUNS
    if not _engine_ok(g_hat, k, gf):
        return None
    if len(z_hat) != len(g_hat) or len(L_tilde.coeffs) != len(g_hat):
        return None
    if transcript not in ("v1", "v2"):
        return None
    from . import pivot_native

    z_arr = pivot_native._scalars_or_none(z_hat, gf)
    if z_arr is None:
        return None
    l_arr, l_exact = pivot_native._form_coeffs_reduced(L_tilde.coeffs, gf)
    if l_arr is None:
        return None
    l_obj = None if l_exact else L_tilde
    ENGINE_RUNS += 1

    g_host, g_dev = _resident(g_hat)
    k_arr = np.ascontiguousarray(native._pts_to_u64([k])[0])
    order = k.order

    while True:
        half = g_dev.shape[0] // 2
        y_a = native.mod_dot_arr(l_arr[half:], z_arr[:half], ELL)
        y_b = native.mod_dot_arr(l_arr[:half], z_arr[half:], ELL)
        AB = native._u64_to_pts(_rows(_round_msms(g_dev, z_arr)))
        A = AB[0] * _k_pow(k_arr, y_a)
        B = AB[1] * _k_pow(k_arr, y_b)
        proof["A" + str(round_i)] = A
        proof["B" + str(round_i)] = B

        if transcript == "v2":
            from .compressed_pivot import _round_challenge_v2

            c = c_prev = _round_challenge_v2(A, B, c_prev, order)
        else:
            c = pivot_native._round_challenge_resident(
                A, B, g_host, k, Q, l_arr, order, l_obj
            )
        l_obj = None

        g_dev = _fold(g_dev, c)
        g_host = _rows(g_dev)
        Q = A * (Q ** c) * (B ** (c ** 2))
        l_arr = native.mod_axpy_arr(c, l_arr[:half], l_arr[half:], ELL)
        z_arr = native.mod_axpy_arr(c, z_arr[half:], z_arr[:half], ELL)
        round_i += 1
        if half // 2 < _CUTOVER:
            break

    # hand the tail to the host engines with exactly the state the generic
    # loop would hold
    from . import compressed_pivot

    g_list = native._u64_to_pts(g_host)
    L_small = pivot.LinearForm([gf(v) for v in native._u64x4_to_ints(l_arr)])
    z_small = [gf(v) for v in native._u64x4_to_ints(z_arr)]
    return compressed_pivot.protocol_4_prover(
        g_list, k, Q, L_small, z_small, gf, proof, round_i,
        transcript=transcript, c_prev=c_prev,
    )


def try_protocol_4_verifier(g_hat, k, Q, L_tilde, gf, proof, round_i):
    """GPU-resident verifier rounds down to _CUTOVER; None if unsuitable."""
    global ENGINE_RUNS
    if not _engine_ok(g_hat, k, gf):
        return None
    if len(L_tilde.coeffs) != len(g_hat):
        return None
    from . import pivot_native

    l_arr, l_exact = pivot_native._form_coeffs_reduced(L_tilde.coeffs, gf)
    if l_arr is None:
        return None
    l_obj = None if l_exact else L_tilde
    ENGINE_RUNS += 1

    g_host, g_dev = _resident(g_hat)
    order = k.order

    while True:
        half = g_dev.shape[0] // 2
        A = proof["A" + str(round_i)]
        B = proof["B" + str(round_i)]
        if type(A) is not EdwardsPoint or type(B) is not EdwardsPoint:
            return None
        c = pivot_native._round_challenge_resident(
            A, B, g_host, k, Q, l_arr, order, l_obj
        )
        l_obj = None

        g_dev = _fold(g_dev, c)
        g_host = _rows(g_dev)
        Q = A * (Q ** c) * (B ** (c ** 2))
        l_arr = native.mod_axpy_arr(c, l_arr[:half], l_arr[half:], ELL)
        round_i += 1
        if half // 2 < _CUTOVER:
            break

    from . import compressed_pivot

    g_list = native._u64_to_pts(g_host)
    L_small = pivot.LinearForm([gf(v) for v in native._u64x4_to_ints(l_arr)])
    return compressed_pivot.protocol_4_verifier(
        g_list, k, Q, L_small, gf, proof, round_i
    )
