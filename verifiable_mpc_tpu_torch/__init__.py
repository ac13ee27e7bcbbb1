"""verifiable_mpc_tpu_torch -- the PyTorch/CUDA port of the JAX package.

Publicly verifiable proofs (AC20 compressed Sigma-protocols over Ed25519,
BN256 and quadratic-residue groups) with the host protocol layer carried
over from the JAX package and the device work in CUDA kernels written for
NVIDIA Hopper (``csrc/``).  The port carries the flagship path (generator
setup, prove and verify of AC20 circuit satisfiability with the compressed
pivot over Ed25519) and the BN256 path (Pinocchio key generation,
proving and verifying, over G1 and the twist G2; the KoE pivot's G1
work), and the Ed25519 bucket-method MSM, opt-in as in the JAX package
(``ops.msm_bucket_cuda.register()`` after :func:`enable_gpu`).

Entry points: :func:`enable_gpu` installs the GPU kernels behind the
dispatch layer; :func:`enable_native` the C++ host tier.  The package
imports neither ``jax`` nor the JAX package.
"""

__version__ = "0.1.0"

from . import fields
from . import groups

# Batch sizes from which enable_gpu's backends take a call (below, the C++
# host tier serves it).  In chip_smoke.py's tier sweeps on an H100 (PERF.md
# §7), encode to decode as the dispatch calls them, with every MSM tail
# (K2, K6, K10) a one-block combination: the Ed25519 MSM has a floor of
# about 2 ms and beats the C++ tier from 512 points, about even with it at
# 128-256; the Ed25519 comb wins from 128 exponents; the BN MSM (floor
# about 3 ms) and comb win from 256; the twist MSM (floor about 11 ms) and
# batch-exp (K9-K11, which share BN2_MIN_BATCH) win from 256.  The
# thresholds were set before these sweeps and stay until a benchmark's
# cells decide them.
MIN_MSM_BATCH = 512
BN_MIN_MSM_BATCH = 4096
BN2_MIN_BATCH = 2048


def enable_gpu(device=None, min_msm_batch: int = MIN_MSM_BATCH,
               min_poly_len: int = 128):
    """Install the GPU backends on ``device``: the Ed25519 MSM, MSM-async,
    fold and batch-exp backends with the resident protocol-4 engine, and
    the BN256 G1 and twist (G2) MSM, fold and batch-exp backends.

    On a CUDA device these are the kernels of ``csrc/*.cu`` (K1-K12);
    ``device="cpu"`` installs their plain PyTorch versions instead (the
    CPU tests use it).  With no argument the device is ``cuda`` and, when
    no card is present, this raises: nothing carries on on the CPU unasked.

    Batches below ``min_msm_batch`` (BN MSMs: below
    :data:`BN_MIN_MSM_BATCH`; twist MSMs and batch-exps: below
    :data:`BN2_MIN_BATCH`) go to the C++ host tier, which also serves the
    engine's sub-cutover tail (a BN or twist fold below it takes the host
    loop: the C++ tier has neither fold).

    The folds of ``min_msm_batch`` elements or more run K3 (Ed25519), K7
    (BN G1) and K12 (the twist) on one design: the challenge as the width-5
    NAF of c mod the group's order (``msm_cuda.fold_digits``), each
    element's table of odd multiples 1..15 and its encoding in the kernel,
    and one wave of threads (``fold_threads``), each normalizing its
    elements with one inversion.
    """
    import torch

    from . import native
    from .ac20 import pivot_gpu
    from .groups.bn256 import BNPoint, BNTwistPoint
    from .groups.edwards import EdwardsPoint
    from .ops import dispatch, msm_bn2_cuda, msm_bn_cuda, msm_cuda, ntt

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("enable_gpu: no CUDA device is available")
        from .ops import _cuda_build

        _cuda_build.lib()  # build now: a failed build raises here
    elif device.type != "cpu":
        raise ValueError(f"enable_gpu: unsupported device {device}")
    if not native.register():
        raise RuntimeError("enable_gpu: the C++ host tier did not build")
    msm_cuda.register(device, min_msm_batch)
    pivot_gpu.enable()

    # tiered dispatch of the synchronous backends: below the batch
    # threshold the C++ tier serves the call (the compression tail, tiny
    # commitments)
    def _tier(table, cls, gpu_fn, native_fn, pick, threshold=min_msm_batch):
        def fn(*args):
            if len(pick(args)) >= threshold:
                return gpu_fn(*args)
            return native_fn(*args)

        table[cls] = (fn, 8)

    first = lambda a: a[0]  # noqa: E731
    exps = lambda a: a[1]  # noqa: E731
    _tier(dispatch._MSM_BACKENDS, EdwardsPoint, msm_cuda.msm, native.ed_msm,
          first)
    _tier(dispatch._FOLD_BACKENDS, EdwardsPoint, msm_cuda.fold,
          native.ed_fold, first)
    _tier(dispatch._BATCH_EXP_BACKENDS, EdwardsPoint, msm_cuda.batch_exp_comb,
          native.ed_batch_exp, exps)
    _tier(dispatch._MSM_BACKENDS, BNPoint, msm_bn_cuda.msm, native.bn_msm,
          first, BN_MIN_MSM_BATCH)
    _tier(dispatch._BATCH_EXP_BACKENDS, BNPoint, msm_bn_cuda.batch_exp_comb,
          native.bn_batch_exp, exps)
    dispatch.register_fold_backend(BNPoint, msm_bn_cuda.fold, min_msm_batch)
    _tier(dispatch._MSM_BACKENDS, BNTwistPoint, msm_bn2_cuda.msm,
          native.bn2_msm, first, BN2_MIN_BATCH)
    _tier(dispatch._BATCH_EXP_BACKENDS, BNTwistPoint, msm_bn2_cuda.batch_exp,
          native.bn2_batch_exp, exps, BN2_MIN_BATCH)
    dispatch.register_fold_backend(BNTwistPoint, msm_bn2_cuda.fold,
                                   min_msm_batch)
    ntt.register(min_poly_len)
    return device


def enable_native(min_batch: int = 8, min_poly_len: int = 128):
    """Install the C++ host tier (Pippenger MSM etc.) as the dispatch
    backend, and its CRT NTT for large polynomial products.  Returns False
    if no toolchain is available."""
    import sys

    from . import native

    ok = native.register(min_batch)
    if ok:
        from .ops import ntt

        ntt.register(min_poly_len)
        # the C++ tier replaces the GPU backends: native.register() takes
        # the synchronous tables; the Ed25519 MSM-async backend that
        # msm_cuda.register() installed (K1 + K2) is removed here, and the
        # resident engine, the device encode cache and the BN and twist
        # folds (the C++ tier has none) step aside too
        from .groups.bn256 import BNPoint, BNTwistPoint
        from .groups.edwards import EdwardsPoint
        from .ops import dispatch

        dispatch._MSM_ASYNC_BACKENDS.pop(EdwardsPoint, None)
        dispatch._FOLD_BACKENDS.pop(BNPoint, None)
        dispatch._FOLD_BACKENDS.pop(BNTwistPoint, None)
        engine = sys.modules.get(__name__ + ".ac20.pivot_gpu")
        if engine is not None:
            engine.ENABLED = False
        kernels = sys.modules.get(__name__ + ".ops.msm_cuda")
        if kernels is not None:
            kernels.REGISTERED = False
    return ok
