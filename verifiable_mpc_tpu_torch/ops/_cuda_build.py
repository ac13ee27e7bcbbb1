"""Build and load the CUDA kernels (``csrc/*.cu``) at first use.

Route: ``nvcc`` by hand into one shared library with a plain C interface,
loaded with ctypes -- no PyTorch headers.  Every kernel source compiles
with its own ``nvcc -c``, all started together, and one link joins the
objects (``_build.build``: under a file lock, to a temporary name).  The
library goes to ``verifiable_mpc_tpu_torch/build/`` (listed in
``.gitignore``).  Nothing here runs at import time, and a failed build
raises: there is no fallback to another implementation.
"""

from __future__ import annotations

import ctypes
import os

from .. import _build

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
SOURCES = ("msm_accum.cu", "msm_tail.cu", "fold.cu", "comb.cu",
           "bn_msm_accum.cu", "bn_msm_tail.cu", "bn_fold.cu", "bn_comb.cu",
           "bn2_msm_accum.cu", "bn2_msm_tail.cu", "bn2_bexp.cu",
           "bn2_fold.cu", "bucket_accum.cu", "bucket_reduce.cu", "bexp.cu",
           "ed_add_mont.cu", "probe_vpu.cu", "probe_carrychain.cu")
HEADERS = ("fe25519.cuh", "ed25519_kernels.cuh", "fp254.cuh", "coop.cuh",
           "bn254_kernels.cuh", "fp2_254.cuh", "bn2_kernels.cuh",
           "digits.cuh", "launch.cuh", "probe_ops.cuh")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]
LIB = os.path.join(BUILD, "libvmpc_cuda.so")

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def build(verbose: bool = False) -> float:
    """Compile the kernel sources (one ``nvcc -c`` each, in parallel) and
    link them; returns the wall seconds spent (0.0 when current)."""
    nvcc = _nvcc()
    ptxas = ["-Xptxas=-v"] if verbose else []
    return _build.build(
        LIB,
        [os.path.join(CSRC, s) for s in SOURCES],
        [os.path.join(CSRC, f) for f in SOURCES + HEADERS],
        lambda src, obj: [nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", obj, src],
        lambda objs, out: [nvcc, *NVCC_FLAGS, "-shared", "-o", out, *objs],
        timeout=900, verbose=verbose,
    )


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        build()
        so = ctypes.CDLL(LIB)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        so.vmpc_cu_msm_accum.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
        so.vmpc_cu_msm_tail.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
        so.vmpc_cu_fold_norm.argtypes = [vp, vp, vp, ci, ci, vp, vp, ci, vp]
        so.vmpc_cu_fold_resident.argtypes = []
        so.vmpc_cu_comb_norm.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp]
        so.vmpc_cu_comb_resident.argtypes = []
        so.vmpc_cu_bn_msm_accum.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                            vp]
        so.vmpc_cu_bn_msm_tail.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
        so.vmpc_cu_bn_fold_norm.argtypes = [vp, vp, vp, ci, ci, vp, vp, ci,
                                            vp]
        so.vmpc_cu_bn_fold_resident.argtypes = []
        so.vmpc_cu_bn_comb_norm.argtypes = [vp, vp, vp, ci, ci, ci, vp, vp,
                                            vp]
        so.vmpc_cu_bn_comb_resident.argtypes = []
        so.vmpc_cu_bn2_msm_accum.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci,
                                             ci, ci, vp]
        so.vmpc_cu_bn2_table_resident.argtypes = []
        so.vmpc_cu_bn2_msm_tail.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
        so.vmpc_cu_bn2_bexp.argtypes = [vp, vp, vp, ci, ci, ci, vp, vp, vp]
        so.vmpc_cu_bn2_bexp_resident.argtypes = []
        so.vmpc_cu_bn2_fold_norm.argtypes = [vp, vp, vp, ci, ci, vp, vp, ci,
                                             vp]
        so.vmpc_cu_bn2_fold_resident.argtypes = []
        so.vmpc_cu_bucket_accum.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci,
                                            ci, ci, ci, vp]
        so.vmpc_cu_bucket_reduce.argtypes = [vp, vp, vp, ci, ci, vp]
        so.vmpc_cu_bexp_norm.argtypes = [vp, vp, ci, ci, vp, vp]
        so.vmpc_cu_mont_add.argtypes = [vp] * 12 + [ci, vp]
        so.vmpc_cu_probe_vpu.argtypes = [ci, vp, vp, vp, ci, ci, vp]
        so.vmpc_cu_probe_field.argtypes = [ci, vp, vp, vp, ci, ci, vp]
        so.vmpc_cu_probe_chain.argtypes = [ci, vp, vp, vp, ci, ci, vp]
        so.vmpc_cu_probe_raw.argtypes = [vp, vp, vp, ci, ci, vp]
        so.vmpc_cu_probe_vpu_resident.argtypes = [ci]
        so.vmpc_cu_probe_carrychain_resident.argtypes = [ci]
        for fn in (so.vmpc_cu_msm_accum, so.vmpc_cu_msm_tail,
                   so.vmpc_cu_fold_norm, so.vmpc_cu_comb_norm,
                   so.vmpc_cu_bn_msm_accum, so.vmpc_cu_bn_msm_tail,
                   so.vmpc_cu_bn_fold_norm, so.vmpc_cu_bn_comb_norm,
                   so.vmpc_cu_bn2_msm_accum, so.vmpc_cu_bn2_msm_tail,
                   so.vmpc_cu_bn2_bexp, so.vmpc_cu_bn2_fold_norm,
                   so.vmpc_cu_bucket_accum, so.vmpc_cu_bucket_reduce,
                   so.vmpc_cu_bexp_norm, so.vmpc_cu_mont_add,
                   so.vmpc_cu_probe_vpu, so.vmpc_cu_probe_field,
                   so.vmpc_cu_probe_chain, so.vmpc_cu_probe_raw,
                   so.vmpc_cu_probe_vpu_resident,
                   so.vmpc_cu_probe_carrychain_resident,
                   so.vmpc_cu_fold_resident, so.vmpc_cu_comb_resident,
                   so.vmpc_cu_bn_fold_resident, so.vmpc_cu_bn_comb_resident,
                   so.vmpc_cu_bn2_fold_resident,
                   so.vmpc_cu_bn2_bexp_resident,
                   so.vmpc_cu_bn2_table_resident):
            fn.restype = ci
        _lib = so
    return _lib


def check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: error {rc}")
