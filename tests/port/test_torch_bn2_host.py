"""The twist kernels' per-thread bodies (csrc/bn2_kernels.cuh over
csrc/fp2_254.cuh), built with g++ for the CPU, against the plain PyTorch
versions and Python integers on the same inputs: the GF(p^2) and twist
code of K9-K12 gets checked without a card.  Compiles a C++ file, so it is
marked slow."""

import ctypes
import pathlib
import random
import shutil
import subprocess
import types

import numpy as np
import pytest

from verifiable_mpc_tpu_torch import native
from verifiable_mpc_tpu_torch.groups.bn256 import (B2, ORDER, P, GFp2,
                                                   BNTwistPoint)

pytestmark = pytest.mark.slow

ROOT = pathlib.Path(__file__).resolve().parents[2]
CSRC = ROOT / "verifiable_mpc_tpu_torch" / "csrc"
R = 1 << 256
R_INV = pow(R, -1, P)
EDGE = [0, 1, ORDER // 2 - 1, ORDER // 2, ORDER // 2 + 1, ORDER - 2,
        ORDER - 1]


def _p(a):
    return ctypes.c_void_p(a.ctypes.data)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.fail("g++ is required to build the kernels' CPU harness")
    so = tmp_path_factory.mktemp("bn2_host_check") / "libhost_check.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(so),
                    str(CSRC / "host_check.cc")], check=True, timeout=300)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def k():
    """torch and the port's device-side modules, imported here and not at
    collection (every xdist worker collects this file)."""
    import torch

    from verifiable_mpc_tpu_torch.ops import curve_bn2, msm_bn2_cuda, msm_cuda

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield types.SimpleNamespace(torch=torch, cb2=curve_bn2, mb2=msm_bn2_cuda,
                                mc=msm_cuda)
    torch.set_num_threads(n)


def _rows(k, n, seed, identity_at=()):
    """Input rows of n twist points, every third one with Z != 1."""
    rng = random.Random(seed)
    pts = native.bn2_batch_exp(BNTwistPoint.generator,
                               [rng.randrange(1, ORDER) for _ in range(n)])
    for i in range(1, n, 3):
        lam = GFp2(rng.randrange(2, P), rng.randrange(P))
        q = pts[i].normalize()
        pts[i] = BNTwistPoint(q.x * lam * lam, q.y * lam * lam * lam, lam,
                              check=False)
    for i in identity_at:
        if i < n:
            pts[i] = BNTwistPoint.identity
    return k.cb2.encode_points(pts, "cpu")


def _u64(t):
    return np.ascontiguousarray(t.numpy().view(np.uint64))


def _digits(k, n, seed):
    rng = random.Random(seed)
    sc = (EDGE + [rng.randrange(ORDER) for _ in range(n)])[:n]
    return k.mc.packed_digits(native._scalars_to_u64(sc, ORDER), ORDER)


@pytest.mark.parametrize("n", [1, 7, 40])
def test_msm_bodies_match_plain(host_lib, n, k):
    """K9's table launch and accumulation, K10's reduction and Horner."""
    rows = _rows(k, n, n, identity_at=(2,))
    pk, nw = _digits(k, n, n)
    S = k.mc.slices_for(n)
    pts = _u64(rows)
    tbl = np.zeros((n, 8, 24), np.uint64)
    acc = np.zeros((nw, S, 24), np.uint64)
    wsum = np.zeros((nw, 24), np.uint64)
    out = np.zeros(24, np.uint64)
    host_lib.host_bn2_msm(_p(pts), _p(tbl), _p(pk), n, nw, S, _p(acc),
                          _p(wsum), _p(out))
    plain = k.mb2.msm_plain(rows[None], k.torch.from_numpy(pk)[None])
    assert np.array_equal(out, _u64(plain)[0])


# K11's cases: id -> (n, threads G, table).  Thread g sums and normalizes
# the exponents g, g + G, g + 2G, ... with one inversion: G < n leaves
# ragged groups (the last threads one exponent short).  The exponents of
# thread 0's group are all 0 (a whole group of identities), and 0 also
# sits at index 1, in a group with others.  Tables: the C++ tier's (affine
# rows), an identity base's, and the C++ tier's with every third row
# rescaled to Z != 1 (the first launch's inversion).
BEXP_CASES = {"1": (1, 1, "base"), "7": (7, 7, "base"), "40": (40, 40, "base"),
              "7-G3": (7, 3, "base"), "40-G6": (40, 6, "base"),
              "40-G6-identity-base": (40, 6, "identity"),
              "40-G6-jacobian-table": (40, 6, "jacobian")}


def _rescaled(k, table, seed):
    """The table's rows with every third point in jacobian coordinates
    with Z != 1."""
    rng = random.Random(seed)
    pts = k.cb2.decode_rows(table)
    for i in range(1, len(pts), 3):
        if pts[i].z == GFp2(0):
            continue
        lam = GFp2(rng.randrange(2, P), rng.randrange(P))
        q = pts[i].normalize()
        pts[i] = BNTwistPoint(q.x * lam * lam, q.y * lam * lam * lam, lam,
                              check=False)
    return k.cb2.encode_points(pts, "cpu")
SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)  # in every row before a call


@pytest.mark.parametrize("case", list(BEXP_CASES))
def test_bexp_body_matches_plain(host_lib, case, k):
    """K11's comb body over all G threads against bexp_plain, with its
    output and scratch filled with a sentinel first."""
    n, G, kind = BEXP_CASES[case]
    rng = random.Random(5 * n)
    exps = (EDGE + [rng.randrange(ORDER) for _ in range(n)])[:n]
    for i in [1] + list(range(0, n, G)):
        if i < n:
            exps[i] = 0
    pk, nw = k.mc.packed_digits(native._scalars_to_u64(exps, ORDER), ORDER)
    base = (BNTwistPoint.identity if kind == "identity"
            else BNTwistPoint.generator ** 12345)
    table = k.mb2.bexp_table(base, nw, "cpu")
    if kind == "jacobian":
        table = _rescaled(k, table, n)
        assert not np.array_equal(_u64(table), _u64(
            k.mb2.bexp_table(base, nw, "cpu")))
    tb = _u64(table)
    work = np.zeros_like(tb)
    out = np.full((n, 24), SENTINEL)
    pre = np.full((n, 8), SENTINEL)
    host_lib.host_bn2_bexp(_p(tb), _p(work), _p(pk), n, nw, G, _p(pre),
                           _p(out))
    plain = k.mb2.bexp_plain(table, k.torch.from_numpy(pk))
    assert np.array_equal(out, _u64(plain))
    ident = [1, 0, 0, 0, 0, 0, 0, 0, 1] + [0] * 15
    zero = [i for i in range(n)
            if i % G == 0 or i == 1 or kind == "identity"]
    assert all(out[i].tolist() == ident for i in zero)


@pytest.mark.parametrize("n", [1, 7, 40])
def test_fold_body_matches_plain(host_lib, n, k):
    gl, gr = _rows(k, n, 2 * n, (1,)), _rows(k, n, 2 * n + 1, (3,))
    rng = random.Random(n)
    cdig = np.ascontiguousarray(k.mc.scalar_digits(
        [rng.randrange(ORDER)], ORDER)[:, 0].astype(np.uint8))
    out = np.zeros((n, 24), np.uint64)
    work = np.zeros((2 * n, 24), np.uint64)
    a, b = _u64(gl), _u64(gr)
    host_lib.host_bn2_fold_norm(_p(a), _p(b), _p(work), _p(cdig), 64,
                                _p(out), n)
    plain = k.mb2.fold_plain(gl, gr, cdig)
    assert np.array_equal(out, _u64(plain))


@pytest.mark.parametrize("n", [1, 40])
def test_encode_body_matches_plain(host_lib, n, k):
    """The twist kernels' first launch (input rows -> working rows)
    against curve_bn2.encode_jacobian_rows, identities and Z != 1
    included."""
    rows = _rows(k, n, 3 * n, identity_at=(0, 5))
    a, out = _u64(rows), np.zeros((n, 24), np.uint64)
    host_lib.host_bn2_encode(_p(a), _p(out), n)
    assert np.array_equal(out, _u64(k.cb2.encode_jacobian_rows(rows)))


FP_EDGE = [0, 1, 2, P // 2, P // 2 + 1, P - 2, P - 1]
B3 = 3 * B2


def _fp2(v):
    return np.array([(v[j] >> (64 * i)) & ((1 << 64) - 1)
                     for j in (0, 1) for i in range(4)], np.uint64)


def _fp2_int(a):
    return tuple(sum(int(x) << (64 * i) for i, x in enumerate(a[4 * j:
                                                                4 * j + 4]))
                 for j in (0, 1))


def _mont(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) * R_INV % P,
            (a[0] * b[1] + a[1] * b[0]) * R_INV % P)


def _values():
    rng = random.Random(3)
    return ([(a, b) for a in FP_EDGE for b in FP_EDGE]
            + [(rng.randrange(P), rng.randrange(P)) for _ in range(6)])


@pytest.mark.parametrize("op", ["mul", "sq", "mul_b3", "inv"])
def test_fp2_bodies_match_ints(host_lib, op):
    """fp2_254.cuh on canonical values: canonical results, the residues
    Python computes (Karatsuba sums that carry out of bit 256 included;
    the inverse of 0 is 0)."""
    b3 = (int(B3.c0) * R % P, int(B3.c1) * R % P)
    vals = _values()
    for a, b in zip(vals, vals[::-1]):
        x, y, r = _fp2(a), _fp2(b), np.zeros(8, np.uint64)
        if op == "mul":
            host_lib.host_fp2_mul(_p(x), _p(y), _p(r))
            expect = _mont(a, b)
        elif op == "sq":
            host_lib.host_fp2_sq(_p(x), _p(r))
            expect = _mont(a, a)
        elif op == "mul_b3":
            host_lib.host_fp2_mul_b3(_p(x), _p(r))
            expect = _mont(a, b3)
        else:
            host_lib.host_fp2_inv(_p(x), _p(r))
            got = _fp2_int(r)
            assert (got == (0, 0) if a == (0, 0)
                    else _mont(a, got) == (R % P, 0)), a
            continue
        assert _fp2_int(r) == expect, (a, b)
