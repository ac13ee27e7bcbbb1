"""The BN kernels' per-thread bodies (csrc/bn254_kernels.cuh over
csrc/fp254.cuh), built with g++ for the CPU, against the plain PyTorch
versions and Python integers on the same inputs: the field and group code
of K5-K8 gets checked without a card.  Compiles a C++ file, so it is
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
from verifiable_mpc_tpu_torch.groups.bn256 import ORDER, P, BNPoint

pytestmark = pytest.mark.slow

ROOT = pathlib.Path(__file__).resolve().parents[2]
CSRC = ROOT / "verifiable_mpc_tpu_torch" / "csrc"
R = 1 << 256
EDGE = [0, 1, ORDER // 2 - 1, ORDER // 2, ORDER // 2 + 1, ORDER - 2,
        ORDER - 1]


def _p(a):
    return ctypes.c_void_p(a.ctypes.data)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.fail("g++ is required to build the kernels' CPU harness")
    so = tmp_path_factory.mktemp("bn_host_check") / "libhost_check.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(so),
                    str(CSRC / "host_check.cc")], check=True, timeout=300)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def k():
    """torch and the port's device-side modules, imported here and not at
    collection (every xdist worker collects this file)."""
    import torch

    from verifiable_mpc_tpu_torch.ops import curve_bn, msm_bn_cuda, msm_cuda

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield types.SimpleNamespace(torch=torch, cbn=curve_bn, mb=msm_bn_cuda,
                                mc=msm_cuda)
    torch.set_num_threads(n)


def _rows(k, n, seed, identity_at=()):
    """Input rows of n points, every third one with Z != 1."""
    return k.cbn.encode_points(_points(n, seed, identity_at), "cpu")


def _points(n, seed, identity_at=()):
    """n points, every third one in jacobian coordinates with Z != 1."""
    rng = random.Random(seed)
    pts = native.bn_batch_exp(BNPoint.generator,
                              [rng.randrange(1, ORDER) for _ in range(n)])
    for i in range(1, n, 3):
        lam, q = rng.randrange(2, ORDER), pts[i].normalize()
        pts[i] = BNPoint(int(q.x) * lam**2, int(q.y) * lam**3, lam,
                         check=False)
    for i in identity_at:
        if i < n:
            pts[i] = BNPoint.identity
    return pts


def _u64(t):
    return np.ascontiguousarray(t.numpy().view(np.uint64))


def _scalars(n, seed):
    rng = random.Random(seed)
    return (EDGE + [rng.randrange(ORDER) for _ in range(n)])[:n]


# K5's cases: id -> (n, batches, slice count S or None for slices_for).
# Each batch holds identity points (index 2, and 5 from n = 40 on), an
# all-zero scalar column (the scalar 0 at index 0) and scalars whose digits
# reach 8 and -7; S = 3 leaves a ragged last row of points, S = 300 slices
# with no point
MSM_CASES = {"1": (1, 1, None), "7": (7, 1, None), "40": (40, 1, None),
             "40-B2-S3": (40, 2, 3), "40-B2-S300": (40, 2, 300),
             "40-S300": (40, 1, 300), "300-B2": (300, 2, None)}
SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)  # in every row before a call


def _msm_scalars(n, seed):
    """The edge scalars, then scalars with digits 8 (8 * 16^k) and -7
    (ORDER - 7 * 16^k), then random ones."""
    rng = random.Random(seed)
    special = [8, ORDER - 7, 8 << 60, ORDER - (7 << 100), 0]
    return (EDGE + special + [rng.randrange(ORDER) for _ in range(n)])[:n]


def _int(words):
    return sum(int(x) << (64 * i) for i, x in enumerate(words))


def _affine(row):
    """(x, y) of a working row, None for the identity (Z = 0, which must
    be (0 : Y : 0) with Y != 0: an all-zero row fails here)."""
    x, y, z = (_int(row[4 * j : 4 * j + 4]) for j in range(3))
    if z % P == 0:
        assert x % P == 0 and y % P != 0
        return None
    zi = pow(z, -1, P)
    return x * zi % P, y * zi % P


@pytest.mark.parametrize("case", list(MSM_CASES))
def test_msm_bodies_match_plain(host_lib, case, k):
    """K5's table and accumulation bodies over the kernel's whole grid
    against the plain version, accumulators compared as affine points; the
    table against m * P; at one batch, K5 then K6 against msm_plain."""
    n, B, S = MSM_CASES[case]
    S = S or k.mc.slices_for(n, k.mc.ACCUM_POINTS_PER_THREAD)
    pts = [_points(n, 17 * n + b, identity_at=(2, 5) if n >= 40 else (2,))
           for b in range(B)]
    rows_t = [k.cbn.encode_points(p, "cpu") for p in pts]
    pk = []
    for b in range(B):
        pkb, nw = k.mc.packed_digits(
            native._scalars_to_u64(_msm_scalars(n, n + b), ORDER), ORDER)
        pk.append(pkb)
    assert len({p.shape for p in pk}) == 1
    pk = np.ascontiguousarray(np.stack(pk))
    d = k.mc.unpack_digits(k.torch.from_numpy(pk))
    assert not d[:, :, 0].any()
    if n > len(EDGE) + 1:
        assert (d[:, :, len(EDGE)] == 8).any() and (d == -7).any()
    rows = np.ascontiguousarray(np.stack([_u64(r) for r in rows_t]))
    tbl = np.full((B, n, 8, 12), SENTINEL)
    host_lib.host_bn_table(_p(rows), _p(tbl), ctypes.c_longlong(B * n))
    for b in range(B):
        for i in range(min(n, 6)):
            for m in range(1, 9):
                want = (pts[b][i] ** m).normalize()
                got = _affine(tbl[b, i, m - 1])
                if want == BNPoint.identity:
                    assert got is None
                else:
                    assert got == (int(want.x), int(want.y))
    plain = _u64(k.mb.msm_accumulate_plain(k.torch.stack(rows_t),
                                           k.torch.from_numpy(pk), S))
    acc = np.full((B, nw, S, 12), SENTINEL)
    host_lib.host_bn_msm_accum(_p(tbl), _p(pk), B, n, nw, S, _p(acc))
    assert ([_affine(r) for r in acc.reshape(-1, 12)]
            == [_affine(r) for r in plain.reshape(-1, 12)])
    if B == 1:
        acc1 = np.full((nw, S, 12), SENTINEL)
        wsum = np.zeros((nw, 12), np.uint64)
        out = np.zeros(12, np.uint64)
        host_lib.host_bn_msm(_p(rows[0]), _p(tbl[0]), _p(pk[0]), n, nw, S,
                             _p(acc1), _p(wsum), _p(out))
        full = k.mb.msm_plain(rows_t[0][None], k.torch.from_numpy(pk))
        assert np.array_equal(out, _u64(full)[0])


# K7's cases: id -> (n, threads G or None for G = n, a challenge's name in
# msm_cuda.fold_challenges(ORDER) or None for a random one, identities).
# G = 1 folds every element in one thread, G = 3 and 6 leave ragged
# normalization groups; the challenges are the edges 0, 1, 8, 9,
# ORDER - 1 and a run of zero windows; with identities every element of
# thread 0's group (0, G, 2G, ...) has identity gl and gr, and element 1
# a gr with gl^c * gr the identity
FOLD_CASES = {"1": (1, None, None, False), "7": (7, None, None, False),
              "40": (40, None, None, False), "7-G1": (7, 1, None, False),
              "7-G3-c0": (7, 3, "c0", False), "7-G3-c1": (7, 3, "c1", False),
              "7-G3-c8": (7, 3, "c8", False), "7-G3-c9": (7, 3, "c9", False),
              "40-G6-order-1": (40, 6, "order-1", False),
              "40-G6-zero-run": (40, 6, "zero-run", False),
              "40-G6-identities": (40, 6, None, True)}


@pytest.mark.parametrize("n", list(FOLD_CASES))
def test_fold_body_matches_plain(host_lib, n, k):
    """K7's body over all G threads (each folding its elements g, g + G,
    ... from their input rows and normalizing them with one inversion)
    against fold_plain and the C++ tier's MSM of (gl_i, gr_i) by (c, 1),
    the output and scratch filled with a sentinel first."""
    n, G, c, ident = FOLD_CASES[n]
    G = G or n
    if c is None:
        c = _scalars(n + 1, 3)[-1]
    else:
        c = k.mc.fold_challenges(ORDER)[c]
    zero = list(range(0, n, G)) if ident else []
    gl = _points(n, 2 * n, [1] + zero)
    gr = _points(n, 2 * n + 1, [3] + zero)
    if ident and n > 1:
        gl[1] = BNPoint.generator ** 77
        gr[1] = -(gl[1] ** c)
    gl_t, gr_t = (k.cbn.encode_points(p, "cpu") for p in (gl, gr))
    cdig = k.mc.fold_digits(c, ORDER)
    out = np.full((n, 12), SENTINEL)
    pre = np.full((n, 4), SENTINEL)
    host_lib.host_bn_fold_norm(_p(_u64(gl_t)), _p(_u64(gr_t)), _p(cdig),
                               len(cdig), G, _p(pre), _p(out), n)
    assert np.array_equal(out, _u64(k.mb.fold_plain(gl_t, gr_t, cdig)))
    host = BNPoint.batch_normalize(
        [native.bn_msm([a, b], [c, 1]) for a, b in zip(gl, gr)])
    assert np.array_equal(out, native._bn_pts_to_u64(host))
    ident_row = [1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0]
    assert all(out[i].tolist() == ident_row for i in zero + [1][:ident])


# K8's cases: id -> (n, threads G, table).  Thread g sums and normalizes
# the exponents g, g + G, g + 2G, ... with one inversion: G < n leaves
# ragged groups (the last threads one exponent short).  The exponents of
# thread 0's group are all 0 (a whole group of identities), and 0 also
# sits at index 1, in a group with others.  Tables: the C++ tier's (affine
# rows), an identity base's, and the C++ tier's with every third row
# rescaled to Z != 1 (the first launch's inversion).
COMB_CASES = {"1": (1, 1, "base"), "7": (7, 7, "base"), "40": (40, 40, "base"),
              "7-G3": (7, 3, "base"), "40-G6": (40, 6, "base"),
              "40-G6-identity-base": (40, 6, "identity"),
              "40-G6-jacobian-table": (40, 6, "jacobian")}


def _rescaled(p, seed):
    """p in jacobian coordinates with Z != 1."""
    lam, q = random.Random(seed).randrange(2, ORDER), p.normalize()
    return BNPoint(int(q.x) * lam**2, int(q.y) * lam**3, lam, check=False)


def _comb_exponents(n, G, seed):
    exps = _scalars(n, seed)
    for i in [1] + list(range(0, n, G)):
        if i < n:
            exps[i] = 0
    return exps


@pytest.mark.parametrize("case", list(COMB_CASES))
def test_comb_body_matches_plain(host_lib, case, k):
    """K8's body over all G threads against comb_plain, with its output and
    scratch filled with a sentinel first."""
    n, G, kind = COMB_CASES[case]
    pk, nw = k.mc.packed_digits(native._scalars_to_u64(
        _comb_exponents(n, G, 5), ORDER), ORDER)
    base = (BNPoint.identity if kind == "identity"
            else BNPoint.generator ** 12345)
    table = k.mb.comb_table(base, nw, "cpu")
    if kind == "jacobian":
        pts = [p if p.z == 0 or i % 3 != 1 else _rescaled(p, i)
               for i, p in enumerate(k.cbn.decode_rows(table))]
        table = k.cbn.encode_points(pts, "cpu")
        assert not np.array_equal(_u64(table), _u64(
            k.mb.comb_table(base, nw, "cpu")))
    out = np.full((n, 12), SENTINEL)
    pre = np.full((n, 4), SENTINEL)
    tb = _u64(table)
    work = np.zeros_like(tb)
    host_lib.host_bn_comb_norm(_p(tb), _p(work), _p(pk), n, nw, G, _p(pre),
                               _p(out))
    plain = k.mb.comb_plain(table, k.torch.from_numpy(pk))
    assert np.array_equal(out, _u64(plain))
    ident = [1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0]
    zero = [i for i in range(n)
            if i % G == 0 or i == 1 or kind == "identity"]
    assert all(out[i].tolist() == ident for i in zero)


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_coop_group_ops_match_plain(host_lib, lanes, k):
    """K6's group operations with their products spread over 1, 2 or 4
    lanes, the lanes run one after another, against the plain RCB15 law on
    the same working rows, word for word: random points, the identity, P +
    P and P + (-P)."""
    rows = k.cbn.encode_jacobian_rows(_rows(k, 6, 11, identity_at=(4,)))
    neg = k.cbn.join_rows(k.cbn.neg_where(
        k.torch.ones(1, dtype=k.torch.bool), k.cbn.split_rows(rows[:1])))
    pairs = [(0, 1), (2, 3), (4, 5), (5, 4), (4, 4), (1, 1), (0, "neg")]
    for i, j in pairs:
        p = rows[i:i + 1]
        q = neg if j == "neg" else rows[j:j + 1]
        want = {0: k.cbn.add(k.cbn.split_rows(p), k.cbn.split_rows(q)),
                1: k.cbn.dbl(k.cbn.split_rows(p))}
        for op in (0, 1):
            out = np.full(12, SENTINEL)
            host_lib.host_bn_coop(op, lanes, _p(_u64(p)), _p(_u64(q)),
                                  _p(out))
            assert np.array_equal(out, _u64(k.cbn.join_rows(want[op]))[0]), (
                op, i, j)


# K6's cases: id -> (B, nw, S, R, lanes L, window groups P, the window
# whose accumulators are all the identity or None); S = 7 with R = 3 and
# S = 5 with R = 2 leave a short last chunk, nw = 9 and 3 a short last
# group and empty groups, P = 1 the one-group Horner
TAIL_CASES = {"64-L4-P8": (1, 64, 3, 2, 4, 8, 5),
              "B3-9-L2-P4": (3, 9, 7, 3, 2, 4, 0),
              "B2-3-L1-P8": (2, 3, 5, 2, 1, 8, None),
              "8-L4-P1": (1, 8, 4, 4, 4, 1, 7),
              "B2-64-L4-P8-R1": (2, 64, 2, 1, 4, 8, 63)}


@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_msm_tail_bodies_match_plain(host_lib, case, k):
    """K6's reduce chunks and its combination (each window's partials,
    the window groups' Horners, the shift and add, each step's lanes run one
    after another) against msm_tail_plain, the output filled with a
    sentinel first."""
    B, nw, S, R, L, P, ident = TAIL_CASES[case]
    rows = k.cbn.encode_jacobian_rows(_rows(k, B * nw * S, 3 * nw + S,
                                            identity_at=(1,)))
    acc = rows.reshape(B, nw, S, 12).clone()
    if ident is not None:
        acc[:, ident] = k.torch.tensor(k.cbn.IDENTITY_MONT_ROW)
    part = np.full((B, nw, R, 12), SENTINEL)
    out = np.full((B, 12), SENTINEL)
    host_lib.host_bn_msm_tail(_p(_u64(acc)), _p(part), _p(out), B, nw, S, R,
                              L, P)
    assert np.array_equal(out, _u64(k.mb.msm_tail_plain(acc, R)))


@pytest.mark.parametrize("n", [1, 40])
def test_encode_body_matches_plain(host_lib, n, k):
    """The kernels' first launch (input rows -> working rows) against
    curve_bn.encode_jacobian_rows, identities and Z != 1 included."""
    rows = _rows(k, n, 3 * n, identity_at=(0, 5))
    out = np.zeros((n, 12), np.uint64)
    host_lib.host_bn_encode(_p(_u64(rows)), _p(out), n)
    assert np.array_equal(out, _u64(k.cbn.encode_jacobian_rows(rows)))


FP_EDGE = [0, 1, 2, P // 2, P // 2 + 1, P - 2, P - 1]
FP_BINARY = {"mul": lambda a, b: a * b * pow(R, -1, P),
             "add": lambda a, b: a + b, "sub": lambda a, b: a - b}


def _fp(v):
    return np.array([(v >> (64 * i)) & ((1 << 64) - 1) for i in range(4)],
                    np.uint64)


def _fp_int(a):
    return sum(int(x) << (64 * i) for i, x in enumerate(a))


@pytest.mark.parametrize("op", sorted(FP_BINARY))
def test_field_bodies_match_ints(host_lib, op):
    """fp254.cuh on canonical edge values: canonical results, the residues
    Python computes (a - b with a < b, sums that carry out of bit 256,
    products of values near p)."""
    fn = getattr(host_lib, f"host_fp_{op}")
    vals = FP_EDGE + [random.Random(3).randrange(P) for _ in range(4)]
    for a in vals:
        for b in vals:
            x, y, r = _fp(a), _fp(b), np.zeros(4, np.uint64)
            fn(_p(x), _p(y), _p(r))
            assert _fp_int(r) == FP_BINARY[op](a, b) % P, (a, b)


def test_field_mul_b3_body_matches_ints(host_lib):
    """fp_mul_b3 (four additions) is mont_mul_const by 9 R mod p: 9 a."""
    for a in FP_EDGE + [random.Random(4).randrange(P) for _ in range(4)]:
        x, r = _fp(a), np.zeros(4, np.uint64)
        host_lib.host_fp_mul_b3(_p(x), _p(r))
        assert _fp_int(r) == 9 * a % P, a


def test_field_inverse_body_matches_pow(host_lib):
    """fp_inv inverts a Montgomery-form value into Montgomery form."""
    for v in FP_EDGE[1:]:
        x, r = _fp(v * R % P), np.zeros(4, np.uint64)
        host_lib.host_fp_inv(_p(x), _p(r))
        assert _fp_int(r) == pow(v, P - 2, P) * R % P, v
    x, r = _fp(0), np.ones(4, np.uint64)
    host_lib.host_fp_inv(_p(x), _p(r))
    assert _fp_int(r) == 0
