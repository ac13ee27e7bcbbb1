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
    return k.cb2.encode_points(_points(n, seed, identity_at), "cpu")


def _points(n, seed, identity_at=()):
    """n twist points, every third one in jacobian coordinates with Z !=
    1."""
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
    return pts


def _u64(t):
    return np.ascontiguousarray(t.numpy().view(np.uint64))


def _digits(k, n, seed):
    rng = random.Random(seed)
    sc = (EDGE + [rng.randrange(ORDER) for _ in range(n)])[:n]
    return k.mc.packed_digits(native._scalars_to_u64(sc, ORDER), ORDER)


@pytest.mark.parametrize("n", [1, 7, 40])
def test_msm_bodies_match_plain(host_lib, n, k):
    """K9's table launch and accumulation, K10's reduction and combination."""
    rows = _rows(k, n, n, identity_at=(2,))
    pk, nw = _digits(k, n, n)
    S = k.mb2.msm_slices(n)
    pts = _u64(rows)
    tbl = np.zeros((n, 8, 16), np.uint64)
    pre = np.zeros((n, 8, 16), np.uint64)
    acc = np.zeros((nw, S, 24), np.uint64)
    part = np.zeros((nw, 24), np.uint64)
    out = np.zeros(24, np.uint64)
    host_lib.host_bn2_msm(_p(pts), _p(tbl), _p(pre), _p(pk), n, nw, S,
                          _p(acc), _p(part), _p(out))
    plain = k.mb2.msm_plain(rows[None], k.torch.from_numpy(pk)[None])
    assert np.array_equal(out, _u64(plain)[0])


SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)  # in every row before a call

# K9's table cases: id -> (points, threads G, identity inputs).  Thread g
# builds and normalizes the entries of the points g, g + G, ...: G < n
# leaves ragged groups; with G = 3 and identities at 0, 3, 6, ... thread
# 0's whole group is identities.
TABLE_CASES = {"1": (1, 1, ()), "7-G7": (7, 7, (2,)), "7-G3": (7, 3, (4,)),
               "20-G3-identity-group": (20, 3, tuple(range(0, 20, 3))),
               "20-G6": (20, 6, (0, 19))}


def _table_plain(k, rows):
    """The affine entries K9's first launch must write: m P for m = 1..8
    of each input row, (x R, y R) in Montgomery form, (0, 0) for the
    identity."""
    cb2 = k.cb2
    mult = k.mb2._multiples(cb2.split_rows(cb2.encode_jacobian_rows(rows)))
    norm = k.torch.stack([cb2.normalize_rows(m) for m in mult[1:]], dim=1)
    mont = cb2.encode_jacobian_rows(norm)[..., :16]  # (x R, y R) over Z = R
    ident = norm[..., 16:].eq(0).all(-1, keepdim=True)
    return _u64(mont.masked_fill(ident, 0))


@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_table_body_matches_plain(host_lib, case, k):
    """K9's first launch over all G threads (each group normalized with one
    inversion) against the plain multiples, normalized: ragged groups, a
    group of identities, identity inputs and rows with Z != 1; the table
    and the scratch are filled with a sentinel first."""
    n, G, ident = TABLE_CASES[case]
    rows = _rows(k, n, 7 * n + G, identity_at=ident)
    tbl = np.full((n, 8, 16), SENTINEL)
    pre = np.full((n, 8, 16), SENTINEL)
    host_lib.host_bn2_table(_p(_u64(rows)), _p(tbl), _p(pre), n, G)
    want = _table_plain(k, rows)
    assert np.array_equal(tbl, want)
    assert all(not tbl[i].any() for i in ident)


# K9's accumulation cases: id -> (n, batches, slice count S).  Digit
# columns: slice 1 of batch 0 has only zero digits, point 3 of every batch
# is all zero digits, point 2 is the identity, and digits 8 and -7 occur.
ACCUM_CASES = {"9-B1-S3": (9, 1, 3), "13-B2-S4": (13, 2, 4),
               "40-B2-S2": (40, 2, 2)}


@pytest.mark.parametrize("case", list(ACCUM_CASES))
def test_accum_body_matches_plain(host_lib, case, k):
    """K9's accumulation over its table (mixed adds, identity entries and
    zero digits skipped) against msm_accumulate_plain, the accumulators
    normalized, filled with a sentinel first."""
    n, B, S = ACCUM_CASES[case]
    rows = k.torch.stack([_rows(k, n, 11 * n + b, identity_at=(2,))
                          for b in range(B)])
    rng = random.Random(n)
    sc = [[rng.randrange(ORDER) for _ in range(n)] for _ in range(B)]
    for b in range(B):
        sc[b][3] = 0
        sc[b][0] = 8 * 16 ** 5 - 7  # digits -7, 0, 0, 0, 0, 8
    sc[0][1::S] = [0] * len(sc[0][1::S])
    pk = np.stack([_digits_of(k, s) for s in sc])
    nw = 2 * pk.shape[1]
    tbl = np.zeros((B, n, 8, 16), np.uint64)
    pre = np.zeros((B, n, 8, 16), np.uint64)
    host_lib.host_bn2_table(_p(_u64(rows)), _p(tbl), _p(pre), B * n, 5)
    acc = np.full((B, nw, S, 24), SENTINEL)
    host_lib.host_bn2_msm_accum(_p(tbl), _p(pk), B, n, nw, S, _p(acc))
    plain = k.mb2.msm_accumulate_plain(rows, k.torch.from_numpy(pk), S)
    norm = lambda a: _u64(k.cb2.normalize_rows(k.cb2.split_rows(a)))  # noqa
    assert np.array_equal(norm(k.torch.from_numpy(acc.view(np.int64))),
                          norm(plain))


def _digits_of(k, scalars):
    pk, _ = k.mc.packed_digits(native._scalars_to_u64(scalars, ORDER), ORDER)
    return pk


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_coop_group_ops_match_plain(host_lib, lanes, k):
    """K10's group operations with their three levels of products spread
    over 1, 2, 4, 8, 16 or 32 lanes, the lanes run one after another, against the
    plain RCB15 law on the same working rows, word for word: random
    points, the identity, P + P and P + (-P)."""
    cb2 = k.cb2
    rows = cb2.encode_jacobian_rows(_rows(k, 6, 11, identity_at=(4,)))
    neg = cb2.join_rows(cb2.neg_where(k.torch.ones(1, dtype=k.torch.bool),
                                      cb2.split_rows(rows[:1])))
    pairs = [(0, 1), (2, 3), (4, 5), (5, 4), (4, 4), (1, 1), (0, "neg")]
    for i, j in pairs:
        p = rows[i:i + 1]
        q = neg if j == "neg" else rows[j:j + 1]
        want = {0: cb2.add(cb2.split_rows(p), cb2.split_rows(q)),
                1: cb2.dbl(cb2.split_rows(p))}
        for op in (0, 1):
            out = np.full(24, SENTINEL)
            host_lib.host_bn2_coop(op, lanes, _p(_u64(p)), _p(_u64(q)),
                                   _p(out))
            assert np.array_equal(out, _u64(cb2.join_rows(want[op]))[0]), (
                op, i, j)


# K10's cases: id -> (B, nw, S, R, lanes L of the windows' sums, lanes Lc
# of the Horners and the shift, window groups P, the window whose
# accumulators are all the identity or None).  S mod R runs up to R - 1
# (11 mod 4, 8 mod 3, 7 mod 4), S = 2 with R = 4 leaves two empty chunks,
# P = 8 over nw = 2 leaves empty groups.
TAIL_CASES = {"64-L8-16-P8": (1, 64, 11, 4, 8, 16, 8, 5),
              "B3-8-L4-P4": (3, 8, 8, 3, 4, 4, 4, 0),
              "B3-2-L2-P8": (3, 2, 5, 2, 2, 2, 8, None),
              "8-L1-P1": (1, 8, 4, 4, 1, 1, 1, 7),
              "2-L8-32-P4": (1, 2, 7, 4, 8, 32, 4, 1),
              "8-L8-16-P8-S2-R4": (1, 8, 2, 4, 8, 16, 8, None),
              "64-L4-8-P1-R1": (1, 64, 2, 1, 4, 8, 1, 63)}


@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_msm_tail_bodies_match_plain(host_lib, case, k):
    """K10's reduce chunks and its combination (each window's partials,
    the window groups' Horners, the shift and add, each step's lanes run one
    after another) against msm_tail_plain, the partials and the output
    filled with a sentinel first."""
    B, nw, S, R, L, Lc, P, ident = TAIL_CASES[case]
    rows = k.cb2.encode_jacobian_rows(_rows(k, B * nw * S, 3 * nw + S,
                                            identity_at=(1,)))
    acc = rows.reshape(B, nw, S, 24).clone()
    if ident is not None:
        acc[:, ident] = k.torch.tensor(k.cb2.IDENTITY_MONT_ROW)
    part = np.full((B, nw, R, 24), SENTINEL)
    out = np.full((B, 24), SENTINEL)
    host_lib.host_bn2_msm_tail(_p(_u64(acc)), _p(part), _p(out), B, nw, S,
                               R, L, Lc, P)
    assert np.array_equal(out, _u64(k.mb2.msm_tail_plain(acc)))


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


# K12's cases, as K7's in test_torch_bn_host.py: id -> (n, threads G or
# None for G = n, a challenge's name in msm_cuda.fold_challenges(ORDER) or
# None for a random one, identities).  G = 1
# folds every element in one thread, G = 3 and 6 leave ragged
# normalization groups; with identities every element of thread 0's group
# (0, G, 2G, ...) has identity gl and gr, and element 1 a gr with
# gl^c * gr the identity
FOLD_CASES = {"1": (1, None, None, False), "7": (7, None, None, False),
              "40": (40, None, None, False), "7-G1": (7, 1, None, False),
              "7-G3-c0": (7, 3, "c0", False), "7-G3-c1": (7, 3, "c1", False),
              "7-G3-c8": (7, 3, "c8", False), "7-G3-c9": (7, 3, "c9", False),
              "40-G6-order-1": (40, 6, "order-1", False),
              "40-G6-zero-run": (40, 6, "zero-run", False),
              "40-G6-identities": (40, 6, None, True)}


@pytest.mark.parametrize("n", list(FOLD_CASES))
def test_fold_body_matches_plain(host_lib, n, k):
    """K12's body over all G threads (each folding its elements g, g + G,
    ... from their input rows and normalizing them with one GF(p^2)
    inversion) against fold_plain and the C++ tier's MSM of (gl_i, gr_i)
    by (c, 1), the output and scratch filled with a sentinel first."""
    n, G, c, ident = FOLD_CASES[n]
    G = G or n
    if c is None:
        c = random.Random(n).randrange(ORDER)
    else:
        c = k.mc.fold_challenges(ORDER)[c]
    zero = list(range(0, n, G)) if ident else []
    gl = _points(n, 2 * n, [1] + zero)
    gr = _points(n, 2 * n + 1, [3] + zero)
    if ident and n > 1:
        gl[1] = BNTwistPoint.generator ** 77
        gr[1] = -(gl[1] ** c)
    gl_t, gr_t = (k.cb2.encode_points(p, "cpu") for p in (gl, gr))
    cdig = k.mc.fold_digits(c, ORDER)
    out = np.full((n, 24), SENTINEL)
    pre = np.full((n, 8), SENTINEL)
    host_lib.host_bn2_fold_norm(_p(_u64(gl_t)), _p(_u64(gr_t)), _p(cdig),
                                len(cdig), G, _p(pre), _p(out), n)
    assert np.array_equal(out, _u64(k.mb2.fold_plain(gl_t, gr_t, cdig)))
    host = BNTwistPoint.batch_normalize(
        [native.bn2_msm([a, b], [c, 1]) for a, b in zip(gl, gr)])
    assert np.array_equal(out, native._bn2_pts_to_u64(host))
    ident_row = [1, 0, 0, 0, 0, 0, 0, 0, 1] + [0] * 15
    assert all(out[i].tolist() == ident_row for i in zero + [1][:ident])


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
