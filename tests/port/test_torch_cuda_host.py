"""The CUDA kernels' per-thread bodies (csrc/ed25519_kernels.cuh over
csrc/fe25519.cuh), built with g++ for the CPU, against the plain PyTorch
versions on the same inputs: the field and curve code of the kernels gets
checked without a card.  K2's combination (coop.cuh's lane groups over
the ed_coop steps) runs lane by lane, and K4's comb with a thread count G
that the test chooses.  The bucket MSM's bodies (K13's add with
negation, K14's suffix-scan and tree steps and its 8-bit Horner ladder),
K15's ladder and K16's Montgomery conversions are held against their
plain versions (msm_bucket_cuda, msm_cuda.bexp_plain, add_cuda.add_plain)
and against Python ints, and so are the probe kernels' loop bodies
(csrc/probe_ops.cuh, P1-P4) and the word-by-word Montgomery product mod
2^255 - 19.  Compiles a C++ file, so it is marked slow."""

import ctypes
import pathlib
import random
import shutil
import subprocess
import types

import numpy as np
import pytest

from verifiable_mpc_tpu_torch import native
from verifiable_mpc_tpu_torch.groups.bn256 import P as BN_P
from verifiable_mpc_tpu_torch.groups.edwards import ELL, EdwardsPoint

pytestmark = pytest.mark.slow

ROOT = pathlib.Path(__file__).resolve().parents[2]
CSRC = ROOT / "verifiable_mpc_tpu_torch" / "csrc"
EDGE = [0, 1, ELL // 2 - 1, ELL // 2, ELL // 2 + 1, ELL - 2, ELL - 1]


def _p(a):
    return ctypes.c_void_p(a.ctypes.data)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.fail("g++ is required to build the kernels' CPU harness")
    so = tmp_path_factory.mktemp("host_check") / "libhost_check.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(so),
                    str(CSRC / "host_check.cc")], check=True, timeout=300)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def k():
    """torch and the port's device-side modules, imported here and not at
    collection (every xdist worker collects this file)."""
    import torch

    from verifiable_mpc_tpu_torch.ops import (add_cuda, curve_ed, limbs_mont,
                                              msm_bucket_cuda, msm_cuda)

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield types.SimpleNamespace(torch=torch, ced=curve_ed, mc=msm_cuda,
                                bk=msm_bucket_cuda, add=add_cuda,
                                lm=limbs_mont)
    torch.set_num_threads(n)


def _points(n, seed):
    rng = random.Random(seed)
    exps = [rng.randrange(1, ELL) for _ in range(n)]
    pts = native.ed_batch_exp(EdwardsPoint.generator, exps)
    return np.ascontiguousarray(native._pts_to_u64(pts))


def _scalars(n, seed):
    rng = random.Random(seed)
    return (EDGE + [rng.randrange(ELL) for _ in range(n)])[:n]


# K1's cases: id -> (n, batches, slice count S or None for slices_for).
# Each batch holds an identity point (index 2), an all-zero scalar column
# (the scalar 0 at index 0) and scalars whose digits reach 8 and -7;
# S = 3 leaves a ragged last row of points, S = 300 slices with no point
MSM_CASES = {"1": (1, 1, None), "7": (7, 1, None), "40": (40, 1, None),
             "40-B2-S3": (40, 2, 3), "40-B2-S300": (40, 2, 300),
             "40-S300": (40, 1, 300), "300-B2": (300, 2, None)}
SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)  # in every row before a call


def _msm_scalars(n, seed):
    """The edge scalars, then scalars with digits 8 (8 * 16^k) and -7
    (ELL - 7 * 16^k), then random ones."""
    rng = random.Random(seed)
    special = [8, ELL - 7, 8 << 60, ELL - (7 << 100), 0]
    return (EDGE + special + [rng.randrange(ELL) for _ in range(n)])[:n]


def _ext_affine(rows):
    """(x, y) of each extended row [..., 16] (X, Y, Z, T), asserting
    Z != 0 and T Z = X Y mod p: a row that was never stored (the sentinel)
    or is degenerate fails here."""
    out = []
    for r in rows.reshape(-1, 16):
        x, y, z, t = (_fe_int(r[4 * j : 4 * j + 4]) for j in range(4))
        assert z % P and (t * z - x * y) % P == 0
        zi = pow(z, -1, P)
        out.append((x * zi % P, y * zi % P))
    return out


def _pre_affine(row):
    """(x, y) of a precomputed-form row (Y+X, Y-X, 2dT, 2Z)."""
    ypx, ymx, _t2d, z2 = (_fe_int(row[4 * j : 4 * j + 4]) for j in range(4))
    zi = pow(z2, -1, P)
    return (ypx - ymx) * zi % P, (ypx + ymx) * zi % P


@pytest.mark.parametrize("case", list(MSM_CASES))
def test_msm_bodies_match_plain(host_lib, case, k):
    """K1's table and accumulation bodies over the kernel's whole grid
    against the plain version, accumulators compared as affine points; the
    table against m * P; at one batch, K1 then K2 against msm_plain."""
    n, B, S = MSM_CASES[case]
    S = S or k.mc.slices_for(n, k.mc.ACCUM_POINTS_PER_THREAD)
    pts = [native.ed_batch_exp(EdwardsPoint.generator,
                               [random.Random(31 * n + b).randrange(1, ELL)
                                for _ in range(n)]) for b in range(B)]
    for b in range(B):
        if n > 2:
            pts[b][2] = EdwardsPoint.identity
    rows = np.stack([native._pts_to_u64(p) for p in pts])  # [B, n, 16]
    arrs = [native._ints_to_u64x4(_msm_scalars(n, n + b), ELL)
            for b in range(B)]
    packed = [k.mc.packed_digits(a) for a in arrs]
    nw = max(w for _, w in packed)
    assert all(w == nw for _, w in packed)
    pk = np.ascontiguousarray(np.stack([p for p, _ in packed]))
    d = k.mc.unpack_digits(k.torch.from_numpy(pk))
    assert not d[:, :, 0].any()
    if n > len(EDGE) + 1:
        assert (d[:, :, len(EDGE)] == 8).any() and (d == -7).any()
    tbl = np.full((B, n, 8, 16), SENTINEL)
    host_lib.host_msm_table(_p(rows), _p(tbl), ctypes.c_longlong(B * n))
    for b in range(B):
        for i in range(min(n, 4)):
            for m in range(1, 9):
                want = (pts[b][i] ** m).normalize()
                assert _pre_affine(tbl[b, i, m - 1]) == (want.x, want.y)
    pts_t = k.torch.stack([k.ced.from_reference_rows(r, "cpu") for r in rows])
    plain = k.ced.to_rows(k.mc.msm_accumulate_plain(
        pts_t, k.torch.from_numpy(pk), S))
    acc = np.full((B, nw, S, 16), SENTINEL)
    host_lib.host_msm_accum(_p(tbl), _p(pk), B, n, nw, S, _p(acc))
    assert _ext_affine(acc) == _ext_affine(plain)
    if B == 1:
        acc1 = np.full((nw, S, 16), SENTINEL)
        wsum = np.zeros((nw, 16), np.uint64)
        out = np.zeros(16, np.uint64)
        host_lib.host_msm(_p(rows[0]), _p(tbl[0]), _p(pk[0]), n, nw, S,
                          _p(acc1), _p(wsum), _p(out))
        full = k.mc.msm_plain(pts_t, k.torch.from_numpy(pk))
        assert np.array_equal(out, k.ced.to_rows(full)[0])


# K3's cases: id -> (n, threads G or None for G = n, challenge or None for
# a random one); G = 3 and 6 leave ragged normalization groups
FOLD_ZERO_RUN = sum(7 << (4 * w) for w in range(20, 63, 3))
FOLD_CASES = {"1": (1, None, None), "7": (7, None, None),
              "40": (40, None, None), "7-G3-c0": (7, 3, 0),
              "7-G3-c1": (7, 3, 1), "7-G3-c8": (7, 3, 8),
              "7-G3-c9": (7, 3, 9), "40-G6-cl-1": (40, 6, ELL - 1),
              "40-G6-zero-run": (40, 6, FOLD_ZERO_RUN)}


@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_fold_body_matches_plain(host_lib, case, k):
    """K3's body over all G threads (each folding its elements g, g + G,
    ... and normalizing them with one inversion) against fold_plain and the
    C++ tier's fold, the output and scratch filled with a sentinel first."""
    n, G, c = FOLD_CASES[case]
    G = G or n
    if c is None:
        c = _scalars(n + 1, 3)[-1]
    gl, gr = _points(n, 2 * n), _points(n, 2 * n + 1)
    cdig = np.ascontiguousarray(k.mc.fold_digits(c))
    out = np.full((n, 16), SENTINEL)
    pre = np.full((n, 4), SENTINEL)
    host_lib.host_fold_norm(_p(gl), _p(gr), _p(cdig), len(cdig), G,
                            _p(pre), _p(out), n)
    plain = k.mc.fold_plain(k.ced.from_reference_rows(gl, "cpu"),
                            k.ced.from_reference_rows(gr, "cpu"), cdig)
    assert np.array_equal(out, k.ced.to_rows(plain))
    host = native.ed_fold_arr(gl, gr, native._ints_to_u64x4([c], ELL))
    native.ed_batch_normalize_arr(host)
    assert np.array_equal(out, host)


P = (1 << 255) - 19
FE_EDGE = [0, 1, 19, 38, P - 1, P, P + 1, 2 * P - 1, (1 << 255) - 1,
           (1 << 256) - 38, (1 << 256) - 1]
FE_BINARY = {"mul": lambda a, b: a * b, "add": lambda a, b: a + b,
             "sub": lambda a, b: a - b}


def _fe(v):
    return np.array([(v >> (64 * i)) & ((1 << 64) - 1) for i in range(4)],
                    np.uint64)


def _fe_int(a):
    return sum(int(x) << (64 * i) for i, x in enumerate(a))


def _fe_canon(host_lib, r):
    out = np.zeros(4, np.uint64)
    host_lib.host_fe_canon(_p(r), _p(out))
    return _fe_int(out)


@pytest.mark.parametrize("op", sorted(FE_BINARY))
def test_field_bodies_match_ints(host_lib, op):
    """fe25519.cuh on relaxed edge values (up to 2^256 - 1): the result,
    canonicalized, is the residue Python computes."""
    fn = getattr(host_lib, f"host_fe_{op}")
    for a in FE_EDGE:
        for b in FE_EDGE:
            x, y, r = _fe(a), _fe(b), np.zeros(4, np.uint64)
            fn(_p(x), _p(y), _p(r))
            assert _fe_canon(host_lib, r) == FE_BINARY[op](a, b) % P, (a, b)


def test_field_inverse_body_matches_pow(host_lib):
    for v in FE_EDGE:
        if v % P == 0:
            continue
        x, r = _fe(v), np.zeros(4, np.uint64)
        host_lib.host_fe_inv(_p(x), _p(r))
        assert _fe_canon(host_lib, r) == pow(v, P - 2, P), v


def test_field_var_inverse_body_matches_pow(host_lib):
    """K2's binary extended Euclid inversion on the relaxed edge values
    (0 mod p gives 0) and random ones: canonical, and z^(p-2)."""
    rng = random.Random(8)
    for v in FE_EDGE + [2, P - 2, (P + 1) // 2] + [
            rng.randrange(1 << 256) for _ in range(300)]:
        x, r = _fe(v), np.zeros(4, np.uint64)
        host_lib.host_fe_inv_var(_p(x), _p(r))
        assert _fe_int(r) == pow(v, P - 2, P), v


# K4's cases: id -> (n, threads G or None for G = n, base "identity" or a
# power of the generator); G = 3 and 6 leave ragged groups, and thread 0's
# group is all exponent 0 (also exponent 1 where n > 1)
COMB_CASES = {"1": (1, None, "g"), "7": (7, None, "g"), "40": (40, None, "g"),
              "7-G3": (7, 3, "g"), "40-G6": (40, 6, "g"),
              "40-G6-identity": (40, 6, "identity")}


def _comb_exponents(n, G, seed):
    exps = _scalars(n, seed)
    for i in [1] + list(range(0, n, G)):
        if i < n:
            exps[i] = 0
    return exps


@pytest.mark.parametrize("case", list(COMB_CASES))
def test_comb_body_matches_plain(host_lib, case, k):
    """K4's body over all G threads (each summing its exponents g, g + G,
    ... over the affine table and normalizing them with one inversion)
    against comb_plain and the C++ tier's batch-exp, output and scratch
    filled with a sentinel first."""
    n, G, kind = COMB_CASES[case]
    G = G or n
    exps = _comb_exponents(n, G, 5 * n)
    pk, nw = k.mc.packed_digits(native._ints_to_u64x4(exps, ELL))
    base = (EdwardsPoint.identity if kind == "identity"
            else EdwardsPoint.generator ** 12345)
    table = k.mc.comb_table(base, nw, "cpu")
    tb = np.ascontiguousarray(table.numpy().view(np.uint64))
    assert tb.shape == (nw * 9, 12)
    out = np.full((n, 16), SENTINEL)
    pre = np.full((n, 4), SENTINEL)
    host_lib.host_comb_norm(_p(tb), _p(pk), n, nw, G, _p(pre), _p(out))
    plain = k.mc.comb_plain(table, k.torch.from_numpy(pk))
    assert np.array_equal(out, k.ced.to_rows(plain))
    host = native._pts_to_u64(EdwardsPoint.batch_normalize(
        native.ed_batch_exp(base, exps)))
    assert np.array_equal(out, host)
    ident = [0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0]
    zero = [i for i in range(n)
            if i % G == 0 or i == 1 or kind == "identity"]
    assert all(out[i].tolist() == ident for i in zero)


def test_comb_table_rows_are_affine_multiples(k):
    """K4's table rows: row w*9 + m is (y+x, y-x, 2dxy) of the normalized
    m * 16^(nw-1-w) * base (m = 0: the identity's (1, 1, 0))."""
    from verifiable_mpc_tpu_torch.groups.edwards import D

    base = EdwardsPoint.generator ** 777
    nw = 8
    tb = k.mc.comb_table(base, nw, "cpu").numpy().view(np.uint64)
    for w in range(nw):
        for m in range(9):
            pt = (base ** (m * 16 ** (nw - 1 - w))).normalize()
            want = [(pt.y + pt.x) % P, (pt.y - pt.x) % P,
                    2 * D * pt.x * pt.y % P]
            row = tb[w * 9 + m]
            assert [_fe_int(row[4 * j : 4 * j + 4]) for j in range(3)] == want


@pytest.mark.parametrize("lanes", [1, 2, 3, 4, 8])
def test_coop_group_ops_match_plain(host_lib, lanes, k):
    """K2's group operations with their products spread over 1-8 lanes,
    the lanes run one after another, against the plain law (add-2008-hwcd-3,
    dbl-2008-hwcd) on the same rows, coordinate for coordinate: random
    points, the identity, P + P, P + (-P) and rows with Z != 1."""
    pts = _rescaled_points(6, 11)  # point 2 the identity, 0 and 3 Z != 1
    pts.append(-pts[0])
    rows = np.ascontiguousarray(native._pts_to_u64(pts))
    t = k.ced.split_rows(k.ced.from_reference_rows(rows, "cpu"))
    pairs = [(0, 1), (2, 3), (4, 5), (5, 2), (2, 2), (1, 1), (0, 6), (3, 0)]
    for i, j in pairs:
        p = tuple(c[i : i + 1] for c in t)
        q = tuple(c[j : j + 1] for c in t)
        want = {0: k.ced.add(p, q), 1: k.ced.dbl(p)}
        for op in (0, 1):
            out = np.full(16, SENTINEL)
            host_lib.host_ed_coop(op, lanes, _p(rows[i]), _p(rows[j]),
                                  _p(out))
            expect = k.ced.to_rows(k.ced.join_rows_relaxed(want[op]))[0]
            assert np.array_equal(out, expect), (op, i, j)


# K2's cases: id -> (B, nw, S, R, lanes L of the windows' sums, lanes Lc of
# the Horners, window groups P, the window whose accumulators are all the
# identity or None).  S = 7 with R = 3 and S = 5 with R = 2 leave a short
# last chunk, S = 2 with R = 4 empty chunks, nw = 9 and 3 a short last
# group and empty groups, P = 1 the one-group Horner
TAIL_CASES = {"64-L4-P8": (1, 64, 3, 2, 4, 4, 8, 5),
              "B2-9-L2-P4": (2, 9, 7, 3, 2, 2, 4, 0),
              "B2-3-L1-P8": (2, 3, 5, 2, 1, 4, 8, None),
              "8-L4-Lc8-P1": (1, 8, 4, 4, 4, 8, 1, 7),
              "B2-64-S2-R4-P16": (2, 64, 2, 4, 4, 4, 16, 63),
              "1-S1": (1, 1, 1, 1, 4, 4, 8, None)}


@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_msm_tail_bodies_match_plain(host_lib, case, k):
    """K2's reduce chunks and its combination (each window's partials, the
    window groups' Horners, the shift and add, each step's lanes run one
    after another) against msm_tail_plain and the C++ tier's MSM of the
    accumulators by 16^(nw-1-w), the output and partials filled with a
    sentinel first."""
    B, nw, S, R, L, Lc, P_, ident = TAIL_CASES[case]
    pts = _rescaled_points(B * nw * S, 3 * nw + S)
    if ident is not None:
        for b in range(B):
            for s in range(S):
                pts[(b * nw + ident) * S + s] = EdwardsPoint.identity
    rows = np.ascontiguousarray(native._pts_to_u64(pts))
    acc = rows.reshape(B, nw, S, 16)
    part = np.full((B, nw, R, 16), SENTINEL)
    out = np.full((B, 16), SENTINEL)
    host_lib.host_msm_tail(_p(acc), _p(part), _p(out), B, nw, S, R, L, Lc,
                           P_, 4)
    plain = k.mc.msm_tail_plain(k.ced.from_reference_rows(
        rows, "cpu").reshape(B, nw, S, 16))
    assert np.array_equal(out, k.ced.to_rows(plain))
    sc = [16 ** (nw - 1 - w) % ELL for w in range(nw) for _ in range(S)]
    for b in range(B):
        host = native.ed_msm(pts[b * nw * S:(b + 1) * nw * S], sc)
        assert native._u64_to_pts(out[b:b + 1])[0] == host


def test_msm_tail_body_identity_result(host_lib, k):
    """K2 where every window sums to the identity (P and -P in each): the
    result is exactly the identity row (0, 1, 1, 0)."""
    B, nw, S = 2, 3, 2
    pts = []
    for p in _rescaled_points(B * nw, 5):
        pts += [p, -p]
    rows = np.ascontiguousarray(native._pts_to_u64(pts))
    part = np.full((B, nw, 1, 16), SENTINEL)
    out = np.full((B, 16), SENTINEL)
    host_lib.host_msm_tail(_p(rows), _p(part), _p(out), B, nw, S, 1, 4, 4, 8,
                           4)
    assert out.tolist() == [IDENT_ROW] * B


IDENT_ROW = [0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("nw", [1, 3, 32])
def test_tail_combine_window_bits_match_plain_horner(host_lib, bits, nw, k):
    """coop.cuh's combination (tail_window, tail_group, tail_shift) with
    windows of 4 bits (K2's) and 8 bits (K14's), 8 window groups of 4
    lanes, against the plain Horner sum_w 2^(bits (nw-1-w)) S_w and the C++
    tier's MSM; then with every window summing to the identity, the
    identity row."""
    S = 2
    pts = _rescaled_points(nw * S, 7 * nw + bits)
    rows = np.ascontiguousarray(native._pts_to_u64(pts))
    part = np.full((1, nw, 1, 16), SENTINEL)
    out = np.full((1, 16), SENTINEL)
    host_lib.host_msm_tail(_p(rows), _p(part), _p(out), 1, nw, S, 1, 4, 4, 8,
                           bits)
    acc = k.ced.from_reference_rows(rows, "cpu").reshape(1, nw, S, 16)
    sums = k.mc._tree_sum(k.ced.split_rows(acc), 2)
    plain = k.ced.normalize_rows(k.mc._horner(sums, nw, bits=bits))
    assert np.array_equal(out, k.ced.to_rows(plain))
    sc = [pow(2, bits * (nw - 1 - w), ELL) for w in range(nw) for _ in range(S)]
    assert native._u64_to_pts(out)[0] == native.ed_msm(pts, sc)
    zero = []
    for p in pts[:nw]:
        zero += [p, -p]
    rows = np.ascontiguousarray(native._pts_to_u64(zero))
    host_lib.host_msm_tail(_p(rows), _p(part), _p(out), 1, nw, S, 1, 4, 4, 8,
                           bits)
    assert out.tolist() == [IDENT_ROW]


def _rescaled_points(n, seed):
    """Rows of n points, every third one with Z != 1 and point 2 the
    identity (1 : 1 : 1 : 0) scaled, as K13 and K16 meet them."""
    rng = random.Random(seed)
    pts = native.ed_batch_exp(EdwardsPoint.generator,
                              [rng.randrange(1, ELL) for _ in range(n)])
    if n > 2:
        pts[2] = EdwardsPoint.identity
    for i in range(0, n, 3):
        lam = rng.randrange(2, P)
        q = pts[i]
        pts[i] = EdwardsPoint(q.x * lam, q.y * lam, q.z * lam, q.t * lam)
    return pts


def _bucket_inputs(k, n, seed, lanes=None, small=False):
    """Rows, compact layout and bucket sums (plain K13) of an MSM of n
    points with edge scalars, the digits 128 and -128 among them; with
    ``small`` scalars whose digits lie in -3..3 (the lanes = 4 layout, and
    at lanes 128 trailing empty columns in every window)."""
    lanes = lanes or k.bk.LANES
    rng = random.Random(seed)
    if small:
        sc = [sum(rng.randrange(4) << (8 * j) for j in range(3))
              for _ in range(n)]
        sc = [ELL - v if i % 3 == 1 else v for i, v in enumerate(sc)]
    else:
        sc = ([ELL - 1, 1, 128 + (128 << 8), ELL - 128, ELL // 2,
               ELL // 2 + 1] + _scalars(n, seed))[:n]
    rows = np.ascontiguousarray(native._pts_to_u64(_rescaled_points(n, seed)))
    entries, offsets, count = k.bk.layout_for(sc, 8, lanes, "cpu")
    plain = k.bk.bucket_accumulate_plain(
        k.ced.from_reference_rows(rows, "cpu"), entries, offsets, lanes)
    return sc, rows, entries, offsets, count, plain


# K13's cases: id -> (n, entries a thread C, lanes a column's combination
# M, lanes, small digits).  C = 5 and 3 divide no column ("C5", "C3"),
# C = 2 with M = 3 makes the top window's columns span many threads and
# many partials a combining lane, C = 64 at lanes 4 one thread span many
# short columns and empty ones, small digits at lanes 128 leave trailing
# empty columns in every window; M = 32 is the kernel's warp
ACCUM_CASES = {"1-C64": (1, 64, 32, 128, False),
               "17-C3-M2": (17, 3, 2, 128, False),
               "64-C5": (64, 5, 32, 128, False),
               "64-C2-M3": (64, 2, 3, 128, False),
               "9-C64-lanes4": (9, 64, 32, 4, True),
               "40-C7-lanes4": (40, 7, 2, 4, True),
               "40-C4-trailing-empty": (40, 4, 32, 128, True)}


@pytest.mark.parametrize("case", list(ACCUM_CASES))
def test_bucket_accum_bodies_match_plain(host_lib, case, k):
    """K13's steps (precomputed form, every accumulation thread over its C
    entries, every column's combination with M lanes) against the plain
    version: equal bucket sums once normalized (the two add in other
    orders), the output and partials filled with a sentinel first, empty
    columns the identity row."""
    n, chunk, M, lanes, small = ACCUM_CASES[case]
    _sc, rows, entries, offsets, count, plain = _bucket_inputs(
        k, n, n + chunk, lanes, small)
    nw = (offsets.numel() - 1) // lanes
    off = offsets.numpy()
    pre = np.zeros((n, 16), np.uint64)
    part = np.full((-(-count // chunk), 2, 16), SENTINEL)
    buf = np.full((M, 16), SENTINEL)
    out = np.full((nw * lanes, 16), SENTINEL)
    host_lib.host_bucket_accum(_p(rows), _p(pre), _p(entries.numpy()),
                               _p(off), _p(part), _p(buf), _p(out), n, nw,
                               lanes, count, chunk, M)
    empty = np.diff(off) == 0
    assert empty.any()
    assert (out[empty] == np.array(IDENT_ROW, np.uint64)).all()
    norm = lambda t: k.ced.normalize_rows(k.ced.split_rows(t))  # noqa: E731
    got = k.ced.from_reference_rows(out, "cpu")
    assert k.torch.equal(norm(got), norm(plain.reshape(-1, 16)))


@pytest.mark.parametrize("n,L,P_", [(1, 4, 8), (17, 4, 8), (64, 4, 8),
                                    (64, 1, 3), (17, 2, 1)])
def test_bucket_reduce_bodies_match_plain_and_native(host_lib, n, L, P_, k):
    """K14's suffix scan and tree on lane groups of L lanes, run step by
    step, and its combination with 8-bit windows over P window groups
    against the plain version and the C++ tier's MSM of the same points
    and scalars."""
    sc, rows, _e, _o, _c, plain = _bucket_inputs(k, n, 3 * n)
    nw, lanes, _ = plain.shape
    buckets = np.ascontiguousarray(k.ced.to_rows(plain))
    wsum = np.full((nw, 16), SENTINEL)
    out = np.full(16, SENTINEL)
    host_lib.host_bucket_reduce(_p(buckets), _p(wsum), _p(out), nw, lanes, L,
                                P_)
    expect = k.ced.to_rows(k.bk.bucket_reduce_plain(plain))[0]
    assert np.array_equal(out, expect)
    host = native.ed_msm(native._u64_to_pts(rows), sc)
    assert native._u64_to_pts(out[None])[0] == host


@pytest.mark.parametrize("lanes", [4, 5, 128])
def test_bucket_reduce_body_identity_result(host_lib, lanes, k):
    """K14 where every window's weighted sum is the identity (bucket 0 holds
    -2 P and bucket 1 P, the rest the identity): the identity row."""
    nw = 3
    ident = EdwardsPoint.identity
    pts = []
    for p in _rescaled_points(nw, 11):
        pts += [p ** (ELL - 2), p] + [ident] * (lanes - 2)
    buckets = np.ascontiguousarray(native._pts_to_u64(pts))
    wsum = np.full((nw, 16), SENTINEL)
    out = np.full(16, SENTINEL)
    host_lib.host_bucket_reduce(_p(buckets), _p(wsum), _p(out), nw, lanes, 4,
                                8)
    assert out.tolist() == IDENT_ROW


@pytest.mark.parametrize("n", [1, 7, 40])
def test_bexp_body_matches_plain(host_lib, n, k):
    sc = _scalars(n, 7 * n)
    pk, nw = k.mc.packed_digits(native._ints_to_u64x4(sc, ELL))
    base = EdwardsPoint.generator ** 4242
    table = k.mc.bexp_table(base, "cpu")
    tb = np.ascontiguousarray(k.ced.to_rows(table))
    out = np.zeros((n, 16), np.uint64)
    host_lib.host_bexp_norm(_p(tb), _p(pk), n, nw, _p(out))
    plain = k.mc.bexp_plain(table, k.torch.from_numpy(pk))
    assert np.array_equal(out, k.ced.to_rows(plain))
    assert native._u64_to_pts(out) == [base ** s for s in sc]


@pytest.mark.parametrize("n", [1, 9])
def test_mont_add_body_matches_plain_and_ints(host_lib, n, k):
    """K16: Montgomery limbs in, the unified add, canonical Montgomery
    limbs out, against the plain version limb for limb and against the
    host law; the conversions against Python ints."""
    pts_p = _rescaled_points(n, 11 * n)
    pts_q = _rescaled_points(n, 11 * n + 1)[::-1]
    mp, mq = k.lm.encode_points(pts_p), k.lm.encode_points(pts_q)
    outs = [np.zeros((n, 16), np.uint32) for _ in range(4)]
    host_lib.host_mont_add(*(_p(a) for a in (*mp, *mq, *outs)), n)
    plain = k.add.add_plain(tuple(k.torch.from_numpy(a) for a in mp),
                            tuple(k.torch.from_numpy(a) for a in mq))
    for a, b in zip(outs, plain):
        assert np.array_equal(a, b.numpy())
    assert k.lm.decode_points(outs) == [a * b for a, b in zip(pts_p, pts_q)]
    for c in outs:
        assert all(v < P for v in k.lm.limbs_to_ints(c))
    assert k.lm.limbs_to_ints(mp[0]) == [pt.x * (1 << 256) % P
                                         for pt in pts_p]


# ---------------------------------------------------------------------------
# the probe kernels' loop bodies (csrc/probe_ops.cuh), P1-P4
# ---------------------------------------------------------------------------

PROBE_STEPS = [1, 7, 33]  # 33: two unrolled turns of 16 and one step
P_BN = BN_P
R256 = 1 << 256
U32_STEP = {
    0: lambda a, b: ((a * b) & 0xFFFFFFFF & 0xFFFF)
    + (((a * b) & 0xFFFFFFFF) >> 16),
    1: lambda a, b: (a * b + 1) & 0xFFFFFFFF,
    2: lambda a, b: ((a + b) & 0xFFFFFFFF) ^ a,
}


def _words(vals):
    """Python ints below 2^256 -> word-major [8, n] uint32."""
    return np.ascontiguousarray(np.array(
        [[(v >> (32 * k)) & 0xFFFFFFFF for v in vals] for k in range(8)],
        np.uint32))


def _words_ints(w):
    return [sum(int(w[k, i]) << (32 * k) for k in range(8))
            for i in range(w.shape[1])]


def _field_inputs(n, seed):
    rng = random.Random(seed)
    edge = [0, 1, P, P + 1, 2 * P - 1, R256 - 1, P_BN, P_BN + 1]
    return ((edge + [rng.randrange(R256) for _ in range(n)])[:n],
            [rng.randrange(R256) for _ in range(n)])


@pytest.mark.parametrize("steps", PROBE_STEPS)
@pytest.mark.parametrize("op", [0, 1, 2],
                         ids=["u32_mul_split", "u32_mul", "u32_add"])
def test_probe_vpu_body_matches_python_ints(host_lib, op, steps):
    rng = np.random.RandomState(op * 100 + steps)
    x = rng.randint(0, 1 << 32, 40, dtype=np.int64).astype(np.uint32)
    y = rng.randint(0, 1 << 32, 40, dtype=np.int64).astype(np.uint32)
    out = np.zeros(40, np.uint32)
    host_lib.host_probe_vpu(op, _p(x), _p(y), _p(out), 40, steps)
    want = []
    for a, b in zip(x.tolist(), y.tolist()):
        for _ in range(steps):
            a = U32_STEP[op](a, b)
        want.append(a)
    assert out.tolist() == want


@pytest.mark.parametrize("steps", PROBE_STEPS)
def test_probe_fma_body_matches_plain(host_lib, k, steps):
    """f32_fma's body (one fused rounding a step) against the plain
    version within 4 units in the last place."""
    from verifiable_mpc_tpu_torch.probes import probe_vpu as pv

    rng = np.random.RandomState(steps)
    x = rng.rand(64).astype(np.float32)
    y = rng.rand(64).astype(np.float32)
    out = np.zeros(64, np.float32)
    host_lib.host_probe_vpu(3, _p(x), _p(y), _p(out), 64, steps)
    want = pv.plain_vpu_op("f32_fma", k.torch.from_numpy(x),
                           k.torch.from_numpy(y), steps).numpy()
    ulps = np.abs(out.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("op", [0, 1, 2],
                         ids=["mul25519", "mont_mul", "fp_mul"])
def test_probe_field_bodies_match_python_ints(host_lib, op, steps):
    """P2's products on inputs at and above p: results below 2^256 and
    congruent to x * (y s)^steps, s = 1 or R^-1."""
    xs, ys = _field_inputs(24, op)
    x, y = _words(xs), _words(ys)
    out = np.zeros_like(x)
    host_lib.host_probe_field(op, _p(x), _p(y), _p(out), 24, steps)
    p = P_BN if op == 2 else P
    s = 1 if op == 0 else pow(R256, -1, p)
    got = _words_ints(out)
    assert all(g < R256 for g in got)
    assert [g % p for g in got] == [xv * pow(yv * s, steps, p) % p
                                    for xv, yv in zip(xs, ys)]


@pytest.mark.parametrize("chains", [1, 4])
def test_probe_chain_bodies_match_python_ints(host_lib, chains):
    n = 16
    starts = [_field_inputs(n, 10 + c)[0] for c in range(chains)]
    bs = _field_inputs(n, 20)[1]
    a = np.ascontiguousarray(np.stack([_words(v) for v in starts]))
    b = _words(bs)
    out = np.zeros_like(a)
    host_lib.host_probe_chain(chains, _p(a), _p(b), _p(out), n, 5)
    for c in range(chains):
        assert [g % P for g in _words_ints(out[c])] == [
            xv * pow(yv, 5, P) % P for xv, yv in zip(starts[c], bs)]


def test_probe_raw_body_matches_python_ints(host_lib):
    rng = np.random.RandomState(3)
    x = rng.randint(0, 1 << 16, 32).astype(np.uint32)
    y = rng.randint(0, 1 << 16, 32).astype(np.uint32)
    out = np.zeros(32, np.uint32)
    host_lib.host_probe_raw(_p(x), _p(y), _p(out), 32, 70)
    want = []
    for a, b in zip(x.tolist(), y.tolist()):
        for _ in range(70):
            a = (a * b + 1) & 0xFFFFFFFF
        want.append(a)
    assert out.tolist() == want


def test_mont25519_mul_edges(host_lib):
    """The word-by-word Montgomery product on edge values: a * b * 2^-256
    mod p, below 2^256 (not always below p)."""
    r_inv = pow(R256, -1, P)
    for a in FE_EDGE:
        for b in FE_EDGE:
            r = np.zeros(4, np.uint64)
            fa, fb = _fe(a), _fe(b)  # kept alive across the call
            host_lib.host_mont25519_mul(_p(fa), _p(fb), _p(r))
            v = _fe_int(r)
            assert v < R256 and v % P == a * b * r_inv % P, (a, b)
