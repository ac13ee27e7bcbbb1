#!/usr/bin/env python3
"""Where the time of one GPU prove or key generation goes (the
PyTorch/CUDA port, one card).

    python3 chip_profile.py [--snark | --keygen | --bucket] [--log2-muls 16]
                            [--out DIR]

Builds the chain circuit of ``chip_smoke.py``, sets up the generators on
the card and proves twice with no profiler (the first prove of a process
fills the host caches, the second is the steady time).  With ``--snark``
the prove is Pinocchio's over BN256 (the SparseQAP of the chain circuit,
keys from generate_keys_fast, compute_proof_fast: seven G1 MSMs and the
twist MSM on the card); with ``--keygen`` the stage is Pinocchio's key
generation itself (generate_keys_fast: eight G1 combs and the twist
batch-exp on the card; its first run in a process also builds the comb
tables); without either, the AC20 compressed-pivot prove over Ed25519,
and with ``--bucket`` that prove with the bucket MSM registered
(``msm_bucket_cuda.register()``: K13 + K14 serve protocol 5's commitment
A, 2^18 points at 2^16 multiplications, and the check asserts that they
ran).
Then it runs the stage twice more; every proof is verified, and every key
generation checked for its kernels' launches, outside the timed and
profiled parts:

1. under ``torch.profiler`` (CPU and CUDA activity): the stage's wall
   seconds, the device time of each kernel and copy, and the device's busy
   share (device time over wall time; every launch goes to one stream, so
   the device intervals do not overlap);
2. under ``cProfile``: the host functions with the most cumulative time,
   which say where the rest of the stage goes (cProfile slows pure-Python
   code, so its seconds are shares, not times).

With ``--out`` the full host table goes to ``DIR/profile_host.txt``
(``DIR/profile_host_snark.txt`` with ``--snark``,
``DIR/profile_host_keygen.txt`` with ``--keygen``,
``DIR/profile_host_bucket.txt`` with ``--bucket``).  The last line is one
JSON object with the numbers above.  Imports neither jax
nor the JAX package, and fails without a card.
"""

from __future__ import annotations

import argparse
import collections
import cProfile
import io
import json
import os
import pstats
import sys
import time

import chip_smoke as smoke

HOST_ROWS = 25


def _timed(torch, prove):
    """(proof, wall seconds of the prove, ended by a device sync)."""
    t0 = time.perf_counter()
    proof = prove()
    torch.cuda.synchronize()
    return proof, time.perf_counter() - t0


def ac20_path(vm, mc, log2_muls: int, bucket: bool = False):
    """(prove, check) of the Ed25519 flagship: the compressed-pivot prove
    and its verify, which also asserts that the resident engine ran (and
    with ``bucket`` that K13 and K14 did: the bucket MSM is registered
    after the generators are made)."""
    import verifiable_mpc_tpu_torch.ac20.circuit_sat_cb as cs
    from verifiable_mpc_tpu_torch.ac20 import pivot_gpu
    from verifiable_mpc_tpu_torch.ops import msm_bucket_cuda as bk

    pc = cs.PivotChoice.compressed
    group, gf, circuit, x, g_length = smoke.padded_circuit(vm, log2_muls)
    gens = cs.create_generators(g_length, pc, group)
    if bucket:
        bk.register()
    runs = [pivot_gpu.ENGINE_RUNS]
    seen = {}

    def prove():
        runs[0] = pivot_gpu.ENGINE_RUNS
        seen.update((k, mc.LAUNCHES[k]) for k in smoke.BUCKET_KERNELS)
        return cs.circuit_sat_prover(gens, circuit, x, gf, pc)

    def check(proof):
        assert pivot_gpu.ENGINE_RUNS > runs[0], "the GPU engine never ran"
        for k in smoke.BUCKET_KERNELS if bucket else ():
            assert mc.LAUNCHES[k] > seen[k], f"{k} never ran"
        ver = cs.circuit_sat_verifier(proof, gens, circuit, gf, pc)
        assert smoke.verified(ver), f"proof did not verify: {ver}"

    return prove, check


def snark_path(mc, log2_muls: int):
    """(prove, check) of Pinocchio over BN256: compute_proof_fast with
    fresh deltas, and its verify, which also asserts that K5 and the
    twist's K9 ran."""
    import verifiable_mpc_tpu_torch.trinocchio.pynocchio as pyn

    g1, g2, gf, qap = smoke.snark_setup(log2_muls)
    evalkey, verikey = smoke.snark_keygen(g1, g2, qap)
    c = qap.calculate_witness([gf(3)])
    keys = ("bn_msm_accumulate", "bn2_msm_accumulate")
    seen = {}

    def prove():
        seen.update((k, mc.LAUNCHES[k]) for k in keys)
        return smoke.snark_prove(g1, qap, c, evalkey)

    def check(proof):
        for k in keys:
            assert mc.LAUNCHES[k] > seen[k], f"{k} never ran"
        ver = pyn.verify(qap, verikey, proof, c[: qap.out_ix + 1])
        assert all(ver.values()), f"proof did not verify: {ver}"

    return prove, check


def keygen_path(mc, log2_muls: int):
    """(keygen, check) of Pinocchio over BN256: generate_keys_fast on the
    chain circuit's QAP, and a check that K8 and the twist's K11 ran."""
    g1, g2, _gf, qap = smoke.snark_setup(log2_muls)
    keys = ("bn_comb", "bn2_bexp")
    seen = {}

    def keygen():
        seen.update((k, mc.LAUNCHES[k]) for k in keys)
        return smoke.snark_keygen(g1, g2, qap)

    def check(_keys):
        for k in keys:
            assert mc.LAUNCHES[k] > seen[k], f"{k} never ran"

    return keygen, check


def device_table(torch, prof):
    """{name: (count, device ms)} of the device activity the profiler saw
    (kernels by function name, copies by kind)."""
    from torch.autograd import DeviceType

    table = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        row = table[e.name.split("(")[0][:60]]
        row[0] += 1
        row[1] += (e.time_range.end - e.time_range.start) / 1e3
    return dict(table)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    stage = ap.add_mutually_exclusive_group()
    stage.add_argument("--snark", action="store_true",
                       help="profile the Pinocchio prove over BN256")
    stage.add_argument("--keygen", action="store_true",
                       help="profile Pinocchio's key generation over BN256")
    stage.add_argument("--bucket", action="store_true",
                       help="profile the Ed25519 prove with the bucket MSM "
                       "registered")
    ap.add_argument("--log2-muls", type=int, default=None)
    ap.add_argument("--out", help="directory for the full host table")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import verifiable_mpc_tpu_torch as vm
    from verifiable_mpc_tpu_torch.ops import msm_cuda as mc

    print(smoke.card_line(), flush=True)
    vm.enable_gpu("cuda")
    if args.snark or args.keygen:
        log2 = args.log2_muls or smoke.SNARK_LOG2_MULS
        path_fn = keygen_path if args.keygen else snark_path
        prove, check = path_fn(mc, log2)
        path = "pinocchio-keygen" if args.keygen else "pinocchio"
    else:
        log2 = args.log2_muls or smoke.FLAGSHIP_LOG2_MULS
        prove, check = ac20_path(vm, mc, log2, args.bucket)
        path = "ac20-bucket" if args.bucket else "ac20"
    proof, warm = _timed(torch, prove)
    check(proof)
    proof, steady = _timed(torch, prove)
    check(proof)
    what = "keygen" if args.keygen else "prove"
    print(f"{path} {what} 2^{log2}: first {warm:.3f} s, second "
          f"{steady:.3f} s (no profiler)", flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        proof, wall = _timed(torch, prove)
    check(proof)
    dev = device_table(torch, prof)
    dev_ms = sum(ms for _n, ms in dev.values())
    print(f"profiled {what}: {wall:.3f} s wall (profiler on)", flush=True)
    for name, (count, ms) in sorted(dev.items(), key=lambda kv: -kv[1][1]):
        print(f"   device {name}: {count} x, {ms:.3f} ms", flush=True)
    busy = dev_ms / (wall * 1e3) if dev_ms else None
    print("   device busy share: "
          + (f"{busy:.4f}" if busy is not None else "not measured "
             "(the profiler saw no device activity)"), flush=True)

    host = cProfile.Profile()
    host.enable()
    proof, host_wall = _timed(torch, prove)
    host.disable()
    check(proof)
    buf = io.StringIO()
    pstats.Stats(host, stream=buf).sort_stats("cumulative").print_stats(
        HOST_ROWS)
    print(f"host profile: {host_wall:.3f} s wall under cProfile", flush=True)
    print(buf.getvalue(), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        full = io.StringIO()
        pstats.Stats(host, stream=full).sort_stats("cumulative").print_stats()
        name = ("profile_host_keygen.txt" if args.keygen
                else "profile_host_snark.txt" if args.snark
                else "profile_host_bucket.txt" if args.bucket
                else "profile_host.txt")
        with open(os.path.join(args.out, name), "w") as f:
            f.write(full.getvalue())

    print(json.dumps({
        "path": path, "stage": what, "log2_muls": log2, "first_s": warm,
        "second_s": steady, "profiled_s": wall,
        "device_ms": dev_ms, "device_busy": busy,
        "device": {name: {"count": c, "ms": ms}
                   for name, (c, ms) in dev.items()},
        "kind": torch.cuda.get_device_name(0),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
