"""Device time of the single point operations, `padd` and `pdouble` (the
kernels behind padd_points and pdouble_points), against those of another
checkout of the package.

    python3 -m tpu_ecc_torch.tools.bench_point_ops [--against DIR] [--turns N]

Each side runs in a process of its own (`python3 bench_point_ops.py
--worker` with the side's checkout first on PYTHONPATH, so that it imports
that side's tpu_ecc_torch and builds that side's kernels): B = 8192 points
k*G on secp256k1 and P-256, each kernel held against its plain twin on
the card (by canonical coordinates mod p), then REPS calls under
torch.profiler, whose device time of the kernel's own launches (the
wrapper's int32 conversions left out) gives the ms a call, and REPS calls
between CUDA events (the wrapper's whole call). With --against DIR (for
example a `git archive` of the parent commit unpacked into a directory)
the sides run in turns, other, this, this, other, --turns rounds of four
(default 1). Prints each worker's numbers and returns them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
B, REPS = 8192, 20
CURVES = ("secp256k1", "p256")


def worker() -> dict:
    """One side's numbers: {curve: {kernel: {"device_ms", "events_ms"}}}."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_ecc_torch.curves.specs import get_curve
    from tpu_ecc_torch.ops import fe as F
    from tpu_ecc_torch.ops import kernels as K
    from tpu_ecc_torch.ops import points as P
    from tpu_ecc_torch.utils import ec_host as H

    dev = torch.device("cuda")
    out = {}
    for name in CURVES:
        c = get_curve(name)
        rng = np.random.default_rng(11)
        pts = [H.aff_mul(c, int(k), H.aff_generator(c)) for k in rng.integers(1, 2**31, 16)]
        pts = pts * (2 * B // 16)
        Q = P.point_limbs(P.steady(P.from_affine_ints(c, [p[0] for p in pts],
                                                      [p[1] for p in pts], dev)))
        a, b = Q[..., :B].contiguous(), Q[..., B:].contiguous()
        runs = {"padd": (lambda: K.padd(c, a, b), lambda: K.padd_plain(c, a, b)),
                "pdouble": (lambda: K.pdouble(c, a), lambda: K.pdouble_plain(c, a))}
        K.build(c, list(runs))
        out[name] = {}
        for kname, (kern, plain) in runs.items():
            got, want = kern(), plain()
            for i in range(3):
                if not torch.equal(F.fcanonical(F.fe_steady(c.field, got[i])).limbs,
                                   F.fcanonical(F.fe_steady(c.field, want[i])).limbs):
                    raise AssertionError(f"{kname} on {name} differs from its twin")
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(REPS):
                    kern()
                torch.cuda.synchronize()
            # the kernel's own launches: padd_kernel, padd_chain_kernel or
            # pdouble_kernel, by the side's source
            us = sum(next((getattr(e, f) for f in ("self_device_time_total",
                                                   "self_cuda_time_total") if hasattr(e, f)), 0)
                     for e in prof.key_averages()
                     if kname in e.key and "_kernel" in e.key)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(REPS):
                kern()
            end.record()
            torch.cuda.synchronize()
            out[name][kname] = {"device_ms": us / 1e3 / REPS,
                                "events_ms": start.elapsed_time(end) / REPS}
    return out


def run_side(root: str) -> dict:
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker"], env=env,
                         cwd=root, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"worker in {root} failed:\n{res.stdout}\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default=None, help="another checkout's root")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker()))
        return []
    other = None if args.against is None else os.path.abspath(args.against)
    order = ["this"] if other is None else ["other", "this", "this", "other"] * args.turns
    got = []
    for side in order:
        res = run_side(ROOT if side == "this" else other)
        got.append((side, res))
        print(f"{side}: " + "; ".join(
            f"{c} {k} device {v['device_ms']:.4f} ms, events {v['events_ms']:.4f} ms"
            for c, ks in res.items() for k, v in ks.items()), flush=True)
    return got


if __name__ == "__main__":
    main()
