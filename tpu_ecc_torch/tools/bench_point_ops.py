"""Device time of the single point operations, `padd` and `pdouble` (the
kernels behind padd_points and pdouble_points), and of the probes'
multiply chains, `fmul_chain` and `mxu_chain`, against those of another
checkout of the package.

    python3 -m tpu_ecc_torch.tools.bench_point_ops [--against DIR] [--turns N]

Each side runs in a process of its own (`python3 bench_point_ops.py
--worker` with the side's checkout first on PYTHONPATH, so that it imports
that side's tpu_ecc_torch and builds that side's kernels, all of them
started together): B = 8192 points k*G on secp256k1 and P-256 for the
point operations; B = 8192 random elements of secp256k1's field, P-256's
and k256mxu.fp (secp256k1's p forced onto Montgomery) for fmul_chain, of
the last two for mxu_chain (bench_mxu_mul's shapes). Each kernel is held
against its plain twin on the card (by canonical values mod p), then REPS
calls under torch.profiler, whose device time of the kernel's own
launches (the wrapper's int32 conversions left out; `devtime.device_ms`
of this checkout, which the worker, a script in this directory, imports
for both sides) gives the ms a call, and REPS calls between CUDA events
(the wrapper's whole call). With
--against DIR (for example a `git archive` of the parent commit unpacked
into a directory) the sides run in turns, other, this, this, other,
--turns rounds of four (default 1). Prints each worker's numbers and
returns them.
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
    """One side's numbers: {curve or field: {kernel: {"device_ms",
    "events_ms"}}}."""
    import numpy as np
    import torch
    from devtime import device_ms       # beside this file: the same code for both sides

    from tpu_ecc_torch.curves.specs import get_curve
    from tpu_ecc_torch.ops import fe as F
    from tpu_ecc_torch.ops import kernels as K
    from tpu_ecc_torch.ops import points as P
    from tpu_ecc_torch.utils import ec_host as H

    dev = torch.device("cuda")
    # (target, kernel, run, twin, field): points [3, n, B] compared by each
    # coordinate, field elements [n, B] as they are
    runs = []
    for name in CURVES:
        c = get_curve(name)
        rng = np.random.default_rng(11)
        pts = [H.aff_mul(c, int(k), H.aff_generator(c)) for k in rng.integers(1, 2**31, 16)]
        pts = pts * (2 * B // 16)
        Q = P.point_limbs(P.steady(P.from_affine_ints(c, [p[0] for p in pts],
                                                      [p[1] for p in pts], dev)))
        a, b = Q[..., :B].contiguous(), Q[..., B:].contiguous()
        runs += [(c, "padd", lambda c=c, a=a, b=b: K.padd(c, a, b),
                  lambda c=c, a=a, b=b: K.padd_plain(c, a, b), c.field),
                 (c, "pdouble", lambda c=c, a=a: K.pdouble(c, a),
                  lambda c=c, a=a: K.pdouble_plain(c, a), c.field)]
    k256 = get_curve("secp256k1")
    mxu = F.make_field_spec("k256mxu.fp", k256.p, "mont")
    rng = np.random.default_rng(9)
    for spec in (k256.field, get_curve("p256").field, mxu):
        vals = [int.from_bytes(rng.bytes(32), "big") % spec.p for _ in range(B)]
        a = F.fe_from_ints(spec, vals, dev).limbs
        b = F.fe_from_ints(spec, vals[::-1], dev).limbs
        for kname in ("fmul_chain", "mxu_chain") if spec.kind == "mont" else ("fmul_chain",):
            runs.append((spec, kname, lambda f=getattr(K, kname), s=spec, a=a, b=b: f(s, a, b),
                         lambda f=getattr(K, f"{kname}_plain"), s=spec, a=a, b=b: f(s, a, b),
                         spec))
    K.build_targets([(t, kname) for t, kname, *_ in runs])

    def canonical(spec, t):
        return F.fcanonical(F.fe_steady(spec, t.to(torch.int64))).limbs

    out = {}
    for target, kname, kern, plain, spec in runs:
        got, want = kern(), plain()
        pairs = zip(got, want) if got.dim() == 3 else [(got, want)]
        if not all(torch.equal(canonical(spec, g), canonical(spec, w)) for g, w in pairs):
            raise AssertionError(f"{kname} on {target.name} differs from its twin")
        # the kernel's own launches: padd_kernel or padd_chain_kernel (by the
        # side's source), pdouble_kernel, fmul_chain_kernel, mxu_chain_kernel
        dev_ms = device_ms(kern, REPS, kname)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(REPS):
            kern()
        end.record()
        torch.cuda.synchronize()
        out.setdefault(target.name, {})[kname] = {"device_ms": dev_ms,
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
