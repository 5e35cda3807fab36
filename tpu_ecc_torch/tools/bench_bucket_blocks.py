"""bucket_reduce's block size: registers, spills and time on the card.

csrc/bucket_reduce.cu takes its threads a block from BUCKET_THREADS, which
its __launch_bounds__ follows. This builds the source for secp256k1 at each
size in SIZES (nvcc -DBUCKET_THREADS=k, one process each, together), prints
ptxas's registers and spills for each, holds each against
kernels.bucket_reduce_plain by canonical coordinates mod p at the MSM's
shapes (nbuck = 8192 buckets a window, 8 windows and the last call's 3), and
times them in turns (ROUNDS rounds, the order reversed in every other).

    python3 -m tpu_ecc_torch.tools.bench_bucket_blocks
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np
import torch

from ..curves.specs import get_curve
from ..ops import kernels as K
from ..ops import kfe
from ..ops import points as P
from ..utils import ec_host as H
from . import device_label
from .bench_ladder_forms import _canonical

SIZES = (32, 64, 128)
NBUCK, WINDOWS = 8192, (8, 3)
ROUNDS, REPS = 8, 5          # rounds in turns; calls a timing


def build(curve) -> dict:
    """{block size: (library path, nvcc's report)}, built under
    kernels.BUILD_DIR and named by a hash of the sources, the header, the
    flags and the size."""
    name = K.KERNELS["bucket_reduce"][0]
    src = os.path.join(K.CSRC, name)
    texts = []
    for f in [name] + K.includes(name):
        with open(os.path.join(K.CSRC, f)) as fh:
            texts.append(fh.read())
    header = K._header("bucket_reduce", curve)
    jobs = {}
    for size in SIZES:
        flags = (*K.NVCC_FLAGS, f"-DBUCKET_THREADS={size}")
        key = hashlib.sha256("\0".join((header, *texts) + flags).encode()).hexdigest()[:16]
        d = os.path.join(K.BUILD_DIR, f"{curve.name}-bucket_blocks-{key}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "kfe_bucket_reduce.cuh"), "w") as fh:
            fh.write(header)
        so = os.path.join(d, "libbucket_reduce.so")
        cmd = [K._nvcc(), *flags, "-I", d, "-I", K.CSRC, "-o", so, src]
        jobs[size] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    out = {}
    for size, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"bucket_reduce at {size} (nvcc exit {proc.returncode}):\n{log}")
        out[size] = (so, log)
    return out


def ptxas_lines(log: str) -> list:
    """ptxas's registers and spill lines, one pair a kernel instance."""
    return [ln.split(":", 1)[1].strip() if "registers" in ln else ln.strip()
            for ln in log.splitlines()
            if ("Used" in ln and "registers" in ln) or "stack frame" in ln]


def _buckets(curve, windows: int, dev) -> torch.Tensor:
    """[3, n, windows, NBUCK] steady points, 64 distinct k*G tiled."""
    rng = np.random.default_rng(windows)
    pts = [H.aff_mul(curve, int(k), H.aff_generator(curve)) for k in rng.integers(1, 2**62, 64)]
    pts = pts * (windows * NBUCK // 64)
    Q = P.from_affine_ints(curve, [p[0] for p in pts], [p[1] for p in pts], dev)
    limbs = P.point_limbs(P.steady(Q))
    return limbs.reshape(3, curve.field.n_limbs, windows, NBUCK)


def main(argv=None) -> dict:
    """Returns {block size: {"ptxas": [...], "ms": {windows: median ms}}},
    ms the median over the rounds of the mean of REPS calls."""
    if not torch.cuda.is_available():
        raise SystemExit("bench_bucket_blocks: no CUDA device")
    dev = torch.device("cuda")
    curve = get_curve("secp256k1")
    built = build(curve)
    print(f"device: {device_label(dev)}; bucket_reduce, nbuck = {NBUCK}, windows {WINDOWS}, "
          f"block sizes {SIZES}, {ROUNDS} rounds in turns", flush=True)
    fns = {}
    for size, (so, _) in built.items():
        fn = getattr(ctypes.CDLL(so), "bucket_reduce_launch")
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fns[size] = fn
    n = curve.field.n_limbs
    ms = {size: {g: [] for g in WINDOWS} for size in SIZES}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for g in WINDOWS:
        b32 = K._u32(_buckets(curve, g, dev))
        want = _canonical(curve, K.bucket_reduce_plain(curve, b32, False))
        out = torch.empty((3, n, g), dtype=torch.int32, device=dev)
        buf = torch.empty((2, 3 * kfe.FE32_N, g * NBUCK), dtype=torch.int32, device=dev)

        def run(size):
            made = ctypes.c_int(0)
            err = fns[size](b32.data_ptr(), out.data_ptr(), buf.data_ptr(), NBUCK, g, 0,
                            ctypes.byref(made), torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"bucket_reduce at {size}: cudaError {err}")

        for size in SIZES:
            run(size)
            torch.cuda.synchronize(dev)
            if not torch.equal(_canonical(curve, out), want):
                raise AssertionError(f"bucket_reduce at {size} differs from its twin mod p")
        for r in range(ROUNDS):
            for size in (SIZES if r % 2 == 0 else SIZES[::-1]):
                start.record()
                for _ in range(REPS):
                    run(size)
                end.record()
                torch.cuda.synchronize(dev)
                ms[size][g].append(start.elapsed_time(end) / REPS)
    result = {}
    for size in SIZES:
        lines = ptxas_lines(built[size][1])
        med = {g: float(np.median(v)) for g, v in ms[size].items()}
        result[size] = {"ptxas": lines, "ms": med}
        print(f"  {size} threads a block: equal mod p to bucket_reduce_plain; ptxas "
              f"{' | '.join(lines)}; median ms " + ", ".join(
                  f"{g} windows {m:.4f} (rounds {[round(x, 4) for x in ms[size][g]]})"
                  for g, m in med.items()), flush=True)
    return result


if __name__ == "__main__":
    main()
