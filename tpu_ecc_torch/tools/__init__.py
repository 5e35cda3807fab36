"""The port's probe tools, the counterparts of the JAX repo's tools/ of the
same names: `bench_gather_probe`, `bench_mxu_mul` and `profile_ladder`. Each
runs as

    python3 -m tpu_ecc_torch.tools.<name> [batch] [--device cpu]

on the card unless `--device cpu` is given (the kernels' plain twins; a CPU
time says nothing of the card). Each prints its measurements and its `main`
returns them. `bench_imad_wide`, `bench_ladder_forms`, `bench_blocks` and
`bench_point_ops`, the port's own, run on the card only: the first
measures the IMAD.WIDE.U32 rate that the 32-bit layer's bound assumes, the
second the ladder kernel's launch forms (csrc/ladder.cu builds each
field's in the form it found fastest), the third the block sizes of
bucket_reduce, pow, fixup and ladder_probe, dma_gather's warps a block and
rows a warp, and the ptxas levels of the point-add and field-multiply
chains, the fourth the device time of padd, pdouble, fmul_chain and
mxu_chain against another checkout's. `devtime.device_ms` reads a
kernel's device time for the last two and for `chip_smoke.py`.
"""

from __future__ import annotations

import argparse
import time

import torch

from .. import resolve_device


def parse(argv, doc: str, batch_help: str, default: int):
    """(batch, device) from argv: an optional positional batch and
    --device (default: the card)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=default, help=batch_help)
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    return args.batch, resolve_device(args.device)


def device_label(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def best_seconds(fn, dev: torch.device, iters: int, rounds: int) -> float:
    """The best over `rounds` of the mean seconds per call of `iters` calls
    of fn(), each round closed by a synchronize, after one warm-up call."""
    fn()
    sync(dev)
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync(dev)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best

