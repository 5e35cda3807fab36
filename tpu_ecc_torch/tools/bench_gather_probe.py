"""Measure the MSM payload-gather floor: the library row gather against a
kernel that fetches every row with an asynchronous copy of its own.

The port of the JAX repo's tools/bench_gather_probe.py. Two probes:

1. `bench_take`: 8 dependent `torch.index_select` row gathers of M = N rows
   at row widths W = 32, 40, 64 and 128 words (the counterpart of the JAX
   tool's `jnp.take` chain) — is the library gather bound by rows or by
   bytes? If by bytes, a payload row of 2 coordinates instead of 3 gathers
   a third faster.
2. `bench_dma_gather`: the `dma_gather` kernel (ops/kernels.py,
   csrc/dma_gather.cu), timed over a chain of 8 dependent calls as the
   index_select chain is, at W = 128 and depth 2, 8 and 16: one
   `cp.async.bulk` copy per row, `depth` in flight in each warp's ring,
   the rows XORed together, over chunks of Cb = 4096 indices; then at
   depth 8 with Cb = 1024 and 256. Its rate is the ceiling of a gather
   fused into segscan: below the library's rows/s, fusing the gather
   cannot beat sort -> gather -> segscan. The TPU tool's Cb = 4096 made
   64 steps of a sequential grid. On the card Cb decides only how a chunk
   splits: into runs of at most kernels.GATHER_ROWS rows, one a warp, so
   the card holds the same warps, and copies in flight, at every Cb (at M
   = 2^18 and 32 rows a run, 8192 warps); the smaller chunks show that
   the rate no longer follows Cb.

    python3 -m tpu_ecc_torch.tools.bench_gather_probe [rows] [--device cpu]

`rows` is N, the payload's rows (default 2^20); the kernel gathers N / 4.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..ops import kernels as K
from . import device_label, parse, sync

REP = 8          # dependent gathers per timed chain
CB = 1 << 12     # indices per chunk of the kernel


def device_payload(N: int, W: int, device) -> torch.Tensor:
    """The payload int32 [N, W] with the uint32 words (r * 2654435761) XOR
    (c * 40503) mod 2^32, made on the device in int64."""
    r = torch.arange(N, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(W, dtype=torch.int64, device=device)[None, :]
    return (((r * 2654435761) ^ (c * 40503)) & 0xFFFFFFFF).to(torch.int32)


def _indices(rng, N: int, M: int, device) -> list:
    return [torch.from_numpy(rng.permutation(N).astype(np.int32)[:M]).to(device)
            for _ in range(2)]


def _top_bit(word: torch.Tensor) -> torch.Tensor:
    """The uint32 word's bit 31 (the words are int32 carrying uint32 bits)."""
    return (word >> 31) & 1


def bench_take(N: int = 1 << 20, W: int = 64, M: int = 1 << 20, iters: int = 5,
               device=None) -> float:
    """Rows/s of `torch.index_select` over a chain of REP dependent gathers."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    pay = device_payload(N, W, dev)
    idxs = _indices(rng, N, M, dev)

    def take_chain(i):
        o = None
        for _ in range(REP):
            o = torch.index_select(pay, 0, i)
            i = i ^ _top_bit(o[0, 0])
        return o[0, :1]

    take_chain(idxs[0])
    sync(dev)
    best = float("inf")
    for t in range(iters):
        t0 = time.perf_counter()
        take_chain(idxs[t % 2])
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    rate = REP * M / best
    print(f"index_select  W={W:4d} ({4 * W:4d}B/row): {best / REP * 1e3:8.3f} ms "
          f"-> {rate / 1e6:7.2f} Mrows/s  {rate * 4 * W / 1e9:7.1f} GB/s", flush=True)
    return rate


def bench_dma_gather(N: int = 1 << 20, W: int = 64, M: int = 1 << 18, Cb: int = CB,
                     depth: int = 8, iters: int = 5, device=None) -> float:
    """Rows/s of the `dma_gather` kernel over a chain of REP dependent
    calls, each call's indices depending on the last call's result (as
    `bench_take`'s chain of index_select), best of `iters` chains: one call
    between two synchronizes would time the launch and the sync with it."""
    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    pay = device_payload(N, W, dev)
    idxs = _indices(rng, N, M, dev)

    def gather_chain(i):
        o = None
        for _ in range(REP):
            o = K.dma_gather(pay, i, Cb, depth)
            i = i ^ _top_bit(o[0, 0])
        return o[0, :1]

    gather_chain(idxs[0])
    sync(dev)
    best = float("inf")
    for t in range(iters):
        t0 = time.perf_counter()
        gather_chain(idxs[t % 2])
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    rate = REP * M / best
    print(f"dma_gather    W={W:4d} depth={depth:2d} Cb={Cb:4d}: {best / REP * 1e3:8.3f} ms "
          f"a call ({M} rows, a chain of {REP} calls) -> {rate / 1e6:7.2f} Mrows/s  "
          f"{rate * 4 * W / 1e9:7.1f} GB/s", flush=True)
    return rate


def main(argv=None) -> dict:
    """Both probes at the JAX tool's sizes (N = 2^20 by default). Returns
    {"take": {W: rows/s}, "dma_gather": {depth: rows/s} at Cb = 4096,
    "dma_gather_cb": {Cb: rows/s} at depth 8}."""
    N, dev = parse(argv, __doc__, "payload rows N (default 2^20)", 1 << 20)
    print(f"device: {device_label(dev)}  N={N}", flush=True)
    take = {W: bench_take(N, W, N, device=dev) for W in (32, 40, 64, 128)}
    M = N // 4
    dma = {depth: bench_dma_gather(N, 128, M, min(CB, M), depth, device=dev)
           for depth in (2, 8, 16)}
    by_cb = {Cb: bench_dma_gather(N, 128, M, min(Cb, M), 8, device=dev) for Cb in (1024, 256)}
    return {"take": take, "dma_gather": dma, "dma_gather_cb": by_cb}


if __name__ == "__main__":
    main()
