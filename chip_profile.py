"""Where the time of tpu_ecc_torch's batched verify and sign goes, on one
NVIDIA card.

    python3 chip_profile.py [curve]      # secp256k1 (default) or p256

Builds the kernels, makes the 8192 signatures of chip_smoke.py and 8192
(d, z) from a seed, then for each of verify and sign times (the timings of
both before the first profile, since a profiler run can leave overhead
behind in the process):

- `verify_batch` / `sign_batch` end to end, 7 runs and their median (host
  clock, closed by the results it returns);
- the device core alone on one packed chunk (host clock around a
  synchronised call), so the rest is host packing, nonces and the pipeline;
- one chunk of the core under torch.profiler: device busy time (the sum of
  kernel times), the number of kernel launches, the hand-written kernels'
  share, and the kernels by device time.

Prints one JSON line last. Needs a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from chip_smoke import signatures, smi

SIGS = 8192
RUNS = 7


def _wall(fn) -> list:
    walls = []
    for _ in range(RUNS):
        t = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t)
    return walls


def _core_times(core, buf: torch.Tensor) -> list:
    """Seconds of 3 synchronised calls of core(buf) (one chunk)."""
    torch.cuda.synchronize()
    cores = []
    for _ in range(3):
        t = time.perf_counter()
        core(buf)
        torch.cuda.synchronize()
        cores.append(time.perf_counter() - t)
    return cores


def profile_core(label: str, core, buf: torch.Tensor, walls: list, cores: list) -> dict:
    """Profile one call of `core(buf)` (one chunk); print and return the
    breakdown beside the end-to-end `walls` of SIGS items and the core's
    own times `cores`."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_ecc_torch.ops import kernels as K

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        core(buf)
        torch.cuda.synchronize()
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    # device-side events only: the operator events that launched them carry
    # the same time again
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in kern)
    launches = sum(e.count for e in kern)
    top = sorted(kern, key=dev_us, reverse=True)[:12]
    ours = {}                         # ms by hand-written kernel
    for e in kern:
        name = e.key.removeprefix("void ").split("(")[0].split("<")[0].removesuffix("_kernel")
        if name in K.KERNELS:
            ours[name] = ours.get(name, 0.0) + dev_us(e) / 1e3
    chunk = buf.shape[-1]
    wall = float(np.median(walls))
    print(f"{label}: {SIGS} items, chunk {chunk}: median {wall:.4f} s "
          f"({SIGS / wall:.1f}/s), runs {[round(w, 4) for w in walls]}")
    print(f"  device core, one chunk: best {min(cores):.4f} s, runs "
          f"{[round(c, 4) for c in cores]}")
    print(f"  profiled chunk: device busy {busy_us / 1e3:.3f} ms over {launches} kernel "
          f"launches; busy share {busy_us / 1e6 / min(cores):.4f} of the best core time")
    print(f"  hand-written kernels: {sum(ours.values()):.3f} ms {ours}")
    for e in top:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    return {"items": SIGS, "chunk": chunk, "s_median": wall, "s_runs": walls,
            "per_s": SIGS / wall, "core_chunk_s": min(cores),
            "device_busy_ms": busy_us / 1e3, "kernel_launches": launches,
            "handwritten_ms": ours,
            "top": [{"name": e.key, "ms": dev_us(e) / 1e3, "count": e.count} for e in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    from tpu_ecc_torch import native
    from tpu_ecc_torch.curves.specs import get_curve
    from tpu_ecc_torch.ops import fe as F
    from tpu_ecc_torch.ops import kernels as K
    from tpu_ecc_torch.protocols import ecdsa as E
    from tpu_ecc_torch.protocols import rfc6979

    curve = get_curve(sys.argv[1] if len(sys.argv) > 1 else "secp256k1")
    low_s = curve.name in E.LOW_S_CURVES
    f, s = curve.field, curve.scalar
    n = E.DEFAULT_CHUNK
    K.build(curve, ["pow", "ladder", "genmul"])
    native.build()
    print(f"card: {smi('name,power.limit')}; curve: {curve.name}")

    pubs, zs, sigs, expect = signatures(curve, SIGS, 256, 5, low_s)
    if E.verify_batch(curve, pubs, zs, sigs) != expect:
        raise AssertionError("verify_batch disagrees with the expected booleans")
    v_walls = _wall(lambda: E.verify_batch(curve, pubs, zs, sigs))
    buf = np.concatenate([
        F.words_from_ints([p[0] for p in pubs[:n]], f.bits),
        F.words_from_ints([p[1] for p in pubs[:n]], f.bits),
        F.words_from_ints([z % curve.n for z in zs[:n]], s.bits),
        F.words_from_ints([r for r, _ in sigs[:n]], s.bits),
        F.words_from_ints([v for _, v in sigs[:n]], s.bits),
        np.array([r + curve.n < curve.p for r, _ in sigs[:n]], np.uint32)[None],
    ], axis=0)
    v_buf = torch.from_numpy(buf.astype(np.int64)).cuda()
    v_core = lambda b: E._verify_core(curve, b)                        # noqa: E731
    v_cores = _core_times(v_core, v_buf)

    rng = np.random.default_rng(6)
    ds = [int.from_bytes(rng.bytes(32), "big") % (curve.n - 1) + 1 for _ in range(SIGS)]
    zs = [int.from_bytes(rng.bytes(32), "big") % curve.n for _ in range(SIGS)]
    E.sign_batch(curve, ds, zs)
    s_walls = _wall(lambda: E.sign_batch(curve, ds, zs))
    ks = rfc6979.generate_k_batch(curve.n, ds[:n], [z.to_bytes(32, "big") for z in zs[:n]])
    buf = np.concatenate([F.words_from_ints(v, s.bits) for v in (ks, zs[:n], ds[:n])], 0)
    s_buf = torch.from_numpy(buf.astype(np.int64)).cuda()
    s_core = lambda b: E._sign_core(curve, low_s, b)                   # noqa: E731
    s_cores = _core_times(s_core, s_buf)

    verify = profile_core("verify_batch", v_core, v_buf, v_walls, v_cores)
    sign = profile_core("sign_batch", s_core, s_buf, s_walls, s_cores)
    print(json.dumps({"verify": verify, "sign": sign}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
