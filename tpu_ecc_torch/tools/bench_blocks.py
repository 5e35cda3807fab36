"""Block sizes of the kernels that take theirs from a macro: registers,
spills and time on the card.

csrc/bucket_reduce.cu, csrc/pow.cu and csrc/fixup.cu take their threads a
block from BUCKET_THREADS, POW_THREADS and FIXUP_THREADS, which their
__launch_bounds__ follow (and pow's table stride). This builds each named
kernel at each size in SIZES (nvcc -D<macro>=k, one process each, all
started together), prints ptxas's registers and spills for each, holds each
against its plain twin by canonical values mod p at the main path's shapes,
and times them in turns through the kernel's wrapper (ROUNDS rounds, the
order reversed in every other):

    bucket_reduce  secp256k1, nbuck = 8192, 8 and 3 windows
    pow            secp256k1 and P-256, each field, e = p - 2, B = 4096
    fixup          secp256k1, 8 and 3 windows of 8192 lanes, keys as the
                   MSM's 2^20 points sort them (C = 128 rows a lane)

For fixup it then times, at the size the source builds by default, the C
entry alone (inputs converted and the scratch allocated once) against the
wrapper (its int32 conversions and allocations included), each by CUDA
events around back-to-back calls and by torch.profiler's device time of
the calls' launches.

    python3 -m tpu_ecc_torch.tools.bench_blocks [bucket_reduce] [pow] [fixup]
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np
import torch

from ..curves.specs import get_curve
from ..ops import fe as F
from ..ops import kernels as K
from ..ops import kfe
from ..ops import points as P
from ..utils import ec_host as H
from . import device_label

MACROS = {"bucket_reduce": "BUCKET_THREADS", "pow": "POW_THREADS", "fixup": "FIXUP_THREADS"}
SIZES = (32, 64, 128)
NBUCK, WINDOWS, LANES, ROWS = 8192, (8, 3), 8192, 128
POW_B = 4096
ROUNDS, REPS = 8, 5          # rounds in turns; calls a timing


def build(targets) -> dict:
    """{(kernel, curve name, block size): (library path, nvcc's report)}
    for targets = [(kernel, curve)], each at every size, built under
    kernels.BUILD_DIR and named by a hash of the sources, the header, the
    flags and the size."""
    jobs = {}
    for name, curve in targets:
        src_file = K.KERNELS[name][0]
        texts = []
        for f in [src_file] + K.includes(src_file):
            with open(os.path.join(K.CSRC, f)) as fh:
                texts.append(fh.read())
        header = K._header(name, curve)
        for size in SIZES:
            flags = (*K.NVCC_FLAGS, f"-D{MACROS[name]}={size}")
            key = hashlib.sha256("\0".join((header, *texts) + flags).encode()).hexdigest()[:16]
            d = os.path.join(K.BUILD_DIR, f"{curve.name}-{name}-blocks-{key}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, f"kfe_{name}.cuh"), "w") as fh:
                fh.write(header)
            so = os.path.join(d, f"lib{name}.so")
            cmd = [K._nvcc(), *flags, "-I", d, "-I", K.CSRC, "-o", so,
                   os.path.join(K.CSRC, src_file)]
            jobs[name, curve.name, size] = (so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for key, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{key} (nvcc exit {proc.returncode}):\n{log}")
        out[key] = (so, log)
    return out


def ptxas_lines(log: str) -> list:
    """ptxas's registers and spill lines, one pair a kernel instance."""
    return [ln.split(":", 1)[1].strip() if "registers" in ln else ln.strip()
            for ln in log.splitlines()
            if ("Used" in ln and "registers" in ln) or "stack frame" in ln]


def _entry(so: str, name: str):
    fn = getattr(ctypes.CDLL(so), K.KERNELS[name][2])
    fn.argtypes = [*K.KERNELS[name][3], ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _canonical(spec, limbs: torch.Tensor) -> torch.Tensor:
    """Each element's canonical limbs; limbs [.., n, ..] with the limb axis
    first for an element, second for a point [3, n, ..]."""
    if limbs.shape[0] == 3 and limbs.shape[1] == spec.n_limbs:
        return torch.stack([_canonical(spec, limbs[c]) for c in range(3)], 0)
    return F.fcanonical(F.fe_steady(spec, limbs.to(torch.int64))).limbs


def _points(curve, count: int, dev, seed: int) -> torch.Tensor:
    """[3, n, count] steady points, 64 distinct k*G tiled."""
    rng = np.random.default_rng(seed)
    pts = [H.aff_mul(curve, int(k), H.aff_generator(curve)) for k in rng.integers(1, 2**62, 64)]
    pts = pts * (count // 64)
    Q = P.from_affine_ints(curve, [p[0] for p in pts], [p[1] for p in pts], dev)
    return P.point_limbs(P.steady(Q))


def _fixup_inputs(curve, windows: int, dev):
    """(t_l, last_key, first_key, lead) of `windows` windows of LANES lanes,
    int32: per window LANES * ROWS keys in [0, NBUCK] sorted, lane l
    holding rows [l ROWS, (l + 1) ROWS), as msm.sorted_windows lays out the
    2^20 points of a window (signed w = 14: 8193 keys)."""
    g = torch.Generator(device=dev).manual_seed(windows)
    keys = torch.sort(torch.randint(0, NBUCK + 1, (windows, LANES * ROWS), device=dev,
                                    generator=g), dim=-1)[0].to(torch.int32)
    keys = keys.reshape(windows, LANES, ROWS)
    n = curve.field.n_limbs
    t_l = _points(curve, windows * LANES, dev, windows).reshape(3, n, windows, LANES)
    lead = _points(curve, windows * LANES, dev, windows + 10).reshape(3, n, windows, LANES)
    return (t_l.to(torch.int32).contiguous(), keys[..., -1].contiguous(),
            keys[..., 0].contiguous(), lead.to(torch.int32).contiguous())


def cases(names, dev) -> list:
    """(kernel, curve, label, run(), the twin's canonical values, spec)."""
    out = []
    k256, p256 = get_curve("secp256k1"), get_curve("p256")
    if "bucket_reduce" in names:
        for g in WINDOWS:
            b32 = K._u32(_points(k256, g * NBUCK, dev, g).reshape(3, -1, g, NBUCK))
            out.append(("bucket_reduce", k256, f"{g} windows",
                        lambda b32=b32: K.bucket_reduce(k256, b32, False),
                        _canonical(k256.field, K.bucket_reduce_plain(k256, b32, False)),
                        k256.field))
    if "pow" in names:
        rng = np.random.default_rng(3)
        for c in (k256, p256):
            for spec in (c.scalar, c.field):
                xs = [int.from_bytes(rng.bytes(32), "big") % spec.p for _ in range(POW_B)]
                x = F.fsteady(F.fe_from_ints(spec, xs, dev)).limbs
                e = spec.p - 2
                out.append(("pow", c, spec.name, lambda spec=spec, x=x, e=e: K.fpow(spec, x, e),
                            _canonical(spec, K.fpow_plain(spec, x, e)), spec))
    if "fixup" in names:
        for g in WINDOWS:
            args = _fixup_inputs(k256, g, dev)
            out.append(("fixup", k256, f"{g} windows",
                        lambda args=args: K.fixup(k256, *args),
                        _canonical(k256.field, K.fixup_plain(k256, *args)), k256.field))
    return out


def _events_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profiled_ms(fn, reps: int) -> float:
    """Device ms a call of fn() by torch.profiler: the self device time of
    the fixup kernels over `reps` calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if "fixup_" in e.key:
            us += next((getattr(e, a) for a in ("self_device_time_total", "self_cuda_time_total")
                        if hasattr(e, a)), 0)
    return us / 1e3 / reps


def fixup_alone(so: str, dev) -> dict:
    """fixup's C entry alone against its wrapper at 8 and 3 windows: ms a
    call by CUDA events and by the profiler's device time, each the median
    of ROUNDS rounds in turns."""
    k256 = get_curve("secp256k1")
    entry = _entry(so, "fixup")
    K._bound["fixup", k256.name] = entry
    out = {}
    for g in WINDOWS:
        t_l, lk, fk, lead = _fixup_inputs(k256, g, dev)
        n = k256.field.n_limbs
        res = torch.empty((3, n, g, LANES), dtype=torch.int32, device=dev)
        buf = torch.empty((2, 3 * kfe.FE32_N, g * LANES), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def alone():
            made = ctypes.c_int(0)
            err = entry(t_l.data_ptr(), lk.data_ptr(), fk.data_ptr(), lead.data_ptr(),
                        res.data_ptr(), buf.data_ptr(), LANES, g * LANES, ctypes.byref(made),
                        stream)
            if err:
                raise RuntimeError(f"fixup: cudaError {err}")

        fns = {"alone": alone, "wrapper": lambda: K.fixup(k256, t_l, lk, fk, lead)}
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        if not torch.equal(_canonical(k256.field, res), _canonical(k256.field, fns["wrapper"]())):
            raise AssertionError("fixup's C entry differs from its wrapper")
        got = {(w, m): [] for w in fns for m in ("events", "profiler")}
        for r in range(ROUNDS):
            for w in (sorted(fns) if r % 2 == 0 else sorted(fns, reverse=True)):
                got[w, "events"].append(_events_ms(fns[w], REPS))
                got[w, "profiler"].append(_profiled_ms(fns[w], REPS))
        out[g] = {f"{w} {m}": float(np.median(v)) for (w, m), v in got.items()}
        print(f"  fixup at {g} windows, ms a call (median of {ROUNDS} rounds in turns): "
              + ", ".join(f"{k} {v:.4f}" for k, v in out[g].items()), flush=True)
    return out


def main(argv=None) -> dict:
    """Returns {kernel: {block size: {"ptxas": [...], "ms": {label: median
    ms}}}}, ms the median over the rounds of the mean of REPS calls, and
    under "fixup_alone" the C entry against the wrapper."""
    names = list(sys.argv[1:] if argv is None else argv) or list(MACROS)
    if any(n not in MACROS for n in names):
        raise SystemExit(f"bench_blocks: kernels are {list(MACROS)}")
    if not torch.cuda.is_available():
        raise SystemExit("bench_blocks: no CUDA device")
    dev = torch.device("cuda")
    todo = cases(names, dev)
    built = build(sorted({(k, c.name): (k, c) for k, c, *_ in todo}.values(),
                         key=lambda t: (t[0], t[1].name)))
    print(f"device: {device_label(dev)}; block sizes {SIZES}, {ROUNDS} rounds in turns, "
          f"{REPS} calls a timing", flush=True)
    entries = {key: _entry(so, key[0]) for key, (so, _) in built.items()}
    result = {}
    for name, curve, label, run, want, spec in todo:
        ms = {size: [] for size in SIZES}
        for size in SIZES:
            K._bound[name, curve.name] = entries[name, curve.name, size]
            got = run()
            torch.cuda.synchronize()
            if not torch.equal(_canonical(spec, got), want):
                raise AssertionError(f"{name} {label} at {size} differs from its twin mod p")
        for r in range(ROUNDS):
            for size in (SIZES if r % 2 == 0 else SIZES[::-1]):
                K._bound[name, curve.name] = entries[name, curve.name, size]
                ms[size].append(_events_ms(run, REPS))
        row = result.setdefault(name, {})
        for size in SIZES:
            lines = ptxas_lines(built[name, curve.name, size][1])
            row.setdefault(size, {"ptxas": lines, "ms": {}})["ms"][label] = float(
                np.median(ms[size]))
        print(f"  {name} [{label}]: each size equal mod p to its twin; median ms "
              + ", ".join(f"{s} threads {np.median(v):.4f}" for s, v in ms.items()), flush=True)
        del K._bound[name, curve.name]
    for name, row in result.items():
        for size, r in row.items():
            print(f"  {name} at {size} threads: ptxas {' | '.join(r['ptxas'])}", flush=True)
    if "fixup" in names:
        result["fixup_alone"] = fixup_alone(
            built["fixup", "secp256k1", K.FIXUP_LANES][0], dev)
        del K._bound["fixup", "secp256k1"]
    return result


if __name__ == "__main__":
    main()
