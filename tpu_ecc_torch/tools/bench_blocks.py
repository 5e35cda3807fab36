"""Block sizes of the kernels that take theirs from a macro, and the ptxas
level of the point-add chain, of the generic-a curves' ladder, of the
segmented scan and of the field-multiply chain: registers, spills and
time on the card.

csrc/bucket_reduce.cu, csrc/pow.cu, csrc/fixup.cu and csrc/ladder_probe.cu
take their threads a block from BUCKET_THREADS, POW_THREADS, FIXUP_THREADS
and PROBE_THREADS, which their __launch_bounds__ follow (and pow's and
ladder_probe's table stride); csrc/dma_gather.cu its warps a block and the
most rows a warp gathers from GATHER_WARPS and GATHER_ROWS;
and csrc/fmul_chain.cu its threads from FMUL_THREADS.
This builds each named kernel in each of its forms (`forms`: 32, 64 and
128 threads; for dma_gather 4, 8 and 16 warps by 32, 64 and 128 rows,
nvcc -D<macro>=k; for padd_chain, whose source is also `padd`'s, for
ladder and for segscan, ptxas -O3 and -O1; for fmul_chain 32, 64 and 128 threads each at ptxas -O3 and
-O1; one process each, all started together), prints ptxas's
registers and spills for each, holds each against its plain twin (by
canonical values mod p; dma_gather exactly) at the main path's or the
tool's shapes, and times them in turns through the kernel's wrapper
(ROUNDS rounds, the order reversed in every other), by CUDA events and
by torch.profiler's device time of the kernel's launches:

    bucket_reduce  secp256k1, nbuck = 8192, 8 and 3 windows
    pow            secp256k1 and P-256, each field, e = p - 2, B = 4096
    fixup          secp256k1, 8 and 3 windows of 8192 lanes, keys as the
                   MSM's 2^20 points sort them (C = 128 rows a lane)
    ladder_probe   secp256k1, the five variants, B = 4096, 34 windows
                   (profile_ladder's inputs)
    dma_gather     N = 2^20, W = 128, M = 2^18 (bench_gather_probe's
                   payload), Cb = 4096 at depth 8, 2 and 16, Cb = 256 at 8
    padd_chain     the five N = 8 curves (secp256k1, P-256, bp256t1, SM2,
                   bign256), B = 8192, repeat 16 (the headline) and repeat
                   1 (the launch of padd_points)
    ladder         the generic-a curves bp256r1 and bp384r1, the verify's
                   T = 2 without GLV on all the scalar's windows, B = 256
                   (a core call of their smoke's ECDSA) and 4096
    fmul_chain     secp256k1's field, P-256's and k256mxu.fp (secp256k1's p
                   forced onto Montgomery), B = 8192 (bench_mxu_mul's)
    segscan        the N = 8 curves with a != 0 (P-256, SM2, bign256,
                   bp256t1, bp256r1) and secp256k1, signed digits at the
                   shape msm() gives 2^14 points (19 windows of 4096
                   lanes side by side, C = 4 rows a lane); each form held
                   by canonical coordinates of the lanes' tail and lead

For fixup it then times, at the size the source builds by default, the C
entry alone (inputs converted and the scratch allocated once) against the
wrapper (its int32 conversions and allocations included), each by CUDA
events around back-to-back calls and by torch.profiler's device time of
the calls' launches.

    python3 -m tpu_ecc_torch.tools.bench_blocks [bucket_reduce] [pow] [fixup]
        [ladder_probe] [dma_gather] [padd_chain] [ladder] [fmul_chain] [segscan]
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
from ..ops import scalarmul as SM
from ..utils import ec_host as H
from . import bench_gather_probe, device_label, profile_ladder
from .devtime import device_ms

MACROS = {"bucket_reduce": "BUCKET_THREADS", "pow": "POW_THREADS", "fixup": "FIXUP_THREADS",
          "ladder_probe": "PROBE_THREADS"}
SIZES = (32, 64, 128)
GATHER_WARPS, GATHER_ROWS = (4, 8, 16), (32, 64, 128)
PTXAS_LEVELS = ("-O3", "-O1")
SWEPT = (*MACROS, "dma_gather", "padd_chain", "ladder", "fmul_chain", "segscan")
SEGSCAN_CURVES = ("p256", "sm2", "bign256", "bp256t1", "bp256r1", "secp256k1")
SEGSCAN_POINTS, SEGSCAN_LANES = 1 << 14, 4096      # msm()'s Pippenger at its smallest
CHAIN_B = 8192
NBUCK, WINDOWS, LANES, ROWS = 8192, (8, 3), 8192, 128
POW_B, LADDER_B = 4096, 4096
GATHER_N, GATHER_W, GATHER_M = 1 << 20, 128, 1 << 18
GATHER_SHAPES = ((4096, 8), (4096, 2), (4096, 16), (256, 8))     # (Cb, depth)
ROUNDS, REPS = 8, 5          # rounds in turns; calls a timing


def forms(name: str) -> list:
    """(label, nvcc flags) of each build of kernel `name`."""
    if name == "dma_gather":
        return [(f"{w} warps x {r} rows", (f"-DGATHER_WARPS={w}", f"-DGATHER_ROWS={r}"))
                for w in GATHER_WARPS for r in GATHER_ROWS]
    if name in ("padd_chain", "ladder", "segscan"):
        return [(f"ptxas {lv}", ("-Xptxas", lv)) for lv in PTXAS_LEVELS]
    if name == "fmul_chain":
        return [(f"{k} threads, ptxas {lv}", (f"-DFMUL_THREADS={k}", "-Xptxas", lv))
                for k in SIZES for lv in PTXAS_LEVELS]
    return [(f"{k} threads", (f"-D{MACROS[name]}={k}",)) for k in SIZES]


def build(targets) -> dict:
    """{(kernel, target name, form label): (library path, nvcc's report)}
    for targets = [(kernel, curve or None)], each in every form, built
    under kernels.BUILD_DIR and named by a hash of the sources, the header,
    the flags and the form."""
    jobs = {}
    for name, curve in targets:
        src_file = K.KERNELS[name][0]
        texts = []
        for f in [src_file] + K.includes(src_file):
            with open(os.path.join(K.CSRC, f)) as fh:
                texts.append(fh.read())
        header = K._header(name, curve)
        tname = K.target_name(curve)
        for label, extra in forms(name):
            flags = (*K.NVCC_FLAGS, *extra)
            key = hashlib.sha256("\0".join((header, *texts) + flags).encode()).hexdigest()[:16]
            d = os.path.join(K.BUILD_DIR, f"{tname}-{name}-blocks-{key}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, f"kfe_{os.path.splitext(src_file)[0]}.cuh"), "w") as fh:
                fh.write(header)
            so = os.path.join(d, f"lib{name}.so")
            cmd = [K._nvcc(), *flags, "-I", d, "-I", K.CSRC, "-o", so,
                   os.path.join(K.CSRC, src_file)]
            jobs[name, tname, label] = (so, subprocess.Popen(
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
    fn = getattr(ctypes.CDLL(so), K.KERNELS[name][1])
    fn.argtypes = [*K.KERNELS[name][2], ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _canonical(spec, limbs: torch.Tensor) -> torch.Tensor:
    """Each element's canonical limbs; limbs [.., n, ..] with the limb axis
    first for an element, second for a point [3, n, ..]. With spec None
    (dma_gather's words) the tensor itself."""
    if spec is None:
        return limbs
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
    """(kernel, build target (a curve, a field spec or None), label, run(),
    the twin's canonical values, spec or None)."""
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
    if "ladder_probe" in names:
        bases, mag, neg = profile_ladder.inputs(k256, LADDER_B, dev)
        twins = {}       # unroll and build give bare's values
        for variant in K.PROBE_VARIANTS:
            key = variant if variant in ("select", "negate") else "bare"
            if key not in twins:
                twins[key] = _canonical(k256.field, K.ladder_probe_plain(k256, bases, mag, neg,
                                                                         key))
            out.append(("ladder_probe", k256, variant,
                        lambda v=variant: K.ladder_probe(k256, bases, mag, neg, v),
                        twins[key], k256.field))
    if "padd_chain" in names:
        for c in (k256, p256, get_curve("bp256t1"), get_curve("sm2"), get_curve("bign256")):
            a, b = _points(c, CHAIN_B, dev, 1), _points(c, CHAIN_B, dev, 2)
            for repeat in (16, 1):
                out.append(("padd_chain", c, f"{c.name} repeat {repeat}",
                            lambda c=c, a=a, b=b, r=repeat: K.padd_chain(c, a, b, r),
                            _canonical(c.field, K.padd_chain_plain(c, a, b, repeat)), c.field))
    if "ladder" in names:
        rng = np.random.default_rng(6)
        for c in (get_curve("bp256r1"), get_curve("bp384r1")):
            for b in (256, LADDER_B):
                ks = [SM.pack_scalars(c, [int.from_bytes(rng.bytes(c.scalar_bytes), "big")
                                          for _ in range(b)], dev) for _ in range(2)]
                bases, mag, neg = SM.ladder_inputs(
                    [(P.generator(c, (b,), dev), ks[0]),
                     (P.point_from_limbs(c, _points(c, b, dev, 4)), ks[1])])
                out.append(("ladder", c, f"{c.name} T=2 nw={mag.shape[0]} B={b}",
                            lambda c=c, bases=bases, mag=mag, neg=neg: K.ladder(c, bases, mag,
                                                                               neg),
                            _canonical(c.field, K.ladder_plain(c, bases, mag, neg)), c.field))
    if "fmul_chain" in names:
        rng = np.random.default_rng(5)
        for spec in (k256.field, p256.field, F.make_field_spec("k256mxu.fp", k256.p, "mont")):
            vals = [int.from_bytes(rng.bytes(32), "big") % spec.p for _ in range(CHAIN_B)]
            a = F.fe_from_ints(spec, vals, dev).limbs
            b = F.fe_from_ints(spec, vals[::-1], dev).limbs
            out.append(("fmul_chain", spec, spec.name,
                        lambda spec=spec, a=a, b=b: K.fmul_chain(spec, a, b),
                        _canonical(spec, K.fmul_chain_plain(spec, a, b)), spec))
    if "segscan" in names:
        from ..parallel import msm as M

        rng = np.random.default_rng(7)
        for c in map(get_curve, SEGSCAN_CURVES):
            pts = _points(c, SEGSCAN_POINTS, dev, 3)
            ks = [int.from_bytes(rng.bytes(c.scalar_bytes), "big") for _ in range(SEGSCAN_POINTS)]
            f = c.field
            payload, keys, negs, nbuck = M.pippenger_inputs(
                c, F.fe_steady(f, pts[0]), F.fe_steady(f, pts[1]),
                torch.zeros(SEGSCAN_POINTS, dtype=torch.bool, device=dev),
                SM.pack_scalars(c, ks, dev), 14, signed=True)
            _, key2, val2, neg2 = M.sorted_windows(payload, keys, negs, SEGSCAN_LANES)
            twin = K.segscan_plain(c, key2, val2, nbuck, neg2)
            out.append(("segscan", c, f"{c.name} C={key2.shape[0]} lanes={key2[0].numel()}",
                        lambda c=c, a=(key2, val2, nbuck, neg2): K.segscan(c, *a),
                        _canonical(f, torch.cat(twin[2:], -1)), f))
    if "dma_gather" in names:
        pay = bench_gather_probe.device_payload(GATHER_N, GATHER_W, dev)
        idx = torch.from_numpy(np.random.default_rng(1).permutation(GATHER_N)
                               .astype(np.int32)[:GATHER_M]).to(dev)
        want = K.dma_gather_plain(pay, idx)
        for Cb, depth in GATHER_SHAPES:
            out.append(("dma_gather", None, f"Cb={Cb} depth={depth}",
                        lambda Cb=Cb, depth=depth: K.dma_gather(pay, idx, Cb, depth), want, None))
    return out


def _events_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
        buf = torch.empty((2, 3 * kfe.fe32_words(k256.field), g * LANES), dtype=torch.int32,
                          device=dev)
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
                got[w, "profiler"].append(device_ms(fns[w], REPS, "fixup"))
        out[g] = {f"{w} {m}": float(np.median(v)) for (w, m), v in got.items()}
        print(f"  fixup at {g} windows, ms a call (median of {ROUNDS} rounds in turns): "
              + ", ".join(f"{k} {v:.4f}" for k, v in out[g].items()), flush=True)
    return out


def main(argv=None) -> dict:
    """Returns {kernel: {form label: {"ptxas": {target name: [...]}, "ms":
    {case label: median ms}, "device_ms": {case label: median ms}}}}, ms the median over
    the rounds of the mean of REPS calls by CUDA events, device_ms of the
    profiler's device time of a call, and under "fixup_alone" the C entry
    against the wrapper."""
    names = list(sys.argv[1:] if argv is None else argv) or list(SWEPT)
    if any(n not in SWEPT for n in names):
        raise SystemExit(f"bench_blocks: kernels are {list(SWEPT)}")
    if not torch.cuda.is_available():
        raise SystemExit("bench_blocks: no CUDA device")
    dev = torch.device("cuda")
    todo = cases(names, dev)
    built = build(sorted({(k, K.target_name(c)): (k, c) for k, c, *_ in todo}.values(),
                         key=lambda t: (t[0], K.target_name(t[1]))))
    print(f"device: {device_label(dev)}; {ROUNDS} rounds in turns, {REPS} calls a timing",
          flush=True)
    entries = {key: _entry(so, key[0]) for key, (so, _) in built.items()}
    result = {}
    for name, curve, label, run, want, spec in todo:
        tname, labels = K.target_name(curve), [f for f, _ in forms(name)]
        ms = {form: [] for form in labels}
        dev_ms = {form: [] for form in labels}
        for form in labels:
            K._bound[name, tname] = entries[name, tname, form]
            got = run()
            torch.cuda.synchronize()
            if isinstance(got, tuple):      # segscan: its lanes' tail and lead
                got = torch.cat(got[2:], -1)
            if not torch.equal(_canonical(spec, got), want):
                raise AssertionError(f"{name} {label} at {form} differs from its twin")
        for r in range(ROUNDS):
            for form in (labels if r % 2 == 0 else labels[::-1]):
                K._bound[name, tname] = entries[name, tname, form]
                ms[form].append(_events_ms(run, REPS))
                dev_ms[form].append(device_ms(run, REPS, name))
        row = result.setdefault(name, {})
        for form in labels:
            lines = ptxas_lines(built[name, tname, form][1])
            r = row.setdefault(form, {"ptxas": {}, "ms": {}, "device_ms": {}})
            r["ptxas"][tname] = lines
            r["ms"][label] = float(np.median(ms[form]))
            r["device_ms"][label] = float(np.median(dev_ms[form]))
        print(f"  {name} [{label}]: each form equal to its twin; median ms by events, "
              "by the profiler's device time: "
              + ", ".join(f"{f} {np.median(ms[f]):.4f}, {np.median(dev_ms[f]):.4f}"
                          for f in labels), flush=True)
        del K._bound[name, tname]
    for name, row in result.items():
        for form, r in row.items():
            for tname, lines in r["ptxas"].items():
                print(f"  {name} {tname} at {form}: ptxas {' | '.join(lines)}", flush=True)
    if "fixup" in names:
        result["fixup_alone"] = fixup_alone(
            built["fixup", "secp256k1", f"{K.FIXUP_LANES} threads"][0], dev)
        del K._bound["fixup", "secp256k1"]
    return result


if __name__ == "__main__":
    main()
