"""The slice's hand-written CUDA kernels: build, binding, launch counters, and
the plain PyTorch twin beside each.

| kernel       | source             | replaces (tpu_ecc/ops/pallas_kernels.py) |
|--------------|--------------------|------------------------------------------|
| `padd_chain` | csrc/padd_chain.cu | `padd_chain_call` :426                   |
| `pow`        | csrc/pow.cu        | `pow_call` :1140                         |
| `ladder`     | csrc/ladder.cu     | `ladder_call` :887                       |
| `genmul`     | csrc/genmul.cu     | `genmul_call` :1048                      |
| `segscan`    | csrc/segscan.cu    | `segscan_call` :463                      |
| `fixup`      | csrc/fixup.cu      | `fixup_call` :647                        |
| `bucket_reduce` | csrc/bucket_reduce.cu | `bucket_reduce_call` :733             |
| `horner`     | csrc/horner.cu     | `horner_call` :814                       |
| `padd`       | csrc/padd_chain.cu | `_padd_call` :379 (the chain at one add) |
| `pdouble`    | csrc/pdouble.cu    | `_pdouble_call` :403                     |

and the four kernels of the probe tools (tpu_ecc_torch/tools/), which replace
the Pallas kernels of the JAX repo's tools/:

| kernel         | source              | replaces                              |
|----------------|---------------------|---------------------------------------|
| `dma_gather`   | csrc/dma_gather.cu  | `dma_gather_call`, bench_gather_probe.py:82 |
| `fmul_chain`   | csrc/fmul_chain.cu  | the KFE 16-mul chain, bench_mxu_mul.py:118 |
| `mxu_chain`    | csrc/mxu_chain.cu   | `bench_mxu_kernel_chain`, bench_mxu_mul.py:232 |
| `ladder_probe` | csrc/ladder_probe.cu | `make(variant)`, profile_ladder.py:72 |

Each kernel but `dma_gather` runs one thread per batch lane over limb-major
[.., n, B] uint32 arrays (`mxu_chain`: a warpgroup of 128 threads per
MXU_LANES lanes). The thirteen others (FE32_KERNELS) run on the
hand-written 32-bit field layer (csrc/fe32.cuh, csrc/point32.cuh,
csrc/chain32.cuh): they convert their 13-bit rows to N words an element
on load (N the field's own, `kfe.fe32_words`: 6 for P-192 up to 17 for
P-521), keep the point or element in registers, and store canonical
13-bit limbs; their generated header holds only constants. A build
target is a curve, a bare field spec, or None (`dma_gather`, which has no
generated header: a ring of `cp.async.bulk` row copies in each warp's
shared memory, GATHER_WARPS warps a block, at most GATHER_ROWS rows a
warp). For a curve the header is `kfe.fe32_header`: the curve's
`Curve32`, with the GLV beta where the curve has an endomorphism, and its
scalar field's `Scalar32`, on which `pow` runs for field 1. Every kernel
builds for every registered curve: the layer holds the RCB formulas for
a = 0, a = -3 and a generic a (the Brainpool r1 curves, whose a is a full
multiply by a constant); `pow`, which needs the two fields alone, takes
a header of the two fields (`fe32_header(fields_only=True)`). For a bare
field (FIELD_KERNELS: the probes' `fmul_chain` and `mxu_chain`) the header is
`kfe.fe32_field_header`'s `Field32`. `ladder` and `ladder_probe` build
their tables [O, Q, .., 8Q] in shared memory (`ladder_lanes`; the probe's
one table a lane at PROBE_LANES lanes a block), `genmul` converts the
comb into shared memory once a block, `pow` keeps its table x..x^15 in
shared memory, `bucket_reduce` and `fixup` keep their points as words in
a scratch between their steps, and `mxu_chain` runs its reduction's two
constant products as byte-digit `wgmma` products (`mxu_tiles`). No
kernel builds from the 13-bit generated code (`kfe.kernel_header`), whose
counts stay the "kfe" design of the bounds. The
build is nvcc by hand into a shared library with a plain C interface, bound
with ctypes, at first use (or by `build_targets`) into build/kernels/ beside
the package; a content hash of the source, the csrc/ headers it includes,
the generated header and the flags names the library, so a changed source
or include rebuilds.

Each wrapper takes its plain twin for a CPU tensor and launches its kernel
for a CUDA tensor, on the current stream; `launches[name]` counts the
kernel launches that its C entry reports making.
The twins are plain tensor code that repeats each kernel's algorithm in
the 13-bit plan, so `dma_gather`'s output equals its twin's word for
word; for the thirteen kernels on the 32-bit layer, `pow`'s,
`fmul_chain`'s and `mxu_chain`'s element and each projective coordinate
of the others equal the twin's mod p (the same field operations in the
same order; the limb plan differs, and the kernels store canonical
values), and `segscan` writes only the run-end rows of `scanned`.

Limbs cross to the kernels as int32 tensors that carry the uint32 bits:
steady limbs are below 2^13, so the conversion from the port's int64 limbs
is exact. The four Pippenger phase kernels (segscan, fixup, bucket_reduce,
horner) take and return int32 limbs and keys on both devices: the MSM
converts its point payload to int32 once, before the window loop, and keeps
every per-window array in it. fixup and bucket_reduce launch one kernel per
scan step (the launch boundary is the barrier across all lanes), and count
each.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess

import numpy as np
import torch

from ..curves.specs import CurveSpec, get_curve
from ..utils.bigint import int_to_limbs
from . import fe as F
from . import kfe
from . import points as P

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DENSE_CHAIN_PTXAS = "-O1"
"""ptxas's optimisation level for the builds at N = 8 words that spill at
ptxas's default -O3 and not at -O1 (chip_smoke.py fails a spill at N = 8):
csrc/padd_chain.cu (the body of both `padd_chain` and `padd`, the chain at
one add) on a curve whose base field rows load by two Montgomery products
(kfe's MLOAD: the Brainpool fields, every word of p dense, N0 != 1), where
bp256t1's inlined add spills 28 B at -O3; csrc/ladder.cu on a curve with
the generic a (the Brainpool r1 curves), where bp256r1's ladder holds 168
registers and spills 32 B at -O3, and at -O1 takes 148 and none (bp384r1:
40 B against none), both as fast or faster at -O1; and csrc/segscan.cu on a
curve of 8 words with a != 0 (P-256, SM2, bign256, bp256t1, bp256r1), whose
row loop holds the running sum, the row's point and its sign's select
beside the a = -3 or generic-a add: at -O3 it takes 255 registers and
spills 16-64 B, at -O1 194-244 and none (secp256k1's, a = 0, takes 254 at
-O3 and none). Unlike the other two, segscan at -O1 runs slower than the
spilling -O3 build, by 1-4% on four of the curves and 35% on bign256
(device ms at msm()'s 2^14-point shape); the builds take -O1 all the same,
because a build at 8 words must not spill. Every other source and curve
builds at -O3, where secp256k1's chain runs 7.5% faster than at -O1
(PERF.md, tools/bench_blocks.py padd_chain, ladder and segscan)."""

_VP, _I = ctypes.c_void_p, ctypes.c_int
# name -> (source, C entry point, its argtypes before the launch count and
#          the stream, the TPU kernel it replaces);
# `padd` launches padd_chain's library at one add and counts as `padd`
KERNELS = {
    "padd": ("padd_chain.cu", "padd_chain_launch", [_VP, _VP, _VP, _I, _I],
             "tpu_ecc/ops/pallas_kernels.py:379"),
    "pdouble": ("pdouble.cu", "pdouble_launch", [_VP, _VP, _I],
                "tpu_ecc/ops/pallas_kernels.py:403"),
    "padd_chain": ("padd_chain.cu", "padd_chain_launch",
                   [_VP, _VP, _VP, _I, _I],
                   "tpu_ecc/ops/pallas_kernels.py:426"),
    "pow": ("pow.cu", "pow_launch", [_VP, _VP, _VP, _I, _I, _I],
            "tpu_ecc/ops/pallas_kernels.py:1140"),
    "ladder": ("ladder.cu", "ladder_launch",
               [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I],
               "tpu_ecc/ops/pallas_kernels.py:887"),
    "genmul": ("genmul.cu", "genmul_launch",
               [_VP, _VP, _VP, _VP, _I, _I],
               "tpu_ecc/ops/pallas_kernels.py:1048"),
    "segscan": ("segscan.cu", "segscan_launch",
                [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I],
                "tpu_ecc/ops/pallas_kernels.py:463"),
    "fixup": ("fixup.cu", "fixup_launch",
              [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I],
              "tpu_ecc/ops/pallas_kernels.py:647"),
    "bucket_reduce": ("bucket_reduce.cu", "bucket_reduce_launch",
                      [_VP, _VP, _VP, _I, _I, _I],
                      "tpu_ecc/ops/pallas_kernels.py:733"),
    "horner": ("horner.cu", "horner_launch",
               [_VP, _VP, _I, _I], "tpu_ecc/ops/pallas_kernels.py:814"),
    "dma_gather": ("dma_gather.cu", "dma_gather_launch",
                   [_VP, _VP, _VP, _I, _I, _I, _I, _I],
                   "tools/bench_gather_probe.py:82"),
    "fmul_chain": ("fmul_chain.cu", "fmul_chain_launch",
                   [_VP, _VP, _VP, _I], "tools/bench_mxu_mul.py:118"),
    "mxu_chain": ("mxu_chain.cu", "mxu_chain_launch",
                  [_VP, _VP, _VP, _VP, _I], "tools/bench_mxu_mul.py:232"),
    "ladder_probe": ("ladder_probe.cu", "ladder_probe_launch",
                     [_VP, _VP, _VP, _VP, _I, _I, _I], "tools/profile_ladder.py:72"),
}

FE32_KERNELS = ("padd", "pdouble", "padd_chain", "segscan", "ladder", "genmul", "bucket_reduce",
                "horner", "pow", "fixup", "ladder_probe", "fmul_chain", "mxu_chain")
"""The kernels on the 32-bit field layer: every kernel but dma_gather."""
FIELD_KERNELS = ("fmul_chain", "mxu_chain")
"""The kernels built per bare field spec (`kfe.fe32_field_header`)."""

TBL = 9   # signed-digit table [O, Q, .., 8Q]
SMEM_BLOCK = 232448
"""Bytes of shared memory one block may opt into on an H100 (227 KB)."""
LADDER_LANES = 32   # the most lanes a block of `ladder`
GENMUL_LANES = 32   # the lanes a block of `genmul` (csrc/genmul.cu THREADS)
POW_LANES = 32      # the lanes a block of `pow` (csrc/pow.cu POW_THREADS)
FIXUP_LANES = 128   # the lanes a block of `fixup` (csrc/fixup.cu FIXUP_THREADS)
PROBE_LANES = 64    # the lanes a block of `ladder_probe` (csrc/ladder_probe.cu PROBE_THREADS)
GATHER_WARPS = 4    # the warps a block of `dma_gather` (csrc/dma_gather.cu GATHER_WARPS)
GATHER_ROWS = 32    # the most rows a warp of `dma_gather` gathers (GATHER_ROWS)
FMUL_LANES = 64     # the lanes a block of `fmul_chain` (csrc/fmul_chain.cu FMUL_THREADS)
MXU_LANES = 64      # the lanes a block (one warpgroup) of `mxu_chain` (csrc/mxu_chain.cu)
MXU_MAX_WORDS = 12  # the widest field `mxu_chain` takes, in words (P-384's)
CHAIN = 16   # multiplies per lane in fmul_chain and mxu_chain (the tool's)
PROBE_VARIANTS = ("bare", "unroll", "build", "select", "negate")

launches = {name: 0 for name in KERNELS}
"""Launches of each kernel since the last `reset_launches()`."""

_bound: dict = {}   # (kernel, target name) -> ctypes function


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# build and binding
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                           "with the CUDA toolkit")
    return found


def target_name(target) -> str:
    """A build target's name: the curve's or the field's, "any" for None."""
    return "any" if target is None else target.name


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def includes(src_file: str) -> list:
    """The csrc/ headers that `src_file` includes, directly or through one
    another, sorted (a generated header, which is not in csrc/, is not
    among them)."""
    found, todo = set(), [src_file]
    while todo:
        with open(os.path.join(CSRC, todo.pop())) as fh:
            for inc in _INCLUDE.findall(fh.read()):
                if inc not in found and os.path.exists(os.path.join(CSRC, inc)):
                    found.add(inc)
                    todo.append(inc)
    return sorted(found)


def _header(name: str, target) -> str:
    if target is None:
        return ""
    if name in FIELD_KERNELS:
        return kfe.fe32_field_header(target)
    return kfe.fe32_header(target, fields_only=name == "pow")


def _flags(src_file: str, target) -> tuple:
    """nvcc's flags for a source and target: NVCC_FLAGS, and
    DENSE_CHAIN_PTXAS for padd_chain.cu on a curve whose base field loads
    by the Montgomery load, for ladder.cu on a curve with the generic a and
    for segscan.cu on a curve of 8 words with a != 0."""
    curve = target if isinstance(target, CurveSpec) else None
    dense = curve is not None and (
        (src_file == "padd_chain.cu" and kfe.fe32_field_constants(curve.field)["MLOAD"])
        or (src_file == "ladder.cu" and curve.strategy == "generic")
        or (src_file == "segscan.cu" and curve.strategy != "a0"
            and kfe.fe32_words(curve.field) == 8))
    return NVCC_FLAGS + (("-Xptxas", DENSE_CHAIN_PTXAS) if dense else ())


def _target(name: str, target):
    """(library path, build directory, generated header) for one kernel,
    named by its source: kernels of one source with one header share a
    library."""
    src_file = KERNELS[name][0]
    stem = os.path.splitext(src_file)[0]
    header = _header(name, target)
    texts = []
    for f in [src_file] + includes(src_file):
        with open(os.path.join(CSRC, f)) as fh:
            texts.append(fh.read())
    key = hashlib.sha256("\0".join((header, *texts) + _flags(src_file, target)).encode())
    d = os.path.join(BUILD_DIR, f"{target_name(target)}-{stem}-{key.hexdigest()[:16]}")
    return os.path.join(d, f"lib{stem}.so"), d, header


def build(curve: CurveSpec, names=None) -> dict:
    """Build the kernels `names` (default: all) for `curve` and bind them.
    Returns {name: nvcc's report} for the kernels built now (`build_targets`)."""
    names = list(KERNELS) if names is None else list(names)
    reports = build_targets([(curve, name) for name in names])
    return {name: rep for (_, name), rep in reports.items()}


def build_targets(targets, meanwhile=None, nice: int = 0) -> dict:
    """Build the kernels of targets = [(target, name), ...] (a target is a
    curve, a field spec or None, see `functions`), one nvcc process per
    (target, kernel), all started together at niceness `nice` (through
    nice(1), so that a thread may call this), calls meanwhile() (where
    given) while they run, and binds them. Returns
    {(target name, kernel name): nvcc's report} for the kernels built now
    (ptxas registers, spills); a library already built from the same
    source, header and flags is reused, and one that two kernels share
    (`padd`, `padd_chain`) is built once, reported under the first."""
    jobs, sos = {}, set()
    for target, name in targets:
        so, d, header = _target(name, target)
        if os.path.exists(so) or so in sos:
            continue
        sos.add(so)
        src_file = KERNELS[name][0]
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"kfe_{os.path.splitext(src_file)[0]}.cuh"), "w") as fh:
            fh.write(header)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_flags(src_file, target), "-I", d, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, src_file)]
        if nice:
            cmd = ["nice", "-n", str(nice), *cmd]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs[target_name(target), name] = (so, tmp, proc)
    if meanwhile is not None:
        meanwhile()
    reports, failed = {}, []
    for key, (so, tmp, proc) in jobs.items():
        reports[key], _ = proc.communicate()
        with open(f"{so}.log", "w") as fh:
            fh.write(reports[key])
        if proc.returncode != 0:
            failed.append(f"{key} (nvcc exit {proc.returncode}):\n{reports[key]}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    for target, name in targets:
        _bind(name, target)
    return reports


def _bind(name: str, target):
    key = (name, target_name(target))
    if key not in _bound:
        so, _, _ = _target(name, target)
        if not os.path.exists(so):
            build_targets([(target, name)])
        fn = getattr(ctypes.CDLL(so), KERNELS[name][1])
        fn.argtypes = [*KERNELS[name][2], ctypes.POINTER(_I), _VP]
        fn.restype = ctypes.c_int
        _bound[key] = fn
    return _bound[key]


def _launch(name: str, target, device: torch.device, *args) -> None:
    """Call a kernel's C entry on the current stream and add the kernel
    launches it reports making to `launches[name]`."""
    fn = _bind(name, target)
    stream = torch.cuda.current_stream(device).cuda_stream
    made = _I(0)
    err = fn(*args, ctypes.byref(made), stream)
    launches[name] += made.value
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int64 limbs (each < 2^32) -> contiguous int32 carrying the same bits."""
    return t.to(torch.int32).contiguous()


def _from_u32(t: torch.Tensor) -> torch.Tensor:
    return t.to(F.LIMB) & 0xFFFFFFFF


def _check(t: torch.Tensor, shape, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _check_words(t: torch.Tensor, what: str) -> None:
    """The 32-bit layer's kernels index their arrays with 32-bit offsets."""
    if t.numel() >= 1 << 32:
        raise ValueError(f"{what}: {t.numel()} words, the kernel takes below 2^32")


def _curve_of(spec: F.FieldSpec):
    """The curve a field belongs to, and 0 for its base field, 1 for its
    scalar field (the pow kernel is built per curve)."""
    name, part = spec.name.rsplit(".", 1)
    curve = get_curve(name)
    if (curve.field, curve.scalar)[part == "fn"] is not spec:
        raise ValueError(f"{spec} is not a registered curve's field")
    return curve, int(part == "fn")


# ---------------------------------------------------------------------------
# padd, pdouble: one add or one doubling per lane
# ---------------------------------------------------------------------------

def padd(curve: CurveSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b for steady point limbs a, b [3, n, B] -> steady [3, n, B]. The
    kernel, padd_chain's at one add (csrc/padd_chain.cu, on the 32-bit
    layer), returns each coordinate canonical: equal mod p to the twin's."""
    if a.device.type == "cpu":
        return padd_plain(curve, a, b)
    B = a.shape[-1]
    shape = (3, curve.field.n_limbs, B)
    _check(a, shape, "padd a")
    _check(b, shape, "padd b")
    _check_words(a, "padd a")
    a32, b32 = _u32(a), _u32(b)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    _launch("padd", curve, a.device, a32.data_ptr(), b32.data_ptr(),
            out.data_ptr(), B, 1)
    return _from_u32(out)


def padd_plain(curve: CurveSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return P.add_limbs(curve, a, b)


def pdouble(curve: CurveSpec, a: torch.Tensor) -> torch.Tensor:
    """2a for steady point limbs a [3, n, B] -> steady [3, n, B]. The
    kernel (on the 32-bit layer) returns each coordinate canonical: equal
    mod p to the twin's."""
    if a.device.type == "cpu":
        return pdouble_plain(curve, a)
    B = a.shape[-1]
    _check(a, (3, curve.field.n_limbs, B), "pdouble a")
    _check_words(a, "pdouble a")
    a32 = _u32(a)
    out = torch.empty(a32.shape, dtype=torch.int32, device=a.device)
    _launch("pdouble", curve, a.device, a32.data_ptr(), out.data_ptr(), B)
    return _from_u32(out)


def pdouble_plain(curve: CurveSpec, a: torch.Tensor) -> torch.Tensor:
    return P.point_limbs(P.steady(P.pdouble(P.point_from_limbs(curve, a))))


def padd_points(a: P.Point, b: P.Point) -> P.Point:
    """One complete add of two 1-D point batches on the `padd` kernel (its
    twin for CPU tensors): the counterpart of tpu_ecc's padd_pallas
    (pallas_kernels.py:1239). Returns steady coordinates."""
    c = a.curve
    out = padd(c, P.point_limbs(P.steady(a)), P.point_limbs(P.steady(b)))
    return P.point_from_limbs(c, out)


def pdouble_points(a: P.Point) -> P.Point:
    """One doubling of a 1-D point batch on the `pdouble` kernel: the
    counterpart of tpu_ecc's pdouble_pallas (pallas_kernels.py:1251)."""
    c = a.curve
    return P.point_from_limbs(c, pdouble(c, P.point_limbs(P.steady(a))))


# ---------------------------------------------------------------------------
# padd_chain
# ---------------------------------------------------------------------------

def padd_chain(curve: CurveSpec, a: torch.Tensor, b: torch.Tensor,
               repeat: int) -> torch.Tensor:
    """a + repeat*b for steady point limbs a, b [3, n, B], with a steady
    clamp after every add -> steady [3, n, B]. The kernel (on the 32-bit
    layer) returns each coordinate canonical: equal mod p to the twin's."""
    if a.device.type == "cpu":
        return padd_chain_plain(curve, a, b, repeat)
    B = a.shape[-1]
    shape = (3, curve.field.n_limbs, B)
    _check(a, shape, "padd_chain a")
    _check(b, shape, "padd_chain b")
    _check_words(a, "padd_chain a")
    a32, b32 = _u32(a), _u32(b)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    _launch("padd_chain", curve, a.device, a32.data_ptr(), b32.data_ptr(),
            out.data_ptr(), B, repeat)
    return _from_u32(out)


def padd_chain_plain(curve: CurveSpec, a: torch.Tensor, b: torch.Tensor,
                     repeat: int) -> torch.Tensor:
    acc = P.point_from_limbs(curve, a)
    q = P.point_from_limbs(curve, b)
    for _ in range(repeat):
        acc = P.steady(P.padd(acc, q))
    return P.point_limbs(acc)


# ---------------------------------------------------------------------------
# pow
# ---------------------------------------------------------------------------

def exponent_digits(e: int) -> list:
    """The 4-bit windows of a public exponent, MSB first."""
    ndig = -(-e.bit_length() // 4)
    return [(e >> (4 * i)) & 15 for i in reversed(range(ndig))]


@functools.lru_cache(maxsize=None)
def _digit_tensor(e: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(exponent_digits(e), dtype=torch.int32, device=device)


def fpow(spec: F.FieldSpec, x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e for steady limbs x [n, *batch] and a fixed public e >= 2 -> steady
    limbs [n, *batch] (4-bit windows MSB first; the accumulator starts at one
    and a zero digit keeps it). The kernel (on the 32-bit layer, either of
    the curve's fields, the table x..x^15 in shared memory) returns
    canonical limbs: the same element as the twin's, equal mod p. The
    kernel is built for both fields of the curve, at the curve's word
    count (every registered curve's two fields fit the layer,
    `kfe.fe32_fits`), from a header of the two fields alone."""
    if x.device.type == "cpu":
        return fpow_plain(spec, x, e)
    curve, field = _curve_of(spec)
    n = spec.n_limbs
    x2 = x.reshape(n, -1)
    B = x2.shape[1]
    _check(x2, (n, B), "pow x")
    _check_words(x2, "pow x")
    x32 = _u32(x2)
    out = torch.empty((n, B), dtype=torch.int32, device=x.device)
    digits = _digit_tensor(e, x.device)
    _launch("pow", curve, x.device, x32.data_ptr(), out.data_ptr(),
            digits.data_ptr(), digits.numel(), field, B)
    return _from_u32(out).reshape(x.shape)


def fpow_plain(spec: F.FieldSpec, x: torch.Tensor, e: int) -> torch.Tensor:
    xs = F.fe_steady(spec, x)
    tbl = [xs]                                   # tbl[k - 1] = x^k
    for _ in range(14):
        tbl.append(F.fsteady(F.fmul(tbl[-1], xs)))
    acc = F.fone(spec, xs.batch_shape, x.device)
    for dig in exponent_digits(e):
        for _ in range(4):
            acc = F.fsteady(F.fsquare(acc))
        if dig:                                  # x^(16a+0) = (x^a)^16
            acc = F.fsteady(F.fmul(acc, tbl[dig - 1]))
    return acc.limbs.expand(x.shape)


# ---------------------------------------------------------------------------
# ladder
# ---------------------------------------------------------------------------

def ladder_lanes(T: int, curve: CurveSpec) -> int:
    """Lanes a block of the `ladder` kernel takes for T bases of `curve`:
    at most LADDER_LANES, so that the lanes' tables (9 points of 3N words a
    base: 864 B at the 256-bit curves' N = 8, 3672 B at P-521's 17) fit the
    block's shared memory. Raises where one lane's do not."""
    per_lane = T * TBL * 3 * kfe.fe32_words(curve.field) * 4
    lanes = min(LADDER_LANES, SMEM_BLOCK // per_lane)
    if lanes < 1:
        raise ValueError(f"ladder: the tables of T = {T} bases take {per_lane} B a lane, "
                         f"above the {SMEM_BLOCK} B of shared memory a block can hold")
    return lanes


def ladder(curve: CurveSpec, bases: torch.Tensor, mag: torch.Tensor,
           neg: torch.Tensor, glv: bool = False) -> torch.Tensor:
    """Signed-digit Straus ladder: bases [T, 3, n, B] steady limbs, digit
    magnitudes mag [nw, H, B] in [0, 8] and sign masks neg [nw, H, B], MSB
    window first -> steady [3, n, B] limbs of sum_h d_h * P_h.

    H = T, or H = 2T with `glv`: term 2t takes base t, term 2t+1 takes
    psi(base t) = (beta*x, y), applied after the select. With H == 1 the
    first window seeds the accumulator from its selected entry. The kernel
    (on the 32-bit layer, its tables in shared memory: `ladder_lanes`
    raises for a T whose one-lane tables do not fit) returns each
    coordinate canonical: equal mod p to the twin's."""
    if glv and not curve.glv:
        raise ValueError(f"{curve.name} has no endomorphism")
    if bases.device.type == "cpu":
        return ladder_plain(curve, bases, mag, neg, glv)
    T, B = bases.shape[0], bases.shape[-1]
    lanes = ladder_lanes(T, curve)
    nw = mag.shape[0]
    H = 2 * T if glv else T
    n = curve.field.n_limbs
    _check(bases, (T, 3, n, B), "ladder bases")
    _check(mag, (nw, H, B), "ladder mag")
    _check(neg, (nw, H, B), "ladder neg")
    _check_words(bases, "ladder bases")
    _check_words(mag, "ladder mag")
    b32, m32, g32 = _u32(bases), _u32(mag), _u32(neg)
    out = torch.empty((3, n, B), dtype=torch.int32, device=bases.device)
    _launch("ladder", curve, bases.device, b32.data_ptr(), m32.data_ptr(),
            g32.data_ptr(), out.data_ptr(), T, H, nw, int(glv), B, lanes)
    return _from_u32(out)


def _identity_of(curve: CurveSpec, batch_shape, device) -> torch.Tensor:
    return P.point_limbs(P.identity(curve, tuple(batch_shape), device))


def ladder_plain(curve: CurveSpec, bases: torch.Tensor, mag: torch.Tensor,
                 neg: torch.Tensor, glv: bool = False) -> torch.Tensor:
    from .scalarmul import _point_table, _signed_term   # scalarmul imports this module
    f = curve.field
    T, nw = bases.shape[0], mag.shape[0]
    H = 2 * T if glv else T
    tables = [_point_table(P.point_from_limbs(curve, bases[t]), TBL) for t in range(T)]
    beta = F.fe_from_int(f, curve.glv["beta"], tuple(bases.shape[-1:]),
                         bases.device) if glv else None
    acc = P.point_from_limbs(curve, _identity_of(curve, bases.shape[-1:], bases.device))
    for w in range(nw):
        for _ in range(4):
            acc = P.steady(P.pdouble(acc))
        for h in range(H):
            t, endo_f = (h // 2, h % 2) if glv else (h, 0)
            sel = _signed_term(curve, tables[t], mag[w, h], neg[w, h] != 0)
            x = F.fe_steady(f, sel[0])
            if endo_f:                  # psi after the select: beta * X
                x = F.fmul(beta, x)
            term = P.Point(x, F.fe_steady(f, sel[1]), F.fe_steady(f, sel[2]), curve)
            if H == 1 and w == 0:
                acc = term
            else:
                acc = P.steady(P.padd(acc, term))
    return P.point_limbs(acc)


# ---------------------------------------------------------------------------
# genmul
# ---------------------------------------------------------------------------

def genmul(curve: CurveSpec, tbl: torch.Tensor, mag: torch.Tensor,
           neg: torch.Tensor) -> torch.Tensor:
    """Constant-time fixed-base comb: the affine table tbl [nw, 9, 2, n]
    (row j holds d * 16^j * G for d = 0..8, entry 0 a dummy), digit
    magnitudes mag [nw, B] in [0, 8] and sign masks neg [nw, B], LSB window
    first -> steady [3, n, B] limbs of sum_j d_j 16^j G. The kernel (on
    the 32-bit layer, the comb converted into shared memory once a block)
    returns each coordinate canonical: equal mod p to the twin's."""
    if mag.device.type == "cpu":
        return genmul_plain(curve, tbl, mag, neg)
    nw, B = mag.shape
    n = curve.field.n_limbs
    _check(tbl, (nw, TBL, 2, n), "genmul tbl")
    _check(mag, (nw, B), "genmul mag")
    _check(neg, (nw, B), "genmul neg")
    _check_words(mag, "genmul mag")
    t32, m32, g32 = _u32(tbl), _u32(mag), _u32(neg)
    out = torch.empty((3, n, B), dtype=torch.int32, device=mag.device)
    _launch("genmul", curve, mag.device, t32.data_ptr(), m32.data_ptr(),
            g32.data_ptr(), out.data_ptr(), nw, B)
    return _from_u32(out)


def genmul_plain(curve: CurveSpec, tbl: torch.Tensor, mag: torch.Tensor,
                 neg: torch.Tensor) -> torch.Tensor:
    from .scalarmul import _ct_lookup   # scalarmul imports this module
    f = curve.field
    n = f.n_limbs
    acc = P.identity(curve, tuple(mag.shape[1:]), mag.device)
    for w in range(mag.shape[0]):
        m = mag[w]
        sel = _ct_lookup(tbl[w].reshape(TBL, 2, n, 1), m)     # [2, n, B]
        y = F.fe_steady(f, sel[1])
        y = F.fselect(neg[w] != 0, F.fsteady(F.fneg(y)), y)
        new = P.steady(P.padd_mixed(acc, F.fe_steady(f, sel[0]), y))
        acc = P.pselect(m == 0, acc, new)      # entry 0 is the dummy
    return P.point_limbs(acc)


# ---------------------------------------------------------------------------
# the Pippenger phases: segscan, fixup, bucket_reduce, horner
# ---------------------------------------------------------------------------

def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32)


def segscan(curve: CurveSpec, key2: torch.Tensor, val2: torch.Tensor, nbuck: int,
            neg2: torch.Tensor | None = None):
    """Per-lane segmented scan of C digit-sorted points: keys key2 [C, *lanes],
    steady point limbs val2 [C, 3, n, *lanes] and, with signed digits, the
    sign masks neg2 [C, *lanes] (y is negated where set) -> int32 (scanned
    [C, 3, n, *lanes], last_key [*lanes], tail [3, n, *lanes], lead
    [3, n, *lanes]). The previous key starts at the sentinel `nbuck`; `lead`
    is the scan's value at the end of each lane's leading run (the rows whose
    key is the lane's first). Lanes are independent, so several windows can
    go side by side.

    The kernel (on the 32-bit layer) writes row r of `scanned` only where r
    ends a run, key2[r + 1] != key2[r] or r = C - 1: the one row of a run
    that `bucket_lookup` reads. The other rows are left unwritten (whatever
    torch.empty gave). Its values are canonical, each coordinate equal mod
    p to the twin's, which writes every row."""
    if key2.device.type == "cpu":
        return segscan_plain(curve, key2, val2, nbuck, neg2)
    C, lanes = key2.shape[0], tuple(key2.shape[1:])
    n = curve.field.n_limbs
    _check(key2, (C, *lanes), "segscan key2")
    _check(val2, (C, 3, n, *lanes), "segscan val2")
    if neg2 is not None:
        _check(neg2, (C, *lanes), "segscan neg2")
    _check_words(val2, "segscan val2")
    k32, v32 = _u32(key2), _u32(val2)
    g32 = None if neg2 is None else _u32(neg2)
    dev = key2.device
    scanned = torch.empty((C, 3, n, *lanes), dtype=torch.int32, device=dev)
    last_key = torch.empty(lanes, dtype=torch.int32, device=dev)
    tail = torch.empty((3, n, *lanes), dtype=torch.int32, device=dev)
    lead = torch.empty((3, n, *lanes), dtype=torch.int32, device=dev)
    _launch("segscan", curve, dev, k32.data_ptr(), v32.data_ptr(),
            None if g32 is None else g32.data_ptr(), scanned.data_ptr(),
            last_key.data_ptr(), tail.data_ptr(), lead.data_ptr(), C,
            last_key.numel(), nbuck)
    return scanned, last_key, tail, lead


def segscan_plain(curve: CurveSpec, key2: torch.Tensor, val2: torch.Tensor,
                  nbuck: int, neg2: torch.Tensor | None = None):
    f = curve.field
    key2 = key2.to(F.LIMB)
    acc = lead = _identity_of(curve, key2.shape[1:], key2.device)
    pk = torch.full_like(key2[0], nbuck)
    rows = []
    for r in range(key2.shape[0]):
        v = val2[r].to(F.LIMB)
        if neg2 is not None:
            yn = F.fsteady(F.fneg(F.fe_steady(f, v[1]))).limbs
            v = torch.stack([v[0], torch.where(neg2[r] != 0, yn, v[1]), v[2]], 0)
        k = key2[r]
        acc = torch.where(k == pk, P.add_limbs(curve, acc, v), v)
        rows.append(acc)
        lead = torch.where(k == key2[0], acc, lead)
        pk = k
    return (_i32(torch.stack(rows, 0)), _i32(pk), _i32(acc), _i32(lead))


def fixup(curve: CurveSpec, t_l: torch.Tensor, last_key: torch.Tensor,
          first_key: torch.Tensor, lead: torch.Tensor) -> torch.Tensor:
    """Stitch the runs that cross lane boundaries, per window of L lanes
    (the last axis; leading axes are independent windows): a segmented
    Hillis–Steele scan of the lane tails t_l [3, n, *w, L] keyed on last_key
    [*w, L], then lead + (T[l-1] where first_key[l] == last_key[l-1], else
    O) -> int32 [3, n, *w, L]. log2(L) + 1 launches. The kernel (on the
    32-bit layer) keeps the lanes as canonical words between its steps, in
    a scratch of 2 * 3N words a lane, and returns each coordinate
    canonical: equal mod p to the twin's."""
    if t_l.device.type == "cpu":
        return fixup_plain(curve, t_l, last_key, first_key, lead)
    keys = tuple(last_key.shape)
    n = curve.field.n_limbs
    _check(t_l, (3, n, *keys), "fixup t_l")
    _check(first_key, keys, "fixup first_key")
    _check(lead, (3, n, *keys), "fixup lead")
    L = keys[-1]
    _check_words(t_l, "fixup t_l")   # the scratch is smaller
    t32, lk32, fk32, ld32 = _u32(t_l), _u32(last_key), _u32(first_key), _u32(lead)
    out = torch.empty((3, n, *keys), dtype=torch.int32, device=t_l.device)
    buf = torch.empty((2, 3 * kfe.fe32_words(curve.field), last_key.numel()),
                      dtype=torch.int32, device=t_l.device)
    _launch("fixup", curve, t_l.device, t32.data_ptr(), lk32.data_ptr(),
            fk32.data_ptr(), ld32.data_ptr(), out.data_ptr(), buf.data_ptr(), L,
            last_key.numel())
    return out


def fixup_plain(curve: CurveSpec, t_l: torch.Tensor, last_key: torch.Tensor,
                first_key: torch.Tensor, lead: torch.Tensor) -> torch.Tensor:
    L = t_l.shape[-1]
    lk = last_key.to(F.LIMB)
    lane = torch.arange(L, device=t_l.device)
    vals = t_l.to(F.LIMB)
    s = 1
    while s < L:
        ok = (torch.roll(lk, s, -1) == lk) & (lane >= s)
        vals = torch.where(ok, P.add_limbs(curve, vals, torch.roll(vals, s, -1)), vals)
        s *= 2
    carry_ok = (first_key.to(F.LIMB) == torch.roll(lk, 1, -1)) & (lane >= 1)
    carry = torch.where(carry_ok, torch.roll(vals, 1, -1),
                        _identity_of(curve, lk.shape, lk.device))
    return _i32(P.add_limbs(curve, lead.to(F.LIMB), carry))


def bucket_reduce(curve: CurveSpec, buckets: torch.Tensor, drop0: bool) -> torch.Tensor:
    """sum_b b * S_b over the buckets [3, n, *w, nbuck] of each window (the
    last axis; nbuck a power of two >= 2; leading axes are independent
    windows): a guarded suffix scan, bucket 0 dropped with `drop0`, then
    lane 0 of a circular all-reduce, as a pairwise tree -> int32 [3, n, *w].
    2 * log2(nbuck) launches. The kernel (on the 32-bit layer) keeps the
    buckets as canonical words between its steps, in a scratch of 2 * 3N
    words a bucket, and returns each coordinate canonical: equal mod p to
    the twin's."""
    nbuck = buckets.shape[-1]
    if nbuck < 2 or nbuck & (nbuck - 1):
        raise ValueError(f"bucket_reduce: nbuck must be a power of two >= 2, got {nbuck}")
    if buckets.device.type == "cpu":
        return bucket_reduce_plain(curve, buckets, drop0)
    n = curve.field.n_limbs
    wins = tuple(buckets.shape[2:-1])
    _check(buckets, (3, n, *wins, nbuck), "bucket_reduce buckets")
    b32 = _u32(buckets)
    groups = b32[0, 0].numel() // nbuck
    out = torch.empty((3, n, *wins), dtype=torch.int32, device=buckets.device)
    _check_words(b32, "bucket_reduce buckets")   # the scratch is smaller
    buf = torch.empty((2, 3 * kfe.fe32_words(curve.field), groups * nbuck),
                      dtype=torch.int32, device=buckets.device)
    _launch("bucket_reduce", curve, buckets.device, b32.data_ptr(), out.data_ptr(),
            buf.data_ptr(), nbuck, groups, int(drop0))
    return out


def bucket_reduce_plain(curve: CurveSpec, buckets: torch.Tensor,
                        drop0: bool) -> torch.Tensor:
    suff = P.suffix_scan_limbs(curve, buckets.to(F.LIMB))
    if drop0:
        suff = torch.cat([_identity_of(curve, suff.shape[2:-1] + (1,), suff.device),
                          suff[..., 1:]], -1)
    return _i32(P.tree_total_limbs(curve, suff))


def horner(curve: CurveSpec, s_all: torch.Tensor, w: int) -> torch.Tensor:
    """acc = 2^w * acc + S_j over the window sums s_all [nw, 3, n], MSB
    window first, from acc = O -> int32 [3, n]. One thread (on the 32-bit
    layer), whose result is canonical: each coordinate equal mod p to the
    twin's."""
    if s_all.device.type == "cpu":
        return horner_plain(curve, s_all, w)
    nw = s_all.shape[0]
    n = curve.field.n_limbs
    _check(s_all, (nw, 3, n), "horner s_all")
    s32 = _u32(s_all)
    out = torch.empty((3, n), dtype=torch.int32, device=s_all.device)
    _launch("horner", curve, s_all.device, s32.data_ptr(), out.data_ptr(), nw, w)
    return out


def horner_plain(curve: CurveSpec, s_all: torch.Tensor, w: int) -> torch.Tensor:
    acc = P.identity(curve, (), s_all.device)
    for j in range(s_all.shape[0]):
        for _ in range(w):
            acc = P.steady(P.pdouble(acc))
        acc = P.steady(P.padd(acc, P.point_from_limbs(curve, s_all[j].to(F.LIMB))))
    return _i32(P.point_limbs(acc))


# ---------------------------------------------------------------------------
# the probes: dma_gather, fmul_chain, mxu_chain, ladder_probe
# ---------------------------------------------------------------------------

def dma_gather(payload: torch.Tensor, idx: torch.Tensor, Cb: int,
               depth: int) -> torch.Tensor:
    """The XOR of the rows payload[idx] -> [1, W]: payload int32 [N, W]
    (uint32 bits), idx int32 [M], M a multiple of Cb, Cb of depth. The
    kernel splits each chunk of Cb indices into runs of at most GATHER_ROWS
    rows, one run a warp (Cb bounds a run; the warps on the card do not
    follow it), and keeps `depth` row copies in flight in each warp's ring;
    the result does not depend on Cb or depth. An index outside [0, N)
    stops the kernel with a device fault, as index_select's device
    assertion does."""
    M = idx.shape[0]
    N, W = payload.shape
    if Cb <= 0 or depth <= 0 or M % Cb or Cb % depth:
        raise ValueError(f"dma_gather: need Cb | M and depth | Cb, got M={M} "
                         f"Cb={Cb} depth={depth}")
    if (W * 4) % 16 or W > 1024:
        raise ValueError(f"dma_gather: a row must be a multiple of 16 bytes and at "
                         f"most 1024 words, got W={W}")
    parts = -(-Cb // GATHER_ROWS)
    ring = depth * (4 * W + 8) + 4 * -(-Cb // parts) + 4 * W    # one warp's, and the fold
    if ring > SMEM_BLOCK:
        raise ValueError(f"dma_gather: a ring of depth {depth} rows of {W} words takes "
                         f"{ring} B, above the {SMEM_BLOCK} B a block can hold")
    if payload.device.type == "cpu":
        return dma_gather_plain(payload, idx)
    _check(payload, (N, W), "dma_gather payload")
    _check(idx, (M,), "dma_gather idx")
    if payload.dtype != torch.int32 or idx.dtype != torch.int32:
        raise ValueError("dma_gather: payload and idx must be int32")
    pay, ix = payload.contiguous(), idx.contiguous()
    out = torch.zeros((1, W), dtype=torch.int32, device=payload.device)
    _launch("dma_gather", None, payload.device, pay.data_ptr(), ix.data_ptr(),
            out.data_ptr(), N, W, M, Cb, depth)
    return out


def dma_gather_plain(payload: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    rows = torch.index_select(payload, 0, idx)
    while rows.shape[0] > 1:            # XOR fold, a pairwise tree
        if rows.shape[0] % 2:
            rows = torch.cat([rows, torch.zeros_like(rows[:1])], 0)
        h = rows.shape[0] // 2
        rows = rows[:h] ^ rows[h:]
    return rows if rows.shape[0] else torch.zeros_like(payload[:1])


def fmul_chain(spec: F.FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a <- a * b, CHAIN times: steady limbs a, b [n, B] -> steady [n, B].
    On a Montgomery field each product carries R^-1 (R13 = 2^(13n) in the
    twin, which clamps each product steady; R32 in the kernel, on the
    32-bit layer's `mul`, whose load and store map R13 to R32 and back).
    The kernel returns canonical limbs: equal mod p to the twin's."""
    if a.device.type == "cpu":
        return fmul_chain_plain(spec, a, b)
    n, B = spec.n_limbs, a.shape[-1]
    _check(a, (n, B), "fmul_chain a")
    _check(b, (n, B), "fmul_chain b")
    _check_words(a, "fmul_chain a")
    a32, b32 = _u32(a), _u32(b)
    out = torch.empty((n, B), dtype=torch.int32, device=a.device)
    _launch("fmul_chain", spec, a.device, a32.data_ptr(), b32.data_ptr(),
            out.data_ptr(), B)
    return _from_u32(out)


def fmul_chain_plain(spec: F.FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    acc, y = F.fe_steady(spec, a.to(F.LIMB)), F.fe_steady(spec, b.to(F.LIMB))
    for _ in range(CHAIN):
        acc = F._steady(F.fmul(acc, y))
    return acc.limbs


def _toeplitz(limbs, rows: int, cols: int) -> np.ndarray:
    """C[k, i] = limbs[k - i] (0 outside): the banded convolution matrix."""
    m = np.zeros((rows, cols), np.int64)
    for i in range(cols):
        for j, v in enumerate(limbs):
            if i + j < rows:
                m[i + j, i] = v
    return m


def _planes_np(mat: np.ndarray) -> tuple:
    """13-bit digits -> their int8 planes (low 7 bits, high 6 bits)."""
    return (mat & 127).astype(np.int8), (mat >> 7).astype(np.int8)


@functools.lru_cache(maxsize=None)
def mont_matrices(spec: F.FieldSpec) -> tuple:
    """The two constant Toeplitz matrices of the separated Montgomery step:
    Mc [n, n] (m = T * N' mod R, the columns >= n dropped) and Pc [2n, n]
    (m * p), N' = -p^-1 mod R, R = 2^(b n)."""
    b, n = spec.limb_bits, spec.n_limbs
    R = 1 << (b * n)
    nprime = (R - pow(spec.p, -1, R)) % R
    return (_toeplitz(int_to_limbs(nprime, n, b), n, n),
            _toeplitz(int_to_limbs(spec.p, n, b), 2 * n, n))


def _carry_rows(cols: torch.Tensor, b: int, mask: int) -> torch.Tensor:
    """The sequential carry down the rows of cols; the carry-out drops."""
    return torch.stack(kfe._carry_unrolled(list(cols), b, mask)[0], 0)


def mont_step(spec: F.FieldSpec, x: torch.Tensor, y: torch.Tensor, const_conv) -> torch.Tensor:
    """One separated Montgomery multiply on canonical digits x, y [n, B]
    (tools/bench_mxu_mul.py:286-298, the kernel chain's :470-484): the data
    by data convolution and its carry, m = T * N' mod R and (T + m p) / R by
    const_conv(which, digits) (which: 0 for N', 1 for p) -> digits [n, B]
    below 2p."""
    b, n, mask = spec.limb_bits, spec.n_limbs, spec.mask
    cols = torch.zeros((2 * n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    for i in range(n):
        cols[i:i + n] += x[i] * y
    T = _carry_rows(cols, b, mask)
    m = _carry_rows(const_conv(0, T[:n]), b, mask)
    u = _carry_rows(const_conv(1, m) + T, b, mask)
    return u[n:]


def mxu_chain(spec: F.FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a <- a b R^-1, CHAIN times, on a Montgomery field: canonical digits
    a, b [n, B] -> [n, B]. The twin runs the tool's separated multiply on
    13-bit digits (`mont_step`, R13; digits below 2p). The kernel runs it on
    the 32-bit layer (R32 = 2^(32N), which its load and store map to R13
    and back): T = x y on the CUDA cores, the reduction's two constant
    products m = T N' mod R32 and m p as byte-digit `wgmma` products on the
    tensor cores (`mont_byte_matrices`); it takes fields of at most
    MXU_MAX_WORDS words and raises ValueError for a wider one before any
    build or launch. It returns canonical limbs: equal mod p to the twin's."""
    if spec.kind != "mont":
        raise ValueError(f"mxu_chain: {spec} is not a Montgomery field")
    if a.device.type == "cpu":
        return mxu_chain_plain(spec, a, b)
    words = kfe.fe32_words(spec)
    if words > MXU_MAX_WORDS:
        raise ValueError(f"mxu_chain: {spec.name} takes N = {words} words; the kernel takes "
                         f"Montgomery fields of at most N = {MXU_MAX_WORDS}")
    n, B = spec.n_limbs, a.shape[-1]
    _check(a, (n, B), "mxu_chain a")
    _check(b, (n, B), "mxu_chain b")
    _check_words(a, "mxu_chain a")
    a32, b32 = _u32(a), _u32(b)
    tiles = _mxu_tiles_on(spec, a.device)
    out = torch.empty((n, B), dtype=torch.int32, device=a.device)
    _launch("mxu_chain", spec, a.device, a32.data_ptr(), b32.data_ptr(), tiles.data_ptr(),
            out.data_ptr(), B)
    return _from_u32(out)


def mxu_shape(spec: F.FieldSpec) -> dict:
    """mxu_chain's product shapes at the field's N words (csrc/chain32.cuh
    MxuShape): KB digit bytes a lane (4N, padded to the 32-byte k step), M1
    and M2 rows of the N' and p matrices (4N and 8N, padded to 64-row
    tiles), SS words of column sums a lane in shared memory (at least 8N,
    4 mod 16)."""
    N = kfe.fe32_words(spec)
    return {"N": N, "KB": 32 * -(-4 * N // 32), "M1": 64 * -(-4 * N // 64),
            "M2": 64 * -(-8 * N // 64), "SS": (8 * N + 11) // 16 * 16 + 4}


@functools.lru_cache(maxsize=None)
def mont_byte_matrices(spec: F.FieldSpec) -> tuple:
    """mxu_chain's two constant Toeplitz matrices of bytes, uint8 [M1, KB]
    and [M2, KB] (`mxu_shape`, zero-padded): A1[k, j] = byte k - j of N' =
    -p^-1 mod R32 (k < 4N: m = T N' mod R32) and A2[k, j] = byte k - j of p
    (k < 8N: m p), R32 = 2^(32N); a lane's digits are its words' 4N bytes."""
    sh = mxu_shape(spec)
    N, KB = sh["N"], sh["KB"]
    R = 1 << (32 * N)
    nprime = (-pow(spec.p, -1, R)) % R
    out = []
    for v, rows, M in ((nprime, 4 * N, sh["M1"]), (spec.p, 8 * N, sh["M2"])):
        m = np.zeros((M, KB), np.uint8)
        m[:rows, :4 * N] = _toeplitz(list(v.to_bytes(4 * N, "little")), rows, 4 * N)
        out.append(m)
    return tuple(out)


def core_tiles(m: np.ndarray) -> np.ndarray:
    """A byte matrix [rows, KB] (rows a multiple of 8, KB of 16) in the
    kernel's operand layout, uint8 [rows KB]: K-major without swizzle, core
    matrices of 8 rows x 16 bytes, the 16-byte chunks of a row 128 B apart,
    each 8 rows 8 KB bytes apart (csrc/chain32.cuh mxu_offset)."""
    M, KB = m.shape
    return m.reshape(M // 8, 8, KB // 16, 16).transpose(0, 2, 1, 3).reshape(-1)


def mxu_tiles(spec: F.FieldSpec) -> np.ndarray:
    """The two byte matrices (`mont_byte_matrices`) in the kernel's operand
    layout (`core_tiles`), one after the other, uint8 [(M1 + M2) KB]."""
    return np.concatenate([core_tiles(m) for m in mont_byte_matrices(spec)])


@functools.lru_cache(maxsize=None)
def _mxu_tiles_on(spec: F.FieldSpec, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(mxu_tiles(spec)).to(device)


def mxu_chain_plain(spec: F.FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mats = [torch.from_numpy(m).to(a.device) for m in mont_matrices(spec)]

    def const_conv(which, d):
        return (mats[which][:, :, None] * d[None]).sum(1)

    x, y = a.to(F.LIMB), b.to(F.LIMB)
    for _ in range(CHAIN):
        x = mont_step(spec, x, y, const_conv)
    return x


def ladder_probe(curve: CurveSpec, bases: torch.Tensor, mag: torch.Tensor,
                 neg: torch.Tensor, variant: str) -> torch.Tensor:
    """The ladder's body with its parts switched on one at a time
    (PROBE_VARIANTS): bases [3, n, B] steady limbs of one base, mag and neg
    [nw, 2, B] -> steady [3, n, B]. From O, per window 4 doublings, then for
    h = 0, 1 an add of the selected entry of the table [O, Q, .., 8Q]:
    entry 1 (`bare`, `unroll`, `build`) or entry mag[w, h] (`select`,
    `negate`); `negate` negates y where neg[w, h] is set; from `build` on
    the kernel builds the table's entries 2-8 (7 adds), though only
    `select` and `negate` read them (the twin builds them only there). The
    kernel (on the 32-bit layer, the table in shared memory) returns each
    coordinate canonical: equal mod p to the twin's."""
    if variant not in PROBE_VARIANTS:
        raise ValueError(f"ladder_probe: variant must be one of {PROBE_VARIANTS}")
    if bases.device.type == "cpu":
        return ladder_probe_plain(curve, bases, mag, neg, variant)
    n, B = curve.field.n_limbs, bases.shape[-1]
    nw = mag.shape[0]
    _check(bases, (3, n, B), "ladder_probe bases")
    _check(mag, (nw, 2, B), "ladder_probe mag")
    _check(neg, (nw, 2, B), "ladder_probe neg")
    _check_words(bases, "ladder_probe bases")
    _check_words(mag, "ladder_probe mag")
    b32, m32, g32 = _u32(bases), _u32(mag), _u32(neg)
    out = torch.empty((3, n, B), dtype=torch.int32, device=bases.device)
    _launch("ladder_probe", curve, bases.device, b32.data_ptr(), m32.data_ptr(),
            g32.data_ptr(), out.data_ptr(), nw, PROBE_VARIANTS.index(variant), B)
    return _from_u32(out)


def ladder_probe_plain(curve: CurveSpec, bases: torch.Tensor, mag: torch.Tensor,
                       neg: torch.Tensor, variant: str) -> torch.Tensor:
    from .scalarmul import _ct_lookup, _point_table, _signed_term  # scalarmul imports this module
    base = P.point_from_limbs(curve, bases.to(F.LIMB))
    tbl = _point_table(base, TBL) if variant in ("select", "negate") else None
    acc = P.point_from_limbs(curve, _identity_of(curve, bases.shape[-1:], bases.device))
    for w in range(mag.shape[0]):
        for _ in range(4):
            acc = P.steady(P.pdouble(acc))
        for h in range(2):
            if variant == "negate":
                sel = P.point_from_limbs(curve, _signed_term(curve, tbl, mag[w, h],
                                                             neg[w, h] != 0))
            elif variant == "select":
                sel = P.point_from_limbs(curve, _ct_lookup(tbl, mag[w, h]))
            else:
                sel = base
            acc = P.steady(P.padd(acc, sel))
    return P.point_limbs(acc)


# ---------------------------------------------------------------------------
# work per call, for the kernels' bounds
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def op_counts(target) -> dict:
    """The 32-bit integer instructions each generated function of `target`
    (a curve or a field spec) needs at least, by class, as the 13-bit
    generator counts them (kfe.INSTRUCTION_CLASSES): the point formulas
    where the generator has them (kfe.has_formulas), and both fields'
    functions."""
    names = tuple(n for n in kfe.function_table(target)
                  if n not in kfe.FE32_POINT_FNS or kfe.has_formulas(target))
    return kfe.kernel_header(target, names)[1]


_NONE = dict.fromkeys(kfe.INSTRUCTION_CLASSES, 0)


def _total(*terms) -> dict:
    """sum(k * counts) over terms = [(k, counts by class), ...]."""
    return {c: sum(k * cnt[c] for k, cnt in terms) for c in kfe.INSTRUCTION_CLASSES}


def designs(name: str, target) -> tuple:
    """The designs whose instruction counts `work` gives for kernel `name`
    on `target` (a curve or a field spec): the 13-bit generated code
    ("kfe", which no kernel runs any more) wherever the generator has the
    functions the kernel calls (every point kernel needs the curve's
    formulas, kfe.has_formulas), the 32-bit layer ("fe32") for
    FE32_KERNELS, which run on it, and for `mxu_chain` also "cios": the
    same chain by the layer's own multiply, as `fmul_chain` runs it. A
    row's bound is the least of its designs' times."""
    if name == "mxu_chain":
        return ("kfe", "fe32", "cios")
    if name not in FE32_KERNELS:
        return ("kfe",)
    points = isinstance(target, CurveSpec) and name != "pow"
    return ("kfe", "fe32") if not points or kfe.has_formulas(target) else ("fe32",)


def work(name: str, target, B: int, design: str = "kfe", **kw) -> tuple:
    """(32-bit integer instructions by class, bytes that must move) of one
    call: padd(), pdouble(), padd_chain(repeat=), pow(field=0|1, e=),
    ladder(T=, nw=, glv=), genmul(nw=), segscan(C=, adds=, ends=, signed=),
    fixup(adds=), bucket_reduce(groups=), horner(nw=, w=) on a curve;
    fmul_chain(), mxu_chain() on a field spec; dma_gather(M=) with target
    None; ladder_probe(nw=, variant=). B is the lanes of all windows
    (segscan, fixup), the buckets of one window (bucket_reduce), 1
    (horner) or the row width W (dma_gather); `adds` counts the adds that
    the call's data needs (rows whose key repeats; lanes whose partner is
    in their run, over all steps), `ends` the run-end rows over all lanes
    (the rows segscan writes). `mxu_chain` adds the int8 tensor-core
    operations (two per multiply-add) under "int8". `design` (see
    `designs`): "kfe" counts the generated 13-bit code (for `mxu_chain` the
    13-bit plan's four int8 planes), "fe32" the 32-bit layer
    (kfe.fe32_counts; `mxu_chain`'s step `mxu_step_counts` and its two
    byte-digit products), whose IMAD.WIDE.U32 are under "wide"; "cios"
    `mxu_chain`'s chain by the layer's multiply."""
    if design == "cios" and name == "mxu_chain":
        return _work_fe32("fmul_chain", target, B)
    if design == "fe32":
        return _work_fe32(name, target, B, **kw)
    if design != "kfe":
        raise ValueError(f"unknown design {design!r}")
    if name == "dma_gather":        # one XOR per word gathered
        M = kw["M"]
        return {"imad": 0, "alu": M * B, "other": 0}, (M * B + M + B) * 4
    c = op_counts(target)
    if isinstance(target, F.FieldSpec):
        n = target.n_limbs
        if name == "fmul_chain":
            return _total((CHAIN * B, c["fp_mul"])), 3 * n * 4 * B
        if name == "mxu_chain":
            # per step and lane: the n*n convolution; one AND and one add
            # with the shifted carry per digit of the three carries (2n, n,
            # 2n digits); one AND and one shift per digit split into planes
            # (2n); two shift-adds per recombined column (3n); the + T (2n).
            # The four plane products are 4 * (n*n + 2n*n) multiply-adds.
            step = {"imad": n * n, "alu": 5 * n + 2 * n,
                    "other": 5 * n + 2 * n + 2 * 3 * n + 2 * n}
            ops = _total((CHAIN * B, step))
            ops["int8"] = CHAIN * B * 2 * 4 * 3 * n * n
            return ops, 3 * n * 4 * B + 3 * n * n * 2
        raise KeyError(name)
    curve = target
    n = curve.field.n_limbs
    pn = 3 * n
    if name == "ladder_probe":
        nw, variant = kw["nw"], kw["variant"]
        built = variant not in ("bare", "unroll")
        selects = variant in ("select", "negate")
        select = {"imad": 0, "alu": TBL * (pn + 1), "other": 0}
        negate = {"imad": 0, "alu": n, "other": 0}
        ops = _total(((7 if built else 0) * B, c["padd"]), (4 * nw * B, c["pdouble"]),
                     (2 * nw * B, c["padd"]), (2 * nw * B if selects else 0, select),
                     (2 * nw * B if variant == "negate" else 0, negate),
                     (2 * nw * B if variant == "negate" else 0, c["fp_neg"]))
        words = 2 * pn + (2 * nw if selects else 0) + (2 * nw if variant == "negate" else 0)
        return ops, words * 4 * B
    if name == "padd":
        return _total((B, c["padd"])), 3 * pn * 4 * B
    if name == "pdouble":
        return _total((B, c["pdouble"])), 2 * pn * 4 * B
    if name == "padd_chain":
        return _total((kw["repeat"] * B, c["padd"])), 3 * pn * 4 * B
    if name == "pow":
        pre = ("fp", "fn")[kw["field"]]
        digits = exponent_digits(kw["e"])
        nl = (curve.field, curve.scalar)[kw["field"]].n_limbs
        muls = 14 + sum(1 for d in digits if d)
        ops = _total((muls * B, c[f"{pre}_mul"]),
                     (4 * len(digits) * B, c[f"{pre}_sqr"]))
        return ops, 2 * nl * 4 * B + 4 * len(digits)
    if name == "ladder":
        T, nw, glv = kw["T"], kw["nw"], kw["glv"]
        H = 2 * T if glv else T
        # per term and window: a compare and a select of 3n words for each
        # of the 9 entries, the negation of y and the select of n words
        select = {"imad": 0, "alu": TBL * (pn + 1) + n, "other": 0}
        adds = T * (TBL - 2) + nw * H - (1 if H == 1 else 0)
        ops = _total((adds * B, c["padd"]), (4 * nw * B, c["pdouble"]),
                     (nw * H * B, select), (nw * H * B, c["fp_neg"]),
                     (nw * T * B if glv else 0, c.get("fp_mul_beta", _NONE)))
        return ops, (T * pn + 2 * nw * H + pn) * 4 * B
    if name == "genmul":
        nw = kw["nw"]
        # per window: a compare and a select of 2n words for each of the 9
        # entries, the select of n words of y, and the compare and select
        # of 3n words that keep acc on a zero digit
        select = {"imad": 0, "alu": TBL * (2 * n + 1) + n + pn + 1, "other": 0}
        ops = _total((nw * B, c["padd_mixed"]), (nw * B, c["fp_neg"]),
                     (nw * B, select))
        return ops, nw * TBL * 2 * n * 4 + (2 * nw + pn) * 4 * B
    if name == "segscan":
        C, signed = kw["C"], kw["signed"]
        # signed: the negation of y and the select of n words, every row
        ops = _total((kw["adds"], c["padd"]),
                     (C * B if signed else 0, c["fp_neg"]),
                     (C * B if signed else 0, {"imad": 0, "alu": n, "other": 0}))
        return ops, _segscan_bytes(pn, B, **kw)
    if name == "fixup":
        return _total((kw["adds"] + B, c["padd"])), (3 * pn + 2) * 4 * B
    if name == "bucket_reduce":
        G = kw["groups"]
        return _total((_bucket_adds(G, B), c["padd"])), pn * 4 * G * (B + 1)
    if name == "horner":
        nw, w = kw["nw"], kw["w"]
        return (_total((nw * w, c["pdouble"]), (nw, c["padd"])),
                (nw + 1) * pn * 4)
    raise KeyError(name)


def _bucket_adds(groups: int, nbuck: int) -> int:
    """bucket_reduce's adds: (nbuck - s) a window at each suffix step s,
    nbuck - 1 a window in the tree."""
    steps = nbuck.bit_length() - 1
    return groups * (sum(nbuck - (1 << k) for k in range(steps)) + nbuck - 1)


def _segscan_bytes(pn: int, B: int, C: int, ends: int, signed: bool, **_) -> int:
    """Every row, key and sign read once; the run-end rows, tail, lead and
    last_key written once."""
    return (C * (pn + 1 + signed) + 2 * pn + 1) * 4 * B + ends * pn * 4


def mxu_step_counts(shape: dict) -> tuple:
    """What one step of mxu_chain's lane needs at least at `mxu_shape`'s N
    words: (instructions on the CUDA cores by class, kfe.FE32_CLASSES;
    byte multiply-adds on the tensor cores). On the CUDA cores: the 2N-word
    product T = x y (N^2 IMAD.WIDE.U32, (N - 1)^2 second addends), the OR
    of T's low half, 3N words each folded from four column sums and the
    carry (three shift-adds and an add, 64 bits wide: 8), the high half's
    add of T and of the low half's carry, and the conditional subtraction
    (csrc/chain32.cuh); the round trips of digits and sums through shared
    memory are the kernel's, not the function's, and are left out. On the
    tensor cores: the nonzero band of the two Toeplitz products, 4N (4N +
    1) / 2 for m = T N' mod R32 and 16 N^2 for m p, not the zero rows and
    columns that pad them to 64-row tiles and 32-byte k steps."""
    N = shape["N"]
    step = {"wide": N * N, "imad": 0, "alu": N + 1 + N,
            "other": (N - 1) ** 2 + 8 * 3 * N + 2 * N + 2 + N}
    return step, 4 * N * (4 * N + 1) // 2 + 16 * N * N


def _work_fe32(name: str, curve, B: int, **kw) -> tuple:
    """`work` for the 32-bit layer: its functions' counts (kfe.fe32_counts)
    over the call, on a curve or (FIELD_KERNELS) a bare field spec. A row
    converts on load (3 coordinates) and on store."""
    def total(*terms) -> dict:
        return {k: sum(m * cnt[k] for m, cnt in terms) for k in kfe.FE32_CLASSES}

    if name in FIELD_KERNELS:
        # per lane: the loads of a and b, CHAIN multiplies (mxu_chain: CHAIN
        # steps, each with its two products' byte multiply-adds on the
        # tensor cores), the store; a, b and out once, and mxu_chain's
        # constant tiles
        spec, f = curve, kfe.fe32_counts(curve)
        nbytes = 3 * spec.n_limbs * 4 * B
        if name == "fmul_chain":
            return total((2 * B, f["load"]), (CHAIN * B, f["mul"]), (B, f["store"])), nbytes
        sh = mxu_shape(spec)
        step, macs = mxu_step_counts(sh)
        ops = total((2 * B, f["load"]), (CHAIN * B, step), (B, f["store"]))
        ops["int8"] = CHAIN * B * 2 * macs
        return ops, nbytes + (sh["M1"] + sh["M2"]) * sh["KB"]
    pn = 3 * curve.field.n_limbs
    if name == "pow":
        # per lane: the load of x, 14 multiplies for the table and one a
        # nonzero digit, 4 squarings a digit, the store; in the field's count
        spec = (curve.field, curve.scalar)[kw["field"]]
        f = kfe.fe32_counts(spec)
        digits = exponent_digits(kw["e"])
        muls = 14 + sum(1 for d in digits if d)
        ops = total((B, f["load"]), (muls * B, f["mul"]), (4 * len(digits) * B, f["sqr"]),
                    (B, f["store"]))
        return ops, 2 * spec.n_limbs * 4 * B + 4 * len(digits)
    c = kfe.fe32_counts(curve)      # pow needs the fields alone; the rest the curve
    if name == "padd":
        ops = total((B, c["padd"]), (6 * B, c["load"]), (3 * B, c["store"]))
        return ops, 3 * pn * 4 * B
    if name == "pdouble":
        ops = total((B, c["pdouble"]), (3 * B, c["load"]), (3 * B, c["store"]))
        return ops, 2 * pn * 4 * B
    if name == "padd_chain":
        ops = total((kw["repeat"] * B, c["padd"]), (6 * B, c["load"]), (3 * B, c["store"]))
        return ops, 3 * pn * 4 * B
    if name == "segscan":
        C, signed = kw["C"], kw["signed"]
        n = kfe.fe32_words(curve.field)
        # per row: the load, and (signed) the negation and its select of n
        # words; an add per repeated key; the stores of the run ends, and
        # of tail and lead (one leading run a lane)
        ops = total((3 * C * B, c["load"]), (kw["adds"], c["padd"]),
                    (C * B if signed else 0, c["neg"]),
                    (C * B if signed else 0, {"wide": 0, "imad": 0, "alu": n, "other": 0}),
                    (3 * (kw["ends"] + 2 * B), c["store"]))
        return ops, _segscan_bytes(pn, B, **kw)
    if name == "ladder":
        T, nw, glv = kw["T"], kw["nw"], kw["glv"]
        H = 2 * T if glv else T
        # per lane: the bases' load and 7 adds a table; per window 4
        # doublings; per term the select, beta * x for the odd GLV terms,
        # the sign's negation and an add (none in the seeded first window
        # of H == 1); the store
        ops = total((3 * T * B, c["load"]), (7 * T * B, c["padd"]),
                    (4 * nw * B, c["pdouble"]), (nw * H * B, c["select_point"]),
                    (nw * T * B if glv else 0, c["mul_beta"]), (nw * H * B, c["cneg"]),
                    ((nw * H - (H == 1)) * B, c["padd"]), (3 * B, c["store"]))
        return ops, (T * pn + 2 * nw * H + pn) * 4 * B
    if name == "genmul":
        nw = kw["nw"]
        blocks = -(-B // GENMUL_LANES)
        # per block the prologue's conversion of the comb; per lane and
        # window the select, the sign's negation, a mixed add and the keep
        ops = total((nw * TBL * 2 * blocks, c["load"]), (nw * B, c["select_affine"]),
                    (nw * B, c["cneg"]), (nw * B, c["padd_mixed"]), (nw * B, c["pselect"]),
                    (3 * B, c["store"]))
        return ops, nw * TBL * 2 * (pn // 3) * 4 + (2 * nw + pn) * 4 * B
    if name == "bucket_reduce":
        # the first step loads every bucket and, for the buckets whose
        # partner is in their window, the partner; the last stores one
        # point a window
        G = kw["groups"]
        ops = total((_bucket_adds(G, B), c["padd"]), (3 * G * (2 * B - 1), c["load"]),
                    (3 * G, c["store"]))
        return ops, pn * 4 * G * (B + 1)
    if name == "horner":
        nw, w = kw["nw"], kw["w"]
        ops = total((nw * w, c["pdouble"]), (nw, c["padd"]), (3 * nw, c["load"]),
                    (3, c["store"]))
        return ops, (nw + 1) * pn * 4
    if name == "fixup":
        # the first step loads every lane's point (3 rows; the partners'
        # loads of the lanes that add there are left out of this least
        # count); an add per lane whose partner is in its run; the last
        # launch loads lead, adds once a lane and stores
        ops = total((6 * B, c["load"]), (kw["adds"] + B, c["padd"]), (3 * B, c["store"]))
        return ops, (3 * pn + 2) * 4 * B
    if name == "ladder_probe":
        nw, variant = kw["nw"], kw["variant"]
        built = variant not in ("bare", "unroll")
        selects = variant in ("select", "negate")
        negates = variant == "negate"
        # per lane: the base's load, 7 adds from build on; per window 4
        # doublings and 2 adds, per term the select (select, negate) and
        # the sign's negation (negate); the store
        ops = total((3 * B, c["load"]), ((7 if built else 0) * B, c["padd"]),
                    (4 * nw * B, c["pdouble"]), (2 * nw * B, c["padd"]),
                    (2 * nw * B if selects else 0, c["select_point"]),
                    (2 * nw * B if negates else 0, c["cneg"]), (3 * B, c["store"]))
        words = 2 * pn + (2 * nw if selects else 0) + (2 * nw if negates else 0)
        return ops, words * 4 * B
    raise KeyError(f"{name} does not run on the 32-bit layer")
