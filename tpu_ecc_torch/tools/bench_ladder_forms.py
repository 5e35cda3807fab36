"""The ladder kernel's launch forms: registers, spills and time on the card.

csrc/ladder.cu builds each field's ladder in one of two launch forms, the
one that ran fastest on an H100 (PERF.md): at least one block an SM with the
tables' lane stride a compile-time constant (the solinas field, secp256k1),
or no such minimum with the stride read from blockDim.x (the Montgomery
field, P-256).
ptxas picks the registers, and with them the spills and the schedule, from
the form as much as from the source. This builds the same lane body
(fe32::ladder_lane) in all four forms,

    min1_const   __launch_bounds__(32, 1), stride 32
    min1_reg     __launch_bounds__(32, 1), stride blockDim.x
    nomin_const  __launch_bounds__(32),    stride 32
    nomin_reg    __launch_bounds__(32),    stride blockDim.x

for secp256k1 and P-256, prints ptxas's registers and spills for each,
holds each against kernels.ladder_plain at the verify's shape (T = 2, B =
4096 lanes, 32 a block; GLV on secp256k1) by canonical coordinates mod p,
and times them in turns (ROUNDS rounds, the order reversed in every other).

    python3 -m tpu_ecc_torch.tools.bench_ladder_forms
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess

import numpy as np
import torch

from ..curves.specs import get_curve
from ..ops import fe as F
from ..ops import kernels as K
from ..ops import points as P
from ..ops import scalarmul as SM
from ..utils import ec_host as H
from . import device_label

LANES, B = 32, 4096
ROUNDS, REPS = 8, 5          # rounds in turns; launches a timing
FORMS = {
    "min1_const": ("__launch_bounds__(LANES, 1)", "LANES"),
    "min1_reg": ("__launch_bounds__(LANES, 1)", "blockDim.x"),
    "nomin_const": ("__launch_bounds__(LANES)", "LANES"),
    "nomin_reg": ("__launch_bounds__(LANES)", "blockDim.x"),
}

_KERNEL = r"""
__global__ void %(bounds)s
    %(name)s_kernel(const uint32_t* __restrict__ bases, const uint32_t* __restrict__ mag,
                    const uint32_t* __restrict__ neg, uint32_t* __restrict__ out, int T,
                    int H, int nw, int glv, int B) {
  extern __shared__ uint32_t tables[];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  fe32::ladder_lane<Curve32>(bases, mag, neg, out, tables + threadIdx.x, %(stride)s, T, H,
                             nw, glv != 0, B, lane);
}
"""

SOURCE = ('#include <cuda_runtime.h>\n#include <stdint.h>\n#include "kfe_ladder.cuh"\n'
          f'#include "point32.cuh"\n#define LANES {LANES}\n'
          + "".join(_KERNEL % {"name": k, "bounds": b, "stride": s}
                    for k, (b, s) in FORMS.items())
          + "typedef void (*form_t)(const uint32_t*, const uint32_t*, const uint32_t*, "
            "uint32_t*, int, int, int, int, int);\n"
          + "static const form_t FORMS[] = {" + ", ".join(f"{k}_kernel" for k in FORMS) + "};\n"
          + r"""
extern "C" int ladder_forms_launch(int which, const void* bases, const void* mag,
                                   const void* neg, void* out, int T, int H, int nw, int glv,
                                   int B, void* stream) {
  const size_t smem = (size_t)T * fe32::TBL * 3 * Curve32::N * sizeof(uint32_t) * LANES;
  cudaError_t err = cudaFuncSetAttribute(FORMS[which],
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  FORMS[which]<<<(B + LANES - 1) / LANES, LANES, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)bases, (const uint32_t*)mag, (const uint32_t*)neg, (uint32_t*)out, T,
      H, nw, glv, B);
  return (int)cudaGetLastError();
}
""")


def build(curves) -> dict:
    """nvcc the four forms for each curve (one process each, together) into
    libraries under kernels.BUILD_DIR, named by a hash of the source, the
    csrc/ headers, the generated header and the flags. Returns {curve name:
    (library path, {form: (registers line, stack and spill line)})}."""
    texts = []
    for inc in ("fe32.cuh", "point32.cuh"):
        with open(os.path.join(K.CSRC, inc)) as fh:
            texts.append(fh.read())
    jobs = {}
    for c in curves:
        header = K._header("ladder", c)
        key = hashlib.sha256("\0".join((SOURCE, header, *texts) + K.NVCC_FLAGS).encode())
        d = os.path.join(K.BUILD_DIR, f"{c.name}-ladder_forms-{key.hexdigest()[:16]}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "kfe_ladder.cuh"), "w") as fh:
            fh.write(header)
        src = os.path.join(d, "ladder_forms.cu")
        with open(src, "w") as fh:
            fh.write(SOURCE)
        so = os.path.join(d, "libladder_forms.so")
        cmd = [K._nvcc(), *K.NVCC_FLAGS, "-I", d, "-I", K.CSRC, "-o", so, src]
        jobs[c.name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ladder_forms for {name} (nvcc exit {proc.returncode}):\n{log}")
        out[name] = (so, ptxas_by_form(log))
    return out


def ptxas_by_form(log: str) -> dict:
    """{form: (registers line, stack and spill line)} of ptxas's -v report."""
    got, form = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(\w+?)_kernel", ln)
        if m:
            form = m.group(1)
            got[form] = ["", ""]
        elif form and "Used" in ln and "registers" in ln:
            got[form][0] = ln.split(":", 1)[1].strip()
        elif form and "stack frame" in ln:
            got[form][1] = ln.strip()
    return {k: tuple(v) for k, v in got.items()}


def _canonical(curve, limbs: torch.Tensor) -> torch.Tensor:
    f = curve.field
    return torch.stack([F.fcanonical(F.fe_steady(f, limbs[c].to(torch.int64))).limbs
                        for c in range(3)], 0)


def _inputs(curve, dev):
    """The verify's ladder: u1*G + u2*Q on B lanes (8 distinct Q, tiled)."""
    rng = np.random.default_rng(3)
    pts = [H.aff_mul(curve, int(k), H.aff_generator(curve)) for k in rng.integers(1, 2**31, 8)]
    pts = pts * (B // 8)
    Q = P.from_affine_ints(curve, [p[0] for p in pts], [p[1] for p in pts], dev)
    ks = [SM.pack_scalars(curve, [int.from_bytes(rng.bytes(32), "big") for _ in range(B)], dev)
          for _ in range(2)]
    return SM.ladder_inputs([(P.generator(curve, (B,), dev), ks[0]), (Q, ks[1])],
                            glv=bool(curve.glv))


def main(argv=None) -> dict:
    """Returns {curve name: {form: {"registers", "spill", "ms"}}}, ms the
    median over the rounds of the mean of REPS launches."""
    if not torch.cuda.is_available():
        raise SystemExit("bench_ladder_forms: no CUDA device")
    dev = torch.device("cuda")
    curves = [get_curve("secp256k1"), get_curve("p256")]
    built = build(curves)
    print(f"device: {device_label(dev)}; the verify's ladder, T = 2, B = {B}, {LANES} lanes "
          f"a block, {ROUNDS} rounds in turns", flush=True)
    result = {}
    for c in curves:
        so, reports = built[c.name]
        fn = getattr(ctypes.CDLL(so), "ladder_forms_launch")
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        glv = bool(c.glv)
        bases, mag, neg = _inputs(c, dev)
        want = _canonical(c, K.ladder_plain(c, bases, mag, neg, glv))
        b32, m32, g32 = K._u32(bases), K._u32(mag), K._u32(neg)
        out = torch.empty((3, c.field.n_limbs, B), dtype=torch.int32, device=dev)

        def run(which):
            err = fn(which, b32.data_ptr(), m32.data_ptr(), g32.data_ptr(), out.data_ptr(), 2,
                     mag.shape[1], mag.shape[0], int(glv), B,
                     torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"ladder_forms launch failed: cudaError {err}")

        names = list(FORMS)
        for which, name in enumerate(names):
            run(which)
            torch.cuda.synchronize(dev)
            if not torch.equal(_canonical(c, K._from_u32(out)), want):
                raise AssertionError(f"{c.name} {name} differs from ladder_plain mod p")
        ms = {name: [] for name in names}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for r in range(ROUNDS):
            for which in (range(len(names)) if r % 2 == 0 else reversed(range(len(names)))):
                start.record()
                for _ in range(REPS):
                    run(which)
                end.record()
                torch.cuda.synchronize(dev)
                ms[names[which]].append(start.elapsed_time(end) / REPS)
        result[c.name] = {}
        for name in names:
            regs, stack = reports[name]
            med = float(np.median(ms[name]))
            result[c.name][name] = {"registers": regs, "spill": stack, "ms": med}
            print(f"  {c.name} {name}: equal mod p to ladder_plain; {regs}; {stack}; median "
                  f"{med:.4f} ms, rounds {[round(x, 4) for x in ms[name]]}", flush=True)
    return result


if __name__ == "__main__":
    main()
