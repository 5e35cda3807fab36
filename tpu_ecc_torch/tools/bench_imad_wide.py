"""The issue rate of IMAD.WIDE.U32 on the card, against IMAD's.

`kernels.work` counts the 32-bit field layer's 32 x 32 -> 64 multiply-adds
(IMAD.WIDE.U32) on their own ("wide"), and `chip_smoke.op_seconds` needs
their rate on the FMA pipe: the CUDA C++ Programming Guide's throughput
table gives 64 32-bit integer multiply-adds a clock an SM on compute
capability 9.0, and no rate for the wide form. This measures both in one
run, with kernels of the same shape, each thread running CHAINS
independent chains of one step (STEPS):

    imad:      u = u * y + u               IMAD, 32-bit
    wide:      u = lo32(u) * hi32(u) + c   IMAD.WIDE.U32, c loop-invariant
    wide_acc:  u = lo32(u) * y + u         the 64-bit running addend of a
                                           product column, as nvcc emits it

at full occupancy (8 blocks of 256 threads an SM, one wave), launched in
turns. Each block's thread 0 reads clock64() around its loop; a block's
SM runs its 8 blocks together, so the instructions an SM ran over the
most cycles a block took is the rate a clock an SM, whatever clock the
card ran at. Prints each kernel's SASS opcodes (cuobjdump), that rate,
and the ratio of imad's rate to wide's: the IMAD slots one IMAD.WIDE.U32
takes (`chip_smoke.WIDE_SLOTS`).

    python3 -m tpu_ecc_torch.tools.bench_imad_wide
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess

import torch

from ..ops import kernels as K
from . import device_label

CHAINS, UNROLL = 8, 16       # independent chains a thread; steps a loop pass
THREADS, BLOCKS_PER_SM = 256, 8
OUTER = 2048                 # loop passes: CHAINS * UNROLL instructions each
ROUNDS, REPS = 3, 5          # rounds, each kernel twice in turns; launches a kernel

# the step of each kernel: chain i of a thread, its state u[i], the
# multiplier y and a loop-invariant addend c. wide multiplies the two
# halves of u, so that nvcc must keep the whole 64-bit product
STEPS = {
    "imad": ("uint32_t", "u[i] = u[i] * y + u[i]"),
    "wide": ("uint64_t", "u[i] = (uint64_t)(uint32_t)u[i] * (uint32_t)(u[i] >> 32) + c"),
    "wide_acc": ("uint64_t", "u[i] = (uint64_t)(uint32_t)u[i] * y + u[i]"),
}

_KERNEL = r"""
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    %(name)s_kernel(uint32_t* out, long long* cycles, uint32_t y, int outer) {
  %(word)s u[CHAINS];
  const %(word)s c = ((uint64_t)y << 29) ^ blockIdx.x;
  for (int i = 0; i < CHAINS; ++i) u[i] = threadIdx.x * (i + 3) + blockIdx.x;
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 1
  for (int o = 0; o < outer; ++o) {
#pragma unroll
    for (int s = 0; s < UNROLL; ++s)
#pragma unroll
      for (int i = 0; i < CHAINS; ++i) %(step)s;
  }
  __syncthreads();
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - t0;
  uint64_t x = c;
  for (int i = 0; i < CHAINS; ++i) x ^= u[i];
  out[blockIdx.x * THREADS + threadIdx.x] = (uint32_t)(x ^ (x >> 32));
}
"""

SOURCE = ("#include <cuda_runtime.h>\n#include <stdint.h>\n"
          f"#define CHAINS {CHAINS}\n#define UNROLL {UNROLL}\n#define THREADS {THREADS}\n"
          f"#define BLOCKS_PER_SM {BLOCKS_PER_SM}\n"
          + "".join(_KERNEL % {"name": k, "word": w, "step": st} for k, (w, st) in STEPS.items())
          + "typedef void (*kernel_t)(uint32_t*, long long*, uint32_t, int);\n"
          + "static const kernel_t KERNELS[] = {"
          + ", ".join(f"{k}_kernel" for k in STEPS) + "};\n"
          + r"""
extern "C" int imad_wide_launch(int which, void* out, void* cycles, unsigned y, int outer,
                                int blocks, void* stream) {
  KERNELS[which]<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (long long*)cycles, y, outer);
  return (int)cudaGetLastError();
}
""")


def build() -> str:
    """nvcc the two kernels into a library under kernels.BUILD_DIR (named by
    a hash of the source and flags); returns its path."""
    key = hashlib.sha256("\0".join((SOURCE,) + K.NVCC_FLAGS).encode()).hexdigest()[:16]
    d = os.path.join(K.BUILD_DIR, f"imad_wide-{key}")
    so = os.path.join(d, "libimad_wide.so")
    if not os.path.exists(so):
        os.makedirs(d, exist_ok=True)
        src = os.path.join(d, "imad_wide.cu")
        with open(src, "w") as fh:
            fh.write(SOURCE)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-o", tmp, src], check=True)
        os.replace(tmp, so)
    return so


def sass_opcodes(so: str, kernel: str) -> dict:
    """{opcode: count} of `kernel`'s SASS in the library (cuobjdump -sass)."""
    tool = os.path.join(os.path.dirname(K._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    counts, inside = {}, False
    for ln in text.splitlines():
        if "Function :" in ln:
            inside = kernel in ln
            continue
        m = re.match(r"^\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", ln) if inside else None
        if m:
            words = m.group(1).split()
            op = words[1] if words[0].startswith("@") else words[0]
            counts[op] = counts.get(op, 0) + 1
    return counts


def main(argv=None) -> dict:
    """Returns {"imad": rate, "wide": rate, "wide_acc": rate, "slots": imad /
    wide}, rates in steps a clock an SM (the median over the rounds)."""
    if not torch.cuda.is_available():
        raise SystemExit("bench_imad_wide: no CUDA device")
    dev = torch.device("cuda")
    so = build()
    fn = getattr(ctypes.CDLL(so), "imad_wide_launch")
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = sms * BLOCKS_PER_SM
    out = torch.empty(blocks * THREADS, dtype=torch.int32, device=dev)
    cycles = torch.empty(blocks, dtype=torch.int64, device=dev)
    per_sm = BLOCKS_PER_SM * THREADS * OUTER * CHAINS * UNROLL
    print(f"device: {device_label(dev)}, {sms} SMs; {blocks} blocks of {THREADS} threads, "
          f"{CHAINS} chains a thread, {OUTER * UNROLL} steps a chain", flush=True)

    def run(which: int) -> tuple:
        """(instructions a clock an SM, ms a launch) of REPS launches."""
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(which, out.data_ptr(), cycles.data_ptr(), 0x9E3779B1, OUTER, blocks, stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn(which, out.data_ptr(), cycles.data_ptr(), 0x9E3779B1, OUTER, blocks, stream)
        end.record()
        torch.cuda.synchronize(dev)
        return per_sm / int(cycles.max()), start.elapsed_time(end) / REPS

    names = list(STEPS)
    for name in names:
        ops = sass_opcodes(so, f"{name}_kernel")
        print(f"  {name} ({STEPS[name][1]}) SASS: " + ", ".join(
            f"{k} {v}" for k, v in sorted(ops.items(), key=lambda t: -t[1])))
    got = {name: [] for name in names}
    for _ in range(ROUNDS):
        for which in list(range(len(names))) + list(reversed(range(len(names)))):
            rate, ms = run(which)
            got[names[which]].append(rate)
            print(f"  {names[which]}: {rate:.3f} a clock an SM (the last launch's clock64), "
                  f"{ms:.3f} ms a launch, {per_sm * sms / ms * 1e3:.5g} a second", flush=True)
    med = {k: sorted(v)[len(v) // 2] for k, v in got.items()}
    result = {**med, "slots": med["imad"] / med["wide"]}
    print("median a clock an SM: " + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
          + f"; one IMAD.WIDE.U32 takes {result['slots']:.3f} IMAD slots", flush=True)
    return result


if __name__ == "__main__":
    main()
