"""End-to-end check of tpu_ecc_torch on one NVIDIA card (H100).

    python3 chip_smoke.py

1. Builds the CUDA kernels (csrc/, sm_90a) from the checkout, one nvcc per
   source and target, all started together: the ten of the main path for
   secp256k1, the six of the P-256 path (padd, pdouble, padd_chain, pow,
   ladder, genmul) for p256, and the seven of the probes (dma_gather;
   fmul_chain for the fields of secp256k1, P-256 and secp256k1 forced onto
   Montgomery, k256mxu.fp; mxu_chain for the two Montgomery fields;
   ladder_probe for secp256k1); the ten of the main path for P-384 (N = 12
   words); pow, ladder, genmul, padd and pdouble for P-521 (N = 17), P-224
   (7), P-192 (6), SM2, bign256, bp256t1 (8), bp384t1 (12) and, on the
   generic-a formulas, bp256r1 (8) and bp384r1 (12) (padd is padd_chain's
   library at one add: one build serves both); and the four MSM phase
   kernels (segscan, fixup, bucket_reduce, horner) for each of MSM_CURVES
   (P-256, SM2, bign256, P-224, P-192, bp256t1, bp256r1, bp384t1, bp384r1,
   P-521): 115 libraries. Those that step 7 and later steps need first,
   the MSM's phase kernels of all twelve curves and the probes' (55), build
   in the background, on a thread at the same niceness, from the end of
   this step until step 10, which waits for them first; then the native
   signing code (g++). Prints the seconds each build
   took and ptxas's registers and stack for each library. The kernels on
   the 32-bit field layer at N = 8 words (fmul_chain and mxu_chain, on
   their bare fields' `Field32`, among them) and dma_gather must show 0
   bytes of spill stores and loads (a build at N = 6, 7, 12 or 17 prints
   its spill; the background's libraries are checked so after the wait);
   for the secp256k1 and P-256 builds, the probes' and P-384's and P-521's
   ladder and pow, the instructions of the loop bodies in the built SASS
   (cuobjdump -sass; pow's for each field, ladder_probe's for each
   variant; bucket_reduce's tree step and fixup's step, which have no
   loop, whole; fmul_chain's multiply, mxu_chain's step), by class, are
   read at step 8, after every timed step, and print beside the count of
   kernels.work's "fe32" design; mxu_chain's step must hold
   a warpgroup MMA instruction (the GMMA family: its two constant
   products on `wgmma`). Then
   it makes the inputs of the new curves' holds (step 10) and of
   ladder_probe's (step 9) and hands their twins to TWIN_WORKERS
   processes, which compute them on the CPU while the background build
   runs (step 2's twin of the Straus shape too, from the start of the
   build).
2. Holds each kernel against its plain PyTorch twin on the card, at the
   shapes the main path gives it (tolerance: exact, zero limb difference;
   for the kernels on the 32-bit layer, which store canonical values, zero
   difference between the canonical limbs of pow's element and of each
   projective coordinate of the others, segscan's `scanned` at its run-end
   rows only; each such hold prints its warps a scheduler): padd_chain at
   B = 8192, repeat 16, on secp256k1, P-256 and P-384; padd and pdouble at
   B = 8192 on the twelve curves, on the inputs of the single point
   operations of step 5; pow on the scalar field (e = n - 2) and the base
   field (e = p - 2) at B = 4096; ladder with glv=True, T = 2 at B = 4096,
   with glv=False, T = 1 (65 windows), and at the Straus MSM's shape (T =
   8 with GLV at the 512 lanes msm() gives 4096 points); genmul (the comb
   k*G) at B = 4096, 65 windows, on random scalars plus 0 and n - 1. Then
   the P-256 and P-384 builds at their paths' shapes (`curve_holds`: pow
   on both fields, the verify's ladder with T = 2 and no GLV on all the
   scalar's windows, 65 or 97, and genmul, each at B = 4096, a core
   call's width), all by canonical values mod p.
   The steps run in the order 1, 10, 2, 11, 3-6, 7, 12, 9, 8: step 10
   first waits for the background build, so that no timing runs beside
   nvcc.
3. Verify: `verify_batch` on secp256k1 over 8192 signatures in two chunks,
   about a quarter of them tampered, run 7 times; every boolean must match
   in every run. Prints each run's verifies/s and their median, and the
   launch counters of a run, which must be above zero.
4. Sign: `sign_batch` over 8192 (d, z) made from a seed, RFC 6979 nonces,
   in two chunks, run 7 times; the same signatures must come out of every
   run, and genmul and pow must have launched. A sample of 256 lanes must
   equal the host oracle's signature with the pure-Python RFC 6979 nonce.
   (The host oracle's signatures, nonces and sampled keys of steps 3-6
   and 10 come from `ecdsa_oracle` on the CPU workers, made while the
   card runs other steps.)
   Derive: `derive_public_batch` over the same 8192 d, 7 runs; a sample of
   256 lanes must equal the host oracle's d*G. All 8192 signatures must
   pass `verify_batch` on the card under the derived keys, and
   `recover_batch` (7 runs) must give back every derived key, with the
   ladder and pow kernels launched. Prints each rate, its runs and median.
5. The headline: padd_chain adds/s at B = 8192, repeat 16, by chain-length
   differencing (the extra work of a longer chain over its extra time), and
   a check of the chain's result against the host oracle. Then the single
   point operations `padd_points` and `pdouble_points` at B = 8192 on the
   twelve curves (the padd and pdouble kernels), 8 lanes each against the
   host oracle.
6. P-256: steps 3-5 again on P-256 (sha256, not low-s; the verify's
   lincomb on the two-term ladder without GLV, 65 windows), with the same
   sizes, checks and run counts, except that the signatures are the host
   oracle's without low-s folding. Then P-384's path: steps 3-5 at the
   same sizes and checks, P384_RUNS runs each; and on P-521, P-224, P-192,
   SM2, bign256, bp256t1, bp384t1, bp256r1 and bp384r1 the chain of step 5
   (padd_chain at B = 8192, repeat 16) held against its twin, computed at
   once on the card, its adds/s and 8 lanes against the host oracle.
10. The new curves (after step 1 and the background build's end): the
   holds of their other builds at
   their path's shapes, B = WIDE_COUNT lanes
   (pow on both fields, the verify's ladder on all the scalar's windows,
   49 to 132, genmul on all the comb's), their twins those the workers
   computed on the CPU; and steps 3-4 at WIDE_COUNT signatures, one run
   each
   (P-192 verify-only: verify and derive); then SM2-DSA and bign-DSA
   (`sm2_bign_phase`) at WIDE_COUNT messages on the sm2 and bign256
   builds: SM2's (r, s) at the caller's k against the host formula, every
   signature of both verified on the card, their vectors accepted and
   their bit flips refused, with the launches each protocol made.
11. Schnorr, ECDH and hash-to-curve (after step 2; vectors from
   tests/vectors/bip340.json and rfc9380_h2c.json): BIP340 on secp256k1
   (`schnorr_phase`: the sign vectors 0-3 byte for byte, the verify vectors
   0-14 and a tampered signature; CHUNK random (d, msg, aux) signed
   SIGN_RUNS times, the same bytes each run, SAMPLE lanes equal to the
   pure-Python signer, all verified under `xonly_public_keys`, a quarter
   tampered and refused exactly there); ECDH on secp256k1 and P-256
   (`ecdh_phase`: CHUNK key pairs each, both sides agree, SAMPLE lanes
   against the host oracle, off-curve, x >= p and d = n give None; the
   secp256k1 call's ladder, GLV at T = 1, held against its twin); RFC
   9380 hash-to-curve (`h2c_phase`: the four suites' vectors exactly,
   CHUNK random messages on secp256k1 and P-256 with SAMPLE lanes against
   device="cpu", pow at e = (p - 3)/4 held on P-384 and P-521 at B =
   WIDE_COUNT). Every core call's launches of ladder, genmul and pow must
   equal PROTOCOL_LAUNCHES. Prints each phase's seconds and each rate
   (one run, host-bound).
7. MSM (`msm_phase`, after step 6): 2^20 points P_i = a_i*G made on the card
   (`derive_public_batch`) and full-width k_i, from a seed. Holds the four
   Pippenger phase kernels against their twins on the card at the shapes
   the first group of windows gives them (segscan signed and unsigned,
   fixup and bucket_reduce also at the last group's 3 windows,
   bucket_reduce with and without drop0, horner on the 19 window sums;
   fixup, bucket_reduce and horner by canonical coordinates, and horner's
   one-thread bound in both designs' counts; horner's twin is computed by
   a CPU worker while the msm() runs go on, and held after them). Then
   `msm()` (signed, w = 14, 8192 lanes) must equal (sum a_i*k_i mod n)*G
   from one host `aff_mul`, with every phase kernel launched; the device
   core (packed tensors in, point out, closed by a synchronize) runs 5
   times. A Straus `msm()` at 4096 points is checked the same way, with
   the ladder launched. Then one core run under torch.profiler gives the
   device time of each step of msm_pippenger (its `msm/<step>` ranges).
   Then the same phase on P-384 at 2^16 points (its 28 windows in one
   group; no variants). Last (step 7b), the same phase runs on each of
   MSM_CURVES at MSM_CURVE_POINTS = 2^14 points (signed, w = 14, one
   group of all the windows, 4096 lanes), their horner holds after the
   last curve, so that the ten horner twins compute on the workers side
   by side.
12. The sharded MSM (after step 7, before the probes; `sharded_phase`):
   step 7's tensors released, SHARD_RANKS = 4 ranks spawned on the one
   card in a gloo group (file:// rendezvous under build/sharded/), each
   loading only kernels that step 1 built. Case 1: each rank makes its
   2^18 of step 7's 2^20 points again from the seed, derives them on the
   card, and runs `msm_sharded` (signed Pippenger, w = 14) with the ring
   and the gather on a 1-D mesh of 4 and "auto" on a (2, 2) ("dcn",
   "ici") mesh: every result on every rank must equal step 7's host
   check, with the four phase kernels launched; each core (the rank's
   partial and the fold, closed by a synchronize, the ranks started
   together) runs 3 times, and the fold alone, ring and gather. Case 2:
   the Straus `msm()` over 4 x 4096 of step 7's points on the 1-D mesh,
   against the host check, with the ladder launched. Case 3: adversarial
   shards (`adversarial_inputs`: a rank of only padding, one of only zero
   scalars, equal points and digits across the boundaries), Pippenger
   and Straus, ring and gather, against the host oracle. Prints each
   rank's core and fold ms, launches and peak memory, the card's name
   and power limit; four ranks share one card, so no scaling figure.
9. Probes (run after step 12, before the record of step 8): holds the four
   probe kernels against their twins at the tools' shapes (exact): dma_gather
   (N = 2^20, W = 128, M = 2^18, Cb = 4096 at depth 8, 2 and 16, and Cb =
   256 at depth 8; each with the GB/s of the rows read beside
   index_select's, which also writes them),
   fmul_chain on the three fields and mxu_chain on the two Montgomery ones
   at B = 8192 (on the 32-bit layer: by canonical values mod p; then the
   two chains on the same inputs, CHAIN_PAIRS pairs in turns, by the
   profiler's device ms a call), ladder_probe's five variants at B = 4096
   on 34 windows (by canonical coordinates mod p; the twins from the
   workers).
   Then runs the three tools' `main` (tpu_ecc_torch/tools/) at their
   default sizes, each with the counts set to 0 just before and read just
   after, and prints what each probe answered.
8. Prints the MSM core's points/s on each curve, the chain's adds/s on
   the nine curves, the build's (and the background build's), the
   sharded MSM's and the whole run's seconds, the card's name and
   power limit, a `kernels` JSON line (each kernel and build: its launches
   on its path or per tool run, its error against its twin, its time, its
   twin's time (a worker's on the CPU for the twins of step 10's holds),
   its bound and, for dma_gather, the time of index_select over the same
   rows), and last a JSON line with the device.

Any mismatch or fault raises, so the exit code is not 0. Without a CUDA
device it exits with code 1 and prints no result. The worker processes
end with the run.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA's data sheet)
INT8_OPS_PER_S = 1979e12        # H100 SXM dense int8 tensor cores (the same)
# CUDA C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0: 64 results per clock per SM for each class of 32-bit
# integer instruction (add, multiply and multiply-add, shift, compare,
# bitwise logic); an SM's four warp schedulers issue at most one warp
# instruction (32 lanes) each per clock, 128 lanes in all.
INT32_PER_CLK_PER_SM = 64
ISSUE_PER_CLK_PER_SM = 128
# IMAD.WIDE.U32 (the 32-bit layer's 32 x 32 -> 64 multiply-add) takes two
# slots of that 64-per-clock multiply pipe and one issue slot: the guide
# gives no rate for it, and tpu_ecc_torch/tools/bench_imad_wide.py measures
# 29.5 a clock an SM on an H100 (IMAD: 64.0), at most the 32 of two slots.
WIDE_SLOTS = 2
SMS = 132
VERIFY_RUNS = 7
RUNS = 7          # sign, derive and recover
SIGNS = 8192      # the ECDSA batch, in chunks of CHUNK
CHUNK = 4096      # protocols/pipeline.py DEFAULT_CHUNK: the lanes of a core call's kernels
POINT_B = 8192    # the point-add chain's and the single point operations' lanes
SAMPLE = 256
MSM_POINTS = 1 << 20
MSM_RUNS = 5
MSM_W, MSM_LANES = 14, 8192       # msm()'s defaults at 2^20 points
STRAUS_POINTS = 4096
# the kernels of the main path, built for secp256k1
K256_KERNELS = ("padd", "pdouble", "padd_chain", "pow", "ladder", "genmul", "segscan",
                "fixup", "bucket_reduce", "horner")
# the kernels of the P-256 path (the MSM's are built for secp256k1 only)
P256_KERNELS = ("padd", "pdouble", "padd_chain", "pow", "ladder", "genmul")
GATHER_N, GATHER_W, GATHER_M, GATHER_CB = 1 << 20, 128, 1 << 18, 1 << 12
PROBE_B, LADDER_B = 8192, 4096      # the multiply probes' lanes, the ladder's
CHAIN_REPS = 200                    # timed launches of a multiply chain (~0.1 ms each)
CHAIN_PAIRS = 10                    # fmul_chain against mxu_chain, in turns


def row_name(name: str, target) -> str:
    """A kernel's name in the record: bare for secp256k1 and for a kernel
    with no target, else with the curve or field of its build, as in
    `ladder[p256]` or `mxu_chain[k256mxu.fp]`."""
    return name if target is None or target.name == "secp256k1" else f"{name}[{target.name}]"


def row_names(targets) -> list:
    """The record's names of the kernels of targets = [(target, kernel)]."""
    return [row_name(name, t) for t, name in targets]


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def op_seconds(ops: dict, clock_hz: float) -> float:
    """The least time the card takes for `ops` (instructions by class, see
    kfe.INSTRUCTION_CLASSES and kfe.FE32_CLASSES, and int8 tensor-core
    operations under "int8"): the multiplies on the FMA pipe (an
    IMAD.WIDE.U32, "wide", as WIDE_SLOTS of them) and the logic on the ALU
    pipe each at 64 per clock per SM, all of them within the issue rate of
    128 per clock per SM, and the int8 operations at the dense int8 rate;
    the larger of the two parts."""
    wide = ops.get("wide", 0)
    per_sm = max((ops["imad"] + WIDE_SLOTS * wide) / INT32_PER_CLK_PER_SM,
                 ops["alu"] / INT32_PER_CLK_PER_SM,
                 (ops["imad"] + wide + ops["alu"] + ops["other"]) / ISSUE_PER_CLK_PER_SM)
    return max(per_sm / (SMS * clock_hz), ops.get("int8", 0) / INT8_OPS_PER_S)


def _time_ms(fn, reps: int) -> float:
    """Mean ms of fn() on the card over `reps` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def canonical(curve, limbs: torch.Tensor) -> torch.Tensor:
    """Steady point limbs [3, n, ...] -> each coordinate's canonical limbs
    (int64), for holding the 32-bit layer's kernels mod p."""
    from tpu_ecc_torch.ops import fe as F

    f = curve.field
    return torch.stack([F.fcanonical(F.fe_steady(f, limbs[c].to(torch.int64))).limbs
                        for c in range(3)], 0)


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def limb_diff(outs_k, outs_p) -> int:
    """The largest limb difference between two tuples of outputs."""
    return max(_max_diff(a, b) for a, b in zip(outs_k, outs_p))


def field_diff(spec):
    """The hold of pow, fmul_chain and mxu_chain: the largest difference
    between the canonical limbs of the kernel's element and the twin's."""
    from tpu_ecc_torch.ops import fe as F

    def canon(t):
        return F.fcanonical(F.fe_steady(spec, t.to(torch.int64))).limbs

    return lambda outs_k, outs_p: _max_diff(canon(outs_k[0]), canon(outs_p[0]))


def coord_diff(curve):
    """padd_chain's hold: the largest difference between the canonical limbs
    of each projective coordinate."""
    return lambda outs_k, outs_p: _max_diff(canonical(curve, outs_k[0]),
                                            canonical(curve, outs_p[0]))


def run_ends(key2: torch.Tensor) -> torch.Tensor:
    """The rows [C, *lanes] that end a run: key2[r + 1] != key2[r], or the
    last row."""
    ends = torch.ones_like(key2, dtype=torch.bool)
    ends[:-1] = key2[1:] != key2[:-1]
    return ends


def segscan_diff(curve, key2):
    """segscan's hold: `scanned` at the run-end rows and tail and lead by
    canonical coordinates, last_key exactly."""
    ends = run_ends(key2)

    def at_ends(sc):                     # [C, 3, n, *lanes] -> [3, n, ends]
        return canonical(curve, sc.movedim(0, 2)[:, :, ends])

    def diff(outs_k, outs_p):
        return max(_max_diff(at_ends(outs_k[0]), at_ends(outs_p[0])),
                   _max_diff(outs_k[1], outs_p[1]),
                   *(_max_diff(canonical(curve, a), canonical(curve, b))
                     for a, b in zip(outs_k[2:], outs_p[2:])))
    return diff


def ptxas_report(log: str) -> tuple:
    """(registers, stack and spill) of ptxas's -v report, each function's
    (a template kernel has one an instance) joined by " | "."""
    regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
            if "registers" in ln and "Used" in ln]
    stack = [ln.strip() for ln in log.splitlines() if "stack frame" in ln]
    return (" | ".join(regs) or "no ptxas report", " | ".join(stack))


def sass_class(op: str) -> str:
    """The class of one SASS opcode, as kfe.FE32_CLASSES sorts the 32-bit
    layer's instructions, plus gmma (a warpgroup MMA: HGMMA, IGMMA, ...),
    local, memory and control."""
    if "GMMA" in op:
        return "gmma"
    if op.startswith("IMAD.WIDE"):
        return "wide"
    if op.startswith(("IMAD", "IMUL")):
        return "imad"
    if op.startswith(("LOP3", "LOP", "ISETP", "SEL", "PLOP3", "P2R", "R2P", "IMNMX",
                      "POPC", "FLO", "PRMT", "BMSK", "VOTE")):
        return "alu"
    if op.startswith(("IADD3", "IADD", "VIADD", "LEA", "SHF", "SHL", "SHR", "MOV", "CS2R",
                      "HFMA2.MMA", "IABS", "UIADD3", "UMOV", "ULEA", "USHF", "UIMAD", "ULOP3",
                      "UISETP", "USEL")):
        return "other"                    # HFMA2.MMA, CS2R: the compiler's moves
    if op.startswith(("LDL", "STL")):
        return "local"
    if op.startswith(("LD", "ST", "ULDC", "ATOM", "RED")):
        return "memory"
    return "control"


SASS_FUNCTION = {"padd": ("padd_chain_kernel",),
                 "ladder": ("ladder_kernelILi32E|ladder_mont_kernel",),
                 "bucket_reduce": ("bucket_reduce_pair_kernelILb0E",),
                 "pow": ("pow_kernelI7Curve32E", "pow_kernelI8Scalar32E"),
                 "fixup": ("fixup_step_kernelILb0E",),
                 "ladder_probe": tuple(f"ladder_probe_kernelILi{v}E" for v in range(5))}
"""The functions whose SASS `sass_loop_counts` reads, where they are not
`<kernel>_kernel`, each of them in every build ("a|b": a in one build, b in
another): padd's, the chain's library at one add; the ladder's instance
for full blocks (csrc/ladder.cu: the
solinas or the Montgomery form); bucket_reduce's tree step from words to
words, one add; pow's instance for each field; fixup's step from words to
words, one add; ladder_probe's five variants (kernels.PROBE_VARIANTS)."""


def _cuobjdump(so: str) -> str:
    """cuobjdump -sass of the library `so`."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          check=True).stdout


def sass_loop_counts(text: str, function: str, so: str) -> list:
    """The instructions of each loop body of the function whose (mangled)
    name holds `function` in `text`, the cuobjdump -sass of the library
    `so` (the span from a backward branch's target to the branch, not
    counting the branch to itself that ends every function), by
    sass_class, the largest first (an outer loop's count holds its inner
    loops'); of the whole function where it has no loop. `function` may
    name alternatives, "a|b"; raises where the library has no function of
    that name."""
    insts, labels, pending, inside = [], {}, [], False
    for ln in text.splitlines():
        s = ln.strip()
        if "Function :" in s:
            inside = any(f in s for f in function.split("|"))
            continue
        if not inside:
            continue
        m = re.match(r"^(\.L_x_\d+):", s)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"^/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", s)
        if m:
            addr = int(m.group(1), 16)
            labels.update((lb, addr) for lb in pending)
            pending = []
            words = m.group(2).split()
            op = words[1] if words[0].startswith("@") else words[0]
            insts.append((addr, op, m.group(2)))
    if not insts:
        raise ValueError(f"{so}: no function named {function}")
    loops = []
    for addr, op, body in insts:
        if op.startswith("BRA"):
            lab = re.search(r"(\.L_x_\d+)", body)
            hexa = re.search(r"0x([0-9a-f]+)", body)
            target = labels.get(lab.group(1)) if lab else int(hexa.group(1), 16) if hexa else None
            if target is not None and target < addr:   # not the trailing self-branch
                loops.append((target, addr))
    bodies = []
    if not loops:
        loops = [(insts[0][0], insts[-1][0])]
    for lo, hi in sorted(set(loops), key=lambda t: t[0] - t[1]):
        counts = {}
        for addr, op, _ in insts:
            if lo <= addr <= hi:
                counts[sass_class(op)] = counts.get(sass_class(op), 0) + 1
        bodies.append(counts)
    return bodies


def _points(curve, seed: int, B: int, dev):
    """B steady points k*G for 8 random k, tiled (as bench.py builds them)."""
    from tpu_ecc_torch.ops import points as P
    from tpu_ecc_torch.utils import ec_host as H

    rng = np.random.default_rng(seed)
    pts = [H.aff_mul(curve, int(k), H.aff_generator(curve))
           for k in rng.integers(1, 2**31, 8)]
    pts = pts * (B // 8)
    Q = P.from_affine_ints(curve, [p[0] for p in pts], [p[1] for p in pts], dev)
    return P.point_limbs(P.steady(Q)), pts


def signatures(curve, count: int, distinct: int, seed: int, low_s: bool = True):
    """`count` (pub, z, sig, expected) tuples tiled from `distinct` valid
    signatures made by the host oracle; every fourth is tampered (z + 1 or
    the low bit of r flipped) and expected to fail."""
    from tpu_ecc_torch.utils import ec_host as H

    rng = np.random.default_rng(seed)
    base = []
    for _ in range(distinct):
        d, z, k = (int.from_bytes(rng.bytes(curve.scalar_bytes), "big") % (curve.n - 1) + 1
                   for _ in range(3))
        pub = H.aff_mul(curve, d, H.aff_generator(curve))
        base.append((pub, z, H.ecdsa_sign(curve, d, z, k, low_s=low_s)))
    pubs, zs, sigs, expect = [], [], [], []
    for i in range(count):
        pub, z, (r, s) = base[i % distinct]
        ok = True
        if i % 4 == 3:
            ok = False
            if (i // 4) % 2:
                z += 1
            else:
                r ^= 1
        pubs.append(pub)
        zs.append(z)
        sigs.append((r, s))
        expect.append(ok)
    return pubs, zs, sigs, expect


def measure_runs(label: str, fn, count: int, runs: int, must_launch, want=None):
    """Run fn() once to warm up, then `runs` times, each with the launch
    counts set to 0 just before and read just after. The warm-up must return
    `want` (where given) and every run what the warm-up returned, with the
    same launches, `must_launch` among them. Returns (result, items/s of
    each run, their median, the launches of a run)."""
    from tpu_ecc_torch.ops import kernels as K

    first = fn()
    if want is not None and first != want:
        bad = [i for i, (g, x) in enumerate(zip(first, want)) if g != x]
        raise AssertionError(f"{label} wrong at {len(bad)} lanes, e.g. {bad[:8]}")
    rates, launches = [], None
    for run in range(runs):
        torch.cuda.synchronize()
        K.reset_launches()
        t = time.perf_counter()
        got = fn()
        dt = time.perf_counter() - t
        if got != first:
            raise AssertionError(f"{label}: run {run} differs from the first")
        if launches is None:
            launches = dict(K.launches)
        elif K.launches != launches:
            raise AssertionError(f"{label} launches changed: {K.launches} != {launches}")
        rates.append(count / dt)
    for name in must_launch:
        if launches[name] <= 0:
            raise AssertionError(f"{label} did not launch the {name} kernel")
    return first, rates, float(np.median(rates)), launches


def msm_phase_ms(core) -> dict:
    """One run of core() (the MSM core) under torch.profiler -> {step: ms}
    for each `msm/<step>` range of msm_pippenger (parallel/msm.py PHASES),
    summed over the groups of windows: the range's span on the card's
    timeline ("span") and the device time of the torch operators' kernels
    inside it ("torch_kernels"; the hand-written kernels, launched through
    ctypes, carry no link to a range); beside them the device time of each
    hand-written kernel by its name ("by_name") and the device's busy time
    ("busy")."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_ecc_torch.ops import kernels as K
    from tpu_ecc_torch.parallel import msm as M

    def dev_us(e, total):
        names = ("device_time_total", "cuda_time_total") if total else (
            "self_device_time_total", "self_cuda_time_total")
        return next((getattr(e, n) for n in names if hasattr(e, n)), 0)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        core()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    out = {"span": {}, "torch_kernels": {p: 0.0 for p in M.PHASES}, "by_name": {},
           "busy": 0.0}
    for e in prof.key_averages():
        step = e.key.removeprefix("msm/")
        if step in M.PHASES and e.key != step:
            if e.device_type == cuda:
                out["span"][step] = dev_us(e, True) / 1e3
            else:
                out["torch_kernels"][step] += dev_us(e, True) / 1e3
        elif e.device_type == cuda and dev_us(e, False) > 0:
            out["busy"] += dev_us(e, False) / 1e3
            name = e.key.removeprefix("void ").split("(")[0].split("<")[0]
            name = name.removesuffix("_kernel")
            found = [k for k in K.KERNELS if name == k or name.startswith(f"{k}_")]
            if found:                   # the longest: padd_chain_kernel is not padd's
                kname = max(found, key=len)
                out["by_name"][kname] = out["by_name"].get(kname, 0.0) + dev_us(e, False) / 1e3
    return out


def ecdsa_oracle(curve, count: int) -> dict:
    """The host oracle's side of `ecdsa_phases` on `curve` (pure Python, so
    a CPU worker computes it while the card runs other steps): `count`
    (pub, z, sig, expected) from `signatures`; `count` (d, z) from a seed,
    min(SAMPLE, count // 8) sampled lanes, and at those lanes the host
    signature with the pure-Python RFC 6979 nonce (a curve that signs) and
    d*G."""
    from tpu_ecc_torch.protocols import ecdsa as E
    from tpu_ecc_torch.protocols import rfc6979
    from tpu_ecc_torch.utils import ec_host as H

    low_s = curve.name in E.LOW_S_CURVES
    t = time.perf_counter()
    pubs, zs, sigs, expect = signatures(curve, count, min(256, count // 4), 5, low_s)
    rng = np.random.default_rng(6)
    nb = curve.scalar_bytes
    ds = [int.from_bytes(rng.bytes(nb), "big") % (curve.n - 1) + 1 for _ in range(count)]
    zs_s = [int.from_bytes(rng.bytes(nb), "big") % curve.n for _ in range(count)]
    sample = [int(i) for i in rng.choice(count, min(SAMPLE, count // 8), replace=False)]
    G = H.aff_generator(curve)
    signed = {}
    if curve.name not in E.SIGN_UNSUPPORTED:
        for i in sample:
            k = rfc6979.generate_k(curve.n, ds[i], zs_s[i].to_bytes(nb, "big"),
                                   E.CURVE_HASH[curve.name])
            signed[i] = H.ecdsa_sign(curve, ds[i], zs_s[i], k, low_s=low_s)
    return {"pubs": pubs, "zs": zs, "sigs": sigs, "expect": expect, "ds": ds, "zs_s": zs_s,
            "sample": sample, "signed": signed,
            "derived": {i: H.aff_mul(curve, ds[i], G) for i in sample},
            "seconds": time.perf_counter() - t}


def ecdsa_phases(curve, count: int, verify_runs: int, runs: int, oracle) -> dict:
    """Steps 3 and 4 on `curve`: verify `count` signatures (a quarter
    tampered) `verify_runs` times; sign `count` (d, z), derive their keys,
    verify every signature under them and recover them, `runs` times each
    (a curve that only verifies, P-192: derive alone), with
    min(SAMPLE, count // 8) sampled lanes held against the host oracle
    (`oracle`: the future of `ecdsa_oracle` that a CPU worker computes).
    Returns the median rates and the launches of one run of each."""
    from tpu_ecc_torch.ops import scalarmul as SM
    from tpu_ecc_torch.protocols import ecdsa as E

    signs = curve.name not in E.SIGN_UNSUPPORTED
    chunks = -(-count // CHUNK)
    print(f"verify: {curve.name}, {count} signatures in {chunks} chunk(s)")
    t = time.perf_counter()
    o = oracle.result()
    pubs, zs, sigs, expect = o["pubs"], o["zs"], o["sigs"], o["expect"]
    print(f"  host oracle made the signatures and the sampled lanes in {o['seconds']:.1f} s "
          f"on a CPU worker; waited {time.perf_counter() - t:.1f} s for them")
    _, rates_v, verify_rate, verify_launches = measure_runs(
        "verify_batch", lambda: E.verify_batch(curve, pubs, zs, sigs), len(sigs),
        verify_runs, ("pow", "ladder"), want=expect)
    print(f"  {sum(expect)} valid and {len(expect) - sum(expect)} tampered, all as "
          f"expected in each of {verify_runs} runs; verifies/s median {verify_rate:.1f}, "
          f"runs {[round(r, 1) for r in rates_v]}; launches per run {verify_launches}")
    torch.cuda.synchronize()

    ds, zs_s, sample = o["ds"], o["zs_s"], o["sample"]
    out = {"verify": verify_rate, "verify_launches": verify_launches, "sign": None,
           "sign_launches": None, "recover": None}
    if signs:
        print(f"sign: {curve.name}, {count} (d, z) in {chunks} chunk(s), RFC 6979 nonces")
        signed, rates_s, out["sign"], out["sign_launches"] = measure_runs(
            "sign_batch", lambda: E.sign_batch(curve, ds, zs_s), count, runs, ("genmul", "pow"))
        for i in sample:                # nonces from the pure-Python RFC 6979
            if signed[i][:2] != o["signed"][i]:
                raise AssertionError(f"sign_batch lane {i} disagrees with the host oracle")
        print(f"  {len(sample)} sampled lanes equal the host oracle; signs/s median "
              f"{out['sign']:.1f}, runs {[round(r, 1) for r in rates_s]}; launches per run "
              f"{out['sign_launches']}")
    pubs_d, rates_d, out["derive"], out["derive_launches"] = measure_runs(
        "derive_public_batch", lambda: SM.derive_public_batch(curve, ds), count, runs,
        ("genmul", "pow"))
    for i in sample:
        if pubs_d[i] != o["derived"][i]:
            raise AssertionError(f"derive_public_batch lane {i} disagrees with the host oracle")
    print(f"  derive: {len(sample)} sampled lanes equal the host oracle; derives/s median "
          f"{out['derive']:.1f}, runs {[round(r, 1) for r in rates_d]}; launches per run "
          f"{out['derive_launches']}")
    if signs:
        if E.verify_batch(curve, pubs_d, zs_s, [(r, s) for r, s, _ in signed]) != [True] * count:
            raise AssertionError("a signature of sign_batch fails verify_batch")
        _, rates_r, out["recover"], recover_launches = measure_runs(
            "recover_batch", lambda: E.recover_batch(curve, zs_s, signed), count, runs,
            ("ladder", "pow"), want=pubs_d)
        print(f"  all {count} signatures verify under the derived keys, and recover_batch "
              f"gives back every key; recovers/s median {out['recover']:.1f}, runs "
              f"{[round(r, 1) for r in rates_r]}; launches per run {recover_launches}")
    torch.cuda.synchronize()
    return out


# the SM2 and bign vectors (copied in: the script imports nothing of
# tpu_ecc): GB/T 32918.5 appendix A's key; an OpenSSL SM2 signature under a
# custom identifier (sm2/tests/sm2dsa.rs:16-31); bign256/tests/dsa.rs:16-25
SM2_GBT_D = 0x3945208F7B2144B13F36E38AC6D39F95889393692860B51A42FB81EF4DF7C5B8
SM2_GBT_PUB = (0x09F9DF311E5421A150DD7D161E4BC5C672179FAD1833FC076BB08FF356F35020,
               0xCCEA490CE26775A52DC6EA718CC1AA600AED05FBF35E084A6632F6072DA9AD13)
SM2_SSL_PUB = (0x08D77AE04C01CC4C1104360DD8AF6B6F7DF334283D7C1A6AFD5652407B87BEE5,
               0x014E2A57C36C150D16324DC664E31E6432359609C4E79847A5B161C8C7364C8A)
SM2_SSL_ID = b"example@rustcrypto.org"
SM2_SSL_SIG = (0xD1DCCCEDD9FB785E0F67C16B7C52901625C0B69DE9BCA2144ACC7BE713CAD2FC,
               0xF7D1EAE6E3A157B36C65F672F738CA8B46298BF149A6510072C431B49CD88B1C)
BIGN_PUB = bytes.fromhex(
    "04D07F8590A8F77BF84F1EF10C6DE44CF5DDD52B4C9DE4CE3FE0799D1750561ABD"
    "909AD9B92A4DB89A4A050959DA2E0C1926281B466D68913417C8E86103A6C67A")
BIGN_SIG = bytes.fromhex(
    "63F59C523FF1780851143114FFBC5C139BE81FF88F9D7F7FE209A6914198044C"
    "2A41D37B8439AAB42983FDB04AC2C326")


def _launched(label: str, fn, must_launch):
    """fn() with the counts set to 0 just before and read just after:
    (its result, the launches of ladder, genmul and pow, its seconds);
    each of `must_launch` must have launched."""
    from tpu_ecc_torch.ops import kernels as K

    torch.cuda.synchronize()
    K.reset_launches()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    got = {name: K.launches[name] for name in ("ladder", "genmul", "pow")}
    if any(got[name] <= 0 for name in must_launch):
        raise AssertionError(f"{label} did not launch {must_launch}: {got}")
    return out, got, dt


def sm2_bign_phase(count: int) -> dict:
    """SM2-DSA and bign-DSA on the card, on the sm2 and bign256 builds,
    `count` keys and messages from a seed. SM2: e = SM3(Z_A || M) under
    the keys derived on the card; sign_batch at the caller's k equal, lane
    by lane, to the host formula r = (e + x1) mod n, s = (1 + d)^-1 (k - r
    d) mod n; verify_batch of every signature true. bign: sign_batch
    (belt-hash nonces) and verify_batch of every signature under the
    derived keys true. The vectors (GB/T 32918.5's key and its RFC 6979
    signature, the OpenSSL signature under its identifier, bign256's
    reference signature) accepted and, each with a bit flipped, refused.
    Prints the launches of ladder, genmul and pow each protocol's sign and
    verify made; returns them."""
    from tpu_ecc_torch.curves.specs import get_curve
    from tpu_ecc_torch.ops import scalarmul as SM
    from tpu_ecc_torch.protocols import bign, sm2
    from tpu_ecc_torch.utils import ec_host as H
    from tpu_ecc_torch.utils.bigint import be_bytes_to_int

    out = {}
    c = get_curve("sm2")
    n = c.n
    rng = np.random.default_rng(41)
    ds, ks = ([int.from_bytes(rng.bytes(40), "big") % (n - 1) + 1 for _ in range(count)]
              for _ in range(2))
    msgs = [rng.bytes(int(rng.integers(0, 200))) for _ in range(count)]
    pubs = SM.derive_public_batch(c, ds)
    es = [be_bytes_to_int(e) for e in sm2.hash_msg_batch(c, pubs, msgs)]
    sigs, sign_l, sign_s = _launched("SM2 sign_batch", lambda: sm2.sign_batch(c, ds, es, k_ints=ks),
                                     ("genmul", "pow"))
    G = H.aff_generator(c)
    for i, (d, e, k) in enumerate(zip(ds, es, ks)):
        r = (e + H.aff_mul(c, k, G)[0]) % n
        if sigs[i] != (r, pow(1 + d, -1, n) * (k - r * d) % n):
            raise AssertionError(f"SM2 sign_batch lane {i} disagrees with the host formula")
    ok, verify_l, verify_s = _launched("SM2 verify_batch",
                                       lambda: sm2.verify_batch(c, pubs, es, sigs),
                                       ("ladder", "pow"))
    if ok != [True] * count:
        raise AssertionError("an SM2 signature of sign_batch fails verify_batch")
    sk = sm2.SigningKey(c, SM2_GBT_D)
    if sk.public_point() != SM2_GBT_PUB:
        raise AssertionError("SM2: the GB/T 32918.5 key's public point is wrong")
    r, s = sk.sign(b"message digest")
    vk, ssl = sk.verifying_key(), sm2.VerifyingKey(c, SM2_SSL_PUB, ident=SM2_SSL_ID)
    got = [vk.verify(b"message digest", r, s), vk.verify(b"message digest", r, s ^ 1),
           ssl.verify(b"testing", *SM2_SSL_SIG),
           ssl.verify(b"testing", SM2_SSL_SIG[0] ^ 1, SM2_SSL_SIG[1])]
    if got != [True, False, True, False]:
        raise AssertionError(f"SM2 vectors: accepted/refused {got}")
    out["sm2"] = {"sign": sign_l, "verify": verify_l}
    print(f"SM2-DSA, {count} messages: (r, s) at the caller's k equal the host formula on "
          f"every lane ({sign_s:.2f} s), all verify ({verify_s:.2f} s); the GB/T and OpenSSL "
          f"vectors accepted, their bit flips refused; launches sign {sign_l}, verify "
          f"{verify_l}")

    c = get_curve("bign256")
    ds = [int.from_bytes(rng.bytes(40), "big") % (c.n - 1) + 1 for _ in range(count)]
    pubs = SM.derive_public_batch(c, ds)
    sigs, sign_l, sign_s = _launched("bign sign_batch", lambda: bign.sign_batch(c, ds, msgs),
                                     ("genmul", "pow"))
    ok, verify_l, verify_s = _launched("bign verify_batch",
                                       lambda: bign.verify_batch(c, pubs, msgs, sigs),
                                       ("ladder", "pow"))
    if ok != [True] * count:
        raise AssertionError("a bign signature of sign_batch fails verify_batch")
    bad = bytearray(BIGN_SIG)
    bad[5] ^= 1
    vk = bign.VerifyingKey.from_sec1_bytes(BIGN_PUB)
    got = [vk.verify(b"testing", BIGN_SIG), vk.verify(b"testing", bytes(bad))]
    if got != [True, False]:
        raise AssertionError(f"bign vector: accepted/refused {got}")
    out["bign"] = {"sign": sign_l, "verify": verify_l}
    print(f"bign-DSA, {count} messages: signed on the card ({sign_s:.2f} s), all verify on the "
          f"card ({verify_s:.2f} s); the reference vector accepted, its bit flip refused; "
          f"launches sign {sign_l}, verify {verify_l}")
    return out


# the launches of ladder, genmul and pow that one core call of each new
# protocol makes (each batch is one chunk of CHUNK lanes)
PROTOCOL_LAUNCHES = {
    "schnorr sign": {"ladder": 0, "genmul": 2, "pow": 2},
    "schnorr xonly": {"ladder": 0, "genmul": 1, "pow": 1},
    "schnorr verify": {"ladder": 1, "genmul": 0, "pow": 2},
    "ecdh": {"ladder": 1, "genmul": 0, "pow": 1},
    "h2c secp256k1": {"ladder": 0, "genmul": 0, "pow": 7},
    "h2c": {"ladder": 0, "genmul": 0, "pow": 5},
}
SIGN_RUNS = 3           # the Schnorr batch, signed this many times


def load_vectors(name: str) -> dict:
    """tests/vectors/<name> of the checkout that holds this script (the
    BIP340 and RFC 9380 vectors; the script imports nothing of tpu_ecc or of
    the JAX package's tests)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "vectors", name)
    with open(path) as fh:
        return json.load(fh)


def bip340_sign_host(curve, d: int, msg: bytes, aux: bytes) -> bytes:
    """BIP340's reference signing algorithm in pure Python on the host
    oracle (hashlib and ec_host.aff_mul; variable-time: test data only)."""
    import hashlib

    from tpu_ecc_torch.utils import ec_host as H

    def tagged(tag: str, data: bytes) -> bytes:
        th = hashlib.sha256(tag.encode()).digest()
        return hashlib.sha256(th + th + data).digest()

    n, G = curve.n, H.aff_generator(curve)
    px, py = H.aff_mul(curve, d, G)
    d = n - d if py & 1 else d
    t = d ^ int.from_bytes(tagged("BIP0340/aux", aux), "big")
    pb = px.to_bytes(32, "big")
    k = int.from_bytes(tagged("BIP0340/nonce", t.to_bytes(32, "big") + pb + msg), "big") % n
    rx, ry = H.aff_mul(curve, k, G)
    k = n - k if ry & 1 else k
    rb = rx.to_bytes(32, "big")
    e = int.from_bytes(tagged("BIP0340/challenge", rb + pb + msg), "big") % n
    return rb + ((k + e * d) % n).to_bytes(32, "big")


def _expect_launches(label: str, got: dict, key: str) -> None:
    if got != PROTOCOL_LAUNCHES[key]:
        raise AssertionError(f"{label} launched {got}, not {PROTOCOL_LAUNCHES[key]}")


def schnorr_phase() -> dict:
    """Step 11a, BIP340 on secp256k1 on the card: the sign vectors 0-3 byte
    for byte; the verify vectors 0-14 and a tampered signature, each
    boolean as the vector says; CHUNK random (d, msg, aux) from a seed
    signed SIGN_RUNS times, the same bytes each run, a SAMPLE-lane sample
    equal to the pure-Python signer (`bip340_sign_host`), every signature
    verifying under `xonly_public_keys` and a quarter of them, tampered,
    refused exactly there. Each core call's launches must equal
    PROTOCOL_LAUNCHES. Returns the launches and rates."""
    from tpu_ecc_torch.curves.specs import get_curve
    from tpu_ecc_torch.protocols import schnorr
    from tpu_ecc_torch.utils import ec_host as H

    c = get_curve("secp256k1")
    n, G = c.n, H.aff_generator(c)
    bip = load_vectors("bip340.json")
    sv = bip["sign"]
    ds = [int(v["seckey"], 16) for v in sv]
    msgs = [bytes.fromhex(v["msg"]) for v in sv]
    sigs = [bytes.fromhex(v["sig"]) for v in sv]
    got = schnorr.sign_batch(c, ds, msgs, [bytes.fromhex(v["aux_rand"]) for v in sv])
    if got != sigs:
        raise AssertionError("Schnorr sign_batch differs from the BIP340 sign vectors")
    bad = bytearray(sigs[0])
    bad[-1] ^= 1
    pxs = [H.aff_mul(c, d, G)[0] for d in ds] + [H.aff_mul(c, ds[0], G)[0]]
    msgs, sigs = msgs + msgs[:1], sigs + [bytes(bad)]
    expect = [True] * len(sv) + [False]
    for v in bip["verify"]:
        pxs.append(int(v["pubkey"], 16))
        msgs.append(bytes.fromhex(v["msg"]))
        sigs.append(bytes.fromhex(v["sig"]))
        expect.append(v["valid"])
    got = schnorr.verify_batch(c, pxs, msgs, sigs)
    if got != expect:
        raise AssertionError(f"Schnorr verify_batch on the BIP340 vectors: {got} != {expect}")

    rng = np.random.default_rng(51)
    ds = [int.from_bytes(rng.bytes(32), "big") % (n - 1) + 1 for _ in range(CHUNK)]
    msgs = [rng.bytes(32) for _ in range(CHUNK)]
    auxs = [rng.bytes(32) for _ in range(CHUNK)]
    first, sign_s = None, []
    for run in range(SIGN_RUNS):
        sigs, sign_l, s = _launched("Schnorr sign_batch",
                                    lambda: schnorr.sign_batch(c, ds, msgs, auxs), ("genmul", "pow"))
        _expect_launches("Schnorr sign_batch", sign_l, "schnorr sign")
        if first is None:
            first = sigs
        elif sigs != first:
            raise AssertionError(f"Schnorr sign_batch run {run} differs from the first")
        sign_s.append(s)
    sample = [int(i) for i in rng.choice(CHUNK, SAMPLE, replace=False)]
    for i in sample:
        if first[i] != bip340_sign_host(c, ds[i], msgs[i], auxs[i]):
            raise AssertionError(f"Schnorr sign_batch lane {i} disagrees with the host signer")
    pks, xonly_l, xonly_s = _launched("xonly_public_keys",
                                      lambda: schnorr.xonly_public_keys(c, ds), ("genmul", "pow"))
    _expect_launches("xonly_public_keys", xonly_l, "schnorr xonly")
    if any(pks[i] != H.aff_mul(c, ds[i], G)[0] for i in sample[:16]):
        raise AssertionError("xonly_public_keys disagrees with the host oracle")
    t_msgs, t_sigs, expect = list(msgs), list(first), []
    for i in range(CHUNK):
        expect.append(i % 4 != 3)
        if i % 4 == 3:              # flip a bit of r, of s or of the message
            kind = (i // 4) % 3
            if kind == 2:
                t_msgs[i] = bytes([msgs[i][0] ^ 1]) + msgs[i][1:]
            else:
                sig = bytearray(first[i])
                sig[5 if kind == 0 else 40] ^= 4
                t_sigs[i] = bytes(sig)
    ok, verify_l, verify_s = _launched("Schnorr verify_batch",
                                       lambda: schnorr.verify_batch(c, pks, t_msgs, t_sigs),
                                       ("ladder", "pow"))
    _expect_launches("Schnorr verify_batch", verify_l, "schnorr verify")
    if ok != expect:
        bad = [i for i, (g, x) in enumerate(zip(ok, expect)) if g != x]
        raise AssertionError(f"Schnorr verify_batch wrong at {len(bad)} lanes, e.g. {bad[:8]}")
    out = {"sign": sign_l, "xonly": xonly_l, "verify": verify_l,
           "signs/s": [CHUNK / s for s in sign_s], "verifies/s": CHUNK / verify_s}
    print(f"Schnorr (BIP340), secp256k1: sign vectors 0-3 byte-equal, verify vectors 0-14 and "
          f"a tampered one as expected; {CHUNK} random lanes signed {SIGN_RUNS} times, the same "
          f"bytes each run, {SAMPLE} sampled lanes equal the host signer; all verify under "
          f"xonly_public_keys ({xonly_s:.3f} s), the {CHUNK // 4} tampered lanes refused; "
          f"signs/s {[round(r, 1) for r in out['signs/s']]}, verifies/s "
          f"{out['verifies/s']:.1f} (one run each, host-bound); launches sign {sign_l}, "
          f"xonly {xonly_l}, verify {verify_l}")
    return out


def ecdh_phase(hold, dev) -> dict:
    """Step 11b, ECDH on secp256k1 and P-256 on the card, CHUNK key pairs
    from a seed each: both sides agree on every lane, a SAMPLE-lane sample
    equals the host oracle's x((a*b mod n)*G), and off-curve, x >= p and d
    = n lanes give None beside a good lane; EphemeralSecret and its
    extract. The secp256k1 call's ladder (GLV, T = 1, a shape of its own)
    is held against its twin on the card by canonical coordinates. Each
    core call's launches must equal PROTOCOL_LAUNCHES."""
    from tpu_ecc_torch.curves.specs import get_curve
    from tpu_ecc_torch.ops import kernels as K
    from tpu_ecc_torch.ops import points as P
    from tpu_ecc_torch.ops import scalarmul as SM
    from tpu_ecc_torch.protocols import ecdh
    from tpu_ecc_torch.utils import ec_host as H

    rng = np.random.default_rng(52)
    out = {}
    for name in ("secp256k1", "p256"):
        c = get_curve(name)
        n, p, G = c.n, c.p, H.aff_generator(c)
        da, db = ([int.from_bytes(rng.bytes(32), "big") % (n - 1) + 1 for _ in range(CHUNK)]
                  for _ in range(2))
        pa, pb = SM.derive_public_batch(c, da), SM.derive_public_batch(c, db)
        sab, ab_l, ab_s = _launched(f"ECDH {name}", lambda: ecdh.diffie_hellman_batch(c, da, pb),
                                    ("ladder", "pow"))
        _expect_launches(f"ECDH {name}", ab_l, "ecdh")
        sba = ecdh.diffie_hellman_batch(c, db, pa)
        if None in sab or sab != sba:
            raise AssertionError(f"ECDH {name}: the two sides disagree")
        for i in rng.choice(CHUNK, SAMPLE, replace=False):
            if sab[i] != H.aff_mul(c, da[i] * db[i] % n, G)[0]:
                raise AssertionError(f"ECDH {name} lane {i} disagrees with the host oracle")
        good = H.aff_mul(c, 7, G)
        peers = [good, (good[0], (good[1] + 1) % p), (good[0] + p, good[1]), good]
        got = ecdh.diffie_hellman_batch(c, [da[0]] * 3 + [n], peers)
        if got != [H.aff_mul(c, da[0] * 7 % n, G)[0], None, None, None]:
            raise AssertionError(f"ECDH {name}: the adversarial lanes gave {got}")
        a = ecdh.EphemeralSecret(c, da[1])
        sa = a.diffie_hellman(pb[1])
        if (a.public_key() != pa[1] or sa.raw_secret_bytes() != sab[1].to_bytes(32, "big")
                or len(sa.extract()) != 32):
            raise AssertionError(f"ECDH {name}: EphemeralSecret disagrees with the batch")
        print(f"ECDH, {name}, {CHUNK} key pairs: both sides agree, {SAMPLE} sampled lanes equal "
              f"the host oracle, off-curve, x >= p and d = n give None; {CHUNK / ab_s:.1f} "
              f"agreements/s (one run, host-bound); launches {ab_l}")
        out[name] = {"launches": ab_l, "rate": CHUNK / ab_s}
        if name == "secp256k1":
            Q = P.from_affine_ints(c, [q[0] for q in pb], [q[1] for q in pb], dev)
            bases, mag, neg = SM.ladder_inputs([(Q, SM.pack_scalars(c, da, dev))], glv=True)
            hold("ladder", f"ECDH glv T=1 B={CHUNK}",
                 lambda: K.ladder(c, bases, mag, neg, glv=True),
                 Twin(None, dev, "ladder_plain", c, bases, mag, neg, glv=True), 3,
                 compare=coord_diff(c), block=K.ladder_lanes(1, c), T=1, nw=mag.shape[0],
                 glv=True)
    return out


def h2c_phase(hold, dev) -> dict:
    """Step 11c, hash-to-curve (RFC 9380) on the card: the final points of
    the four suites' vectors exactly; CHUNK random messages from a seed on
    secp256k1 and P-256, every point on the curve and a SAMPLE-lane sample
    equal to the same call with device="cpu"; pow at the SSWU exponent e =
    (p - 3)/4 held against its twin on P-384 and P-521 at B = WIDE_COUNT by
    canonical values. Each map call's launches must equal
    PROTOCOL_LAUNCHES."""
    from tpu_ecc_torch.curves.specs import get_curve
    from tpu_ecc_torch.ops import fe as F
    from tpu_ecc_torch.ops import kernels as K
    from tpu_ecc_torch.protocols import hash2curve
    from tpu_ecc_torch.utils import ec_host as H

    out = {}
    for name, suite in load_vectors("rfc9380_h2c.json")["suites"].items():
        c = get_curve(name)
        msgs = [case["msg"].encode() for case in suite["cases"]]
        got, l, _ = _launched(f"hash_to_curve {name}",
                              lambda: hash2curve.hash_to_curve(c, msgs, suite["dst"].encode()),
                              ("pow",))
        _expect_launches(f"hash_to_curve {name}", l,
                         "h2c secp256k1" if name == "secp256k1" else "h2c")
        want = [(int(case["x"], 16), int(case["y"], 16)) for case in suite["cases"]]
        if got != want:
            raise AssertionError(f"hash_to_curve {name} differs from RFC 9380's vectors")
        out[name] = {"launches": l}
    print(f"hash_to_curve: the RFC 9380 vectors of {list(out)} equal; pow launches a call "
          f"{[v['launches']['pow'] for v in out.values()]}")
    rng = np.random.default_rng(53)
    dst = b"QUUX-V01-CS02-with-secp256k1_XMD:SHA-256_SSWU_RO_"
    for name in ("secp256k1", "p256"):
        c = get_curve(name)
        msgs = [rng.bytes(int(rng.integers(0, 100))) for _ in range(CHUNK)]
        got, l, s = _launched(f"hash_to_curve {name}",
                              lambda: hash2curve.hash_to_curve(c, msgs, dst), ("pow",))
        if not all(H.on_curve(c, q) for q in got):
            raise AssertionError(f"hash_to_curve {name}: a point off the curve")
        sample = [int(i) for i in rng.choice(CHUNK, SAMPLE, replace=False)]
        t = time.perf_counter()
        cpu = hash2curve.hash_to_curve(c, [msgs[i] for i in sample], dst, device="cpu")
        cpu_s = time.perf_counter() - t
        if [got[i] for i in sample] != cpu:
            raise AssertionError(f"hash_to_curve {name} differs from device='cpu'")
        out[name]["rate"] = CHUNK / s
        print(f"  {name}, {CHUNK} messages: all on the curve, {SAMPLE} sampled lanes equal "
              f"device='cpu' ({cpu_s:.1f} s there); {CHUNK / s:.1f} hashes/s (one run, "
              f"host-bound); launches {l}")
    for name in ("p384", "p521"):
        c = get_curve(name)
        spec = c.field
        e = (spec.p - 3) // 4
        xs = [int.from_bytes(rng.bytes(spec.bits // 8 + 8), "big") % spec.p
              for _ in range(WIDE_COUNT)]
        x = F.fsteady(F.fe_from_ints(spec, xs, dev)).limbs
        hold("pow", f"{spec.name} e=(p-3)/4 B={WIDE_COUNT}", lambda: K.fpow(spec, x, e),
             Twin(None, dev, "fpow_plain", spec, x, e), 10,
             c=c, compare=field_diff(spec), block=K.POW_LANES, field=0, e=e)
    return out


def chain_phase(curve, a_l, b_l, a_pts, b_pts):
    """Step 5 on `curve`: padd_chain adds/s at B = POINT_B, repeat 16, by
    chain-length differencing (best of 3), and 8 lanes of the result held
    against the host oracle. Returns (adds/s, the chain's launches)."""
    from tpu_ecc_torch.ops import fe as F
    from tpu_ecc_torch.ops import kernels as K
    from tpu_ecc_torch.ops import points as P
    from tpu_ecc_torch.utils import ec_host as H

    B, repeat = POINT_B, 16
    print(f"headline: padd_chain, {curve.name}, B={B}, repeat {repeat}")
    a = P.point_from_limbs(curve, a_l)
    b = P.point_from_limbs(curve, b_l)
    K.reset_launches()
    out = P.point_limbs(P.padd_chain(a, b, repeat))
    add_rates = []
    for _ in range(3):
        times = []
        for count in (16, 80):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(count):
                out = K.padd_chain(curve, out, b_l, repeat)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        if times[1] > times[0]:
            add_rates.append((80 - 16) * repeat * B / (times[1] - times[0]))
    chain_launches = K.launches["padd_chain"]
    if chain_launches <= 0 or not add_rates:
        raise AssertionError("the headline chain did not run")
    total = 1 + 3 * (16 + 80)
    ax, ay, _ = P.to_affine(P.point_from_limbs(curve, out[:, :, :8]))
    x, y = F.fe_to_ints(ax), F.fe_to_ints(ay)
    for i in range(8):
        want = H.aff_add(curve, a_pts[i], H.aff_mul(curve, total * repeat, b_pts[i]))
        if (x[i], y[i]) != want:
            raise AssertionError(f"padd_chain lane {i} disagrees with the host oracle")
    print(f"  {max(add_rates):.6g} adds/s (best of {[f'{r:.6g}' for r in add_rates]}); "
          f"result checked against the host oracle")
    torch.cuda.synchronize()
    return max(add_rates), chain_launches


def point_op_inputs(curve, dev) -> tuple:
    """The single point operations' inputs on `curve`: (a, b limbs, a, b
    host points), POINT_B points each."""
    a_l, a_pts = _points(curve, 11, POINT_B, dev)
    b_l, b_pts = _points(curve, 12, POINT_B, dev)
    return a_l, b_l, a_pts, b_pts


def single_point_ops(curves, dev) -> dict:
    """`padd_points` and `pdouble_points` (the padd and pdouble kernels) at
    B = POINT_B on each curve, on `point_op_inputs`, the counts set to 0
    just before and read just after, 8 lanes held against the host oracle.
    Returns {curve name: {kernel: launches}}."""
    from tpu_ecc_torch.ops import fe as F
    from tpu_ecc_torch.ops import kernels as K
    from tpu_ecc_torch.ops import points as P
    from tpu_ecc_torch.utils import ec_host as H

    out = {}
    for curve in curves:
        a_l, b_l, a_pts, b_pts = point_op_inputs(curve, dev)
        a, b = P.point_from_limbs(curve, a_l), P.point_from_limbs(curve, b_l)
        torch.cuda.synchronize()
        K.reset_launches()
        s, d = K.padd_points(a, b), K.pdouble_points(a)
        torch.cuda.synchronize()
        out[curve.name] = {"padd": K.launches["padd"], "pdouble": K.launches["pdouble"]}
        for pt, want in ((s, [H.aff_add(curve, u, v) for u, v in zip(a_pts, b_pts)]),
                         (d, [H.aff_add(curve, u, u) for u in a_pts])):
            x, y, _ = P.to_affine(P.point_from_limbs(curve, P.point_limbs(pt)[..., :8]))
            if list(zip(F.fe_to_ints(x), F.fe_to_ints(y))) != want[:8]:
                raise AssertionError(f"padd_points/pdouble_points on {curve.name} "
                                     "disagree with the host oracle")
        if min(out[curve.name].values()) <= 0:
            raise AssertionError(f"the single point ops on {curve.name} did not launch")
        print(f"single point ops, {curve.name}, B={POINT_B}: padd_points and pdouble_points "
              f"equal the host oracle on 8 lanes; launches {out[curve.name]}")
    return out


def chain_pairs(spec, a, b) -> None:
    """fmul_chain against mxu_chain on the same inputs, CHAIN_PAIRS pairs in
    turns (each side first in every other pair), CHAIN_REPS launches each
    under torch.profiler: prints each side's median, range and wins in
    device ms a call and µs per chained multiply."""
    from tpu_ecc_torch.ops import kernels as K
    from tpu_ecc_torch.tools.devtime import device_ms

    fns = {"fmul_chain": lambda: K.fmul_chain(spec, a, b),
           "mxu_chain": lambda: K.mxu_chain(spec, a, b)}
    ms = {name: [] for name in fns}
    for r in range(CHAIN_PAIRS):
        for name in sorted(fns, reverse=r % 2 == 1):
            ms[name].append(device_ms(fns[name], CHAIN_REPS, name))
    wins = sum(m < f for m, f in zip(ms["mxu_chain"], ms["fmul_chain"]))
    print(f"  {spec.name}, device ms a call (us per chained mul) over {CHAIN_PAIRS} pairs in "
          "turns, by the profiler: " + ", ".join(
              f"{name} median {np.median(v):.4f} ({min(v):.4f}-{max(v):.4f}; "
              f"{1e3 * np.median(v) / K.CHAIN:.4f} us)" for name, v in ms.items())
          + f"; mxu_chain faster in {wins} of {CHAIN_PAIRS}")


def probe_ladder_inputs(curve, dev, pool) -> tuple:
    """ladder_probe's inputs at LADDER_B lanes (profile_ladder's) and its
    twins, which the workers of `pool` compute on the CPU from the end of
    step 1: {variant: Twin}. unroll and build return bare's values (the
    same selects and adds; unroll differs in compilation, build in a table
    no one reads), so their twin is bare's."""
    from tpu_ecc_torch.tools import profile_ladder

    bases, mag, neg = profile_ladder.inputs(curve, LADDER_B, dev)
    twins = {key: Twin(pool, dev, "ladder_probe_plain", curve, bases, mag, neg, key)
             for key in ("bare", "select", "negate")}
    return bases, mag, neg, {v: twins[v if v in twins else "bare"] for v in
                             ("negate", "bare", "unroll", "build", "select")}


def probes(hold, fields, ladder_in, dev) -> dict:
    """Step 9: each probe kernel against its twin at its tool's shapes
    (ladder_probe's inputs and twins from `probe_ladder_inputs`), then the
    three tools' main at their default sizes, the counts set to 0 just
    before each and read just after. Returns {(target, kernel): launches
    per tool run}."""
    from tpu_ecc_torch.curves.specs import get_curve
    from tpu_ecc_torch.ops import fe as F
    from tpu_ecc_torch.ops import kernels as K
    from tpu_ecc_torch.tools import bench_gather_probe, bench_mxu_mul, profile_ladder

    curve = get_curve("secp256k1")
    started = time.perf_counter()
    print("hold: the probe kernels at their tools' shapes")
    pay = bench_gather_probe.device_payload(GATHER_N, GATHER_W, dev)
    idx = torch.from_numpy(np.random.default_rng(1).permutation(GATHER_N)
                           .astype(np.int32)[:GATHER_M]).to(dev)
    # (Cb, depth): the tool's default first (the row's time), then the
    # other depths and the smaller chunks of the tool's last two lines
    for Cb, depth in ((GATHER_CB, 8), (GATHER_CB, 2), (GATHER_CB, 16), (256, 8)):
        ms, lib_ms = hold("dma_gather", f"N=2^20 W={GATHER_W} M=2^18 Cb={Cb} depth={depth}",
                          lambda: K.dma_gather(pay, idx, Cb, depth),
                          lambda: K.dma_gather_plain(pay, idx), 10, B=GATHER_W, c=None,
                          library=lambda: torch.index_select(pay, 0, idx), M=GATHER_M)
        rows_b = GATHER_M * GATHER_W * 4          # the rows read; index_select also writes them
        print(f"    rows read: dma_gather {rows_b / ms / 1e6:.1f} GB/s, index_select "
              f"{rows_b / lib_ms / 1e6:.1f} GB/s (it moves {2 * rows_b / lib_ms / 1e6:.1f} "
              f"GB/s, reading and writing each row)")
    del pay
    rng = np.random.default_rng(9)
    for spec in fields:
        vals = [int.from_bytes(rng.bytes(32), "big") % spec.p for _ in range(PROBE_B)]
        a = F.fe_from_ints(spec, vals, dev).limbs
        b = F.fe_from_ints(spec, vals[::-1], dev).limbs
        hold("fmul_chain", f"{spec.name} B={PROBE_B}", lambda: K.fmul_chain(spec, a, b),
             lambda: K.fmul_chain_plain(spec, a, b), CHAIN_REPS, c=spec,
             compare=field_diff(spec), block=K.FMUL_LANES)
        if spec.kind == "mont":
            hold("mxu_chain", f"{spec.name} B={PROBE_B}", lambda: K.mxu_chain(spec, a, b),
                 lambda: K.mxu_chain_plain(spec, a, b), CHAIN_REPS, c=spec,
                 compare=field_diff(spec))
            chain_pairs(spec, a, b)
    bases, mag, neg, twins = ladder_in
    for variant, twin in twins.items():          # the whole body first
        hold("ladder_probe", f"{variant} nw={profile_ladder.NW} B={LADDER_B}",
             lambda: K.ladder_probe(curve, bases, mag, neg, variant), twin, 3,
             compare=coord_diff(curve), block=K.PROBE_LANES, nw=profile_ladder.NW,
             variant=variant)
    torch.cuda.synchronize()

    print("tools: bench_gather_probe, bench_mxu_mul, profile_ladder at their default sizes")
    counts = {}
    K.reset_launches()
    gather = bench_gather_probe.main([])
    counts[None, "dma_gather"] = K.launches["dma_gather"]
    K.reset_launches()
    muls = bench_mxu_mul.main([])
    by_name = {f.name: f for f in fields}
    if sorted(res["field"] for res in muls) != sorted(by_name):
        raise AssertionError(f"bench_mxu_mul ran {[res['field'] for res in muls]}")
    for res in muls:                # the launches of each field's cases
        spec = by_name[res["field"]]
        for name in ("fmul_chain", "mxu_chain") if spec.kind == "mont" else ("fmul_chain",):
            counts[spec, name] = res["launches"].get(name, 0)
    K.reset_launches()
    ladder = profile_ladder.main([])
    counts[curve, "ladder_probe"] = K.launches["ladder_probe"]
    torch.cuda.synchronize()
    for (t, name), v in counts.items():
        if v <= 0:
            raise AssertionError(f"the tools did not launch {row_name(name, t)}")
    print(f"  launches per tool run: {({row_name(n, t): v for (t, n), v in counts.items()})}")

    take = gather["take"][GATHER_W]
    print(f"probe answers: gather at W={GATHER_W}: index_select {take / 1e6:.2f} Mrows/s "
          f"({take * 4 * GATHER_W / 1e9:.1f} GB/s); dma_gather at Cb={GATHER_CB}, its best "
          f"depth {max(gather['dma_gather'].values()) / 1e6:.2f} Mrows/s; at depth 8 by Cb "
          + ", ".join(f"{cb}: {r / 1e6:.2f}" for cb, r in gather["dma_gather_cb"].items())
          + " Mrows/s")
    for res in muls:
        if "mxu_chain_s" in res:
            print(f"  {res['field']}: per chained mul mxu_chain "
                  f"{res['mxu_chain_s'] / K.CHAIN * 1e6:.3f} us, fmul_chain "
                  f"{res['chain_s'] / K.CHAIN * 1e6:.3f} us")
    v = ladder["variants"]
    print(f"  ladder (ms): floor {v['bare'] * 1e3:.3f}, unroll "
          f"{(v['unroll'] - v['bare']) * 1e3:+.3f}, build {(v['build'] - v['bare']) * 1e3:+.3f}, "
          f"select {(v['select'] - v['build']) * 1e3:+.3f}, negate "
          f"{(v['negate'] - v['select']) * 1e3:+.3f}; padd_chain x16 "
          f"{ladder['padd_chain_s'] * 1e3:.3f}")
    print(f"  the probes took {time.perf_counter() - started:.1f} s")
    return counts


# the eleventh slice: the 32-bit layer at each curve's own word count
P384_KERNELS = K256_KERNELS          # P-384's path: all ten (the MSM's four too)
PHASE_KERNELS = ("segscan", "fixup", "bucket_reduce", "horner")
MSM_CURVES = ("p256", "sm2", "bign256", "p224", "p192", "bp256t1", "bp256r1", "bp384t1",
              "bp384r1", "p521")
"""The curves whose MSM phase kernels build in the background from the end
of step 1 (`msm_targets`) and are held after step 7, in this order: P-256,
then N = 8, 7 and 6, the Brainpool curves, P-521 (N = 17) last."""
MSM_CURVE_POINTS = 1 << 14   # their msm(): Pippenger's smallest size, 4096 lanes
P384_RUNS = 3                        # its runs of each entry point (no claim rests on them)
P384_MSM_POINTS = 1 << 16
WIDE_CURVES = ("p521", "p224", "p192", "sm2", "bign256", "bp256t1", "bp384t1", "bp256r1",
               "bp384r1")
WIDE_KERNELS = ("pow", "ladder", "genmul", "padd", "pdouble")
WIDE_COUNT = 256       # the new curves' ECDSA batch: their core calls' lanes and their holds'
TWIN_WORKERS = 4       # processes that compute the new curves' twins on the CPU
SASS_WIDE = {("p384", "ladder"), ("p384", "pow"), ("p521", "ladder"), ("p521", "pow"),
             *((c, k) for c in ("bp256t1", "bp256r1") for k in ("padd", "ladder", "genmul"))}
"""The wide builds whose SASS loop bodies phase 1 prints: P-384's and
P-521's, and bp256r1's point kernels beside their a = -3 twins on bp256t1's
field."""


def wide_targets(get_curve) -> list:
    """The builds of the other curves: P-384's path, and the five kernels of
    each of WIDE_CURVES (a = -3, and the generic a of the r1 curves)."""
    return ([(get_curve("p384"), n) for n in P384_KERNELS]
            + [(get_curve(c), n) for c in WIDE_CURVES for n in WIDE_KERNELS])


def msm_targets(get_curve) -> list:
    """The MSM phase kernels of MSM_CURVES (40 libraries), built in the
    background from the end of step 1."""
    return [(get_curve(c), n) for c in MSM_CURVES for n in PHASE_KERNELS]


def _timed_build(targets) -> tuple:
    """kernels.build_targets(targets) at niceness 10: (its reports, its
    seconds)."""
    from tpu_ecc_torch.ops import kernels as K

    t = time.perf_counter()
    reports = K.build_targets(targets, nice=10)
    return reports, time.perf_counter() - t


def _twin(plain: str, args: tuple, kw: dict) -> tuple:
    """kernels.<plain>(*args, **kw) (a plain twin): (its output, its
    seconds). In a worker process, on CPU tensors."""
    from tpu_ecc_torch.ops import kernels as K

    t = time.perf_counter()
    out = getattr(K, plain)(*args, **kw)
    if out.is_cuda:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _worker_init() -> None:
    torch.set_num_threads(1)


class Twin:
    """A hold's plain twin, kernels.<plain>(*args, **kw), computed ahead of
    its kernel: at once in this process on the card (pool None; step 2's,
    while the kernels build), or by a worker of `pool` on the CPU, on
    copies of the inputs. Calling it returns the output on `dev`;
    `seconds` is the twin's time."""

    def __init__(self, pool, dev, plain: str, *args, **kw):
        self.dev, self.fut = dev, None
        self.where = "" if pool is None else " on the CPU"
        if pool is None:
            self.out, self.seconds = _twin(plain, args, kw)
        else:
            cpu = tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)
            self.fut = pool.submit(_twin, plain, cpu, kw)

    def __call__(self):
        if self.fut is not None:
            (self.out, self.seconds), self.fut = self.fut.result(), None
        return self.out.to(self.dev)


def chain_inputs(c, dev) -> tuple:
    """The chain phase's inputs on curve c: (a, b limbs, a, b host points),
    POINT_B points each."""
    a_l, a_pts = _points(c, 1, POINT_B, dev)
    b_l, b_pts = _points(c, 2, POINT_B, dev)
    return a_l, b_l, a_pts, b_pts


def chain_hold(c, a_l, b_l, twin) -> tuple:
    """padd_chain's hold at the chain's shape (B = POINT_B, repeat 16) on
    curve c, for `run_holds`."""
    from tpu_ecc_torch.ops import kernels as K

    return ("padd_chain", f"{c.name} B={POINT_B} repeat=16",
            lambda: K.padd_chain(c, a_l, b_l, 16), twin, 20,
            dict(c=c, compare=coord_diff(c), block=32, repeat=16))


def step2_holds(curve, p256, p384, point_curves, dev, pool) -> tuple:
    """Step 2's holds, each twin computed at once on the card (`Twin`), so
    that they run while the kernels build, but the Straus shape's, which
    a worker of `pool` computes on the CPU: padd_chain at POINT_B lanes, repeat 16, on
    secp256k1, P-256 and P-384 (the chain phases' inputs); padd and
    pdouble at POINT_B on every point curve (the single point operations'
    inputs); on secp256k1 pow on both fields at B = CHUNK, the ladder with
    GLV at T = 2, without at T = 1 (65 windows) and at the Straus MSM's
    shape (T = 8 with GLV at the lanes msm() gives STRAUS_POINTS points),
    genmul at B = CHUNK (65 windows, random scalars plus 0 and n - 1); on
    P-256 and P-384 `curve_holds` at B = CHUNK. Returns (the holds, the
    chain phases' inputs by curve name)."""
    from tpu_ecc_torch.ops import fe as F
    from tpu_ecc_torch.ops import kernels as K
    from tpu_ecc_torch.ops import points as P
    from tpu_ecc_torch.ops import scalarmul as SM
    from tpu_ecc_torch.parallel import msm as M

    holds, chain_in = [], {}
    for c in (curve, p256, p384):
        chain_in[c.name] = a_l, b_l, _, _ = chain_inputs(c, dev)
        holds.append(chain_hold(c, a_l, b_l, Twin(None, dev, "padd_chain_plain", c, a_l, b_l, 16)))
    for c in point_curves:
        a_l, b_l, _, _ = point_op_inputs(c, dev)
        holds += [("padd", f"{c.name} B={POINT_B}", lambda c=c, a=a_l, b=b_l: K.padd(c, a, b),
                   Twin(None, dev, "padd_plain", c, a_l, b_l), 20,
                   dict(c=c, compare=coord_diff(c), block=32)),
                  ("pdouble", f"{c.name} B={POINT_B}", lambda c=c, a=a_l: K.pdouble(c, a),
                   Twin(None, dev, "pdouble_plain", c, a_l), 20,
                   dict(c=c, compare=coord_diff(c), block=32))]

    rng = np.random.default_rng(3)
    for spec, field in ((curve.scalar, 1), (curve.field, 0)):
        xs = [int.from_bytes(rng.bytes(32), "big") % spec.p for _ in range(CHUNK)]
        x = F.fsteady(F.fe_from_ints(spec, xs, dev)).limbs
        e = spec.p - 2
        holds.append(("pow", f"{spec.name} e=p-2 B={CHUNK}",
                      lambda spec=spec, x=x, e=e: K.fpow(spec, x, e),
                      Twin(None, dev, "fpow_plain", spec, x, e), 10,
                      dict(compare=field_diff(spec), block=K.POW_LANES, field=field, e=e)))
    Qs, _ = _points(curve, 4, CHUNK, dev)
    Q = P.point_from_limbs(curve, Qs)
    G = P.generator(curve, (CHUNK,), dev)
    ks = [SM.pack_scalars(curve, [int.from_bytes(rng.bytes(32), "big")
                                  for _ in range(CHUNK)], dev) for _ in range(2)]
    # the Straus MSM's shape: msm() at 4096 points runs 8 terms on 512 lanes
    sl = M._pick_lanes(STRAUS_POINTS, 8)
    straus = [(P.point_from_limbs(curve, _points(curve, 20 + t, sl, dev)[0]),
               SM.pack_scalars(curve, [int.from_bytes(rng.bytes(32), "big") for _ in range(sl)],
                               dev)) for t in range(8)]
    for label, T, glv, terms, bits, where in (
            (f"glv T=2 B={CHUNK}", 2, True, [(G, ks[0]), (Q, ks[1])], None, None),
            (f"T=1 B={CHUNK}", 1, False, [(Q, ks[0])], 256, None),
            (f"Straus glv T=8 B={sl}", 8, True, straus, None, pool)):
        bases, mag, neg = SM.ladder_inputs(terms, glv=glv, scalar_bits=bits)
        holds.append(("ladder", label,
                      lambda b=bases, m=mag, n=neg, g=glv: K.ladder(curve, b, m, n, glv=g),
                      Twin(where, dev, "ladder_plain", curve, bases, mag, neg, glv=glv), 3,
                      dict(compare=coord_diff(curve), block=K.ladder_lanes(T, curve), T=T,
                           nw=mag.shape[0], glv=glv)))
    kg = [0, curve.n - 1] + [int.from_bytes(rng.bytes(32), "big") for _ in range(CHUNK - 2)]
    mag_g, neg_g = SM.signed_digits(curve, SM.pack_scalars(curve, kg, dev))
    mag_g, neg_g = mag_g.flip(0), neg_g.flip(0)        # LSB window first
    tbl_g = SM._gen_table(curve, dev)
    holds.append(("genmul", f"nw={mag_g.shape[0]} B={CHUNK}",
                  lambda: K.genmul(curve, tbl_g, mag_g, neg_g),
                  Twin(None, dev, "genmul_plain", curve, tbl_g, mag_g, neg_g), 10,
                  dict(compare=coord_diff(curve), block=K.GENMUL_LANES, nw=mag_g.shape[0])))
    for c in (p256, p384):
        holds += curve_holds(c, CHUNK, dev, ("pow", "ladder", "genmul"))
    return holds, chain_in


def curve_holds(c, B: int, dev, kernels, pool=None) -> list:
    """The holds of curve c's builds at its path's shapes, each core call
    B lanes wide, by canonical values mod p: pow on both fields at e = p -
    2; the verify's (and recover's) two-term ladder without GLV on all the
    scalar's windows; the comb (genmul) on all its windows, on random
    scalars plus 0 and n - 1. `kernels` names which. Each twin is computed
    ahead (`Twin`): at once on the card, or with `pool` by a worker on the
    CPU. Returns the holds, [(name, label, kernel, twin, timed calls,
    hold's keywords)], for `run_holds`."""
    from tpu_ecc_torch.ops import fe as F
    from tpu_ecc_torch.ops import kernels as K
    from tpu_ecc_torch.ops import points as P
    from tpu_ecc_torch.ops import scalarmul as SM

    def twin(plain, *args):
        return Twin(pool, dev, plain, *args)

    rng = np.random.default_rng(31)
    out = []
    if "pow" in kernels:
        for spec, field in ((c.scalar, 1), (c.field, 0)):
            xs = [int.from_bytes(rng.bytes(spec.bits // 8 + 8), "big") % spec.p
                  for _ in range(B)]
            x = F.fsteady(F.fe_from_ints(spec, xs, dev)).limbs
            e = spec.p - 2
            out.append(("pow", f"{spec.name} e=p-2 B={B}",
                        lambda spec=spec, x=x, e=e: K.fpow(spec, x, e),
                        twin("fpow_plain", spec, x, e), 10,
                        dict(c=c, compare=field_diff(spec), block=K.POW_LANES, field=field, e=e)))
    if "ladder" in kernels:
        Qs, _ = _points(c, 4, B, dev)
        ks = [SM.pack_scalars(c, [int.from_bytes(rng.bytes(c.scalar_bytes), "big")
                                  for _ in range(B)], dev) for _ in range(2)]
        bases, mag, neg = SM.ladder_inputs([(P.generator(c, (B,), dev), ks[0]),
                                            (P.point_from_limbs(c, Qs), ks[1])])
        out.append(("ladder", f"{c.name} T=2 nw={mag.shape[0]} B={B}",
                    lambda: K.ladder(c, bases, mag, neg), twin("ladder_plain", c, bases, mag, neg),
                    3, dict(c=c, compare=coord_diff(c), block=K.ladder_lanes(2, c), T=2,
                            nw=mag.shape[0], glv=False)))
    if "genmul" in kernels:
        kg = [0, c.n - 1] + [int.from_bytes(rng.bytes(c.scalar_bytes), "big")
                             for _ in range(B - 2)]
        mag_g, neg_g = SM.signed_digits(c, SM.pack_scalars(c, kg, dev))
        mag_g, neg_g = mag_g.flip(0), neg_g.flip(0)        # LSB window first
        tbl_g = SM._gen_table(c, dev)
        out.append(("genmul", f"{c.name} nw={mag_g.shape[0]} B={B}",
                    lambda: K.genmul(c, tbl_g, mag_g, neg_g),
                    twin("genmul_plain", c, tbl_g, mag_g, neg_g), 10,
                    dict(c=c, compare=coord_diff(c), block=K.GENMUL_LANES, nw=mag_g.shape[0])))
    return out


def run_holds(hold, holds) -> None:
    for name, label, kern, plain, reps, kw in holds:
        hold(name, label, kern, plain, reps, **kw)
    torch.cuda.synchronize()


def msm_scalars(c, N: int, seed: int, lo: int = 0, hi: int | None = None) -> tuple:
    """(a_i, k_i) for i in [lo, hi) of step 7's N points P_i = a_i*G and
    full-width scalars k_i, made from `seed` (a rank of step 12 makes its
    own shard's)."""
    nb = c.scalar_bytes
    raw = np.random.default_rng(seed).bytes(2 * nb * N)
    rows = range(lo, N if hi is None else hi)
    a_i = [int.from_bytes(raw[2 * nb * i:2 * nb * i + nb], "big") % (c.n - 1) + 1 for i in rows]
    k_i = [int.from_bytes(raw[2 * nb * i + nb:2 * nb * (i + 1)], "big") % c.n for i in rows]
    return a_i, k_i


def msm_phase(hold, c, N: int, seed: int, dev, variants: bool, clock_hz: float,
              pool) -> dict:
    """Step 7 on curve c: N points P_i = a_i*G made on the card
    (derive_public_batch) and full-width k_i, from `seed`. Holds the four
    Pippenger phase kernels against their twins on the card at the shapes
    the first group of windows gives them (segscan signed, fixup,
    bucket_reduce without drop0 as the signed path runs it; with
    `variants` also segscan unsigned on 16 rows, bucket_reduce with drop0,
    fixup and bucket_reduce at the last group's 3 windows), by canonical
    coordinates. Then msm() (signed, w = MSM_W) must equal (sum a_i*k_i
    mod n)*G from one host aff_mul, with every phase kernel launched; the
    device core (packed tensors in, point out, closed by a synchronize)
    runs MSM_RUNS times. Returns the points, the scalars, the core, msm()'s
    launches, the core's median points/s, the host check and "horner": a
    function that holds horner on all the window sums against its twin,
    which a worker of `pool` computes on the CPU meanwhile, and prints its
    one-thread bound in both designs' counts; the caller runs it when it
    wants the twin, so that the twins of several curves may compute side by
    side."""
    from tpu_ecc_torch.ops import fe as F
    from tpu_ecc_torch.ops import kernels as K
    from tpu_ecc_torch.ops import scalarmul as SM
    from tpu_ecc_torch.parallel import msm as M
    from tpu_ecc_torch.utils import ec_host as H

    print(f"msm: {c.name}, {N} points a_i*G made on the card, full-width k_i")
    t = time.perf_counter()
    a_i, k_i = msm_scalars(c, N, seed)
    pts = SM.derive_public_batch(c, a_i)
    want = H.aff_mul(c, sum(a * k for a, k in zip(a_i, k_i)) % c.n, H.aff_generator(c))
    print(f"  points, scalars and the host check made in {time.perf_counter() - t:.1f} s")

    lanes = min(MSM_LANES, 1 << max(N.bit_length() - 3, 3))
    packed = M.pack(c, pts, k_i, lanes, dev)
    xs, ys = F.fe_steady(c.field, packed[0]), F.fe_steady(c.field, packed[1])
    payload, keys, negs, nbuck = M.pippenger_inputs(c, xs, ys, packed[2], packed[3], MSM_W,
                                                    signed=True)
    nwin = keys.shape[0]
    per = min(max(1, M.GROUP_BYTES // payload[:1].nbytes // N), nwin)
    skey, key2, val2, neg2 = M.sorted_windows(payload, keys[:per], negs[:per], lanes)
    C, width = key2.shape[0], key2[0].numel()
    seg_adds = int((key2[1:] == key2[:-1]).sum() + (key2[0] == nbuck).sum())
    seg_ends = int(run_ends(key2).sum())
    print(f"hold: the Pippenger phases on {c.name} at the first group of {per} of {nwin} "
          f"windows (C = {C}, L = {lanes}, nbuck = {nbuck})")
    print(f"  segscan: {seg_adds} adds, {seg_ends} run-end rows of {C * width}")
    hold("segscan", f"{c.name} signed C={C} lanes={per}x{lanes}",
         lambda: K.segscan(c, key2, val2, nbuck, neg2),
         lambda: K.segscan_plain(c, key2, val2, nbuck, neg2), 3, c=c, B=width,
         compare=segscan_diff(c, key2), block=128, C=C, adds=seg_adds, ends=seg_ends,
         signed=True)
    if variants:
        hold("segscan", f"{c.name} unsigned C=16 lanes={per}x{lanes}",
             lambda: K.segscan(c, key2[:16], val2[:16], nbuck),
             lambda: K.segscan_plain(c, key2[:16], val2[:16], nbuck), 3, c=c, B=width,
             compare=segscan_diff(c, key2[:16]), C=16,
             adds=int((key2[1:16] == key2[:15]).sum() + (key2[0] == nbuck).sum()),
             ends=int(run_ends(key2[:16]).sum()), signed=False)
    scanned, last_key, tail, lead = K.segscan(c, key2, val2, nbuck, neg2)

    def fix_adds(lk):
        return sum(int((lk[:, s:] == lk[:, :-s]).sum())
                   for s in (1 << i for i in range(lanes.bit_length() - 1)))

    hold("fixup", f"{c.name} lanes={per}x{lanes}",
         lambda: K.fixup(c, tail, last_key, key2[0], lead),
         lambda: K.fixup_plain(c, tail, last_key, key2[0], lead), 5, c=c, B=width,
         compare=coord_diff(c), block=K.FIXUP_LANES, adds=fix_adds(last_key))
    if variants:                          # the last group's 3 windows
        t3, lk3, fk3, ld3 = (x[..., :3, :].contiguous() for x in (tail, last_key, key2[0], lead))
        hold("fixup", f"{c.name} lanes=3x{lanes}", lambda: K.fixup(c, t3, lk3, fk3, ld3),
             lambda: K.fixup_plain(c, t3, lk3, fk3, ld3), 5, c=c, B=3 * lanes,
             compare=coord_diff(c), block=K.FIXUP_LANES, adds=fix_adds(lk3))
    fixed = K.fixup(c, tail, last_key, key2[0], lead)
    buckets = M.bucket_lookup(c, skey, scanned, fixed, key2[0], nbuck)
    for drop0 in (False, True) if variants else (False,):     # False: the signed path's
        hold("bucket_reduce", f"{c.name} nbuck={nbuck} windows={per} drop0={drop0}",
             lambda: K.bucket_reduce(c, buckets, drop0),
             lambda: K.bucket_reduce_plain(c, buckets, drop0), 5, c=c, B=nbuck,
             compare=coord_diff(c), groups=per)
    if variants:
        last = buckets[:, :, :3].contiguous()     # the last group's 3 windows
        hold("bucket_reduce", f"{c.name} nbuck={nbuck} windows=3 drop0=False",
             lambda: K.bucket_reduce(c, last, False),
             lambda: K.bucket_reduce_plain(c, last, False), 5, c=c, B=nbuck,
             compare=coord_diff(c), groups=3)
    warps = per * nbuck // 32
    print(f"  bucket_reduce: a suffix step of {per} windows is {warps} warps, "
          f"{warps / (4 * SMS):.3f} a scheduler")
    s_all = torch.cat([M.window_sums(c, payload, keys[j:j + per], negs[j:j + per],
                                     lanes, nbuck, True)
                       for j in range(0, nwin, per)], -1).permute(2, 0, 1)
    # horner's twin (one point, hundreds of small operations: seconds on
    # the card) goes to a CPU worker; its hold comes after the msm() runs
    horner_twin = Twin(pool, dev, "horner_plain", c, s_all, MSM_W)
    del skey, key2, val2, neg2, scanned, fixed, payload, buckets
    torch.cuda.synchronize()

    print(f"msm(): {c.name}, {N} points, signed w={MSM_W}, {lanes} lanes")
    K.reset_launches()
    t = time.perf_counter()
    got = M.msm(c, pts, k_i)
    wall = time.perf_counter() - t
    launches = dict(K.launches)
    if got != want:
        raise AssertionError(f"msm() on {c.name} disagrees with the host check")
    for name in ("segscan", "fixup", "bucket_reduce", "horner"):
        if launches[name] <= 0:
            raise AssertionError(f"msm() on {c.name} did not launch the {name} kernel")
    print(f"  equals (sum a_i*k_i mod n)*G; whole msm() {wall:.3f} s; launches "
          f"per MSM {launches}")

    def core():
        return M.msm_limbs(c, *packed, "pippenger", w=MSM_W, lanes=lanes, signed=True)

    first = core()
    rates = []
    for _ in range(MSM_RUNS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = core()
        torch.cuda.synchronize()
        rates.append(N / (time.perf_counter() - t))
        if not torch.equal(out, first):
            raise AssertionError(f"the {c.name} MSM core differs between runs")
    rate = float(np.median(rates))
    print(f"  device core: points/s median {rate:.1f}, runs {[round(r, 1) for r in rates]}")

    def horner_hold():
        hold("horner", f"{c.name} w={MSM_W} nw={nwin}", lambda: K.horner(c, s_all, MSM_W),
             horner_twin, 5, c=c, B=1, compare=coord_diff(c), nw=nwin, w=MSM_W)
        thread_ms = {d: 1e3 * sum(K.work("horner", c, 1, design=d, nw=nwin, w=MSM_W)[0].values())
                     / clock_hz for d in K.designs("horner", c)}
        hold.rows[row_name("horner", c)]["thread_bound_ms"] = min(thread_ms.values())
        print(f"  {c.name}: horner's one-thread bound (one instruction per clock): " + ", ".join(
            f"{d} {v:.4f} ms" for d, v in thread_ms.items()))

    return {"pts": pts, "a_i": a_i, "k_i": k_i, "core": core, "launches": launches,
            "rate": rate, "want": want, "horner": horner_hold}


SHARD_RANKS = 4          # step 12's ranks, all on the one card
SHARD_RUNS = 3           # timed runs of each sharded core and of each fold
SHARD_TIMEOUT = 300      # seconds the ranks may take, spawning included
SHARD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "sharded")


def host_msm(c, pts, ks):
    """sum k_i * P_i by the host oracle, one aff_mul per distinct point."""
    from tpu_ecc_torch.utils import ec_host as H

    total = {}
    for p_, k in zip(pts, ks):
        total[p_] = (total.get(p_, 0) + k) % c.n
    acc = None
    for p_, k in total.items():
        acc = H.aff_add(c, acc, H.aff_mul(c, k, p_))
    return acc


def adversarial_inputs(c, method: str) -> tuple:
    """Step 12's case 3 for `method` on SHARD_RANKS ranks: (points,
    scalars, msm()'s keywords). N is not a multiple of msm()'s unit, so
    that the last rank holds only padding (Pippenger: 70 points at 8 lanes,
    shards of 24; Straus: 3000 points at 8 terms, shards of 1024); the rank
    before it holds only zero scalars; one point and one scalar sit on both
    sides of the boundary between ranks 0 and 1, and one point with zero
    scalars on both sides of the boundary between ranks 1 and 2."""
    import random

    from tpu_ecc_torch.utils import ec_host as H

    N, shard, kw = ((70, 24, dict(method="pippenger", lanes=8)) if method == "pippenger"
                    else (3000, 1024, dict(method="straus")))
    rng = random.Random(12)
    base = [H.aff_mul(c, rng.randrange(1, c.n), H.aff_generator(c)) for _ in range(8)]
    pts = [base[rng.randrange(8)] for _ in range(N)]
    ks = [rng.randrange(1, c.n) for _ in range(N)]
    k = rng.randrange(1, c.n)
    for i in range(shard - 6, shard + 6):
        pts[i], ks[i] = base[0], k
    for i in range(2 * shard - 5, N):
        pts[i], ks[i] = base[1], 0
    return pts, ks, kw


def _timed_ms(fn, runs: int, barrier) -> tuple:
    """(the last output, the ms of each of `runs` calls of fn), each call
    started together with the other ranks (barrier) and closed by a
    synchronize of the card."""
    out, ms = None, []
    for _ in range(runs):
        barrier()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
    return out, ms


def sharded_rank(rank: int, want) -> None:
    """One rank of step 12, on card 0 in a gloo group of SHARD_RANKS (a
    file:// rendezvous in SHARD_DIR); it loads only kernels that step 1
    built. Case 1: its shard of step 7's MSM_POINTS points (made again
    from seed 8, derived on the card) through msm_sharded, signed w =
    MSM_W, with the ring and the gather on a 1-D mesh and "auto" on a
    (2, 2) ("dcn", "ici") mesh: each must equal `want` and launch the four
    phase kernels (the counts set to 0 just before, read just after); then
    each core SHARD_RUNS times, and the fold alone, ring and gather, on
    this rank's partial. Case 2: the Straus msm() over the first
    SHARD_RANKS * STRAUS_POINTS of step 7's points (made again, derived on
    the card) on the 1-D mesh, which must equal their host check and
    launch the ladder. Case 3:
    `adversarial_inputs` for both methods, ring and gather, against the
    host oracle. Writes its record to SHARD_DIR/rank<r>.json."""
    import torch.distributed as dist

    from tpu_ecc_torch.curves.specs import get_curve
    from tpu_ecc_torch.ops import fe as F
    from tpu_ecc_torch.ops import kernels as K
    from tpu_ecc_torch.ops import points as P
    from tpu_ecc_torch.ops import scalarmul as SM
    from tpu_ecc_torch.parallel import collectives as CL
    from tpu_ecc_torch.parallel import msm as M
    from tpu_ecc_torch.utils import ec_host as H

    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method="file://" + os.path.join(SHARD_DIR, "rendezvous"),
                            rank=rank, world_size=SHARD_RANKS)
    try:
        c = get_curve("secp256k1")
        for name in PHASE_KERNELS + ("ladder", "genmul", "pow"):
            if not os.path.exists(K._target(name, c)[0]):
                raise RuntimeError(f"rank {rank}: step 1 did not build the {name} kernel")
        torch.cuda.reset_peak_memory_stats()
        line = CL.make_mesh(SHARD_RANKS, "dp")
        grid = CL.make_mesh(shape=(2, 2), axes=("dcn", "ici"))
        part = CL.shard_slice(line, "dp", MSM_POINTS)
        a_i, k_i = msm_scalars(c, MSM_POINTS, 8, part.start, part.stop)
        packed = M.pack(c, SM.derive_public_batch(c, a_i), k_i, part.stop - part.start, dev)
        del a_i, k_i
        rec = {"rank": rank, "made_s": time.perf_counter() - t0, "launches": {},
               "core_ms": {}, "fold_ms": {}}

        def affine(limbs):
            x, y, inf = P.to_affine(P.point_from_limbs(c, limbs))
            return None if bool(inf) else (F.fe_to_ints(x)[0], F.fe_to_ints(y)[0])

        for label, rm, mesh, axis in (("ring", "ring", line, "dp"),
                                      ("gather", "gather", line, "dp"),
                                      ("auto (2, 2)", "auto", grid, ("dcn", "ici"))):
            def core(mesh=mesh, axis=axis, rm=rm):
                return M.msm_sharded(c, mesh, axis, *packed, method="pippenger", w=MSM_W,
                                     lanes=MSM_LANES, reduce_method=rm, signed=True)

            dist.barrier()
            K.reset_launches()
            first = core()
            rec["launches"][label] = launches = dict(K.launches)
            if affine(first) != tuple(want):
                raise AssertionError(f"rank {rank}: the sharded MSM ({label}) disagrees "
                                     "with the host check")
            for name in PHASE_KERNELS:
                if launches[name] <= 0:
                    raise AssertionError(f"rank {rank}: the sharded MSM ({label}) did not "
                                         f"launch the {name} kernel")
            out, rec["core_ms"][label] = _timed_ms(core, SHARD_RUNS, dist.barrier)
            if not torch.equal(out, first):
                raise AssertionError(f"rank {rank}: the sharded MSM ({label}) differs "
                                     "between runs")
        partial = M.msm_limbs(c, *packed, "pippenger", w=MSM_W, lanes=MSM_LANES,
                              signed=True)[..., None]
        for rm in ("ring", "gather"):
            _, rec["fold_ms"][rm] = _timed_ms(
                lambda rm=rm: M.fold_partials(c, line, "dp", partial, rm), SHARD_RUNS,
                dist.barrier)
        del packed, partial

        a_i, k_i = msm_scalars(c, MSM_POINTS, 8, 0, SHARD_RANKS * STRAUS_POINTS)
        straus_pts = SM.derive_public_batch(c, a_i)
        straus_want = H.aff_mul(c, sum(a * k for a, k in zip(a_i, k_i)) % c.n,
                                H.aff_generator(c))
        dist.barrier()
        K.reset_launches()
        got = M.msm(c, straus_pts, k_i, mesh=line)
        rec["straus_launches"] = dict(K.launches)
        if got != straus_want:
            raise AssertionError(f"rank {rank}: the sharded Straus msm() disagrees with "
                                 "the host check")
        if rec["straus_launches"]["ladder"] <= 0:
            raise AssertionError(f"rank {rank}: the sharded Straus msm() did not launch "
                                 "the ladder kernel")
        for method in ("pippenger", "straus"):
            pts, ks, kw = adversarial_inputs(c, method)
            want3 = host_msm(c, pts, ks)
            for rm in ("ring", "gather"):
                if M.msm(c, pts, ks, mesh=line, reduce_method=rm, **kw) != want3:
                    raise AssertionError(f"rank {rank}: the adversarial shards ({method}, "
                                         f"{rm}) disagree with the host oracle")
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec["seconds"] = time.perf_counter() - t0
        with open(os.path.join(SHARD_DIR, f"rank{rank}.json"), "w") as fh:
            json.dump(rec, fh)
    finally:
        dist.destroy_process_group()


def sharded_phase(want) -> list:
    """Step 12: SHARD_RANKS ranks (`sharded_rank`) spawned on the one card;
    a rank's exception, or ranks still running after SHARD_TIMEOUT
    seconds, raise here (the ranks still alive are killed). Prints each
    rank's times, launches and peak memory; returns the ranks' records."""
    import torch.multiprocessing as tmp

    from tpu_ecc_torch.curves.specs import get_curve
    from tpu_ecc_torch.ops import points as P

    c = get_curve("secp256k1")
    pts = P.point_limbs(P.generator(c, (2,), torch.device("cuda")))
    add_ms = float(np.median(_timed_ms(lambda: P.add_limbs(c, pts[..., 0], pts[..., 1]), 5,
                                       lambda: None)[1]))
    os.makedirs(SHARD_DIR, exist_ok=True)
    for name in os.listdir(SHARD_DIR):
        os.remove(os.path.join(SHARD_DIR, name))
    print(f"sharded msm: {SHARD_RANKS} ranks on the one card (gloo, file:// rendezvous; "
          f"torch.cuda.device_count() = {torch.cuda.device_count()}), {MSM_POINTS} points, "
          f"{MSM_POINTS // SHARD_RANKS} a rank, signed w={MSM_W}; Straus at "
          f"{SHARD_RANKS * STRAUS_POINTS} points; adversarial shards")
    t = time.perf_counter()
    ctx = tmp.start_processes(sharded_rank, args=(want,), nprocs=SHARD_RANKS, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + SHARD_TIMEOUT
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"the {SHARD_RANKS} ranks did not end within "
                                   f"{SHARD_TIMEOUT} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    recs = []
    for r in range(SHARD_RANKS):
        with open(os.path.join(SHARD_DIR, f"rank{r}.json")) as fh:
            recs.append(json.load(fh))
    for rec in recs:
        for label, launches in rec["launches"].items():
            if any(launches[name] <= 0 for name in PHASE_KERNELS):
                raise AssertionError(f"rank {rec['rank']} ({label}): a phase kernel did not "
                                     f"launch: {launches}")
        if rec["straus_launches"]["ladder"] <= 0:
            raise AssertionError(f"rank {rec['rank']}: the Straus msm() did not launch ladder")
        print(f"  rank {rec['rank']}: shard made in {rec['made_s']:.1f} s; core ms (median of "
              f"{SHARD_RUNS}) " + ", ".join(f"{k} {np.median(v):.3f} {[round(x, 3) for x in v]}"
                                             for k, v in rec["core_ms"].items())
              + "; fold ms " + ", ".join(f"{k} {np.median(v):.3f} {[round(x, 3) for x in v]}"
                                         for k, v in rec["fold_ms"].items())
              + f"; peak {rec['peak_gib']:.2f} GiB; {rec['seconds']:.1f} s in all")
        print(f"    launches: " + "; ".join(
            f"{k} {{{', '.join(f'{n}: {v[n]}' for n in PHASE_KERNELS)}}}"
            for k, v in rec["launches"].items())
            + f"; Straus ladder {rec['straus_launches']['ladder']}")
    print(f"  every rank equals the host check under ring, gather and (2, 2) auto, Straus "
          f"and the adversarial shards; {time.perf_counter() - t:.1f} s with spawning; "
          f"{smi('name,power.limit')}")
    print(f"  the fold's add alone (one point, plain torch on the card, this process, "
          f"median of 5): {add_ms:.3f} ms")
    print("  four ranks share one card: no scaling figure")
    return recs


def check_builds(targets, sass) -> list:
    """ptxas's registers and stack of each library of `targets` on the
    32-bit layer, and of dma_gather's (a library once, under its kernels'
    names): at N = 8 words (and dma_gather) a spill fails, at N = 6, 7, 12
    and 17 it is printed, not refused. Returns the SASS to read, [(label,
    library, kernel)] where sass(target, kernel), for `sass_report`."""
    from tpu_ecc_torch.ops import kernels as K
    from tpu_ecc_torch.ops import kfe

    libs, jobs = {}, []
    for c, name in targets:
        if c is not None and name in K.FE32_KERNELS or name == "dma_gather":
            libs.setdefault(K._target(name, c)[0], []).append((c, name))
    for so, names in libs.items():
        c, name = names[0]
        with open(f"{so}.log") as fh:
            regs, stack = ptxas_report(fh.read())
        words = (None if c is None else
                 kfe.fe32_words(c if name in K.FIELD_KERNELS else c.field))
        flags = " ".join(K._flags(K.KERNELS[name][0], c)[len(K.NVCC_FLAGS):])
        print(f"  {' and '.join(row_name(n, t) for t, n in names)}"
              f"{'' if words is None else f' (N = {words})'}{f' [{flags}]' if flags else ''}: "
              f"{regs}; {stack}")
        spills = not stack or any("0 bytes spill stores, 0 bytes spill loads" not in ln
                                  for ln in stack.split(" | "))
        if spills and words in (None, 8):
            raise AssertionError(f"{row_name(name, c)} spills: {stack!r}")
        if sass(c, name):
            jobs.append((" and ".join(row_name(n, t) for t, n in names), so, name))
    return jobs


def sass_report(jobs) -> list:
    """The SASS loop bodies by class of each (label, library, kernel) of
    `jobs` (`check_builds`), as lines to print; mxu_chain's step must hold
    a warpgroup MMA (GMMA). cuobjdump runs once a library."""
    lines = []
    for label, so, name in jobs:
        text = _cuobjdump(so)
        lines.append(f"  {label}:")
        for fn in SASS_FUNCTION.get(name, (f"{name}_kernel",)):
            bodies = sass_loop_counts(text, fn, so)
            lines.append(f"    SASS loop bodies of {fn} by class, largest first: {bodies}")
            if name == "mxu_chain" and not any(b.get("gmma") for b in bodies):
                raise AssertionError(f"{label}: no warpgroup MMA (GMMA) in its step's SASS")
    return lines


def make_hold(rows: dict, clock_hz: float, default_curve):
    """The hold of phase 2: a function that holds a kernel against its
    plain twin, times both and records the kernel's row in `rows`."""
    from tpu_ecc_torch.ops import kernels as K

    def hold(name, label, kern, plain, reps, B=None, c=default_curve, library=None,
             compare=limb_diff, block=None, **work):
        """kern() against plain() (a tensor or a tuple of them) by compare
        (the largest limb difference, by default of the raw limbs), then
        kern's ms over `reps` runs and its bound, the least over K.designs
        of K.work (B: the lanes, by default the output's last axis) for
        target c (default secp256k1, whose rows are named by the kernel
        alone; a field spec; None), and the ms of library(), one PyTorch
        call that computes the same function, where there is one. With
        `block` (the lanes a block, one thread a lane), prints the warps
        a scheduler of the card. A `Twin` plain was computed ahead, and
        its time is its own."""
        out_k = kern()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out_p = plain()
        torch.cuda.synchronize()
        plain_s = plain.seconds if isinstance(plain, Twin) else time.perf_counter() - t
        outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
        outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
        if [a.shape for a in outs_k] != [b.shape for b in outs_p]:
            raise AssertionError(f"{name} ({label}): output shapes differ from its twin's")
        err = compare(outs_k, outs_p)
        if err != 0:
            raise AssertionError(f"{name} ({label}) differs from its plain twin: "
                                 f"max abs limb difference {err}")
        ms = _time_ms(kern, reps)
        lib_ms = None if library is None else _time_ms(library, reps)
        by_design, split = {}, None
        for design in K.designs(name, c):
            ops, nbytes = K.work(name, c, outs_k[0].shape[-1] if B is None else B,
                                 design=design, **work)
            by_design[design] = (nbytes / PEAK_BYTES_PER_S, op_seconds(ops, clock_hz))
            if "int8" in ops:       # the last design with tensor-core work
                split = (design, ops)
        bytes_s, ops_s = min(by_design.values(), key=max)
        bound_ms = 1e3 * max(bytes_s, ops_s)
        by = "bytes" if bytes_s > ops_s else "operations"
        key = row_name(name, c)
        extra = "" if lib_ms is None else f", library {lib_ms:.3f} ms"
        if len(by_design) > 1:
            extra += " (bound by design: " + ", ".join(
                f"{d} {1e3 * max(v):.4f} ms" for d, v in by_design.items()) + ")"
        if split is not None:
            design, ops = split
            cores = op_seconds({**ops, "int8": 0}, clock_hz)
            extra += (f" ({design}: CUDA cores {1e3 * cores:.4f} ms, int8 tensor cores "
                      f"{1e3 * ops['int8'] / INT8_OPS_PER_S:.4f} ms)")
        same = "limb-equal" if compare is limb_diff else "equal mod p by canonical values"
        if block is not None:
            lanes = outs_k[0].shape[-1] if B is None else B
            warps = -(-lanes // block) * -(-block // 32)
            extra += f"; {warps} warps, {warps / (4 * SMS):.3f} a scheduler"
        where = plain.where if isinstance(plain, Twin) else ""
        print(f"  {key} [{label}]: {same} to its twin; kernel {ms:.3f} ms, "
              f"twin {1e3 * plain_s:.1f} ms{where}, bound {bound_ms:.4f} ms ({by}){extra}")
        row = rows.setdefault(key, {"max_abs_err": 0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if "ms" not in row:        # the first variant is the main path's shape
            row.update(ms=ms, plain_ms=1e3 * plain_s, bound_ms=bound_ms, bound_by=by,
                       library_ms=lib_ms)
        return ms, lib_ms

    hold.rows = rows
    return hold


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    pool = ProcessPoolExecutor(TWIN_WORKERS, mp_context=multiprocessing.get_context("spawn"),
                               initializer=_worker_init)
    try:
        return run(pool)
    finally:                    # on a fault, no worker goes on with a queued twin
        pool.shutdown(cancel_futures=True)


def run(pool) -> int:
    """Steps 1-11 (see the module's docstring), the new curves' twins on
    `pool`."""
    from tpu_ecc_torch import native
    from tpu_ecc_torch.curves.specs import get_curve
    from tpu_ecc_torch.ops import fe as F
    from tpu_ecc_torch.ops import kernels as K
    from tpu_ecc_torch.ops import kfe
    from tpu_ecc_torch.parallel import msm as M
    from tpu_ecc_torch.utils import ec_host as H

    started = time.perf_counter()
    dev = torch.device("cuda")

    def stamp(step: str) -> None:
        """A step's start on the run's clock, for the breakdown in PERF.md."""
        print(f"[{time.perf_counter() - started:.1f} s] {step}", flush=True)

    curve, p256, p384 = get_curve("secp256k1"), get_curve("p256"), get_curve("p384")
    curves = (curve, p256)
    wide_curves = tuple(get_curve(n) for n in WIDE_CURVES)
    point_curves = curves + (p384,) + wide_curves
    mxu = F.make_field_spec("k256mxu.fp", curve.p, "mont")
    probe_fields = (curve.field, p256.field, mxu)
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6

    # -- 1. build; step 2's inputs and twins meanwhile ------------------------
    t0 = time.perf_counter()
    probe_targets = ([(None, "dma_gather")] + [(f, "fmul_chain") for f in probe_fields]
                     + [(f, "mxu_chain") for f in probe_fields if f.kind == "mont"]
                     + [(curve, "ladder_probe")])
    targets = ([(curve, name) for name in K256_KERNELS] + [(p256, name) for name in P256_KERNELS]
               + probe_targets + wide_targets(get_curve))
    # built in the background from the end of step 1 until step 10: the MSM
    # phase kernels (secp256k1's, P-384's and MSM_CURVES') and the probes'
    later = ([(c, n) for c, n in targets if n in PHASE_KERNELS] + probe_targets
             + msm_targets(get_curve))
    first = [t for t in targets if t not in later]
    step2, chain_in, twins_s = [], {}, []
    # the host oracle's side of steps 3-6 and 10's main paths, on the workers
    oracles = {c.name: pool.submit(ecdsa_oracle, c, SIGNS) for c in (curve, p256, p384)}

    def prepare():          # plain PyTorch on the card: needs no kernel
        t = time.perf_counter()
        holds, inputs = step2_holds(curve, p256, p384, point_curves, dev, pool)
        step2.extend(holds)
        chain_in.update(inputs)
        twins_s.append(time.perf_counter() - t)

    reports = K.build_targets(first, meanwhile=prepare, nice=10)
    build_s = time.perf_counter() - t0
    build_pool = ThreadPoolExecutor(1)
    later_build = build_pool.submit(_timed_build, later)
    print(f"build: {build_s:.1f} s for {len(reports)} libraries of {len(first)} kernels "
          f"(padd is padd_chain's library at one add; nvcc at niceness 10, step 2's twins "
          f"made meanwhile in {twins_s[0]:.1f} s): {row_names(first)}; in the background "
          f"from now until step 10, {len(later)} kernels: {row_names(later)}")
    for (cname, name), rep in reports.items():
        print(f"  {cname} {name}: {ptxas_report(rep)[0]}")
    print("the 32-bit layer's kernels and dma_gather: ptxas (their loop bodies in SASS, "
          "read at step 8 after every timed step, print there beside these fe32 counts)")
    for c in curves:
        model = kfe.fe32_counts(c)
        print(f"  fe32 count, {c.name}: " + ", ".join(
            f"{f} {model[f]}" for f in ("padd", "padd_mixed", "pdouble", "select_point",
                                        "select_affine", "cneg", "mul", "sqr", "load",
                                        "store"))
            + f", scalar field mul {kfe.fe32_counts(c.scalar)['mul']}"
            + f", sqr {kfe.fe32_counts(c.scalar)['sqr']}")
    for c in (p384, get_curve("p521")):
        model = kfe.fe32_counts(c)
        print(f"  fe32 count, {c.name}: " + ", ".join(
            f"{f} {model[f]}" for f in ("padd", "pdouble", "mul", "sqr", "load", "store"))
            + f", scalar field mul {kfe.fe32_counts(c.scalar)['mul']}"
            + f", sqr {kfe.fe32_counts(c.scalar)['sqr']}")

    def sass(c, name):
        return c is None or c in curves or name in K.FIELD_KERNELS or (c.name, name) in SASS_WIDE

    sass_jobs = check_builds(first, sass)
    t0 = time.perf_counter()
    native.build()
    print(f"  native (g++): {time.perf_counter() - t0:.1f} s")
    # the new curves' holds at their path's shapes, their twins computed by
    # the workers on the CPU while the background build runs
    t10 = time.perf_counter()
    wide_holds = {c.name: curve_holds(c, WIDE_COUNT, dev, ("pow", "ladder", "genmul"), pool)
                  for c in wide_curves}
    wide_s = time.perf_counter() - t10
    oracles.update({c.name: pool.submit(ecdsa_oracle, c, WIDE_COUNT) for c in wide_curves})
    probe_ladder = probe_ladder_inputs(curve, dev, pool)     # step 9's twins, on the workers
    torch.cuda.synchronize()

    rows = {}
    hold = make_hold(rows, clock_hz, curve)

    # -- the background build's end: no timing runs beside nvcc --------------
    stamp("background build")
    t2 = time.perf_counter()
    later_reports, later_s = later_build.result()
    build_pool.shutdown()
    print(f"build (background, from the end of step 1): {later_s:.1f} s for "
          f"{len(later_reports)} libraries; waited {time.perf_counter() - t2:.1f} s for it "
          "before step 10, so that no timing runs beside nvcc")
    for (cname, name), rep in later_reports.items():
        print(f"  {cname} {name}: {ptxas_report(rep)[0]}")
    sass_jobs += check_builds(later, sass)

    # -- 10. the new curves: the other builds' holds, ECDSA --------------------
    stamp("step 10")
    t10 = time.perf_counter()
    print(f"hold: the new curves' builds at their path's shapes (B = {WIDE_COUNT}), the "
          "twins computed by the workers on the CPU")
    for holds in wide_holds.values():
        run_holds(hold, holds)
    del wide_holds
    wide = {c.name: ecdsa_phases(c, WIDE_COUNT, 1, 1, oracles.pop(c.name)) for c in wide_curves}
    sm2_bign_phase(WIDE_COUNT)
    wide_s += time.perf_counter() - t10

    # -- 2. each kernel against its plain twin, at the main path's shapes ---
    stamp("step 2")
    print("hold: kernels against their plain twins (secp256k1, then the point kernels "
          "of every curve, P-256's and P-384's builds)")
    run_holds(hold, step2)
    del step2

    # -- 11. Schnorr, ECDH and hash-to-curve -----------------------------------
    stamp("step 11")
    print("Schnorr, ECDH and hash-to-curve (the holds: the ECDH ladder's shape, pow at "
          "the SSWU exponent)")
    proto_s = {}
    for label, phase in (("schnorr", schnorr_phase), ("ecdh", lambda: ecdh_phase(hold, dev)),
                         ("h2c", lambda: h2c_phase(hold, dev))):
        t11 = time.perf_counter()
        phase()
        proto_s[label] = time.perf_counter() - t11
    print("  seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in proto_s.items()))

    # -- 3.-5. the main path on secp256k1: ECDSA, the point-add chain --------
    stamp("steps 3-5")
    k256 = ecdsa_phases(curve, SIGNS, VERIFY_RUNS, RUNS, oracles.pop(curve.name))
    k256["adds"], chain_launches = chain_phase(curve, *chain_in[curve.name])
    single = single_point_ops(point_curves, dev)

    # -- 6. the P-256 path, then P-384's; the chain on the nine others -------
    stamp("step 6")
    p = ecdsa_phases(p256, SIGNS, VERIFY_RUNS, RUNS, oracles.pop(p256.name))
    p["adds"], p_chain_launches = chain_phase(p256, *chain_in[p256.name])
    t10 = time.perf_counter()
    q = ecdsa_phases(p384, SIGNS, P384_RUNS, P384_RUNS, oracles.pop(p384.name))
    q["adds"], q_chain_launches = chain_phase(p384, *chain_in[p384.name])
    print(f"hold: padd_chain at its chain's shape (B = {POINT_B}, repeat 16) on "
          f"{list(WIDE_CURVES)}, the twins computed at once on the card; adds/s")
    wide_adds, wide_chain_launches = {}, {}
    for c in wide_curves:
        a_l, b_l, a_pts, b_pts = chain_inputs(c, dev)
        run_holds(hold, [chain_hold(c, a_l, b_l,
                                    Twin(None, dev, "padd_chain_plain", c, a_l, b_l, 16))])
        wide_adds[c.name], wide_chain_launches[c.name] = chain_phase(c, a_l, b_l, a_pts, b_pts)
    wide_s += time.perf_counter() - t10

    # -- 7. MSM: Pippenger at 2^20 points, Straus ------------------------------
    stamp("step 7")
    k_msm = msm_phase(hold, curve, MSM_POINTS, 8, dev, True, clock_hz, pool)
    k_msm["horner"]()
    pts, a_i, k_i = k_msm["pts"], k_msm["a_i"], k_msm["k_i"]
    print(f"msm(): {STRAUS_POINTS} points (Straus)")
    want_s = H.aff_mul(curve, sum(a * k for a, k in zip(a_i[:STRAUS_POINTS],
                                                        k_i[:STRAUS_POINTS])) % curve.n,
                       H.aff_generator(curve))
    K.reset_launches()
    t = time.perf_counter()
    got = M.msm(curve, pts[:STRAUS_POINTS], k_i[:STRAUS_POINTS])
    straus_wall = time.perf_counter() - t
    if got != want_s:
        raise AssertionError("the Straus msm() disagrees with the host check")
    if K.launches["ladder"] <= 0:
        raise AssertionError("the Straus msm() did not launch the ladder kernel")
    print(f"  equals the host check; {straus_wall:.3f} s; launches {dict(K.launches)}")
    del pts, a_i, k_i
    torch.cuda.synchronize()
    phases = msm_phase_ms(k_msm["core"])     # last: a profiler run leaves overhead behind
    print(f"  device core by step (one profiled run), ms: {json.dumps(phases)}")
    del k_msm["core"]

    t10 = time.perf_counter()
    q_msm = msm_phase(hold, p384, P384_MSM_POINTS, 18, dev, False, clock_hz, pool)
    q_msm["horner"]()
    del q_msm["core"]
    wide_s += time.perf_counter() - t10

    # -- 7b. the MSM on MSM_CURVES at 2^14 points ------------------------------
    stamp("step 7b")
    t7 = time.perf_counter()
    curve_msm = {}
    for i, name in enumerate(MSM_CURVES):
        m = msm_phase(hold, get_curve(name), MSM_CURVE_POINTS, 60 + i, dev, False, clock_hz,
                      pool)
        curve_msm[name] = {k: m[k] for k in ("launches", "rate", "horner")}
        del m
    for m in curve_msm.values():            # their twins, computed side by side meanwhile
        m.pop("horner")()
    msm_curves_s = time.perf_counter() - t7
    pool.shutdown()

    # -- 12. the sharded MSM: SHARD_RANKS ranks on the one card ---------------
    stamp("step 12")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    sharded_phase(k_msm["want"])
    sharded_s = time.perf_counter() - t12

    # -- 9. the probes (before the record of step 8) ---------------------------
    stamp("step 9")
    probe_launches = probes(hold, probe_fields, probe_ladder, dev)

    # -- 8. the record --------------------------------------------------------
    stamp("step 8")
    t8 = time.perf_counter()
    sass_lines = sass_report(sass_jobs)
    print(f"the loop bodies in SASS against the fe32 count (read in "
          f"{time.perf_counter() - t8:.1f} s):")
    print("\n".join(sass_lines))
    launches = {(curve, "padd_chain"): chain_launches,
                (p256, "padd_chain"): p_chain_launches,
                (p384, "padd_chain"): q_chain_launches,
                **{(c, name): r["verify_launches"][name]
                   for c, r in zip((curve, p256, p384) + wide_curves, (k256, p, q, *wide.values()))
                   for name in ("pow", "ladder")},
                **{(c, "genmul"): (r["sign_launches"] or r["derive_launches"])["genmul"]
                   for c, r in zip((curve, p256, p384) + wide_curves, (k256, p, q, *wide.values()))},
                **{(c, name): m["launches"][name] for c, m in ((curve, k_msm), (p384, q_msm))
                   for name in PHASE_KERNELS},
                **{(get_curve(c), name): m["launches"][name] for c, m in curve_msm.items()
                   for name in PHASE_KERNELS},
                **{(c, "padd_chain"): wide_chain_launches[c.name] for c in wide_curves},
                **{(c, name): single[c.name][name] for c in point_curves
                   for name in ("padd", "pdouble")},
                **probe_launches}
    kernels = []
    for (c, name), count in launches.items():
        src, _, _, replaces = K.KERNELS[name]
        kernels.append({"name": row_name(name, c), "route": "cuda",
                        "source": f"tpu_ecc_torch/csrc/{src}", "replaces": replaces,
                        "launches": count, **rows[row_name(name, c)]})
    for c, r in ((curve, k256), (p256, p), (p384, q)):
        runs = P384_RUNS if c is p384 else RUNS
        print(f"slice, {c.name}: {r['verify']:.1f} verifies/s (median of "
              f"{P384_RUNS if c is p384 else VERIFY_RUNS}), {r['sign']:.1f} signs/s, "
              f"{r['derive']:.1f} derives/s, {r['recover']:.1f} recovers/s (medians of "
              f"{runs}), {r['adds']:.6g} adds/s")
    print(f"msm, secp256k1: {k_msm['rate']:.1f} MSM points/s at 2^20 points; p384: "
          f"{q_msm['rate']:.1f} at 2^16; at 2^14: " + ", ".join(
              f"{c} {m['rate']:.1f}" for c, m in curve_msm.items()) + f" (medians of {MSM_RUNS})")
    print("padd_chain at B = 8192, repeat 16, adds/s: " + ", ".join(
        f"{c} {v:.6g}" for c, v in wide_adds.items()))
    print(f"build {build_s:.1f} s, and {later_s:.1f} s in the background for "
          f"{len(later_reports)} more libraries; the new curves' phases took {wide_s:.1f} s, "
          f"their MSM {msm_curves_s:.1f} s; Schnorr, ECDH and hash-to-curve "
          f"{sum(proto_s.values()):.1f} s; the sharded MSM {sharded_s:.1f} s; "
          f"chip_smoke took {time.perf_counter() - started:.1f} s in all")
    print(smi("name,power.limit"))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
