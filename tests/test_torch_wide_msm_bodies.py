"""The lane bodies of the MSM's four phase kernels (`segscan`, `fixup`,
`bucket_reduce`, `horner`) on the 32-bit field layer at each curve's own
word count: P-192 (N = 6), P-224 (7), SM2, bign256 and bp256t1 (8; CIOS,
solinas and the Montgomery load), P-384 and bp384t1 (12), P-521 (17, the
fold at bit 521), and the generic a of bp256r1 and bp384r1 (RCB Algorithms
1-3). One g++ build at -O0 of the host harness (tests/fe32_harness.py) per
curve, five at a time, or the one tests/test_torch_fe32_wide.py built
(`fe32_harness.HARNESS_CACHE`); tests/test_torch_fe32.py holds the same
bodies on secp256k1 and P-256.

Inputs are made from a numpy seed (and the host oracle's points).
Tolerance: exact. Each body runs as its launches run it (segscan signed,
N = 512, 32 lanes, w = 8, two windows side by side; fixup's steps on two
windows of 64 lanes, and windows of one lane; bucket_reduce's steps on two
windows of 64 buckets, signed and with drop0; horner at w = 4 over five
window sums) and equals its plain twin coordinate by coordinate mod p
(segscan at the run-end rows, the only rows it writes) and the host
oracle's sums; every value the harness returns is canonical.

Budget: 120 s for the file at one process, its g++ builds included.
"""

import shutil

import pytest
import torch

from fe32_harness import (check_bucket_body, check_fixup_body, check_horner_body,
                          check_segscan_body, compile_harness, runner)
from tpu_ecc_torch.curves.specs import get_curve, list_curves
from tpu_ecc_torch.ops import kernels

CURVES = ("p192", "p224", "p384", "p521", "sm2", "bign256", "bp256t1", "bp384t1",
          "bp256r1", "bp384r1")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module: its tensors are small, and idle
    threads that spin take cores from the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """{curve name: harness runner}: the g++ builds, five at a time."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    runners, todo = {}, list(CURVES)
    while todo:
        batch, todo = todo[:5], todo[5:]
        procs = {c: compile_harness(c, tmp_path_factory.mktemp(f"fe32-msm-{c}")) for c in batch}
        for c, (exe, proc) in procs.items():
            out, _ = proc.communicate()
            assert proc.returncode == 0, out.decode()
            runners[c] = runner(exe)
    return runners


@pytest.mark.parametrize("cname", CURVES)
def test_segscan_body_equals_plain(harness, cname):
    """segscan_lane with signed digits (the MSM's), two windows side by
    side, against segscan_plain at the run-end rows, last_key exactly, tail
    and lead mod p; the buckets that either's rows give equal mod p."""
    check_segscan_body(harness[cname], get_curve(cname), True)


@pytest.mark.parametrize("drop0", [False, True], ids=["signed", "drop0"])
@pytest.mark.parametrize("cname", CURVES)
def test_bucket_body_equals_plain(harness, cname, drop0):
    """bucket_reduce's suffix and pair steps against bucket_reduce_plain
    mod p and the weighted bucket sums by the host oracle."""
    check_bucket_body(harness[cname], get_curve(cname), drop0)


@pytest.mark.parametrize("cname", CURVES)
def test_horner_body_equals_plain(harness, cname):
    """horner_lane against horner_plain mod p and the host oracle."""
    check_horner_body(harness[cname], get_curve(cname))


@pytest.mark.parametrize("cname", CURVES)
def test_fixup_body_equals_plain(harness, cname):
    """fixup's steps and its last launch against fixup_plain mod p and the
    fixed lanes by the host oracle, then windows of one lane."""
    check_fixup_body(harness[cname], get_curve(cname))


def test_ptxas_level_of_each_build():
    """ptxas runs at -O1 (kernels.DENSE_CHAIN_PTXAS) only for the builds
    that spill at -O3 and not at -O1: segscan on the 8-word curves with
    a != 0, padd_chain (and padd) on the Montgomery-load fields, the ladder
    on the generic a; every other source and curve at -O3."""
    want = {"segscan.cu": {"p256", "sm2", "bign256", "bp256t1", "bp256r1"},
            "padd_chain.cu": {"bp256t1", "bp256r1", "bp384t1", "bp384r1"},
            "ladder.cu": {"bp256r1", "bp384r1"}}
    for src in {kernels.KERNELS[k][0] for k in kernels.KERNELS}:
        got = {c for c in list_curves()
               if ("-Xptxas", kernels.DENSE_CHAIN_PTXAS)
               == kernels._flags(src, get_curve(c))[len(kernels.NVCC_FLAGS):]}
        assert got == want.get(src, set()), src
        assert kernels._flags(src, None) == kernels.NVCC_FLAGS
