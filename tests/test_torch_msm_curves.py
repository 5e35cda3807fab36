"""The single-device MSM on the curves beside secp256k1: the port's
Pippenger (`msm_pippenger`, and `msm(..., device="cpu")`, whose four phases
run their plain twins on the CPU) against tpu_ecc and the host oracle.

Limb for limb against tpu_ecc: the plain path keeps tpu_ecc's limb plan,
so the port's point limbs equal those of tpu_ecc's XLA path
(`msm_pippenger(kernels=False)`, one jitted program a curve and
configuration, compiled in niced worker processes by
tests/msm_reference.py) on the same numpy-seeded inputs: 128 points, w =
5, 16-bit scalars, unsigned ("u16") on P-256 (a = -3, Montgomery) and
bp256r1 (the generic a), signed ("s16") on P-521 (41 limbs of 13 bits,
the solinas field; tests/test_torch_msm.py holds both on secp256k1).
tpu_ecc's XLA path takes no signed digits on a
Montgomery field: its negation of y, `_steady(fneg(y))`, asserts at trace
time that the value is not steady (p256.fp: 259 bits), where the port's
`segscan_plain` reduces it below 4p, as tpu_ecc's segscan kernel does;
`test_reference_refuses_signed_digits_on_montgomery_fields` pins that.
P-521's unsigned case is not compiled, to keep the file within its
budget (each tpu_ecc program at N = 17 takes minutes of a loaded
machine's CPU): it is held against the host oracle only.

Against the host oracle, affine-equal: `msm(method="pippenger")` on all
ten curves at 128 points with full-width scalars (signed, w = 6, 16
lanes), zero and n - 1 among them; the s16 case on P-256 and bp256r1, and
the u16 case on P-521.

Budget: 150 s for the file at one process.
"""

import concurrent.futures
import functools
import multiprocessing
import os

import msm_reference
import numpy as np
import pytest
import torch

from tpu_ecc_torch import interop
from tpu_ecc_torch.curves.specs import get_curve
from tpu_ecc_torch.ops import fe as F
from tpu_ecc_torch.ops import points as P
from tpu_ecc_torch.ops import scalarmul as SM
from tpu_ecc_torch.parallel import msm as M
from tpu_ecc_torch.utils import ec_host as H

CURVES = ("p256", "sm2", "bign256", "p224", "p192", "bp256t1", "bp256r1", "bp384t1",
          "bp384r1", "p521")
# case -> the Pippenger configuration (tests/test_torch_msm.py's)
CASES = {
    "u16": dict(N=128, lanes=16, w=5, bits=16, signed=False),
    "s16": dict(N=128, lanes=16, w=5, bits=16, signed=True),
}
REFERENCE = [("p256", "u16"), ("bp256r1", "u16"), ("p521", "s16")]
MONT_SIGNED = [("p256", "s16"), ("bp256r1", "s16")]   # tpu_ecc's XLA path refuses these
ORACLE_ONLY = MONT_SIGNED + [("p521", "u16")]
FULL = dict(lanes=16, w=6)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module: its tensors are small, and idle
    threads that spin take cores from the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host_msm(curve, pts, ks):
    """sum k_i * P_i by the host oracle, one aff_mul per distinct point."""
    total = {}
    for p_, k in zip(pts, ks):
        total[p_] = (total.get(p_, 0) + k) % curve.n
    acc = None
    for p_, k in total.items():
        acc = H.aff_add(curve, acc, H.aff_mul(curve, k, p_))
    return acc


@functools.lru_cache(maxsize=None)
def _inputs(name, bits):
    """(points, scalars) from a seed: 8 random base points tiled over 128;
    16-bit scalars with zeros and 2^16 - 1, or full-width ones with 0 and
    n - 1."""
    curve = get_curve(name)
    rng = np.random.default_rng(1234 + (bits or 0))
    G = H.aff_generator(curve)
    base = [H.aff_mul(curve, int.from_bytes(rng.bytes(curve.scalar_bytes), "big")
                      % (curve.n - 1) + 1, G) for _ in range(8)]
    pts = [base[i % 8] for i in range(128)]
    if bits is None:
        ks = [int.from_bytes(rng.bytes(curve.scalar_bytes), "big") % curve.n for _ in pts]
        ks[0], ks[1] = 0, curve.n - 1
    else:
        ks = [int(v) for v in rng.integers(0, 1 << bits, len(pts))]
        ks[0] = ks[3] = ks[5] = 0
        ks[1] = (1 << bits) - 1
    return pts, ks


def _packed(curve, pts, ks):
    """Affine limbs xs, ys [n, N] and scalar limbs [ns, N], int64 tensors."""
    f = curve.field
    return (F.fe_from_ints(f, [p_[0] for p_ in pts], "cpu").limbs,
            F.fe_from_ints(f, [p_[1] for p_ in pts], "cpu").limbs,
            SM.pack_scalars(curve, ks, "cpu"))


def _reference_inputs(name, case):
    curve = get_curve(name)
    return {"mixed": tuple(interop.to_reference_limbs(t)
                           for t in _packed(curve, *_inputs(name, CASES[case]["bits"])))}


@pytest.fixture(scope="module")
def references():
    """tpu_ecc's results {(curve, case): future}, its three programs
    compiled at once in three niced worker processes, while this process
    runs the port."""
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=len(REFERENCE), mp_context=multiprocessing.get_context("spawn"),
            initializer=os.nice, initargs=(10,)) as pool:
        yield {(name, case): pool.submit(msm_reference.pippenger, name, CASES[case],
                                         _reference_inputs(name, case))
               for name, case in REFERENCE}
        pool.shutdown(cancel_futures=True)


@pytest.fixture(scope="module", autouse=True)
def _compile_ahead(request):
    """Starts tpu_ecc's compiles with the module's first test where the
    selection holds a limb-for-limb test, so that they overlap the port's
    work in the tests before it."""
    if any(item.module is request.module
           and item.originalname == "test_pippenger_limb_equal_to_reference"
           for item in request.session.items):
        request.getfixturevalue("references")


@functools.lru_cache(maxsize=None)
def _port_pippenger(name, case):
    curve = get_curve(name)
    cfg = CASES[case]
    pts, ks = _inputs(name, cfg["bits"])
    xs, ys, k = _packed(curve, pts, ks)
    f = curve.field
    pt = M.msm_pippenger(curve, F.fe_steady(f, xs), F.fe_steady(f, ys),
                         torch.zeros(len(pts), dtype=torch.bool), k, w=cfg["w"],
                         lanes=cfg["lanes"], scalar_bits=cfg["bits"], signed=cfg["signed"])
    return P.point_limbs(pt)


def _affine(curve, limbs):
    """Projective limbs [3, n] -> the affine point as host ints (None for O)."""
    X, Y, Z = (F.fe_to_ints(F.fe_steady(curve.field, limbs[i]))[0] for i in range(3))
    if Z == 0:
        return None
    zi = pow(Z, -1, curve.p)
    return X * zi % curve.p, Y * zi % curve.p


@pytest.mark.parametrize("name", CURVES)
def test_msm_full_width_equals_host_oracle(name):
    """msm(..., device="cpu") by Pippenger (signed, w = 6, 16 lanes) at 128
    points with full-width scalars, 0 and n - 1 among them."""
    curve = get_curve(name)
    pts, ks = _inputs(name, None)
    got = M.msm(curve, pts, ks, method="pippenger", device="cpu", **FULL)
    assert got == _host_msm(curve, pts, ks)


@pytest.mark.parametrize("name,case", REFERENCE, ids=[f"{n}-{c}" for n, c in REFERENCE])
def test_pippenger_limb_equal_to_reference(references, name, case):
    got = _port_pippenger(name, case)
    want = references[name, case].result()["mixed"]
    np.testing.assert_array_equal(interop.to_reference_limbs(got), want)


@pytest.mark.parametrize("name,case", REFERENCE + ORACLE_ONLY,
                         ids=[f"{n}-{c}" for n, c in REFERENCE + ORACLE_ONLY])
def test_pippenger_equals_host_oracle(name, case):
    curve = get_curve(name)
    pts, ks = _inputs(name, CASES[case]["bits"])
    assert _affine(curve, _port_pippenger(name, case)) == _host_msm(curve, pts, ks)


@pytest.mark.parametrize("name", [n for n, _ in MONT_SIGNED])
def test_reference_refuses_signed_digits_on_montgomery_fields(name):
    """tpu_ecc's XLA path (kernels=False) cannot run signed digits on a
    Montgomery field: tracing its window asserts that the negated y is not
    steady, so the port's signed path there is held against the host
    oracle alone (above) and, on the card, against its own twins."""
    from tpu_ecc.curves.specs import get_curve as j_curve
    from tpu_ecc.ops import fe as JF
    from tpu_ecc.parallel import msm as JM

    c = j_curve(name)
    cfg = CASES["s16"]
    xs, ys, k = _reference_inputs(name, "s16")["mixed"]
    with pytest.raises(AssertionError, match="not steady"):
        JM.msm_pippenger(c, JF.fe_steady(c.field, xs), JF.fe_steady(c.field, ys),
                         np.zeros(cfg["N"], bool), k, w=cfg["w"], lanes=cfg["lanes"],
                         scalar_bits=cfg["bits"], kernels=False, signed=True)
