"""The third slice: the single-device MSM, port against tpu_ecc and the host
oracle, on the CPU.

The same inputs, made from a seed, go through tpu_ecc (jitted, its XLA path
on the CPU: `msm_pippenger(kernels=False)`, which tpu_ecc's own tests hold
bit-equal to its Pallas kernels) and through the port with device="cpu",
where the four Pippenger phases run their plain twins. Tolerance: exact —
equal limbs, or equal affine integers where the two packages take different
routes (Straus: tpu_ecc's CPU route is the stacked-table scan, the port's
the ladder, as tpu_ecc's accelerator route is).

tpu_ecc compiles five programs here (tests/msm_reference.py), each once
and reused across its inputs: three Pippenger signatures (16-bit unsigned
and signed at w = 5, full-width signed at w = 13), its Straus `msm()` and
one program for the point helpers, 20-50 s of XLA:CPU compile each. They
run in three worker processes while the port computes in this one: only
those that the selected tests need, all from the start where this process
runs the whole selection, the full-width case first.
"""

import concurrent.futures
import functools
import multiprocessing
import os
import random

import jax.numpy as jnp
import msm_reference
import numpy as np
import pytest
import torch

from tpu_ecc.curves.specs import get_curve as j_curve
from tpu_ecc.parallel import msm as JM
from tpu_ecc_torch import interop
from tpu_ecc_torch.curves.specs import get_curve
from tpu_ecc_torch.ops import fe as F
from tpu_ecc_torch.ops import kernels
from tpu_ecc_torch.ops import points as P
from tpu_ecc_torch.ops import scalarmul as SM
from tpu_ecc_torch.parallel import msm as M
from tpu_ecc_torch.utils import ec_host as H

NAME = "secp256k1"
C = get_curve(NAME)
G = H.aff_generator(C)

# case -> the Pippenger configuration, as tests/test_msm.py runs tpu_ecc's
CASES = {
    "full": dict(N=256, lanes=32, w=13, bits=None, signed=True),
    "u16": dict(N=128, lanes=16, w=5, bits=16, signed=False),
    "s16": dict(N=128, lanes=16, w=5, bits=16, signed=True),
}
PIPPENGER = [("full", "mixed"), ("u16", "mixed"), ("u16", "seven"),
             ("s16", "mixed"), ("s16", "seven")]


def _host_msm(pts, ks):
    """sum k_i * P_i by the host oracle, one aff_mul per distinct point."""
    total = {}
    for p_, k in zip(pts, ks):
        total[p_] = (total.get(p_, 0) + k) % C.n
    acc = None
    for p_, k in total.items():
        acc = H.aff_add(C, acc, H.aff_mul(C, k, p_))
    return acc


@functools.lru_cache(maxsize=None)
def _case_inputs(case):
    """(points, {scalar set: scalars}): 8 random base points tiled. 16-bit
    sets: random with zero scalars and 2^16 - 1 (carry chains), and 7 for
    every point (one bucket across every lane). Full width: random with 0
    and n - 1."""
    cfg = CASES[case]
    rng = random.Random(1234)
    base = [H.aff_mul(C, rng.randrange(1, C.n), G) for _ in range(8)]
    pts = [base[i % 8] for i in range(cfg["N"])]
    if cfg["bits"] is None:
        ks = [rng.randrange(0, C.n) for _ in pts]
        ks[0], ks[1] = 0, C.n - 1
        return pts, {"mixed": ks}
    ks = [rng.randrange(0, 1 << 16) for _ in pts]
    ks[0] = ks[3] = ks[5] = 0
    ks[1] = (1 << 16) - 1
    return pts, {"mixed": ks, "seven": [7] * len(pts)}


def _packed(pts, ks):
    """Affine limbs xs, ys [n, N] and scalar limbs [ns, N], int64 tensors."""
    f = C.field
    return (F.fe_from_ints(f, [p_[0] for p_ in pts], "cpu").limbs,
            F.fe_from_ints(f, [p_[1] for p_ in pts], "cpu").limbs,
            SM.pack_scalars(C, ks, "cpu"))


def _affine(limbs):
    """Projective limbs [3, n] -> the affine point as host ints (None for O)."""
    X, Y, Z = (F.fe_to_ints(F.fe_steady(C.field, limbs[i]))[0] for i in range(3))
    if Z == 0:
        return None
    zi = pow(Z, -1, C.p)
    return X * zi % C.p, Y * zi % C.p


@functools.lru_cache(maxsize=None)
def _straus_inputs():
    """msm() inputs: 9 random points with 16-bit scalars, zero scalars, and
    a total that cancels to the identity (P and -P)."""
    rng = random.Random(7)
    pts = [H.aff_mul(C, rng.randrange(1, C.n), G) for _ in range(9)]
    ks = [rng.randrange(1, 1 << 16) for _ in range(9)]
    return {"random": (pts, ks), "zero_scalars": (pts[:2], [0, 0]),
            "identity_total": ([G, (G[0], C.p - G[1])], [5, 5])}


@functools.lru_cache(maxsize=None)
def _helper_inputs():
    """Projective steady limbs [3, n, 8] of 8 points with random Z, lane 7
    the identity; and a second batch for peq: the same points under another
    Z in lanes 0-3, other points in 4-6, the identity in lane 7."""
    rng = random.Random(11)
    f = C.field

    def proj(pts):
        cols = []
        for pt in pts:
            if pt is None:
                cols.append((0, 1, 0))
                continue
            z = rng.randrange(1, C.p)
            cols.append((pt[0] * z % C.p, pt[1] * z % C.p, z))
        return torch.stack([F.fe_from_ints(f, [c[i] for c in cols], "cpu").limbs
                            for i in range(3)], 0)

    pts = [H.aff_mul(C, rng.randrange(1, C.n), G) for _ in range(7)] + [None]
    other = pts[:4] + [H.aff_mul(C, rng.randrange(1, C.n), G) for _ in range(3)] + [None]
    return pts, proj(pts), proj(other)


# ---------------------------------------------------------------------------
# tpu_ecc's results (tests/msm_reference.py), computed in worker processes
# ---------------------------------------------------------------------------

def _reference_job(key):
    """(function, arguments) of one of tpu_ecc's results."""
    ref = interop.to_reference_limbs
    if key == "straus":
        return msm_reference.straus, NAME, _straus_inputs()
    if key == "helpers":
        _, a, b = _helper_inputs()
        return msm_reference.helpers, NAME, ref(a), ref(b)
    pts, sets = _case_inputs(key)
    inputs = {name: tuple(ref(t) for t in _packed(pts, ks)) for name, ks in sets.items()}
    return msm_reference.pippenger, NAME, CASES[key], inputs


def _key_of(item):
    """The reference key a test of this module asks for, or None."""
    if item.originalname == "test_pippenger_limb_equal_to_reference":
        return item.callspec.params["case"]
    return {"test_msm_straus_equals_reference_and_oracle": "straus",
            "test_point_helpers_limb_equal_to_reference": "helpers"}.get(item.originalname)


class _References(dict):
    """tpu_ecc's results as futures, each submitted when first asked for."""

    def __init__(self, pool):
        super().__init__()
        self.pool = pool

    def __missing__(self, key):
        self[key] = self.pool.submit(*_reference_job(key))
        return self[key]


@pytest.fixture(scope="module")
def references(request):
    """tpu_ecc's results, computed in three worker processes (niced, so that
    the port's own work in this process, the longer path, keeps the cores
    it needs). A job starts when a test first asks for its key; where this
    process runs every selected test of the module (no xdist, or xdist's
    loadfile) the keys of those tests are asked for at once, the full-width
    case first, so that the compiles overlap."""
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=3, mp_context=multiprocessing.get_context("spawn"),
            initializer=os.nice, initargs=(10,)) as pool:
        refs = _References(pool)
        if getattr(request.config.option, "dist", "no") in ("no", "loadfile"):
            for item in request.session.items:
                if item.module is request.module and _key_of(item) is not None:
                    refs[_key_of(item)]
        yield refs
        pool.shutdown(cancel_futures=True)


# ---------------------------------------------------------------------------
# (a, b) msm_pippenger: limb-equal to tpu_ecc, equal to the host oracle
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _port_pippenger(case, name):
    cfg = CASES[case]
    f = C.field
    pts, sets = _case_inputs(case)
    xs, ys, k = _packed(pts, sets[name])
    pt = M.msm_pippenger(C, F.fe_steady(f, xs), F.fe_steady(f, ys),
                         torch.zeros(len(pts), dtype=torch.bool), k, w=cfg["w"],
                         lanes=cfg["lanes"], scalar_bits=cfg["bits"],
                         signed=cfg["signed"])
    return P.point_limbs(pt)


@pytest.mark.parametrize("case,name", PIPPENGER, ids=[f"{c}-{n}" for c, n in PIPPENGER])
def test_pippenger_limb_equal_to_reference(references, case, name):
    want = references[case]
    got = _port_pippenger(case, name)
    np.testing.assert_array_equal(interop.to_reference_limbs(got), want.result()[name])


@pytest.mark.parametrize("case,name", PIPPENGER, ids=[f"{c}-{n}" for c, n in PIPPENGER])
def test_pippenger_equals_host_oracle(case, name):
    pts, sets = _case_inputs(case)
    assert _affine(_port_pippenger(case, name)) == _host_msm(pts, sets[name])


# ---------------------------------------------------------------------------
# (c) window digits
# ---------------------------------------------------------------------------

DIGITS = [(5, 16), (8, 16), (5, None), (8, None), (13, None), (14, None), (16, None)]


@pytest.mark.parametrize("w,bits", DIGITS, ids=[f"w{w}-{b or 256}bit" for w, b in DIGITS])
def test_window_digits_equal_reference(w, bits):
    """Unsigned and signed w-bit windows equal tpu_ecc's; where bits % w ==
    0 the signed recoding adds the carry row."""
    rng = random.Random(w)
    top = 1 << 16 if bits else C.n
    ks = [0, top - 1, top >> 1, (top >> 1) - 1] + [rng.randrange(0, top) for _ in range(28)]
    k = SM.pack_scalars(C, ks, "cpu")
    kj = jnp.asarray(interop.to_reference_limbs(k))
    jc = j_curve(NAME)
    np.testing.assert_array_equal(M.wide_window_digits(C, k, w, bits).numpy(),
                                  np.asarray(JM.wide_window_digits(jc, kj, w, bits)))
    keys, negs = M.wide_window_digits_signed(C, k, w, bits)
    jkeys, jnegs = JM.wide_window_digits_signed(jc, kj, w, bits)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
    np.testing.assert_array_equal(negs.numpy(), np.asarray(jnegs))
    nbits = bits or C.scalar.bits
    assert keys.shape[0] == -(-nbits // w) + (nbits % w == 0)


# ---------------------------------------------------------------------------
# (d) msm(): Straus against tpu_ecc's msm() and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["random", "zero_scalars", "identity_total"])
def test_msm_straus_equals_reference_and_oracle(references, name):
    want = references["straus"]
    pts, ks = _straus_inputs()[name]
    got = M.msm(C, pts, ks, terms=2, scalar_bits=16, device="cpu")
    assert got == _host_msm(pts, ks)
    assert got == want.result()[name]


def test_msm_pads_and_checks_its_arguments():
    """Pippenger pads N to its lanes with identity points and zero scalars;
    a mesh that is not a DeviceMesh or an unknown method raises."""
    pts, sets = _case_inputs("u16")
    ks = sets["mixed"][:100]
    got = M.msm(C, pts[:100], ks, method="pippenger", w=5, lanes=16, scalar_bits=16,
                device="cpu")
    assert got == _host_msm(pts[:100], ks)
    with pytest.raises(TypeError, match="DeviceMesh"):
        M.msm(C, pts[:8], ks[:8], mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="unknown MSM method"):
        M.msm(C, pts[:8], ks[:8], method="bucketed", device="cpu")


# ---------------------------------------------------------------------------
# (e) tree_reduce_points, peq, batch_normalize, fbatch_inv
# ---------------------------------------------------------------------------

def test_point_helpers_limb_equal_to_reference(references):
    pts, a, b = _helper_inputs()
    want = references["helpers"].result()
    pa, pb = P.point_from_limbs(C, a), P.point_from_limbs(C, b)
    bx, by, binf = P.batch_normalize(pa)
    got = {"tree": P.point_limbs(M.tree_reduce_points(P.steady(pa))),
           "inv": F.fbatch_inv(pa.z).limbs, "bx": bx.limbs, "by": by.limbs,
           "binf": binf, "peq": P.peq(pa, pb)}
    for key, val in got.items():
        np.testing.assert_array_equal(val.numpy().astype(want[key].dtype), want[key],
                                      err_msg=key)
    assert list(want["peq"]) == [True] * 4 + [False] * 3 + [True]
    assert list(want["binf"]) == [False] * 7 + [True]
    assert F.fe_to_ints(F.fe_steady(C.field, bx.limbs))[:7] == [p_[0] for p_ in pts[:7]]
    assert _affine(got["tree"]) == _host_msm(pts[:7], [1] * 7)


# ---------------------------------------------------------------------------
# (f) the card requirement; the wrappers' checks
# ---------------------------------------------------------------------------

def test_msm_needs_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.msm(C, [G], [1])


def test_bucket_reduce_needs_a_power_of_two():
    b = P.point_limbs(P.identity(C, (6,), "cpu"))
    with pytest.raises(ValueError, match="power of two"):
        kernels.bucket_reduce(C, b, drop0=True)
