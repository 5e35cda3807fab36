"""The generic-a formulas (RCB 2015 Algorithms 1-3) of the port's plain layer,
and ECDSA on the two curves that take them, bp256r1 and bp384r1.

The same inputs, made from a seed with numpy and the host oracle, go through
tpu_ecc and through the port with device="cpu" (the kernels' plain twins).
Tolerance: exact. The add, the mixed add and the doubling (O + O, P + O,
O + P, P + P and P + (-P) among the lanes) equal tpu_ecc.ops.points' limb
for limb, run op by op (no compile) in one niced worker process
(tests/p256_reference.py) that starts with the module, and
the host oracle's sums. ECDSA has no Brainpool file in tests/vectors/, so
derive, sign with the caller's k, verify and recover are held against the
host oracle (`ec_host`, which takes any a).

Budget: 150 s for the file at one process.
"""

import concurrent.futures
import functools
import multiprocessing
import os

import numpy as np
import pytest

import p256_reference
from fe32_harness import _affine_limbs, _affine_pairs, _steady_limbs
from tpu_ecc_torch import interop
from tpu_ecc_torch.curves.specs import get_curve
from tpu_ecc_torch.ops import fe as F
from tpu_ecc_torch.ops import points as P
from tpu_ecc_torch.ops import scalarmul as SM
from tpu_ecc_torch.protocols import ecdsa as E
from tpu_ecc_torch.utils import ec_host as H

CURVES = ("bp256r1", "bp384r1")
OPS = ("padd", "padd_mixed", "pdouble")
B = 8            # the formulas' lanes
SIGNS = 3        # the signatures a curve


def _plain_inputs(name):
    """{case: (curve, a [3, n, B], b [3, n, B])}: steady projective limbs
    at random representatives; the mixed add's b holds an affine operand
    (never O) with Z = 1."""
    curve = get_curve(name)
    rng = np.random.default_rng(21)
    a_aff, b_aff = _affine_pairs(curve, B)
    G = H.aff_generator(curve)
    a, b = _steady_limbs(curve, a_aff, rng), _steady_limbs(curve, b_aff, rng)
    xy = _affine_limbs(curve, [G if q is None else q for q in b_aff], rng)
    one = F.fone(curve.field, (B,), "cpu").limbs.numpy().astype(np.uint32)[None]
    return {f"{name}-padd": (name, a, b), f"{name}-pdouble": (name, a, a),
            f"{name}-padd_mixed": (name, a, np.concatenate([xy, one], 0))}


@pytest.fixture(scope="module", autouse=True)
def references():
    """tpu_ecc's formulas on both curves, op by op, in one niced worker
    process that runs while the port's tests run; the tests that read them
    come last."""
    inputs = {case: v for name in CURVES for case, v in _plain_inputs(name).items()}
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"),
            initializer=os.nice, initargs=(10,)) as pool:
        fut = pool.submit(p256_reference.plain_formulas, inputs, eager=True)
        yield functools.lru_cache(maxsize=None)(fut.result)
        pool.shutdown(cancel_futures=True)


def test_formulas_registered():
    """Both r1 curves take the generic strategy, and the plain layer has a
    formula of each kind for every strategy of the registry."""
    for name in CURVES:
        assert get_curve(name).strategy == "generic"
    for table in (P._ADD, P._ADD_MIXED, P._DOUBLE):
        assert set(table) == {"a0", "a_minus3", "generic"}


# ---------------------------------------------------------------------------
# ECDSA against the host oracle
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ecdsa(name):
    """SIGNS keys, digests and nonces from a seed; the port's derived keys,
    signatures at the caller's k, verify booleans (each signature, then
    each with the low bit of r flipped) and recovered keys, all on the
    CPU."""
    curve = get_curve(name)
    rng = np.random.default_rng(22)

    def scalar():
        return int.from_bytes(rng.bytes(curve.scalar_bytes + 8), "big") % (curve.n - 1) + 1

    ds = [scalar() for _ in range(SIGNS)]
    zs = [scalar() for _ in range(SIGNS)]
    ks = [scalar() for _ in range(SIGNS)]
    pubs = SM.derive_public_batch(curve, ds, device="cpu")
    sigs = E.sign_batch(curve, ds, zs, k_ints=ks, device="cpu")
    rs = [(r, s) for r, s, _ in sigs]
    flipped = [(r ^ 1, s) for r, s in rs]
    ok = E.verify_batch(curve, pubs + pubs, zs + zs, rs + flipped, device="cpu")
    rec = E.recover_batch(curve, zs, sigs, device="cpu")
    return ds, zs, ks, pubs, sigs, ok, rec


@pytest.mark.parametrize("name", CURVES)
def test_derive_and_sign_equal_oracle(name):
    """derive_public_batch equals d G and sign_batch at the caller's k
    equals the host oracle's (r, s) (no low-s), with k256's RecoveryId."""
    curve = get_curve(name)
    ds, zs, ks, pubs, sigs, _, _ = _ecdsa(name)
    G = H.aff_generator(curve)
    assert pubs == [H.aff_mul(curve, d, G) for d in ds]
    for d, z, k, (r, s, recid) in zip(ds, zs, ks, sigs):
        assert (r, s) == H.ecdsa_sign(curve, d, z, k, low_s=False)
        R = H.aff_mul(curve, k, G)
        assert recid == (R[1] & 1) | (int(R[0] >= curve.n) << 1)


@pytest.mark.parametrize("name", CURVES)
def test_verify_true_and_flipped_false(name):
    """verify_batch accepts every signature and refuses each with a bit of r
    flipped."""
    ok = _ecdsa(name)[5]
    assert ok == [True] * SIGNS + [False] * SIGNS


@pytest.mark.parametrize("name", CURVES)
def test_recover_equals_key(name):
    """recover_batch gives back each signer's key."""
    _, _, _, pubs, _, _, rec = _ecdsa(name)
    assert rec == pubs


# ---------------------------------------------------------------------------
# the plain formulas against tpu_ecc's (last: they wait for the workers)
# ---------------------------------------------------------------------------

def _affine_ints(curve, limbs):
    x, y, inf = P.to_affine(P.steady(interop.point_from_reference(curve, limbs, "cpu")))
    return [None if i else (xv, yv)
            for xv, yv, i in zip(F.fe_to_ints(x), F.fe_to_ints(y), inf.tolist())]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", CURVES)
def test_plain_formulas_limb_equal(references, name, op):
    """The port's generic add, mixed add and doubling: limb for limb against
    tpu_ecc.ops.points on the same steady inputs, and the host oracle's
    sums."""
    curve = get_curve(name)
    case = f"{name}-{op}"
    _, a, b = _plain_inputs(name)[case]
    pa = interop.point_from_reference(curve, a, "cpu")
    pb = interop.point_from_reference(curve, b, "cpu")
    out = {"padd_mixed": lambda: P.padd_mixed(pa, pb.x, pb.y),
           "padd": lambda: P.padd(pa, pb), "pdouble": lambda: P.pdouble(pa)}[op]()
    got = interop.to_reference_limbs(P.point_limbs(P.steady(out)))
    np.testing.assert_array_equal(got, references()[case])
    a_aff, b_aff = _affine_ints(curve, a), _affine_ints(curve, b)
    want = [H.aff_add(curve, u, u if op == "pdouble" else v) for u, v in zip(a_aff, b_aff)]
    assert _affine_ints(curve, got) == want
