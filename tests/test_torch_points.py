"""tpu_ecc_torch's point layer against tpu_ecc's and the host oracle.

The same steady point limbs, made from a seed with numpy and the host
oracle, go through tpu_ecc.ops.points (one jitted program per curve) and
tpu_ecc_torch.ops.points on the CPU. Tolerance: exact — equal limbs.
secp256k1 runs the a = 0 formulas on a solinas field, P-256 the a = -3
ones on a Montgomery field; the secp256k1 cases keep their bare ids.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ecc.curves.specs import get_curve as j_curve
from tpu_ecc.ops import points as JP
from tpu_ecc_torch import interop
from tpu_ecc_torch.curves.specs import get_curve
from tpu_ecc_torch.ops import fe as F
from tpu_ecc_torch.ops import kernels
from tpu_ecc_torch.ops import points as P
from tpu_ecc_torch.utils import ec_host as H

NAME = "secp256k1"
C = get_curve(NAME)
CURVES = (NAME, "p256")
REPEAT = 4


def _vec(name):
    return os.path.join(os.path.dirname(__file__), "vectors", f"group_{name}.json")


def _ids(values):
    """(curve, value) cases; secp256k1's keep the bare value as id."""
    return [pytest.param(c, v, id=str(v) if c == NAME else f"{c}-{v}")
            for c in CURVES for v in values]


def _affine_inputs(curve):
    """8 lanes of (a, b) affine points: random pairs, a doubling lane (a = b),
    an inverse pair (a = -b) and a lane where b is the identity."""
    rng = np.random.default_rng(7)
    G = H.aff_generator(curve)
    pts = [H.aff_mul(curve, int(k), G) for k in rng.integers(1, 2**62, 12)]
    a, b = pts[:8], pts[4:12]
    b[1] = a[1]
    b[2] = (a[2][0], curve.p - a[2][1])
    b[3] = None
    return a, b


def _limbs(curve, pts):
    """Projective steady limbs uint32 [3, n, B] of affine points (None = O)."""
    f = curve.field
    xs = [p[0] if p else 0 for p in pts]
    ys = [p[1] if p else 1 for p in pts]
    zs = [1 if p else 0 for p in pts]
    return np.stack([F.fe_from_ints(f, v, "cpu").limbs.numpy().astype(np.uint32)
                     for v in (xs, ys, zs)], 0)


@functools.lru_cache(maxsize=None)
def _results(name):
    curve = get_curve(name)
    a_aff, b_aff = _affine_inputs(curve)
    a_np, b_np = _limbs(curve, a_aff), _limbs(curve, b_aff)
    jc = j_curve(name)

    @jax.jit
    def run(a, b):
        pa, pb = JP.point_from_limbs(jc, a), JP.point_from_limbs(jc, b)
        s = JP.padd(pa, pb)
        d = JP.pdouble(pa)
        chain = pa
        for _ in range(REPEAT):          # bench.py's headline chain
            chain = JP.steady(JP.padd(chain, pb))
        return {"padd": JP.point_limbs(s), "pdouble": JP.point_limbs(d),
                "steady": JP.point_limbs(JP.steady(s)),
                "padd_kernel": JP.point_limbs(JP.steady(s)),
                "pdouble_kernel": JP.point_limbs(JP.steady(d)),
                "chain": JP.point_limbs(chain)}

    ref = {k: np.asarray(v) for k, v in run(jnp.asarray(a_np), jnp.asarray(b_np)).items()}
    pa = interop.point_from_reference(curve, a_np, "cpu")
    pb = interop.point_from_reference(curve, b_np, "cpu")
    s = P.padd(pa, pb)
    got = {"padd": P.point_limbs(s), "pdouble": P.point_limbs(P.pdouble(pa)),
           "steady": P.point_limbs(P.steady(s)),
           # the padd and pdouble kernels' wrappers (their twins on the CPU)
           "padd_kernel": P.point_limbs(kernels.padd_points(pa, pb)),
           "pdouble_kernel": P.point_limbs(kernels.pdouble_points(pa)),
           "chain": kernels.padd_chain(curve, P.point_limbs(pa), P.point_limbs(pb), REPEAT)}
    got = {k: interop.to_reference_limbs(v) for k, v in got.items()}
    return ref, got, a_aff, b_aff


@pytest.mark.parametrize("name, op", _ids(["padd", "pdouble", "steady", "chain",
                                           "padd_kernel", "pdouble_kernel"]))
def test_limb_equal_reference(name, op):
    ref, got, *_ = _results(name)
    np.testing.assert_array_equal(got[op], ref[op])


def _to_affine_ints(curve, limbs):
    x, y, inf = P.to_affine(P.point_from_limbs(curve, torch.from_numpy(limbs.astype(np.int64))))
    return [None if i else (xv, yv)
            for xv, yv, i in zip(F.fe_to_ints(x), F.fe_to_ints(y), inf.tolist())]


@pytest.mark.parametrize("name, op", _ids(["steady", "chain"]))
def test_matches_host_oracle(name, op):
    curve = get_curve(name)
    _, got, a_aff, b_aff = _results(name)
    want = {"steady": [H.aff_add(curve, a, b) for a, b in zip(a_aff, b_aff)],
            "chain": [H.aff_add(curve, a, H.aff_mul(curve, REPEAT, b) if b else None)
                      for a, b in zip(a_aff, b_aff)]}[op]
    assert _to_affine_ints(curve, got[op]) == want


def _pdouble_matches_host_oracle(curve):
    a_aff, _ = _affine_inputs(curve)
    pa = interop.point_from_reference(curve, _limbs(curve, a_aff), "cpu")
    got = P.point_limbs(P.steady(P.pdouble(pa))).numpy()
    assert _to_affine_ints(curve, got) == [H.aff_add(curve, a, a) for a in a_aff]


def _predicates_and_conversions(curve):
    a_aff, b_aff = _affine_inputs(curve)
    pa = interop.point_from_reference(curve, _limbs(curve, a_aff), "cpu")
    pb = interop.point_from_reference(curve, _limbs(curve, b_aff), "cpu")
    assert P.on_curve(pa).all() and P.on_curve(pb).all()
    assert P.is_identity(pb).tolist() == [p is None for p in b_aff]
    off = P.Point(pa.x, F.fadd(pa.y, F.fone(curve.field, (8,), "cpu")), pa.z, curve)
    assert not P.on_curve(off).any()
    neg = _to_affine_ints(curve, P.point_limbs(P.steady(P.pneg(pa))).numpy())
    assert neg == [(x, (-y) % curve.p) for x, y in a_aff]
    mask = torch.tensor([True, False] * 4)
    sel = P.point_limbs(P.pselect(mask, pa, pb))
    want = torch.where(mask, P.point_limbs(pa), P.point_limbs(pb))
    assert torch.equal(sel, want)
    ident = P.point_limbs(P.identity(curve, (8,), "cpu"))
    assert P.is_identity(P.point_from_limbs(curve, ident)).all()


def _group_add_vectors(curve):
    want = [(int(v["x"], 16), int(v["y"], 16))
            for v in json.load(open(_vec(curve.name)))["add"]]
    G = P.generator(curve, (1,), "cpu")
    acc, chain = G, []
    for _ in want:
        chain.append(P.point_limbs(acc))
        acc = P.steady(P.padd_mixed(acc, G.x, G.y))
    assert _to_affine_ints(curve, torch.cat(chain, -1).numpy()) == want


def test_pdouble_matches_host_oracle():
    _pdouble_matches_host_oracle(C)


def test_predicates_and_conversions():
    _predicates_and_conversions(C)


def test_group_add_vectors():
    """k*G for k = 1..20 (the reference's ADD_TEST_VECTORS) by a chain of
    complete mixed adds."""
    _group_add_vectors(C)


@pytest.mark.parametrize("check", [_pdouble_matches_host_oracle, _predicates_and_conversions,
                                   _group_add_vectors],
                         ids=["pdouble_host_oracle", "predicates", "group_add_vectors"])
def test_p256(check):
    """The three checks above on P-256 (a = -3, Montgomery field)."""
    check(get_curve("p256"))
