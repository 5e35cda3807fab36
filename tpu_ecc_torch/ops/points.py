"""Batched projective point arithmetic: complete Renes–Costello–Batina formulas.

Homogeneous projective coordinates (X : Y : Z), identity = (0 : 1 : 0), on
int64 limb tensors — the torch port of tpu_ecc/ops/points.py, limb-equal with
it. It carries the a = 0 formulas (RCB 2015 Algorithms 7/8/9, the secp256k1
path, b3 = 21 as a small-constant multiply), the a = -3 ones (Algorithms
4/5/6: P-256, P-384, P-521, P-224, SM2, bign256 and the brainpool t1 curves,
b as a full field multiply) and the generic-a ones (Algorithms 1/2/3: the
brainpool r1 curves, a and 3b as full field multiplies).

The formulas are exception-free on prime-order short-Weierstrass curves, so
identity and doubling cases need no branches. A point batch is three FE limb
tensors [n_limbs, *batch]; `point_limbs` packs them as [3, n_limbs, *batch].
"""

from __future__ import annotations

import dataclasses

import torch

from ..curves.specs import CurveSpec
from . import fe as F
from .fe import FE


@dataclasses.dataclass
class Point:
    """Batch of projective points on `curve`."""

    x: FE
    y: FE
    z: FE
    curve: CurveSpec

    @property
    def batch_shape(self):
        return self.x.batch_shape

    @property
    def device(self):
        return self.x.device

    def __add__(self, other):
        return padd(self, other)

    def __sub__(self, other):
        return padd(self, pneg(other))

    def __neg__(self):
        return pneg(self)


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def identity(curve: CurveSpec, batch_shape=(), device=None) -> Point:
    f = curve.field
    return Point(F.fe_zeros(f, batch_shape, device), F.fone(f, batch_shape, device),
                 F.fe_zeros(f, batch_shape, device), curve)


def generator(curve: CurveSpec, batch_shape=(), device=None) -> Point:
    f = curve.field
    return Point(F.fe_from_int(f, curve.gx, batch_shape, device),
                 F.fe_from_int(f, curve.gy, batch_shape, device),
                 F.fone(f, batch_shape, device), curve)


def from_affine(curve: CurveSpec, x: FE, y: FE, inf_mask=None) -> Point:
    """Affine (x, y) -> projective; inf_mask selects the identity per element."""
    f = curve.field
    z = F.fone(f, x.batch_shape, x.device)
    pt = Point(x, y, z, curve)
    if inf_mask is not None:
        pt = pselect(inf_mask, identity(curve, x.batch_shape, x.device), pt)
    return pt


def from_affine_ints(curve: CurveSpec, xs, ys, device=None) -> Point:
    f = curve.field
    return from_affine(curve, F.fe_from_ints(f, xs, device),
                       F.fe_from_ints(f, ys, device))


# ---------------------------------------------------------------------------
# predicates / conversions
# ---------------------------------------------------------------------------

def is_identity(P: Point) -> torch.Tensor:
    return F.fis_zero(P.z)


def pselect(mask, a: Point, b: Point) -> Point:
    return Point(F.fselect(mask, a.x, b.x), F.fselect(mask, a.y, b.y),
                 F.fselect(mask, a.z, b.z), a.curve)


def peq(P: Point, Q: Point) -> torch.Tensor:
    """Batched equality via cross-multiplication (identity-safe)."""
    ex = F.feq(F.fmul(P.x, Q.z), F.fmul(Q.x, P.z))
    ey = F.feq(F.fmul(P.y, Q.z), F.fmul(Q.y, P.z))
    return ex & ey


def pneg(P: Point) -> Point:
    return Point(P.x, F.fneg(P.y), P.z, P.curve)


def to_affine(P: Point):
    """Batched projective -> affine: (x, y, is_identity). One Fermat inversion
    per element, batched."""
    zi = F.finv(P.z)
    return F.fmul(P.x, zi), F.fmul(P.y, zi), is_identity(P)


def batch_normalize(P: Point):
    """Affine conversion with one field inversion for the whole batch
    (Montgomery's trick, `fe.fbatch_inv`; BatchNormalize,
    primeorder/src/projective.rs:363-413). Returns (x, y, is_identity)."""
    zi = F.fbatch_inv(P.z)
    return F.fmul(P.x, zi), F.fmul(P.y, zi), is_identity(P)


def on_curve(P: Point) -> torch.Tensor:
    """Projective curve membership: Y^2 Z = X^3 + a X Z^2 + b Z^3."""
    c = P.curve
    f = c.field
    x, y, z = P.x, P.y, P.z
    lhs = F.fmul(F.fsquare(y), z)
    z2 = F.fsquare(z)
    rhs = F.fmul(F.fsquare(x), x)
    if c.a != 0:
        rhs = rhs + F.fmul(F.fmul(F.fe_from_int(f, c.a, P.batch_shape, P.device),
                                  x), z2)
    rhs = rhs + F.fmul(F.fmul(F.fe_from_int(f, c.b, P.batch_shape, P.device), z2), z)
    return F.feq(lhs, rhs)


def steady(P: Point) -> Point:
    """Clamp coordinates to the per-spec steady loop invariant (carried limbs,
    bounded value), the state the kernels take and return."""
    return Point(F.fsteady(P.x), F.fsteady(P.y), F.fsteady(P.z), P.curve)


def point_limbs(P: Point) -> torch.Tensor:
    """Pack the 3 coordinates into one [3, n_limbs, *batch] tensor."""
    return torch.stack([P.x.limbs, P.y.limbs, P.z.limbs], 0)


def point_from_limbs(curve: CurveSpec, arr: torch.Tensor) -> Point:
    f = curve.field
    return Point(F.fe_steady(f, arr[0]), F.fe_steady(f, arr[1]),
                 F.fe_steady(f, arr[2]), curve)


def add_limbs(curve: CurveSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """steady(padd(a, b)) on packed steady limbs [3, n_limbs, *batch]: the
    step of every scan over packed points (the kernels' ksteady(padd))."""
    return point_limbs(steady(padd(point_from_limbs(curve, a), point_from_limbs(curve, b))))


def suffix_scan_limbs(curve: CurveSpec, limbs: torch.Tensor) -> torch.Tensor:
    """Hillis–Steele suffix scan of point limbs [3, n, *batch, W] over the
    last axis: out[i] = sum_{j >= i} in[j], one `add_limbs` per step with
    shift s = 1, 2, .., W/2, guarded (no wraparound)."""
    W = limbs.shape[-1]
    s = 1
    while s < W:
        head = add_limbs(curve, limbs[..., :W - s], limbs[..., s:])
        limbs = torch.cat([head, limbs[..., W - s:]], -1)
        s *= 2
    return limbs


def tree_total_limbs(curve: CurveSpec, limbs: torch.Tensor) -> torch.Tensor:
    """Lane 0 of the Hillis–Steele all-reduce of point limbs [3, n, *batch,
    W] (W a power of two) -> [3, n, *batch]. The all-reduce adds roll(acc,
    -s) at s = 1, 2, ..; lane 0's result needs at shift s only the lanes
    that are multiples of 2s, which read multiples of s and never wrap, so
    it is the pairwise tree acc[t] = acc[2t] + acc[2t+1]: W - 1 adds, the
    same limbs."""
    while limbs.shape[-1] > 1:
        limbs = add_limbs(curve, limbs[..., 0::2], limbs[..., 1::2])
    return limbs[..., 0]


# ---------------------------------------------------------------------------
# formula helpers
# ---------------------------------------------------------------------------

def _b3_mul(curve: CurveSpec, t: FE) -> FE:
    """Multiply by 3b — small-constant path when b is tiny (k256: 21)."""
    b3 = (3 * curve.b) % curve.p
    if curve.field.kind == "solinas" and b3 < (1 << 14):
        return F.fmul_small(t, b3)
    return F.fmul(F.fe_from_int(curve.field, b3, t.batch_shape, t.device), t)


def _b_mul(curve: CurveSpec, t: FE) -> FE:
    if curve.field.kind == "solinas" and curve.b < (1 << 14):
        return F.fmul_small(t, curve.b)
    return F.fmul(F.fe_from_int(curve.field, curve.b, t.batch_shape, t.device), t)


def _a_mul(curve: CurveSpec, t: FE) -> FE:
    return F.fmul(F.fe_from_int(curve.field, curve.a, t.batch_shape, t.device), t)


# ---------------------------------------------------------------------------
# RCB 2015 Algorithms 1-3: generic a
# ---------------------------------------------------------------------------

def _add_generic(P: Point, Q: Point) -> Point:
    c = P.curve
    X1, Y1, Z1 = P.x, P.y, P.z
    X2, Y2, Z2 = Q.x, Q.y, Q.z
    t0 = X1 * X2
    t1 = Y1 * Y2
    t2 = Z1 * Z2
    t3 = (X1 + Y1) * (X2 + Y2)
    t3 = t3 - (t0 + t1)
    t4 = (X1 + Z1) * (X2 + Z2)
    t4 = t4 - (t0 + t2)
    t5 = (Y1 + Z1) * (Y2 + Z2)
    t5 = t5 - (t1 + t2)
    Z3 = _a_mul(c, t4)
    X3 = _b3_mul(c, t2)
    Z3 = X3 + Z3
    X3 = t1 - Z3
    Z3 = t1 + Z3
    Y3 = X3 * Z3
    t1 = t0 + t0 + t0
    t2 = _a_mul(c, t2)
    t4 = _b3_mul(c, t4)
    t1 = t1 + t2
    t2 = _a_mul(c, t0 - t2)
    t4 = t4 + t2
    Y3 = Y3 + t1 * t4
    X3 = t3 * X3 - t5 * t4
    Z3 = t5 * Z3 + t3 * t1
    return Point(X3, Y3, Z3, c)


def _add_mixed_generic(P: Point, x2: FE, y2: FE) -> Point:
    c = P.curve
    X1, Y1, Z1 = P.x, P.y, P.z
    t0 = X1 * x2
    t1 = Y1 * y2
    t3 = (x2 + y2) * (X1 + Y1)
    t3 = t3 - (t0 + t1)
    t4 = x2 * Z1 + X1
    t5 = y2 * Z1 + Y1
    Z3 = _a_mul(c, t4)
    X3 = _b3_mul(c, Z1)
    Z3 = X3 + Z3
    X3 = t1 - Z3
    Z3 = t1 + Z3
    Y3 = X3 * Z3
    t1 = t0 + t0 + t0
    t2 = _a_mul(c, Z1)
    t4 = _b3_mul(c, t4)
    t1 = t1 + t2
    t2 = _a_mul(c, t0 - t2)
    t4 = t4 + t2
    Y3 = Y3 + t1 * t4
    X3 = t3 * X3 - t5 * t4
    Z3 = t5 * Z3 + t3 * t1
    return Point(X3, Y3, Z3, c)


def _double_generic(P: Point) -> Point:
    c = P.curve
    X, Y, Z = P.x, P.y, P.z
    t0 = X * X
    t1 = Y * Y
    t2 = Z * Z
    t3 = X * Y
    t3 = t3 + t3
    Z3 = X * Z
    Z3 = Z3 + Z3
    X3 = _a_mul(c, Z3)
    Y3 = _b3_mul(c, t2)
    Y3 = X3 + Y3
    X3 = t1 - Y3
    Y3 = t1 + Y3
    Y3 = X3 * Y3
    X3 = t3 * X3
    Z3 = _b3_mul(c, Z3)
    t2 = _a_mul(c, t2)
    t3 = _a_mul(c, t0 - t2)
    t3 = t3 + Z3
    t0 = t0 + t0 + t0 + t2
    t0 = t0 * t3
    Y3 = Y3 + t0
    t2 = Y * Z
    t2 = t2 + t2
    X3 = X3 - t2 * t3
    Z3 = t2 * t1
    Z3 = Z3 + Z3
    Z3 = Z3 + Z3
    return Point(X3, Y3, Z3, c)


# ---------------------------------------------------------------------------
# RCB 2015 Algorithms 4-6: a = -3
# ---------------------------------------------------------------------------

def _add_am3(P: Point, Q: Point) -> Point:
    c = P.curve
    X1, Y1, Z1 = P.x, P.y, P.z
    X2, Y2, Z2 = Q.x, Q.y, Q.z
    t0 = X1 * X2
    t1 = Y1 * Y2
    t2 = Z1 * Z2
    t3 = (X1 + Y1) * (X2 + Y2)
    t3 = t3 - (t0 + t1)
    t4 = (Y1 + Z1) * (Y2 + Z2)
    t4 = t4 - (t1 + t2)
    X3 = (X1 + Z1) * (X2 + Z2)
    Y3 = X3 - (t0 + t2)
    Z3 = _b_mul(c, t2)
    X3 = Y3 - Z3
    Z3 = X3 + X3
    X3 = X3 + Z3
    Z3 = t1 - X3
    X3 = t1 + X3
    Y3 = _b_mul(c, Y3)
    t1 = t2 + t2 + t2
    Y3 = Y3 - t1 - t0
    Y3 = Y3 + Y3 + Y3
    t0 = t0 + t0 + t0
    t0 = t0 - t1
    t1 = t4 * Y3
    t2 = t0 * Y3
    Y3 = X3 * Z3 + t2
    X3 = t3 * X3 - t1
    Z3 = t4 * Z3 + t3 * t0
    return Point(X3, Y3, Z3, c)


def _add_mixed_am3(P: Point, x2: FE, y2: FE) -> Point:
    c = P.curve
    X1, Y1, Z1 = P.x, P.y, P.z
    t0 = X1 * x2
    t1 = Y1 * y2
    t3 = (x2 + y2) * (X1 + Y1)
    t3 = t3 - (t0 + t1)
    t4 = y2 * Z1 + Y1
    Y3 = x2 * Z1 + X1
    Z3 = _b_mul(c, Z1)
    X3 = Y3 - Z3
    Z3 = X3 + X3
    X3 = X3 + Z3
    Z3 = t1 - X3
    X3 = t1 + X3
    Y3 = _b_mul(c, Y3)
    t1 = Z1 + Z1 + Z1
    Y3 = Y3 - t1 - t0
    Y3 = Y3 + Y3 + Y3
    t0 = t0 + t0 + t0
    t0 = t0 - t1
    t1 = t4 * Y3
    t2 = t0 * Y3
    Y3 = X3 * Z3 + t2
    X3 = t3 * X3 - t1
    Z3 = t4 * Z3 + t3 * t0
    return Point(X3, Y3, Z3, c)


def _double_am3(P: Point) -> Point:
    c = P.curve
    X, Y, Z = P.x, P.y, P.z
    t0 = X * X
    t1 = Y * Y
    t2 = Z * Z
    t3 = X * Y
    t3 = t3 + t3
    Z3 = X * Z
    Z3 = Z3 + Z3
    Y3 = _b_mul(c, t2)
    Y3 = Y3 - Z3
    X3 = Y3 + Y3
    Y3 = X3 + Y3
    X3 = t1 - Y3
    Y3 = t1 + Y3
    Y3 = X3 * Y3
    X3 = X3 * t3
    t2 = t2 + t2 + t2
    Z3 = _b_mul(c, Z3)
    Z3 = Z3 - t2 - t0
    Z3 = Z3 + Z3 + Z3
    t0 = t0 + t0 + t0
    t0 = t0 - t2
    t0 = t0 * Z3
    Y3 = Y3 + t0
    t0 = Y * Z
    t0 = t0 + t0
    Z3 = t0 * Z3
    X3 = X3 - Z3
    Z3 = t0 * t1
    Z3 = Z3 + Z3
    Z3 = Z3 + Z3
    return Point(X3, Y3, Z3, c)


# ---------------------------------------------------------------------------
# RCB 2015 Algorithms 7-9: a = 0 (k256 path)
# ---------------------------------------------------------------------------

def _add_a0(P: Point, Q: Point) -> Point:
    c = P.curve
    X1, Y1, Z1 = P.x, P.y, P.z
    X2, Y2, Z2 = Q.x, Q.y, Q.z
    t0 = X1 * X2
    t1 = Y1 * Y2
    t2 = Z1 * Z2
    t3 = (X1 + Y1) * (X2 + Y2)
    t3 = t3 - (t0 + t1)
    t4 = (Y1 + Z1) * (Y2 + Z2)
    t4 = t4 - (t1 + t2)
    X3 = (X1 + Z1) * (X2 + Z2)
    Y3 = X3 - (t0 + t2)
    t0 = t0 + t0 + t0
    t2 = _b3_mul(c, t2)
    Z3 = t1 + t2
    t1 = t1 - t2
    Y3 = _b3_mul(c, Y3)
    X3 = t4 * Y3
    t2 = t3 * t1
    X3 = t2 - X3
    Y3 = Y3 * t0
    t1 = t1 * Z3
    Y3 = t1 + Y3
    t0 = t0 * t3
    Z3 = Z3 * t4
    Z3 = Z3 + t0
    return Point(X3, Y3, Z3, c)


def _add_mixed_a0(P: Point, x2: FE, y2: FE) -> Point:
    c = P.curve
    X1, Y1, Z1 = P.x, P.y, P.z
    t0 = X1 * x2
    t1 = Y1 * y2
    t3 = (x2 + y2) * (X1 + Y1)
    t3 = t3 - (t0 + t1)
    t4 = y2 * Z1 + Y1
    Y3 = x2 * Z1 + X1
    t0 = t0 + t0 + t0
    t2 = _b3_mul(c, Z1)
    Z3 = t1 + t2
    t1 = t1 - t2
    Y3 = _b3_mul(c, Y3)
    X3 = t4 * Y3
    t2 = t3 * t1
    X3 = t2 - X3
    Y3 = Y3 * t0
    t1 = t1 * Z3
    Y3 = t1 + Y3
    t0 = t0 * t3
    Z3 = Z3 * t4
    Z3 = Z3 + t0
    return Point(X3, Y3, Z3, c)


def _double_a0(P: Point) -> Point:
    c = P.curve
    X, Y, Z = P.x, P.y, P.z
    t0 = Y * Y
    Z3 = t0 + t0
    Z3 = Z3 + Z3
    Z3 = Z3 + Z3
    t1 = Y * Z
    t2 = Z * Z
    t2 = _b3_mul(c, t2)
    X3 = t2 * Z3
    Y3 = t0 + t2
    Z3 = t1 * Z3
    t1 = t2 + t2
    t2 = t1 + t2
    t0 = t0 - t2
    Y3 = t0 * Y3
    Y3 = X3 + Y3
    t1 = X * Y
    X3 = t0 * t1
    X3 = X3 + X3
    return Point(X3, Y3, Z3, c)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

_ADD = {"generic": _add_generic, "a_minus3": _add_am3, "a0": _add_a0}
_ADD_MIXED = {"generic": _add_mixed_generic, "a_minus3": _add_mixed_am3,
              "a0": _add_mixed_a0}
_DOUBLE = {"generic": _double_generic, "a_minus3": _double_am3, "a0": _double_a0}


def padd(P: Point, Q: Point) -> Point:
    """Complete projective addition (exception-free, batched)."""
    assert P.curve is Q.curve
    return _ADD[P.curve.strategy](P, Q)


def padd_mixed(P: Point, x2: FE, y2: FE, q_identity=None) -> Point:
    """Complete mixed addition with affine Q = (x2, y2); `q_identity` is an
    optional bool[*batch] mask selecting P where Q is the identity."""
    out = _ADD_MIXED[P.curve.strategy](P, x2, y2)
    if q_identity is not None:
        out = pselect(q_identity, P, out)
    return out


def pdouble(P: Point) -> Point:
    """Exception-free doubling (batched)."""
    return _DOUBLE[P.curve.strategy](P)


def padd_chain(a: Point, b: Point, repeat: int) -> Point:
    """a + repeat*b as a chain of complete adds with a steady clamp after each
    — the batched point-add workload, on the `padd_chain` kernel."""
    from . import kernels

    c = a.curve
    out = kernels.padd_chain(c, point_limbs(steady(a)), point_limbs(steady(b)),
                             repeat)
    return point_from_limbs(c, out)
