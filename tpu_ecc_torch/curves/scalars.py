"""Host-side scalar boundary types: the API-surface analogues of the
reference's `NonZeroScalar` / `ScalarPrimitive` (elliptic-curve crate) and
`Scalar::invert_vartime` (k256/src/arithmetic/scalar.rs:467-515).

The torch port's copy of tpu_ecc/curves/scalars.py. Secret-scalar
*arithmetic* is batched constant-time device code (ops/fe.py,
ops/scalarmul.py); these types guard the host boundaries where scalars
enter and leave the system (key material, signature components), so
invalid values (0, >= n) are rejected at construction instead of deep
inside a protocol.
"""

from __future__ import annotations

import dataclasses

from .specs import CurveSpec, get_curve


def invert_vartime(x: int, m: int) -> int:
    """Variable-time modular inversion for PUBLIC inputs (the reference's
    Scalar::invert_vartime, a Stein-gcd perf escape hatch). Host Python uses
    the native extended-gcd (`pow(x, -1, m)`); on device, batched Fermat
    inversion (fe.finv / fbatch_inv) amortizes better than any vartime
    ladder, so there is deliberately no device vartime path.
    Raises ValueError when x is not invertible."""
    return pow(x, -1, m)


@dataclasses.dataclass(frozen=True)
class NonZeroScalar:
    """An integer guaranteed in [1, n) for a curve's scalar field.

    Mirrors elliptic-curve's NonZeroScalar: construction validates, so any
    API accepting a NonZeroScalar cannot receive 0 or an out-of-range value
    (e.g. secret keys, signature r/s components).
    """

    curve: CurveSpec
    value: int

    def __post_init__(self):
        if not 0 < self.value < self.curve.n:
            raise ValueError(f"scalar out of range [1, n) for {self.curve.name}")

    # -- constructors ------------------------------------------------------
    @classmethod
    def new(cls, curve_name: str, value: int) -> "NonZeroScalar":
        return cls(get_curve(curve_name), value)

    @classmethod
    def from_bytes(cls, curve_name: str, data: bytes) -> "NonZeroScalar":
        c = get_curve(curve_name)
        if len(data) != c.scalar_bytes:
            raise ValueError(f"expected {c.scalar_bytes} bytes")
        return cls(c, int.from_bytes(data, "big"))

    @classmethod
    def random(cls, curve_name: str, rng) -> "NonZeroScalar":
        c = get_curve(curve_name)
        return cls(c, rng.randrange(1, c.n))

    # -- accessors ---------------------------------------------------------
    def __int__(self) -> int:
        return self.value

    def to_bytes(self) -> bytes:
        return self.value.to_bytes(self.curve.scalar_bytes, "big")

    # -- arithmetic (host, vartime: public-value domain) --------------------
    def invert_vartime(self) -> "NonZeroScalar":
        return NonZeroScalar(self.curve, invert_vartime(self.value, self.curve.n))

    def __mul__(self, other):
        o = int(other)
        v = (self.value * o) % self.curve.n
        return NonZeroScalar(self.curve, v)  # raises if the product is 0

    def negate(self) -> "NonZeroScalar":
        return NonZeroScalar(self.curve, self.curve.n - self.value)
