"""ECDH: the batched device core and the host EphemeralSecret API.

The torch port of tpu_ecc/protocols/ecdh.py, which mirrors
elliptic_curve::ecdh (re-exported by k256/src/ecdh.rs): the shared secret
is the affine x-coordinate of d * Q_peer. On the device, in one core call:
the peer point's curve check, d*Q on the `ladder` kernel (through the GLV
split on secp256k1, one base without it elsewhere) and its affine form (the
`pow` kernel). The secret d reaches the device only, through the
constant-time ladder and comb.
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch

from .. import resolve_device
from ..curves.specs import CurveSpec, get_curve
from ..encoding import sec1
from ..ops import fe as F
from ..ops import points as P
from ..ops import scalarmul as SM
from ..utils.bigint import int_to_be_bytes


def _dh_core(curve: CurveSpec, qx: F.FE, qy: F.FE, d_raw: torch.Tensor) -> torch.Tensor:
    """The peer points (qx, qy) and canonical scalar limbs d_raw [ns, B] on
    the device -> words [nwf + 1, B] = x(d*Q) | ok."""
    Q = P.from_affine(curve, qx, qy)
    # peer-point curve membership INSIDE the library (the reference rejects
    # off-curve keys at decode, primeorder/src/affine.rs:164-195; this
    # batched entry point takes raw coordinates, so validate here — an
    # off-curve peer point is the classic invalid-curve attack input)
    valid = P.on_curve(Q)
    S = SM.scalar_mul(Q, d_raw)
    x, _, inf = P.to_affine(S)
    ok = valid & ~inf
    # one packed output, one device-to-host copy
    return torch.cat([F.fe_to_words(x), ok.to(F.LIMB)[None]], 0)


def diffie_hellman_batch(curve: CurveSpec, d_ints, peer_pts, device=None):
    """Batched raw ECDH -> per-lane shared-secret x-coordinate (int), or
    None where the lane failed (off-curve / out-of-range peer point, or an
    identity result, as for d = 0 mod n) — per-lane errors like the
    reference's per-call Result, never a batch-wide failure. Runs on the
    card unless `device` names another."""
    dev = resolve_device(device)
    p = curve.p
    pre_ok = [0 <= q[0] < p and 0 <= q[1] < p for q in peer_pts]
    g = (curve.gx, curve.gy)
    safe = [q if ok else g for q, ok in zip(peer_pts, pre_ok)]
    qx = F.fe_from_ints(curve.field, [q[0] for q in safe], dev)
    qy = F.fe_from_ints(curve.field, [q[1] for q in safe], dev)
    d_raw = SM.pack_scalars(curve, d_ints, dev)
    packed = _dh_core(curve, qx, qy, d_raw).cpu().numpy()
    nwf = (curve.field.bits + 31) // 32
    ok = packed[nwf]
    xs = F.ints_from_words(packed[:nwf])
    return [x if (po and o) else None
            for x, po, o in zip(xs, pre_ok, ok)]


@dataclasses.dataclass
class EphemeralSecret:
    """elliptic_curve::ecdh::EphemeralSecret analogue (host single-shot)."""

    curve: CurveSpec
    d: int

    @classmethod
    def random(cls, curve_name: str, rng) -> "EphemeralSecret":
        c = get_curve(curve_name)
        return cls(c, rng.randrange(1, c.n))

    def public_key(self, device=None):
        # the constant-time device comb on the secret d, never the host ladder
        return SM.derive_public(self.curve, self.d, device)

    def public_key_bytes(self, compress: bool = True, device=None) -> bytes:
        return sec1.encode_point(self.curve, self.public_key(device), compress)

    def diffie_hellman(self, peer_pt, device=None) -> "SharedSecret":
        (x,) = diffie_hellman_batch(self.curve, [self.d], [peer_pt], device)
        if x is None:
            raise ValueError("invalid peer public key (off-curve or identity)")
        return SharedSecret(self.curve, int_to_be_bytes(x, self.curve.field_bytes))


@dataclasses.dataclass
class SharedSecret:
    curve: CurveSpec
    raw: bytes

    def raw_secret_bytes(self) -> bytes:
        return self.raw

    def extract(self, hashname: str = "sha256", salt: bytes = b"") -> bytes:
        """HKDF-extract, as elliptic_curve::ecdh::SharedSecret::extract."""
        import hmac

        return hmac.new(salt or b"\x00" * hashlib.new(hashname).digest_size,
                        self.raw, hashname).digest()
