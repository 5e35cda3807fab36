"""Key serialization: SPKI / PKCS#8 / SEC1 ECPrivateKey DER+PEM, and JWK.

The reference gets these from the pkcs8/sec1/elliptic-curve crates and wires
them per curve (k256/src/lib.rs:93-163, p256/tests/pkcs8.rs with .der/.pem
fixtures, JWK via elliptic_curve::jwk). Byte-exact interop is the contract.

The torch port of tpu_ecc/encoding/keys.py, on the port's asn1, sec1 and
curve registry. The encoders that embed a public key derive it from the
secret on the device's constant-time comb (`scalarmul.derive_public`): on
the card unless `device` names another.
"""

from __future__ import annotations

import base64

from ..curves.specs import CurveSpec, get_curve, list_curves
from ..utils.bigint import be_bytes_to_int, int_to_be_bytes
from . import asn1, sec1
from .asn1 import (Asn1Error, BIT_STRING, CTX_0, CTX_1, INTEGER, OCTET_STRING,
                   OID, SEQUENCE, tlv)

EC_PUBLIC_KEY_OID = "1.2.840.10045.2.1"

JWK_CRV = {
    "p256": "P-256", "p384": "P-384", "p521": "P-521",
    "secp256k1": "secp256k1",
}
_CRV_TO_CURVE = {v: k for k, v in JWK_CRV.items()}


def _curve_by_oid(oid: str) -> CurveSpec:
    for name in list_curves():
        c = get_curve(name)
        if c.oid == oid:
            return c
    raise Asn1Error(f"unknown curve OID {oid}")


def _algid(curve: CurveSpec) -> bytes:
    return tlv(SEQUENCE, asn1.encode_oid(EC_PUBLIC_KEY_OID)
               + asn1.encode_oid(curve.oid))


# ---------------------------------------------------------------------------
# SPKI (SubjectPublicKeyInfo) — public keys
# ---------------------------------------------------------------------------

def spki_encode(curve: CurveSpec, point, compress: bool = False) -> bytes:
    pt = sec1.encode_point(curve, point, compress)
    return tlv(SEQUENCE, _algid(curve) + tlv(BIT_STRING, b"\x00" + pt))


def spki_decode(data: bytes):
    """-> (curve, (x, y))."""
    body, end = asn1.expect(data, 0, SEQUENCE)
    if end != len(data):
        raise Asn1Error("trailing bytes after SPKI")
    alg, pos = asn1.expect(body, 0, SEQUENCE)
    oid1, p2 = asn1.expect(alg, 0, OID)
    if asn1.decode_oid(oid1) != EC_PUBLIC_KEY_OID:
        raise Asn1Error("not an EC public key")
    oid2, _ = asn1.expect(alg, p2, OID)
    curve = _curve_by_oid(asn1.decode_oid(oid2))
    bs, pos = asn1.expect(body, pos, BIT_STRING)
    if not bs or bs[0] != 0:
        raise Asn1Error("bad BIT STRING padding")
    return curve, sec1.decode_point(curve, bs[1:])


# ---------------------------------------------------------------------------
# SEC1 ECPrivateKey (RFC 5915) and PKCS#8 (RFC 5958) — private keys
# ---------------------------------------------------------------------------

def ec_private_key_encode(curve: CurveSpec, d: int, include_curve: bool = True,
                          include_public: bool = True, device=None) -> bytes:
    fb = (curve.scalar.bits + 7) // 8
    body = asn1.encode_integer(1) + tlv(OCTET_STRING, int_to_be_bytes(d, fb))
    if include_curve:
        body += tlv(CTX_0, asn1.encode_oid(curve.oid))
    if include_public:
        # the constant-time device comb on the secret d, never the host ladder
        from ..ops import scalarmul as SM

        pub = SM.derive_public(curve, d, device)
        pt = sec1.encode_point(curve, pub, compress=False)
        body += tlv(CTX_1, tlv(BIT_STRING, b"\x00" + pt))
    return tlv(SEQUENCE, body)


def ec_private_key_decode(data: bytes, curve: CurveSpec | None = None):
    """-> (curve, d). Curve may come from the [0] field or the caller."""
    body, end = asn1.expect(data, 0, SEQUENCE)
    if end != len(data):
        raise Asn1Error("trailing bytes after ECPrivateKey")
    ver, pos = asn1.expect(body, 0, INTEGER)
    if asn1.decode_integer(ver) != 1:
        raise Asn1Error("bad ECPrivateKey version")
    priv, pos = asn1.expect(body, pos, OCTET_STRING)
    while pos < len(body):
        t, val, pos = asn1.read_tlv(body, pos)
        if t == CTX_0:
            oid, _ = asn1.expect(val, 0, OID)
            curve = _curve_by_oid(asn1.decode_oid(oid))
    if curve is None:
        raise Asn1Error("curve unspecified")
    d = be_bytes_to_int(priv)
    if not 0 < d < curve.n:
        raise Asn1Error("secret scalar out of range")
    return curve, d


def pkcs8_encode(curve: CurveSpec, d: int, device=None) -> bytes:
    ec = ec_private_key_encode(curve, d, include_curve=False, device=device)
    return tlv(SEQUENCE, asn1.encode_integer(0) + _algid(curve)
               + tlv(OCTET_STRING, ec))


def pkcs8_decode(data: bytes):
    """-> (curve, d)."""
    body, end = asn1.expect(data, 0, SEQUENCE)
    if end != len(data):
        raise Asn1Error("trailing bytes after PKCS#8")
    ver, pos = asn1.expect(body, 0, INTEGER)
    if asn1.decode_integer(ver) != 0:
        raise Asn1Error("bad PKCS#8 version")
    alg, pos = asn1.expect(body, pos, SEQUENCE)
    oid1, p2 = asn1.expect(alg, 0, OID)
    if asn1.decode_oid(oid1) != EC_PUBLIC_KEY_OID:
        raise Asn1Error("not an EC key")
    oid2, _ = asn1.expect(alg, p2, OID)
    curve = _curve_by_oid(asn1.decode_oid(oid2))
    inner, pos = asn1.expect(body, pos, OCTET_STRING)
    return ec_private_key_decode(inner, curve)


# --- PEM wrappers (labels match RFC 7468 / the reference's pem feature) ---

def spki_to_pem(curve, point, compress=False) -> str:
    return asn1.pem_encode(spki_encode(curve, point, compress), "PUBLIC KEY")


def spki_from_pem(text: str):
    return spki_decode(asn1.pem_decode(text, "PUBLIC KEY"))


def pkcs8_to_pem(curve, d, device=None) -> str:
    return asn1.pem_encode(pkcs8_encode(curve, d, device), "PRIVATE KEY")


def pkcs8_from_pem(text: str):
    return pkcs8_decode(asn1.pem_decode(text, "PRIVATE KEY"))


def ec_private_key_to_pem(curve, d, device=None) -> str:
    return asn1.pem_encode(ec_private_key_encode(curve, d, device=device),
                           "EC PRIVATE KEY")


def ec_private_key_from_pem(text: str):
    return ec_private_key_decode(asn1.pem_decode(text, "EC PRIVATE KEY"))


# ---------------------------------------------------------------------------
# JWK (RFC 7518 §6.2; elliptic_curve::jwk equivalent, k256/src/lib.rs:114-121)
# ---------------------------------------------------------------------------

def _b64url(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


def _unb64url(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def jwk_encode(curve: CurveSpec, point, d: int | None = None) -> dict:
    if curve.name not in JWK_CRV:
        raise ValueError(f"no JWK crv name for {curve.name}")
    fb = curve.field_bytes
    out = {
        "kty": "EC",
        "crv": JWK_CRV[curve.name],
        "x": _b64url(int_to_be_bytes(point[0], fb)),
        "y": _b64url(int_to_be_bytes(point[1], fb)),
    }
    if d is not None:
        out["d"] = _b64url(int_to_be_bytes(d, (curve.scalar.bits + 7) // 8))
    return out


def jwk_decode(jwk: dict):
    """-> (curve, (x, y), d_or_None)."""
    if jwk.get("kty") != "EC":
        raise ValueError("not an EC JWK")
    curve = get_curve(_CRV_TO_CURVE[jwk["crv"]])
    x = be_bytes_to_int(_unb64url(jwk["x"]))
    y = be_bytes_to_int(_unb64url(jwk["y"]))
    from ..utils import ec_host

    if not ec_host.on_curve(curve, (x, y)):
        raise ValueError("JWK point not on curve")
    d = be_bytes_to_int(_unb64url(jwk["d"])) if "d" in jwk else None
    return curve, (x, y), d
