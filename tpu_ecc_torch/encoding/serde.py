"""serdect-compatible wire formats (RustCrypto/serdect as used by the
reference's `serde` feature, e.g. k256/src/lib.rs Scalar/AffinePoint impls).

serdect's convention: human-readable formats (JSON & co.) carry fixed-width
*lowercase hex*; binary formats (bincode, CBOR) carry the raw fixed-width
big-endian bytes. Decoding accepts upper- or lower-case hex but rejects
mixed-length input. These helpers give byte-compatible output for scalars,
field elements and SEC1-encoded points.

The torch port's copy of tpu_ecc/encoding/serde.py, on the port's sec1.
"""

from __future__ import annotations

from ..curves.specs import CurveSpec
from . import sec1


class SerdeError(ValueError):
    pass


def serialize_hex(data: bytes) -> str:
    """serdect::slice::serialize_hex_lower_or_bin, human-readable arm."""
    return data.hex()


def deserialize_hex(s: str, expected_len: int | None = None) -> bytes:
    """Accepts upper or lower hex (serdect is case-insensitive on read)."""
    try:
        out = bytes.fromhex(s)
    except ValueError as e:
        raise SerdeError(f"invalid hex: {e}") from None
    if expected_len is not None and len(out) != expected_len:
        raise SerdeError(f"expected {expected_len} bytes, got {len(out)}")
    return out


def scalar_to_wire(curve: CurveSpec, k: int, human: bool = True):
    """Scalar -> serde wire form (hex str if human else bytes)."""
    if not 0 <= k < curve.n:
        raise SerdeError("scalar out of range")
    raw = int(k).to_bytes(curve.scalar_bytes, "big")
    return serialize_hex(raw) if human else raw


def scalar_from_wire(curve: CurveSpec, wire, human: bool = True) -> int:
    raw = deserialize_hex(wire, curve.scalar_bytes) if human else bytes(wire)
    if len(raw) != curve.scalar_bytes:
        raise SerdeError(f"expected {curve.scalar_bytes} bytes")
    k = int.from_bytes(raw, "big")
    if k >= curve.n:
        raise SerdeError("scalar not reduced")
    return k


def field_to_wire(curve: CurveSpec, x: int, human: bool = True):
    if not 0 <= x < curve.p:
        raise SerdeError("field element out of range")
    raw = int(x).to_bytes(curve.field_bytes, "big")
    return serialize_hex(raw) if human else raw


def field_from_wire(curve: CurveSpec, wire, human: bool = True) -> int:
    raw = deserialize_hex(wire, curve.field_bytes) if human else bytes(wire)
    if len(raw) != curve.field_bytes:
        raise SerdeError(f"expected {curve.field_bytes} bytes")
    x = int.from_bytes(raw, "big")
    if x >= curve.p:
        raise SerdeError("field element not reduced")
    return x


def point_to_wire(curve: CurveSpec, pt, human: bool = True,
                  compress: bool = True):
    """Affine point (or None = identity) -> SEC1 bytes / hex, matching the
    reference's serde impls on AffinePoint (compressed SEC1)."""
    raw = sec1.encode_point(curve, pt, compress)
    return serialize_hex(raw) if human else raw


def point_from_wire(curve: CurveSpec, wire, human: bool = True):
    raw = deserialize_hex(wire) if human else bytes(wire)
    pt = sec1.decode_point(curve, raw)
    return pt
