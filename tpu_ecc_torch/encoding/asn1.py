"""Minimal strict-DER TLV reader/writer for the key formats we support
(SPKI, PKCS#8, SEC1 ECPrivateKey), and PEM. Host-side.

The torch port's copy of tpu_ecc/encoding/asn1.py, unchanged."""

from __future__ import annotations

SEQUENCE = 0x30
INTEGER = 0x02
BIT_STRING = 0x03
OCTET_STRING = 0x04
OID = 0x06
CTX_0 = 0xA0
CTX_1 = 0xA1


class Asn1Error(ValueError):
    pass


def encode_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    b = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(b)]) + b


def tlv(tag: int, body: bytes) -> bytes:
    return bytes([tag]) + encode_len(len(body)) + body


def encode_integer(v: int) -> bytes:
    b = v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")
    if b[0] & 0x80:
        b = b"\x00" + b
    return tlv(INTEGER, b)


def encode_oid(dotted: str) -> bytes:
    parts = [int(x) for x in dotted.split(".")]
    body = bytes([40 * parts[0] + parts[1]])
    for p in parts[2:]:
        enc = [p & 0x7F]
        p >>= 7
        while p:
            enc.append(0x80 | (p & 0x7F))
            p >>= 7
        body += bytes(reversed(enc))
    return tlv(OID, body)


def read_tlv(data: bytes, pos: int):
    """-> (tag, body, next_pos)."""
    if pos + 2 > len(data):
        raise Asn1Error("truncated TLV")
    tag = data[pos]
    b0 = data[pos + 1]
    pos += 2
    if b0 < 0x80:
        n = b0
    else:
        nlen = b0 & 0x7F
        if nlen == 0 or nlen > 4 or pos + nlen > len(data):
            raise Asn1Error("bad length")
        n = int.from_bytes(data[pos: pos + nlen], "big")
        if n < 0x80 or n < (1 << (8 * (nlen - 1))):
            raise Asn1Error("non-minimal length")
        pos += nlen
    if pos + n > len(data):
        raise Asn1Error("truncated body")
    return tag, data[pos: pos + n], pos + n


def expect(data: bytes, pos: int, tag: int):
    t, body, pos = read_tlv(data, pos)
    if t != tag:
        raise Asn1Error(f"expected tag {tag:#x}, got {t:#x}")
    return body, pos


def decode_oid(body: bytes) -> str:
    if not body:
        raise Asn1Error("empty OID")
    parts = [body[0] // 40, body[0] % 40]
    v = 0
    for b in body[1:]:
        v = (v << 7) | (b & 0x7F)
        if not b & 0x80:
            parts.append(v)
            v = 0
    return ".".join(map(str, parts))


def decode_integer(body: bytes) -> int:
    if not body:
        raise Asn1Error("empty INTEGER")
    if body[0] & 0x80:
        raise Asn1Error("negative INTEGER unsupported")
    return int.from_bytes(body, "big")


# --- PEM ---

def pem_encode(der: bytes, label: str) -> str:
    import base64

    b64 = base64.b64encode(der).decode()
    lines = [b64[i: i + 64] for i in range(0, len(b64), 64)]
    return (f"-----BEGIN {label}-----\n" + "\n".join(lines)
            + f"\n-----END {label}-----\n")


def pem_decode(text: str, label: str | None = None) -> bytes:
    import base64
    import re

    m = re.search(r"-----BEGIN ([^-]+)-----(.*?)-----END ([^-]+)-----",
                  text, re.S)
    if not m or m.group(1) != m.group(3):
        raise Asn1Error("bad PEM framing")
    if label is not None and m.group(1) != label:
        raise Asn1Error(f"expected PEM label {label}, got {m.group(1)}")
    return base64.b64decode("".join(m.group(2).split()))
