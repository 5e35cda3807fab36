"""RFC 6979 deterministic nonce generation (host-side HMAC-DRBG).

The torch port's own copy of tpu_ecc/protocols/rfc6979.py: the `rfc6979`
crate's semantics that the reference wires into every signer, with exact
bits2int / int2octets / bits2octets, qlen > hlen (P-521) and additional
data included.
"""

from __future__ import annotations

import hashlib
import hmac


def bits2int(data: bytes, qlen: int) -> int:
    """RFC 6979 §2.3.2: the leftmost qlen bits of `data` as an integer."""
    v = int.from_bytes(data, "big")
    blen = len(data) * 8
    if blen > qlen:
        v >>= blen - qlen
    return v


def int2octets(v: int, q: int) -> bytes:
    rolen = (q.bit_length() + 7) // 8
    return v.to_bytes(rolen, "big")


def bits2octets(data: bytes, q: int) -> bytes:
    z1 = bits2int(data, q.bit_length())
    z2 = z1 - q
    if z2 < 0:
        z2 = z1
    return int2octets(z2, q)


def generate_k(q: int, x: int, h1: bytes, hashname: str = "sha256",
               extra: bytes = b"") -> int:
    """Deterministic k per RFC 6979 §3.2 (with optional additional data)."""
    hfunc = getattr(hashlib, hashname) if hasattr(hashlib, hashname) else (
        lambda d=b"": hashlib.new(hashname, d))
    hlen = hfunc(b"").digest_size
    qlen = q.bit_length()
    V = b"\x01" * hlen
    K = b"\x00" * hlen

    def hm(key, msg):
        return hmac.new(key, msg, lambda d=b"": hfunc(d)).digest()

    seed = int2octets(x, q) + bits2octets(h1, q) + extra
    K = hm(K, V + b"\x00" + seed)
    V = hm(K, V)
    K = hm(K, V + b"\x01" + seed)
    V = hm(K, V)
    while True:
        T = b""
        while len(T) * 8 < qlen:
            V = hm(K, V)
            T += V
        k = bits2int(T, qlen)
        if 1 <= k < q:
            return k
        K = hm(K, V + b"\x00")
        V = hm(K, V)


def generate_k_batch(q: int, xs, h1s, hashname: str = "sha256",
                     extra: bytes = b"") -> list[int]:
    """Batched deterministic k. The native batch (tpu_ecc_torch/native) takes
    every shape it covers: qlen == 256, SHA-256 or SM3, no extra data and
    32-byte digests. The Python loop above takes the rest."""
    h1s = list(h1s)
    if (hashname in ("sha256", "sm3") and not extra and q.bit_length() == 256
            and all(len(h) == 32 for h in h1s)):
        from .. import native

        return native.rfc6979_k_batch(hashname, q, xs, h1s)
    return [generate_k(q, x, h1, hashname, extra) for x, h1 in zip(xs, h1s)]
