"""BelT block cipher and belt-hash (STB 34.101.31), on the host.

The torch port's own copy of tpu_ecc/protocols/belt.py: the `belt-hash`
crate that the reference's bign-DSA uses (bign256/src/dsa/signing.rs). The
block cipher is checked at import against the standard's test vector
(STB 34.101.31 A.1, `BLOCK_SELFTEST_OK`); the hash is §6.9's sigma
compression over the block cipher.
"""

from __future__ import annotations

import struct

from .. import native

# H-substitution table (STB 34.101.31, table A.1)
_H_ROWS = [
    "B1 94 BA C8 0A 08 F5 3B 36 6D 00 8E 58 4A 5D E4",
    "85 04 FA 9D 1B B6 C7 AC 25 2E 72 C2 02 FD CE 0D",
    "5B E3 D6 12 17 B9 61 81 FE 67 86 AD 71 6B 89 0B",
    "5C B0 C0 FF 33 C3 56 B8 35 C4 05 AE D8 E0 7F 99",
    "E1 2B DC 1A E2 82 57 EC 70 3F CC F0 95 EE 8D F1",
    "C1 AB 76 38 9F E6 78 CA F7 C6 F8 60 D5 BB 9C 4F",
    "F3 3C 65 7B 63 7C 30 6A DD 4E A7 79 9E B2 3D 31",
    "3E 98 B5 6E 27 D3 BC CF 59 1E 18 1F 4C 5A B7 93",
    "E9 DE E7 2C 8F 0C 0F A6 2D DB 49 F4 6F 73 96 47",
    "06 07 53 16 ED 24 7A 37 39 CB A3 83 03 A9 8B F6",
    "92 BD 9B 1C E5 D1 41 01 54 45 FB C9 5E 4D 0E F2",
    "68 20 80 AA 22 7D 64 2F 26 87 F9 34 90 40 55 11",
    "BE 32 97 13 43 FC 9A 48 A0 2A 88 5F 19 4B 09 A1",
    "7E CD A4 D0 15 44 AF 8C A5 84 50 BF 66 D2 E8 8A",
    "A2 D7 46 52 42 A8 DF B3 69 74 C5 51 EB 23 29 21",
    "D4 EF D9 B4 3A 62 28 75 91 14 10 EA 77 6C DA 1D",
]
H = bytes.fromhex("".join(r.replace(" ", "") for r in _H_ROWS))
assert len(H) == 256

_M32 = 0xFFFFFFFF

BELT_IV = bytes.fromhex("b194bac80a08f53b366d008e584a5de4"
                       "8504fa9d1bb6c7ac252e72c202fdce0d")


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def _g(x, r):
    y = (H[x & 0xFF] | (H[(x >> 8) & 0xFF] << 8)
         | (H[(x >> 16) & 0xFF] << 16) | (H[(x >> 24) & 0xFF] << 24))
    return _rotl(y, r)


def belt_block_encrypt(block: bytes, key: bytes) -> bytes:
    """BelT block encryption (128-bit block, 256-bit key), STB 34.101.31 §6.1."""
    a, b, c, d = struct.unpack("<4I", block)
    k = struct.unpack("<8I", key)

    def K(i):  # 1-based schedule index
        return k[(i - 1) % 8]

    for i in range(1, 9):
        b ^= _g((a + K(7 * i - 6)) & _M32, 5)
        c ^= _g((d + K(7 * i - 5)) & _M32, 21)
        a = (a - _g((b + K(7 * i - 4)) & _M32, 13)) & _M32
        e = _g((b + c + K(7 * i - 3)) & _M32, 21) ^ i
        b = (b + e) & _M32
        c = (c - e) & _M32
        d = (d + _g((c + K(7 * i - 2)) & _M32, 13)) & _M32
        b ^= _g((a + K(7 * i - 1)) & _M32, 21)
        c ^= _g((d + K(7 * i)) & _M32, 5)
        a, b = b, a
        c, d = d, c
        b, c = c, b
    return struct.pack("<4I", b, d, a, c)


def _xor(x: bytes, y: bytes) -> bytes:
    return bytes(a ^ b for a, b in zip(x, y))


def belt_compress(x12: bytes, x34: bytes):
    """sigma compression (STB 34.101.31 §6.9): input X1||X2 (32B), X3||X4 (32B)
    -> (s (16B), Y (32B))."""
    x1, x2 = x12[:16], x12[16:]
    x3, x4 = x34[:16], x34[16:]
    # sigma1 = F(X3 ^ X4, X1 || X2) ^ X3 ^ X4
    s = _xor(_xor(belt_block_encrypt(_xor(x3, x4), x1 + x2), x3), x4)
    # sigma2: Y1 = F(X1, s || X4) ^ X1 ; Y2 = F(X2, (s ^ ones) || X3) ^ X2
    y1 = _xor(belt_block_encrypt(x1, s + x4), x1)
    y2 = _xor(belt_block_encrypt(x2, _xor(s, b"\xff" * 16) + x3), x2)
    return s, y1 + y2


def belt_hash(data: bytes) -> bytes:
    """One-shot belt-hash."""
    s, h = b"\x00" * 16, BELT_IV
    buf = data
    while len(buf) >= 32:
        block, buf = buf[:32], buf[32:]
        s1, h = belt_compress(block, h)
        s = _xor(s, s1)
    if buf:
        block = buf + b"\x00" * (32 - len(buf))
        s1, h = belt_compress(block, h)
        s = _xor(s, s1)
    length = struct.pack("<Q", len(data) * 8) + b"\x00" * 8
    _, out = belt_compress(length + s, h)
    return out


def belt_hash_batch(msgs) -> list:
    """belt-hash of each message, on the native batch (tpu_ecc_torch/native,
    about 1 µs a hash against `belt_hash`'s 0.5 ms); the messages may differ
    in length."""
    return native.belt_hash_batch(list(msgs))


# --- import-time self-test against STB 34.101.31 A.1 (block cipher) ---
_TEST_X = bytes.fromhex("b194bac80a08f53b366d008e584a5de4")
_TEST_K = bytes.fromhex("e9dee72c8f0c0fa62ddb49f46f739647"
                        "06075316ed247a3739cba38303a98bf6")
_TEST_Y = bytes.fromhex("69cca1c93557c9e3d66bc3e0fa88fa6e")
BLOCK_SELFTEST_OK = belt_block_encrypt(_TEST_X, _TEST_K) == _TEST_Y
