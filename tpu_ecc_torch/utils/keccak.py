"""Keccak-256 (original 0x01 padding, NOT NIST SHA3) — the Ethereum message
hash. Host-side helper mirroring the reference's use of sha3::Keccak256 in
its Ethereum end-to-end recovery test (k256/src/ecdsa.rs:317-343).

The torch port's copy of tpu_ecc/utils/keccak.py, unchanged (pure Python)."""

_MASK = (1 << 64) - 1

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROTC = [1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2, 14,
         27, 41, 56, 8, 25, 43, 62, 18, 39, 61, 20, 44]
_PIL = [10, 7, 11, 17, 18, 3, 5, 16, 8, 21, 24, 4,
        15, 23, 19, 13, 12, 2, 20, 14, 22, 9, 6, 1]


def _rotl(v: int, n: int) -> int:
    return ((v << n) | (v >> (64 - n))) & _MASK


def _f1600(st: list) -> None:
    for rc in _RC:
        # theta
        bc = [st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20]
              for i in range(5)]
        for i in range(5):
            t = bc[(i + 4) % 5] ^ _rotl(bc[(i + 1) % 5], 1)
            for j in range(0, 25, 5):
                st[j + i] ^= t
        # rho + pi
        t = st[1]
        for i in range(24):
            j = _PIL[i]
            st[j], t = _rotl(t, _ROTC[i]), st[j]
        # chi
        for j in range(0, 25, 5):
            row = st[j:j + 5]
            for i in range(5):
                st[j + i] = row[i] ^ ((~row[(i + 1) % 5]) & row[(i + 2) % 5])
        # iota
        st[0] ^= rc


def keccak256(data: bytes) -> bytes:
    rate = 136
    st = [0] * 25
    padded = bytearray(data) + b"\x01" + b"\x00" * ((-(len(data) + 1)) % rate)
    padded[-1] |= 0x80
    for blk in range(0, len(padded), rate):
        for i in range(rate // 8):
            st[i] ^= int.from_bytes(padded[blk + 8 * i:blk + 8 * i + 8], "little")
        _f1600(st)
    return b"".join(st[i].to_bytes(8, "little") for i in range(4))
