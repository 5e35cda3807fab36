"""bign-DSA (STB 34.101.45) over bign-curve256v1: the batched device cores
and the host key API.

The torch port of tpu_ecc/protocols/bign.py, with the reference's
`bign256` crate semantics (belt-hash, little-endian external encodings):

- sign (bign256/src/dsa/signing.rs:104-151): H = belt-hash(M), h = LE(H)
  mod q, k by RFC 6979 with HMAC-belt-hash, R = LE(x(k G)), S0 the first
  16 bytes of belt-hash(OID || R || H), S1 = (k - h - (S0 + 2^128) d) mod
  q; the signature is S0 (16 bytes) || S1 (32 bytes), little-endian;
- verify (bign256/src/dsa/verifying.rs:113-165): R = (S1 + h) G + (S0 +
  2^128) Q, rejected where it is O; accept iff S0 equals the first 16
  bytes of belt-hash(OID || LE(x(R)) || H).

The host hashes (belt-hash and its RFC 6979 on the native batch) and does
the scalar algebra around them; the device runs k G on the fixed-base comb
(the `genmul` kernel), the verify's lincomb on the two-term ladder (the
`ladder` kernel) and the affine x on the `pow` kernel, behind the chunked
pipeline (protocols/pipeline.py).
"""

from __future__ import annotations

import dataclasses
import hmac

import numpy as np
import torch

from .. import native, resolve_device
from ..curves.specs import CurveSpec, get_curve
from ..encoding import sec1
from ..ops import fe as F
from ..ops import points as P
from ..ops import scalarmul as SM
from . import rfc6979
from .belt import belt_hash, belt_hash_batch
from .pipeline import run_pipelined

# DER OID of belt-hash: 1.2.112.0.2.0.34.101.31.81 (bign256/src/dsa.rs:61-63)
BELT_OID = bytes([0x06, 0x09, 0x2A, 0x70, 0x00, 0x02, 0x00, 0x22, 0x65, 0x1F, 0x51])


class _BeltForHmac:
    """A hashlib-style belt-hash, so that `hmac` can drive it."""

    digest_size = 32
    block_size = 32
    name = "belt-hash"

    def __init__(self, data: bytes = b""):
        self._data = bytes(data)

    def update(self, d: bytes):
        self._data += d

    def digest(self) -> bytes:
        return belt_hash(self._data)

    def copy(self):
        return _BeltForHmac(self._data)


def _generate_k_belt(q: int, x: int, h1: bytes) -> int:
    """RFC 6979 with HMAC-belt-hash (the reference's generate_k::<BeltHash,
    _>), in Python."""
    qlen = q.bit_length()
    V = b"\x01" * 32
    K = b"\x00" * 32

    def hm(key, msg):
        return hmac.new(key, msg, _BeltForHmac).digest()

    seed = rfc6979.int2octets(x, q) + rfc6979.bits2octets(h1, q)
    K = hm(K, V + b"\x00" + seed)
    V = hm(K, V)
    K = hm(K, V + b"\x01" + seed)
    V = hm(K, V)
    while True:
        T = b""
        while len(T) * 8 < qlen:
            V = hm(K, V)
            T += V
        k = rfc6979.bits2int(T, qlen)
        if 1 <= k < q:
            return k
        K = hm(K, V + b"\x00")
        V = hm(K, V)


def _generate_k_belt_batch(q: int, xs, h1s) -> list:
    """RFC 6979 with HMAC-belt-hash for each (x, h1): the native batch
    (about 10 µs a nonce against 6 ms for `_generate_k_belt`)."""
    return native.rfc6979_k_batch("belt", q, list(xs), list(h1s))


# ---------------------------------------------------------------------------
# the device cores
# ---------------------------------------------------------------------------

def _kg_core(curve: CurveSpec, buf: torch.Tensor) -> torch.Tensor:
    """buf: int64 words [nws, B] of k on the device -> the words of x(k G)
    [nwf, B]."""
    s = curve.scalar
    x, _, _ = P.to_affine(SM.mul_by_generator(curve, F.relimb(buf, 32, s.limb_bits,
                                                                 s.n_limbs)))
    return F.fe_to_words(x)


def _lincomb_core(curve: CurveSpec, buf: torch.Tensor) -> torch.Tensor:
    """buf: int64 words [2*nwf + 2*nws, B] = qx | qy | a | b on the device
    -> the words of x(a G + b Q) | ok [nwf + 1, B], ok where Q is on the
    curve and the sum is not O."""
    f, s = curve.field, curve.scalar
    nwf, nws = (f.bits + 31) // 32, (s.bits + 31) // 32
    bshape = tuple(buf.shape[1:])
    dev = buf.device
    o = 0
    qx_w = buf[o:o + nwf]; o += nwf                              # noqa: E702
    qy_w = buf[o:o + nwf]; o += nwf                              # noqa: E702
    a_w = buf[o:o + nws]; o += nws                               # noqa: E702
    b_w = buf[o:o + nws]
    Q = P.from_affine(curve, F.fe_from_words(f, qx_w, f.bits), F.fe_from_words(f, qy_w, f.bits))
    R = SM.lincomb_auto([(P.generator(curve, bshape, dev),
                          F.relimb(a_w, 32, s.limb_bits, s.n_limbs)),
                         (Q, F.relimb(b_w, 32, s.limb_bits, s.n_limbs))])
    x, _, inf = P.to_affine(R)
    return torch.cat([F.fe_to_words(x), (P.on_curve(Q) & ~inf).to(F.LIMB)[None]], 0)


def sign_batch(curve: CurveSpec, d_ints, msgs, chunk=None, device=None) -> list:
    """Batched bign-DSA sign. Returns 48-byte signatures. Every belt-hash
    (the message, the nonce, S0) runs on the native batch; k G runs on the
    card unless `device` names another."""
    dev = resolve_device(device)
    q, s = curve.n, curve.scalar
    nwf = (curve.field.bits + 31) // 32
    Hs = belt_hash_batch(list(msgs))
    hs = [int.from_bytes(H, "little") % q for H in Hs]
    ks = _generate_k_belt_batch(q, d_ints, [h.to_bytes(32, "big") for h in hs])
    packed = run_pipelined(lambda buf: _kg_core(curve, buf),
                           lambda sl: F.words_from_ints(ks[sl], s.bits), len(d_ints), chunk,
                           F.words_from_ints([1], s.bits), dev)
    xs = F.ints_from_words(packed[:nwf])
    s0_fulls = belt_hash_batch([BELT_OID + int(x).to_bytes(32, "little") + H
                                for x, H in zip(xs, Hs)])
    sigs = []
    for h, k, d, s0_full in zip(hs, ks, d_ints, s0_fulls):
        s0 = int.from_bytes(s0_full[:16], "little")
        s1 = (k - h - (s0 + (1 << 128)) * d) % q
        sigs.append(s0.to_bytes(16, "little") + s1.to_bytes(32, "little"))
    return sigs


def verify_batch(curve: CurveSpec, pub_pts, msgs, sigs, chunk=None, device=None) -> list:
    """Batched bign-DSA verify. Returns list[bool]. A signature that is not
    48 bytes, an S1 >= q and coordinates outside [0, p) are rejected on
    the host; curve membership and R = O on the device (the card unless
    `device` names another)."""
    dev = resolve_device(device)
    q, p = curve.n, curve.p
    f, s = curve.field, curve.scalar
    nwf = (f.bits + 31) // 32
    Hs = belt_hash_batch(list(msgs))
    pre_ok, s0s = [], []

    def prep(sl):
        a_l, b_l, qx_l, qy_l = [], [], [], []
        for H, sig, (qx, qy) in zip(Hs[sl], sigs[sl], pub_pts[sl]):
            ok = len(sig) == 48
            s0 = int.from_bytes(sig[:16], "little") if ok else 0
            s1 = int.from_bytes(sig[16:], "little") if ok else 0
            ok = ok and s1 < q and 0 <= qx < p and 0 <= qy < p
            h = int.from_bytes(H, "little") % q
            pre_ok.append(ok)
            s0s.append(s0)
            a_l.append((s1 + h) % q if ok else 1)
            b_l.append((s0 + (1 << 128)) % q)
            qx_l.append(qx if ok else curve.gx)
            qy_l.append(qy if ok else curve.gy)
        return np.concatenate([F.words_from_ints(qx_l, f.bits), F.words_from_ints(qy_l, f.bits),
                               F.words_from_ints(a_l, s.bits), F.words_from_ints(b_l, s.bits)], 0)

    pad = np.concatenate([F.words_from_ints([curve.gx], f.bits),
                          F.words_from_ints([curve.gy], f.bits),
                          F.words_from_ints([1], s.bits), F.words_from_ints([1], s.bits)], 0)
    packed = run_pipelined(lambda buf: _lincomb_core(curve, buf), prep, len(sigs), chunk, pad,
                           dev)
    xs = F.ints_from_words(packed[:nwf])
    t_hashes = belt_hash_batch([BELT_OID + int(x).to_bytes(32, "little") + H
                                for x, H in zip(xs, Hs)])
    return [bool(ok and o and int.from_bytes(t[:16], "little") == s0)
            for ok, o, t, s0 in zip(pre_ok, packed[nwf], t_hashes, s0s)]


# ---------------------------------------------------------------------------
# host key API (the reference's bign256::dsa SigningKey and VerifyingKey)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SigningKey:
    curve: CurveSpec
    d: int

    @classmethod
    def from_bytes(cls, data: bytes) -> "SigningKey":
        """bign secret keys are little-endian (the reference's .reverse())."""
        c = get_curve("bign256")
        d = int.from_bytes(data, "little")
        if not 0 < d < c.n:
            raise ValueError("invalid secret")
        return cls(c, d)

    def verifying_key(self, device=None) -> "VerifyingKey":
        # the constant-time device comb on the secret d
        return VerifyingKey(self.curve, SM.derive_public(self.curve, self.d, device))

    def sign(self, msg: bytes, device=None) -> bytes:
        (sig,) = sign_batch(self.curve, [self.d], [msg], device=device)
        return sig


@dataclasses.dataclass
class VerifyingKey:
    curve: CurveSpec
    point: tuple

    @classmethod
    def from_sec1_bytes(cls, data: bytes) -> "VerifyingKey":
        c = get_curve("bign256")
        pt = sec1.decode_point(c, data)
        if pt is None:
            raise ValueError("identity public key")
        return cls(c, pt)

    def verify(self, msg: bytes, sig: bytes, device=None) -> bool:
        return verify_batch(self.curve, [self.point], [msg], [sig], device=device)[0]
