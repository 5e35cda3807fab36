"""Schnorr signatures (BIP 340), secp256k1 only — like k256's `schnorr` module.

The torch port of tpu_ecc/protocols/schnorr.py. The host does the tagged
hashes (a batch of one length on the native SHA-256), the nonce derivation
and the x-only key handling (k256/src/schnorr.rs:88-176); the group algebra
runs on the device in one core per chunk, behind the chunked pipeline
(protocols/pipeline.py):

- sign: R = k*G on the fixed-base comb (the `genmul` kernel), its affine
  form (z^-1 on the `pow` kernel), then x(R) as words and the parity of
  y(R); the same core gives the x-only public keys d*G;
- verify: lift_x on the device (y = sqrt(x^3 + b) at (p+1)/4 on `pow`, the
  even root), R = s*G + (n - e)*P through the GLV split (the `ladder`
  kernel, T = 2) and its affine form (`pow`); a lane is valid iff the root
  exists, R != O, x(R) == r and y(R) is even
  (k256/src/schnorr/verifying.rs:62-110).

Secret scalars (d, k) reach the device only: the comb and the derivation
select by mask, with no digit-dependent branch.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib

import numpy as np
import torch

from .. import native, resolve_device
from ..curves.specs import CurveSpec, get_curve
from ..ops import fe as F
from ..ops import points as P
from ..ops import scalarmul as SM
from ..utils import ec_host
from ..utils.bigint import be_bytes_to_int, int_to_be_bytes
from .ecdsa import _word_rows
from .pipeline import run_pipelined


def tagged_hash(tag: str, data: bytes) -> bytes:
    th = hashlib.sha256(tag.encode()).digest()
    return hashlib.sha256(th + th + data).digest()


@functools.lru_cache(maxsize=None)
def _tag_prefix(tag: str) -> bytes:
    th = hashlib.sha256(tag.encode()).digest()
    return th + th


def tagged_hash_batch(tag: str, datas) -> list:
    """Batched BIP340 tagged hashes: tagged(m) = SHA256(th||th||m), so a
    batch of one length runs on the native SHA-256 batch (native/); any
    other batch is hashed message by message."""
    pre = _tag_prefix(tag)
    msgs = [pre + d for d in datas]
    if len(msgs) > 1 and len({len(m) for m in msgs}) == 1:
        return native.sha256_batch(msgs)
    return [hashlib.sha256(m).digest() for m in msgs]


def lift_x(curve: CurveSpec, x: int):
    """BIP340 lift_x: point with given x and even y, or None."""
    if not 0 < x < curve.p:
        return None
    return ec_host.decompress(curve, x, False)


# ---------------------------------------------------------------------------
# the device cores
# ---------------------------------------------------------------------------

def _sign_core(curve: CurveSpec, buf: torch.Tensor) -> torch.Tensor:
    """buf: int64 scalar words [nws, B] on the device (k or d). Returns the
    words [nwf + 1, B] = x(k*G) | parity of y(k*G)."""
    s = curve.scalar
    _, nws = _word_rows(curve)
    k_raw = F.relimb(buf[:nws], 32, s.limb_bits, s.n_limbs)
    x, y, _ = P.to_affine(SM.mul_by_generator(curve, k_raw))
    y_odd = F.fto_raw_canonical(y)[0] & 1
    return torch.cat([F.fe_to_words(x), y_odd[None]], 0)


def _verify_core(curve: CurveSpec, buf: torch.Tensor) -> torch.Tensor:
    """buf: int64 words [2*nwf + 2*nws, B] on the device = px | r (field
    words) | s | n - e (scalar words). Returns bool [B]."""
    f, s = curve.field, curve.scalar
    nwf, nws = _word_rows(curve)
    bshape = tuple(buf.shape[1:])
    dev = buf.device
    o = 0
    px_w = buf[o:o + nwf]; o += nwf                              # noqa: E702
    r_w = buf[o:o + nwf]; o += nwf                               # noqa: E702
    s_w = buf[o:o + nws]; o += nws                               # noqa: E702
    ne_w = buf[o:o + nws]; o += nws                              # noqa: E702
    x = F.fe_from_words(f, px_w, f.bits)
    # lift_x: y = sqrt(x^3 + b) with even y (a = 0 for secp256k1)
    rhs = F.fmul(F.fsquare(x), x) + F.fe_from_int(f, curve.b, bshape, dev)
    y, is_sq = F.fsqrt(rhs)
    y_odd = (F.fto_raw_canonical(y)[0] & 1) == 1
    y = F.fselect(y_odd, F.fneg(y), y)
    Pp = P.from_affine(curve, x, y)
    G = P.generator(curve, bshape, dev)
    s_raw = F.relimb(s_w, 32, s.limb_bits, s.n_limbs)
    ne_raw = F.relimb(ne_w, 32, s.limb_bits, s.n_limbs)
    R = SM.lincomb_auto([(G, s_raw), (Pp, ne_raw)])
    xR, yR, inf = P.to_affine(R)
    okx = F.feq(xR, F.fe_from_words(f, r_w, f.bits))
    y_even = (F.fto_raw_canonical(yR)[0] & 1) == 0
    return is_sq & ~inf & okx & y_even


def xonly_public_keys(curve: CurveSpec, d_ints, chunk=None, device=None) -> list:
    """Batched x-only public keys x(d*G) on the constant-time device comb,
    chunk-pipelined; on the card unless `device` names another."""
    dev = resolve_device(device)
    sc = curve.scalar
    nwf, _ = _word_rows(curve)
    pk = run_pipelined(
        lambda buf: _sign_core(curve, buf),
        lambda sl: F.words_from_ints(list(d_ints[sl]), sc.bits),
        len(d_ints), chunk, F.words_from_ints([1], sc.bits), dev)
    return F.ints_from_words(pk[:nwf])


def sign_batch(curve: CurveSpec, d_ints, msgs, aux_rands, chunk=None, device=None):
    """Batched BIP340 sign. Returns a list of 64-byte signatures, with None
    in any lane whose derived nonce was zero — BIP340's "fail this signing
    attempt" per lane (k256/src/schnorr/signing.rs errors per signature;
    probability 2^-256, reachable only adversarially).

    Both scalar multiplications run chunk-pipelined on the device (the card
    unless `device` names another): the public keys d*G, then — after the
    host nonce hashing, batched on the native SHA-256 — R = k*G."""
    dev = resolve_device(device)
    n, fb = curve.n, curve.field_bytes
    B = len(d_ints)
    sc = curve.scalar
    nwf, _ = _word_rows(curve)
    pad = F.words_from_ints([1], sc.bits)

    def core(buf):
        return _sign_core(curve, buf)

    pk = run_pipelined(core, lambda sl: F.words_from_ints(list(d_ints[sl]), sc.bits),
                       B, chunk, pad, dev)
    px_ints = F.ints_from_words(pk[:nwf])
    py_odd = pk[nwf]
    # host nonce derivation (BIP340: aux + nonce tagged hashes), batched
    d_adj = [n - d if py_odd[i] else d for i, d in enumerate(d_ints)]
    pxs = [int_to_be_bytes(x, fb) for x in px_ints]
    aux_h = tagged_hash_batch("BIP0340/aux", list(aux_rands))
    rand = tagged_hash_batch("BIP0340/nonce", [
        int_to_be_bytes(dd ^ be_bytes_to_int(ah), 32) + px + m
        for dd, ah, px, m in zip(d_adj, aux_h, pxs, msgs)])
    ks = [be_bytes_to_int(r) % n for r in rand]
    k_bad = [k == 0 for k in ks]                 # per lane, not batch-wide
    ks = [1 if b else k for k, b in zip(ks, k_bad)]
    # R = k*G pipelined; flip k for odd-y R
    packed = run_pipelined(core, lambda sl: F.words_from_ints(ks[sl], sc.bits),
                           B, chunk, pad, dev)
    rxs = F.ints_from_words(packed[:nwf])
    y_odd = packed[nwf]
    rbs = [int_to_be_bytes(x, fb) for x in rxs]
    es = tagged_hash_batch("BIP0340/challenge", [
        rb + px + m for rb, px, m in zip(rbs, pxs, msgs)])
    sigs = []
    for i, (dd, k, rb, eh) in enumerate(zip(d_adj, ks, rbs, es)):
        if k_bad[i]:
            sigs.append(None)
            continue
        kf = n - k if y_odd[i] else k
        s = (kf + (be_bytes_to_int(eh) % n) * dd) % n
        sigs.append(rb + int_to_be_bytes(s, fb))
    return sigs


def verify_batch(curve: CurveSpec, px_ints, msgs, sigs, chunk=None, device=None):
    """Batched BIP340 verify. Returns list[bool]. The host does only range
    checks, hashing and word packing; the x-only decompress (lift_x) and all
    group algebra run batched on the device (the card unless `device` names
    another), chunk-pipelined for big batches."""
    dev = resolve_device(device)
    n, p, fb = curve.n, curve.p, curve.field_bytes
    f, sc = curve.field, curve.scalar
    pre_ok = []

    def prep(sl):
        xs, ss, nes, rs = [], [], [], []
        chall = tagged_hash_batch("BIP0340/challenge", [
            (sig[:fb] if len(sig) == 2 * fb else b"\x00" * fb)
            + int_to_be_bytes(px % p, fb) + m
            for px, m, sig in zip(px_ints[sl], msgs[sl], sigs[sl])])
        for px, sig, eh in zip(px_ints[sl], sigs[sl], chall):
            ok = len(sig) == 2 * fb and 0 < px < p
            r = be_bytes_to_int(sig[:fb]) if ok else 1
            s = be_bytes_to_int(sig[fb:]) if ok else 1
            ok = ok and r < p and s < n
            e = be_bytes_to_int(eh) % n if ok else 0
            if not ok:
                px, r, s = curve.gx, 1, 1
            pre_ok.append(ok)
            xs.append(px)
            ss.append(s)
            nes.append((n - e) % n)
            rs.append(r)
        return np.concatenate([
            F.words_from_ints(xs, f.bits),
            F.words_from_ints(rs, f.bits),
            F.words_from_ints(ss, sc.bits),
            F.words_from_ints(nes, sc.bits),
        ], axis=0)

    pad = np.concatenate([
        F.words_from_ints([curve.gx], f.bits),
        F.words_from_ints([1], f.bits),
        F.words_from_ints([1], sc.bits),
        F.words_from_ints([0], sc.bits),
    ], axis=0)
    raw = run_pipelined(lambda buf: _verify_core(curve, buf), prep, len(sigs), chunk,
                        pad, dev)
    return [bool(a and b) for a, b in zip(pre_ok, raw[0])]


# ---------------------------------------------------------------------------
# host key API (k256/src/schnorr/{signing,verifying}.rs analogues)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SigningKey:
    curve: CurveSpec
    d: int

    @classmethod
    def from_bytes(cls, data: bytes) -> "SigningKey":
        c = get_curve("secp256k1")
        d = be_bytes_to_int(data)
        if not 0 < d < c.n:
            raise ValueError("invalid secret")
        return cls(c, d)

    def verifying_key(self, device=None) -> "VerifyingKey":
        # the constant-time device comb on the secret d, never the host ladder
        pt = SM.derive_public(self.curve, self.d, device)
        return VerifyingKey(self.curve, pt[0])

    def sign_with_aux_rand(self, msg: bytes, aux: bytes, device=None) -> bytes:
        (sig,) = sign_batch(self.curve, [self.d], [msg], [aux], device=device)
        if sig is None:   # k == 0: BIP340 "fail this signing attempt"
            raise ValueError("derived nonce is zero; retry with fresh aux")
        return sig

    def sign(self, msg: bytes, device=None) -> bytes:
        return self.sign_with_aux_rand(msg, b"\x00" * 32, device)


@dataclasses.dataclass
class VerifyingKey:
    curve: CurveSpec
    x: int  # x-only public key

    @classmethod
    def from_bytes(cls, data: bytes) -> "VerifyingKey":
        c = get_curve("secp256k1")
        x = be_bytes_to_int(data)
        if lift_x(c, x) is None:
            raise ValueError("invalid x-only key")
        return cls(c, x)

    def to_bytes(self) -> bytes:
        return int_to_be_bytes(self.x, self.curve.field_bytes)

    def verify(self, msg: bytes, sig: bytes, device=None) -> bool:
        return verify_batch(self.curve, [self.x], [msg], [sig], device=device)[0]
