"""ECDSA sign, verify and public-key recovery: the batched device cores and
the host key API.

The torch port of tpu_ecc/protocols/ecdsa.py. The host does range and
policy checks, RFC 6979 nonces (protocols/rfc6979.py, on the native batch)
and packs 32-bit words; everything else runs on the device in one core per
chunk, behind the chunked pipeline (protocols/pipeline.py):

- sign: k*G on the fixed-base comb (the `genmul` kernel), its affine x
  (z^-1 on the `pow` kernel), r = x mod n with the overflow bit, k^-1 (the
  `pow` kernel), s = k^-1 (z + r d), low-s folding and the RecoveryId, in
  one packed output buffer;
- verify: the public key's curve check, s^-1 (`pow`), the lincomb
  u1*G + u2*Q (through the GLV split, the `ladder` kernel) and the x == r
  check, done projectively as X == r*Z or X == (r+n)*Z (mod p), so no
  affine inversion is needed;
- recover: R decompressed from r and the parity bit (a square root on
  `pow`), Q = r^-1 (s*R - z*G) as one lincomb (`ladder`) and its affine
  form (`pow`).

Policy follows tpu_ecc (and its reference): secp256k1 signs low-s and
rejects high s on verify; other curves accept both halves. RecoveryId has
k256's meaning: bit 0 the parity of y(R), bit 1 whether x(R) overflowed n.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from .. import native, resolve_device
from ..curves.specs import CurveSpec, get_curve
from ..encoding import der, sec1
from ..ops import fe as F
from ..ops import points as P
from ..ops import scalarmul as SM
from ..utils.bigint import be_bytes_to_int, int_to_limbs
from . import rfc6979
from .pipeline import DEFAULT_CHUNK, run_pipelined  # noqa: F401

# per-curve protocol defaults (DigestPrimitive in the reference)
CURVE_HASH = {
    "secp256k1": "sha256", "p192": "sha256", "p224": "sha224", "p256": "sha256",
    "p384": "sha384", "p521": "sha512", "bp256r1": "sha256", "bp256t1": "sha256",
    "bp384r1": "sha384", "bp384t1": "sha384", "sm2": "sm3", "bign256": "sha256",
}
LOW_S_CURVES = {"secp256k1"}
# p192 is verify-only in the reference (legacy curve, p192/src/ecdsa.rs:36-51)
SIGN_UNSUPPORTED = {"p192"}


def hash_msg(curve: CurveSpec, msg: bytes, hashname=None) -> bytes:
    hashname = hashname or CURVE_HASH[curve.name]
    return hashlib.new(hashname, msg).digest()


def hash_msgs(curve: CurveSpec, msgs, hashname=None) -> list:
    """Batched message hashing: a SHA-256 batch of messages of one length
    runs on the native batch (tpu_ecc_torch/native); any other batch is
    hashed message by message."""
    hashname = hashname or CURVE_HASH[curve.name]
    if hashname == "sha256" and len(msgs) > 1 and len({len(m) for m in msgs}) == 1:
        return native.sha256_batch(msgs)
    return [hash_msg(curve, m, hashname) for m in msgs]


def digest_to_z(curve: CurveSpec, digest: bytes) -> int:
    """bits2int of the digest (its leftmost qlen bits; p521's 512-bit
    digests against a 521-bit n), reduced mod n."""
    return rfc6979.bits2int(digest, curve.n.bit_length()) % curve.n


def sign_batch_msgs(curve: CurveSpec, d_ints, msgs, hashname=None, chunk=None,
                    low_s=None, device=None):
    """Batched sign over raw messages: `hash_msgs`, then `sign_batch`."""
    hashname = hashname or CURVE_HASH[curve.name]
    zs = [digest_to_z(curve, h) for h in hash_msgs(curve, msgs, hashname)]
    return sign_batch(curve, d_ints, zs, hashname=hashname, chunk=chunk,
                      low_s=low_s, device=device)


def verify_batch_msgs(curve: CurveSpec, pub_pts, msgs, sigs, hashname=None,
                      chunk=None, low_s=None, device=None):
    """Batched verify over raw messages: `hash_msgs`, then `verify_batch`."""
    hashname = hashname or CURVE_HASH[curve.name]
    zs = [digest_to_z(curve, h) for h in hash_msgs(curve, msgs, hashname)]
    return verify_batch(curve, pub_pts, zs, sigs, low_s=low_s, chunk=chunk,
                        device=device)


# ---------------------------------------------------------------------------
# the device core
# ---------------------------------------------------------------------------

def _word_rows(curve: CurveSpec):
    return (curve.field.bits + 31) // 32, (curve.scalar.bits + 31) // 32


def _sign_core(curve: CurveSpec, low_s: bool, buf: torch.Tensor) -> torch.Tensor:
    """buf: int64 words [3*nws, B] on the device = k | z | d. Returns the
    words [2*nws + 2, B] = r | s | recid | bad (r == 0 or s == 0); s is
    folded to the low half when `low_s` (IsHigh + negate, k256
    ecdsa.rs:192-197) and recid's parity bit follows the fold."""
    f, s = curve.field, curve.scalar
    _, nws = _word_rows(curve)
    bshape = tuple(buf.shape[1:])
    k_w, z_w, d_w = buf[:nws], buf[nws:2 * nws], buf[2 * nws:3 * nws]
    k_raw = F.relimb(k_w, 32, s.limb_bits, s.n_limbs)
    k_m = F.fe_from_words(s, k_w, s.bits)
    z_m = F.fe_from_words(s, z_w, s.bits)
    d_m = F.fe_from_words(s, d_w, s.bits)
    x_aff, y_aff, _ = P.to_affine(SM.mul_by_generator(curve, k_raw))
    r_raw, r_overflow = F.field_to_scalar_raw(f, s, x_aff)
    y_odd = (F.fto_raw_canonical(y_aff)[0] & 1) == 1
    # s = k^-1 (z + r d); r enters Montgomery form via * enc(R) = R^2
    r_m = F.fmul(F.FE(r_raw, s, s.mask, s.p - 1), F.fe_from_int(s, s.r, bshape, buf.device))
    sig_raw = F.fto_raw_canonical(F.fmul(F.finv(k_m), z_m + F.fmul(r_m, d_m)))
    _, s_high = F._cond_sub(s, sig_raw, int_to_limbs(s.p // 2 + 1, s.n_limbs, s.limb_bits))
    flip = s_high if low_s else torch.zeros_like(s_high)
    neg = F.fcanonical(F.fneg(F.FE(sig_raw, s, s.mask, s.p - 1))).limbs
    recid = (y_odd ^ flip).to(F.LIMB) | (r_overflow.to(F.LIMB) << 1)
    bad = (r_raw == 0).all(0) | (sig_raw == 0).all(0)
    return torch.cat([F.relimb(r_raw, s.limb_bits, 32, nws),
                      F.relimb(torch.where(flip, neg, sig_raw), s.limb_bits, 32, nws),
                      recid[None], bad.to(F.LIMB)[None]], 0)


def _verify_core(curve: CurveSpec, buf: torch.Tensor) -> torch.Tensor:
    """buf: int64 words [2*nwf + 3*nws + 1, B] on the device = qx | qy | z |
    r | s | (r + n < p). Returns bool [B]."""
    f, s = curve.field, curve.scalar
    nwf, nws = _word_rows(curve)
    bshape = tuple(buf.shape[1:])
    dev = buf.device
    o = 0
    qx_w = buf[o:o + nwf]; o += nwf                              # noqa: E702
    qy_w = buf[o:o + nwf]; o += nwf                              # noqa: E702
    z_w = buf[o:o + nws]; o += nws                               # noqa: E702
    r_w = buf[o:o + nws]; o += nws                               # noqa: E702
    s_w = buf[o:o + nws]; o += nws                               # noqa: E702
    rn_valid = buf[o] == 1
    qx = F.fe_from_words(f, qx_w, f.bits)
    qy = F.fe_from_words(f, qy_w, f.bits)
    # the public key must lie on the curve before it reaches the lincomb
    rhs = F.fmul(F.fsquare(qx), qx)
    if curve.a != 0:
        rhs = rhs + F.fmul(F.fe_from_int(f, curve.a, bshape, dev), qx)
    rhs = rhs + F.fe_from_int(f, curve.b, bshape, dev)
    q_on_curve = F.feq(F.fsquare(qy), rhs)
    z_m = F.fe_from_words(s, z_w, s.bits)
    r_m = F.fe_from_words(s, r_w, s.bits)
    s_m = F.fe_from_words(s, s_w, s.bits)
    sinv = F.finv(s_m)
    u1 = F.fto_raw_canonical(F.fmul(z_m, sinv))
    u2 = F.fto_raw_canonical(F.fmul(r_m, sinv))
    Q = P.from_affine(curve, qx, qy)
    G = P.generator(curve, bshape, dev)
    R = SM.lincomb_auto([(G, u1), (Q, u2)])
    # r == x(R) mod n  <=>  X == r*Z or X == (r+n)*Z  (projective check)
    r_f = F.fe_from_words(f, r_w, s.bits)
    n_f = F.fe_from_int(f, s.p % f.p, bshape, dev)
    rn_f = r_f + n_f        # the integer r + n where rn_valid (r + n < p)
    ok1 = F.feq(R.x, F.fmul(r_f, R.z))
    ok2 = rn_valid & F.feq(R.x, F.fmul(rn_f, R.z))
    not_inf = ~P.is_identity(R)
    return q_on_curve & not_inf & (ok1 | ok2)


def sign_batch(curve: CurveSpec, d_ints, z_ints, k_ints=None, hashname=None,
               low_s=None, _raw_flags=False, chunk=None, device=None) -> list:
    """Batched deterministic ECDSA. Returns [(r, s, recovery_id)].

    Nonces come from RFC 6979 on the host unless the caller gives k_ints;
    all field and group algebra runs batched on the device (the card unless
    `device` names another) with word-packed input and output. A lane whose
    r or s is 0 is signed again with a fresh RFC 6979 nonce (additional
    data 1, 2, ..., as the reference retries); with a caller's k it raises
    ValueError."""
    n = curve.n
    if curve.name in SIGN_UNSUPPORTED:
        raise NotImplementedError(
            f"{curve.name} is verify-only, matching the reference"
            " (p192/src/ecdsa.rs:36-51)")
    dev = resolve_device(device)
    low_s = (curve.name in LOW_S_CURVES) if low_s is None else bool(low_s)
    hashname = hashname or CURVE_HASH[curve.name]
    s = curve.scalar
    nb = (n.bit_length() + 7) // 8

    def prep(sl):
        """One chunk's nonces and its packed input buffer k | z | d."""
        z_c = [z % n for z in z_ints[sl]]
        d_c = list(d_ints[sl])
        if k_ints is not None:
            k_c = list(k_ints[sl])
        else:
            k_c = rfc6979.generate_k_batch(
                n, d_c, [int(z).to_bytes(nb, "big") for z in z_c], hashname)
        return np.concatenate([F.words_from_ints(v, s.bits) for v in (k_c, z_c, d_c)], 0)

    pad = np.concatenate([F.words_from_ints([v], s.bits) for v in (1, 0, 1)], 0)
    packed = run_pipelined(lambda buf: _sign_core(curve, low_s, buf), prep,
                           len(d_ints), chunk, pad, dev)
    _, nws = _word_rows(curve)
    rs = F.ints_from_words(packed[:nws])
    ss = F.ints_from_words(packed[nws:2 * nws])
    out = [(r, s_, int(rc)) for r, s_, rc in zip(rs, ss, packed[2 * nws])]
    if _raw_flags:
        return [sig + (bool(b),) for sig, b in zip(out, packed[2 * nws + 1])]
    bad = np.flatnonzero(packed[2 * nws + 1])
    if bad.size:
        # r == 0 or s == 0 (probability ~2^-250, but reachable with a
        # caller's k): RFC 6979 §3.2 step h.3 re-enters the nonce loop.
        if k_ints is not None:
            raise ValueError(f"r or s is zero for caller-supplied k at "
                             f"lanes {bad.tolist()[:8]}")
        for i in map(int, bad):
            retry, sig_i = 1, None
            while sig_i is None or sig_i[3]:
                k_i = rfc6979.generate_k(
                    n, d_ints[i], int(z_ints[i] % n).to_bytes(nb, "big"),
                    hashname, extra=retry.to_bytes(4, "big"))
                sig_i = sign_batch(curve, [d_ints[i]], [z_ints[i]], k_ints=[k_i],
                                   hashname=hashname, low_s=low_s, _raw_flags=True,
                                   device=dev)[0]
                retry += 1
            out[i] = sig_i[:3]
    return out


def verify_batch(curve: CurveSpec, pub_pts, z_ints, sigs, low_s=None,
                 chunk=None, device=None) -> list:
    """Batched verify. pub_pts: list of affine (x, y); z_ints: message
    digests as ints; sigs: list of (r, s). Returns list[bool].

    Runs on the card unless `device` names another. Coordinates outside
    [0, p) and r, s outside (0, n) (and high s on low-s curves) are rejected
    on the host; curve membership is checked on the device."""
    dev = resolve_device(device)
    n, p = curve.n, curve.p
    low_s = (curve.name in LOW_S_CURVES) if low_s is None else low_s
    s, f = curve.scalar, curve.field
    pre_ok = []

    def prep(sl):
        r_l, s_l, z_l, rn_valid, qx_l, qy_l = [], [], [], [], [], []
        for (r, sg), z, (qx, qy) in zip(sigs[sl], z_ints[sl], pub_pts[sl]):
            ok = 0 < r < n and 0 < sg < n and 0 <= qx < p and 0 <= qy < p
            if low_s and sg > n // 2:
                ok = False
            pre_ok.append(ok)
            r_l.append(r if ok else 1)
            s_l.append(sg if ok else 1)
            qx_l.append(qx if ok else curve.gx)
            qy_l.append(qy if ok else curve.gy)
            z_l.append(z % n)
            rn_valid.append(r + n < p)
        return np.concatenate([
            F.words_from_ints(qx_l, f.bits),
            F.words_from_ints(qy_l, f.bits),
            F.words_from_ints(z_l, s.bits),
            F.words_from_ints(r_l, s.bits),
            F.words_from_ints(s_l, s.bits),
            np.array(rn_valid, np.uint32)[None],
        ], axis=0)

    pad = np.concatenate([
        F.words_from_ints([curve.gx], f.bits),
        F.words_from_ints([curve.gy], f.bits),
        F.words_from_ints([0], s.bits),
        F.words_from_ints([1], s.bits),
        F.words_from_ints([1], s.bits),
        np.ones((1, 1), np.uint32),
    ], axis=0)
    raw = run_pipelined(lambda buf: _verify_core(curve, buf), prep, len(sigs),
                        chunk, pad, dev)
    return [bool(a and b) for a, b in zip(pre_ok, raw[0])]


def _recover_core(curve: CurveSpec, buf: torch.Tensor) -> torch.Tensor:
    """buf: int64 words [nwf + 3*nws + 1, B] = x | z | r | s | y_odd.
    Returns the words [2*nwf + 1, B] = qx | qy | ok."""
    f, s = curve.field, curve.scalar
    nwf, nws = _word_rows(curve)
    bshape = tuple(buf.shape[1:])
    dev = buf.device
    o = 0
    x_w = buf[o:o + nwf]; o += nwf                               # noqa: E702
    z_w = buf[o:o + nws]; o += nws                               # noqa: E702
    r_w = buf[o:o + nws]; o += nws                               # noqa: E702
    s_w = buf[o:o + nws]; o += nws                               # noqa: E702
    want_odd = buf[o] == 1
    x = F.fe_from_words(f, x_w, f.bits)
    # decompress: y = sqrt(x^3 + a x + b), then match the parity bit
    rhs = F.fmul(F.fsquare(x), x)
    if curve.a != 0:
        rhs = rhs + F.fmul(F.fe_from_int(f, curve.a, bshape, dev), x)
    rhs = rhs + F.fe_from_int(f, curve.b, bshape, dev)
    y, is_sq = F.fsqrt(rhs)
    y_odd = (F.fto_raw_canonical(y)[0] & 1) == 1
    y = F.fselect(y_odd != want_odd, F.fneg(y), y)
    # u1 = -z r^-1, u2 = s r^-1 (mod n)
    z_m = F.fe_from_words(s, z_w, s.bits)
    r_m = F.fe_from_words(s, r_w, s.bits)
    s_m = F.fe_from_words(s, s_w, s.bits)
    rinv = F.finv(r_m)
    u1 = F.fto_raw_canonical(F.fmul(F.fneg(z_m), rinv))
    u2 = F.fto_raw_canonical(F.fmul(s_m, rinv))
    Q = SM.lincomb_auto([(P.generator(curve, bshape, dev), u1),
                         (P.from_affine(curve, x, y), u2)])
    qx, qy, inf = P.to_affine(Q)
    return torch.cat([F.fe_to_words(qx), F.fe_to_words(qy),
                      (is_sq & ~inf).to(F.LIMB)[None]], 0)


def recover_batch(curve: CurveSpec, z_ints, sigs, chunk=None, device=None) -> list:
    """Batched public-key recovery. sigs: [(r, s, recid)]. Returns affine
    (x, y) or None per lane (k256's RecoveryId: bit 0 the parity of y(R),
    bit 1 that x(R) overflowed n). Runs on the card unless `device` names
    another; r, s outside (0, n) and x(R) >= p are rejected on the host."""
    dev = resolve_device(device)
    n, p = curve.n, curve.p
    f, s = curve.field, curve.scalar
    pre_ok = []

    def prep(sl_):
        xs, zs, rl, sl, odd = [], [], [], [], []
        for (r, sg, recid), z in zip(sigs[sl_], z_ints[sl_]):
            x = r + (n if recid & 2 else 0)
            ok = 0 < r < n and 0 < sg < n and x < p
            pre_ok.append(ok)
            xs.append(x if ok else curve.gx)
            rl.append(r if ok else 1)
            sl.append(sg if ok else 1)
            zs.append(z % n)
            odd.append(recid & 1)
        return np.concatenate([
            F.words_from_ints(xs, f.bits),
            F.words_from_ints(zs, s.bits),
            F.words_from_ints(rl, s.bits),
            F.words_from_ints(sl, s.bits),
            np.array(odd, np.uint32)[None],
        ], axis=0)

    pad = np.concatenate([
        F.words_from_ints([curve.gx], f.bits),
        F.words_from_ints([0], s.bits),
        F.words_from_ints([1], s.bits),
        F.words_from_ints([1], s.bits),
        np.zeros((1, 1), np.uint32),
    ], axis=0)
    packed = run_pipelined(lambda buf: _recover_core(curve, buf), prep, len(sigs),
                           chunk, pad, dev)
    nwf, _ = _word_rows(curve)
    qxs = F.ints_from_words(packed[:nwf])
    qys = F.ints_from_words(packed[nwf:2 * nwf])
    return [(qx, qy) if (pok and bool(o)) else None
            for qx, qy, pok, o in zip(qxs, qys, pre_ok, packed[2 * nwf])]


def recover_public_key(curve: CurveSpec, z: int, r: int, s: int, recid: int,
                       device=None):
    """One signature's public-key recovery (a batch of one)."""
    return recover_batch(curve, [z], [(r, s, recid)], device=device)[0]


# ---------------------------------------------------------------------------
# host key API (the reference's SigningKey and VerifyingKey)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SigningKey:
    curve: CurveSpec
    d: int

    @classmethod
    def random(cls, curve_name: str, rng) -> "SigningKey":
        c = get_curve(curve_name)
        return cls(c, rng.randrange(1, c.n))

    @classmethod
    def from_bytes(cls, curve_name: str, data: bytes) -> "SigningKey":
        c = get_curve(curve_name)
        d = be_bytes_to_int(data)
        if not 0 < d < c.n:
            raise ValueError("invalid secret scalar")
        return cls(c, d)

    def to_bytes(self) -> bytes:
        return int(self.d).to_bytes((self.curve.scalar.bits + 7) // 8, "big")

    def verifying_key(self, device=None) -> "VerifyingKey":
        # the constant-time device comb, never the host ladder, on the
        # secret d (k256/src/arithmetic/mul.rs:424-439)
        return VerifyingKey(self.curve, SM.derive_public(self.curve, self.d, device))

    def sign_prehash(self, digest: bytes, device=None):
        z = digest_to_z(self.curve, digest)
        (r, s, recid), = sign_batch(self.curve, [self.d], [z], device=device)
        return r, s, recid

    def sign(self, msg: bytes, hashname=None, device=None) -> bytes:
        r, s, _ = self.sign_prehash(hash_msg(self.curve, msg, hashname), device)
        return der.sig_to_der(r, s)

    def sign_recoverable(self, msg: bytes, hashname=None, device=None):
        return self.sign_prehash(hash_msg(self.curve, msg, hashname), device)


@dataclasses.dataclass
class VerifyingKey:
    curve: CurveSpec
    point: tuple  # affine (x, y)

    @classmethod
    def from_sec1_bytes(cls, curve_name: str, data: bytes) -> "VerifyingKey":
        c = get_curve(curve_name)
        pt = sec1.decode_point(c, data)
        if pt is None:
            raise ValueError("identity is not a valid public key")
        return cls(c, pt)

    def to_sec1_bytes(self, compress: bool = True) -> bytes:
        return sec1.encode_point(self.curve, self.point, compress)

    def verify_prehash(self, digest: bytes, r: int, s: int, device=None) -> bool:
        z = digest_to_z(self.curve, digest)
        return verify_batch(self.curve, [self.point], [z], [(r, s)],
                            device=device)[0]

    def verify(self, msg: bytes, sig_der: bytes, hashname=None,
               device=None) -> bool:
        try:
            r, s = der.der_to_sig(sig_der)
        except der.DerError:
            return False
        digest = hash_msg(self.curve, msg, hashname)
        return self.verify_prehash(digest, r, s, device=device)
