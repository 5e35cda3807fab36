"""SM2 digital signatures (GB/T 32918): the batched device cores and the
host key API.

The torch port of tpu_ecc/protocols/sm2.py, with the reference's `sm2`
crate semantics:

- Z_A, the hash of the distinguishing identifier, the curve and the key
  (sm2/src/distid.rs:22-44);
- sign: e = SM3(Z_A || M), k by RFC 6979 with HMAC-SM3, (x1, y1) = k G,
  r = (e + x1) mod n, s = (1 + d)^-1 (k - r d) mod n
  (sm2/src/dsa/signing.rs:185-220);
- verify: t = (r + s) mod n, (x1, y1) = s G + t P, accept iff
  (e + x1) mod n == r (sm2/src/dsa/verifying.rs:131-165).

The host hashes (SM3 on the native batch), draws the nonces and packs
32-bit words; the device runs k G on the fixed-base comb (the `genmul`
kernel), its affine x and (1 + d)^-1 on the `pow` kernel, and the verify's
s G + t P on the two-term ladder (the `ladder` kernel), behind the chunked
pipeline (protocols/pipeline.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import native, resolve_device
from ..curves.specs import CurveSpec, get_curve
from ..ops import fe as F
from ..ops import points as P
from ..ops import scalarmul as SM
from ..utils.bigint import be_bytes_to_int, int_to_be_bytes
from . import rfc6979
from .pipeline import run_pipelined

DEFAULT_ID = b"1234567812345678"


def sm3(data: bytes) -> bytes:
    """SM3 of one message, on the native library."""
    return native.sm3_batch([data])[0]


def _za_prefix(curve: CurveSpec, ident: bytes) -> bytes:
    """ENTL || id || a || b || Gx || Gy: Z_A's input before the key."""
    fb = curve.field_bytes
    return ((len(ident) * 8).to_bytes(2, "big") + ident
            + b"".join(int_to_be_bytes(v % curve.p, fb)
                       for v in (curve.a, curve.b, curve.gx, curve.gy)))


def z_a(curve: CurveSpec, pub_pt, ident: bytes = DEFAULT_ID) -> bytes:
    """Z_A = SM3(ENTL || id || a || b || Gx || Gy || Px || Py)."""
    fb = curve.field_bytes
    return sm3(_za_prefix(curve, ident) + int_to_be_bytes(pub_pt[0], fb)
               + int_to_be_bytes(pub_pt[1], fb))


def hash_msg(curve: CurveSpec, pub_pt, msg: bytes, ident: bytes = DEFAULT_ID) -> bytes:
    """e = SM3(Z_A || M)."""
    return sm3(z_a(curve, pub_pt, ident) + msg)


def hash_msg_batch(curve: CurveSpec, pub_pts, msgs, ident: bytes = DEFAULT_ID) -> list:
    """e = SM3(Z_A || M) for each (key, message): both SM3 passes on the
    native batch, the second in one batch per message length."""
    fb = curve.field_bytes
    prefix = _za_prefix(curve, ident)
    zs = native.sm3_batch([prefix + int_to_be_bytes(q[0], fb) + int_to_be_bytes(q[1], fb)
                           for q in pub_pts])
    ein = [z + m for z, m in zip(zs, msgs)]
    out = [b""] * len(ein)
    for n in sorted({len(x) for x in ein}):
        idx = [i for i, x in enumerate(ein) if len(x) == n]
        for i, h in zip(idx, native.sm3_batch([ein[i] for i in idx])):
            out[i] = h
    return out


# ---------------------------------------------------------------------------
# the device cores
# ---------------------------------------------------------------------------

def _to_mont_scalar(curve: CurveSpec, x: F.FE) -> F.FE:
    """A base-field element's integer mod n, in the scalar field's domain."""
    s = curve.scalar
    x_raw, _ = F.field_to_scalar_raw(curve.field, s, x)
    bshape = tuple(x_raw.shape[1:])
    return F.fmul(F.FE(x_raw, s, s.mask, s.p - 1), F.fe_from_int(s, s.r, bshape, x_raw.device))


def _sign_core(curve: CurveSpec, buf: torch.Tensor) -> torch.Tensor:
    """buf: int64 words [3*nws, B] on the device = k | e | d. Returns the
    words [2*nws + 1, B] = r | s | bad (r == 0, s == 0 or r + k == n: GB/T
    32918 steps A5 and A6)."""
    s = curve.scalar
    nws = (s.bits + 31) // 32
    bshape = tuple(buf.shape[1:])
    k_w, e_w, d_w = buf[:nws], buf[nws:2 * nws], buf[2 * nws:3 * nws]
    k_raw = F.relimb(k_w, 32, s.limb_bits, s.n_limbs)
    k_m = F.fe_from_words(s, k_w, s.bits)
    e_m = F.fe_from_words(s, e_w, s.bits)
    d_m = F.fe_from_words(s, d_w, s.bits)
    x1, _, _ = P.to_affine(SM.mul_by_generator(curve, k_raw))
    r = e_m + _to_mont_scalar(curve, x1)
    dp1_inv = F.finv(d_m + F.fone(s, bshape, buf.device))
    sig = F.fmul(dp1_inv, F.fsub(k_m, F.fmul(r, d_m)))
    r_raw, s_raw = F.fto_raw_canonical(r), F.fto_raw_canonical(sig)
    bad = ((r_raw == 0).all(0) | (s_raw == 0).all(0)
           | (F.fto_raw_canonical(r + k_m) == 0).all(0))
    return torch.cat([F.relimb(r_raw, s.limb_bits, 32, nws), F.relimb(s_raw, s.limb_bits, 32, nws),
                      bad.to(F.LIMB)[None]], 0)


def _verify_core(curve: CurveSpec, buf: torch.Tensor) -> torch.Tensor:
    """buf: int64 words [2*nwf + 3*nws, B] on the device = qx | qy | s | t |
    re (re = r - e mod n). Accept iff Q is on the curve, R = s G + t Q is
    not O and x(R) == re mod n. Returns bool [B]."""
    f, s = curve.field, curve.scalar
    nwf, nws = (f.bits + 31) // 32, (s.bits + 31) // 32
    bshape = tuple(buf.shape[1:])
    dev = buf.device
    o = 0
    qx_w = buf[o:o + nwf]; o += nwf                              # noqa: E702
    qy_w = buf[o:o + nwf]; o += nwf                              # noqa: E702
    s_w = buf[o:o + nws]; o += nws                               # noqa: E702
    t_w = buf[o:o + nws]; o += nws                               # noqa: E702
    re_w = buf[o:o + nws]
    Q = P.from_affine(curve, F.fe_from_words(f, qx_w, f.bits), F.fe_from_words(f, qy_w, f.bits))
    s_raw = F.relimb(s_w, 32, s.limb_bits, s.n_limbs)
    t_raw = F.relimb(t_w, 32, s.limb_bits, s.n_limbs)
    re_m = F.fe_from_words(s, re_w, s.bits)
    R = SM.lincomb_auto([(P.generator(curve, bshape, dev), s_raw), (Q, t_raw)])
    x1, _, inf = P.to_affine(R)
    return P.on_curve(Q) & ~inf & F.feq(re_m, _to_mont_scalar(curve, x1))


def sign_batch(curve: CurveSpec, d_ints, e_ints, k_ints=None, chunk=None,
               _raw_flags=False, device=None) -> list:
    """Batched SM2 sign over e = SM3(Z_A || M). Returns [(r, s)].

    Nonces come from RFC 6979 with HMAC-SM3 on the host (the native batch)
    unless the caller gives k_ints; runs on the card unless `device` names
    another. A lane that hits r = 0, s = 0 or r + k = n (GB/T 32918 steps
    A5 and A6) is signed again with a fresh RFC 6979 nonce (additional
    data 1, 2, ...), lane by lane; with a caller's k it raises ValueError."""
    dev = resolve_device(device)
    n, s = curve.n, curve.scalar
    nb = (n.bit_length() + 7) // 8
    caller_k = k_ints is not None

    def prep(sl):
        e_c = [e % n for e in e_ints[sl]]
        d_c = list(d_ints[sl])
        if caller_k:
            k_c = list(k_ints[sl])
        else:
            k_c = rfc6979.generate_k_batch(n, d_c, [int(e).to_bytes(nb, "big") for e in e_c],
                                           "sm3")
        return np.concatenate([F.words_from_ints(v, s.bits) for v in (k_c, e_c, d_c)], 0)

    pad = np.concatenate([F.words_from_ints([v], s.bits) for v in (1, 0, 1)], 0)
    packed = run_pipelined(lambda buf: _sign_core(curve, buf), prep, len(d_ints), chunk,
                           pad, dev)
    nws = (s.bits + 31) // 32
    out = list(zip(F.ints_from_words(packed[:nws]), F.ints_from_words(packed[nws:2 * nws])))
    if _raw_flags:
        return [sig + (bool(b),) for sig, b in zip(out, packed[2 * nws])]
    bad = np.flatnonzero(packed[2 * nws])
    if bad.size:
        if caller_k:
            raise ValueError(f"degenerate SM2 signature for caller-supplied k at lanes "
                             f"{bad.tolist()[:8]}")
        for i in map(int, bad):
            retry, sig_i = 1, None
            while sig_i is None or sig_i[2]:
                k_i = rfc6979.generate_k(n, d_ints[i], int(e_ints[i] % n).to_bytes(nb, "big"),
                                         "sm3", extra=retry.to_bytes(4, "big"))
                sig_i = sign_batch(curve, [d_ints[i]], [e_ints[i]], k_ints=[k_i],
                                   _raw_flags=True, device=dev)[0]
                retry += 1
            out[i] = sig_i[:2]
    return out


def verify_batch(curve: CurveSpec, pub_pts, e_ints, sigs, chunk=None, device=None) -> list:
    """Batched SM2 verify. pub_pts: affine (x, y); e_ints: SM3(Z_A || M) as
    ints; sigs: (r, s). Returns list[bool]. Runs on the card unless
    `device` names another. r, s outside (0, n), t = 0 and coordinates
    outside [0, p) are rejected on the host; curve membership on the
    device."""
    dev = resolve_device(device)
    n, p = curve.n, curve.p
    f, s = curve.field, curve.scalar
    pre_ok = []

    def prep(sl):
        s_l, t_l, re_l, qx_l, qy_l = [], [], [], [], []
        for (r, sg), e, (qx, qy) in zip(sigs[sl], e_ints[sl], pub_pts[sl]):
            t = (r + sg) % n
            ok = 0 < r < n and 0 < sg < n and t != 0 and 0 <= qx < p and 0 <= qy < p
            pre_ok.append(ok)
            s_l.append(sg if ok else 1)
            t_l.append(t if ok else 1)
            re_l.append((r - e) % n)
            qx_l.append(qx if ok else curve.gx)
            qy_l.append(qy if ok else curve.gy)
        return np.concatenate([F.words_from_ints(qx_l, f.bits), F.words_from_ints(qy_l, f.bits),
                               F.words_from_ints(s_l, s.bits), F.words_from_ints(t_l, s.bits),
                               F.words_from_ints(re_l, s.bits)], 0)

    pad = np.concatenate([F.words_from_ints([curve.gx], f.bits),
                          F.words_from_ints([curve.gy], f.bits),
                          F.words_from_ints([1], s.bits), F.words_from_ints([1], s.bits),
                          F.words_from_ints([0], s.bits)], 0)
    raw = run_pipelined(lambda buf: _verify_core(curve, buf), prep, len(sigs), chunk, pad, dev)
    return [bool(a and b) for a, b in zip(pre_ok, raw[0])]


# ---------------------------------------------------------------------------
# host key API (the reference's sm2::dsa SigningKey and VerifyingKey)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SigningKey:
    curve: CurveSpec
    d: int
    ident: bytes = DEFAULT_ID
    _pub: tuple | None = dataclasses.field(default=None, repr=False, compare=False)

    @classmethod
    def from_bytes(cls, data: bytes, ident: bytes = DEFAULT_ID) -> "SigningKey":
        c = get_curve("sm2")
        d = be_bytes_to_int(data)
        if not 0 < d < c.n:
            raise ValueError("invalid secret")
        return cls(c, d, ident)

    def public_point(self, device=None):
        # the constant-time device comb on the secret d, kept: every sign
        # needs it for Z_A
        if self._pub is None:
            self._pub = SM.derive_public(self.curve, self.d, device)
        return self._pub

    def verifying_key(self, device=None) -> "VerifyingKey":
        return VerifyingKey(self.curve, self.public_point(device), self.ident)

    def sign(self, msg: bytes, device=None):
        e = be_bytes_to_int(hash_msg(self.curve, self.public_point(device), msg, self.ident))
        ((r, s),) = sign_batch(self.curve, [self.d], [e], device=device)
        return r, s


@dataclasses.dataclass
class VerifyingKey:
    curve: CurveSpec
    point: tuple
    ident: bytes = DEFAULT_ID

    def verify(self, msg: bytes, r: int, s: int, device=None) -> bool:
        e = be_bytes_to_int(hash_msg(self.curve, self.point, msg, self.ident))
        return verify_batch(self.curve, [self.point], [e], [(r, s)], device=device)[0]
