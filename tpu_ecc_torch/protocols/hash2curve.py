"""hash-to-curve (RFC 9380): expand_message_xmd + SSWU map (+ k256 3-isogeny).

The torch port of tpu_ecc/protocols/hash2curve.py, which mirrors the
reference's hash2curve stack: the elliptic-curve crate's
ExpandMsgXmd/hash_to_field framework plus each crate's OsswuMap/Isogeny
impls (k256/src/arithmetic/hash2curve.rs:15-205, p256:42-72, p384, p521).

Host: XMD expansion and wide reduction. Device, in one map call: the
batched SSWU map, the isogeny on secp256k1, and the final point addition
(the plain RCB add) and affine form. All supported curves have p = 3 mod 4,
so the map uses the C1 = (p-3)/4 square-root trick exactly like the
reference's osswu(); that power and every inversion run on the `pow`
kernel (7 launches a call on secp256k1, 5 on the other suites). The
statement order is the reference's, so the limbs are its limbs.
"""

from __future__ import annotations

import functools
import hashlib

from .. import resolve_device
from ..curves.specs import CurveSpec
from ..ops import fe as F
from ..ops import points as P
from ..utils import ec_host

# RFC 9380 suite params: (hash, L bytes per element, Z)
SUITES = {
    "secp256k1": ("sha256", 48, -11),
    "p256": ("sha256", 48, -10),
    "p384": ("sha384", 72, -12),
    "p521": ("sha512", 98, -4),
}

# secp256k1 maps through the 3-isogenous curve E': y^2 = x^3 + A'x + B'
# (RFC 9380 §8.7 / k256 hash2curve.rs:51-80)
K256_A = 0x3F8731ABDD661ADCA08A5558F0F5D272E953D363CB6F0E5D405447C01A444533
K256_B = 1771

# 3-isogeny coefficients (RFC 9380 E.1 / k256 hash2curve.rs Isogeny impl)
K256_ISO = {
    "xnum": [
        0x8E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38DAAAAA8C7,
        0x07D3D4C80BC321D5B9F315CEA7FD44C5D595D2FC0BF63B92DFFF1044F17C6581,
        0x534C328D23F234E6E2A413DECA25CAECE4506144037C40314ECBD0B53D9DD262,
        0x8E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38DAAAAA88C,
    ],
    "xden": [
        0xD35771193D94918A9CA34CCBB7B640DD86CD409542F8487D9FE6B745781EB49B,
        0xEDADC6F64383DC1DF7C4B2D51B54225406D36B641F5E41BBC52A56612A8C6D14,
        1,
    ],
    "ynum": [
        0x4BDA12F684BDA12F684BDA12F684BDA12F684BDA12F684BDA12F684B8E38E23C,
        0xC75E0C32D5CB7C0FA9D0A54B12A0A6D5647AB046D686DA6FDFFC90FC201D71A3,
        0x29A6194691F91A73715209EF6512E576722830A201BE2018A765E85A9ECEE931,
        0x2F684BDA12F684BDA12F684BDA12F684BDA12F684BDA12F684BDA12F38E38D84,
    ],
    "yden": [
        0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFF93B,
        0x7A06534BB8BDB49FD5E9E6632722C2989467C1BFC8E8D978DFB425D2685C2573,
        0x6484AA716545CA2CF3A70C3FA8FE337E0A3D21162F0D6299A7BF8192BFD2A76F,
        1,
    ],
}


def expand_message_xmd(msg: bytes, dst: bytes, length: int, hashname: str) -> bytes:
    """RFC 9380 §5.3.1 expand_message_xmd."""
    h = lambda d: hashlib.new(hashname, d).digest()  # noqa: E731
    b_in_bytes = hashlib.new(hashname).digest_size
    r_in_bytes = hashlib.new(hashname).block_size
    ell = -(-length // b_in_bytes)
    if ell > 255 or length > 65535 or len(dst) > 255:
        raise ValueError("expand_message_xmd bounds")
    dst_prime = dst + bytes([len(dst)])
    z_pad = b"\x00" * r_in_bytes
    l_i_b = length.to_bytes(2, "big")
    b0 = h(z_pad + msg + l_i_b + b"\x00" + dst_prime)
    b1 = h(b0 + b"\x01" + dst_prime)
    bs = [b1]
    for i in range(2, ell + 1):
        prev = bs[-1]
        bs.append(h(bytes(x ^ y for x, y in zip(b0, prev)) + bytes([i]) + dst_prime))
    return b"".join(bs)[:length]


def hash_to_field(curve: CurveSpec, msg: bytes, dst: bytes, count: int,
                  modulus: int | None = None) -> list[int]:
    """hash_to_field over F_p (or F_n when modulus=n) — host-side reduction."""
    hashname, L, _ = SUITES[curve.name]
    m = modulus if modulus is not None else curve.p
    okm = expand_message_xmd(msg, dst, count * L, hashname)
    return [int.from_bytes(okm[i * L:(i + 1) * L], "big") % m for i in range(count)]


@functools.lru_cache(maxsize=None)
def _sswu_consts(curve: CurveSpec):
    _, _, Z = SUITES[curve.name]
    p = curve.p
    if curve.name == "secp256k1":
        A, B = K256_A, K256_B
    else:
        A, B = curve.a, curve.b
    c1 = (p - 3) // 4
    c2 = ec_host._mod_sqrt((-pow(Z, 3, p)) % p, p)
    assert c2 is not None
    return A, B, Z % p, c1, c2



def _map_core(curve: CurveSpec, u0: F.FE, u1: F.FE):
    """map_to_curve of two u-values per lane, then their point add and its
    affine form -> (x, y, is_identity), on u0's device."""
    f = curve.field
    A_i, B_i, Z_i, c1, c2_i = _sswu_consts(curve)
    dev = u0.device

    def sswu(u: F.FE):
        bsh = u.batch_shape
        A = F.fe_from_int(f, A_i, bsh, dev)
        B = F.fe_from_int(f, B_i, bsh, dev)
        Z = F.fe_from_int(f, Z_i, bsh, dev)
        c2 = F.fe_from_int(f, c2_i, bsh, dev)
        tv1 = F.fsquare(u)
        tv3 = F.fmul(Z, tv1)
        tv2 = F.fsquare(tv3)
        xd = tv2 + tv3
        x1n = F.fmul(B, xd + F.fone(f, bsh, dev))
        xd = F.fmul(F.fneg(A), xd)
        xd = F.fselect(F.fis_zero(xd), F.fmul(Z, A), xd)
        tv2 = F.fsquare(xd)
        gxd = F.fmul(tv2, xd)                      # xd^3
        tv2 = F.fmul(A, tv2)
        gx1 = F.fmul(x1n, tv2 + F.fsquare(x1n))
        gx1 = gx1 + F.fmul(B, gxd)                 # x1n^3 + A x1n xd^2 + B xd^3
        tv4 = F.fsquare(gxd)
        tv2 = F.fmul(gx1, gxd)
        tv4 = F.fmul(tv4, tv2)                     # gx1 * gxd^3
        y1 = F.fmul(F.fpow_const(tv4, c1), tv2)    # candidate sqrt
        x2n = F.fmul(tv3, x1n)
        y2 = F.fmul(F.fmul(F.fmul(y1, c2), tv1), u)
        e2 = F.feq(F.fmul(F.fsquare(y1), gxd), gx1)
        xn = F.fselect(e2, x1n, x2n)
        y = F.fselect(e2, y1, y2)
        # sgn0 matching: sgn0(u) == sgn0(y)
        u_odd = F.fto_raw_canonical(u)[0] & 1
        y_odd = F.fto_raw_canonical(y)[0] & 1
        y = F.fselect(u_odd == y_odd, y, F.fneg(y))
        x = F.fmul(xn, F.finv(xd))
        return x, y

    def isogeny(x: F.FE, y: F.FE):
        bsh = x.batch_shape

        def poly(coeffs):
            acc = F.fe_from_int(f, coeffs[-1], bsh, dev)
            for c_ in reversed(coeffs[:-1]):
                acc = F.fmul(acc, x) + F.fe_from_int(f, c_, bsh, dev)
            return acc

        xn = poly(K256_ISO["xnum"])
        xd = poly(K256_ISO["xden"])
        yn = poly(K256_ISO["ynum"])
        yd = poly(K256_ISO["yden"])
        inv = F.finv(F.fmul(xd, yd))
        qx = F.fmul(F.fmul(xn, yd), inv)
        qy = F.fmul(y, F.fmul(F.fmul(yn, xd), inv))
        return qx, qy

    pts = []
    for u in (u0, u1):
        x, y = sswu(u)
        if curve.name == "secp256k1":
            x, y = isogeny(x, y)
        pts.append(P.from_affine(curve, x, y))
    R = P.padd(pts[0], pts[1])
    return P.to_affine(R)


def hash_to_curve(curve: CurveSpec, msgs, dst: bytes, device=None):
    """Batched hash_to_curve (RO). Returns list of affine (x, y). The map
    runs on the card unless `device` names another."""
    dev = resolve_device(device)
    us = [hash_to_field(curve, m, dst, 2) for m in msgs]
    u0 = F.fe_from_ints(curve.field, [u[0] for u in us], dev)
    u1 = F.fe_from_ints(curve.field, [u[1] for u in us], dev)
    x, y, inf = _map_core(curve, u0, u1)
    if bool(inf.any()):
        raise ValueError("hash_to_curve: the map gave the identity")
    xs, ys = F.fe_to_ints(x), F.fe_to_ints(y)
    return list(zip(xs, ys))


def hash_to_scalar(curve: CurveSpec, msgs, dst: bytes) -> list[int]:
    """GroupDigest::hash_to_scalar equivalent."""
    return [hash_to_field(curve, m, dst, 1, modulus=curve.n)[0] for m in msgs]
