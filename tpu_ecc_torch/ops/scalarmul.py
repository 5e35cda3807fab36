"""Batched scalar multiplication: signed 4-bit windows on the `ladder` kernel.

The torch port of tpu_ecc/ops/scalarmul.py's variable-base side:

- `signed_digits`: 4-bit windows recoded to signed digits in [-8, 8], so a
  base needs only the 9-entry table [O, Q, .., 8Q] (the reference's
  Radix16Decomposition, k256/src/arithmetic/mul.rs:274-305);
- `scalar_mul` and `lincomb` (shared-doubling Straus, the ECDSA-verify hot
  path, k256/src/arithmetic/mul.rs:342-393);
- the GLV split for secp256k1 (`glv_decompose_device`, `lincomb_glv`,
  `scalar_mul_glv`), which halves the window count, and the host split of a
  public scalar (`glv_decompose`);
- the fixed-base comb k*G (`mul_by_generator`, the sign hot loop) over
  precomputed affine tables d * 16^j * G, and constant-time public-key
  derivation on it (`derive_public_batch`).

Every ladder runs on ops/kernels.py's `ladder` and every comb on its
`genmul`: the CUDA kernel for a CUDA tensor, its plain twin for a CPU
tensor. The select of a table entry is a masked select over all 9 entries,
never an index by digit, so secret scalars are safe. Scalars enter as
canonical little-endian limb tensors in the scalar field's limb layout
(never Montgomery-domain), packed by `pack_scalars`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import resolve_device
from ..curves.specs import CurveSpec
from ..utils import ec_host
from ..utils.bigint import int_to_limbs, ints_to_limbs_np
from . import fe as F
from . import kernels
from . import points as P
from .points import Point


def pack_scalars(curve: CurveSpec, ints, device=None) -> torch.Tensor:
    """Host ints -> canonical scalar limbs int64[n_limbs, B] on `device`
    (the card unless another is named)."""
    s = curve.scalar
    arr = ints_to_limbs_np([v % s.p for v in ints], s.n_limbs, s.limb_bits)
    return torch.from_numpy(arr.astype("int64")).to(resolve_device(device))


def num_windows(curve: CurveSpec, scalar_bits=None) -> int:
    return -(-(scalar_bits or curve.scalar.bits) // 4)


def window_digits(curve: CurveSpec, k_limbs: torch.Tensor, scalar_bits=None) -> torch.Tensor:
    """4-bit windows, MSB first -> [nw, *batch]. Window j covers scalar bits
    [4j, 4j+4) and may straddle two limbs."""
    s = curve.scalar
    b = s.limb_bits
    digs = []
    for j in range(num_windows(curve, scalar_bits)):
        li, off = divmod(4 * j, b)
        d = k_limbs[li] >> off
        if off > b - 4 and li + 1 < s.n_limbs:
            d = d | (k_limbs[li + 1] << (b - off))
        digs.append(d & 15)
    return torch.stack(digs[::-1], 0)


def signed_digits(curve: CurveSpec, k_limbs: torch.Tensor, scalar_bits=None):
    """Signed windows in [-8, 8]: (mag [nw+1, *batch] in [0, 8], neg bool
    [nw+1, *batch]), MSB window first; the extra top window takes the final
    carry."""
    digs = window_digits(curve, k_limbs, scalar_bits).flip(0)   # LSB first
    carry = torch.zeros_like(digs[0])
    mags, negs = [], []
    for j in range(digs.shape[0]):
        e = digs[j] + carry
        hi = e > 8
        mags.append(torch.where(hi, 16 - e, e))
        negs.append(hi)
        carry = hi.to(e.dtype)
    mag = torch.stack(mags + [carry], 0)
    neg = torch.stack(negs + [torch.zeros_like(negs[0])], 0)
    return mag.flip(0), neg.flip(0)


def _ct_lookup(tbl: torch.Tensor, digit: torch.Tensor) -> torch.Tensor:
    """tbl[k, ...] selected by digit[*batch] -> [...], as a masked select
    over every entry (constant-time)."""
    out = torch.zeros_like(tbl[0])
    for k in range(tbl.shape[0]):
        out = torch.where(digit == k, tbl[k], out)
    return out


def _signed_term(curve: CurveSpec, tbl9: torch.Tensor, mag, neg) -> torch.Tensor:
    """Select |d| from the 9-entry table [9, 3, n, *b] and negate y where
    the digit is negative -> limbs [3, n, *b]."""
    f = curve.field
    t = _ct_lookup(tbl9, mag)
    y = F.fe_steady(f, t[1])
    yn = F.fsteady(F.fneg(y))
    return torch.stack([t[0], torch.where(neg, yn.limbs, t[1]), t[2]], 0)


def _point_table(Q: Point, size: int = 9) -> torch.Tensor:
    """[O, Q, 2Q, .., (size-1)Q] as [size, 3, n, *batch] steady limbs."""
    c = Q.curve
    Q = P.steady(Q)
    rows = [P.point_limbs(P.identity(c, Q.batch_shape, Q.device)), P.point_limbs(Q)]
    cur = Q
    for _ in range(size - 2):
        cur = P.steady(P.padd(cur, Q))
        rows.append(P.point_limbs(cur))
    return torch.stack(rows, 0)


def ladder_inputs(terms, glv: bool = False, scalar_bits=None) -> tuple:
    """The `ladder` kernel's arguments for terms = [(Point, k_limbs), ...]:
    (bases [T, 3, n, B] steady limbs, mag [nw, H, B], neg [nw, H, B]).
    With `glv` each scalar splits into two signed halves (H = 2T), each
    half's sign folded into its windows' sign masks (negating a scalar
    negates every signed digit)."""
    c = terms[0][0].curve
    digits = []
    for _, k in terms:
        if glv:
            d1, n1, d2, n2 = glv_decompose_device(c, k)
            for d, hneg in ((d1, n1), (d2, n2)):
                mag, neg = signed_digits(c, d, GLV_BITS)
                digits.append((mag, neg != hneg))
        else:
            digits.append(signed_digits(c, k, scalar_bits))
    bases = torch.stack([P.point_limbs(P.steady(Q)) for Q, _ in terms], 0)
    return (bases, torch.stack([m for m, _ in digits], 1),
            torch.stack([g for _, g in digits], 1))


def _ladder(terms, glv: bool = False, scalar_bits=None) -> Point:
    c = terms[0][0].curve
    out = kernels.ladder(c, *ladder_inputs(terms, glv, scalar_bits), glv=glv)
    return P.point_from_limbs(c, out)


def scalar_mul(Q: Point, k_limbs: torch.Tensor, scalar_bits=None) -> Point:
    """Constant-time k*Q over the batch. Full-width scalars on a curve with
    an endomorphism take the GLV split (34 windows instead of 65); otherwise
    the single-term ladder, whose first window seeds the accumulator."""
    c = Q.curve
    if c.glv and scalar_bits is None:
        return lincomb_glv([(Q, k_limbs)])
    return _ladder([(Q, k_limbs)], scalar_bits=scalar_bits)


def lincomb(terms, scalar_bits=None) -> Point:
    """sum(k_i * P_i) with shared doublings and signed windows; terms =
    [(Point, k_limbs), ...]. scalar_bits bounds the window count."""
    return _ladder(terms, scalar_bits=scalar_bits)


# ---------------------------------------------------------------------------
# fixed-base: precomputed comb tables for the generator
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _gen_tables_np(curve: CurveSpec):
    """T[j][d] = affine(d * 16^j * G) for nw+1 signed windows, d in 0..8
    (host precompute; entry 0 is a dummy (gx, gy) masked out at lookup
    time; the extra window absorbs the signed-recode carry). Returns
    (x_tbl, y_tbl) as uint32[nw+1, 9, n_limbs]."""
    f = curve.field
    nw = num_windows(curve) + 1
    G = ec_host.aff_generator(curve)
    xs = np.zeros((nw, 9, f.n_limbs), np.uint32)
    ys = np.zeros((nw, 9, f.n_limbs), np.uint32)
    base = G
    for j in range(nw):
        acc = None
        for d in range(9):
            pt = acc if acc is not None else base  # d=0 dummy: use base point
            xs[j, d] = int_to_limbs(f.encode_int(pt[0]), f.n_limbs, f.limb_bits)
            ys[j, d] = int_to_limbs(f.encode_int(pt[1]), f.n_limbs, f.limb_bits)
            acc = ec_host.aff_add(curve, acc, base)
        base = ec_host.aff_mul(curve, 16, base)
    return xs, ys


@functools.lru_cache(maxsize=None)
def _gen_table(curve: CurveSpec, device: torch.device) -> torch.Tensor:
    """The comb table as the `genmul` kernel takes it: [nw+1, 9, 2, n]
    limbs on `device`."""
    xs, ys = _gen_tables_np(curve)
    return torch.from_numpy(np.stack([xs, ys], axis=2).astype(np.int64)).to(device)


def mul_by_generator(curve: CurveSpec, k_limbs: torch.Tensor) -> Point:
    """Constant-time k*G via signed comb tables (9 entries per window):
    nw+1 mixed adds, no doublings, with a conditional y negation per window
    (Radix16 signed digits, cf. k256/src/arithmetic/mul.rs:395-439), on the
    `genmul` kernel (its plain twin for a CPU tensor)."""
    mag, neg = signed_digits(curve, k_limbs)    # [nw+1 (msb first), *b]
    out = kernels.genmul(curve, _gen_table(curve, k_limbs.device),
                         mag.flip(0), neg.flip(0))   # windows j = 0..nw
    return P.point_from_limbs(curve, out)


# ---------------------------------------------------------------------------
# constant-time public-key derivation (SecretKey::public_key analogue)
# ---------------------------------------------------------------------------

def _derive_public_core(curve: CurveSpec, buf: torch.Tensor) -> torch.Tensor:
    """buf: secret scalars as 32-bit words [nws, B] on the device -> x | y
    words [2 * nwf, B]."""
    s = curve.scalar
    d_raw = F.relimb(buf, 32, s.limb_bits, s.n_limbs)
    x, y, _ = P.to_affine(mul_by_generator(curve, d_raw))
    return torch.cat([F.fe_to_words(x), F.fe_to_words(y)], 0)


def derive_public_batch(curve: CurveSpec, d_ints, device=None) -> list:
    """Constant-time public keys [(x, y)] = [d*G] for secret scalars d.

    The only path from a secret scalar to its public point: the device comb
    (`mul_by_generator`: masked selects, no secret-dependent control flow),
    as the reference's constant-time SecretKey::public_key
    (k256/src/arithmetic/mul.rs:424-439). The host double-and-add
    (`ec_host.aff_mul`) branches on every bit and never sees a secret. Runs
    on the card unless `device` names another; one packed buffer each way."""
    dev = resolve_device(device)
    words = F.words_from_ints([d % curve.n for d in d_ints], curve.scalar.bits)
    buf = torch.from_numpy(words.astype(np.int64)).to(dev)
    packed = _derive_public_core(curve, buf).cpu().numpy()
    nwf = (curve.field.bits + 31) // 32
    return list(zip(F.ints_from_words(packed[:nwf]), F.ints_from_words(packed[nwf:])))


def derive_public(curve: CurveSpec, d: int, device=None) -> tuple:
    """One key's constant-time public-key derivation (a batch of one)."""
    return derive_public_batch(curve, [d], device)[0]


# ---------------------------------------------------------------------------
# GLV endomorphism path (secp256k1) — k256/src/arithmetic/mul.rs:129-268
# ---------------------------------------------------------------------------

GLV_BITS = 132  # |k1|,|k2| < 2^130 (lattice bound + rounding slack)


@functools.lru_cache(maxsize=None)
def _glv_consts(curve: CurveSpec):
    """Rounding multipliers g_i = round(2^shift * b_i' / n); shift is a
    multiple of the limb width so the mul-shift drops whole limbs."""
    g = curve.glv
    s = curve.scalar
    n = curve.n
    shift_l = -(-(n.bit_length() + GLV_BITS + 2) // s.limb_bits)
    shift = s.limb_bits * shift_l
    g1 = ((g["b2"] << shift) + n // 2) // n
    g2 = (((-g["b1"]) << shift) + n // 2) // n
    out_l = -(-(GLV_BITS + 2) // s.limb_bits)
    return shift_l, out_l, g1, g2


def glv_decompose_device(curve: CurveSpec, u_raw: torch.Tensor):
    """Branchless split of canonical scalar limbs u [ns, *b] into signed
    halves (d1, neg1, d2, neg2): d_i canonical limbs of |k_i| < 2^GLV_BITS,
    neg_i bool masks, with u = (-1)^neg1 d1 + (-1)^neg2 d2 lambda (mod n).
    c_i = floor(u g_i / 2^shift), k2 = -(c1 b1 + c2 b2), k1 = u - k2 lambda."""
    g = curve.glv
    s = curve.scalar
    n = curve.n
    bshape = tuple(u_raw.shape[1:])
    dev = u_raw.device
    shift_l, out_l, g1, g2 = _glv_consts(curve)

    def to_mont(raw, vmax):
        return F.fmul(F.FE(raw, s, s.mask, vmax), F.fe_from_int(s, s.r, bshape, dev))

    def wide(gi):
        c = F.fmul_shift(s, u_raw, gi, shift_l, out_l)
        c = torch.cat([c, c.new_zeros((s.n_limbs - out_l, *bshape))], 0)
        return to_mont(c, (1 << (s.limb_bits * out_l)) - 1)

    c1_m, c2_m = wide(g1), wide(g2)
    mb1 = F.fe_from_int(s, (-g["b1"]) % n, bshape, dev)
    mb2 = F.fe_from_int(s, (-g["b2"]) % n, bshape, dev)
    lam = F.fe_from_int(s, g["lam"], bshape, dev)
    k2_m = F.fmul(c1_m, mb1) + F.fmul(c2_m, mb2)
    k1_m = to_mont(u_raw, n - 1) - F.fmul(k2_m, lam)
    half = int_to_limbs(n // 2 + 1, s.n_limbs, s.limb_bits)

    def sign_fold(k_m):
        raw = F.fto_raw_canonical(k_m)
        _, high = F._cond_sub(s, raw, half)          # value > n/2 => negative
        fe = F.FE(raw, s, s.mask, n - 1)
        mag = F.fselect(high, F.fcanonical(F.fneg(fe)), fe)
        return mag.limbs, high

    d1, neg1 = sign_fold(k1_m)
    d2, neg2 = sign_fold(k2_m)
    return d1, neg1, d2, neg2


def endo(Q: Point) -> Point:
    """The secp256k1 endomorphism psi(x, y) = (beta*x, y) = lambda*(x, y)."""
    c = Q.curve
    beta = F.fe_from_int(c.field, c.glv["beta"], Q.batch_shape, Q.device)
    return Point(F.fmul(beta, Q.x), Q.y, Q.z, c)


def lincomb_glv(terms) -> Point:
    """sum(k_i * P_i) through the endomorphism: each full-width scalar splits
    into two signed 132-bit halves that share their base's table, term 2t+1
    taking psi after the select."""
    c = terms[0][0].curve
    if not c.glv:
        raise ValueError(f"{c.name} has no endomorphism")
    return _ladder(terms, glv=True)


def lincomb_auto(terms, scalar_bits=None) -> Point:
    """lincomb, through the GLV split when the curve has an endomorphism and
    the scalars are full-width (the protocol hot paths)."""
    c = terms[0][0].curve
    if c.glv and scalar_bits is None:
        return lincomb_glv(terms)
    return lincomb(terms, scalar_bits)


def glv_decompose(curve: CurveSpec, k: int):
    """Balanced host decomposition k = k1 + k2*lambda (mod n) with |k_i| ~
    sqrt(n), by exact rounding over the lattice basis (a_i, b_i),
    a_i + b_i*lambda = 0 mod n (mul.rs:129-152 precomputes the same
    rounding). Returns (|k1|, sign(k1), |k2|, sign(k2)), signs in {1, -1}.
    Variable-time: public scalars only; secrets take glv_decompose_device."""
    g = curve.glv
    n = curve.n
    a1, b1, a2, b2 = g["a1"], g["b1"], g["a2"], g["b2"]
    c1 = (b2 * k + n // 2) // n
    c2 = (-b1 * k + n // 2) // n
    k1 = k - c1 * a1 - c2 * a2
    k2 = -c1 * b1 - c2 * b2
    assert (k1 + k2 * g["lam"]) % n == k % n
    return abs(k1), (1 if k1 >= 0 else -1), abs(k2), (1 if k2 >= 0 else -1)


def scalar_mul_glv(Q: Point, k_limbs: torch.Tensor) -> Point:
    """k*Q through the device GLV split and the endomorphism: one base, two
    signed 132-bit halves on the `ladder` kernel (34 windows instead of 65;
    mul.rs:342-393, 443-445). Constant-time: the split is branchless and the
    ladder selects by mask."""
    return lincomb_glv([(Q, k_limbs)])
