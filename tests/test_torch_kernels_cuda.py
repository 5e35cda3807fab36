"""tpu_ecc_torch's CUDA kernels against their plain PyTorch twins, on the card.

dma_gather must equal its twin word for word (tolerance: exact); the
thirteen kernels on the 32-bit field layer (padd, pdouble, padd_chain,
segscan, ladder, genmul, bucket_reduce, horner, pow, fixup, ladder_probe,
fmul_chain, mxu_chain) store canonical values: the element of pow,
fmul_chain and mxu_chain and each projective coordinate of the others must
equal the twin's mod p (exact, by canonical limbs), segscan's `scanned` at
its run-end rows, the only rows it writes. The BIP340 and RFC 9380
vectors (tests/vectors/) run through the protocols' entry points with
device=None. These tests need an NVIDIA card and nvcc; they skip without
them. Run them on the card
with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

(`--noconftest`: the suite's conftest sets up JAX, which the card's machine
does not need.)
"""

import numpy as np
import pytest
import torch

from tpu_ecc_torch.curves.specs import get_curve
from tpu_ecc_torch.ops import fe as F
from tpu_ecc_torch.ops import kernels
from tpu_ecc_torch.ops import points as P
from tpu_ecc_torch.utils import ec_host

pytestmark = pytest.mark.cuda

B = 300          # not a multiple of the block: the ragged edge is masked


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.fixture
def k256():
    return get_curve("secp256k1")


CURVES = ["secp256k1", "p256"]      # a = 0 (solinas field), a = -3 (Montgomery)
# every curve: the layer at N = 6 (p192), 7 (p224), 8, 12 (p384, bp384t1,
# bp384r1) and 17 (p521); a = 0, a = -3 and the generic a (the r1 curves)
GENERIC_CURVES = ["bp256r1", "bp384r1"]
POINT_CURVES = CURVES + ["p192", "p224", "p384", "p521", "sm2", "bign256", "bp256t1",
                         "bp384t1"] + GENERIC_CURVES
WIDE_CURVES = POINT_CURVES[2:]
# the curves whose MSM phase kernels are built beside secp256k1's and P-384's
MSM_CURVES = ["p256", "sm2", "bign256", "p224", "p192", "bp256t1", "bp256r1", "bp384t1",
              "bp384r1", "p521"]
PHASE_KERNELS = ("segscan", "fixup", "bucket_reduce", "horner")


def _points(curve, seed, b, dev):
    """b steady points k*G for random k (a few distinct, tiled)."""
    rng = np.random.default_rng(seed)
    ks = [int(v) for v in rng.integers(1, 2**62, 16)]
    pts = [ec_host.aff_mul(curve, k, ec_host.aff_generator(curve)) for k in ks]
    pts = [pts[i % len(pts)] for i in range(b)]
    Q = P.from_affine_ints(curve, [p[0] for p in pts], [p[1] for p in pts], dev)
    return P.point_limbs(P.steady(Q))


@pytest.mark.parametrize("name", POINT_CURVES)
def test_padd_and_pdouble_match_plain(dev, name):
    """One add and one doubling per lane (the 32-bit layer at the curve's
    word count), with a doubling lane (a = b), an inverse pair (a = -b) and
    identities among the random lanes: equal mod p by canonical
    coordinates, the kernel's limbs canonical, and the host oracle's sums."""
    curve = get_curve(name)
    a = _points(curve, 1, B, dev)
    b = _points(curve, 2, B, dev).clone()
    b[:, :, 1] = a[:, :, 1]
    b[:, :, 2] = P.point_limbs(P.steady(P.pneg(P.point_from_limbs(curve, a[:, :, 2:3]))))[..., 0]
    ident = P.point_limbs(P.identity(curve, (1,), dev))[..., 0]
    a[:, :, 3] = ident
    b[:, :, 4] = ident
    out = kernels.padd(curve, a, b)
    torch.cuda.synchronize()
    _same_mod_p(curve, out, kernels.padd_plain(curve, a, b))
    out = kernels.pdouble(curve, a)
    torch.cuda.synchronize()
    _same_mod_p(curve, out, kernels.pdouble_plain(curve, a))
    pa, pb = P.point_from_limbs(curve, a), P.point_from_limbs(curve, b)
    a_aff, b_aff = _affine(curve, a), _affine(curve, b)
    assert _affine(curve, P.point_limbs(kernels.padd_points(pa, pb))) == \
        [ec_host.aff_add(curve, u, v) for u, v in zip(a_aff, b_aff)]
    assert _affine(curve, P.point_limbs(kernels.pdouble_points(pa))) == \
        [ec_host.aff_add(curve, u, u) for u in a_aff]


def _affine(curve, limbs):
    x, y, inf = P.to_affine(P.point_from_limbs(curve, limbs))
    return [None if i else (xv, yv) for xv, yv, i in
            zip(F.fe_to_ints(x), F.fe_to_ints(y), inf.tolist())]


def _canonical(curve, limbs):
    """Point limbs [3, n, ...] -> each coordinate's canonical limbs."""
    f = curve.field
    return torch.stack([F.fcanonical(F.fe_steady(f, limbs[c].to(torch.int64))).limbs
                        for c in range(3)], 0)


@pytest.mark.parametrize("name", POINT_CURVES)
def test_padd_chain_matches_plain(dev, name):
    """Equal mod p by canonical coordinates (the 32-bit layer, at each
    curve's word count), and the kernel's own limbs canonical."""
    curve = get_curve(name)
    a = _points(curve, 1, B, dev)
    b = _points(curve, 2, B, dev)
    out = kernels.padd_chain(curve, a, b, 5)
    torch.cuda.synchronize()
    assert torch.equal(_canonical(curve, out), out.to(torch.int64))
    assert torch.equal(_canonical(curve, out),
                       _canonical(curve, kernels.padd_chain_plain(curve, a, b, 5)))


@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize("field", ["fp", "fn"])
def test_pow_matches_plain(dev, name, field):
    """Equal mod p by canonical limbs (the 32-bit layer, Scalar32 for the
    scalar field), the kernel's own limbs canonical, and x^-1 by Python."""
    curve = get_curve(name)
    spec = curve.field if field == "fp" else curve.scalar
    rng = np.random.default_rng(3)
    xs = [int(v) * 0x9E3779B97F4A7C15 % spec.p for v in rng.integers(1, 2**62, B)]
    x = F.fsteady(F.fe_from_ints(spec, xs, dev)).limbs
    out = kernels.fpow(spec, x, spec.p - 2)
    torch.cuda.synchronize()

    def canonical(limbs):
        return F.fcanonical(F.fe_steady(spec, limbs.to(torch.int64))).limbs

    assert torch.equal(canonical(out), out.to(torch.int64))
    assert torch.equal(canonical(out), canonical(kernels.fpow_plain(spec, x, spec.p - 2)))
    assert F.fe_to_ints(F.fe_steady(spec, out)) == [pow(v, -1, spec.p) for v in xs]


@pytest.mark.parametrize("name", ["p384", "bp256r1"])
def test_pow_refuses_fields_off_the_layer(dev, name):
    """No field is off the layer any more: P-384 (12 words) and bp256r1
    (whose rows load by mont(lo, to32) + mont(to32h, h)) run pow on the
    card on both fields, one launch each, equal mod p to the twin by
    canonical limbs, and x^-1 by Python."""
    curve = get_curve(name)
    rng = np.random.default_rng(4)
    for spec in (curve.field, curve.scalar):
        xs = [int.from_bytes(rng.bytes(spec.bits // 8 + 8), "big") % spec.p for _ in range(B)]
        x = F.fsteady(F.fe_from_ints(spec, xs, dev)).limbs
        kernels.reset_launches()
        out = kernels.fpow(spec, x, spec.p - 2)
        torch.cuda.synchronize()
        assert kernels.launches["pow"] == 1
        canonical = F.fcanonical(F.fe_steady(spec, out.to(torch.int64))).limbs
        assert torch.equal(canonical, out.to(torch.int64))
        want = kernels.fpow_plain(spec, x, spec.p - 2)
        assert torch.equal(canonical, F.fcanonical(F.fe_steady(spec, want)).limbs)
        assert F.fe_to_ints(F.fe_steady(spec, out)) == [pow(v, -1, spec.p) if v else 0
                                                        for v in xs]


def _same_mod_p(curve, out, want):
    """The kernel's limbs canonical and each coordinate equal to want's mod p."""
    assert torch.equal(_canonical(curve, out), out.to(torch.int64))
    assert torch.equal(_canonical(curve, out), _canonical(curve, want))


def _random_ladder(curve, T, H, nw, b, dev, seed):
    bases = torch.stack([_points(curve, seed + t, b, dev) for t in range(T)], 0)
    rng = np.random.default_rng(seed)
    mag = torch.from_numpy(rng.integers(0, 9, (nw, H, b))).to(dev)
    neg = torch.from_numpy(rng.integers(0, 2, (nw, H, b)).astype(bool)).to(dev)
    return bases, mag, neg


@pytest.mark.parametrize("glv", [True, False])
def test_ladder_matches_plain(dev, k256, glv):
    """Equal mod p by canonical coordinates (the 32-bit layer): GLV with
    T = 2 and H = 1 (the first window seeds the sum)."""
    T = 2 if glv else 1
    bases, mag, neg = _random_ladder(k256, T, 2 * T if glv else T, 5, B, dev, 10)
    out = kernels.ladder(k256, bases, mag, neg, glv=glv)
    torch.cuda.synchronize()
    _same_mod_p(k256, out, kernels.ladder_plain(k256, bases, mag, neg, glv=glv))


@pytest.mark.parametrize("T", [8, 9])
def test_ladder_straus_shape_matches_plain(dev, k256, T):
    """T = 8 with GLV, the largest table the port launches (the Straus MSM's
    terms; 221 KB of shared memory a block of 32 lanes), and T = 9 (29
    lanes a block, the kernel's other instance), on 3 windows."""
    bases, mag, neg = _random_ladder(k256, T, 2 * T, 3, B, dev, 30)
    out = kernels.ladder(k256, bases, mag, neg, glv=True)
    torch.cuda.synchronize()
    _same_mod_p(k256, out, kernels.ladder_plain(k256, bases, mag, neg, glv=True))


def test_ladder_refuses_tables_beyond_shared_memory(dev, k256):
    """A T whose one-lane tables (864 B a base) exceed a block's shared
    memory raises before any launch."""
    T = kernels.SMEM_BLOCK // 864 + 1
    _, mag, neg = _random_ladder(k256, 1, T, 1, 2, dev, 40)
    bases = _points(k256, 40, 2, dev).expand(T, -1, -1, -1).contiguous()
    before = kernels.launches["ladder"]
    with pytest.raises(ValueError):
        kernels.ladder(k256, bases, mag, neg)
    assert kernels.launches["ladder"] == before


def test_ladder_without_glv_matches_plain(dev):
    """P-256 (no endomorphism): the verify's two-term ladder, T = 2 on 65
    windows as ladder_inputs makes them, equal mod p by canonical
    coordinates; a glv launch is refused."""
    p256 = get_curve("p256")
    from tpu_ecc_torch.ops import scalarmul as SM

    rng = np.random.default_rng(6)
    Q = P.point_from_limbs(p256, _points(p256, 11, B, dev))
    ks = [SM.pack_scalars(p256, [int.from_bytes(rng.bytes(32), "big") for _ in range(B)],
                          dev) for _ in range(2)]
    bases, mag, neg = SM.ladder_inputs([(P.generator(p256, (B,), dev), ks[0]), (Q, ks[1])])
    assert mag.shape == (65, 2, B)
    out = kernels.ladder(p256, bases, mag, neg)
    torch.cuda.synchronize()
    _same_mod_p(p256, out, kernels.ladder_plain(p256, bases, mag, neg))
    with pytest.raises(ValueError):
        kernels.ladder(p256, bases, mag, neg, glv=True)


@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize("b", [256, 4096])
def test_genmul_matches_plain(dev, name, b):
    """Equal mod p by canonical coordinates (the 32-bit layer)."""
    curve = get_curve(name)
    from tpu_ecc_torch.ops import scalarmul as SM

    rng = np.random.default_rng(5)
    ks = [0, curve.n - 1] + [int.from_bytes(rng.bytes(32), "big") for _ in range(b - 2)]
    mag, neg = SM.signed_digits(curve, SM.pack_scalars(curve, ks, dev))
    tbl = SM._gen_table(curve, dev)
    mag, neg = mag.flip(0), neg.flip(0)
    out = kernels.genmul(curve, tbl, mag, neg)
    torch.cuda.synchronize()
    _same_mod_p(curve, out, kernels.genmul_plain(curve, tbl, mag, neg))


def test_ladder_glv_single_term_matches_plain(dev, k256):
    """ECDH's shape on secp256k1: one base through the GLV split (T = 1, H
    = 2, 34 windows) as scalar_mul_glv makes it, equal mod p to the twin
    by canonical coordinates, one launch; its affine points equal the host
    oracle's, d = 0 and d = n - 1 among the lanes."""
    from tpu_ecc_torch.ops import scalarmul as SM

    rng = np.random.default_rng(12)
    Q = P.point_from_limbs(k256, _points(k256, 13, B, dev))
    ds = [0, k256.n - 1] + [int.from_bytes(rng.bytes(32), "big") % k256.n for _ in range(B - 2)]
    k = SM.pack_scalars(k256, ds, dev)
    bases, mag, neg = SM.ladder_inputs([(Q, k)], glv=True)
    assert mag.shape == (34, 2, B)
    kernels.reset_launches()
    out = kernels.ladder(k256, bases, mag, neg, glv=True)
    torch.cuda.synchronize()
    assert kernels.launches["ladder"] == 1
    _same_mod_p(k256, out, kernels.ladder_plain(k256, bases, mag, neg, glv=True))
    x, y, inf = P.to_affine(SM.scalar_mul_glv(Q, k))
    qs = list(zip(F.fe_to_ints(P.to_affine(Q)[0]), F.fe_to_ints(P.to_affine(Q)[1])))
    want = [ec_host.aff_mul(k256, d, q) for d, q in zip(ds, qs)]
    got = [None if i else (a, b) for a, b, i in zip(F.fe_to_ints(x), F.fe_to_ints(y),
                                                    inf.tolist())]
    assert got == want


@pytest.mark.parametrize("name", ["secp256k1", "p256", "p384", "p521"])
def test_pow_sswu_exponent_matches_plain(dev, name):
    """pow at hash-to-curve's SSWU exponent e = (p - 3)/4 on the base field
    of each RFC 9380 suite: equal mod p to the twin by canonical limbs, one
    launch, and x^e by Python."""
    spec = get_curve(name).field
    e = (spec.p - 3) // 4
    rng = np.random.default_rng(14)
    xs = [int.from_bytes(rng.bytes(spec.bits // 8 + 8), "big") % spec.p for _ in range(B)]
    x = F.fsteady(F.fe_from_ints(spec, xs, dev)).limbs
    kernels.reset_launches()
    out = kernels.fpow(spec, x, e)
    torch.cuda.synchronize()
    assert kernels.launches["pow"] == 1
    canonical = F.fcanonical(F.fe_steady(spec, out.to(torch.int64))).limbs
    assert torch.equal(canonical, out.to(torch.int64))
    want = kernels.fpow_plain(spec, x, e)
    assert torch.equal(canonical, F.fcanonical(F.fe_steady(spec, want)).limbs)
    assert F.fe_to_ints(F.fe_steady(spec, out)) == [pow(v, e, spec.p) for v in xs]


def _vectors(name):
    import json
    import pathlib

    return json.loads((pathlib.Path(__file__).parent / "vectors" / name).read_text())


def test_bip340_vectors_on_the_card(dev):
    """BIP340's sign vectors byte for byte and its verify vectors' booleans
    (with a tampered signature) through the entry points with device=None."""
    from tpu_ecc_torch.protocols import schnorr

    c = get_curve("secp256k1")
    bip = _vectors("bip340.json")
    sv = bip["sign"]
    ds = [int(v["seckey"], 16) for v in sv]
    msgs = [bytes.fromhex(v["msg"]) for v in sv]
    sigs = [bytes.fromhex(v["sig"]) for v in sv]
    assert schnorr.sign_batch(c, ds, msgs, [bytes.fromhex(v["aux_rand"]) for v in sv]) == sigs
    pxs = schnorr.xonly_public_keys(c, ds)
    bad = bytearray(sigs[0])
    bad[-1] ^= 1
    vv = bip["verify"]
    got = schnorr.verify_batch(c, pxs + pxs[:1] + [int(v["pubkey"], 16) for v in vv],
                               msgs + msgs[:1] + [bytes.fromhex(v["msg"]) for v in vv],
                               sigs + [bytes(bad)] + [bytes.fromhex(v["sig"]) for v in vv])
    assert got == [True] * len(sv) + [False] + [v["valid"] for v in vv]


@pytest.mark.parametrize("name", ["secp256k1", "p256", "p384", "p521"])
def test_rfc9380_vectors_on_the_card(dev, name):
    """RFC 9380's final points of the suite through hash_to_curve with
    device=None, exactly."""
    from tpu_ecc_torch.protocols import hash2curve

    suite = _vectors("rfc9380_h2c.json")["suites"][name]
    got = hash2curve.hash_to_curve(get_curve(name), [c["msg"].encode() for c in suite["cases"]],
                                   suite["dst"].encode())
    assert got == [(int(c["x"], 16), int(c["y"], 16)) for c in suite["cases"]]


def _window_group(curve, dev, N, L, w, signed, windows):
    """The first `windows` windows of a Pippenger MSM over N steady points
    (16 distinct, tiled) with random full-width scalars, sorted and laid out
    as msm_pippenger gives them to the phase kernels."""
    from tpu_ecc_torch.ops import scalarmul as SM
    from tpu_ecc_torch.parallel import msm as M

    pl = _points(curve, 20, N, dev)
    rng = np.random.default_rng(N + w)
    ks = [0, curve.n - 1] + [int.from_bytes(rng.bytes(curve.scalar_bytes), "big")
                             for _ in range(N - 2)]
    f = curve.field
    payload, keys, negs, nbuck = M.pippenger_inputs(
        curve, F.fe_steady(f, pl[0]), F.fe_steady(f, pl[1]),
        torch.zeros(N, dtype=torch.bool, device=dev), SM.pack_scalars(curve, ks, dev),
        w, signed=signed)
    negs = None if negs is None else negs[:windows]
    return M.sorted_windows(payload, keys[:windows], negs, L), nbuck


# (N, L, w, windows): a small shape and a path-like one (8192 lanes and, with
# signed digits at w = 14, 8192 buckets)
SHAPES = [(512, 32, 8, 2), (1 << 17, 8192, 14, 2)]


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=["small", "path"])
def test_msm_phases_match_plain(dev, k256, shape, signed):
    """segscan, fixup and bucket_reduce on a real sorted window group, each
    against its twin on the same inputs: segscan by canonical coordinates
    at its run-end rows, last_key exactly; fixup and bucket_reduce (both
    drop0 values) by canonical coordinates, their own limbs canonical."""
    from tpu_ecc_torch.parallel import msm as M

    N, L, w, windows = shape
    (skey, key2, val2, neg2), nbuck = _window_group(k256, dev, N, L, w, signed, windows)
    got = kernels.segscan(k256, key2, val2, nbuck, neg2)
    torch.cuda.synchronize()
    want = kernels.segscan_plain(k256, key2, val2, nbuck, neg2)
    ends = torch.ones_like(key2, dtype=torch.bool)
    ends[:-1] = key2[1:] != key2[:-1]
    at_ends = [_canonical(k256, sc.movedim(0, 2)[:, :, ends]) for sc in (got[0], want[0])]
    assert torch.equal(*at_ends)
    assert torch.equal(got[1], want[1])
    for g, x in zip(got[2:], want[2:]):
        assert torch.equal(_canonical(k256, g), _canonical(k256, x))
    scanned, last_key, tail, lead = want
    fixed = kernels.fixup(k256, tail, last_key, key2[0], lead)
    torch.cuda.synchronize()
    _same_mod_p(k256, fixed, kernels.fixup_plain(k256, tail, last_key, key2[0], lead))
    buckets = M.bucket_lookup(k256, skey, scanned, fixed, key2[0], nbuck)
    for drop0 in (False, True):
        out = kernels.bucket_reduce(k256, buckets, drop0)
        torch.cuda.synchronize()
        _same_mod_p(k256, out, kernels.bucket_reduce_plain(k256, buckets, drop0))


def test_fixup_single_lane_windows_match_plain(dev, k256):
    """L = 1: no scan step, the last launch alone over 300 windows of one
    lane (a ragged last block), each lane lead + O: equal mod p by
    canonical coordinates to the twin's, the kernel's limbs canonical."""
    t_l = _points(k256, 5, B, dev).reshape(3, -1, B, 1)
    lead = _points(k256, 6, B, dev).reshape(3, -1, B, 1)
    keys = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    out = kernels.fixup(k256, t_l, keys, keys, lead)
    torch.cuda.synchronize()
    _same_mod_p(k256, out, kernels.fixup_plain(k256, t_l, keys, keys, lead))


def test_horner_matches_plain(dev, k256):
    """w = 14 over 19 window sums, MSB first (the signed 2^20-point MSM):
    equal mod p by canonical coordinates, the kernel's limbs canonical."""
    s_all = _points(k256, 21, 19, dev).permute(2, 0, 1).contiguous()
    out = kernels.horner(k256, s_all, 14)
    torch.cuda.synchronize()
    _same_mod_p(k256, out, kernels.horner_plain(k256, s_all, 14))


MSM_CASES = [("secp256k1", 1 << 15), ("secp256k1", 4096)] + [(c, 1 << 14) for c in MSM_CURVES]


@pytest.mark.parametrize("name,n_points", MSM_CASES,
                         ids=["32768", "4096"] + [f"{c}-16384" for c in MSM_CURVES])
def test_msm_on_the_card_equals_host(dev, name, n_points):
    """msm() on the card (Pippenger from 2^14 points, Straus below) against
    (sum a_i*k_i mod n)*G for points a_i*G, full-width scalars: on
    secp256k1, and at 2^14 points (signed w = 14, 4096 lanes) on each curve
    whose phase kernels are built beside it, with the four launched."""
    from tpu_ecc_torch.ops import scalarmul as SM
    from tpu_ecc_torch.parallel import msm as M

    curve = get_curve(name)
    nb = curve.scalar_bytes
    rng = np.random.default_rng(n_points)
    a = [int.from_bytes(rng.bytes(nb), "big") % (curve.n - 1) + 1 for _ in range(n_points)]
    k = [int.from_bytes(rng.bytes(nb), "big") % curve.n for _ in range(n_points)]
    pts = SM.derive_public_batch(curve, a)
    want = ec_host.aff_mul(curve, sum(x * y for x, y in zip(a, k)) % curve.n,
                           ec_host.aff_generator(curve))
    kernels.reset_launches()
    assert M.msm(curve, pts, k) == want
    used = PHASE_KERNELS if n_points >= 1 << 14 else ("ladder",)
    assert all(kernels.launches[kname] > 0 for kname in used)


@pytest.mark.parametrize("name", WIDE_CURVES)
def test_wide_builds_match_plain(dev, name):
    """Each build of the curves the layer takes at their own word count
    against its twin, by canonical values mod p: pow on both fields at e =
    p - 2, the ladder (T = 2 without GLV, 3 windows) and genmul (the
    first 12 windows of the comb)."""
    from tpu_ecc_torch.ops import scalarmul as SM

    curve = get_curve(name)
    rng = np.random.default_rng(7)
    for spec in (curve.field, curve.scalar):
        xs = [int.from_bytes(rng.bytes(spec.bits // 8 + 8), "big") % spec.p for _ in range(B)]
        x = F.fsteady(F.fe_from_ints(spec, xs, dev)).limbs
        out = kernels.fpow(spec, x, spec.p - 2)
        torch.cuda.synchronize()
        want = kernels.fpow_plain(spec, x, spec.p - 2)
        assert torch.equal(F.fcanonical(F.fe_steady(spec, out.to(torch.int64))).limbs,
                           F.fcanonical(F.fe_steady(spec, want)).limbs)
    bases, mag, neg = _random_ladder(curve, 2, 2, 3, B, dev, 50)
    out = kernels.ladder(curve, bases, mag, neg)
    torch.cuda.synchronize()
    _same_mod_p(curve, out, kernels.ladder_plain(curve, bases, mag, neg))
    ks = [0, curve.n - 1] + [int.from_bytes(rng.bytes(curve.scalar_bytes), "big")
                             for _ in range(B - 2)]
    mag, neg = SM.signed_digits(curve, SM.pack_scalars(curve, ks, dev))
    mag, neg, tbl = mag.flip(0)[:12], neg.flip(0)[:12], SM._gen_table(curve, dev)[:12]
    out = kernels.genmul(curve, tbl, mag, neg)
    torch.cuda.synchronize()
    _same_mod_p(curve, out, kernels.genmul_plain(curve, tbl, mag, neg))


@pytest.mark.parametrize("name", GENERIC_CURVES)
def test_generic_curves_point_kernels_match_plain(dev, name):
    """The r1 curves' generic-a formulas (RCB Algorithms 1-3) on the layer:
    padd and pdouble, the verify's ladder (T = 2 without GLV, on all the
    scalar's windows) and genmul (every window of the comb, k = 0 and n - 1
    among the scalars) each equal their twin mod p and launch their kernel
    once; derive_public_batch on the card equals the host oracle."""
    from tpu_ecc_torch.ops import scalarmul as SM

    curve = get_curve(name)
    rng = np.random.default_rng(8)
    a, b = _points(curve, 1, B, dev), _points(curve, 2, B, dev)
    ks = [SM.pack_scalars(curve, [int.from_bytes(rng.bytes(curve.scalar_bytes), "big")
                                  for _ in range(B)], dev) for _ in range(2)]
    bases, mag, neg = SM.ladder_inputs([(P.generator(curve, (B,), dev), ks[0]),
                                        (P.point_from_limbs(curve, b), ks[1])])
    kg = [0, curve.n - 1] + [int.from_bytes(rng.bytes(curve.scalar_bytes), "big")
                             for _ in range(B - 2)]
    mag_g, neg_g = SM.signed_digits(curve, SM.pack_scalars(curve, kg, dev))
    mag_g, neg_g, tbl = mag_g.flip(0), neg_g.flip(0), SM._gen_table(curve, dev)
    runs = {"padd": (lambda: kernels.padd(curve, a, b), lambda: kernels.padd_plain(curve, a, b)),
            "pdouble": (lambda: kernels.pdouble(curve, a),
                        lambda: kernels.pdouble_plain(curve, a)),
            "ladder": (lambda: kernels.ladder(curve, bases, mag, neg),
                       lambda: kernels.ladder_plain(curve, bases, mag, neg)),
            "genmul": (lambda: kernels.genmul(curve, tbl, mag_g, neg_g),
                       lambda: kernels.genmul_plain(curve, tbl, mag_g, neg_g))}
    for kname, (kern, plain) in runs.items():
        kernels.reset_launches()
        out = kern()
        torch.cuda.synchronize()
        assert kernels.launches[kname] == 1 and sum(kernels.launches.values()) == 1, kname
        _same_mod_p(curve, out, plain())
    ds = [int.from_bytes(rng.bytes(curve.scalar_bytes), "big") % (curve.n - 1) + 1
          for _ in range(8)]
    G = ec_host.aff_generator(curve)
    assert SM.derive_public_batch(curve, ds) == [ec_host.aff_mul(curve, d, G) for d in ds]


def test_ladder_straus_shape_on_p521(dev):
    """P-521's T = 8 with 3N = 51 words a point: 14688 B of tables a lane,
    so a block takes 15 lanes (the kernel's stride-in-a-register
    instance), on 3 windows; equal mod p by canonical coordinates."""
    p521 = get_curve("p521")
    assert kernels.ladder_lanes(8, p521) == 15
    bases, mag, neg = _random_ladder(p521, 8, 8, 3, 64, dev, 60)
    out = kernels.ladder(p521, bases, mag, neg)
    torch.cuda.synchronize()
    _same_mod_p(p521, out, kernels.ladder_plain(p521, bases, mag, neg))


def _phase_holds(curve, dev, drops):
    """segscan, fixup, bucket_reduce (each drop0 of `drops`) and horner of
    `curve` at small shapes (N = 512, 32 lanes, w = 8, 2 signed windows;
    horner over 5 window sums at w = 14), each by canonical coordinates
    mod p against its twin, segscan at its run-end rows; each launches its
    own kernel and no other."""
    from tpu_ecc_torch.parallel import msm as M

    def launched(name, fn):
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        assert kernels.launches[name] > 0
        assert sum(kernels.launches.values()) == kernels.launches[name], name
        return out

    (skey, key2, val2, neg2), nbuck = _window_group(curve, dev, 512, 32, 8, True, 2)
    got = launched("segscan", lambda: kernels.segscan(curve, key2, val2, nbuck, neg2))
    want = kernels.segscan_plain(curve, key2, val2, nbuck, neg2)
    ends = torch.ones_like(key2, dtype=torch.bool)
    ends[:-1] = key2[1:] != key2[:-1]
    assert torch.equal(*[_canonical(curve, sc.movedim(0, 2)[:, :, ends])
                         for sc in (got[0], want[0])])
    assert torch.equal(got[1], want[1])
    scanned, last_key, tail, lead = want
    fixed = launched("fixup", lambda: kernels.fixup(curve, tail, last_key, key2[0], lead))
    _same_mod_p(curve, fixed, kernels.fixup_plain(curve, tail, last_key, key2[0], lead))
    buckets = M.bucket_lookup(curve, skey, scanned, fixed, key2[0], nbuck)
    for drop0 in drops:
        out = launched("bucket_reduce", lambda: kernels.bucket_reduce(curve, buckets, drop0))
        _same_mod_p(curve, out, kernels.bucket_reduce_plain(curve, buckets, drop0))
    s_all = _points(curve, 21, 5, dev).permute(2, 0, 1).contiguous()
    out = launched("horner", lambda: kernels.horner(curve, s_all, 14))
    _same_mod_p(curve, out, kernels.horner_plain(curve, s_all, 14))


@pytest.mark.parametrize("name", MSM_CURVES)
def test_msm_phases_on_each_curve_match_plain(dev, name):
    """The phase kernels' builds for P-256 and the nine other curves (N =
    6, 7, 8 with CIOS, solinas or the Montgomery load, 12 and 17; a = -3
    and the generic a) against their twins at small shapes, bucket_reduce
    with and without drop0 (`_phase_holds`)."""
    _phase_holds(get_curve(name), dev, (False, True))


def test_msm_phases_on_p384_match_plain(dev):
    """P-384's builds of padd_chain, segscan, fixup, bucket_reduce and
    horner at small shapes (the chain at repeat 3; the phases as
    `_phase_holds`), each by canonical coordinates mod p against its twin,
    and msm() at 2^14 points equal to the host's (sum a_i k_i mod n) G with
    the four phase kernels launched."""
    from tpu_ecc_torch.ops import scalarmul as SM
    from tpu_ecc_torch.parallel import msm as M

    p384 = get_curve("p384")
    a, b = _points(p384, 1, B, dev), _points(p384, 2, B, dev)
    out = kernels.padd_chain(p384, a, b, 3)
    torch.cuda.synchronize()
    _same_mod_p(p384, out, kernels.padd_chain_plain(p384, a, b, 3))
    _phase_holds(p384, dev, (False,))
    rng = np.random.default_rng(8)
    ai = [int.from_bytes(rng.bytes(48), "big") % (p384.n - 1) + 1 for _ in range(1 << 14)]
    ki = [int.from_bytes(rng.bytes(48), "big") % p384.n for _ in range(1 << 14)]
    pts = SM.derive_public_batch(p384, ai)
    kernels.reset_launches()
    assert M.msm(p384, pts, ki) == ec_host.aff_mul(
        p384, sum(x * y for x, y in zip(ai, ki)) % p384.n, ec_host.aff_generator(p384))
    assert all(kernels.launches[kname] > 0 for kname in PHASE_KERNELS)


# the probe kernels (tpu_ecc_torch/tools/)

def _gather_holds(pay, idx_np, Cb, depth, dev):
    """dma_gather over idx_np equals its twin and numpy's XOR of the rows."""
    idx = torch.from_numpy(idx_np).to(dev)
    out = kernels.dma_gather(pay, idx, Cb, depth)
    torch.cuda.synchronize()
    assert torch.equal(out, kernels.dma_gather_plain(pay, idx))
    want = np.bitwise_xor.reduce(pay.cpu().numpy()[idx_np], axis=0, keepdims=True)
    np.testing.assert_array_equal(out.cpu().numpy(), want)
    return out


@pytest.mark.parametrize("depth", [2, 8, 16])
@pytest.mark.parametrize("Cb", [256, 1024, 4096])
@pytest.mark.parametrize("W", [32, 128])
def test_dma_gather_matches_plain(dev, W, Cb, depth):
    """The XOR of the gathered rows equals the twin's and numpy's, at the
    tool's chunks and depths (M = 2 Cb + 8192: 2 + 8192 / Cb chunks, each
    split into runs of GATHER_ROWS rows, one a warp)."""
    from tpu_ecc_torch.tools import bench_gather_probe as G

    N, M = 4096, 2 * Cb + 8192
    pay = G.device_payload(N, W, dev)
    idx_np = np.random.default_rng(depth).integers(0, N, M).astype(np.int32)
    _gather_holds(pay, idx_np, Cb, depth, dev)


@pytest.mark.parametrize("Cb,depth", [(256, 8), (4096, 16), (200, 8)])
def test_dma_gather_pairs_cancel(dev, Cb, depth):
    """idx of rows gathered twice, whose pairs cancel under XOR, and one
    row once: the result is that row alone, so a row gathered twice or
    never shows. The pairs lie in one run, across the runs of a chunk and
    across chunks; Cb = 200 splits into runs of 29 rows and a last of 26,
    no multiple of the depth."""
    from tpu_ecc_torch.tools import bench_gather_probe as G

    N, W = 4096, 128
    pay = G.device_payload(N, W, dev)
    rng = np.random.default_rng(Cb)
    M = 4 * Cb
    half = rng.integers(0, N, M // 2).astype(np.int32)
    idx_np = rng.permutation(np.concatenate([half, half]))
    idx_np[np.flatnonzero(idx_np == idx_np[0])] = 7       # those pairs now cancel on row 7
    idx_np[0] = 9          # one row 7 left unpaired, and row 9 once
    out = _gather_holds(pay, idx_np, Cb, depth, dev)
    assert torch.equal(out, pay[7:8] ^ pay[9:10])


@pytest.mark.parametrize("W", [32, 128])
def test_dma_gather_smallest_shape(dev, W):
    """M = Cb = depth (one warp of a block whose other warps idle, one
    round of its ring), and M = 0."""
    from tpu_ecc_torch.tools import bench_gather_probe as G

    pay = G.device_payload(64, W, dev)
    for depth in (1, 2, 16):
        _gather_holds(pay, np.arange(depth, dtype=np.int32)[::-1].copy(), depth, depth, dev)
    out = kernels.dma_gather(pay, torch.empty(0, dtype=torch.int32, device=dev), 4, 2)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(pay[:1]))


FIELDS = ["secp256k1.fp", "p256.fp", "k256mxu.fp", "p384.fp"]
MXU_FIELDS = FIELDS[1:]


def _field(name):
    if name == "k256mxu.fp":
        return F.make_field_spec(name, get_curve("secp256k1").p, "mont")
    return get_curve(name.split(".")[0]).field


def _field_inputs(spec, dev, seed, b=B):
    """0, 1, p - 1 and random elements, and the same reversed."""
    rng = np.random.default_rng(seed)
    vals = [0, 1, spec.p - 1] + [int.from_bytes(rng.bytes(64), "big") % spec.p
                                 for _ in range(b - 3)]
    return (F.fe_from_ints(spec, vals, dev).limbs,
            F.fe_from_ints(spec, vals[::-1], dev).limbs)


def _same_field_mod_p(spec, out, want):
    """The kernel's limbs canonical and equal to want's mod p."""
    def canonical(limbs):
        return F.fcanonical(F.fe_steady(spec, limbs.to(torch.int64))).limbs

    assert torch.equal(canonical(out), out.to(torch.int64))
    assert torch.equal(canonical(out), canonical(want))


@pytest.mark.parametrize("name", FIELDS)
def test_fmul_chain_matches_plain(dev, name):
    """The 32-bit layer's multiply, 16 times, equal mod p to the twin (B =
    300: the last block is ragged)."""
    spec = _field(name)
    a, b = _field_inputs(spec, dev, 7)
    out = kernels.fmul_chain(spec, a, b)
    torch.cuda.synchronize()
    _same_field_mod_p(spec, out, kernels.fmul_chain_plain(spec, a, b))


@pytest.mark.parametrize("name", MXU_FIELDS)
@pytest.mark.parametrize("lanes", [256, 300])
def test_mxu_chain_matches_plain(dev, name, lanes):
    """The byte-digit `wgmma` chain equal mod p to the twin: at 256 lanes
    every warpgroup (kernels.MXU_LANES = 64 lanes) is full; at 300 the last
    holds 44 lanes, and its other 20 run every product on zero digits."""
    spec = _field(name)
    a, b = _field_inputs(spec, dev, 8, lanes)
    kernels.reset_launches()
    out = kernels.mxu_chain(spec, a, b)
    torch.cuda.synchronize()
    assert kernels.launches["mxu_chain"] == 1
    _same_field_mod_p(spec, out, kernels.mxu_chain_plain(spec, a, b))


def test_mxu_chain_refuses_a_wide_field():
    """A Montgomery field above 12 words (P-521's scalar field, 17) raises
    ValueError before any build or launch, on a meta tensor; P-384's field
    (12) passes that check and stops only at the CUDA one."""
    wide = get_curve("p521").scalar
    x = torch.empty((wide.n_limbs, 4), dtype=torch.int64, device="meta")
    kernels.reset_launches()
    with pytest.raises(ValueError, match="at most N = 12"):
        kernels.mxu_chain(wide, x, x)
    p384 = _field("p384.fp")
    x = torch.empty((p384.n_limbs, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.mxu_chain(p384, x, x)
    assert kernels.launches["mxu_chain"] == 0


@pytest.mark.parametrize("variant", kernels.PROBE_VARIANTS)
def test_ladder_probe_matches_plain(dev, k256, variant):
    nw = 3
    bases = _points(k256, 13, B, dev)
    rng = np.random.default_rng(9)
    mag = torch.from_numpy(rng.integers(0, 9, (nw, 2, B))).to(dev)
    neg = torch.from_numpy(rng.integers(0, 2, (nw, 2, B)).astype(bool)).to(dev)
    out = kernels.ladder_probe(k256, bases, mag, neg, variant)
    torch.cuda.synchronize()
    _same_mod_p(k256, out, kernels.ladder_probe_plain(k256, bases, mag, neg, variant))
