"""The 32-bit field layer (tpu_ecc_torch/csrc/fe32.cuh, point32.cuh) and the
per-lane bodies of the nine kernels that run on it, `padd_chain`,
`segscan`, `ladder`, `genmul`, `bucket_reduce`, `horner`, `pow`, `fixup`
and the probe `ladder_probe`, built with g++ into one host harness per
curve (tests/fe32_harness.py; secp256k1: a = 0, solinas fold, GLV beta;
P-256: a = -3, Montgomery CIOS with the domain maps to and from the
13-bit plan's R;
each curve's scalar field, Montgomery with N0 != 1, as the traits
Scalar32; the pow body also on bign256's base field and sm2's scalar
field).

Inputs are made from a numpy seed (and the host oracle's points). Tolerance:
exact. The field operations and both boundary converters equal Python ints;
the add, the mixed add and the doubling equal, coordinate by coordinate mod
p, tpu_ecc.ops.points' formulas (one jitted program per curve and formula),
the port's plain ones and the host oracle; the chain body equals
`padd_chain_plain`, the segscan body `segscan_plain` mod p at the run-end
rows that the kernel writes, the ladder body `ladder_plain` (its tables in a
buffer shared by blocks of lanes, as the kernel's shared memory) and the
genmul body (the comb converted by its prologue) `genmul_plain`, the
ladder probe's five variants `ladder_probe_plain` (the table shared as
the ladder's), the
bucket_reduce and fixup steps (run as their launches run them)
`bucket_reduce_plain` and `fixup_plain`, the horner body `horner_plain` and
the pow body `fpow_plain` and Python's pow, on both fields. Every value the
harness returns is canonical.

Budget: 100 s for the file at one process (87 s with the probe's ten
cases: two g++ builds at -O0 of about 2 s each, and six small XLA:CPU
programs, which take most of it).
"""

import functools
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ecc.curves.specs import get_curve as j_curve
from tpu_ecc.ops import fe as JF
from tpu_ecc.ops import points as JP
from tpu_ecc_torch.curves.specs import get_curve, list_curves
from tpu_ecc_torch.ops import fe as F
from tpu_ecc_torch.ops import kernels
from tpu_ecc_torch.ops import kfe
from tpu_ecc_torch.ops import points as P
from tpu_ecc_torch.ops import scalarmul as SM
from tpu_ecc_torch.utils import ec_host as H
from tpu_ecc_torch.utils.bigint import ints_to_limbs_np

from fe32_harness import (_affine_limbs, _affine_of, _affine_pairs, _canonical, _domain,
                          _from_words, _limb_ints, _mod_p, _steady_limbs,
                          _steady_top, _to_words, check_bucket_body, check_fixup_body,
                          check_horner_body, check_segscan_body, compile_harness, runner)

CURVES = ("secp256k1", "p256")
B = 16



@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """harness(curve name)(mode, lanes, *args, arrays=[...]) -> uint32 words."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    built = {}

    def get(cname):
        if cname not in built:
            exe, proc = compile_harness(cname, tmp_path_factory.mktemp(f"fe32-{cname}"))
            out, _ = proc.communicate()
            assert proc.returncode == 0, out.decode()
            built[cname] = runner(exe)
        return built[cname]

    return get


# ---------------------------------------------------------------------------
# the field operations and the boundary converters, against Python ints
# ---------------------------------------------------------------------------

def _canonical_inputs(p, rng, count=B):
    return [0, p - 1, 1, p - 2] + [int.from_bytes(rng.bytes(40), "big") % p
                                   for _ in range(count - 4)]


@pytest.mark.parametrize("cname", CURVES)
@pytest.mark.parametrize("op", ["add", "sub", "neg", "mul", "sqr", "mul_b", "mul_small",
                                "mul_beta"])
def test_field_op_equals_ints(harness, cname, op):
    curve = get_curve(cname)
    p, N = curve.p, kfe.fe32_words(curve.field)
    r32, _ = _domain(curve)
    rng = np.random.default_rng(1)
    a = _canonical_inputs(p, rng)
    b = _canonical_inputs(p, rng)[::-1]
    b_plain = (3 * curve.b if curve.strategy == "a0" else curve.b) % p
    beta = curve.glv["beta"] if curve.glv else 0     # no endomorphism: beta is 0
    inv = pow(r32, -1, p)
    want = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y, "neg": lambda x, y: -x,
            "mul": lambda x, y: x * y * inv, "sqr": lambda x, y: x * x * inv,
            "mul_b": lambda x, y: b_plain * x, "mul_small": lambda x, y: 21 * x,
            "mul_beta": lambda x, y: beta * x}[op]
    arrays = [_to_words(a, N)] + ([_to_words(b, N)] if op in ("add", "sub", "mul") else [])
    args = (21,) if op == "mul_small" else ()
    got = _from_words(harness(cname)(op, B, *args, arrays=arrays).reshape(B, N))
    assert got == [want(x, y) % p for x, y in zip(a, b)]


@pytest.mark.parametrize("cname", CURVES)
def test_load_converter_equals_ints(harness, cname):
    """13-bit steady limbs -> canonical words in the layer's domain:
    v mod p (solinas), v R13^-1 R32 mod p (Montgomery), at 0, p - 1, p,
    the top of the steady range and random steady values."""
    curve = get_curve(cname)
    f = curve.field
    r32, r13 = _domain(curve)
    rng = np.random.default_rng(2)
    top = _steady_top(f)
    vals = [0, f.p - 1, f.p, top, top - f.p] + [
        int.from_bytes(rng.bytes(40), "big") % (top + 1) for _ in range(B - 5)]
    limbs = ints_to_limbs_np(vals, f.n_limbs, f.limb_bits).T
    assert int(limbs.max()) <= f.mask
    got = _from_words(harness(cname)("load", B, arrays=[limbs]).reshape(B, kfe.fe32_words(f)))
    assert got == [v * pow(r13, -1, f.p) * r32 % f.p for v in vals]


@pytest.mark.parametrize("cname", CURVES)
def test_store_converter_equals_ints(harness, cname):
    """Canonical words -> canonical 13-bit limbs of x R32^-1 R13 mod p
    (Montgomery) or x (solinas)."""
    curve = get_curve(cname)
    f = curve.field
    r32, r13 = _domain(curve)
    vals = _canonical_inputs(f.p, np.random.default_rng(3))
    out = harness(cname)("store", B, arrays=[_to_words(vals, kfe.fe32_words(f))])
    out = out.reshape(B, f.n_limbs)
    _canonical(curve, out, 1)
    assert list(_limb_ints(out, f.limb_bits, 1)) == [
        v * pow(r32, -1, f.p) * r13 % f.p for v in vals]


# ---------------------------------------------------------------------------
# the point add and the chain body
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_padd(cname):
    jc = j_curve(cname)
    return jax.jit(lambda a, b: JP.point_limbs(JP.padd(JP.point_from_limbs(jc, a),
                                                       JP.point_from_limbs(jc, b))))


@pytest.mark.parametrize("cname", CURVES)
def test_point_add_equals_reference(harness, cname):
    """One add through the chain body (repeat 1): O + O, P + O, O + P,
    P + P, P + (-P) and random pairs, each coordinate equal mod p to
    tpu_ecc's add and to kernels.padd_plain, and canonical."""
    curve = get_curve(cname)
    rng = np.random.default_rng(5)
    a_aff, b_aff = _affine_pairs(curve)
    a, b = _steady_limbs(curve, a_aff, rng), _steady_limbs(curve, b_aff, rng)
    got = harness(cname)("chain", B, 1, arrays=[a, b]).reshape(a.shape)
    _canonical(curve, got, 1)
    ref = np.asarray(_jax_padd(cname)(jnp.asarray(a), jnp.asarray(b)))
    plain = kernels.padd_plain(curve, torch.from_numpy(a.astype(np.int64)),
                               torch.from_numpy(b.astype(np.int64))).numpy()
    mine = _mod_p(curve, got, 1)
    assert (mine == _mod_p(curve, ref, 1)).all()
    assert (mine == _mod_p(curve, plain, 1)).all()
    x, y, inf = P.to_affine(P.point_from_limbs(curve, torch.from_numpy(got.astype(np.int64))))
    assert [None if i else (xv, yv) for xv, yv, i in
            zip(F.fe_to_ints(x), F.fe_to_ints(y), inf.tolist())] == \
        [H.aff_add(curve, u, v) for u, v in zip(a_aff, b_aff)]


@pytest.mark.parametrize("cname", CURVES)
def test_chain_body_equals_plain(harness, cname):
    """a + 5 b through the chain body against padd_chain_plain, mod p."""
    curve = get_curve(cname)
    rng = np.random.default_rng(6)
    a_aff, b_aff = _affine_pairs(curve)
    a, b = _steady_limbs(curve, a_aff, rng), _steady_limbs(curve, b_aff, rng)
    got = harness(cname)("chain", B, 5, arrays=[a, b]).reshape(a.shape)
    _canonical(curve, got, 1)
    want = kernels.padd_chain_plain(curve, torch.from_numpy(a.astype(np.int64)),
                                    torch.from_numpy(b.astype(np.int64)), 5).numpy()
    assert (_mod_p(curve, got, 1) == _mod_p(curve, want, 1)).all()


# ---------------------------------------------------------------------------
# the doubling and the mixed add
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_point_op(cname, op):
    jc = j_curve(cname)
    f = jc.field
    if op == "double":
        return jax.jit(lambda a: JP.point_limbs(JP.pdouble(JP.point_from_limbs(jc, a))))
    return jax.jit(lambda a, xy: JP.point_limbs(JP.padd_mixed(
        JP.point_from_limbs(jc, a), JF.fe_steady(f, xy[0]), JF.fe_steady(f, xy[1]))))


@pytest.mark.parametrize("cname", CURVES)
def test_point_double_equals_reference(harness, cname):
    """One doubling (RCB Algorithm 9 or 6) on O and random points, each
    coordinate equal mod p to tpu_ecc's pdouble and to kernels.pdouble_plain,
    canonical, and 2P by the host oracle. Neither curve has a point of
    order 2 (both have prime order), so none is among the inputs."""
    curve = get_curve(cname)
    rng = np.random.default_rng(7)
    pts, _ = _affine_pairs(curve)
    a = _steady_limbs(curve, pts, rng)
    got = harness(cname)("double", B, arrays=[a]).reshape(a.shape)
    _canonical(curve, got, 1)
    ref = np.asarray(_jax_point_op(cname, "double")(jnp.asarray(a)))
    plain = kernels.pdouble_plain(curve, torch.from_numpy(a.astype(np.int64))).numpy()
    mine = _mod_p(curve, got, 1)
    assert (mine == _mod_p(curve, ref, 1)).all()
    assert (mine == _mod_p(curve, plain, 1)).all()
    assert _affine_of(curve, got) == [H.aff_add(curve, u, u) for u in pts]


@pytest.mark.parametrize("cname", CURVES)
def test_mixed_add_equals_reference(harness, cname):
    """One mixed add (RCB Algorithm 8 or 5) of a projective point and an
    affine one: O + G, P + P, P + (-P) and random pairs, each coordinate
    equal mod p to tpu_ecc's padd_mixed and to the port's, canonical, and
    the sum by the host oracle."""
    curve = get_curve(cname)
    f = curve.field
    rng = np.random.default_rng(8)
    a_aff, b_aff = _affine_pairs(curve)
    G = H.aff_generator(curve)
    b_aff = [G if q is None else q for q in b_aff]          # Q is never O
    a, xy = _steady_limbs(curve, a_aff, rng), _affine_limbs(curve, b_aff, rng)
    got = harness(cname)("mixed", B, arrays=[a, xy]).reshape(a.shape)
    _canonical(curve, got, 1)
    ref = np.asarray(_jax_point_op(cname, "mixed")(jnp.asarray(a), jnp.asarray(xy)))
    xy64 = torch.from_numpy(xy.astype(np.int64))
    plain = P.point_limbs(P.padd_mixed(P.point_from_limbs(curve, torch.from_numpy(
        a.astype(np.int64))), F.fe_steady(f, xy64[0]), F.fe_steady(f, xy64[1]))).numpy()
    mine = _mod_p(curve, got, 1)
    assert (mine == _mod_p(curve, ref, 1)).all()
    assert (mine == _mod_p(curve, plain, 1)).all()
    want = [H.aff_add(curve, u, v) for u, v in zip(a_aff, b_aff)]
    assert want[0] == G and b_aff[3] == a_aff[3] and want[4] is None   # O + G, P + P, P - P
    assert _affine_of(curve, got) == want


# ---------------------------------------------------------------------------
# the ladder and genmul bodies
# ---------------------------------------------------------------------------

LADDER_CASES = [("secp256k1", 2, True), ("secp256k1", 1, False), ("p256", 2, False)]


@pytest.mark.parametrize("cname,T,glv", LADDER_CASES, ids=["k256-glv-T2", "k256-T1", "p256-T2"])
def test_ladder_body_equals_plain(harness, cname, T, glv):
    """ladder_lane on scalarmul.ladder_inputs' rows (6 windows: GLV's last
    6 of 34, else 24-bit scalars), in blocks of 4 lanes sharing a table
    buffer as the kernel's shared memory, against kernels.ladder_plain mod
    p. Lane 0's scalars are 0 (an all-zero digit column), lane 1's 1; T = 1
    has H == 1, whose first window seeds the sum."""
    curve = get_curve(cname)
    rng = np.random.default_rng(9 + T)
    G = H.aff_generator(curve)
    bases, ks = [], []
    for t in range(T):
        pts = [H.aff_mul(curve, int(k), G) for k in rng.integers(1, 2**62, B)]
        bases.append(P.from_affine_ints(curve, [q[0] for q in pts], [q[1] for q in pts], "cpu"))
        top = curve.n if glv else 1 << 24
        ks.append(SM.pack_scalars(curve, [0, 1] + [int.from_bytes(rng.bytes(32), "big") % top
                                                   for _ in range(B - 2)], "cpu"))
    b, mag, neg = SM.ladder_inputs(list(zip(bases, ks)), glv=glv,
                                   scalar_bits=None if glv else 24)
    mag, neg = mag[-6:], neg[-6:]
    assert (mag[:, :, 0] == 0).all()
    nw, Hn = mag.shape[0], mag.shape[1]
    got = harness(cname)("ladder", B, T, Hn, nw, int(glv), 4,
                         arrays=[b.numpy(), mag.numpy(), neg.to(torch.int64).numpy()])
    got = got.reshape(3, curve.field.n_limbs, B)
    _canonical(curve, got, 1)
    want = kernels.ladder_plain(curve, b, mag, neg, glv).numpy()
    assert (_mod_p(curve, got, 1) == _mod_p(curve, want, 1)).all()
    assert _affine_of(curve, got)[0] is None


@pytest.mark.parametrize("cname", CURVES)
@pytest.mark.parametrize("variant", kernels.PROBE_VARIANTS)
def test_ladder_probe_body_equals_plain(harness, cname, variant):
    """ladder_probe_lane, each of the five variants, on random steady
    representatives of host-oracle points (O among them) and random digits
    (3 windows), in blocks of 4 lanes sharing a table buffer as the
    kernel's shared memory, against kernels.ladder_probe_plain mod p."""
    curve = get_curve(cname)
    rng = np.random.default_rng(13)
    pts, _ = _affine_pairs(curve)
    bases = _steady_limbs(curve, pts, rng)
    nw = 3
    mag = rng.integers(0, kernels.TBL, (nw, 2, B))
    neg = rng.integers(0, 2, (nw, 2, B))
    got = harness(cname)("probe", B, nw, kernels.PROBE_VARIANTS.index(variant), 4,
                         arrays=[bases, mag, neg]).reshape(bases.shape)
    _canonical(curve, got, 1)
    want = kernels.ladder_probe_plain(curve, torch.from_numpy(bases.astype(np.int64)),
                                      torch.from_numpy(mag), torch.from_numpy(neg),
                                      variant).numpy()
    assert (_mod_p(curve, got, 1) == _mod_p(curve, want, 1)).all()


@pytest.mark.parametrize("cname", CURVES)
def test_genmul_body_equals_plain(harness, cname):
    """genmul_table (the prologue, by 5 threads) and genmul_lane on
    scalarmul._gen_table's rows and signed_digits' 65 windows, k = 0, 1,
    n - 1 and random, against kernels.genmul_plain mod p, and k G by the
    host oracle."""
    curve = get_curve(cname)
    rng = np.random.default_rng(10)
    ks = [0, 1, curve.n - 1] + [int.from_bytes(rng.bytes(32), "big") % curve.n
                                for _ in range(B - 3)]
    mag, neg = SM.signed_digits(curve, SM.pack_scalars(curve, ks, "cpu"))
    mag, neg = mag.flip(0), neg.flip(0)                      # LSB window first
    tbl = SM._gen_table(curve, torch.device("cpu"))
    nw = mag.shape[0]
    got = harness(cname)("genmul", B, nw, 5,
                         arrays=[tbl.numpy(), mag.numpy(), neg.to(torch.int64).numpy()])
    got = got.reshape(3, curve.field.n_limbs, B)
    _canonical(curve, got, 1)
    want = kernels.genmul_plain(curve, tbl, mag, neg).numpy()
    assert (_mod_p(curve, got, 1) == _mod_p(curve, want, 1)).all()
    G = H.aff_generator(curve)
    assert _affine_of(curve, got) == [H.aff_mul(curve, k, G) for k in ks]


# ---------------------------------------------------------------------------
# the segscan body
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_segscan_body_equals_plain(harness, signed):
    """secp256k1 (segscan's build), N = 512, L = 32, w = 8, two windows side
    by side: the harness's rows at the run ends, last_key, tail and lead
    against segscan_plain (mod p); the rows that end no run stay unwritten;
    bucket_lookup on either's rows and fixup gives the same buckets mod p."""
    check_segscan_body(harness("secp256k1"), get_curve("secp256k1"), signed)


# ---------------------------------------------------------------------------
# the bucket_reduce and horner bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drop0", [False, True], ids=["signed", "drop0"])
@pytest.mark.parametrize("cname", CURVES)
def test_bucket_body_equals_plain(harness, cname, drop0):
    """bucket_suffix_lane and bucket_pair_lane step by step as the launch
    runs them, on 2 windows of 64 buckets, against bucket_reduce_plain
    coordinate by coordinate mod p, and sum_b (b + 1) S_b (b S_b with
    drop0) of each window by the host oracle. Among the buckets: O (alone
    and at a window's ends), P and -P side by side, and two equal points
    side by side, so that the first step adds a point to itself."""
    check_bucket_body(harness(cname), get_curve(cname), drop0)


@pytest.mark.parametrize("cname", CURVES)
def test_horner_body_equals_plain(harness, cname):
    """horner_lane at w = 4 over 5 window sums (one of them O), MSB first,
    against horner_plain mod p, and sum_j 2^(4 (4 - j)) S_j by the host
    oracle."""
    check_horner_body(harness(cname), get_curve(cname))


# ---------------------------------------------------------------------------
# the pow and fixup bodies
# ---------------------------------------------------------------------------

# both fields of both curves, and a field of each other curve that pow now
# builds for: bign256's base field (solinas, F = 189 in one word) and sm2's
# scalar field
POW_CASES = [(c, f) for c in CURVES for f in ("fp", "fn")] + [("bign256", "fp"), ("sm2", "fn")]


@pytest.mark.parametrize("cname,field", POW_CASES, ids=[f"{c}-{f}" for c, f in POW_CASES])
def test_pow_body_equals_plain(harness, cname, field):
    """pow_lane on 64 lanes (0, 1, p - 1 and random, each a random steady
    representative of its encoding), in blocks of 4 lanes sharing a table
    buffer as the kernel's shared memory, with e = p - 2 and, on the base
    field (p = 3 mod 4 on each curve here), e = (p + 1) / 4: against
    kernels.fpow_plain mod p and Python's pow. The scalar field runs on
    Scalar32 (Montgomery, N0 != 1)."""
    curve = get_curve(cname)
    spec = curve.field if field == "fp" else curve.scalar
    p, lanes = spec.p, 64
    rng = np.random.default_rng(13)
    xs = [0, 1, p - 1] + [int.from_bytes(rng.bytes(40), "big") % p for _ in range(lanes - 3)]
    top = _steady_top(spec)
    enc = [spec.encode_int(v) for v in xs]
    reps = [v + int(rng.integers(0, (top - v) // p + 1)) * p for v in enc]
    x = ints_to_limbs_np(reps, spec.n_limbs, spec.limb_bits)        # [n, lanes]
    r13 = spec.W if spec.kind == "mont" else 1
    exps = [p - 2] + ([(p + 1) // 4] if field == "fp" else [])
    assert p % 4 == 3 or field == "fn"
    for e in exps:
        digits = np.array(kernels.exponent_digits(e), np.uint32)
        got = harness(cname)("pow", lanes, int(field == "fn"), len(digits), 4,
                             arrays=[x, digits]).reshape(spec.n_limbs, lanes)
        assert int(got.max()) <= spec.mask
        vals = _limb_ints(got, spec.limb_bits, 0)
        assert (vals < p).all()
        want = kernels.fpow_plain(spec, torch.from_numpy(x.astype(np.int64)), e).numpy()
        assert list(vals) == list(_limb_ints(want, spec.limb_bits, 0) % p)
        assert [v * pow(r13, -1, p) % p for v in vals] == [pow(v, e, p) for v in xs]


@pytest.mark.parametrize("cname", CURVES)
def test_fixup_body_equals_plain(harness, cname):
    """fixup_step_lane (6 steps) and fixup_final_lane as the launch runs
    them, on 2 windows of 64 lanes, against kernels.fixup_plain coordinate
    by coordinate mod p, and the fixed lanes by the host oracle; then
    windows of one lane (L = 1, the last launch alone)."""
    check_fixup_body(harness(cname), get_curve(cname))


# ---------------------------------------------------------------------------
# the build and the bound
# ---------------------------------------------------------------------------

def test_build_key_follows_the_included_headers(tmp_path, monkeypatch):
    """The kernels on the layer include fe32.cuh and point32.cuh (the
    probes' chains, built per bare field, fe32.cuh and chain32.cuh), none
    the 13-bit generated code (a field kernel's header is Field32's
    constants), and a change to an included header changes the library's
    build key."""
    for name in kernels.FE32_KERNELS:
        want = (["chain32.cuh", "fe32.cuh"] if name in kernels.FIELD_KERNELS
                else ["fe32.cuh", "point32.cuh"])
        assert kernels.includes(kernels.KERNELS[name][0]) == want
    assert set(kernels.KERNELS) - set(kernels.FE32_KERNELS) == {"dma_gather"}
    for name in kernels.FIELD_KERNELS:
        header = kernels._target(name, get_curve("p256").field)[2]
        assert "struct Field32" in header and "KFE_FP_N" not in header
    src = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, src)
    monkeypatch.setattr(kernels, "CSRC", str(src))
    curve = get_curve("secp256k1")
    before = kernels._target("segscan", curve)[0]
    with open(src / "fe32.cuh", "a") as fh:
        fh.write("// changed\n")
    assert kernels._target("segscan", curve)[0] != before
    assert "Curve32" in kernels._target("segscan", curve)[2]


@pytest.mark.parametrize("cname", ["secp256k1", "p521", "bp256t1"])
def test_padd_is_the_chain_library_at_one_add(cname):
    """`padd` launches padd_chain's library (one build a curve serves
    both), and its launches count as padd's."""
    curve = get_curve(cname)
    assert kernels.KERNELS["padd"][:2] == kernels.KERNELS["padd_chain"][:2]
    assert kernels._target("padd", curve) == kernels._target("padd_chain", curve)
    assert "padd" in kernels.launches and "padd_chain" in kernels.launches


@pytest.mark.parametrize("cname", CURVES)
def test_fe32_counts_and_constants(cname):
    """The 32-bit design counts fewer instructions than the 13-bit one
    (kernels.work's two designs) for each kernel on the layer; the header's
    constants are the curve's, beta among them where the curve has an
    endomorphism, and the domain maps compose to the identity; Scalar32's
    (the scalar field, Montgomery) N0, one and maps against Python ints,
    and its field count has CIOS's N0 multiply; a squaring is counted at
    the N(N+1)/2 products it needs, the reduction as a multiply's; the
    Brainpool r1 curves' generic formulas multiply by 3b and a in the
    domain, and count more products than their t1 twins' a = -3 ones."""
    curve = get_curve(cname)
    k = kfe.fe32_constants(curve)
    p = curve.p
    r32, r13 = _domain(curve)
    assert sum(w << (32 * i) for i, w in enumerate(k["p"])) == p
    beta = sum(w << (32 * i) for i, w in enumerate(k["beta"]))
    assert k["HAS_BETA"] == bool(curve.glv)
    assert beta == (curve.glv["beta"] * r32 % p if curve.glv else 0)
    assert f"HAS_BETA = {str(bool(curve.glv)).lower()}" in kfe.fe32_header(curve)
    if k["MONT"]:
        to32 = sum(w << (32 * i) for i, w in enumerate(k["to32"]))
        to13 = sum(w << (32 * i) for i, w in enumerate(k["to13"]))
        inv = pow(r32, -1, p)
        assert to32 * inv * to13 * inv % p == 1     # store(load(v)) = v
        assert k["N0"] * p % (1 << 32) == (1 << 32) - 1
    n = curve.scalar
    s = kfe.fe32_field_constants(n)
    assert "struct Scalar32" in kfe.fe32_header(curve) and s["MONT"]
    assert sum(w << (32 * i) for i, w in enumerate(s["p"])) == n.p
    assert s["N0"] * n.p % (1 << 32) == (1 << 32) - 1 and s["N0"] != 1
    N = kfe.fe32_words(curve.field)
    R = 1 << (32 * N)                                       # R32; R13 = n.W
    to32 = sum(w << (32 * i) for i, w in enumerate(s["to32"]))
    to13 = sum(w << (32 * i) for i, w in enumerate(s["to13"]))
    assert to32 * pow(R, -1, n.p) % n.p == R * pow(n.W, -1, n.p) % n.p   # v R13 -> v R32
    assert to13 == n.W % n.p                                # x R32 -> x R13
    assert sum(w << (32 * i) for i, w in enumerate(s["one"])) == R % n.p
    shapes = {"padd": {}, "pdouble": {}, "padd_chain": dict(repeat=16),
              "ladder": dict(T=2, nw=34, glv=bool(curve.glv)),
              "genmul": dict(nw=65),
              "segscan": dict(C=64, adds=2000, ends=500, signed=True),
              "bucket_reduce": dict(groups=8), "horner": dict(nw=19, w=14),
              "pow": dict(field=1, e=n.p - 2), "fixup": dict(adds=300),
              "ladder_probe": dict(nw=34, variant="negate")}
    assert set(shapes) == set(kernels.FE32_KERNELS) - set(kernels.FIELD_KERNELS)
    for name, kw in shapes.items():
        ops = {d: kernels.work(name, curve, 64, design=d, **kw)[0]
               for d in kernels.designs(name, curve)}
        assert 0 < sum(ops["fe32"].values()) < sum(ops["kfe"].values()), name
    for spec in (curve.field, curve.scalar):     # the probes' chains, on each field
        for name in kernels.FIELD_KERNELS:
            if name == "mxu_chain" and spec.kind != "mont":
                continue
            ops = {d: kernels.work(name, spec, 64, design=d)[0]
                   for d in kernels.designs(name, spec)}
            assert 0 < sum(ops["fe32"].values()) < sum(ops["kfe"].values()), (name, spec)
    c = kfe.fe32_counts(curve)
    assert sum(c["pdouble"].values()) < sum(c["padd_mixed"].values()) < sum(c["padd"].values())
    assert c["mul_beta"] == c["mul"]
    cn = kfe.fe32_counts(n)
    assert set(cn) == {"add", "sub", "neg", "mul", "sqr", "load", "store"}
    assert cn["mul"]["imad"] == cn["sqr"]["imad"] == N   # CIOS's m = t0 N0, once a word
    for counts in (c, cn):                 # a squaring's N(N+1)/2 products against N^2
        assert counts["sqr"]["wide"] == counts["mul"]["wide"] - N * (N - 1) // 2
    for r1, t1 in (("bp256r1", "bp256t1"), ("bp384r1", "bp384t1")):
        gen = get_curve(r1)                 # generic a: 3b and a, in the domain
        kg = kfe.fe32_constants(gen)
        R = 1 << (32 * kg["N"])
        assert kg["AGEN"] and not kg["A0"] and kg["BSMALL"] == 0 and kg["MONT"]
        assert sum(w << (32 * i) for i, w in enumerate(kg["bmul"])) == 3 * gen.b * R % gen.p
        assert sum(w << (32 * i) for i, w in enumerate(kg["amul"])) == gen.a * R % gen.p
        cg, ct = kfe.fe32_counts(gen), kfe.fe32_counts(get_curve(t1))
        assert cg["mul_a"] == cg["mul"] == ct["mul"]    # one field: the same multiply
        for fn in kfe.FE32_POINT_FNS:       # RCB 1-3 multiply more than 4-6
            assert cg[fn]["wide"] > ct[fn]["wide"]
        # the 13-bit generator has no generic formulas: its design drops out
        # of a point kernel's bound, not of pow's
        assert not kfe.has_formulas(gen) and kfe.has_formulas(get_curve(t1))
        assert "padd" not in kernels.op_counts(gen) and "fp_mul" in kernels.op_counts(gen)
        assert kernels.designs("ladder", gen) == ("fe32",)
        assert kernels.designs("pow", gen) == kernels.designs("ladder", get_curve(t1))


def test_padd_count_follows_point32(tmp_path, monkeypatch):
    """The point formulas' field operations in the fe32 count are read from
    point32.cuh: RCB's 12 multiplies and 2 by b in both adds, 11 and 2 in
    both mixed adds, 8 and 1 (a = 0) or 11 and 2 (a = -3) in the
    doublings; the generic a's add 12, 3 by a and 2 by 3b, its mixed add
    and doubling 11, 3 and 2; and an edit of the header moves the count."""
    ops = kfe.fe32_point_ops
    assert ops("padd", "a0") == {"mul": 12, "mul_a": 0, "mul_b": 2, "add": 14, "sub": 5}
    assert ops("padd", "a_minus3") == {"mul": 12, "mul_a": 0, "mul_b": 2, "add": 20, "sub": 9}
    assert ops("padd", "generic") == {"mul": 12, "mul_a": 3, "mul_b": 2, "add": 17, "sub": 6}
    assert ops("padd_mixed", "a0") == {"mul": 11, "mul_a": 0, "mul_b": 2, "add": 10, "sub": 3}
    assert ops("padd_mixed", "a_minus3") == {"mul": 11, "mul_a": 0, "mul_b": 2, "add": 16,
                                             "sub": 7}
    assert ops("padd_mixed", "generic") == {"mul": 11, "mul_a": 3, "mul_b": 2, "add": 13,
                                            "sub": 4}
    assert ops("pdouble", "a0") == {"mul": 8, "mul_a": 0, "mul_b": 1, "add": 8, "sub": 1}
    assert ops("pdouble", "a_minus3") == {"mul": 11, "mul_a": 0, "mul_b": 2, "add": 15, "sub": 6}
    assert ops("pdouble", "generic") == {"mul": 11, "mul_a": 3, "mul_b": 2, "add": 12, "sub": 3}
    text = pathlib.Path(kfe._POINT32).read_text()
    edited = tmp_path / "point32.cuh"
    edited.write_text(text.replace("  X3 = sub<C>(t2, X3);\n",
                                   "  X3 = sub<C>(t2, mul<C>(X3, X3));\n", 1))
    monkeypatch.setattr(kfe, "_POINT32", str(edited))
    assert ops("padd", "a0") == {"mul": 13, "mul_a": 0, "mul_b": 2, "add": 14, "sub": 5}
    assert ops("padd", "a_minus3")["mul"] == ops("padd", "generic")["mul"] == 12
    assert ops("padd_mixed", "a0")["mul"] == 11


# the curves whose two fields the layer takes, each at the curve's own word
# count: every registered curve
POW_CURVES = set(list_curves())


@pytest.mark.parametrize("cname", list_curves())
def test_pow_builds_for_the_fields_on_the_layer(cname):
    """`pow`'s header needs only the curve's two fields: it builds for every
    curve, whatever its formulas (the Brainpool r1 curves' generic a
    among them), and `fpow` gets as far as the CUDA check (a meta
    tensor)."""
    curve = get_curve(cname)
    fits = not (kfe.fe32_fits(curve.field) or kfe.fe32_fits(curve.scalar))
    assert fits == (cname in POW_CURVES)
    x = torch.empty((curve.field.n_limbs, 4), dtype=torch.int64, device="meta")
    header = kernels._header("pow", curve)
    assert "struct Curve32" in header and "struct Scalar32" in header
    assert "A0" not in header and "bmul" not in header
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fpow(curve.field, x, curve.p - 2)


@pytest.mark.parametrize("const,src,macro", [
    ("POW_LANES", "pow.cu", "POW_THREADS"), ("FIXUP_LANES", "fixup.cu", "FIXUP_THREADS"),
    ("GENMUL_LANES", "genmul.cu", "THREADS"), ("LADDER_LANES", "ladder.cu", "MAX_LANES"),
    ("PROBE_LANES", "ladder_probe.cu", "PROBE_THREADS"),
    ("GATHER_WARPS", "dma_gather.cu", "GATHER_WARPS"),
    ("GATHER_ROWS", "dma_gather.cu", "GATHER_ROWS"),
    ("FMUL_LANES", "fmul_chain.cu", "FMUL_THREADS"), ("MXU_LANES", "mxu_chain.cu", "MXU_LANES")])
def test_block_sizes_follow_the_sources(const, src, macro):
    """The lanes a block that ops/kernels.py states (for its shared-memory
    sizing and the smoke's warp counts) are the sources' defaults."""
    text = (pathlib.Path(kernels.CSRC) / src).read_text()
    assert f"#define {macro} {getattr(kernels, const)}\n" in text


def test_ladder_lanes_follow_shared_memory():
    """A block of the ladder takes 32 lanes up to T = 8 (the Straus MSM's
    221 KB at secp256k1's N = 8), fewer above, and a T whose one-lane
    tables (864 B a base) exceed a block's 227 KB raises."""
    k256 = get_curve("secp256k1")
    assert kernels.ladder_lanes(1, k256) == kernels.ladder_lanes(8, k256) == 32
    assert kernels.ladder_lanes(9, k256) == kernels.SMEM_BLOCK // (9 * 864) == 29
    assert kernels.ladder_lanes(269, k256) == 1
    with pytest.raises(ValueError):
        kernels.ladder_lanes(270, k256)
