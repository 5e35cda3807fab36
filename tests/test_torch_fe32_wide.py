"""The 32-bit field layer (tpu_ecc_torch/csrc/fe32.cuh, point32.cuh) at each
curve's own word count: P-192 (N = 6), P-224 (7), SM2 and bign256 (8),
P-384 (12) and P-521 (17, the solinas field with its fold at p's top bit
2^521, the scalar field on the Montgomery load that does not fold through
F), and the Brainpool curves (8 and 12, the Montgomery load mont(lo, to32) +
mont(to32h, h)), the r1 curves on the generic-a formulas (RCB Algorithms
1-3, a and 3b as full multiplies). One g++ build at -O0 of the host
harness (tests/fe32_harness.py) per curve, four at a time.

Inputs are made from a numpy seed (and the host oracle's points). Tolerance:
exact. The field operations on both fields and both boundary converters
equal Python ints, with rows across the whole 13-bit range (Brainpool's top
word near 2^17 and 2^19, P-521's values near 2^533 and 2^540); the add, the
mixed add and the doubling equal, coordinate by coordinate mod p, the
port's plain formulas and the host oracle, and for p384 and p521
tpu_ecc.ops.points' (op by op, in a niced worker process); the pow body equals `fpow_plain` (at a 64-bit exponent) and
Python's pow (at p - 2, and (p + 1) / 4 where p = 3 mod 4) on both fields;
the ladder and genmul bodies equal their twins and the host oracle on
p384, p521 and the two generic-a curves; the port's
plain field layer equals tpu_ecc.ops.fe limb for limb on p192, p224, p384
(both fields), p521 and the two t1 curves.

Budget: 120 s for the file at one process.
"""

import concurrent.futures
import multiprocessing
import os
import shutil

import fe32_wide_reference
import numpy as np
import p256_reference
import pytest
import torch

from fe32_harness import (_affine_limbs, _affine_of, _affine_pairs, _canonical,
                          _from_words, _limb_ints, _mod_p, _steady_limbs, _steady_top,
                          _to_words, compile_harness, runner)
from tpu_ecc_torch import interop
from tpu_ecc_torch.curves.specs import get_curve
from tpu_ecc_torch.ops import fe as F
from tpu_ecc_torch.ops import kernels
from tpu_ecc_torch.ops import kfe
from tpu_ecc_torch.ops import points as P
from tpu_ecc_torch.ops import scalarmul as SM
from tpu_ecc_torch.utils import ec_host as H
from tpu_ecc_torch.utils.bigint import ints_to_limbs_np

CURVES = ("p192", "p224", "p384", "p521", "sm2", "bign256", "bp256t1", "bp384t1",
                "bp256r1", "bp384r1")
GENERIC_CURVES = ("bp256r1", "bp384r1")          # the generic-a formulas
BODY_CURVES = ["p384", "p521", *GENERIC_CURVES]   # the ladder and genmul bodies
B = 16
REFERENCE_FIELDS = [("p192", "field"), ("p224", "field"), ("p384", "field"),
                    ("p384", "scalar"), ("p521", "field"), ("bp256t1", "field"),
                    ("bp384t1", "field")]


def _plain_inputs():
    """The add, doubling and mixed add of p384 and p521 on the inputs of
    test_point_formulas_equal_reference: {case: (curve, a, b)}."""
    cases = {}
    for name in ("p384", "p521"):
        curve = get_curve(name)
        a, b, xy = _formula_inputs(curve)
        one = _steady_limbs(curve, [H.aff_generator(curve)] * B, np.random.default_rng(0))[2:]
        cases[f"{name}.padd"] = (name, a, b)
        cases[f"{name}.pdouble"] = (name, a, a)
        cases[f"{name}.padd_mixed"] = (name, a, np.concatenate([xy, one], 0))
    return cases


def _field_inputs():
    cases = {}
    for name, which in REFERENCE_FIELDS:
        spec = getattr(get_curve(name), which)
        xs, ys = _values(spec, 1), _values(spec, 2)[::-1]
        cases[f"{name}.{which}"] = (name, which, ints_to_limbs_np(xs, spec.n_limbs, spec.limb_bits),
                                    ints_to_limbs_np(ys, spec.n_limbs, spec.limb_bits))
    return cases


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """{curve name: harness runner}, and tpu_ecc's references: the g++
    builds (four at a time) while two niced workers run tpu_ecc's
    programs: the field operations compiled, the formulas op by op."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=2, mp_context=multiprocessing.get_context("spawn"),
        initializer=os.nice, initargs=(10,))
    plain = _plain_inputs()
    fields = _field_inputs()
    refs = {"fields": pool.submit(fe32_wide_reference.field_ops, fields)}
    for name in ("p384", "p521"):
        refs[name] = pool.submit(p256_reference.plain_formulas,
                                 {k: v for k, v in plain.items() if k.startswith(name)},
                                 eager=True)
    runners, todo = {}, list(CURVES)
    while todo:
        batch, todo = todo[:4], todo[4:]
        procs = {c: compile_harness(c, tmp_path_factory.mktemp(f"fe32-{c}")) for c in batch}
        for c, (exe, proc) in procs.items():
            out, _ = proc.communicate()
            assert proc.returncode == 0, out.decode()
            runners[c] = runner(exe)
    yield runners, refs, plain, fields
    pool.shutdown(cancel_futures=True)


def _values(spec, seed, count=B):
    """count canonical values: 0, 1, p - 1, p - 2, then random ones."""
    rng = np.random.default_rng(seed)
    p = spec.p
    return [0, 1, p - 1, p - 2] + [int.from_bytes(rng.bytes(spec.bits // 8 + 8), "big") % p
                                   for _ in range(count - 4)]


def _spec(cname, field):
    c = get_curve(cname)
    return c.field if field == "fp" else c.scalar


def _r32(spec):
    """The layer's Montgomery R (1 for a solinas field)."""
    return 1 << (32 * kfe.fe32_words(spec)) if spec.kind == "mont" else 1


# ---------------------------------------------------------------------------
# the constants, the fits and the headers
# ---------------------------------------------------------------------------

WORDS = {"p192": 6, "p224": 7, "p384": 12, "p521": 17, "sm2": 8, "bign256": 8,
         "bp256t1": 8, "bp384t1": 12, "bp256r1": 8, "bp384r1": 12}


@pytest.mark.parametrize("cname", CURVES)
def test_layer_takes_both_fields_at_the_curves_word_count(cname):
    """Both fields fit at the curve's own N; the constants are the field's
    (p, F, the fold bit for P-521's base field, the Montgomery load where
    reduce_top cannot take a row, with to32h = F to32); the header builds
    the whole Curve32 (the r1 curves' with AGEN, a and 3b in the domain)
    and Scalar32 at N, `pow`'s the base field alone; and a narrower N is
    refused."""
    curve = get_curve(cname)
    N = WORDS[cname]
    for spec in (curve.field, curve.scalar):
        assert kfe.fe32_words(spec) == N
        assert kfe.fe32_fits(spec) == ""
        assert kfe.fe32_fits(spec, N - 1) != ""
        k = kfe.fe32_field_constants(spec)
        W = 1 << (32 * N)
        assert k["N"] == N and sum(w << (32 * i) for i, w in enumerate(k["p"])) == spec.p
        assert k["KB"] == (521 if spec.name == "p521.fp" else 0)
        top = ((1 << (spec.n_limbs * spec.limb_bits)) - 1) >> (32 * N)
        folds = (top + 1) * (W % spec.p) <= W
        assert k["MLOAD"] == (spec.kind == "mont" and (spec.p < W // 2 or not folds))
        if k["MLOAD"]:
            to32 = sum(w << (32 * i) for i, w in enumerate(k["to32"]))
            to32h = sum(w << (32 * i) for i, w in enumerate(k["to32h"]))
            assert to32h == W % spec.p * to32 % spec.p
    assert kfe.fe32_fits(curve.field, N - 1).startswith(curve.field.name)
    header = kfe.fe32_header(curve)
    assert header.count(f"static constexpr int N = {N};") == 2
    assert "BSMALL" in header and kernels._header("ladder", curve) == header
    generic = str(cname in GENERIC_CURVES).lower()
    assert f"static constexpr bool AGEN = {generic};" in header
    assert "AGEN" not in kernels._header("pow", curve)


def test_ladder_lanes_follow_the_word_count():
    """The ladder's lanes a block shrink with the tables' words: P-521's
    T = 8 (the Straus shape, 14688 B a lane) takes 15 lanes, T = 2 takes
    32 (3672 B a lane)."""
    p521, p384 = get_curve("p521"), get_curve("p384")
    assert kernels.ladder_lanes(2, p521) == 32
    assert kernels.ladder_lanes(8, p521) == kernels.SMEM_BLOCK // (8 * 9 * 3 * 17 * 4) == 15
    assert kernels.ladder_lanes(8, p384) == kernels.SMEM_BLOCK // (8 * 9 * 3 * 12 * 4) == 22


# ---------------------------------------------------------------------------
# the field operations and the boundary converters, against Python ints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["fp", "fn"])
@pytest.mark.parametrize("cname", CURVES)
def test_field_ops_equal_ints(built, cname, field):
    """add, sub, neg, mul, sqr on canonical words, and mul_small by 21
    where reduce_top takes it and, on the base field, mul_b (by b for a =
    -3, by 3b for the generic a) and mul_a (by a): against Python ints
    (the Montgomery product carries R32^-1)."""
    run = built[0][cname]
    spec = _spec(cname, field)
    p, N = spec.p, kfe.fe32_words(spec)
    inv = pow(_r32(spec), -1, p)
    a, b = _values(spec, 1), _values(spec, 2)[::-1]
    pre = "" if field == "fp" else "s_"
    want = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y, "neg": lambda x, y: -x,
            "mul": lambda x, y: x * y * inv, "sqr": lambda x, y: x * x * inv}
    if kfe.fe32_small_fits(spec, 21):
        want["mul_small"] = lambda x, y: 21 * x
    curve = get_curve(cname)
    if field == "fp":
        generic = cname in GENERIC_CURVES             # else a = -3
        b_plain = (3 * curve.b if generic else curve.b) % p
        want["mul_b"] = lambda x, y: b_plain * x
        want["mul_a"] = lambda x, y: curve.a * x
    assert (cname == "p521" and field == "fp") <= ("mul_small" in want)
    for op, fn in want.items():
        arrays = [_to_words(a, N)] + ([_to_words(b, N)] if op in ("add", "sub", "mul") else [])
        args = (21,) if op == "mul_small" else ()
        got = _from_words(run(pre + op, B, *args, arrays=arrays).reshape(B, N))
        assert got == [fn(x, y) % p for x, y in zip(a, b)], op


def _rows(spec, seed):
    """13-bit rows [NL, B] across the whole range: 0, p - 1, p, the top of
    the steady range, every limb at its mask (the largest row: 2^533 - 1
    for P-521's base field, 2^540 - 1 for its scalar field, a top word of
    2^17 - 1 or 2^19 - 1 on Brainpool), random steady values and rows of
    random limbs."""
    rng = np.random.default_rng(seed)
    NL, LB = spec.n_limbs, spec.limb_bits
    full, top = (1 << (NL * LB)) - 1, _steady_top(spec)
    vals = [0, spec.p - 1, spec.p, top, full, full - spec.p, full >> 1] + [
        int.from_bytes(rng.bytes(NL * 2), "big") % (top + 1) for _ in range(5)]
    limbs = ints_to_limbs_np(vals, NL, LB)
    rand = rng.integers(0, 1 << LB, (NL, B - len(vals))).astype(np.uint32)
    return np.concatenate([limbs, rand], 1)


@pytest.mark.parametrize("field", ["fp", "fn"])
@pytest.mark.parametrize("cname", CURVES)
def test_converters_equal_ints(built, cname, field):
    """Load: any 13-bit row v -> canonical v R13^-1 R32 mod p (Montgomery)
    or v mod p; store: canonical words -> canonical limbs of x R32^-1 R13."""
    run = built[0][cname]
    spec = _spec(cname, field)
    p, N = spec.p, kfe.fe32_words(spec)
    r32, r13 = _r32(spec), (spec.W if spec.kind == "mont" else 1)
    pre = "" if field == "fp" else "s_"
    rows = _rows(spec, 3)
    vals = list(_limb_ints(rows, spec.limb_bits, 0))
    got = _from_words(run(pre + "load", B, arrays=[np.ascontiguousarray(rows.T)]).reshape(B, N))
    assert got == [v * pow(r13, -1, p) * r32 % p for v in vals]
    xs = _values(spec, 4)
    out = run(pre + "store", B, arrays=[_to_words(xs, N)]).reshape(B, spec.n_limbs)
    assert int(out.max()) < 1 << spec.limb_bits
    assert list(_limb_ints(out, spec.limb_bits, 1)) == [x * pow(r32, -1, p) * r13 % p for x in xs]


# ---------------------------------------------------------------------------
# the point formulas
# ---------------------------------------------------------------------------

def _formula_inputs(curve):
    """(a, b [3, n, B] steady projective limbs, xy [2, n, B] an affine
    operand never O) from the host oracle's points."""
    rng = np.random.default_rng(5)
    a_aff, b_aff = _affine_pairs(curve, B)
    G = H.aff_generator(curve)
    return (_steady_limbs(curve, a_aff, rng), _steady_limbs(curve, b_aff, rng),
            _affine_limbs(curve, [G if q is None else q for q in b_aff], rng))


@pytest.mark.parametrize("op", ["padd", "pdouble", "padd_mixed"])
@pytest.mark.parametrize("cname", CURVES)
def test_point_formulas_equal_plain_and_oracle(built, cname, op):
    """One add (the chain body at repeat 1), doubling or mixed add: O + O,
    P + O, O + P, P + P, P + (-P) and random pairs, canonical, each
    coordinate equal mod p to the port's plain formula, and the sum by the
    host oracle."""
    run = built[0][cname]
    curve = get_curve(cname)
    f = curve.field
    a, b, xy = _formula_inputs(curve)
    a_aff, b_aff = _affine_pairs(curve, B)
    a64 = torch.from_numpy(a.astype(np.int64))
    if op == "padd":
        got = run("chain", B, 1, arrays=[a, b]).reshape(a.shape)
        plain = kernels.padd_plain(curve, a64, torch.from_numpy(b.astype(np.int64)))
        want = [H.aff_add(curve, u, v) for u, v in zip(a_aff, b_aff)]
    elif op == "pdouble":
        got = run("double", B, arrays=[a]).reshape(a.shape)
        plain = kernels.pdouble_plain(curve, a64)
        want = [H.aff_add(curve, u, u) for u in a_aff]
    else:
        got = run("mixed", B, arrays=[a, xy]).reshape(a.shape)
        xy64 = torch.from_numpy(xy.astype(np.int64))
        plain = P.point_limbs(P.padd_mixed(P.point_from_limbs(curve, a64),
                                           F.fe_steady(f, xy64[0]), F.fe_steady(f, xy64[1])))
        G = H.aff_generator(curve)
        want = [H.aff_add(curve, u, G if v is None else v) for u, v in zip(a_aff, b_aff)]
    _canonical(curve, got, 1)
    assert (_mod_p(curve, got, 1) == _mod_p(curve, plain.numpy(), 1)).all()
    assert _affine_of(curve, got) == want


@pytest.mark.parametrize("op", ["padd", "pdouble", "padd_mixed"])
@pytest.mark.parametrize("cname", ["p384", "p521"])
def test_point_formulas_equal_reference(built, cname, op):
    """The same formulas on the same inputs equal tpu_ecc.ops.points'
    (padd, pdouble, padd_mixed) coordinate by coordinate mod p."""
    runners, refs, plain, _ = built
    curve = get_curve(cname)
    _, a, b = plain[f"{cname}.{op}"]
    mode = {"padd": "chain", "pdouble": "double", "padd_mixed": "mixed"}[op]
    args = (1,) if op == "padd" else ()
    arrays = [a, b] if op == "padd" else [a] if op == "pdouble" else [a, b[:2]]
    got = runners[cname](mode, B, *args, arrays=arrays).reshape(a.shape)
    ref = refs[cname].result()[f"{cname}.{op}"]
    assert (_mod_p(curve, got, 1) == _mod_p(curve, ref, 1)).all()


# ---------------------------------------------------------------------------
# the pow, ladder and genmul bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["fp", "fn"])
@pytest.mark.parametrize("cname", CURVES)
def test_pow_body_equals_plain(built, cname, field):
    """pow_lane on rows across the 13-bit range (0, 1 and p - 1 among
    them), in blocks of 4 lanes sharing a table buffer as the kernel's
    shared memory: at a 64-bit exponent against kernels.fpow_plain on the
    steady rows (the twin's domain), and on every row at e = p - 2 (and
    (p + 1) / 4 on a base field with p = 3 mod 4) against Python's pow."""
    run = built[0][cname]
    spec = _spec(cname, field)
    p = spec.p
    rows = _rows(spec, 6)
    rows[:, 0] = ints_to_limbs_np([spec.encode_int(1)], spec.n_limbs, spec.limb_bits)[:, 0]
    vals = [int(v) for v in _limb_ints(rows, spec.limb_bits, 0)]
    r13 = spec.W if spec.kind == "mont" else 1
    xs = [v * pow(r13, -1, p) % p for v in vals]        # the elements the rows encode
    e64 = int(np.random.default_rng(7).integers(1 << 62, 1 << 63)) * 2 + 1
    exps = [e64, p - 2] + ([(p + 1) // 4] if field == "fp" and p % 4 == 3 else [])
    for e in exps:
        digits = np.array(kernels.exponent_digits(e), np.uint32)
        got = run("pow", B, int(field == "fn"), len(digits), 4,
                  arrays=[rows, digits]).reshape(spec.n_limbs, B)
        assert int(got.max()) < 1 << spec.limb_bits
        out = list(_limb_ints(got, spec.limb_bits, 0))
        assert all(v < p for v in out)
        assert [v * pow(r13, -1, p) % p for v in out] == [pow(x, e, p) for x in xs]
        if e == e64:            # the twin takes steady rows, the kernel's contract
            steady = [i for i, v in enumerate(vals) if v <= _steady_top(spec)]
            want = kernels.fpow_plain(spec, torch.from_numpy(rows[:, steady].astype(np.int64)), e)
            assert len(steady) >= B // 2
            assert [out[i] for i in steady] == list(_limb_ints(want.numpy(), spec.limb_bits, 0) % p)


@pytest.mark.parametrize("cname", BODY_CURVES)
def test_ladder_body_equals_plain(built, cname):
    """ladder_lane at T = 2 without GLV on 24-bit scalars (6 windows, lane
    0's scalars 0, lane 1's 1), blocks of 4 lanes sharing the tables,
    against kernels.ladder_plain mod p and the host oracle."""
    curve = get_curve(cname)
    rng = np.random.default_rng(9)
    G = H.aff_generator(curve)
    bases, ks, pts = [], [], []
    for _ in range(2):
        pt = [H.aff_mul(curve, int(k), G) for k in rng.integers(1, 2**62, B)]
        k = [0, 1] + [int(v) for v in rng.integers(0, 1 << 24, B - 2)]
        pts.append(pt)
        ks.append(k)
        bases.append(P.from_affine_ints(curve, [q[0] for q in pt], [q[1] for q in pt], "cpu"))
    b, mag, neg = SM.ladder_inputs([(bases[t], SM.pack_scalars(curve, ks[t], "cpu"))
                                    for t in range(2)], glv=False, scalar_bits=24)
    nw = mag.shape[0]
    got = built[0][cname]("ladder", B, 2, 2, nw, 0, 4,
                          arrays=[b.numpy(), mag.numpy(), neg.to(torch.int64).numpy()])
    got = got.reshape(3, curve.field.n_limbs, B)
    _canonical(curve, got, 1)
    want = kernels.ladder_plain(curve, b, mag, neg).numpy()
    assert (_mod_p(curve, got, 1) == _mod_p(curve, want, 1)).all()
    assert _affine_of(curve, got) == [
        H.aff_add(curve, H.aff_mul(curve, ks[0][i], pts[0][i]),
                  H.aff_mul(curve, ks[1][i], pts[1][i]))
        for i in range(B)]


@pytest.mark.parametrize("cname", BODY_CURVES)
def test_genmul_body_equals_plain(built, cname):
    """genmul_table (the prologue, by 5 threads) and genmul_lane on the
    comb's rows and all of signed_digits' windows, k = 0, 1, n - 1 and
    random, against kernels.genmul_plain mod p and k G by the host
    oracle."""
    curve = get_curve(cname)
    rng = np.random.default_rng(10)
    ks = [0, 1, curve.n - 1] + [int.from_bytes(rng.bytes(72), "big") % curve.n
                                for _ in range(B - 3)]
    mag, neg = SM.signed_digits(curve, SM.pack_scalars(curve, ks, "cpu"))
    mag, neg = mag.flip(0), neg.flip(0)                      # LSB window first
    tbl = SM._gen_table(curve, torch.device("cpu"))
    nw = mag.shape[0]
    got = built[0][cname]("genmul", B, nw, 5,
                          arrays=[tbl.numpy(), mag.numpy(), neg.to(torch.int64).numpy()])
    got = got.reshape(3, curve.field.n_limbs, B)
    _canonical(curve, got, 1)
    want = kernels.genmul_plain(curve, tbl, mag, neg).numpy()
    assert (_mod_p(curve, got, 1) == _mod_p(curve, want, 1)).all()
    G = H.aff_generator(curve)
    assert _affine_of(curve, got) == [H.aff_mul(curve, k, G) for k in ks]


# ---------------------------------------------------------------------------
# the port's plain field layer against tpu_ecc's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", REFERENCE_FIELDS, ids=lambda f: f"{f[0]}.{f[1]}")
def test_plain_field_layer_equals_reference(built, field):
    """tpu_ecc_torch.ops.fe's multiply, square, add, subtract, negation and
    canonical form equal tpu_ecc.ops.fe's limb for limb on the same
    canonical inputs."""
    name, which = field
    _, _, x, y = built[3][f"{name}.{which}"]
    spec = getattr(get_curve(name), which)
    ref = built[1]["fields"].result()[f"{name}.{which}"]
    fx = F.FE(interop.from_reference_limbs(x, "cpu"), spec, spec.mask, spec.p - 1)
    fy = F.FE(interop.from_reference_limbs(y, "cpu"), spec, spec.mask, spec.p - 1)
    got = {"fmul": F.fmul(fx, fy), "fsquare": F.fsquare(fx), "fadd": F.fadd(fx, fy),
           "fsub": F.fsub(fx, fy), "fneg": F.fneg(fx), "fcanonical": F.fcanonical(F.fadd(fx, fy))}
    assert set(got) == set(fe32_wide_reference.FIELD_OPS)
    for op, v in got.items():
        np.testing.assert_array_equal(interop.to_reference_limbs(v.limbs), ref[op], err_msg=op)

