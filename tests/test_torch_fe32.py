"""The 32-bit field layer (tpu_ecc_torch/csrc/fe32.cuh, point32.cuh) and the
per-lane bodies of the two kernels that run on it, `padd_chain` and
`segscan`, built with g++ into one host harness per curve (secp256k1: a = 0,
solinas fold; P-256: a = -3, Montgomery CIOS with the domain maps to and
from the 13-bit plan's R).

Inputs are made from a numpy seed (and the host oracle's points). Tolerance:
exact. The field operations and both boundary converters equal Python ints;
the point add equals, coordinate by coordinate mod p, tpu_ecc.ops.points'
add (one jitted program per curve) and the port's `kernels.padd_plain`; the
chain body equals `padd_chain_plain` and the segscan body `segscan_plain`
mod p, at the run-end rows that the kernel writes. Every value the harness
returns is canonical.

Budget: 60 s for the file at one process (two g++ builds of a few seconds
and two small XLA:CPU programs).
"""

import functools
import pathlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ecc.curves.specs import get_curve as j_curve
from tpu_ecc.ops import points as JP
from tpu_ecc_torch.curves.specs import get_curve
from tpu_ecc_torch.ops import fe as F
from tpu_ecc_torch.ops import kernels
from tpu_ecc_torch.ops import kfe
from tpu_ecc_torch.ops import points as P
from tpu_ecc_torch.ops import scalarmul as SM
from tpu_ecc_torch.parallel import msm as M
from tpu_ecc_torch.utils import ec_host as H
from tpu_ecc_torch.utils.bigint import ints_to_limbs_np

CURVES = ("secp256k1", "p256")
B = 16

_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include "kfe_fe32.cuh"
#include "point32.cuh"
using C = Curve32;
using namespace fe32;
typedef std::vector<uint32_t> V;
static V rd(size_t n) {
  V v(n);
  if (n && fread(v.data(), 4, n, stdin) != n) exit(4);
  return v;
}
static void wr(const V& v) { fwrite(v.data(), 4, v.size(), stdout); }
static E<C> el(const uint32_t* p) {
  E<C> r;
  for (int i = 0; i < C::N; ++i) r.w[i] = p[i];
  return r;
}
static void put(V& out, size_t l, const E<C>& x) {
  for (int i = 0; i < C::N; ++i) out[l * C::N + i] = x.w[i];
}
// harness <mode> <lanes> [args]: uint32 arrays in on stdin, out on stdout
int main(int argc, char** argv) {
  if (argc < 3) return 2;
  const char* m = argv[1];
  const size_t n = (size_t)atoi(argv[2]), N = C::N, NL = C::NL, PN = 3 * C::NL;
  if (!strcmp(m, "chain")) {  // chain B repeat: a, b [3, NL, B] -> out
    const int repeat = atoi(argv[3]);
    V a = rd(PN * n), b = rd(PN * n), out(PN * n);
    for (size_t l = 0; l < n; ++l)
      padd_chain_lane<C>(a.data(), b.data(), out.data(), (int)n, (int)l, repeat);
    wr(out);
    return 0;
  }
  if (!strcmp(m, "segscan")) {  // segscan L C nbuck signed
    const int rows = atoi(argv[3]), sg = atoi(argv[5]);
    const uint32_t nbuck = (uint32_t)atoi(argv[4]);
    V key = rd(rows * n), val = rd(rows * PN * n), neg = rd(sg ? rows * n : 0);
    V scanned(rows * PN * n, 0xFFFFFFFFu), last(n), tail(PN * n), lead(PN * n, 0xFFFFFFFFu);
    for (size_t l = 0; l < n; ++l)
      segscan_lane<C>(key.data(), val.data(), sg ? neg.data() : nullptr, scanned.data(),
                      last.data(), tail.data(), lead.data(), rows, (int)n, nbuck, (int)l);
    wr(scanned), wr(last), wr(tail), wr(lead);
    return 0;
  }
  if (!strcmp(m, "load")) {  // NL limbs a lane -> N words
    V in = rd(NL * n), out(N * n);
    for (size_t l = 0; l < n; ++l) put(out, l, from_limbs<C>(&in[l * NL], 1));
    wr(out);
    return 0;
  }
  if (!strcmp(m, "store")) {  // N words a lane -> NL limbs
    V in = rd(N * n), out(NL * n);
    for (size_t l = 0; l < n; ++l) to_limbs<C>(el(&in[l * N]), &out[l * NL], 1);
    wr(out);
    return 0;
  }
  const bool binary = !strcmp(m, "add") || !strcmp(m, "sub") || !strcmp(m, "mul");
  V in = rd((binary ? 2 : 1) * N * n), out(N * n);
  for (size_t l = 0; l < n; ++l) {
    const E<C> a = el(&in[l * N]), b = binary ? el(&in[(n + l) * N]) : a;
    E<C> r;
    if (!strcmp(m, "add")) r = add<C>(a, b);
    else if (!strcmp(m, "sub")) r = sub<C>(a, b);
    else if (!strcmp(m, "mul")) r = mul<C>(a, b);
    else if (!strcmp(m, "neg")) r = neg<C>(a);
    else if (!strcmp(m, "sqr")) r = sqr<C>(a);
    else if (!strcmp(m, "mul_b")) r = mul_b<C>(a);
    else if (!strcmp(m, "mul_small")) r = mul_small<C>(a, (uint32_t)atoi(argv[3]));
    else return 3;
    put(out, l, r);
  }
  wr(out);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """harness(curve name)(mode, lanes, *args, arrays=[...]) -> uint32 words."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++")
    built = {}

    def get(cname):
        if cname not in built:
            d = tmp_path_factory.mktemp(f"fe32-{cname}")
            (d / "kfe_fe32.cuh").write_text(kfe.fe32_header(get_curve(cname)))
            (d / "harness.cpp").write_text(_HARNESS)
            exe = d / "harness"
            subprocess.run([gxx, "-O1", "-std=c++17", "-I", str(d), "-I", kernels.CSRC,
                            "-o", str(exe), str(d / "harness.cpp")],
                           check=True, capture_output=True)
            built[cname] = exe

        def run(mode, lanes, *args, arrays):
            data = b"".join(np.ascontiguousarray(a, np.uint32).tobytes() for a in arrays)
            res = subprocess.run([str(built[cname]), mode, str(lanes), *map(str, args)],
                                 input=data, capture_output=True, check=True)
            return np.frombuffer(res.stdout, np.uint32)

        return run

    return get


# ---------------------------------------------------------------------------
# integers, words and limbs
# ---------------------------------------------------------------------------

def _to_words(vals, n):
    """ints -> uint32 [lanes, n] (lane-major, as the harness's field modes)."""
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)] for v in vals], np.uint32)


def _from_words(arr):
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in arr]


def _limb_ints(limbs, bits, axis=0):
    """Little-endian limbs along `axis` -> the integers (numpy object array)."""
    a = np.moveaxis(np.asarray(limbs), axis, 0).astype(object)
    acc = np.zeros(a.shape[1:], object)
    for i in reversed(range(a.shape[0])):
        acc = acc * (1 << bits) + a[i]
    return acc


def _mod_p(curve, limbs, axis):
    """Coordinates' integers mod p of limb arrays (limb axis `axis`)."""
    return _limb_ints(limbs, curve.field.limb_bits, axis) % curve.p


def _canonical(curve, limbs, axis):
    """The limbs are below 2^13 and the integers below p."""
    f = curve.field
    assert int(np.asarray(limbs).max()) <= f.mask
    assert (_limb_ints(limbs, f.limb_bits, axis) < f.p).all()


def _domain(curve):
    """(R32 or 1, R13 or 1): the layer's and the 13-bit plan's Montgomery R."""
    f = curve.field
    if f.kind != "mont":
        return 1, 1
    return 1 << (32 * kfe.FE32_N), f.W


# ---------------------------------------------------------------------------
# the field operations and the boundary converters, against Python ints
# ---------------------------------------------------------------------------

def _canonical_inputs(p, rng, count=B):
    return [0, p - 1, 1, p - 2] + [int.from_bytes(rng.bytes(40), "big") % p
                                   for _ in range(count - 4)]


@pytest.mark.parametrize("cname", CURVES)
@pytest.mark.parametrize("op", ["add", "sub", "neg", "mul", "sqr", "mul_b", "mul_small"])
def test_field_op_equals_ints(harness, cname, op):
    curve = get_curve(cname)
    p, N = curve.p, kfe.FE32_N
    r32, _ = _domain(curve)
    rng = np.random.default_rng(1)
    a = _canonical_inputs(p, rng)
    b = _canonical_inputs(p, rng)[::-1]
    b_plain = (3 * curve.b if curve.strategy == "a0" else curve.b) % p
    inv = pow(r32, -1, p)
    want = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y, "neg": lambda x, y: -x,
            "mul": lambda x, y: x * y * inv, "sqr": lambda x, y: x * x * inv,
            "mul_b": lambda x, y: b_plain * x, "mul_small": lambda x, y: 21 * x}[op]
    arrays = [_to_words(a, N)] + ([_to_words(b, N)] if op in ("add", "sub", "mul") else [])
    args = (21,) if op == "mul_small" else ()
    got = _from_words(harness(cname)(op, B, *args, arrays=arrays).reshape(B, N))
    assert got == [want(x, y) % p for x, y in zip(a, b)]


def _steady_top(spec):
    """The largest steady value: carried_vmax (solinas: every limb at the
    mask, 2^260 - 1) or 4p - 1 (Montgomery)."""
    return spec.carried_vmax if spec.kind == "solinas" else 4 * spec.p - 1


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
    got = _from_words(harness(cname)("load", B, arrays=[limbs]).reshape(B, kfe.FE32_N))
    assert got == [v * pow(r13, -1, f.p) * r32 % f.p for v in vals]


@pytest.mark.parametrize("cname", CURVES)
def test_store_converter_equals_ints(harness, cname):
    """Canonical words -> canonical 13-bit limbs of x R32^-1 R13 mod p
    (Montgomery) or x (solinas)."""
    curve = get_curve(cname)
    f = curve.field
    r32, r13 = _domain(curve)
    vals = _canonical_inputs(f.p, np.random.default_rng(3))
    out = harness(cname)("store", B, arrays=[_to_words(vals, kfe.FE32_N)])
    out = out.reshape(B, f.n_limbs)
    _canonical(curve, out, 1)
    assert list(_limb_ints(out, f.limb_bits, 1)) == [
        v * pow(r32, -1, f.p) * r13 % f.p for v in vals]


# ---------------------------------------------------------------------------
# the point add and the chain body
# ---------------------------------------------------------------------------

def _affine_pairs(curve):
    """(a, b) affine pairs, None for O: O + O, P + O, O + P, P + P,
    P + (-P), then random pairs."""
    rng = np.random.default_rng(4)
    G = H.aff_generator(curve)
    pts = [H.aff_mul(curve, int(k), G) for k in rng.integers(1, 2**62, 2 * B)]
    a, b = pts[:B], pts[B:]
    a[0] = b[0] = None
    b[1] = None
    a[2] = None
    b[3] = a[3]
    b[4] = (a[4][0], curve.p - a[4][1])
    return a, b


def _steady_limbs(curve, pts, rng):
    """Steady projective limbs uint32 [3, n, B] of affine points with random
    representatives: X, Y scaled by a random Z, each coordinate plus a
    random multiple of p that stays steady."""
    f = curve.field
    top = _steady_top(f)
    coords = [[], [], []]
    for pt in pts:
        if pt is None:
            xyz = (0, 1, 0)
        else:
            z = int(rng.integers(1, 2**62))
            xyz = (pt[0] * z % curve.p, pt[1] * z % curve.p, z)
        for c, v in zip(coords, xyz):
            v = f.encode_int(v)
            c.append(v + int(rng.integers(0, (top - v) // f.p + 1)) * f.p)
    return np.stack([ints_to_limbs_np(c, f.n_limbs, f.limb_bits) for c in coords], 0)


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
# the segscan body
# ---------------------------------------------------------------------------

def _window_group(curve, N, L, w, signed, windows):
    """The first `windows` windows of a Pippenger MSM over N points (16
    distinct, tiled) with random full-width scalars plus 0 and n - 1, sorted
    and laid out as msm_pippenger gives them to segscan (the shapes of
    tests/test_torch_kernels_cuda.py's small case)."""
    rng = np.random.default_rng(N + w + signed)
    G = H.aff_generator(curve)
    pts = [H.aff_mul(curve, int(k), G) for k in rng.integers(1, 2**62, 16)]
    pts = [pts[i % 16] for i in range(N)]
    Q = P.from_affine_ints(curve, [p[0] for p in pts], [p[1] for p in pts], "cpu")
    ks = [0, curve.n - 1] + [int.from_bytes(rng.bytes(32), "big") for _ in range(N - 2)]
    payload, keys, negs, nbuck = M.pippenger_inputs(
        curve, Q.x, Q.y, torch.zeros(N, dtype=torch.bool),
        SM.pack_scalars(curve, ks, "cpu"), w, signed=signed)
    negs = None if negs is None else negs[:windows]
    return M.sorted_windows(payload, keys[:windows], negs, L), nbuck


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_segscan_body_equals_plain(harness, signed):
    """secp256k1 (segscan's build), N = 512, L = 32, w = 8, two windows side
    by side: the harness's rows at the run ends, last_key, tail and lead
    against segscan_plain (mod p); the rows that end no run stay unwritten;
    bucket_lookup on either's rows and fixup gives the same buckets mod p."""
    curve = get_curve("secp256k1")
    (skey, key2, val2, neg2), nbuck = _window_group(curve, 512, 32, 8, signed, 2)
    C, lanes, n = key2.shape[0], key2[0].numel(), curve.field.n_limbs
    arrays = [key2.numpy(), val2.numpy()] + ([neg2.numpy()] if signed else [])
    out = harness("secp256k1")("segscan", lanes, C, nbuck, int(signed), arrays=arrays)
    cut = np.cumsum([C * 3 * n * lanes, lanes, 3 * n * lanes])
    scanned, last_key, tail, lead = np.split(out, cut)
    scanned = scanned.reshape(val2.shape)
    tail, lead = tail.reshape(3, n, *key2.shape[1:]), lead.reshape(3, n, *key2.shape[1:])
    want = [t.numpy() for t in kernels.segscan_plain(curve, key2, val2, nbuck, neg2)]

    k = key2.numpy()
    ends = np.ones(k.shape, bool)
    ends[:-1] = k[1:] != k[:-1]
    assert 0 < ends.sum() < ends.size
    rows = np.moveaxis(scanned, 0, 2)[..., ends]          # [3, n, run ends]
    rows_want = np.moveaxis(want[0], 0, 2)[..., ends]
    _canonical(curve, rows, 1)
    assert (_mod_p(curve, rows, 1) == _mod_p(curve, rows_want, 1)).all()
    assert (np.moveaxis(scanned, 0, 2)[..., ~ends] == 0xFFFFFFFF).all()
    np.testing.assert_array_equal(last_key.reshape(k.shape[1:]).view(np.int32), want[1])
    for got, ref in ((tail, want[2]), (lead, want[3])):
        _canonical(curve, got, 1)
        assert (_mod_p(curve, got, 1) == _mod_p(curve, ref, 1)).all()

    def buckets(sc, lk, tl, ld):
        sc, lk, tl, ld = (torch.from_numpy(np.asarray(x).astype(np.int32)) for x in (sc, lk, tl, ld))
        fixed = kernels.fixup_plain(curve, tl, lk, key2[0], ld)
        return M.bucket_lookup(curve, skey, sc, fixed, key2[0], nbuck).numpy()

    mine = buckets(scanned, last_key.reshape(k.shape[1:]).view(np.int32), tail, lead)
    assert (_mod_p(curve, mine, 1) == _mod_p(curve, buckets(*want), 1)).all()


# ---------------------------------------------------------------------------
# the build and the bound
# ---------------------------------------------------------------------------

def test_build_key_follows_the_included_headers(tmp_path, monkeypatch):
    """The two kernels on the layer include fe32.cuh and point32.cuh, and a
    change to an included header changes the library's build key."""
    assert kernels.includes("padd_chain.cu") == ["fe32.cuh", "point32.cuh"]
    assert kernels.includes("segscan.cu") == ["fe32.cuh", "point32.cuh"]
    assert kernels.includes("padd.cu") == []
    src = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, src)
    monkeypatch.setattr(kernels, "CSRC", str(src))
    curve = get_curve("secp256k1")
    before = kernels._target("segscan", curve)[0]
    with open(src / "fe32.cuh", "a") as fh:
        fh.write("// changed\n")
    assert kernels._target("segscan", curve)[0] != before
    assert "Curve32" in kernels._target("segscan", curve)[2]


@pytest.mark.parametrize("cname", CURVES)
def test_fe32_counts_and_constants(cname):
    """The 32-bit design counts fewer instructions an add than the 13-bit
    one (kernels.work's two designs); the header's constants are the
    curve's, and the domain maps compose to the identity."""
    curve = get_curve(cname)
    k = kfe.fe32_constants(curve)
    p = curve.p
    assert sum(w << (32 * i) for i, w in enumerate(k["p"])) == p
    if k["MONT"]:
        r32, r13 = _domain(curve)
        to32 = sum(w << (32 * i) for i, w in enumerate(k["to32"]))
        to13 = sum(w << (32 * i) for i, w in enumerate(k["to13"]))
        inv = pow(r32, -1, p)
        assert to32 * inv * to13 * inv % p == 1     # store(load(v)) = v
        assert k["N0"] * p % (1 << 32) == (1 << 32) - 1
    ops = {d: kernels.work("padd_chain", curve, 64, design=d, repeat=16)[0]
           for d in kernels.designs("padd_chain")}
    assert 0 < sum(ops["fe32"].values()) < sum(ops["kfe"].values())
    with pytest.raises(NotImplementedError):
        kfe.fe32_constants(get_curve("bp256r1"))


def test_padd_count_follows_point32(tmp_path, monkeypatch):
    """The add's field operations in the fe32 count are read from
    point32.cuh: RCB's 12 multiplies and 2 by b in both formulas, and an
    edit of the header moves the count."""
    assert kfe.padd_fe32_ops("a0") == {"mul": 12, "mul_b": 2, "add": 14, "sub": 5}
    assert kfe.padd_fe32_ops("a_minus3") == {"mul": 12, "mul_b": 2, "add": 20, "sub": 9}
    text = pathlib.Path(kfe._POINT32).read_text()
    edited = tmp_path / "point32.cuh"
    edited.write_text(text.replace("  X3 = sub<C>(t2, X3);\n",
                                   "  X3 = sub<C>(t2, mul<C>(X3, X3));\n", 1))
    monkeypatch.setattr(kfe, "_POINT32", str(edited))
    assert kfe.padd_fe32_ops("a0") == {"mul": 13, "mul_b": 2, "add": 14, "sub": 5}
    assert kfe.padd_fe32_ops("a_minus3")["mul"] == 12
