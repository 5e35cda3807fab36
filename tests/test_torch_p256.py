"""The fourth slice: batched P-256 ECDSA on the a = -3 formulas, port against
tpu_ecc and the host oracle.

The same inputs, made from a seed with numpy and the host oracle, go through
tpu_ecc and through the port with device="cpu" (the kernels' plain twins).
Tolerance: exact. tpu_ecc compiles three programs here, each once at B = 8,
in three worker processes (tests/p256_reference.py) that start with the
module: its verify (about two minutes of XLA:CPU compile, the longest), its
sign core with the key derivation, and one program of the plain formulas
(P-256's mixed add, P-384's add and doubling: a second Montgomery width).
P-256's own add and doubling are held against tpu_ecc in
test_torch_points.py. The kernel-side formulas run eagerly: tpu_ecc's
`_kadd_am3`, `_kadd_mixed_am3` and `_kdouble_am3` on jnp uint32 limb rows,
no `pallas_call`. Recovery is held against the host oracle and the
reference's vectors (tpu_ecc's recover program would be a fourth compile of
minutes); its lincomb is the verify's, which tpu_ecc checks here.
"""

import concurrent.futures
import functools
import json
import multiprocessing
import os

import jax.numpy as jnp
import numpy as np
import pytest

import p256_reference
from tpu_ecc.curves.specs import get_curve as j_curve
from tpu_ecc.encoding import sec1 as j_sec1
from tpu_ecc.ops import fe_kernel as JK
from tpu_ecc.ops import pallas_kernels as JPK
from tpu_ecc_torch import interop
from tpu_ecc_torch.curves.specs import get_curve
from tpu_ecc_torch.encoding import der, sec1
from tpu_ecc_torch.ops import fe as F
from tpu_ecc_torch.ops import kfe
from tpu_ecc_torch.ops import points as P
from tpu_ecc_torch.ops import scalarmul as SM
from tpu_ecc_torch.protocols import ecdsa as E
from tpu_ecc_torch.utils import ec_host as H
from tpu_ecc_torch.utils.bigint import ints_to_limbs_np, limbs_np_to_ints

NAME = "p256"
C = get_curve(NAME)
B = 8
VEC = os.path.join(os.path.dirname(__file__), "vectors", f"ecdsa_{NAME}.json")
GROUP = os.path.join(os.path.dirname(__file__), "vectors", f"group_{NAME}.json")


def _rand(rng, curve=C):
    return int.from_bytes(rng.bytes(48), "big") % (curve.n - 1) + 1


def _points(curve, seed, count=B):
    """`count` affine points k*G for random k, from a seed."""
    rng = np.random.default_rng(seed)
    G = H.aff_generator(curve)
    return [H.aff_mul(curve, _rand(rng, curve), G) for _ in range(count)]


def _proj_limbs(curve, pts, seed):
    """Steady projective limbs uint32 [3, n, B] of affine points, each at a
    random Z (Z = 0 for None, the identity)."""
    rng = np.random.default_rng(seed)
    f, p = curve.field, curve.p
    cols = []
    for pt in pts:
        if pt is None:
            cols.append((0, 1, 0))
            continue
        z = _rand(rng, curve) % p or 1
        cols.append((pt[0] * z % p, pt[1] * z % p, z))
    return np.stack([F.fe_from_ints(f, [c[i] for c in cols], "cpu").limbs.numpy()
                     for i in range(3)], 0).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _signed():
    """B keys and digests from a seed, and the verify inputs made from them:
    the port's RFC 6979 signatures, every fourth lane tampered (z + 1 or the
    low bit of r flipped), lane 5's key moved off the curve."""
    rng = np.random.default_rng(41)
    ds = [_rand(rng) for _ in range(B)]
    zs = [int.from_bytes(rng.bytes(32), "big") % C.n for _ in range(B)]
    sigs = E.sign_batch(C, ds, zs, device="cpu")
    pubs = [H.aff_mul(C, d, H.aff_generator(C)) for d in ds]
    v_pubs, v_zs, v_sigs = list(pubs), list(zs), [s[:2] for s in sigs]
    v_zs[3] += 1
    v_sigs[7] = (v_sigs[7][0] ^ 1, v_sigs[7][1])
    v_pubs[5] = (pubs[5][0], (pubs[5][1] + 1) % C.p)
    return ds, zs, sigs, pubs, (v_pubs, v_zs, v_sigs)


def _plain_inputs():
    """{case: (curve, a, b)}: P-256 lanes for the mixed add (b affine), and
    P-384 lanes for the add and the doubling, with a doubling lane, an
    inverse pair and an identity among them."""
    out = {}
    for name, ops in ((NAME, ("padd_mixed",)), ("p384", ("padd", "pdouble"))):
        curve = get_curve(name)
        a, b = _points(curve, 42), _points(curve, 43)
        b[1] = a[1]
        b[2] = (a[2][0], curve.p - a[2][1])
        a[3] = None
        a_l = _proj_limbs(curve, a, 44)
        for op in ops:
            b_l = _affine_limbs(curve, b) if op == "padd_mixed" else _proj_limbs(curve, b, 45)
            out[f"{name}-{op}"] = (name, a_l, b_l)
    return out


def _affine_limbs(curve, pts):
    """Limbs [3, n, B] of affine points at Z = 1 (x and y feed a mixed add)."""
    f = curve.field
    return np.stack([F.fe_from_ints(f, v, "cpu").limbs.numpy() for v in
                     ([pt[0] for pt in pts], [pt[1] for pt in pts], [1] * len(pts))],
                    0).astype(np.uint32)


# ---------------------------------------------------------------------------
# tpu_ecc's results, computed in worker processes from the module's start
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def references():
    """tpu_ecc's three programs, submitted at once to three niced worker
    processes so that their compiles overlap each other and the port's own
    work in this process. The tests that read them come last."""
    ds, zs, _, _, (v_pubs, v_zs, v_sigs) = _signed()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=3, mp_context=multiprocessing.get_context("spawn"),
            initializer=os.nice, initargs=(10,)) as pool:
        refs = {"verify": pool.submit(p256_reference.verify, NAME, v_pubs, v_zs, v_sigs),
                "sign": pool.submit(p256_reference.sign_and_derive, NAME, ds, zs),
                "plain": pool.submit(p256_reference.plain_formulas, _plain_inputs())}
        yield {k: functools.lru_cache(maxsize=None)(v.result) for k, v in refs.items()}
        pool.shutdown(cancel_futures=True)


# ---------------------------------------------------------------------------
# scalar multiplication on the reference's group vectors
# ---------------------------------------------------------------------------

def _to_affine_ints(curve, limbs):
    pt = P.steady(interop.point_from_reference(curve, limbs, "cpu"))
    x, y, inf = P.to_affine(pt)
    return [None if i else (xv, yv)
            for xv, yv, i in zip(F.fe_to_ints(x), F.fe_to_ints(y), inf.tolist())]


def test_group_mul_vectors():
    """k*G for the reference's MUL_TEST_VECTORS: on the comb
    (`mul_by_generator`, the genmul twin) and on the single-term ladder
    (`scalar_mul`, P-256 has no GLV split, so the H == 1 seed)."""
    vecs = json.load(open(GROUP))["mul"][:B]
    ks = SM.pack_scalars(C, [int(v["k"], 16) for v in vecs], "cpu")
    want = [(int(v["x"], 16), int(v["y"], 16)) for v in vecs]
    G = P.generator(C, (B,), "cpu")
    for pt in (SM.mul_by_generator(C, ks), SM.scalar_mul(G, ks)):
        got = interop.to_reference_limbs(P.point_limbs(P.steady(pt)))
        assert _to_affine_ints(C, got) == want


# ---------------------------------------------------------------------------
# the kernel-side formulas (ops/kfe.py): tpu_ecc's Pallas kernel bodies
# ---------------------------------------------------------------------------

def _steady_rows(spec, rng, count):
    """Steady Montgomery limbs [count * n, B]: values below 4p, with 4p - 1
    and 0 in the first two lanes."""
    out = []
    for _ in range(count):
        vals = [4 * spec.p - 1, 0] + [int.from_bytes(rng.bytes(40), "big") % (4 * spec.p)
                                      for _ in range(B - 2)]
        out.append(ints_to_limbs_np(vals, spec.n_limbs, spec.limb_bits))
    return np.concatenate(out, 0).astype(np.uint32)


_KERNEL_FORMULAS = {"padd": (JPK._kadd_am3, (3, 3)),
                    "padd_mixed": (JPK._kadd_mixed_am3, (3, 1, 1)),
                    "pdouble": (JPK._kdouble_am3, (3,))}


@pytest.mark.parametrize("name", list(_KERNEL_FORMULAS))
def test_kernel_formulas_equal_pallas_bodies(name):
    """The port's generated functions, run on numpy uint32 (the kernels'
    exact arithmetic), against tpu_ecc's kernel bodies on jnp uint32 rows,
    each output through fe_kernel.ksteady: the same limbs."""
    fn, widths = _KERNEL_FORMULAS[name]
    f, jf = C.field, j_curve(NAME).field
    rng = np.random.default_rng(46)
    args = [_steady_rows(f, rng, w) for w in widths]
    got = kfe.evaluate(C, name, *args)
    rows = [JK.kfe_from_rows(jf, [jnp.asarray(r) for r in a[k * f.n_limbs:(k + 1) * f.n_limbs]])
            for a in args for k in range(a.shape[0] // f.n_limbs)]
    ref = np.concatenate([np.stack([np.asarray(r) for r in JK.ksteady(v).limbs], 0)
                          for v in fn(j_curve(NAME), *rows)], 0)
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# ECDSA: sign, derive, verify, recover
# ---------------------------------------------------------------------------

def test_sign_vectors_fixed_k():
    """The reference's P-256 ECDSA vectors with their own k: equal (r, s)."""
    vecs = json.load(open(VEC))
    sigs = E.sign_batch(C, [int(v["d"], 16) for v in vecs],
                        [int(v["m"], 16) % C.n for v in vecs],
                        k_ints=[int(v["k"], 16) for v in vecs], device="cpu")
    assert [(r, s) for r, s, _ in sigs] == [(int(v["r"], 16), int(v["s"], 16)) for v in vecs]


def _wide_r(rng):
    """A signature whose R has x(R) >= n (RecoveryId bit 1), made without a
    nonce: pick R, u1 and s, then Q = (R - u1 G) / u2 with u2 = r / s and
    z = u1 s. Returns (Q, z, (r, s, recid))."""
    n = C.n
    x = n
    while H.decompress(C, x, False) is None:
        x += 1
    R, r = H.decompress(C, x, False), x - n
    u1, s = _rand(rng), _rand(rng)
    u2 = r * pow(s, -1, n) % n
    Q = H.aff_mul(C, pow(u2, -1, n),
                  H.aff_add(C, R, H.aff_mul(C, n - u1, H.aff_generator(C))))
    return Q, u1 * s % n, (r, s, (R[1] & 1) | 2)


def test_recover_batch():
    """The port's signatures recover their keys; the reference's vectors
    (signed here with their own k) recover theirs; a signature with x(R) >=
    n recovers through RecoveryId bit 1 and fails without it; r = 0 gives
    None."""
    _, zs, sigs, pubs, _ = _signed()
    vecs = json.load(open(VEC))[:3]
    v_z = [int(v["m"], 16) % C.n for v in vecs]
    v_sigs = E.sign_batch(C, [int(v["d"], 16) for v in vecs], v_z,
                          k_ints=[int(v["k"], 16) for v in vecs], device="cpu")
    Q, wz, wsig = _wide_r(np.random.default_rng(47))
    z_in = list(zs[:2]) + v_z + [wz, wz, zs[2]]
    s_in = list(sigs[:2]) + v_sigs + [wsig, wsig[:2] + (wsig[2] & 1,), (0,) + sigs[2][1:]]
    got = E.recover_batch(C, z_in, s_in, device="cpu")
    assert got[:2] == pubs[:2]
    assert got[2:5] == [(int(v["q_x"], 16), int(v["q_y"], 16)) for v in vecs]
    assert got[5] == Q and got[6] != Q
    assert got[7] is None


def test_field_to_scalar_raw():
    """x mod n for x in [0, p) on P-256, with the flag that x >= n."""
    n, p = C.n, C.p
    xs = [0, 1, n - 1, n, n + 5, p - 1]
    raw, over = F.field_to_scalar_raw(C.field, C.scalar, F.fe_from_ints(C.field, xs, "cpu"))
    assert limbs_np_to_ints(raw.numpy(), C.scalar.limb_bits) == [x % n for x in xs]
    assert over.tolist() == [x >= n for x in xs]


def test_sec1_der_and_key_api():
    """Compressed and uncompressed SEC1 keys decode to tpu_ecc's points and
    encode to its bytes; SigningKey signs through DER and the VerifyingKey
    from its compressed SEC1 bytes verifies."""
    _, _, sigs, pubs, _ = _signed()
    jc = j_curve(NAME)
    for pt in pubs[:4]:
        for compress in (True, False):
            data = sec1.encode_point(C, pt, compress)
            assert data == j_sec1.encode_point(jc, pt, compress)
            assert sec1.decode_point(C, data) == j_sec1.decode_point(jc, data) == pt
    r, s, _ = sigs[0]
    assert der.der_to_sig(der.sig_to_der(r, s)) == (r, s)
    sk = E.SigningKey.from_bytes(NAME, bytes.fromhex(json.load(open(VEC))[0]["d"]))
    msg = b"tpu_ecc_torch signs P-256"
    sig = sk.sign(msg, device="cpu")
    vk = E.VerifyingKey.from_sec1_bytes(
        NAME, sec1.encode_point(C, H.aff_mul(C, sk.d, H.aff_generator(C)), True))
    assert vk.verify(msg, sig, device="cpu") and not vk.verify(msg + b"!", sig, device="cpu")


# ---------------------------------------------------------------------------
# against tpu_ecc's programs (last: they wait for the worker processes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["p256-padd_mixed", "p384-padd", "p384-pdouble"])
def test_plain_formulas_limb_equal(references, case):
    """P-256's mixed add, P-384's add and doubling: limb for limb against
    tpu_ecc.ops.points (one jitted program), and the host oracle."""
    name, a, b = _plain_inputs()[case]
    curve = get_curve(name)
    pa = interop.point_from_reference(curve, a, "cpu")
    pb = interop.point_from_reference(curve, b, "cpu")
    op = case.split("-")[1]
    out = {"padd_mixed": lambda: P.padd_mixed(pa, pb.x, pb.y),
           "padd": lambda: P.padd(pa, pb), "pdouble": lambda: P.pdouble(pa)}[op]()
    got = interop.to_reference_limbs(P.point_limbs(P.steady(out)))
    np.testing.assert_array_equal(got, references["plain"]()[case])
    a_aff, b_aff = _to_affine_ints(curve, a), _to_affine_ints(curve, b)
    want = [H.aff_add(curve, u, u if op == "pdouble" else v) for u, v in zip(a_aff, b_aff)]
    assert _to_affine_ints(curve, got) == want

def test_sign_batch_equals_reference(references):
    """RFC 6979 nonces, sha256, P-256 not low-s: equal (r, s, recid) to
    tpu_ecc's sign_batch, and each (r, s) the host oracle's for the same
    nonce."""
    from tpu_ecc_torch.protocols import rfc6979

    assert E.CURVE_HASH[NAME] == "sha256" and NAME not in E.LOW_S_CURVES
    ds, zs, sigs, _, _ = _signed()
    assert sigs == references["sign"]()[0]
    for d, z, (r, s, recid) in zip(ds, zs, sigs):
        k = rfc6979.generate_k(C.n, d, z.to_bytes(32, "big"))
        assert (r, s) == H.ecdsa_sign(C, d, z, k, low_s=False)
        R = H.aff_mul(C, k, H.aff_generator(C))
        assert recid == (R[1] & 1) | (int(R[0] >= C.n) << 1)

def test_derive_public_batch(references):
    ds, _, _, pubs, _ = _signed()
    got = SM.derive_public_batch(C, ds, device="cpu")
    assert got == pubs == references["sign"]()[1]

def test_verify_batch_equals_reference(references):
    """Lanes 3 and 7 tampered, lane 5's key off the curve: the port's
    booleans equal tpu_ecc's and the expected ones."""
    _, _, _, _, (v_pubs, v_zs, v_sigs) = _signed()
    assert not H.on_curve(C, v_pubs[5])
    got = E.verify_batch(C, v_pubs, v_zs, v_sigs, device="cpu")
    assert got == references["verify"]() == [i not in (3, 5, 7) for i in range(B)]
