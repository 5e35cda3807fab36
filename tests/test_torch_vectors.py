"""The wide NIST curves' and bign256's reference vectors through the port
on the CPU (device="cpu", the kernels' plain twins; no tpu_ecc program).

ECDSA (tests/vectors/ecdsa_p{192,224,384,521}.json, FIPS 186-4 SigGen
through the reference crates' ECDSA_TEST_VECTORS): `sign_batch` with each
vector's fixed k and low_s=False gives its (r, s), and `verify_batch`
under its public key accepts it and refuses it with the low bit of r or s
flipped. m is the bits2field output (P-521's 66 bytes taken as an integer
directly), as tests/test_ecdsa.py reads it. P-192 only verifies
(`ecdsa.SIGN_UNSUPPORTED`).

Group (tests/vectors/group_*.json): the 20 add vectors k G, k = 1..20, as
a chain of complete adds from G, and the 32 mul vectors k G through
`scalar_mul` (the ladder) and `mul_by_generator` (the comb). bign256's add
vectors start at 2G, and its mul vectors are not on the curve, so they are
not read (tests/test_scalarmul.py skips them too).

Tolerance: exact (equal affine integers, equal (r, s), equal booleans).
Budget: 150 s for the file at one process (the P-384 and P-521 ladders
take 14-22 s each on the CPU).
"""

import json
import os

import pytest
import torch

from tpu_ecc_torch.curves.specs import get_curve
from tpu_ecc_torch.ops import fe as F
from tpu_ecc_torch.ops import points as P
from tpu_ecc_torch.ops import scalarmul as SM
from tpu_ecc_torch.protocols import ecdsa as E
from tpu_ecc_torch.utils import ec_host as H

VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors")
ECDSA_CURVES = ("p192", "p224", "p384", "p521")
GROUP_CURVES = ("p192", "p224", "p384", "p521", "bign256")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module: its tensors are small, and idle
    threads that spin take cores from the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    with open(os.path.join(VEC_DIR, f"{name}.json")) as fh:
        return json.load(fh)


def _ecdsa_vectors(name):
    c = get_curve(name)
    vecs = _load(f"ecdsa_{name}")
    return ([int(v["d"], 16) for v in vecs], [int(v["k"], 16) for v in vecs],
            [int(v["m"], 16) % c.n for v in vecs],
            [(int(v["q_x"], 16), int(v["q_y"], 16)) for v in vecs],
            [(int(v["r"], 16), int(v["s"], 16)) for v in vecs])


def _affine(pt):
    x, y, inf = P.to_affine(pt)
    return [None if i else (xv, yv) for xv, yv, i in
            zip(F.fe_to_ints(x), F.fe_to_ints(y), inf.reshape(-1).tolist())]


@pytest.mark.parametrize("name", [n for n in ECDSA_CURVES if n not in E.SIGN_UNSUPPORTED])
def test_ecdsa_sign_vectors(name):
    """sign_batch at each vector's k, low_s=False, gives its (r, s)."""
    c = get_curve(name)
    ds, ks, zs, _, want = _ecdsa_vectors(name)
    sigs = E.sign_batch(c, ds, zs, k_ints=ks, low_s=False, device="cpu")
    assert [(r, s) for r, s, _ in sigs] == want


@pytest.mark.parametrize("name", ECDSA_CURVES)
def test_ecdsa_verify_vectors(name):
    """verify_batch accepts each vector under its public key and refuses
    it with the low bit of r or of s flipped."""
    c = get_curve(name)
    _, _, zs, pubs, sigs = _ecdsa_vectors(name)
    bad = [(r ^ 1, s) if i % 2 else (r, s ^ 1) for i, (r, s) in enumerate(sigs)]
    got = E.verify_batch(c, pubs * 2, zs * 2, sigs + bad, low_s=False, device="cpu")
    assert got == [True] * len(sigs) + [False] * len(bad)


@pytest.mark.parametrize("name", GROUP_CURVES)
def test_add_vectors(name):
    """k G for k = 1..20 as a chain of complete adds from G (bign256's
    vectors start at 2G)."""
    c = get_curve(name)
    want = [(int(v["x"], 16), int(v["y"], 16)) for v in _load(f"group_{name}")["add"]]
    if name == "bign256":
        want = [H.aff_generator(c)] + want[:-1]
    G = P.generator(c, (1,), "cpu")
    chain = [G]
    for _ in range(len(want) - 1):
        chain.append(P.steady(P.padd(chain[-1], G)))
    limbs = torch.cat([P.point_limbs(pt) for pt in chain], -1)
    assert _affine(P.point_from_limbs(c, limbs)) == want


@pytest.mark.parametrize("name", [n for n in GROUP_CURVES if n != "bign256"])
def test_mul_vectors(name):
    """The 32 mul vectors k G by scalar_mul (the ladder, G as the base in
    every lane) and by mul_by_generator (the comb)."""
    c = get_curve(name)
    vecs = _load(f"group_{name}")["mul"]
    ks = [int(v["k"], 16) for v in vecs]
    want = [(int(v["x"], 16), int(v["y"], 16)) for v in vecs]
    k = SM.pack_scalars(c, ks, "cpu")
    assert _affine(SM.scalar_mul(P.generator(c, (len(ks),), "cpu"), k)) == want
    assert _affine(SM.mul_by_generator(c, k)) == want
