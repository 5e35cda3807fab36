"""hash-to-curve (RFC 9380) of the port against tpu_ecc and the published
vectors, on the four suites (secp256k1 with its 3-isogeny, P-256, P-384,
P-521).

The same inputs go through tpu_ecc and through the port with device="cpu"
(the kernels' plain twins). Tolerance: exact, on bytes, integers and
limbs. The host parts (expand_message_xmd, hash_to_field, the SSWU
constants, hash_to_scalar) are compared with tpu_ecc's in this process.
The device map is compared limb for limb with tpu_ecc's `_map_core` on u
values from a seed that take both branches of the square test: its jitted
program compiles for secp256k1 and P-256 in one niced worker process
(tests/protocols_reference.py) that starts with the module (about 45 s a
curve; run op by op under jax.disable_jit it takes 234 s and 141 s, beyond
the budget). The vectors come from tests/vectors/rfc9380_h2c.json, held
equal here to tests/test_protocols.py's inline copy.

Budget: 150 s for the file at one process.
"""

import concurrent.futures
import functools
import json
import multiprocessing
import os
import pathlib

import numpy as np
import pytest

import protocols_reference
import test_protocols
from tpu_ecc.curves.specs import get_curve as j_curve
from tpu_ecc.protocols import hash2curve as JH
from tpu_ecc_torch.curves.specs import get_curve
from tpu_ecc_torch.ops import fe as F
from tpu_ecc_torch.protocols import hash2curve

SUITES = ["secp256k1", "p256", "p384", "p521"]
MAP_CURVES = ["secp256k1", "p256"]
VECTORS = json.loads((pathlib.Path(__file__).parent / "vectors" / "rfc9380_h2c.json").read_text())
LANES = 8       # u pairs a curve, half of each u's lanes on each branch


def _gx1_is_square(curve, u: int) -> bool:
    """The SSWU branch of u by Python ints: is g(x1) a square (RFC 9380
    6.6.2, e2 in the map)."""
    A, B, Z, _, _ = hash2curve._sswu_consts(curve)
    p = curve.p
    tv1 = Z * u * u % p
    tv2 = (tv1 * tv1 + tv1) % p
    if tv2 == 0:
        x1 = B * pow(Z * A, -1, p) % p
    else:
        x1 = (-B) * pow(A, -1, p) * (1 + pow(tv2, -1, p)) % p
    gx1 = (x1 * x1 * x1 + A * x1 + B) % p
    return pow(gx1, (p - 1) // 2, p) in (0, 1)


@functools.lru_cache(maxsize=None)
def _map_inputs():
    """{curve: (u0s, u1s)}: LANES u pairs from a seed, both u of each lane
    on one branch, half of the lanes on each."""
    rng = np.random.default_rng(71)
    out = {}
    for name in MAP_CURVES:
        c = get_curve(name)
        by_branch = {True: [], False: []}
        while min(len(v) for v in by_branch.values()) < LANES:
            u = int.from_bytes(rng.bytes(c.field_bytes + 16), "big") % c.p
            by_branch[_gx1_is_square(c, u)].append(u)
        us = by_branch[True][:LANES] + by_branch[False][:LANES]
        out[name] = (us[0::2], us[1::2])
    return out


@pytest.fixture(scope="module", autouse=True)
def references():
    """tpu_ecc's map for secp256k1 and P-256 in one niced worker process
    that compiles it while the port's tests run; the test that reads it
    comes last."""
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"),
            initializer=os.nice, initargs=(10,)) as pool:
        fut = pool.submit(protocols_reference.h2c_maps, _map_inputs())
        yield functools.lru_cache(maxsize=None)(fut.result)
        pool.shutdown(cancel_futures=True)


def test_vector_file_equals_inline_vectors():
    """tests/vectors/rfc9380_h2c.json holds tests/test_protocols.py's RFC
    9380 vectors, unchanged (the copy that chip_smoke.py reads)."""
    inline = {**test_protocols.H2C_VECTORS, **test_protocols.H2C_WIDE_VECTORS}
    assert sorted(VECTORS["suites"]) == sorted(inline)
    for name, spec in inline.items():
        suite = VECTORS["suites"][name]
        assert suite["dst"].encode() == spec["dst"]
        assert [(c["msg"].encode(), int(c["x"], 16), int(c["y"], 16)) for c in suite["cases"]] == [
            (m, x if isinstance(x, int) else int(x, 16), y if isinstance(y, int) else int(y, 16))
            for m, x, y in spec["cases"]]


def test_expand_message_xmd_vectors():
    """RFC 9380 K.1 (SHA-256), the two cases that tests/test_protocols.py
    checks."""
    k1 = VECTORS["expand_message_xmd"]
    for case in k1["cases"]:
        out = hash2curve.expand_message_xmd(case["msg"].encode(), k1["dst"].encode(),
                                            case["len_in_bytes"], k1["hash"])
        assert out.hex() == case["uniform_bytes"]


def test_expand_message_xmd_equals_reference():
    """Random messages, DSTs and lengths (one block to many) on the three
    suites' hashes, byte-equal to tpu_ecc's; the same bounds refused."""
    rng = np.random.default_rng(72)
    for hashname in ("sha256", "sha384", "sha512"):
        for _ in range(6):
            msg = rng.bytes(int(rng.integers(0, 300)))
            dst = rng.bytes(int(rng.integers(1, 80)))
            ln = int(rng.integers(1, 600))
            assert hash2curve.expand_message_xmd(msg, dst, ln, hashname) == \
                JH.expand_message_xmd(msg, dst, ln, hashname)
    for args in ((b"", b"d" * 256, 32, "sha256"), (b"", b"d", 70000, "sha256"),
                 (b"", b"d", 256 * 32, "sha256")):
        with pytest.raises(ValueError):
            hash2curve.expand_message_xmd(*args)
        with pytest.raises(ValueError):
            JH.expand_message_xmd(*args)


@pytest.mark.parametrize("name", SUITES)
def test_hash_to_field_and_constants_equal_reference(name):
    """hash_to_field over F_p and F_n, hash_to_scalar and the SSWU
    constants equal tpu_ecc's."""
    c, jc = get_curve(name), j_curve(name)
    assert hash2curve.SUITES[name] == JH.SUITES[name]
    assert hash2curve._sswu_consts(c) == JH._sswu_consts(jc)
    rng = np.random.default_rng(73)
    msgs = [rng.bytes(int(rng.integers(0, 100))) for _ in range(4)]
    dst = b"QUUX-V01-CS02-with-test"
    for m in msgs:
        assert hash2curve.hash_to_field(c, m, dst, 2) == JH.hash_to_field(jc, m, dst, 2)
        assert hash2curve.hash_to_field(c, m, dst, 1, modulus=c.n) == \
            JH.hash_to_field(jc, m, dst, 1, modulus=jc.n)
    assert hash2curve.hash_to_scalar(c, msgs, dst) == JH.hash_to_scalar(jc, msgs, dst)


@pytest.mark.parametrize("name", SUITES)
def test_rfc9380_vectors(name):
    """The suite's final points (J.8.1, J.1.1: two messages; J.2.1, J.3.1:
    five), exactly."""
    suite = VECTORS["suites"][name]
    got = hash2curve.hash_to_curve(get_curve(name), [c["msg"].encode() for c in suite["cases"]],
                                   suite["dst"].encode(), device="cpu")
    assert got == [(int(c["x"], 16), int(c["y"], 16)) for c in suite["cases"]]


def test_k256_isogeny_constants_equal_reference():
    assert (hash2curve.K256_A, hash2curve.K256_B, hash2curve.K256_ISO) == (
        JH.K256_A, JH.K256_B, JH.K256_ISO)


@pytest.mark.parametrize("name", MAP_CURVES)
def test_map_equals_reference(references, name):
    """The device map on u pairs that take both branches of the square test
    (its isogeny on secp256k1, the final add and affine form), limb-equal
    to tpu_ecc's _map_core."""
    c = get_curve(name)
    u0, u1 = _map_inputs()[name]
    x, y, inf = hash2curve._map_core(c, F.fe_from_ints(c.field, u0, "cpu"),
                                     F.fe_from_ints(c.field, u1, "cpu"))
    jx, jy, jinf = references()[name]
    assert np.array_equal(x.limbs.numpy(), jx.astype(np.int64))
    assert np.array_equal(y.limbs.numpy(), jy.astype(np.int64))
    assert inf.tolist() == jinf.tolist() == [False] * LANES
