"""SM2-DSA (GB/T 32918) and bign-DSA (STB 34.101.45) of the port, with
belt-hash (STB 34.101.31), against tpu_ecc and the published vectors.

The same inputs go through tpu_ecc and through the port with device="cpu"
(the kernels' plain twins). Tolerance: exact, on integers and bytes. The
host parts (Z_A, SM3 of Z_A || M, belt-hash and its batch) are compared
with tpu_ecc's in this process; tpu_ecc's two signing programs (SM2 at the
caller's k, bign with its deterministic nonces) compile in one niced
worker process (tests/protocols_reference.py) that starts with the
module. The vectors are those of tests/test_protocols.py (GB/T 32918.5
appendix A; an OpenSSL signature under a custom identifier) and
tests/test_bign.py (STB 34.101.31 A.1 and A.7; bign256/tests/dsa.rs).

Budget: 150 s for the file at one process.
"""

import concurrent.futures
import functools
import multiprocessing
import os

import numpy as np
import pytest

import protocols_reference
from tpu_ecc.curves.specs import get_curve as j_curve
from tpu_ecc.protocols import belt as JBELT
from tpu_ecc.protocols import sm2 as JSM2
from tpu_ecc_torch.curves.specs import get_curve
from tpu_ecc_torch.ops import scalarmul as SM
from tpu_ecc_torch.protocols import belt, bign, sm2
from tpu_ecc_torch.utils import ec_host as H
from tpu_ecc_torch.utils.bigint import be_bytes_to_int

SM2 = get_curve("sm2")
BIGN = get_curve("bign256")
GBT_D = 0x3945208F7B2144B13F36E38AC6D39F95889393692860B51A42FB81EF4DF7C5B8
GBT_PUB = (0x09F9DF311E5421A150DD7D161E4BC5C672179FAD1833FC076BB08FF356F35020,
           0xCCEA490CE26775A52DC6EA718CC1AA600AED05FBF35E084A6632F6072DA9AD13)
# openssl pkeyutl -sign -digest sm3 -pkeyopt distid:example@rustcrypto.org
# (sm2/tests/sm2dsa.rs:16-31)
SSL_PUB = (0x08D77AE04C01CC4C1104360DD8AF6B6F7DF334283D7C1A6AFD5652407B87BEE5,
           0x014E2A57C36C150D16324DC664E31E6432359609C4E79847A5B161C8C7364C8A)
SSL_ID = b"example@rustcrypto.org"
SSL_SIG = (0xD1DCCCEDD9FB785E0F67C16B7C52901625C0B69DE9BCA2144ACC7BE713CAD2FC,
           0xF7D1EAE6E3A157B36C65F672F738CA8B46298BF149A6510072C431B49CD88B1C)
# bign256/tests/dsa.rs:16-25
BIGN_PUB = bytes.fromhex(
    "04D07F8590A8F77BF84F1EF10C6DE44CF5DDD52B4C9DE4CE3FE0799D1750561ABD"
    "909AD9B92A4DB89A4A050959DA2E0C1926281B466D68913417C8E86103A6C67A")
BIGN_SIG = bytes.fromhex(
    "63F59C523FF1780851143114FFBC5C139BE81FF88F9D7F7FE209A6914198044C"
    "2A41D37B8439AAB42983FDB04AC2C326")
B = 3


@functools.lru_cache(maxsize=None)
def _inputs():
    """B SM2 (d, e, k) and B bign (d, message) from a seed."""
    rng = np.random.default_rng(23)

    def scalar(n):
        return int.from_bytes(rng.bytes(40), "big") % (n - 1) + 1

    sm = [tuple(scalar(SM2.n) for _ in range(3)) for _ in range(B)]
    bg = [(scalar(BIGN.n), rng.bytes(int(rng.integers(0, 70)))) for _ in range(B)]
    return sm, bg


@pytest.fixture(scope="module", autouse=True)
def references():
    """tpu_ecc's SM2 and bign signing programs, one after the other in one
    niced worker process that compiles them while the port's tests run;
    the tests that read them come last."""
    sm, bg = _inputs()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"),
            initializer=os.nice, initargs=(10,)) as pool:
        futs = {"sm2": pool.submit(protocols_reference.sm2_sign, *map(list, zip(*sm))),
                "bign": pool.submit(protocols_reference.bign_sign, *map(list, zip(*bg)))}
        yield {k: functools.lru_cache(maxsize=None)(f.result) for k, f in futs.items()}
        pool.shutdown(cancel_futures=True)


# ---------------------------------------------------------------------------
# SM2
# ---------------------------------------------------------------------------

def test_sm2_z_a_and_hashes_equal_reference():
    """Z_A under the default and a custom identifier, and SM3(Z_A || M) for
    messages of several lengths in one batch, byte-equal to tpu_ecc's."""
    jc = j_curve("sm2")
    pubs = [GBT_PUB, SSL_PUB, GBT_PUB, SSL_PUB]
    msgs = [b"message digest", b"testing", b"", b"x" * 100]
    for ident in (sm2.DEFAULT_ID, SSL_ID):
        for q in pubs[:2]:
            assert sm2.z_a(SM2, q, ident) == JSM2.z_a(jc, q, ident)
        assert sm2.hash_msg_batch(SM2, pubs, msgs, ident) == JSM2.hash_msg_batch(
            jc, pubs, msgs, ident)
        assert sm2.hash_msg(SM2, pubs[0], msgs[0], ident) == JSM2.hash_msg(
            jc, pubs[0], msgs[0], ident)


GBT_MSG = b"message digest"


@functools.lru_cache(maxsize=None)
def _gbt_key_and_signature():
    """The GB/T 32918.5 key, and its signature of GBT_MSG (RFC 6979 with
    SM3), on the CPU."""
    sk = sm2.SigningKey(SM2, GBT_D)
    return sk, sk.sign(GBT_MSG, device="cpu")


def test_sm2_gbt_vector():
    """GB/T 32918.5 appendix A: the key's public point, and its signature
    accepted through the key objects."""
    sk, (r, s) = _gbt_key_and_signature()
    assert sk.public_point(device="cpu") == GBT_PUB
    assert sk.verifying_key(device="cpu").verify(GBT_MSG, r, s, device="cpu")


def test_sm2_openssl_interop_vector():
    """An OpenSSL signature under a custom identifier is accepted; in one
    batch, a bit of r flipped, another message and the default identifier
    (Z_A differs) are refused, and so are the GB/T signature with its
    message changed or a bit of s flipped."""
    r, s = SSL_SIG
    assert sm2.VerifyingKey(SM2, SSL_PUB, ident=SSL_ID).verify(b"testing", r, s, device="cpu")
    _, (gr, gs) = _gbt_key_and_signature()
    lanes = [(SSL_PUB, b"testing", SSL_ID, (r ^ 1, s)), (SSL_PUB, b"testingx", SSL_ID, (r, s)),
             (SSL_PUB, b"testing", sm2.DEFAULT_ID, (r, s)),
             (GBT_PUB, GBT_MSG + b"x", sm2.DEFAULT_ID, (gr, gs)),
             (GBT_PUB, GBT_MSG, sm2.DEFAULT_ID, (gr, gs ^ 1))]
    es = [be_bytes_to_int(sm2.hash_msg(SM2, q, m, ident)) for q, m, ident, _ in lanes]
    assert sm2.verify_batch(SM2, [q for q, *_ in lanes], es, [sig for *_, sig in lanes],
                            device="cpu") == [False] * len(lanes)


def test_sm2_verify_batch_roundtrip():
    """sign_batch at the caller's k verifies under the derived keys in one
    batch; a tampered digest, s + 1 and r = 0 are refused in the same batch."""
    sm, _ = _inputs()
    ds, es, ks = map(list, zip(*sm))
    sigs = sm2.sign_batch(SM2, ds, es, k_ints=ks, device="cpu")
    pubs = SM.derive_public_batch(SM2, ds, device="cpu")
    bad = [(sigs[1][0], (sigs[1][1] + 1) % SM2.n), (0, sigs[2][1])]
    got = sm2.verify_batch(SM2, pubs + pubs[:3], es + [es[0] + 1] + es[1:3],
                           sigs + sigs[:1] + bad, device="cpu")
    assert got == [True] * B + [False] * 3


# ---------------------------------------------------------------------------
# bign and belt-hash
# ---------------------------------------------------------------------------

def test_belt_vectors():
    """STB 34.101.31 A.1 (the block cipher, also checked at import) and A.7
    (belt-hash of the 32-byte test string)."""
    assert belt.BLOCK_SELFTEST_OK
    x = bytes.fromhex("b194bac80a08f53b366d008e584a5de4")
    k = bytes.fromhex("e9dee72c8f0c0fa62ddb49f46f73964706075316ed247a3739cba38303a98bf6")
    assert belt.belt_block_encrypt(x, k).hex() == "69cca1c93557c9e3d66bc3e0fa88fa6e"
    m = bytes.fromhex("b194bac80a08f53b366d008e584a5de48504fa9d1bb6c7ac252e72c202fdce0d")
    assert belt.belt_hash(m).hex() == (
        "749e4c3653aece5e48db4761227742eb6dbe13f4a80f7beff1a9cf8d10ee7786")


def test_belt_hash_batch_equals_reference():
    """The native batch over messages of lengths 0 to 95 equals tpu_ecc's
    batch and the port's Python belt-hash, byte for byte."""
    rng = np.random.default_rng(24)
    msgs = [rng.bytes(n) for n in range(0, 96, 7)]
    got = belt.belt_hash_batch(msgs)
    assert got == JBELT.belt_hash_batch(msgs) == [belt.belt_hash(m) for m in msgs]
    assert belt.belt_hash_batch(msgs[1:2]) == [JBELT.belt_hash(msgs[1])]


def test_bign_nonce_native_equals_python():
    """RFC 6979 with HMAC-belt-hash: the native batch equals the Python
    loop."""
    _, bg = _inputs()
    ds = [d for d, _ in bg]
    h1s = [belt.belt_hash(m) for _, m in bg]
    assert bign._generate_k_belt_batch(BIGN.n, ds, h1s) == [
        bign._generate_k_belt(BIGN.n, d, h) for d, h in zip(ds, h1s)]


def test_bign_reference_vector():
    """bign256/tests/dsa.rs: accepted through the key objects (its refusals
    ride in test_bign_roundtrip_and_truncated_rejected's batch)."""
    vk = bign.VerifyingKey.from_sec1_bytes(BIGN_PUB)
    assert vk.verify(b"testing", BIGN_SIG, device="cpu")


def test_bign_roundtrip_and_truncated_rejected():
    """sign_batch verifies in one batch under the derived keys; in the same
    batch a truncated signature, and the reference signature with a bit
    flipped or under another message, are refused."""
    _, bg = _inputs()
    ds, msgs = [d for d, _ in bg], [m for _, m in bg]
    sigs = bign.sign_batch(BIGN, ds, msgs, device="cpu")
    pubs = SM.derive_public_batch(BIGN, ds, device="cpu")
    ref = bign.VerifyingKey.from_sec1_bytes(BIGN_PUB).point
    bad = bytearray(BIGN_SIG)
    bad[5] ^= 1
    got = bign.verify_batch(BIGN, pubs + [pubs[0], ref, ref],
                            msgs + [msgs[0], b"testing", b"testing!"],
                            sigs + [sigs[0][:-1], bytes(bad), BIGN_SIG], device="cpu")
    assert got == [True] * B + [False] * 3
    assert pubs == [H.aff_mul(BIGN, d, H.aff_generator(BIGN)) for d in ds]


# ---------------------------------------------------------------------------
# against tpu_ecc's programs (last: they wait for the worker processes)
# ---------------------------------------------------------------------------

def test_sm2_sign_equals_reference(references):
    """(r, s) at the caller's k equal tpu_ecc.protocols.sm2.sign_batch's on
    the same d, e and k, and the host formula's."""
    sm, _ = _inputs()
    ds, es, ks = map(list, zip(*sm))
    got = sm2.sign_batch(SM2, ds, es, k_ints=ks, device="cpu")
    assert got == references["sm2"]()
    n = SM2.n
    for d, e, k, (r, s) in zip(ds, es, ks, got):
        x1 = H.aff_mul(SM2, k, H.aff_generator(SM2))[0]
        assert r == (e + x1) % n and s == pow(1 + d, -1, n) * (k - r * d) % n


def test_bign_sign_equals_reference(references):
    """The signature bytes equal tpu_ecc.protocols.bign.sign_batch's on the
    same d and messages (the nonce is deterministic)."""
    _, bg = _inputs()
    ds, msgs = [d for d, _ in bg], [m for _, m in bg]
    assert bign.sign_batch(BIGN, ds, msgs, device="cpu") == references["bign"]()


def test_sm2_signing_key_hashes_with_its_identifier():
    """SigningKey.sign signs e = SM3(Z_A || M) under the key's identifier:
    its signature satisfies the verify equation for tpu_ecc's e on the
    host, (e + x(s G + (r + s) P)) mod n == r."""
    sk = sm2.SigningKey(SM2, GBT_D, ident=SSL_ID, _pub=GBT_PUB)
    r, s = sk.sign(b"abc", device="cpu")
    e = be_bytes_to_int(JSM2.hash_msg(j_curve("sm2"), GBT_PUB, b"abc", SSL_ID))
    n, G = SM2.n, H.aff_generator(SM2)
    x1 = H.aff_add(SM2, H.aff_mul(SM2, s, G), H.aff_mul(SM2, (r + s) % n, GBT_PUB))[0]
    assert (e + x1) % n == r
