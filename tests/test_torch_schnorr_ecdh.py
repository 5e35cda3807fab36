"""Schnorr (BIP340) and ECDH of the port, with Keccak-256 and the host GLV
API, against tpu_ecc, the published vectors and the host oracle.

The same inputs, made from a seed, go through tpu_ecc and through the port
with device="cpu" (the kernels' plain twins). Tolerance: exact, on
integers, bytes and booleans. The host parts (tagged hashes, lift_x,
keccak256, glv_decompose) are compared with tpu_ecc's in this process;
tpu_ecc's jitted Schnorr signing program compiles in one niced worker
process (tests/protocols_reference.py) that starts with the module. The
BIP340 vectors come from tests/vectors/bip340.json, held equal here to
tests/test_protocols.py's inline copy; the ECDH adversarial lanes are those
of tests/test_protocols.py:26-45; the Ethereum case is
tests/test_ecdsa.py's (k256/src/ecdsa.rs:317-343).

Budget: 150 s for the file at one process.
"""

import concurrent.futures
import functools
import hashlib
import json
import multiprocessing
import os
import pathlib

import numpy as np
import pytest

import protocols_reference
import test_protocols
from tpu_ecc.curves.specs import get_curve as j_curve
from tpu_ecc.ops import scalarmul as JSM
from tpu_ecc.protocols import ecdh as JECDH
from tpu_ecc.protocols import schnorr as JSCH
from tpu_ecc.utils.keccak import keccak256 as j_keccak256
from tpu_ecc_torch.curves.specs import get_curve
from tpu_ecc_torch.ops import fe as F
from tpu_ecc_torch.ops import points as P
from tpu_ecc_torch.ops import scalarmul as SM
from tpu_ecc_torch.protocols import ecdh, ecdsa, schnorr
from tpu_ecc_torch.utils import ec_host as H
from tpu_ecc_torch.utils.keccak import keccak256

K1 = get_curve("secp256k1")
VECTORS = json.loads((pathlib.Path(__file__).parent / "vectors" / "bip340.json").read_text())
B = 4


def bip340_sign_host(d: int, msg: bytes, aux: bytes) -> bytes:
    """BIP340's reference signing algorithm on the host oracle (hashlib and
    ec_host.aff_mul)."""
    def tagged(tag, data):
        th = hashlib.sha256(tag.encode()).digest()
        return hashlib.sha256(th + th + data).digest()

    n, G = K1.n, H.aff_generator(K1)
    px, py = H.aff_mul(K1, d, G)
    d = n - d if py & 1 else d
    t = d ^ int.from_bytes(tagged("BIP0340/aux", aux), "big")
    pb = px.to_bytes(32, "big")
    k = int.from_bytes(tagged("BIP0340/nonce", t.to_bytes(32, "big") + pb + msg), "big") % n
    rx, ry = H.aff_mul(K1, k, G)
    k = n - k if ry & 1 else k
    rb = rx.to_bytes(32, "big")
    e = int.from_bytes(tagged("BIP0340/challenge", rb + pb + msg), "big") % n
    return rb + ((k + e * d) % n).to_bytes(32, "big")


@functools.lru_cache(maxsize=None)
def _inputs():
    """The sign vectors' (d, msg, aux), then B random lanes from a seed
    (messages of several lengths, so the tagged hashes take both paths)."""
    sv = VECTORS["sign"]
    ds = [int(v["seckey"], 16) for v in sv]
    msgs = [bytes.fromhex(v["msg"]) for v in sv]
    auxs = [bytes.fromhex(v["aux_rand"]) for v in sv]
    rng = np.random.default_rng(61)
    for ln in (0, 32, 45, 100)[:B]:
        ds.append(int.from_bytes(rng.bytes(32), "big") % (K1.n - 1) + 1)
        msgs.append(rng.bytes(ln))
        auxs.append(rng.bytes(32))
    return ds, msgs, auxs


@functools.lru_cache(maxsize=None)
def _signed():
    ds, msgs, auxs = _inputs()
    return schnorr.sign_batch(K1, ds, msgs, auxs, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def references():
    """tpu_ecc's Schnorr signing program in one niced worker process that
    compiles it while the port's tests run; the test that reads it comes
    last."""
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"),
            initializer=os.nice, initargs=(10,)) as pool:
        fut = pool.submit(protocols_reference.schnorr_sign, *_inputs())
        yield {"schnorr": functools.lru_cache(maxsize=None)(fut.result)}
        pool.shutdown(cancel_futures=True)


# ---------------------------------------------------------------------------
# Schnorr (BIP340)
# ---------------------------------------------------------------------------

def test_vector_file_equals_inline_vectors():
    """tests/vectors/bip340.json holds tests/test_protocols.py's BIP340
    vectors, unchanged (the copy that chip_smoke.py reads)."""
    assert [(v["seckey"], v["aux_rand"], v["msg"], v["sig"]) for v in VECTORS["sign"]] == [
        tuple(v) for v in test_protocols.BIP340_VECTORS]
    assert [v["index"] for v in VECTORS["sign"]] == list(range(len(VECTORS["sign"])))
    assert [(v["index"], v["pubkey"], v["msg"], v["sig"], v["valid"], v["comment"])
            for v in VECTORS["verify"]] == [tuple(v) for v in test_protocols.BIP340_VERIFY_VECTORS]


def test_tagged_hashes_equal_reference():
    """tagged_hash, and tagged_hash_batch over one length (the native
    batch) and over mixed lengths (hashlib), byte-equal to tpu_ecc's."""
    rng = np.random.default_rng(62)
    uniform = [rng.bytes(96) for _ in range(5)]
    mixed = [rng.bytes(n) for n in (0, 1, 31, 64, 200)]
    for tag in ("BIP0340/aux", "BIP0340/nonce", "BIP0340/challenge", "other"):
        for datas in (uniform, mixed, mixed[:1]):
            assert schnorr.tagged_hash_batch(tag, datas) == JSCH.tagged_hash_batch(tag, datas)
        assert schnorr.tagged_hash(tag, mixed[3]) == JSCH.tagged_hash(tag, mixed[3])
        assert schnorr._tag_prefix(tag) == JSCH._tag_prefix(tag)


def test_lift_x_equals_reference():
    """lift_x on random x (about half of them not on the curve) and on the
    range edges equals tpu_ecc's."""
    jc = j_curve("secp256k1")
    rng = np.random.default_rng(63)
    xs = [int.from_bytes(rng.bytes(32), "big") for _ in range(24)] + [0, 1, K1.p - 1, K1.p,
                                                                      K1.gx]
    got = [schnorr.lift_x(K1, x) for x in xs]
    assert got == [JSCH.lift_x(jc, x) for x in xs]
    assert any(g is None for g in got[:24]) and any(g is not None for g in got[:24])
    assert all(g is None or g[1] % 2 == 0 for g in got)


def test_bip340_sign_vectors():
    """Sign vectors 0-3, byte for byte (in one batch with random lanes)."""
    assert [s.hex().upper() for s in _signed()[:len(VECTORS["sign"])]] == [
        v["sig"] for v in VECTORS["sign"]]


def test_sign_and_keys_equal_host_oracle():
    """The random lanes' signatures equal the pure-Python BIP340 signer's,
    and xonly_public_keys equals x(d*G) by the host oracle."""
    ds, msgs, auxs = _inputs()
    nv = len(VECTORS["sign"])
    assert _signed()[nv:] == [bip340_sign_host(*a) for a in zip(ds[nv:], msgs[nv:], auxs[nv:])]
    assert schnorr.xonly_public_keys(K1, ds, device="cpu") == [
        H.aff_mul(K1, d, H.aff_generator(K1))[0] for d in ds]


def test_verify_vectors_and_tampered():
    """One batch: the sign vectors' signatures and the random lanes' accepted;
    verify vectors 4-14 as the BIP says (5: the key's x not on the curve,
    its root computed and refused on the device); a bit flipped in r, in s,
    in the message, and a short signature refused."""
    ds, msgs, auxs = _inputs()
    sigs = _signed()
    pxs = [H.aff_mul(K1, d, H.aff_generator(K1))[0] for d in ds]
    lanes = [(px, m, s, True) for px, m, s in zip(pxs, msgs, sigs)]
    for i, kind in zip(range(len(ds)), ("r", "s", "msg", "len")):
        sig, m = bytearray(sigs[i]), msgs[i]
        if kind == "msg":
            m = m + b"\x00"
        elif kind == "len":
            sig = sig[:-1]
        else:
            sig[3 if kind == "r" else 60] ^= 1
        lanes.append((pxs[i], m, bytes(sig), False))
    for v in VECTORS["verify"]:
        lanes.append((int(v["pubkey"], 16), bytes.fromhex(v["msg"]), bytes.fromhex(v["sig"]),
                      v["valid"]))
    got = schnorr.verify_batch(K1, *map(list, zip(*[lane[:3] for lane in lanes])),
                               device="cpu")
    assert got == [lane[3] for lane in lanes]


def test_key_api():
    """SigningKey and VerifyingKey: vector 1 through sign_with_aux_rand,
    the verifying key from the device comb, its bytes and verify; an
    invalid secret and an x-only key off the curve refused."""
    v = VECTORS["sign"][1]
    sk = schnorr.SigningKey.from_bytes(bytes.fromhex(v["seckey"]))
    sig = sk.sign_with_aux_rand(bytes.fromhex(v["msg"]), bytes.fromhex(v["aux_rand"]),
                                device="cpu")
    assert sig.hex().upper() == v["sig"]
    vk = sk.verifying_key(device="cpu")
    assert vk.x == H.aff_mul(K1, sk.d, H.aff_generator(K1))[0]
    vk2 = schnorr.VerifyingKey.from_bytes(vk.to_bytes())
    assert vk2 == vk and vk.to_bytes() == JSCH.VerifyingKey(j_curve("secp256k1"), vk.x).to_bytes()
    assert vk2.verify(bytes.fromhex(v["msg"]), sig, device="cpu")
    with pytest.raises(ValueError):
        schnorr.SigningKey.from_bytes(bytes(32))
    with pytest.raises(ValueError):
        schnorr.VerifyingKey.from_bytes(bytes.fromhex(VECTORS["verify"][1]["pubkey"]))


# ---------------------------------------------------------------------------
# ECDH
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["secp256k1", "p256"])
def test_ecdh_agreement_and_adversarial_lanes(name):
    """One batch: both sides of B key pairs agree and equal the host
    oracle's x((a b mod n) G); an off-curve peer, a peer with x >= p and d
    = n give None in the same batch (tests/test_protocols.py:26-45)."""
    c = get_curve(name)
    n, p, G = c.n, c.p, H.aff_generator(c)
    rng = np.random.default_rng(64)
    da, db = ([int.from_bytes(rng.bytes(32), "big") % (n - 1) + 1 for _ in range(B)]
              for _ in range(2))
    pubs = SM.derive_public_batch(c, da + db, device="cpu")
    pa, pb = pubs[:B], pubs[B:]
    good = H.aff_mul(c, 7, G)
    bad_peers = [(good[0], (good[1] + 1) % p), (good[0] + p, good[1]), good]
    got = ecdh.diffie_hellman_batch(c, da + db + [da[0], da[0], n], pb + pa + bad_peers,
                                    device="cpu")
    want = [H.aff_mul(c, a * b % n, G)[0] for a, b in zip(da, db)]
    assert got == want + want + [None, None, None]


def test_ephemeral_secret_and_shared_secret():
    """EphemeralSecret's public key from the device comb, its shared secret
    and HKDF-extract (equal to tpu_ecc's SharedSecret on the same bytes),
    and an off-curve peer refused."""
    c = K1
    a = ecdh.EphemeralSecret(c, 0xC0FFEE * 0x1234567)
    peer = H.aff_mul(c, 0xBEEF, H.aff_generator(c))
    assert a.public_key(device="cpu") == H.aff_mul(c, a.d, H.aff_generator(c))
    assert a.public_key_bytes(device="cpu")[0] in (2, 3)
    s = a.diffie_hellman(peer, device="cpu")
    assert s.raw_secret_bytes() == H.aff_mul(c, a.d * 0xBEEF % c.n,
                                             H.aff_generator(c))[0].to_bytes(32, "big")
    js = JECDH.SharedSecret(j_curve("secp256k1"), s.raw)
    for salt in (b"", b"salt"):
        for hashname in ("sha256", "sha512"):
            assert s.extract(hashname, salt) == js.extract(hashname, salt)
    with pytest.raises(ValueError):
        a.diffie_hellman((peer[0], (peer[1] + 1) % c.p), device="cpu")


# ---------------------------------------------------------------------------
# Keccak-256 and the Ethereum case; the host GLV API
# ---------------------------------------------------------------------------

def test_keccak256_equals_reference():
    """Random lengths from 0 to 300 bytes, across the 136-byte rate."""
    rng = np.random.default_rng(65)
    for ln in [0, 1, 135, 136, 137, 271, 272, 300] + [int(v) for v in rng.integers(0, 301, 12)]:
        m = rng.bytes(ln)
        assert keccak256(m) == j_keccak256(m)
    assert keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")


def test_ethereum_end_to_end():
    """k256/src/ecdsa.rs:317-343 through the port: RFC 6979 over a
    Keccak-256 digest, the low-s signature byte-equal to the reference's,
    and recovery giving back the key."""
    c = K1
    sk = ecdsa.SigningKey.from_bytes(
        "secp256k1",
        bytes.fromhex("4c0883a69102937d6231471b5dbb6204fe5129617082792ae468d01a3f362318"))
    msg = bytes.fromhex(
        "e9808504e3b29200831e848094f0109fc8df283027b6285cc889f5aa624eac1f"
        "55843b9aca0080018080")
    digest = keccak256(msg)
    r, s, recid = sk.sign_prehash(digest, device="cpu")
    assert r.to_bytes(32, "big") + s.to_bytes(32, "big") == bytes.fromhex(
        "c9cf86333bcb065d140032ecaab5d9281bde80f21b9687b3e94161de42d51895"
        "727a108a0b8d101465414033c3f705a9c7b826e596766046ee1183dbc8aeaa68")
    assert recid == 0
    z = ecdsa.digest_to_z(c, digest)
    assert ecdsa.recover_public_key(c, z, r, s, recid, device="cpu") == H.aff_mul(
        c, sk.d, H.aff_generator(c))


def test_glv_decompose_equals_reference():
    """The host split equals tpu_ecc's on random k and on 0, 1, lambda and
    n - 1, and recombines to k."""
    jc = j_curve("secp256k1")
    n, lam = K1.n, K1.glv["lam"]
    rng = np.random.default_rng(66)
    for k in [0, 1, lam, n - 1] + [int.from_bytes(rng.bytes(32), "big") % n for _ in range(32)]:
        got = SM.glv_decompose(K1, k)
        assert got == JSM.glv_decompose(jc, k)
        a1, s1, a2, s2 = got
        assert (s1 * a1 + s2 * a2 * lam) % n == k
        assert max(a1, a2).bit_length() <= 129


def test_scalar_mul_glv_equals_scalar_mul():
    """scalar_mul_glv (one base through the GLV split on the ladder) is
    affine-equal to the ladder without the split, scalar_mul at 256 bits,
    and to the host oracle, with k = 0 and n - 1 among the lanes."""
    rng = np.random.default_rng(67)
    n, G = K1.n, H.aff_generator(K1)
    qs = [H.aff_mul(K1, int(v), G) for v in rng.integers(1, 2**62, B)]
    ks = [0, n - 1] + [int.from_bytes(rng.bytes(32), "big") % n for _ in range(B - 2)]
    Q = P.from_affine_ints(K1, [q[0] for q in qs], [q[1] for q in qs], "cpu")
    k = SM.pack_scalars(K1, ks, "cpu")

    def affine(R):
        x, y, inf = P.to_affine(R)
        return [None if i else (a, b) for a, b, i in zip(F.fe_to_ints(x), F.fe_to_ints(y),
                                                        inf.tolist())]

    got = affine(SM.scalar_mul_glv(Q, k))
    assert got == affine(SM.scalar_mul(Q, k, scalar_bits=256))
    assert got == [H.aff_mul(K1, kk, q) for kk, q in zip(ks, qs)]


# ---------------------------------------------------------------------------
# against tpu_ecc's program (last: it waits for the worker process)
# ---------------------------------------------------------------------------

def test_sign_equals_reference(references):
    """The signatures equal tpu_ecc.protocols.schnorr.sign_batch's on the
    same (d, msg, aux), vectors and random lanes."""
    assert _signed() == references["schnorr"]()
