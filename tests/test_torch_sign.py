"""The second slice: batched secp256k1 ECDSA signing, key derivation and
recovery, port against tpu_ecc and the host oracle.

The same inputs, made from a seed, go through tpu_ecc (jitted, on its XLA
path on the CPU, which tpu_ecc's own tests hold bit-equal to its Pallas
kernels) and through the port with device="cpu" (the kernels' plain twins).
Tolerance: exact. tpu_ecc compiles four programs here, each once at B = 8:
mul_by_generator, the sign core and fsqrt on two fields. Recovery is held
against the host oracle and the reference's vectors, not against tpu_ecc's
recover_batch, whose lincomb alone takes minutes to compile on the CPU; the
GLV ladder it runs is held against tpu_ecc in test_torch_ecdsa.py.
"""

import functools
import hashlib
import json
import os
import random

import jax
import numpy as np
import pytest
import torch

from tpu_ecc import native as j_native
from tpu_ecc.curves.specs import get_curve as j_curve
from tpu_ecc.ops import fe as JF
from tpu_ecc.ops import points as JP
from tpu_ecc.ops import scalarmul as JSM
from tpu_ecc.protocols import ecdsa as JE
from tpu_ecc.protocols import rfc6979 as JR
from tpu_ecc.utils.bigint import limbs_np_to_ints
from tpu_ecc_torch import interop, native
from tpu_ecc_torch.curves.specs import get_curve
from tpu_ecc_torch.encoding import der, sec1
from tpu_ecc_torch.ops import fe as F
from tpu_ecc_torch.ops import points as P
from tpu_ecc_torch.ops import scalarmul as SM
from tpu_ecc_torch.protocols import ecdsa as E
from tpu_ecc_torch.protocols import rfc6979
from tpu_ecc_torch.utils import ec_host as H

NAME = "secp256k1"
C = get_curve(NAME)
B = 8
VEC = os.path.join(os.path.dirname(__file__), "vectors", f"ecdsa_{NAME}.json")

# the reference's recovery vectors (k256/src/ecdsa.rs:278-305), as
# tests/test_ecdsa.py uses them: SEC1 key, message, r || s, RecoveryId
RECOVERY_VECTORS = [
    ("021a7a569e91dbf60581509c7fc946d1003b60c7dee85299538db6353538d59574",
     b"example message",
     "ce53abb3721bafc561408ce8ff99c909f7f0b18a2f788649d6470162ab1aa032"
     "3971edc523a6d6453f3fb6128d318d9db1a5ff3386feb1047d9816e780039d52", 0),
    ("036d6caac248af96f6afa7f904f550253a0f3ef3f5aa2fe6838a95b216691468e2",
     b"example message",
     "46c05b6368a44b8810d79859441d819b8e7cdc8bfd371e35c53196f4bcacdb51"
     "35c7facce2a97b95eacba8a586d87b7958aaf8368ab29cee481f76e871dbd9cb", 1),
]


def _rand(rng):
    return int.from_bytes(rng.bytes(32), "big") % (C.n - 1) + 1


@functools.lru_cache(maxsize=None)
def _signed():
    """B keys and digests from a seed, the port's signatures and public
    keys, and tpu_ecc's signatures of the same inputs."""
    rng = np.random.default_rng(21)
    ds = [_rand(rng) for _ in range(B)]
    zs = [int.from_bytes(rng.bytes(32), "big") % C.n for _ in range(B)]
    sigs = E.sign_batch(C, ds, zs, device="cpu")
    pubs = SM.derive_public_batch(C, ds, device="cpu")
    return ds, zs, sigs, pubs, JE.sign_batch(j_curve(NAME), ds, zs)


def test_mul_by_generator_limb_equal():
    """k*G on the comb: the port's genmul twin against tpu_ecc's XLA path
    (padd_mixed with q_identity, then steady), limb for limb, and against
    the host oracle as affine points."""
    n = C.n
    rng = np.random.default_rng(20)
    ks = [0, 1, 9, 16, n - 1, n // 2, _rand(rng), _rand(rng)]    # 9 recodes to 16 - 7
    k_t = SM.pack_scalars(C, ks, "cpu")
    jc = j_curve(NAME)
    ref = np.asarray(jax.jit(lambda k: JP.point_limbs(JP.steady(JSM.mul_by_generator(jc, k))))(
        interop.to_reference_limbs(k_t)))
    got = SM.mul_by_generator(C, k_t)
    np.testing.assert_array_equal(interop.to_reference_limbs(P.point_limbs(P.steady(got))), ref)
    x, y, inf = P.to_affine(got)
    want = [H.aff_mul(C, k, H.aff_generator(C)) for k in ks]
    assert inf.tolist() == [w is None for w in want]
    assert [pt for pt, w in zip(zip(F.fe_to_ints(x), F.fe_to_ints(y)), want) if w] == \
        [w for w in want if w]


def test_gen_tables_rows():
    """Row j of the comb table holds d * 16^j * G for d = 1..8 and the
    dummy G * 16^j at d = 0; one more row than the scalar's windows."""
    xs, ys = SM._gen_tables_np(C)
    f = C.field
    assert xs.shape == (SM.num_windows(C) + 1, 9, f.n_limbs)
    G = H.aff_generator(C)
    for j in (0, 1, xs.shape[0] - 1):
        for d in (0, 1, 8):
            want = H.aff_mul(C, max(d, 1) * 16 ** j, G)
            assert (limbs_np_to_ints(xs[j, d], f.limb_bits)[0],
                    limbs_np_to_ints(ys[j, d], f.limb_bits)[0]) == want


def test_sign_batch_equals_reference():
    """RFC 6979 nonces, low-s on: equal (r, s, recid) integers, and each
    signature is the host oracle's for the same nonce."""
    ds, zs, sigs, _, ref = _signed()
    assert sigs == ref
    for d, z, (r, s, _) in zip(ds, zs, sigs):
        k = rfc6979.generate_k(C.n, d, z.to_bytes(32, "big"))
        assert (r, s) == H.ecdsa_sign(C, d, z, k, low_s=True)
        assert s <= C.n // 2


def test_sign_vectors_fixed_k():
    """The reference's ECDSA_TEST_VECTORS with their fixed k, low-s off."""
    vecs = json.load(open(VEC))
    sigs = E.sign_batch(C, [int(v["d"], 16) for v in vecs],
                        [int(v["m"], 16) % C.n for v in vecs],
                        k_ints=[int(v["k"], 16) for v in vecs], low_s=False, device="cpu")
    assert [(r, s) for r, s, _ in sigs] == [(int(v["r"], 16), int(v["s"], 16)) for v in vecs]


def test_sign_and_verify_batch_msgs():
    """Two messages of one length: SHA-256 on the native batch, then the
    same signatures as signing their digests; verify_batch_msgs accepts
    them and rejects a changed message."""
    rng = np.random.default_rng(22)
    ds = [_rand(rng) for _ in range(2)]
    msgs = [rng.bytes(40) for _ in range(2)]
    zs = [E.digest_to_z(C, hashlib.sha256(m).digest()) for m in msgs]
    got = E.sign_batch_msgs(C, ds, msgs, device="cpu")
    for d, z, (r, s, _) in zip(ds, zs, got):
        k = rfc6979.generate_k(C.n, d, z.to_bytes(32, "big"))
        assert (r, s) == H.ecdsa_sign(C, d, z, k, low_s=True)
    pubs = [H.aff_mul(C, d, H.aff_generator(C)) for d in ds]
    assert E.verify_batch_msgs(C, pubs, [msgs[0], msgs[0][::-1]],
                               [sig[:2] for sig in got], device="cpu") == [True, False]


def test_sign_zero_s_retries_or_raises(monkeypatch):
    """s = 0 (z = -r d mod n): a caller's k raises; an RFC 6979 nonce is
    replaced by the next one (additional data 1), as the reference retries."""
    d, k = 7, 11
    r = H.aff_mul(C, k, H.aff_generator(C))[0] % C.n
    z = -r * d % C.n
    with pytest.raises(ValueError, match="zero"):
        E.sign_batch(C, [d], [z], k_ints=[k], device="cpu")
    monkeypatch.setattr(rfc6979, "generate_k_batch", lambda *a, **kw: [k])
    (r2, s2, _), = E.sign_batch(C, [d], [z], device="cpu")
    k2 = rfc6979.generate_k(C.n, d, z.to_bytes(32, "big"), extra=(1).to_bytes(4, "big"))
    assert (r2, s2) == H.ecdsa_sign(C, d, z, k2, low_s=True)


def test_rfc6979_native_equals_python_and_reference():
    rng = np.random.default_rng(23)
    q = C.n
    xs = [_rand(rng) for _ in range(64)]
    h1s = [rng.bytes(32) for _ in range(64)]
    nat = rfc6979.generate_k_batch(q, xs, h1s)
    py = [rfc6979.generate_k(q, x, h) for x, h in zip(xs, h1s)]
    assert nat == py == [JR.generate_k(q, x, h) for x, h in zip(xs, h1s)]
    # shapes the native batch does not cover take the Python loop
    extra = rfc6979.generate_k_batch(q, xs[:2], h1s[:2], extra=b"\x00\x00\x00\x01")
    assert extra == [JR.generate_k(q, x, h, extra=b"\x00\x00\x00\x01")
                     for x, h in zip(xs[:2], h1s[:2])]
    # HMAC-SM3 on the native batch, against the JAX package's native batch
    assert rfc6979.generate_k_batch(q, xs[:8], h1s[:8], "sm3") == \
        j_native.rfc6979_k_sm3_batch(q, xs[:8], h1s[:8])
    # RFC 6979 A.1.1: the 163-bit sample q and x
    assert rfc6979.generate_k(0x4000000000000000000020108A2E0CC0D99F8A5EF,
                              0x09A4D6792295A7F730FC3F2B49CBC0F62E862272F,
                              hashlib.sha256(b"sample").digest()) == \
        0x23AF4074C90A02B3FE61D286D5C87F425E6BDD81B


def test_native_hashes_equal_hashlib():
    rng = np.random.default_rng(24)
    msgs = [rng.bytes(77) for _ in range(16)]
    assert native.sha256_batch(msgs) == [hashlib.sha256(m).digest() for m in msgs]
    assert E.hash_msgs(C, msgs) == [hashlib.sha256(m).digest() for m in msgs]
    assert native.sm3_batch(msgs) == j_native.sm3_batch(msgs, 77)
    mixed = [b"a", b"bc"]
    assert E.hash_msgs(C, mixed) == [hashlib.sha256(m).digest() for m in mixed]
    assert native.library_path().startswith(native.BUILD_DIR)


def _sqrt_inputs(spec, seed):
    """Squares, non-squares and 0 in the field."""
    rnd = random.Random(seed)
    p = spec.p
    squares = [pow(rnd.randrange(1, p), 2, p) for _ in range(4)]
    nonsq = []
    while len(nonsq) < 3:
        v = rnd.randrange(1, p)
        if pow(v, (p - 1) // 2, p) == p - 1:
            nonsq.append(v)
    return squares + nonsq + [0]


@pytest.mark.parametrize("name,field", [
    pytest.param("secp256k1", "field", id="secp256k1"), pytest.param("p224", "field", id="p224"),
    pytest.param("secp256k1", "scalar", id="secp256k1-n")])
def test_fsqrt_equals_reference(name, field):
    """secp256k1's base field (p = 3 mod 4: one power on the pow kernel's
    twin), p224's (constant-time Tonelli–Shanks) and secp256k1's scalar
    field (n = 1 mod 64: Tonelli–Shanks on a Montgomery field): the root as
    a canonical integer and is_square, against tpu_ecc's jitted fsqrt."""
    spec = getattr(get_curve(name), field)
    jspec = getattr(j_curve(name), field)
    vals = _sqrt_inputs(spec, 25)

    @jax.jit
    def ref(a):
        r, ok = JF.fsqrt(JF.fe_steady(jspec, a))
        return JF.fto_raw_canonical(r), ok

    r_ref, ok_ref = ref(JF.fe_from_ints(jspec, vals).limbs)
    root, ok = F.fsqrt(F.fe_from_ints(spec, vals, "cpu"))
    assert ok.tolist() == np.asarray(ok_ref).tolist() == [True] * 4 + [False] * 3 + [True]
    got = F.fe_to_ints(root)
    assert got == limbs_np_to_ints(np.asarray(r_ref), jspec.limb_bits)
    assert [g * g % spec.p for g in got[:4]] + [got[7]] == vals[:4] + [0]


def test_field_to_scalar_raw():
    """x mod n for x in [0, p), with the flag that x >= n (RecoveryId bit 1)."""
    n, p = C.n, C.p
    xs = [0, 1, n - 1, n, n + 5, p - 1]
    raw, over = F.field_to_scalar_raw(C.field, C.scalar, F.fe_from_ints(C.field, xs, "cpu"))
    s = C.scalar
    assert limbs_np_to_ints(raw.numpy(), s.limb_bits) == [x % n for x in xs]
    assert over.tolist() == [x >= n for x in xs]


def test_recover_batch():
    """The port's own signatures recover their keys; a flipped parity bit
    never gives the original key; r = 0 gives None; the reference's
    recovery vectors pass. One batch of 8 lanes."""
    ds, zs, sigs, pubs, _ = _signed()
    z_in, s_in, want = list(zs[:4]), list(sigs[:4]), list(pubs[:4])
    r, s, recid = sigs[4]
    z_in += [zs[4], zs[5]]
    s_in += [(r, s, recid ^ 1), (0, sigs[5][1], sigs[5][2])]
    for pk_hex, msg, sig_hex, rid in RECOVERY_VECTORS:
        sig = bytes.fromhex(sig_hex)
        z_in.append(E.digest_to_z(C, E.hash_msg(C, msg)))
        s_in.append((int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:], "big"), rid))
    got = E.recover_batch(C, z_in, s_in, device="cpu")
    assert got[:4] == want
    assert got[4] != pubs[4]
    assert got[4] is None or H.on_curve(C, got[4])
    assert got[5] is None
    assert got[6:] == [sec1.decode_point(C, bytes.fromhex(v[0])) for v in RECOVERY_VECTORS]
    assert E.recover_public_key(C, zs[0], *sigs[0], device="cpu") == pubs[0]


def test_derive_public_matches_host_oracle():
    ds, _, _, pubs, _ = _signed()
    assert pubs == [H.aff_mul(C, d, H.aff_generator(C)) for d in ds]


def test_signing_key_der_sec1():
    """Sign -> DER -> VerifyingKey.verify through verifying_key(); the SEC1
    round-trip; from_bytes rejects 0 and n."""
    sk = E.SigningKey.from_bytes(NAME, bytes.fromhex(
        "4c0883a69102937d6231471b5dbb6204fe5129617082792ae468d01a3f362318"))
    assert E.SigningKey.from_bytes(NAME, sk.to_bytes()) == sk
    vk = sk.verifying_key(device="cpu")
    assert vk.point == H.aff_mul(C, sk.d, H.aff_generator(C))
    msg = b"tpu_ecc_torch signs"
    sig = sk.sign(msg, device="cpu")
    r, s = der.der_to_sig(sig)
    assert sk.sign_recoverable(msg, device="cpu")[:2] == (r, s)
    assert vk.verify(msg, sig, device="cpu")
    for compress in (True, False):
        back = E.VerifyingKey.from_sec1_bytes(NAME, vk.to_sec1_bytes(compress))
        assert back.point == vk.point
    for bad in (0, C.n):
        with pytest.raises(ValueError):
            E.SigningKey.from_bytes(NAME, bad.to_bytes(32, "big"))
    assert 0 < E.SigningKey.random(NAME, random.Random(5)).d < C.n


def test_p192_is_verify_only():
    with pytest.raises(NotImplementedError):
        E.sign_batch(get_curve("p192"), [1], [1], device="cpu")
    assert E.SIGN_UNSUPPORTED == JE.SIGN_UNSUPPORTED


def test_entry_points_need_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: E.sign_batch(C, [1], [1]),
                 lambda: SM.derive_public_batch(C, [1]),
                 lambda: E.recover_batch(C, [1], [(1, 1, 0)]),
                 lambda: E.SigningKey(C, 1).sign(b"m"),
                 lambda: E.SigningKey(C, 1).verifying_key()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
