"""The port's key codecs (SPKI, SEC1 ECPrivateKey, PKCS#8, PEM, JWK), its
DER TLV layer (asn1), serde wire forms and NonZeroScalar against
tpu_ecc's, byte for byte, and the package's top-level names.

Every case of tests/test_keys.py runs here, parametrised the same way, and
each encoding must equal tpu_ecc.encoding.keys' bytes (tolerance: exact).
The encoders that embed a public key derive it: the port on the CPU
through its constant-time comb (`scalarmul.derive_public`, device="cpu"),
tpu_ecc through the host oracle `ec_host.aff_mul` put in place of its
derive for these tests, so no JAX program compiles and the port's derived
key is held against the oracle by the same bytes. The port's derive is
memoised per (curve, d) within a test, as each encoder derives again.

Budget: 30 s for the file at one process.
"""

import functools
import random

import pytest

import tpu_ecc_torch
from pkcs8_fixtures import (P256_PKCS8_PRIVATE_KEY_DER, P256_PKCS8_PUBLIC_KEY_DER,
                            SM2_PKCS8_PRIVATE_KEY_DER, SM2_PKCS8_PUBLIC_KEY_DER)
from tpu_ecc.curves import scalars as JSC
from tpu_ecc.curves.specs import get_curve as j_curve
from tpu_ecc.encoding import asn1 as JA
from tpu_ecc.encoding import keys as JK
from tpu_ecc.encoding import serde as JS
from tpu_ecc.ops import scalarmul as JSM
from tpu_ecc_torch.curves import scalars
from tpu_ecc_torch.curves.specs import get_curve, list_curves
from tpu_ecc_torch.encoding import asn1, keys, serde
from tpu_ecc_torch.ops import scalarmul as SM
from tpu_ecc_torch.utils import ec_host as H


@pytest.fixture(autouse=True)
def derive(monkeypatch):
    """tpu_ecc's derive is the host oracle here; the port's runs on the CPU,
    once per (curve, d)."""
    def oracle(curve, d):
        return H.aff_mul(get_curve(curve.name), d, H.aff_generator(get_curve(curve.name)))

    port = functools.lru_cache(maxsize=None)(SM.derive_public)
    monkeypatch.setattr(JSM, "derive_public", oracle)
    monkeypatch.setattr(SM, "derive_public",
                        lambda curve, d, device=None: port(curve, d, "cpu"))


def _keypair(name, d=0x1234567890ABCDEF1234):
    c = get_curve(name)
    d %= c.n
    pub = H.aff_mul(c, d, H.aff_generator(c))
    return c, j_curve(name), d, pub


@pytest.mark.parametrize("name", ["p256", "secp256k1", "p384", "p521", "sm2"])
def test_spki_roundtrip(name):
    c, jc, d, pub = _keypair(name)
    der = keys.spki_encode(c, pub)
    assert der == JK.spki_encode(jc, pub)
    assert keys.spki_encode(c, pub, compress=True) == JK.spki_encode(jc, pub, True)
    c2, pt = keys.spki_decode(der)
    assert c2 is c and pt == pub
    pem = keys.spki_to_pem(c, pub)
    assert pem == JK.spki_to_pem(jc, pub)
    assert keys.spki_from_pem(pem) == (c, pub)


@pytest.mark.parametrize("name", ["p256", "secp256k1", "p521"])
def test_pkcs8_roundtrip(name):
    c, jc, d, pub = _keypair(name)
    der = keys.pkcs8_encode(c, d)
    assert der == JK.pkcs8_encode(jc, d)
    c2, d2 = keys.pkcs8_decode(der)
    assert c2 is c and d2 == d
    pem = keys.pkcs8_to_pem(c, d)
    assert pem == JK.pkcs8_to_pem(jc, d)
    assert keys.pkcs8_from_pem(pem) == (c, d)
    # SEC1 ECPrivateKey form
    sec1_der = keys.ec_private_key_encode(c, d)
    assert sec1_der == JK.ec_private_key_encode(jc, d)
    assert keys.ec_private_key_encode(c, d, include_curve=False, include_public=False) == \
        JK.ec_private_key_encode(jc, d, include_curve=False, include_public=False)
    assert keys.ec_private_key_decode(sec1_der) == (c, d)
    pem2 = keys.ec_private_key_to_pem(c, d)
    assert pem2 == JK.ec_private_key_to_pem(jc, d)
    assert keys.ec_private_key_from_pem(pem2) == (c, d)


def test_reference_fixtures_decode():
    """Byte-exact interop with the reference's fixture keys."""
    c, d = keys.pkcs8_decode(P256_PKCS8_PRIVATE_KEY_DER)
    assert c.name == "p256" and d == JK.pkcs8_decode(P256_PKCS8_PRIVATE_KEY_DER)[1]
    pub = H.aff_mul(c, d, H.aff_generator(c))
    c2, pt = keys.spki_decode(P256_PKCS8_PUBLIC_KEY_DER)
    assert c2.name == "p256" and pt == pub
    assert keys.spki_encode(c, pub) == P256_PKCS8_PUBLIC_KEY_DER
    assert keys.pkcs8_encode(c, d) == JK.pkcs8_encode(j_curve("p256"), d)

    c, d = keys.pkcs8_decode(SM2_PKCS8_PRIVATE_KEY_DER)
    assert c.name == "sm2"
    pub = H.aff_mul(c, d, H.aff_generator(c))
    c2, pt = keys.spki_decode(SM2_PKCS8_PUBLIC_KEY_DER)
    assert c2.name == "sm2" and pt == pub
    assert keys.spki_encode(c, pub) == SM2_PKCS8_PUBLIC_KEY_DER


@pytest.mark.parametrize("name", ["p256", "secp256k1", "p521"])
def test_jwk_roundtrip(name):
    c, jc, d, pub = _keypair(name)
    j = keys.jwk_encode(c, pub, d)
    assert j == JK.jwk_encode(jc, pub, d)
    c2, pt, d2 = keys.jwk_decode(j)
    assert c2 is c and pt == pub and d2 == d
    j.pop("d")
    assert keys.jwk_decode(j)[2] is None
    with pytest.raises(ValueError):
        keys.jwk_decode({**j, "y": keys._b64url((pub[1] + 1).to_bytes(c.field_bytes, "big"))})


def test_bad_inputs():
    c, jc, d, pub = _keypair("p256")
    der = keys.spki_encode(c, pub)
    for bad in (der + b"\x00", der[:-1]):
        with pytest.raises(asn1.Asn1Error):
            keys.spki_decode(bad)
        with pytest.raises(JA.Asn1Error):
            JK.spki_decode(bad)
    bad = bytearray(keys.pkcs8_encode(c, d))
    bad[4] ^= 1  # corrupt version
    with pytest.raises(asn1.Asn1Error):
        keys.pkcs8_decode(bytes(bad))


def test_asn1_equals_reference():
    """The TLV writer and reader, OIDs of every registered curve, integers
    across byte boundaries, long lengths and PEM, byte-equal to tpu_ecc's;
    the same inputs refused."""
    for name in list_curves():
        oid = get_curve(name).oid
        if oid:
            enc = asn1.encode_oid(oid)
            assert enc == JA.encode_oid(oid)
            assert asn1.decode_oid(enc[2:]) == JA.decode_oid(enc[2:]) == oid
    for v in (0, 1, 127, 128, 255, 256, 2**63, 2**521 - 1):
        assert asn1.encode_integer(v) == JA.encode_integer(v)
    for n in (0, 1, 0x7F, 0x80, 0xFF, 0x100, 0x10000):
        assert asn1.encode_len(n) == JA.encode_len(n)
        blob = asn1.tlv(asn1.OCTET_STRING, b"\xab" * n)
        assert blob == JA.tlv(JA.OCTET_STRING, b"\xab" * n)
        assert asn1.read_tlv(blob, 0) == JA.read_tlv(blob, 0)
    pem = asn1.pem_encode(b"\x01" * 100, "TEST")
    assert pem == JA.pem_encode(b"\x01" * 100, "TEST")
    assert asn1.pem_decode(pem, "TEST") == b"\x01" * 100
    for bad in (b"\x04", b"\x04\x81\x05abcde", b"\x04\x85\x00\x00\x00\x00\x01a", b"\x04\x03ab"):
        with pytest.raises(asn1.Asn1Error):
            asn1.read_tlv(bad, 0)
        with pytest.raises(JA.Asn1Error):
            JA.read_tlv(bad, 0)


@pytest.mark.parametrize("name", list_curves())
def test_serde_equals_reference(name):
    """Scalars, field elements and points (compressed and not, and the
    identity) in both wire forms, byte-equal to tpu_ecc.encoding.serde's,
    and back; out-of-range values refused by both."""
    c, jc = get_curve(name), j_curve(name)
    rng = random.Random(name)
    for human in (True, False):
        for k in (0, 1, c.n - 1, rng.randrange(c.n)):
            w = serde.scalar_to_wire(c, k, human)
            assert w == JS.scalar_to_wire(jc, k, human)
            assert serde.scalar_from_wire(c, w, human) == k
        for x in (0, c.p - 1, rng.randrange(c.p)):
            w = serde.field_to_wire(c, x, human)
            assert w == JS.field_to_wire(jc, x, human)
            assert serde.field_from_wire(c, w, human) == x
        pt = H.aff_mul(c, rng.randrange(1, c.n), H.aff_generator(c))
        for p_ in (pt, None):
            for compress in (True, False):
                w = serde.point_to_wire(c, p_, human, compress)
                assert w == JS.point_to_wire(jc, p_, human, compress)
                assert serde.point_from_wire(c, w, human) == p_
        for mod, fn, jfn in ((c.n, serde.scalar_to_wire, JS.scalar_to_wire),
                             (c.p, serde.field_to_wire, JS.field_to_wire)):
            with pytest.raises(serde.SerdeError):
                fn(c, mod, human)
            with pytest.raises(JS.SerdeError):
                jfn(jc, mod, human)
    w = serde.scalar_to_wire(c, 1).upper()
    assert serde.scalar_from_wire(c, w) == JS.scalar_from_wire(jc, w) == 1
    for bad in (serde.serialize_hex((c.n).to_bytes(c.scalar_bytes, "big")), "zz", "00"):
        with pytest.raises(serde.SerdeError):
            serde.scalar_from_wire(c, bad)
        with pytest.raises(JS.SerdeError):
            JS.scalar_from_wire(jc, bad)


@pytest.mark.parametrize("name", ["secp256k1", "p256", "p521", "sm2"])
def test_nonzero_scalar_equals_reference(name):
    """NonZeroScalar's constructors, bytes, inversion, product and negation
    equal tpu_ecc.curves.scalars' on the same values; 0, n and a wrong
    length refused by both."""
    c = get_curve(name)
    a = scalars.NonZeroScalar.random(name, random.Random(5))
    ja = JSC.NonZeroScalar.random(name, random.Random(5))
    assert a.value == ja.value and a.to_bytes() == ja.to_bytes()
    b = scalars.NonZeroScalar.from_bytes(name, a.to_bytes())
    assert b.value == a.value == int(JSC.NonZeroScalar.from_bytes(name, ja.to_bytes()))
    assert a.invert_vartime().value == ja.invert_vartime().value
    assert (a * 7).value == (ja * 7).value
    assert a.negate().value == ja.negate().value
    assert scalars.invert_vartime(a.value, c.n) == JSC.invert_vartime(ja.value, c.n)
    for mod in (scalars, JSC):
        for v in (0, c.n):
            with pytest.raises(ValueError):
                mod.NonZeroScalar.new(name, v)
        with pytest.raises(ValueError):
            mod.NonZeroScalar.from_bytes(name, b"\x01")
        with pytest.raises(ValueError):
            mod.invert_vartime(0, c.n)
    with pytest.raises(ValueError):
        a * c.n


@pytest.mark.parametrize("name", ["get_curve", "list_curves", "CurveSpec", "FE", "FieldSpec",
                                  "Point", "fe", "points", "scalarmul", "ecdsa", "ecdh",
                                  "schnorr", "sm2", "bign", "hash2curve", "rfc6979", "belt",
                                  "msm", "sec1", "der", "keys", "asn1", "serde"])
def test_top_level_names_resolve(name):
    """The package's names as tpu_ecc's __init__ gives them (the protocol,
    encoding and parallel modules load lazily)."""
    obj = getattr(tpu_ecc_torch, name)
    assert obj is not None
    if isinstance(obj, type(tpu_ecc_torch)):
        assert obj.__name__.startswith("tpu_ecc_torch.")


def test_collectives_not_ported():
    """The name `collectives` gives the port's collectives module
    (parallel/collectives.py), as tpu_ecc's does its own; an unknown name
    raises."""
    mod = tpu_ecc_torch.collectives
    assert mod.__name__ == "tpu_ecc_torch.parallel.collectives"
    assert callable(mod.make_mesh) and callable(mod.ppermute_ring_reduce)
    with pytest.raises(AttributeError):
        tpu_ecc_torch.no_such_name
