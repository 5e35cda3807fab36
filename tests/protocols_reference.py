"""tpu_ecc's protocol results for the port's protocol tests
(tests/test_torch_sm2_bign.py, tests/test_torch_schnorr_ecdh.py,
tests/test_torch_hash2curve.py), computed in worker processes. This module
imports jax and tpu_ecc only (no torch, nothing of the port), so a worker
starts quickly; inputs and outputs are host ints, bytes and numpy arrays."""

import numpy as np

from tpu_ecc.curves.specs import get_curve
from tpu_ecc.ops import fe as JF
from tpu_ecc.protocols import bign as JB
from tpu_ecc.protocols import hash2curve as JH
from tpu_ecc.protocols import schnorr as JSC
from tpu_ecc.protocols import sm2 as JS


def sm2_sign(ds, es, ks):
    """tpu_ecc.protocols.sm2.sign_batch with the caller's nonces: [(r, s)]."""
    return JS.sign_batch(get_curve("sm2"), ds, es, k_ints=ks)


def bign_sign(ds, msgs):
    """tpu_ecc.protocols.bign.sign_batch (deterministic nonces): 48-byte
    signatures."""
    return JB.sign_batch(get_curve("bign256"), ds, msgs)


def schnorr_sign(ds, msgs, auxs):
    """tpu_ecc.protocols.schnorr.sign_batch: 64-byte BIP340 signatures."""
    return JSC.sign_batch(get_curve("secp256k1"), ds, msgs, auxs)


def h2c_maps(cases):
    """tpu_ecc's hash-to-curve map (`_map_core`, its jitted program) for
    each {curve name: (u0 ints, u1 ints)} -> {name: (x limbs, y limbs,
    is_identity)} as numpy arrays."""
    out = {}
    for name, (u0, u1) in cases.items():
        c = get_curve(name)
        x, y, inf = JH._map_core(c)(JF.fe_from_ints(c.field, u0), JF.fe_from_ints(c.field, u1))
        out[name] = (np.asarray(x.limbs), np.asarray(y.limbs), np.asarray(inf))
    return out
