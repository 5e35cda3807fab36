"""tpu_ecc's SM2 and bign signatures for tests/test_torch_sm2_bign.py,
computed in worker processes. This module imports jax and tpu_ecc only (no
torch, nothing of the port), so a worker starts quickly; inputs and outputs
are host ints and bytes."""

from tpu_ecc.curves.specs import get_curve
from tpu_ecc.protocols import bign as JB
from tpu_ecc.protocols import sm2 as JS


def sm2_sign(ds, es, ks):
    """tpu_ecc.protocols.sm2.sign_batch with the caller's nonces: [(r, s)]."""
    return JS.sign_batch(get_curve("sm2"), ds, es, k_ints=ks)


def bign_sign(ds, msgs):
    """tpu_ecc.protocols.bign.sign_batch (deterministic nonces): 48-byte
    signatures."""
    return JB.sign_batch(get_curve("bign256"), ds, msgs)
