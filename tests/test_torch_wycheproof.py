"""The Wycheproof ECDSA vectors (tests/vectors/wycheproof_*.json) through the
port's verify_batch, with the runner semantics of tests/test_wycheproof.py
(k256/src/ecdsa.rs:351-425): parse strict DER, normalise s low on
secp256k1, reject r or s outside (0, n), hash the message with the curve's
digest, verify; no caller-side check of the public key (verify_batch
validates it). Every result must equal the vector's `ok` (tolerance:
exact).

On the CPU (device="cpu", the plain path): secp256k1 and p256 in tier-1,
p224, p384 and p521 marked `slow`, as in the JAX file. On the card (the
`cuda` marker, all five files through the kernels): run with

    python -m pytest --noconftest -m cuda tests/test_torch_wycheproof.py -q

This file imports nothing of JAX, so the card's machine runs it.

Budget: 60 s for the tier-1 cases at one process.
"""

import json
import os

import pytest
import torch

from tpu_ecc_torch.curves.specs import get_curve
from tpu_ecc_torch.encoding import der
from tpu_ecc_torch.ops import kernels
from tpu_ecc_torch.protocols import ecdsa

VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors")
CURVES = ["secp256k1", "p256", "p224", "p384", "p521"]


def _run_wycheproof(name, device):
    """verify_batch over every vector of the file that reaches it, in one
    call; returns the indices whose result differs from the vector's."""
    c = get_curve(name)
    with open(os.path.join(VEC_DIR, f"wycheproof_{name}.json")) as fh:
        vecs = json.load(fh)
    low_s = name in ecdsa.LOW_S_CURVES
    items, results = [], {}
    for i, v in enumerate(vecs):
        try:
            r, s = der.der_to_sig(bytes.fromhex(v["sig"]))
        except der.DerError:
            results[i] = False
            continue
        if low_s and s > c.n // 2:
            s = c.n - s                   # normalize_s, as the k256 runner
        if not (0 < r < c.n and 0 < s < c.n):
            results[i] = False
            continue
        z = ecdsa.digest_to_z(c, ecdsa.hash_msg(c, bytes.fromhex(v["msg"])))
        items.append((i, (int(v["wx"], 16), int(v["wy"], 16)), z, (r, s)))
    oks = ecdsa.verify_batch(c, [it[1] for it in items], [it[2] for it in items],
                             [it[3] for it in items], low_s=False, device=device)
    results.update((it[0], ok) for it, ok in zip(items, oks))
    assert items
    return [i for i, v in enumerate(vecs) if results[i] != v["ok"]]


@pytest.mark.parametrize("name", CURVES[:2])
def test_wycheproof(name):
    fails = _run_wycheproof(name, "cpu")
    assert not fails, f"{name}: {len(fails)} wycheproof mismatches, e.g. {fails[:5]}"


@pytest.mark.slow
@pytest.mark.parametrize("name", CURVES[2:])
def test_wycheproof_slow(name):
    fails = _run_wycheproof(name, "cpu")
    assert not fails, f"{name}: {len(fails)} wycheproof mismatches, e.g. {fails[:5]}"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CURVES)
def test_wycheproof_on_the_card(name):
    """The same vectors through the kernels (ladder and pow at the curve's
    word count)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    kernels.reset_launches()
    fails = _run_wycheproof(name, None)
    assert not fails, f"{name}: {len(fails)} wycheproof mismatches, e.g. {fails[:5]}"
    assert kernels.launches["ladder"] > 0 and kernels.launches["pow"] > 0
