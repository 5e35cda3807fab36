"""tpu_ecc_torch: batched elliptic-curve cryptography in PyTorch, with its hot
loops as hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of `tpu_ecc` (the JAX/TPU package beside it, which stays the
reference). It keeps tpu_ecc's limb plan, layouts and algorithms, so every
result can be compared with tpu_ecc's limb for limb. This package imports
neither jax nor tpu_ecc.

Entry points take `device=None`, which means the CUDA card; pass
`device="cpu"` to run the plain PyTorch path (the tests do).

Quick start:

    from tpu_ecc_torch import get_curve, ecdsa
    sigs = ecdsa.sign_batch(get_curve("p256"), d_list, z_list)
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Raises when the card is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpu_ecc_torch: no CUDA device available; pass device='cpu' to "
            "run the plain PyTorch path")
    return dev


from .curves.specs import CurveSpec, get_curve, list_curves          # noqa: E402,F401
from .ops import fe, points, scalarmul                               # noqa: E402,F401
from .ops.fe import FE, FieldSpec                                    # noqa: E402,F401
from .ops.points import Point                                        # noqa: E402,F401

_LAZY = {**dict.fromkeys(("ecdsa", "ecdh", "schnorr", "sm2", "bign", "hash2curve",
                          "rfc6979", "belt"), "protocols"),
         **dict.fromkeys(("msm", "collectives"), "parallel"),
         **dict.fromkeys(("sec1", "der", "keys", "asn1", "serde"), "encoding")}


def __getattr__(name):
    # the protocol, encoding and parallel modules load on first use
    if name in _LAZY:
        import importlib

        return importlib.import_module(f".{_LAZY[name]}.{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
