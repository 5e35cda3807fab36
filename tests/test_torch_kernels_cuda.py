"""tpu_ecc_torch's CUDA kernels against their plain PyTorch twins, on the card.

Each kernel must equal its twin limb for limb (tolerance: exact). These tests
need an NVIDIA card and nvcc; they skip without them. Run them on the card
with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

(`--noconftest`: the suite's conftest sets up JAX, which the card's machine
does not need.)
"""

import numpy as np
import pytest
import torch

from tpu_ecc_torch.curves.specs import get_curve
from tpu_ecc_torch.ops import fe as F
from tpu_ecc_torch.ops import kernels
from tpu_ecc_torch.ops import points as P
from tpu_ecc_torch.utils import ec_host

pytestmark = pytest.mark.cuda

B = 300          # not a multiple of the block: the ragged edge is masked


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.fixture
def k256():
    return get_curve("secp256k1")


def _points(curve, seed, b, dev):
    """b steady points k*G for random k (a few distinct, tiled)."""
    rng = np.random.default_rng(seed)
    ks = [int(v) for v in rng.integers(1, 2**62, 16)]
    pts = [ec_host.aff_mul(curve, k, ec_host.aff_generator(curve)) for k in ks]
    pts = [pts[i % len(pts)] for i in range(b)]
    Q = P.from_affine_ints(curve, [p[0] for p in pts], [p[1] for p in pts], dev)
    return P.point_limbs(P.steady(Q))


def test_padd_chain_matches_plain(dev, k256):
    a = _points(k256, 1, B, dev)
    b = _points(k256, 2, B, dev)
    out = kernels.padd_chain(k256, a, b, 5)
    torch.cuda.synchronize()
    assert torch.equal(out, kernels.padd_chain_plain(k256, a, b, 5))


@pytest.mark.parametrize("field", ["fp", "fn"])
def test_pow_matches_plain(dev, k256, field):
    spec = k256.field if field == "fp" else k256.scalar
    rng = np.random.default_rng(3)
    xs = [int(v) * 0x9E3779B97F4A7C15 % spec.p for v in rng.integers(1, 2**62, B)]
    x = F.fsteady(F.fe_from_ints(spec, xs, dev)).limbs
    out = kernels.fpow(spec, x, spec.p - 2)
    torch.cuda.synchronize()
    assert torch.equal(out, kernels.fpow_plain(spec, x, spec.p - 2))
    assert F.fe_to_ints(F.fe_steady(spec, out)) == [pow(v, -1, spec.p) for v in xs]


@pytest.mark.parametrize("glv", [True, False])
def test_ladder_matches_plain(dev, k256, glv):
    T = 2 if glv else 1
    H = 2 * T if glv else T
    nw = 5
    bases = torch.stack([_points(k256, 10 + t, B, dev) for t in range(T)], 0)
    rng = np.random.default_rng(4)
    mag = torch.from_numpy(rng.integers(0, 9, (nw, H, B))).to(dev)
    neg = torch.from_numpy(rng.integers(0, 2, (nw, H, B)).astype(bool)).to(dev)
    out = kernels.ladder(k256, bases, mag, neg, glv=glv)
    torch.cuda.synchronize()
    assert torch.equal(out, kernels.ladder_plain(k256, bases, mag, neg, glv=glv))


@pytest.mark.parametrize("b", [256, 4096])
def test_genmul_matches_plain(dev, k256, b):
    from tpu_ecc_torch.ops import scalarmul as SM

    rng = np.random.default_rng(5)
    ks = [0, k256.n - 1] + [int.from_bytes(rng.bytes(32), "big") for _ in range(b - 2)]
    mag, neg = SM.signed_digits(k256, SM.pack_scalars(k256, ks, dev))
    tbl = SM._gen_table(k256, dev)
    mag, neg = mag.flip(0), neg.flip(0)
    out = kernels.genmul(k256, tbl, mag, neg)
    torch.cuda.synchronize()
    assert torch.equal(out, kernels.genmul_plain(k256, tbl, mag, neg))
