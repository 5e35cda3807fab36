"""Field multiply on the CUDA cores against a Montgomery multiply whose
reduction runs on the int8 tensor cores.

The port of the JAX repo's tools/bench_mxu_mul.py. The batched data-by-data
limb convolution has no shared operand, so it cannot become a matrix
product. What is matrix-shaped is the Montgomery reduction: with R =
2^(b n),

    m   = (T mod R) * N' mod R      N' = -p^-1 mod R   (a constant)
    out = (T + m * p) / R           p                  (a constant)

are convolutions of a constant with data: out[k, B] = sum_i C[k, i] d[i, B]
with C a banded Toeplitz matrix of the constant's limbs, [2n, n] x [n, B].
13-bit limbs split into two int8 planes (7 + 6 bits); four int8 products
recombine exactly as P00 + ((P01 + P10) << 7) + (P11 << 14), every column
below 2^31 for n <= 21.

At B = 8192, for P-256's field (Montgomery), secp256k1's field forced onto
the Montgomery backend, and secp256k1's own (solinas), this measures:

  1. fmul on the plain torch path (`F._steady(F.fmul(..))`);
  2. the `fmul_chain` kernel: 16 chained multiplies in one launch, on the
     32-bit layer's own multiply (csrc/fe32.cuh `mul`: the solinas fold or
     CIOS at R32 = 2^(32N)), checked mod p against Python integers on 8
     lanes;
  3. (Montgomery fields) the separated Montgomery multiply above on 13-bit
     digits, the reduction's constant products as library int8 matrix
     products (`torch._int_mm`, four planes each), checked against Python
     integers on 64 lanes: the JAX tool's plane algorithm, not a kernel;
  4. (Montgomery fields) the `mxu_chain` kernel: 16 chained separated
     multiplies in one launch on the 32-bit layer, the two constant
     products as byte-digit `wgmma` products (u8 x u8 -> s32: 32-bit
     words are their own bytes, so one product replaces the four planes),
     checked mod p on 8 lanes.

    python3 -m tpu_ecc_torch.tools.bench_mxu_mul [batch] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves.specs import get_curve
from ..ops import fe as F
from ..ops import kernels as K
from ..ops.fe import make_field_spec
from ..utils.bigint import limbs_to_int
from . import best_seconds, device_label, parse


def make_mxu_mul(spec: F.FieldSpec):
    """The separated Montgomery multiply of canonical digits x, y [n, B] ->
    digits [n, B] below 2p (x y R^-1 mod p): the convolution and the carries
    as plain torch, the two constant products as four `torch._int_mm` int8
    products each. Both limb axes of the constant matrices (and the digits')
    are zero-padded from n and 2n to multiples of 8, as the card's int8
    product wants them; the zeros add nothing, and the padded rows are cut."""
    n = spec.n_limbs
    kpad = -(-n // 8) * 8

    def padded(p):
        return torch.from_numpy(np.pad(p, ((0, -p.shape[0] % 8), (0, kpad - n))))

    planes = [[padded(p) for p in K._planes_np(m)] for m in K.mont_matrices(spec)]
    on = {}

    def const_conv(which, d):
        if d.device not in on:
            on[d.device] = [[p.to(d.device) for p in pair] for pair in planes]
        c_lo, c_hi = on[d.device][which]
        pad = torch.zeros((d.shape[1], kpad - n), dtype=torch.int8, device=d.device)
        # the digits' planes column-major [kpad, B]: the card's int8 product
        # takes its second operand so
        d_lo = torch.cat([(d & 127).to(torch.int8).t(), pad], 1).t()
        d_hi = torch.cat([(d >> 7).to(torch.int8).t(), pad], 1).t()
        p00, p01 = torch._int_mm(c_lo, d_lo), torch._int_mm(c_lo, d_hi)
        p10, p11 = torch._int_mm(c_hi, d_lo), torch._int_mm(c_hi, d_hi)
        return (p00 + ((p01 + p10) << 7) + (p11 << 14))[:(which + 1) * n].to(F.LIMB)

    def mul(x, y):
        return K.mont_step(spec, x, y, const_conv)

    return mul


def _ints(limbs: torch.Tensor, bits: int) -> list:
    arr = limbs.cpu().numpy()
    return [limbs_to_int(arr[:, k], bits) for k in range(arr.shape[1])]


def main(argv=None) -> list:
    """The four cases on the three fields. Returns one dict per field: its
    name, the seconds per call of each case, and the kernel launches that
    the field's cases made."""
    B, dev = parse(argv, __doc__, "lanes B (default 8192)", 8192)
    print(f"device: {device_label(dev)}  B = {B}", flush=True)

    def timeit(name, fn, *args):
        best = best_seconds(lambda: fn(*args), dev, 24, 3)
        print(f"  {name}: {best * 1e6:9.1f} us/call  {B / best:.3e} muls/s", flush=True)
        return best

    k256 = get_curve("secp256k1")
    cases = [
        ("p256 (native mont)", get_curve("p256").field),
        ("k256 forced-mont", make_field_spec("k256mxu.fp", k256.p, "mont")),
        ("k256 solinas (production)", k256.field),
    ]
    rng = np.random.default_rng(1)
    results = []
    for label, spec in cases:
        print(f"== {label}: n={spec.n_limbs} x {spec.limb_bits}-bit, kind={spec.kind}",
              flush=True)
        before = dict(K.launches)
        vals = [int.from_bytes(rng.bytes(spec.bits // 8), "big") % spec.p for _ in range(B)]
        a = F.fe_from_ints(spec, vals, dev)
        bb = F.fe_from_ints(spec, vals[::-1], dev)
        res = {"field": spec.name, "label": label}

        # 1) the plain torch path
        res["graph_s"] = timeit("fmul plain torch  ", lambda u, v: F._steady(F.fmul(
            F.fe_steady(spec, u), F.fe_steady(spec, v))).limbs, a.limbs, bb.limbs)

        # 2) the fmul_chain kernel: 16 chained multiplies in one launch
        got = F.fe_to_ints(F.fe_steady(spec, K.fmul_chain(spec, a.limbs, bb.limbs)[:, :8]))
        if got != [vals[i] * pow(vals[B - 1 - i], K.CHAIN, spec.p) % spec.p
                   for i in range(len(got))]:
            raise AssertionError(f"fmul_chain on {spec.name} disagrees with the host")
        t_k = timeit("fmul_chain kernel ", lambda u, v: K.fmul_chain(spec, u, v),
                     a.limbs, bb.limbs)
        res["chain_s"] = t_k
        print(f"    (per chained mul: {t_k / K.CHAIN * 1e6:.2f} us, "
              f"{K.CHAIN * B / t_k:.3e} muls/s; 8 lanes equal the host)", flush=True)

        if spec.kind == "mont":
            R = 1 << (spec.limb_bits * spec.n_limbs)
            rinv = pow(R, -1, spec.p)
            # 3) the separated Montgomery multiply, the reduction on _int_mm
            mxu = make_mxu_mul(spec)
            got = _ints(mxu(a.limbs[:, :64], bb.limbs[:, :64]), spec.limb_bits)
            for i in range(len(got)):
                want = spec.encode_int(vals[i]) * spec.encode_int(vals[B - 1 - i]) * rinv
                if got[i] % spec.p != want % spec.p:
                    raise AssertionError(f"{label}: the mxu multiply is wrong at lane {i}")
            print(f"    mxu correctness OK ({len(got)} host cross-checks)", flush=True)
            res["mxu_s"] = timeit("fmul mxu-mont _int_mm", mxu, a.limbs, bb.limbs)

            # 4) the mxu_chain kernel: 16 chained separated multiplies
            got = _ints(K.mxu_chain(spec, a.limbs, bb.limbs)[:, :8], spec.limb_bits)
            for i in range(len(got)):
                want, ye = spec.encode_int(vals[i]), spec.encode_int(vals[B - 1 - i])
                for _ in range(K.CHAIN):
                    want = want * ye * rinv % spec.p
                if got[i] % spec.p != want:
                    raise AssertionError(f"{label}: the mxu_chain kernel is wrong at lane {i}")
            print(f"    mxu_chain correctness OK ({len(got)} host cross-checks)", flush=True)
            t_f = timeit("mxu_chain kernel  ", lambda u, v: K.mxu_chain(spec, u, v),
                         a.limbs, bb.limbs)
            res["mxu_chain_s"] = t_f
            print(f"    (per chained mul: {t_f / K.CHAIN * 1e6:.2f} us, "
                  f"{K.CHAIN * B / t_f:.3e} muls/s)", flush=True)
        res["launches"] = {k: v - before[k] for k, v in K.launches.items() if v != before[k]}
        results.append(res)
    return results


if __name__ == "__main__":
    main()
