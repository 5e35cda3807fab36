"""Split the ladder kernel's time among its parts.

The port of the JAX repo's tools/profile_ladder.py. The `ladder_probe`
kernel (ops/kernels.py, csrc/ladder_probe.cu) is the port's ladder body
with its parts switched on one at a time; the differences between its five
variants isolate the point-formula floor (4 doublings and 2 adds per window,
`bare`), the doubling loop unrolled (`unroll`), the table build of 7 adds
(`build`), the masked 9-entry select by digit (`select`) and the masked
y-negation (`negate`). Beside them, the `padd_chain` kernel at the same
batch, 16 adds per lane, for the cost of one add.

secp256k1, B = 4096 lanes of 8 bases, full-width scalars cut to their
low 132 bits' signed digits (34 windows), as the JAX tool makes them.

    python3 -m tpu_ecc_torch.tools.profile_ladder [batch] [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np

from ..curves.specs import get_curve
from ..ops import kernels as K
from ..ops import points as P
from ..ops import scalarmul as SM
from ..utils import ec_host as H
from . import best_seconds, device_label, parse, sync

NW = 34
ITERS = 8


def inputs(curve, B: int, device) -> tuple:
    """(bases [3, n, B], mag, neg [NW, 2, B]): 8 bases k*G from seed 11,
    tiled; B full-width scalars, their signed digits of 132 bits."""
    G = H.aff_generator(curve)
    rng = np.random.default_rng(11)
    base = [H.aff_mul(curve, int(k), G) for k in rng.integers(1, 2**31, 8)]
    pp = P.from_affine_ints(curve, [p[0] for p in base] * (B // 8),
                            [p[1] for p in base] * (B // 8), device)
    bases = P.point_limbs(P.steady(pp))
    ks = [int.from_bytes(rng.bytes(32), "big") % curve.n for _ in range(B)]
    mag, neg = SM.signed_digits(curve, SM.pack_scalars(curve, ks, device), 132)
    return (bases, mag[:NW, None].expand(NW, 2, B).contiguous(),
            neg[:NW, None].expand(NW, 2, B).contiguous())


def main(argv=None) -> dict:
    """The padd_chain reference and the five variants. Returns
    {"padd_chain_s": s, "variants": {variant: s}} (seconds per call)."""
    B, dev = parse(argv, __doc__, "lanes B, a multiple of 8 (default 4096)", 4096)
    curve = get_curve("secp256k1")
    print(f"device: {device_label(dev)}  B={B} nw={NW}", flush=True)
    bases, mag, neg = inputs(curve, B, dev)

    def timeit(name, fn):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        print(f"  {name}: first call {time.perf_counter() - t0:.1f}s", flush=True)
        best = best_seconds(fn, dev, 1, ITERS)
        print(f"  {name}: {best * 1e3:8.3f} ms   {best / NW * 1e6:7.2f} us/window",
              flush=True)
        return best

    # the reference: the point-add chain at the same batch (the TPU tool's
    # two block heights, S = 8 and 16, have no counterpart: one run)
    tc = timeit("padd_chain x16", lambda: K.padd_chain(curve, bases, bases, 16))
    print(f"    per add: {tc / 16 * 1e6:7.2f} us (one launch of B lanes; the TPU "
          "tool's S = 8 and S = 16 block rows have no counterpart, so it runs once)",
          flush=True)
    out, prev = {}, None
    for variant in K.PROBE_VARIANTS:
        t = timeit(f"{variant:7s}", lambda: K.ladder_probe(curve, bases, mag, neg, variant))
        if prev is not None:
            print(f"    delta vs previous: {(t - prev) * 1e3:+8.3f} ms  "
                  f"{(t - prev) / NW * 1e6:+7.2f} us/window", flush=True)
        out[variant], prev = t, t
    return {"padd_chain_s": tc, "variants": out}


if __name__ == "__main__":
    main()
