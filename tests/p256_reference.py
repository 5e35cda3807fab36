"""tpu_ecc's results for tests/test_torch_p256.py, computed in worker
processes. This module imports jax and tpu_ecc only (no torch, nothing of
the port), so a worker starts quickly; inputs arrive as numpy uint32 limbs
and host ints."""

import jax
import numpy as np

from tpu_ecc.curves.specs import get_curve
from tpu_ecc.ops import points as JP
from tpu_ecc.ops import scalarmul as JSM
from tpu_ecc.protocols import ecdsa as JE


def plain_formulas(inputs, eager=False):
    """The add, mixed add or doubling of each case, on steady limbs, in one
    jitted program, or op by op when eager (a few seconds a curve against
    half a minute or more of compiling). inputs: {case: (curve name,
    a [3, n, B], b [3, n, B])}, the case's name ending in its operation ->
    {case: point limbs uint32 [3, n, B]} (b's x and y are the mixed add's
    affine operand)."""
    curves = {case: get_curve(name) for case, (name, _, _) in inputs.items()}

    def run(arrays):
        out = {}
        for case, (a, b) in arrays.items():
            c = curves[case]
            pa = JP.point_from_limbs(c, a)
            if case.endswith("padd_mixed"):
                pb = JP.point_from_limbs(c, b)
                r = JP.padd_mixed(pa, pb.x, pb.y)
            elif case.endswith("pdouble"):
                r = JP.pdouble(pa)
            else:
                r = JP.padd(pa, JP.point_from_limbs(c, b))
            out[case] = JP.point_limbs(JP.steady(r))
        return out

    arrays = {case: (a, b) for case, (_, a, b) in inputs.items()}
    if eager:
        with jax.disable_jit():
            res = run(arrays)
    else:
        res = jax.jit(run)(arrays)
    return {k: np.asarray(v) for k, v in res.items()}


def sign_and_derive(name, ds, zs):
    """sign_batch with RFC 6979 nonces, and derive_public_batch."""
    c = get_curve(name)
    return JE.sign_batch(c, ds, zs), JSM.derive_public_batch(c, ds)


def verify(name, pubs, zs, sigs):
    return JE.verify_batch(get_curve(name), pubs, zs, sigs)
