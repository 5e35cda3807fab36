"""tpu_ecc's results for tests/test_torch_fe32_wide.py, computed in worker
processes. This module imports jax and tpu_ecc only (no torch, nothing of
the port), so a worker starts quickly; inputs arrive as numpy uint32 limbs."""

import jax
import numpy as np

from tpu_ecc.curves.specs import get_curve
from tpu_ecc.ops import fe as JF

FIELD_OPS = ("fmul", "fsquare", "fadd", "fsub", "fneg", "fcanonical")


def field_ops(cases):
    """tpu_ecc.ops.fe's multiply, square, add, subtract, negation and
    canonical form of x + y, one jitted program per field. cases: {case:
    (curve name, "field" or "scalar", x, y [n, B] canonical limbs)} ->
    {case: {op: limbs}}."""
    out = {}
    for case, (name, which, x, y) in cases.items():
        spec = getattr(get_curve(name), which)

        @jax.jit
        def run(a, b):
            fa = JF.FE(a, spec, spec.mask, spec.p - 1)
            fb = JF.FE(b, spec, spec.mask, spec.p - 1)
            r = {"fmul": JF.fmul(fa, fb), "fsquare": JF.fsquare(fa), "fadd": JF.fadd(fa, fb),
                 "fsub": JF.fsub(fa, fb), "fneg": JF.fneg(fa),
                 "fcanonical": JF.fcanonical(JF.fadd(fa, fb))}
            return {k: v.limbs for k, v in r.items()}

        out[case] = {k: np.asarray(v) for k, v in run(x, y).items()}
    return out
