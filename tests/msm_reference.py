"""tpu_ecc's MSM results for tests/test_torch_msm.py and
tests/test_torch_msm_sharded.py, computed in worker processes. This module
imports jax and tpu_ecc only (no torch, nothing of the port), so a worker
starts quickly; inputs arrive as numpy uint32 limbs and host ints."""

import jax
import numpy as np

from tpu_ecc.curves.specs import get_curve
from tpu_ecc.ops import fe as JF
from tpu_ecc.ops import points as JP
from tpu_ecc.parallel import msm as JM


def pippenger(name, cfg, inputs):
    """msm_pippenger(kernels=False) under one jax.jit: {set: (xs, ys, k)} ->
    {set: point limbs uint32 [3, n]}."""
    c = get_curve(name)
    f = c.field
    run = jax.jit(lambda xs, ys, inf, k: JP.point_limbs(JM.msm_pippenger(
        c, JF.fe_steady(f, xs), JF.fe_steady(f, ys), inf, k, w=cfg["w"],
        lanes=cfg["lanes"], scalar_bits=cfg["bits"], kernels=False,
        signed=cfg["signed"])))
    return {key: np.asarray(run(xs, ys, np.zeros(xs.shape[-1], bool), k))
            for key, (xs, ys, k) in inputs.items()}


def straus(name, cases):
    """tpu_ecc's msm() (Straus, terms = 2, 16-bit scalars): {case: (points,
    scalars)} -> {case: affine (x, y) or None}."""
    c = get_curve(name)
    return {key: JM.msm(c, pts, ks, terms=2, scalar_bits=16)
            for key, (pts, ks) in cases.items()}


def helpers(name, a, b):
    """tree_reduce_points, fbatch_inv, batch_normalize and peq under one
    jax.jit on projective limbs a, b uint32 [3, n, B]."""
    c = get_curve(name)

    @jax.jit
    def run(a, b):
        pa, pb = JP.point_from_limbs(c, a), JP.point_from_limbs(c, b)
        bx, by, binf = JP.batch_normalize(pa)
        return {"tree": JP.point_limbs(JM.tree_reduce_points(JP.steady(pa))),
                "inv": JF.fbatch_inv(pa.z).limbs, "bx": bx.limbs, "by": by.limbs,
                "binf": binf, "peq": JP.peq(pa, pb)}

    return {k: np.asarray(v) for k, v in run(a, b).items()}


def straus_sharded(name, pts, ks, D):
    """tpu_ecc's sharded msm() (Straus, terms = 2, 16-bit scalars) on a 1-D
    mesh of D of the virtual CPU devices, with each reduce method:
    {method: affine (x, y) or None}."""
    from tpu_ecc.parallel import collectives

    c = get_curve(name)
    mesh = collectives.make_mesh(D, "dp")
    return {rm: JM.msm(c, pts, ks, mesh=mesh, axis="dp", terms=2, scalar_bits=16,
                       reduce_method=rm) for rm in ("gather", "ring")}


def pippenger_shards(name, cfg, shards):
    """msm_sharded's Pippenger without its sharded program: msm_pippenger
    (kernels=False, one jax.jit) on each shard (xs, ys, inf, k), then the
    partials folded in msm_sharded's two orders by its own steps
    (tree_reduce_points, padd and steady): device 0's ring, acc = x_0 +
    x_{D-1} + ... + x_1 one add at a time, and the tree over the gathered
    partials. -> {"partials": [D, 3, n], "ring": [3, n], "gather": [3, n]},
    uint32 limbs."""
    c = get_curve(name)
    f = c.field
    run = jax.jit(lambda xs, ys, inf, k: JP.point_limbs(JM.msm_pippenger(
        c, JF.fe_steady(f, xs), JF.fe_steady(f, ys), inf, k, w=cfg["w"],
        lanes=cfg["lanes"], scalar_bits=cfg["bits"], kernels=False,
        signed=cfg["signed"])))
    tree = jax.jit(lambda limbs: JP.point_limbs(JM.tree_reduce_points(
        JP.point_from_limbs(c, limbs))))
    fold = jax.jit(lambda a, b: JP.point_limbs(JP.steady(JP.padd(
        JP.point_from_limbs(c, a), JP.point_from_limbs(c, b)))))
    parts = np.stack([np.asarray(run(*shard)) for shard in shards])
    ones = [tree(p[..., None]) for p in parts]
    acc = ones[0]
    for x in ones[:0:-1]:
        acc = fold(acc, x)
    return {"partials": parts, "ring": np.asarray(acc),
            "gather": np.asarray(tree(np.moveaxis(parts, 0, -1)))}
