"""The ranks of tests/test_torch_msm_sharded.py: D processes, one gloo group
(a file:// rendezvous), each running every case of the sharded MSM on the
CPU (device="cpu": the Pippenger phases' and the ladder's plain twins) and
writing its results to <out>/rank<r>.pkl. This module imports torch and the
port only (no jax, no tpu_ecc), so a rank starts quickly; the inputs come
from `inputs()`, which the test process calls too."""

import functools
import os
import pickle
import random

import torch
import torch.distributed as dist

from tpu_ecc_torch.curves.specs import get_curve
from tpu_ecc_torch.ops import fe as F
from tpu_ecc_torch.ops import points as P
from tpu_ecc_torch.parallel import collectives as CL
from tpu_ecc_torch.parallel import msm as M
from tpu_ecc_torch.utils import ec_host as H

D = 4
NAME = "secp256k1"
C = get_curve(NAME)

# the Pippenger configurations, as tests/test_msm.py runs tpu_ecc's sharded
# ones at D = 8 (the full-width case at w = 8, not 13: see inputs())
FULL = dict(N=32 * D, lanes=8, w=8, bits=None, signed=True)
HIER = dict(N=128 * D, lanes=32, w=8, bits=16)
ADV_PIPPENGER = dict(N=70, lanes=8, w=5, bits=16)     # shards of 24: rank 3 all padding
ADV_STRAUS = dict(N=700, terms=2, bits=16)            # shards of 256: rank 3 all padding
AXES = ("dcn", "ici")


@functools.lru_cache(maxsize=None)
def inputs() -> dict:
    """{case: (points, scalars)}, made from a seed.

    straus: 2 * 128 * D points (8 random base points tiled), 16-bit scalars.
    full: 32 * D points, full-width scalars with 0 and n - 1; w = 8 (33
    signed windows with the carry row), where tpu_ecc's test takes w = 13:
    the port's plain bucket_reduce at w = 13 (4096 buckets in each of 20
    windows) takes over two minutes a rank on one CPU thread.
    hier: 128 * D points, 16-bit scalars.
    adv_pippenger, adv_straus: N not a multiple of the unit, so that the
    last rank holds only padding; the rank before it only zero scalars;
    one point and one scalar on both sides of the boundary between ranks
    0 and 1 (a run of equal keys across ranks and across lanes), one
    point with zero scalars on both sides of the boundary between ranks
    1 and 2."""
    rng = random.Random(4321)
    G = H.aff_generator(C)
    base = [H.aff_mul(C, rng.randrange(1, C.n), G) for _ in range(8)]
    out = {}
    for case, N, bits in (("straus", 2 * 128 * D, 16), ("full", FULL["N"], None),
                          ("hier", HIER["N"], 16)):
        pts = [base[i % 8] for i in range(N)]
        ks = [rng.randrange(0, 1 << bits if bits else C.n) for _ in range(N)]
        if bits is None:
            ks[0], ks[1] = 0, C.n - 1
        out[case] = (pts, ks)
    for case, N, shard in (("adv_pippenger", ADV_PIPPENGER["N"], 24),
                           ("adv_straus", ADV_STRAUS["N"], 256)):
        pts = [base[rng.randrange(8)] for _ in range(N)]
        ks = [rng.randrange(1, 1 << 16) for _ in range(N)]
        k = rng.randrange(1, 1 << 16)
        for i in range(shard - 6, shard + 6):         # across the ranks 0 | 1 boundary
            pts[i], ks[i] = base[0], k
        for i in range(2 * shard - 5, 2 * shard):     # zeros up to rank 2
            pts[i], ks[i] = base[1], 0
        for i in range(2 * shard, N):                 # rank 2: zero scalars only
            pts[i], ks[i] = base[1], 0
        out[case] = (pts, ks)
    return out


def shards(pts, ks, unit_count: int):
    """The D packed shards (xs, ys, inf, k) of msm()'s global padding to a
    multiple of unit_count, as the ranks pack them."""
    Np = -(-len(pts) // unit_count) * unit_count
    S = Np // D
    return [M.pack(C, pts[r * S:(r + 1) * S], ks[r * S:(r + 1) * S], S, "cpu")
            for r in range(D)]


def _affine(limbs):
    x, y, inf = P.to_affine(P.point_from_limbs(C, limbs))
    return None if bool(inf) else (F.fe_to_ints(x)[0], F.fe_to_ints(y)[0])


def random_points(rank: int, lanes: int):
    """Projective steady limbs [3, n, lanes] of random points, rank's own."""
    rng = random.Random(100 + rank)
    G = H.aff_generator(C)
    pts = [H.aff_mul(C, rng.randrange(1, C.n), G) for _ in range(lanes)]
    return P.point_limbs(P.steady(P.from_affine(
        C, F.fe_from_ints(C.field, [p[0] for p in pts], "cpu"),
        F.fe_from_ints(C.field, [p[1] for p in pts], "cpu"),
        torch.zeros(lanes, dtype=torch.bool))))


def collectives_case(rank: int, line, grid) -> dict:
    x = torch.tensor([rank])
    out = {"gather": CL.all_gather(x, line, "dp").tolist(),
           "size": CL.axis_size(line, "dp"),
           "shard": CL.shard_batch(line, "dp", torch.arange(2 * D)).tolist(),
           "ring_order": CL.ppermute_ring_reduce(x, line, "dp",
                                                 lambda a, b: torch.cat([a, b])).tolist(),
           "ring_sum": CL.ppermute_ring_reduce(x + 1, line, "dp", torch.add).tolist()}
    for ax in AXES:
        out[f"groups_{ax}"] = dist.get_process_group_ranks(grid.get_group(ax))
        out[f"gather_{ax}"] = CL.all_gather(x[None], grid, ax, axis=1).tolist()
        out[f"size_{ax}"] = CL.axis_size(grid, ax)
        out[f"ring_{ax}"] = CL.ppermute_ring_reduce(x, grid, ax,
                                                    lambda a, b: torch.cat([a, b])).tolist()
    out["shard_grid"] = CL.shard_batch(grid, AXES, torch.arange(2 * D)).tolist()
    out["shard_grid_swapped"] = CL.shard_batch(grid, AXES[::-1], torch.arange(2 * D)).tolist()
    pts = random_points(rank, 2)
    one = P.point_limbs(M.tree_reduce_points(P.point_from_limbs(C, pts)))
    out["points_ring"] = _affine(CL.ppermute_ring_reduce(one, line, "dp",
                                                         lambda a, b: P.add_limbs(C, a, b)))
    out["points_gather"] = _affine(M.fold_partials(C, line, "dp", pts, "gather"))
    return out


def run(rank: int, rendezvous: str, out_dir: str) -> None:
    """One rank: join the gloo group, run every case, write the results."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=D)
    try:
        line = CL.make_mesh(D, "dp")
        grid = CL.make_mesh(shape=(2, 2), axes=AXES)
        res = {"collectives": collectives_case(rank, line, grid)}
        cases = inputs()

        pts, ks = cases["straus"]
        for rm in ("gather", "ring"):
            res[f"straus_{rm}"] = M.msm(C, pts, ks, mesh=line, terms=2, scalar_bits=16,
                                        reduce_method=rm, device="cpu")
        res["hier_straus"] = M.msm(C, pts, ks, mesh=grid, axis=AXES, terms=2, scalar_bits=16,
                                   device="cpu")

        pts, ks = cases["full"]
        part = CL.shard_slice(line, "dp", FULL["N"])
        xs, ys, inf, k = M.pack(C, pts[part], ks[part], FULL["N"] // D, "cpu")
        partial = M.msm_limbs(C, xs, ys, inf, k, "pippenger", w=FULL["w"],
                              lanes=FULL["lanes"], signed=True)
        res["full_partial"] = partial
        for rm in ("gather", "ring"):
            res[f"full_{rm}"] = M.fold_partials(C, line, "dp", partial[..., None], rm)

        pts, ks = cases["hier"]
        res["hier_pippenger"] = M.msm(C, pts, ks, mesh=grid, axis=AXES, method="pippenger",
                                      w=HIER["w"], lanes=HIER["lanes"], scalar_bits=16,
                                      reduce_method="gather", device="cpu")

        for rm in ("gather", "ring"):
            pts, ks = cases["adv_pippenger"]
            res[f"adv_pippenger_{rm}"] = M.msm(
                C, pts, ks, mesh=line, method="pippenger", w=ADV_PIPPENGER["w"],
                lanes=ADV_PIPPENGER["lanes"], scalar_bits=16, reduce_method=rm, device="cpu")
            pts, ks = cases["adv_straus"]
            res[f"adv_straus_{rm}"] = M.msm(C, pts, ks, mesh=line, terms=2, scalar_bits=16,
                                            reduce_method=rm, device="cpu")
        try:
            M.msm(C, pts, ks, mesh=line, reduce_method="tree", device="cpu")
        except ValueError as e:
            res["bad_reduce_method"] = str(e)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(res, fh)
    finally:
        dist.destroy_process_group()
