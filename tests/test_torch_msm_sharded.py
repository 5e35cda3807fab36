"""The fifteenth slice: the sharded MSM and its collectives on
torch.distributed, port against tpu_ecc and the host oracle, on the CPU.

Four gloo ranks (tests/msm_sharded_ranks.py, a file:// rendezvous in the
module's temporary directory, so that parallel test processes never clash
on a port) run every case once with device="cpu", where the Pippenger
phases and the ladder run their plain twins; each rank writes its results,
and each test reads its own case. The ranks must end within RANKS_TIMEOUT
seconds, so that a hang fails.

tpu_ecc's results come from two niced worker processes
(tests/msm_reference.py): its sharded Straus msm() on 4 of the 8 virtual
CPU devices of tests/conftest.py, gather and ring (about a minute of
XLA:CPU compile); and its msm_pippenger on each of the four shards (one
program: the shards have one shape), the partials then folded by its own
padd, steady and tree_reduce_points in msm_sharded's two orders, which is
its device 0's result limb for limb without the sharded Pippenger program
(minutes of compile). Tolerance: exact (equal limbs, or equal affine
integers where the two take different routes: the port's Straus runs the
ladder, tpu_ecc's CPU route the stacked-table scan).
"""

import concurrent.futures
import functools
import multiprocessing
import os
import pickle
import time

import msm_reference
import msm_sharded_ranks as R
import numpy as np
import pytest
import torch
import torch.multiprocessing

from tpu_ecc_torch import interop
from tpu_ecc_torch.ops import fe as F
from tpu_ecc_torch.parallel import msm as M
from tpu_ecc_torch.utils import ec_host as H

C = R.C
D = R.D
RANKS_TIMEOUT = 120


def _host_msm(pts, ks):
    """sum k_i * P_i by the host oracle, one aff_mul per distinct point."""
    total = {}
    for p_, k in zip(pts, ks):
        total[p_] = (total.get(p_, 0) + k) % C.n
    acc = None
    for p_, k in total.items():
        acc = H.aff_add(C, acc, H.aff_mul(C, k, p_))
    return acc


@functools.lru_cache(maxsize=None)
def _want(case):
    return _host_msm(*R.inputs()[case])


def _affine(limbs):
    X, Y, Z = (F.fe_to_ints(F.fe_steady(C.field, limbs[i]))[0] for i in range(3))
    if Z == 0:
        return None
    zi = pow(Z, -1, C.p)
    return X * zi % C.p, Y * zi % C.p


def _run_ranks(out) -> list:
    """Run the D ranks; their results, rank by rank."""
    ctx = torch.multiprocessing.start_processes(
        R.run, args=(str(out / "rendezvous"), str(out)), nprocs=D, join=False,
        start_method="spawn")
    deadline = time.monotonic() + RANKS_TIMEOUT
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                pytest.fail(f"the {D} ranks did not end within {RANKS_TIMEOUT} s")
    finally:
        for p_ in ctx.processes:
            if p_.is_alive():
                p_.kill()
                p_.join()
    results = []
    for r in range(D):
        with open(out / f"rank{r}.pkl", "rb") as fh:
            results.append(pickle.load(fh))
    return results


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(every rank's results, tpu_ecc's results as futures). tpu_ecc's two
    jobs start first, in niced workers, and run while the ranks do."""
    ref = interop.to_reference_limbs
    pts, ks = R.inputs()["full"]
    shards = [(ref(xs), ref(ys), inf.numpy(), ref(k))
              for xs, ys, inf, k in R.shards(pts, ks, R.FULL["lanes"] * D)]
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=2, mp_context=multiprocessing.get_context("spawn"),
            initializer=os.nice, initargs=(10,)) as pool:
        refs = {"straus": pool.submit(msm_reference.straus_sharded, R.NAME,
                                      *R.inputs()["straus"], D),
                "full": pool.submit(msm_reference.pippenger_shards, R.NAME, R.FULL, shards)}
        yield _run_ranks(tmp_path_factory.mktemp("ranks")), refs
        pool.shutdown(cancel_futures=True)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

# each rank's group on each axis of the 1-D mesh and of the (2, 2) ("dcn",
# "ici") mesh, in group-rank order
GROUPS = {"dp": [[0, 1, 2, 3]] * 4, "ici": [[0, 1], [0, 1], [2, 3], [2, 3]],
          "dcn": [[0, 2], [1, 3], [0, 2], [1, 3]]}


@pytest.mark.parametrize("axis", list(GROUPS))
def test_all_gather_in_group_rank_order(sharded, axis):
    ranks, _ = sharded
    for r, res in enumerate(ranks):
        got = res["collectives"]["gather" if axis == "dp" else f"gather_{axis}"]
        assert got == (GROUPS[axis][r] if axis == "dp" else [GROUPS[axis][r]])


def test_axis_size_and_sub_groups(sharded):
    ranks, _ = sharded
    for r, res in enumerate(ranks):
        col = res["collectives"]
        assert (col["size"], col["size_dcn"], col["size_ici"]) == (4, 2, 2)
        assert [col["groups_dcn"], col["groups_ici"]] == [GROUPS["dcn"][r], GROUPS["ici"][r]]


@pytest.mark.parametrize("key,order", [("shard", [0, 1, 2, 3]), ("shard_grid", [0, 1, 2, 3]),
                                       ("shard_grid_swapped", [0, 2, 1, 3])])
def test_shard_batch_takes_the_rank_s_slice(sharded, key, order):
    """Shards of arange(8), outermost axis major: on ("dcn", "ici") the
    shard index is the global rank, on ("ici", "dcn") it is ici * 2 + dcn."""
    ranks, _ = sharded
    for r, res in enumerate(ranks):
        s = order[r]
        assert res["collectives"][key] == [2 * s, 2 * s + 1]


@pytest.mark.parametrize("axis", list(GROUPS))
def test_ring_reduce_order(sharded, axis):
    """With fold = concatenation, rank r folds its own payload, then group
    rank r - 1's, r - 2's, ..: the order of tpu_ecc's ppermute ring."""
    ranks, _ = sharded
    for r, res in enumerate(ranks):
        group = GROUPS[axis][r]
        i = group.index(r)
        want = [group[(i - s) % len(group)] for s in range(len(group))]
        assert res["collectives"]["ring_order" if axis == "dp" else f"ring_{axis}"] == want


def test_ring_reduce_of_integers_and_of_points(sharded):
    """Every rank ends with the sum 1 + 2 + 3 + 4; the ring of points
    equals the gather fold and the host oracle."""
    ranks, _ = sharded
    want = None
    for r in range(D):
        for lane in R.random_points(r, 2).unbind(-1):
            want = H.aff_add(C, want, _affine(lane))
    for res in ranks:
        col = res["collectives"]
        assert col["ring_sum"] == [10]
        assert col["points_ring"] == col["points_gather"] == want


# ---------------------------------------------------------------------------
# the sharded MSM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rm", ["gather", "ring"])
def test_straus_equals_reference_and_oracle(sharded, rm):
    ranks, refs = sharded
    want = _want("straus")
    assert refs["straus"].result()[rm] == want
    assert [res[f"straus_{rm}"] for res in ranks] == [want] * D


@pytest.mark.parametrize("rank", range(D))
def test_pippenger_partial_limb_equal_to_reference(sharded, rank):
    """Each rank's full-width signed Pippenger partial over its own shard
    equals tpu_ecc's msm_pippenger on the same shard."""
    ranks, refs = sharded
    np.testing.assert_array_equal(interop.to_reference_limbs(ranks[rank]["full_partial"]),
                                  refs["full"].result()["partials"][rank])


@pytest.mark.parametrize("rm", ["gather", "ring"])
def test_pippenger_fold_limb_equal_to_reference(sharded, rm):
    """Rank 0's folded limbs equal tpu_ecc's device 0's, in the fold's
    order; every rank's fold is the host oracle's sum."""
    ranks, refs = sharded
    np.testing.assert_array_equal(interop.to_reference_limbs(ranks[0][f"full_{rm}"]),
                                  refs["full"].result()[rm])
    assert [_affine(res[f"full_{rm}"]) for res in ranks] == [_want("full")] * D


@pytest.mark.parametrize("case", ["hier_straus", "hier_pippenger"])
def test_hierarchical_equals_oracle(sharded, case):
    """The (2, 2) ("dcn", "ici") mesh: Straus with "auto" (the ring on both
    axes), Pippenger (signed, w = 8, 16-bit) with "gather"."""
    ranks, _ = sharded
    want = _want("straus" if case == "hier_straus" else "hier")
    assert [res[case] for res in ranks] == [want] * D


@pytest.mark.parametrize("case", ["adv_pippenger_gather", "adv_pippenger_ring",
                                  "adv_straus_gather", "adv_straus_ring"])
def test_adversarial_shards(sharded, case):
    """N not a multiple of the unit, the last rank all padding, the one
    before it only zero scalars, equal points and scalars across the shard
    boundaries: every rank's sum is the oracle's."""
    ranks, _ = sharded
    inputs = case.rsplit("_", 1)[0]
    pts, ks = R.inputs()[inputs]
    unit = R.ADV_PIPPENGER["lanes"] if inputs == "adv_pippenger" else R.ADV_STRAUS["terms"] * 128
    shards = R.shards(pts, ks, unit * D)
    assert bool(shards[3][2].all()), "the last shard is all padding"
    assert not bool(shards[2][3].any()), "the third shard has only zero scalars"
    assert [res[case] for res in ranks] == [_want(inputs)] * D


def test_msm_checks_the_mesh_and_reduce_method(sharded):
    """A mesh that is not a DeviceMesh raises TypeError; an unknown
    reduce_method on a mesh raises ValueError on every rank."""
    ranks, _ = sharded
    pts, ks = R.inputs()["straus"]
    with pytest.raises(TypeError, match="DeviceMesh"):
        M.msm(C, pts[:8], ks[:8], mesh=object(), device="cpu")
    for res in ranks:
        assert res["bad_reduce_method"].startswith("unknown reduce_method 'tree'")
