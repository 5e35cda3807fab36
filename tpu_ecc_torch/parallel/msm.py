"""Multi-scalar multiplication (MSM): Straus for small N, the bucketed
Pippenger for large N, on one device or sharded over the ranks of a mesh.

The torch port of tpu_ecc/parallel/msm.py, limb-equal with tpu_ecc's XLA
path. Two methods behind one `msm()` entry:

- *Straus* (small N, secret scalars): points go in groups of T terms x B
  lanes through `scalarmul.lincomb_auto` (the `ladder` kernel, with the GLV
  split for full-width secp256k1 scalars), and the lane partials fold in
  one log-depth tree.
- *Pippenger* (large public aggregations): per w-bit window, sort the
  points by digit (a stable sort and one row gather), then a chunked
  segmented scan — each of L lanes accumulates a run of C = N / L sorted
  points (`segscan`), and a log2(L) Hillis–Steele pass stitches the runs
  that cross lanes (`fixup`) — then a per-bucket run-end lookup fills the
  bucket array, reduced as sum_b b * S_b by a suffix scan and an all-reduce
  (`bucket_reduce`); one Horner combine across the windows ends it
  (`horner`). The four phases are the hand-written kernels of
  ops/kernels.py on a CUDA tensor and their plain twins on a CPU tensor;
  the sort, the gather and the lookup are plain torch, as tpu_ecc left
  them to XLA. The sort order depends on the digits: use Straus for secret
  scalars.

tpu_ecc ran the windows one after another; here a group of windows goes
through each phase side by side (`GROUP_BYTES`: 8 windows at 2^20 points),
which puts 65536 lanes, not 8192, in each launch; the limbs of every window
are the same. The payload enters as int32 point-major rows [N, 3n],
converted once: the port's int64 limbs would double the 252 MB a 2^20-point
window gathers.

Sharded (`msm(mesh=...)`, `msm_sharded`): the point axis is split over the
named axes of a DeviceMesh (parallel/collectives.py), one contiguous shard
a rank; each rank packs and sums its own shard with the methods above,
and the one-point partials fold over the axes, innermost first, by a ring
of neighbour exchanges or by a gather and a log-depth tree. Point
addition is not an arithmetic all-reduce, so the fold's add is
`points.add_limbs`, the step of tpu_ecc's `padd` and `steady`.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.profiler import record_function

from .. import resolve_device
from ..curves.specs import CurveSpec
from ..ops import fe as F
from ..ops import kernels
from ..ops import points as P
from ..ops import scalarmul as SM
from ..ops.points import Point
from . import collectives as CL


def tree_reduce_points(pt: Point) -> Point:
    """Fold the last batch axis of a point batch into one point: lane 0 of
    log2(B) rounds of acc += roll(acc, -2^k). B must be a power of two;
    padding lanes hold the identity."""
    B = pt.batch_shape[-1]
    assert B & (B - 1) == 0, "tree_reduce needs power-of-two lanes"
    return P.point_from_limbs(pt.curve,
                              P.tree_total_limbs(pt.curve, P.point_limbs(P.steady(pt))))


# ---------------------------------------------------------------------------
# Straus (small N / secret scalars)
# ---------------------------------------------------------------------------

def _pick_lanes(N: int, terms: int) -> int:
    per = N // terms
    lanes = min(per & (-per), 4096)       # largest power-of-two divisor
    assert N % (terms * lanes) == 0, (N, terms, lanes)
    return lanes


def _lincomb_terms(curve: CurveSpec, pts: Point, k_limbs: torch.Tensor, terms: int,
                   scalar_bits=None) -> Point:
    """lincomb over the terms axis: pts batch [T, B], k_limbs [ns, T, B] ->
    Point batch [B], through scalarmul.lincomb_auto (the `ladder` kernel), as
    tpu_ecc routes it on its accelerator."""
    assert terms & (terms - 1) == 0, "terms must be a power of two"
    pl = P.point_limbs(pts)                                   # [3, n, T, B]
    return SM.lincomb_auto([(P.point_from_limbs(curve, pl[:, :, t]), k_limbs[:, t])
                            for t in range(terms)], scalar_bits)


def msm_local_lanes(curve: CurveSpec, xs: F.FE, ys: F.FE, inf_mask: torch.Tensor,
                    k_limbs: torch.Tensor, terms: int = 8, scalar_bits=None) -> Point:
    """Straus MSM partials: per-lane sums, batch [lanes] (not reduced)."""
    N = xs.batch_shape[0]
    lanes = _pick_lanes(N, terms)
    shape = (N // (terms * lanes), terms, lanes)

    def part(fe, g):
        return F.FE(fe.limbs.reshape(-1, *shape)[:, g], fe.spec, fe.bound, fe.vmax)

    inf_r = inf_mask.reshape(shape)
    k_r = k_limbs.reshape(-1, *shape)
    acc = P.identity(curve, (lanes,), xs.device)
    for g in range(shape[0]):
        pts = P.from_affine(curve, part(xs, g), part(ys, g), inf_r[g])
        acc = P.steady(P.padd(acc, _lincomb_terms(curve, pts, k_r[:, g], terms,
                                                  scalar_bits)))
    return acc


def msm_local(curve: CurveSpec, xs: F.FE, ys: F.FE, inf_mask: torch.Tensor,
              k_limbs: torch.Tensor, terms: int = 8, scalar_bits=None) -> Point:
    """Straus MSM over one device's points -> a single point (batch ()).

    xs, ys: FE with batch [N]; inf_mask: bool [N] identity markers (padding);
    k_limbs: [ns, N] canonical scalars. N must be divisible by terms * lanes;
    the caller pads with identity points and zero scalars."""
    return tree_reduce_points(
        msm_local_lanes(curve, xs, ys, inf_mask, k_limbs, terms, scalar_bits))


# ---------------------------------------------------------------------------
# Pippenger (large N): sort + chunked segmented scan + buckets
# ---------------------------------------------------------------------------

def wide_window_digits(curve: CurveSpec, k_limbs: torch.Tensor, w: int,
                       scalar_bits=None) -> torch.Tensor:
    """w-bit windows of canonical scalar limbs [ns, *batch], MSB window
    first -> [nw, *batch]."""
    s = curve.scalar
    b = s.limb_bits
    assert 1 <= w <= 16
    nw = -(-(scalar_bits or s.bits) // w)
    digs = []
    for j in range(nw):
        lo = w * j
        acc = 0
        for li in range(lo // b, min(s.n_limbs - 1, (lo + w - 1) // b) + 1):
            base = b * li
            acc = acc | (k_limbs[li] << (base - lo) if base >= lo
                         else k_limbs[li] >> (lo - base))
        digs.append(acc & ((1 << w) - 1))
    return torch.stack(digs[::-1], 0)


def wide_window_digits_signed(curve: CurveSpec, k_limbs: torch.Tensor, w: int,
                              scalar_bits=None):
    """Signed w-bit windows, digits in [-2^(w-1), 2^(w-1)], so the bucket
    space halves (nbuck = 2^(w-1)). Returns (keys [nw', *batch], negs bool
    [nw', *batch]), MSB window first: key = |digit| - 1, or the sentinel
    nbuck for digit 0; negs marks digit < 0. Bucket b weighs b + 1. Where the
    top window can carry out (bits % w == 0) an extra MSB row holds the
    carry (nw' = nw + 1)."""
    bits = scalar_bits or curve.scalar.bits
    digs = wide_window_digits(curve, k_limbs, w, scalar_bits).flip(0)  # LSB first
    nw = digs.shape[0]
    half, full = 1 << (w - 1), 1 << w
    keys, negs = [], []
    carry = torch.zeros_like(digs[0])
    for j in range(nw):
        t = digs[j] + carry
        carry = (t > half).to(t.dtype)
        mag = torch.where(carry == 1, full - t, t)
        keys.append(torch.where(mag == 0, half, mag - 1))
        negs.append((carry == 1) & (mag != 0))
    if bits - w * (nw - 1) == w:                   # the top window can carry out
        keys.append(torch.where(carry == 1, 0, half))
        negs.append(torch.zeros_like(negs[0]))
    return torch.stack(keys[::-1], 0), torch.stack(negs[::-1], 0)


def pippenger_inputs(curve: CurveSpec, xs: F.FE, ys: F.FE, inf_mask: torch.Tensor,
                     k_limbs: torch.Tensor, w: int, scalar_bits=None, signed: bool = False):
    """Pippenger's per-MSM inputs: (payload int32 point rows [N, 3n], the
    steady limbs of each point converted once; keys int32 [nw, N], MSB
    window first; negs bool [nw, N] or None; nbuck)."""
    n = curve.field.n_limbs
    N = xs.batch_shape[0]
    pts = P.steady(P.from_affine(curve, xs, ys, inf_mask))
    payload = P.point_limbs(pts).reshape(3 * n, N).T.to(torch.int32).contiguous()
    if signed:
        keys, negs = wide_window_digits_signed(curve, k_limbs, w, scalar_bits)
    else:
        keys, negs = wide_window_digits(curve, k_limbs, w, scalar_bits), None
    return payload, keys.to(torch.int32), negs, 1 << (w - 1) if signed else 1 << w


def sorted_windows(payload: torch.Tensor, keys: torch.Tensor, negs, L: int):
    """A group of windows' points sorted by key (a stable sort per window,
    one row gather) in the chunk layout, windows side by side and lane l of
    a window holding its sorted[l*C : (l+1)*C]. keys [G, N], negs [G, N] or
    None -> (skey [G, N], key2 [C, G, L], val2 int32 [C, 3, n, G, L], neg2
    bool [C, G, L] or None)."""
    N, pn = payload.shape
    G, C = keys.shape[0], N // L
    skey, order = torch.sort(keys, dim=-1, stable=True)
    key2 = skey.reshape(G, L, C).permute(2, 0, 1).contiguous()
    val2 = (payload.index_select(0, order.reshape(-1)).reshape(G, L, C, pn)
            .permute(2, 3, 0, 1).contiguous().reshape(C, 3, pn // 3, G, L))
    neg2 = None if negs is None else (
        negs.gather(1, order).reshape(G, L, C).permute(2, 0, 1).contiguous())
    return skey, key2, val2, neg2


def bucket_lookup(curve: CurveSpec, skey: torch.Tensor, scanned: torch.Tensor,
                  fixed: torch.Tensor, first_key: torch.Tensor, nbuck: int) -> torch.Tensor:
    """The bucket arrays int32 [3, n, G, nbuck] of a group of windows: each
    bucket's value at the last sorted position of its key (a binary search
    and a gather of nbuck rows, not a scatter of N). A run that reaches its
    lane's start spans lanes, and its whole sum is the fixed lane value; an
    empty bucket is O. skey [G, N]; scanned [C, 3, n, G, L]; fixed
    [3, n, G, L]; first_key [G, L]."""
    C, G = scanned.shape[0], skey.shape[0]
    bids = torch.arange(nbuck, dtype=skey.dtype, device=skey.device).expand(G, nbuck)
    bidx = torch.searchsorted(skey, bids.contiguous(), right=True) - 1
    safe = bidx.clamp(min=0)
    have = (bidx >= 0) & (skey.gather(1, safe) == bids)
    lane, pos = safe // C, safe % C
    win = torch.arange(G, device=skey.device)[:, None]
    end_vals = scanned[pos, :, :, win, lane].permute(2, 3, 0, 1)
    spans = first_key.gather(1, lane) == bids
    ident = P.point_limbs(P.identity(curve, (1, 1), skey.device)).to(torch.int32)
    return torch.where(have & spans, fixed[:, :, win, lane],
                       torch.where(have, end_vals, ident))


PHASES = ("digits and payload", "sort and gather", "segscan", "fixup", "bucket lookup",
          "bucket_reduce", "horner")
"""The steps of `msm_pippenger`, each run inside a profiler range named
"msm/<step>" (`torch.profiler.record_function`; no cost without a
profiler)."""


def _phase(name: str):
    return record_function(f"msm/{name}")


def window_sums(curve: CurveSpec, payload: torch.Tensor, keys: torch.Tensor, negs,
                L: int, nbuck: int, signed: bool) -> torch.Tensor:
    """The weighted bucket sums S_j of a group of windows -> int32 [3, n, G];
    the windows go side by side through each phase kernel."""
    with _phase("sort and gather"):
        skey, key2, val2, neg2 = sorted_windows(payload, keys, negs, L)
    with _phase("segscan"):
        scanned, last_key, tail, lead = kernels.segscan(curve, key2, val2, nbuck, neg2)
    with _phase("fixup"):
        fixed = kernels.fixup(curve, tail, last_key, key2[0], lead)
    with _phase("bucket lookup"):
        buckets = bucket_lookup(curve, skey, scanned, fixed, key2[0], nbuck)
    # unsigned: bucket b holds digit b, bucket 0 dropped; signed: bucket b
    # holds |digit| = b + 1, every suffix counts
    with _phase("bucket_reduce"):
        return kernels.bucket_reduce(curve, buckets, drop0=not signed)


GROUP_BYTES = 1 << 31
"""The gathered payload of the windows that go through the phases together
(2 GiB: 8 windows of 2^20 points); the phase kernels' other arrays are a
few times as large."""


def msm_pippenger(curve: CurveSpec, xs: F.FE, ys: F.FE, inf_mask: torch.Tensor,
                  k_limbs: torch.Tensor, w: int = 13, lanes: int = 8192,
                  scalar_bits=None, signed: bool = False) -> Point:
    """Bucketed Pippenger MSM -> a single point (batch ()); see the module
    doc. N must be a multiple of `lanes` (a power of two); w <= 16. `signed`
    recodes the digits to signed windows (wide_window_digits_signed): half
    the buckets, so w can grow one step at the same bucket count; the
    y-negation of points with a negative digit happens inside `segscan`."""
    N = xs.batch_shape[0]
    L = min(lanes, N & (-N))
    assert N % L == 0 and L & (L - 1) == 0, (N, L)
    with _phase("digits and payload"):
        payload, keys, negs, nbuck = pippenger_inputs(curve, xs, ys, inf_mask, k_limbs,
                                                      w, scalar_bits, signed)
    per = max(1, GROUP_BYTES // payload[:1].nbytes // N)
    sums = [window_sums(curve, payload, keys[j:j + per],
                        None if negs is None else negs[j:j + per], L, nbuck, signed)
            for j in range(0, keys.shape[0], per)]
    # one Horner combine acc = 2^w * acc + S_j, MSB window first
    with _phase("horner"):
        out = kernels.horner(curve, torch.cat(sums, -1).permute(2, 0, 1), w)
    return P.point_from_limbs(curve, out.to(F.LIMB))


def msm_limbs(curve: CurveSpec, xs_l: torch.Tensor, ys_l: torch.Tensor,
              inf_mask: torch.Tensor, k_limbs: torch.Tensor, method: str,
              terms: int = 8, scalar_bits=None, w: int = 13, lanes: int = 8192,
              signed: bool = False) -> torch.Tensor:
    """The device side of `msm`: packed, padded inputs (affine limbs
    xs_l, ys_l [n, N], inf_mask bool [N], scalar limbs [ns, N]) -> the sum
    as point limbs [3, n]."""
    f = curve.field
    xs, ys = F.fe_steady(f, xs_l), F.fe_steady(f, ys_l)
    if method == "pippenger":
        pt = msm_pippenger(curve, xs, ys, inf_mask, k_limbs, w=w, lanes=lanes,
                           scalar_bits=scalar_bits, signed=signed)
    elif method == "straus":
        pt = msm_local(curve, xs, ys, inf_mask, k_limbs, terms, scalar_bits)
    else:
        raise ValueError(f"unknown MSM method {method!r}")
    return P.point_limbs(pt)


# ---------------------------------------------------------------------------
# sharded over the ranks of a mesh
# ---------------------------------------------------------------------------

REDUCE_METHODS = ("auto", "ring", "gather")


def _mesh_axes(mesh, axis, reduce_method: str) -> tuple:
    """The mesh's axes named by `axis` (one name or a tuple, outermost
    first), after checking the mesh's type and the reduce method."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, not {type(mesh).__name__}")
    if reduce_method not in REDUCE_METHODS:
        raise ValueError(f"unknown reduce_method {reduce_method!r}: one of {REDUCE_METHODS}")
    return (axis,) if isinstance(axis, str) else tuple(axis)


def fold_partials(curve: CurveSpec, mesh, axis, packed: torch.Tensor,
                  reduce_method: str = "auto") -> torch.Tensor:
    """Fold every rank's partial point limbs packed [3, n, B] (B a power
    of two) over the mesh axes `axis`, innermost first -> the total [3, n],
    the same point on every rank (rank r's limbs are tpu_ecc's device
    r's). Per axis: "ring" folds the local lanes to one point by the tree
    and passes it round the ring (`ppermute_ring_reduce`), "gather"
    gathers the lanes of the axis and folds them by the tree, "auto" takes
    the ring on an axis of at most 8 ranks and the gather above."""
    axes = _mesh_axes(mesh, axis, reduce_method)

    def tree(limbs):
        return P.point_limbs(tree_reduce_points(P.point_from_limbs(curve, limbs)))

    for ax in reversed(axes):
        kind = reduce_method
        if kind == "auto":
            kind = "ring" if CL.axis_size(mesh, ax) <= 8 else "gather"
        if kind == "ring":
            packed = CL.ppermute_ring_reduce(
                tree(packed), mesh, ax, lambda a, b: P.add_limbs(curve, a, b))[..., None]
        else:
            packed = tree(CL.all_gather(packed, mesh, ax, axis=2))[..., None]
    return packed[..., 0]


def msm_sharded(curve: CurveSpec, mesh, axis, xs_l: torch.Tensor, ys_l: torch.Tensor,
                inf_mask: torch.Tensor, k_l: torch.Tensor, terms: int = 8,
                scalar_bits=None, method: str = "straus", w: int = 13,
                lanes: int = 8192, reduce_method: str = "auto",
                signed: bool = False) -> torch.Tensor:
    """The MSM of points sharded over `axis` of `mesh` (one axis name or a
    tuple, outermost first, e.g. ("dcn", "ici")); every rank of the mesh
    calls it with its own shard: affine limbs xs_l, ys_l [n, N/D], inf_mask
    bool [N/D], scalar limbs k_l [ns, N/D]. Returns this rank's copy of the
    sum's point limbs [3, n]; every rank's is the same point.

    The rank's partial comes from `msm_pippenger` (one point) or from the
    Straus lanes (`msm_local_lanes`, [lanes] points unfolded); the partials
    then fold over the axes (`fold_partials`), innermost first, so that on
    a hierarchical mesh only one folded point a slice crosses each outer
    axis."""
    _mesh_axes(mesh, axis, reduce_method)
    if method == "straus":
        f = curve.field
        packed = P.point_limbs(msm_local_lanes(curve, F.fe_steady(f, xs_l), F.fe_steady(f, ys_l),
                                               inf_mask, k_l, terms, scalar_bits))
    else:                                                  # one point: [3, n, 1]
        packed = msm_limbs(curve, xs_l, ys_l, inf_mask, k_l, method, terms, scalar_bits, w,
                           lanes, signed)[..., None]
    return fold_partials(curve, mesh, axis, packed, reduce_method)


# ---------------------------------------------------------------------------
# host entry
# ---------------------------------------------------------------------------

def pack(curve: CurveSpec, points, scalars, unit: int, device=None):
    """Host points [(x, y)] and scalars -> (xs_l, ys_l [n, Np], inf_mask
    bool [Np], k_limbs [ns, Np]) on `device` (the card unless another is
    named), padded to a multiple of `unit` with identity points and zero
    scalars."""
    dev = resolve_device(device)
    f = curve.field
    N = len(points)
    pad = -(-max(N, 1) // unit) * unit - N
    xs_l = F.fe_from_ints(f, [p[0] for p in points] + [curve.gx] * pad, dev).limbs
    ys_l = F.fe_from_ints(f, [p[1] for p in points] + [curve.gy] * pad, dev).limbs
    inf = torch.arange(N + pad, device=dev) >= N
    return xs_l, ys_l, inf, SM.pack_scalars(curve, list(scalars) + [0] * pad, dev)


def msm(curve: CurveSpec, points, scalars, mesh=None, axis="dp", terms: int = 8,
        scalar_bits=None, method: str = "auto", w: int | None = None,
        lanes: int = 8192, reduce_method: str = "auto", signed: bool | None = None,
        device=None):
    """Host entry: points = [(x, y) ints], scalars = [ints] -> the affine sum
    (x, y), or None for the identity. Runs on the card unless `device` names
    another.

    Pads to a lane-, term- and shard-aligned size with identity points,
    packs, runs `msm_limbs` (or, on a mesh, `msm_sharded`) and converts the
    result to affine. method: 'straus' (constant-time; small N),
    'pippenger' (large public aggregations) or 'auto' (Pippenger from 2^14
    points a shard). Pippenger is signed with w = 14 by default (unsigned:
    w = 13).

    mesh: a DeviceMesh (parallel/collectives.py) whose every rank calls
    msm() with the same arguments; the point axis is sharded over `axis`
    (one axis name or a tuple, outermost first), each rank packs only its
    own shard, the partials fold by `reduce_method` ("ring", "gather" or
    "auto", see `fold_partials`), and every rank returns the same sum."""
    dev = resolve_device(device)
    N = len(points)
    D = 1
    if mesh is not None:
        axes = _mesh_axes(mesh, axis, reduce_method)
        D = math.prod(CL.axis_size(mesh, ax) for ax in axes)
    if method == "auto":
        method = "pippenger" if N // D >= (1 << 14) else "straus"
    if signed is None:
        signed = method == "pippenger"
    if w is None:
        w = 14 if signed else 13
    if method == "pippenger":
        lanes = min(lanes, 1 << max((N // D).bit_length() - 3, 3))
        unit = lanes * D
    else:
        unit = terms * 128 * D
    if mesh is None:
        out = msm_limbs(curve, *pack(curve, points, scalars, unit, dev), method, terms,
                        scalar_bits, w, lanes, signed)
    else:
        # the padding is global, as tpu_ecc's, so the shards split where its do
        part = CL.shard_slice(mesh, axes, -(-max(N, 1) // unit) * unit)
        out = msm_sharded(curve, mesh, axes,
                          *pack(curve, list(points)[part], list(scalars)[part],
                                part.stop - part.start, dev),
                          terms, scalar_bits, method, w, lanes, reduce_method, signed)
    x, y, is_inf = P.to_affine(P.point_from_limbs(curve, out))
    if bool(is_inf):
        return None
    return F.fe_to_ints(x)[0], F.fe_to_ints(y)[0]
