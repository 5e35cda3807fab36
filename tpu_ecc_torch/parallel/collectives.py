"""Collective and mesh layer of the sharded MSM: the one place that calls
torch.distributed.

The port of tpu_ecc/parallel/collectives.py. JAX's named `Mesh` becomes a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the default
process group, which the caller initialises: it chooses the backend and
the rendezvous (`init_process_group(backend, init_method=..., rank=...,
world_size=...)`), and this module chooses neither. Where JAX ran the
collectives inside one SPMD program over all devices, here every rank runs
the same Python and meets the others in the collective.

Transport: on an NCCL group the payload stays on the card; on a gloo group
it is copied to host memory and back around the collective (gloo moves
host tensors). Either way the caller's tensor, and the work on it, stay on
its own device.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _axes(axis) -> tuple:
    """One mesh axis name, or a tuple ordered outermost first."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


def make_mesh(n_devices: int | None = None, axis: str = "dp",
              shape: tuple | None = None, axes: tuple | None = None) -> DeviceMesh:
    """A 1-D mesh of the first n_devices ranks (default: every rank of the
    default group) named `axis`; or pass shape/axes for multi-axis layouts,
    e.g. shape=(hosts, cards_per_host), axes=("dcn", "ici"), ranks laid out
    row-major, so that the innermost axis joins neighbouring ranks. Every
    rank calls it, in the same order (it makes each axis's groups). The
    mesh's device type follows the default group's backend: "cuda" for
    NCCL, "cpu" otherwise."""
    if shape is None:
        n = n_devices or dist.get_world_size()
        shape, names = (n,), (axis,)
    else:
        names = axes or tuple(f"ax{i}" for i in range(len(shape)))
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names))


def axis_size(mesh: DeviceMesh, mesh_axis: str) -> int:
    """The size of a named mesh axis."""
    return mesh.shape[mesh.mesh_dim_names.index(mesh_axis)]


def shard_slice(mesh: DeviceMesh, axis, n: int) -> slice:
    """This rank's contiguous part of n items sharded over `axis` (one mesh
    axis name or a tuple, outermost first). Shards are ordered as JAX's
    PartitionSpec(axes) orders them, the outermost axis major; on a mesh of
    `make_mesh` the shard index is the global rank. n must be a multiple
    of the shard count."""
    index, count = 0, 1
    for ax in _axes(axis):
        size = axis_size(mesh, ax)
        index, count = index * size + mesh.get_local_rank(ax), count * size
    if n % count:
        raise ValueError(f"{n} items do not split into {count} equal shards")
    per = n // count
    return slice(index * per, (index + 1) * per)


def shard_batch(mesh: DeviceMesh, axis, arr, batch_axis: int = -1):
    """This rank's contiguous slice of `arr` (a tensor or an array) along
    `batch_axis`, sharded over `axis` (see `shard_slice`)."""
    dim = batch_axis % arr.ndim
    return arr[(slice(None),) * dim + (shard_slice(mesh, axis, arr.shape[dim]),)]


def _wire(group, x: torch.Tensor) -> torch.Tensor:
    """x as the group's backend moves it: on its card for NCCL, in host
    memory for gloo."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        return x.contiguous()
    if backend == "gloo":
        return x.cpu().contiguous()
    raise ValueError(f"no transport for the {backend!r} backend (nccl or gloo)")


def all_gather(x: torch.Tensor, mesh: DeviceMesh, mesh_axis: str, axis: int = 0) -> torch.Tensor:
    """Gather the ranks' x over `mesh_axis`, concatenated along array dim
    `axis` in group-rank order (JAX's tiled all_gather; the MSM partials'
    gather fold, parallel/msm.py::fold_partials)."""
    group = mesh.get_group(mesh_axis)
    wire = _wire(group, x)
    parts = [torch.empty_like(wire) for _ in range(group.size())]
    dist.all_gather(parts, wire, group=group)
    return torch.cat(parts, axis).to(x.device)


def ppermute_ring_reduce(x: torch.Tensor, mesh: DeviceMesh, mesh_axis: str, fold):
    """Ring all-reduce with an arbitrary fold over `mesh_axis`: D - 1 steps,
    in each of which every rank sends to group rank r + 1, receives from
    r - 1, folds acc = fold(acc, received) and sends what it received in
    the next step: the order of tpu_ecc's ppermute(perm=[(i, (i+1) % D)])
    inside one lax.scan, so that rank r's result is tpu_ecc's device r's.

    Traffic is nearest-neighbour and memory one payload, at the cost of
    D - 1 folds one after another (the gather fold's tree takes log2 D).
    `fold` must be associative and commutative over the payload (point
    addition is); every rank ends with the full reduction."""
    group = mesh.get_group(mesh_axis)
    D, r = group.size(), dist.get_rank(group)
    to = dist.get_global_rank(group, (r + 1) % D)
    frm = dist.get_global_rank(group, (r - 1) % D)
    acc, send = x, x
    for _ in range(D - 1):
        out = _wire(group, send)
        recv = torch.empty_like(out)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, out, to, group),
                                           dist.P2POp(dist.irecv, recv, frm, group)]):
            req.wait()
        send = recv.to(x.device)
        acc = fold(acc, send)
    return acc
