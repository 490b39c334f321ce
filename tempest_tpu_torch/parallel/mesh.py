"""The particle mesh and the block layout of the sharded state
(tempest_tpu/parallel/mesh.py).

The scalable dimension of Persistent Sampling is the particle axis: the
history grows by N samples an iteration. JAX shards it over a 1-D mesh
of devices and lets XLA insert the collectives. Here the mesh is a 1-D
`torch.distributed.device_mesh.DeviceMesh` of W ranks, one device each,
and every collective is explicit (ops/tools.py, parallel/collective.py).

Block layout: rank r holds particle columns [r N/W, (r+1) N/W) of every
particle-indexed buffer, the last dimension of the history's (d, T, N) and
(T, N) buffers and the first of the active set's (N, ...) rows. The
per-iteration scalars are replicated: every rank holds the same values.
The canonical sample order stays t-major, s = t N + r N/W + n, so a run
gathered back (`unshard_history`, `utils.host.fetch`) is laid out as a
run on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..state import Current, History

# The particle dimension of each sharded field; every other field is
# replicated (JAX's `history_sharding` / `current_sharding`, :39-66).
_HISTORY_DIMS = {"u": 2, "x": 2, "logl": 1, "mis_c": 1, "blobs": 2}
_CURRENT_DIMS = {"u": 0, "x": 0, "logl": 0, "blobs": 0, "assignments": 0}


def make_particle_mesh(n_devices: Optional[int] = None, axis_name: str = "particles",
                       device="cuda"):
    """1-D mesh over every rank of the process group, one device per rank.

    The group must be up (`parallel.distributed.initialize`). `n_devices`,
    where given, must equal the world size: a rank owns one device."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_particle_mesh needs a process group: call "
            "tempest_tpu_torch.parallel.distributed.initialize() first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"n_devices ({n_devices}) must equal the world size ({world}): each rank "
            "drives one device")
    return init_device_mesh(torch.device(device).type, (world,), mesh_dim_names=(axis_name,))


def history_sharding() -> Dict[str, Optional[int]]:
    """The particle dimension of each History field, None where replicated."""
    return {f.name: _HISTORY_DIMS.get(f.name) for f in dataclasses.fields(History)}


def current_sharding() -> Dict[str, Optional[int]]:
    """The particle dimension of each Current field, None where replicated."""
    return {f.name: _CURRENT_DIMS.get(f.name) for f in dataclasses.fields(Current)}


def particle_group(mesh, axis_name: str = "particles"):
    """The process group of the mesh's particle axis."""
    return mesh.get_group(axis_name)


def block(n_global: int, group):
    """(start, stop) of this rank's particle columns."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    n_local = n_global // world
    return rank * n_local, (rank + 1) * n_local


def _shard(tree, dims: Dict[str, Optional[int]], mesh, axis_name: str):
    group = particle_group(mesh, axis_name)
    out = {}
    for name, dim in dims.items():
        value = getattr(tree, name)
        if dim is not None and value is not None:
            lo, hi = block(value.shape[dim], group)
            value = value.narrow(dim, lo, hi - lo).clone()
        out[name] = value
    return type(tree)(**out)


def shard_history(hist: History, mesh, axis_name: str = "particles") -> History:
    """This rank's block of a global History."""
    return _shard(hist, history_sharding(), mesh, axis_name)


def shard_current(cur: Current, mesh, axis_name: str = "particles") -> Current:
    """This rank's block of a global Current."""
    return _shard(cur, current_sharding(), mesh, axis_name)


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The blocks of every rank concatenated along `dim`, in rank order (a
    collective: every rank of the group calls it)."""
    world = dist.get_world_size(group)
    wire = torch.uint8 if t.dtype == torch.bool else t.dtype  # gloo moves no bool
    moved = torch.movedim(t, dim, 0).to(wire).contiguous()
    out = torch.empty((world * moved.shape[0],) + tuple(moved.shape[1:]),
                      dtype=wire, device=moved.device)
    dist.all_gather_into_tensor(out, moved, group=group)
    return torch.movedim(out, 0, dim).to(t.dtype).contiguous()


def _unshard(tree, dims: Dict[str, Optional[int]], group):
    out = {}
    for name, dim in dims.items():
        value = getattr(tree, name)
        out[name] = value if dim is None or value is None else all_gather(value, group, dim)
    return type(tree)(**out)


def unshard_history(hist: History, group) -> History:
    """The global History, gathered from every rank's block (a collective)."""
    return _unshard(hist, history_sharding(), group)


def unshard_current(cur: Current, group) -> Current:
    """The global Current, gathered from every rank's block (a collective)."""
    return _unshard(cur, current_sharding(), group)
