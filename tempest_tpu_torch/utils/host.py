"""Device -> host transfers that hold under a particle mesh
(tempest_tpu/utils/host.py).

Under a mesh each rank holds its block of the particle axis, so a global
value is an `all_gather` along that axis: a collective, which every rank
must call at the same point. That holds here, because every host decision
of the loop reads a value that is the same on every rank. Without a group
`fetch` is the tensor's value as a numpy array.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.distributed import is_primary  # noqa: F401  (re-exported)


def fetch(t: torch.Tensor, group=None, dim: Optional[int] = None) -> np.ndarray:
    """The value of `t` as a numpy array; with a group and the particle
    dimension `dim`, the blocks of every rank gathered along it."""
    if group is not None and dim is not None:
        from ..parallel.mesh import all_gather

        t = all_gather(t, group, dim)
    return t.detach().cpu().numpy()


def fetch_tree(tree, group=None) -> Dict[str, object]:
    """Every field of a History or Current as numpy (None and Python
    numbers kept), the sharded fields gathered over `group`."""
    from ..parallel.mesh import current_sharding, history_sharding
    from ..state import History

    dims = history_sharding() if isinstance(tree, History) else current_sharding()
    out = {}
    for f in dataclasses.fields(tree):
        value = getattr(tree, f.name)
        out[f.name] = (fetch(value, group, dims[f.name]).copy()
                       if isinstance(value, torch.Tensor) else value)
    return out


def sync(group=None) -> None:
    """Barrier across the ranks of `group`; a no-op without one."""
    if group is not None and dist.get_world_size(group) > 1:
        dist.barrier(group=group)
