"""State exchange with the JAX package, through numpy arrays.

This module has no counterpart in tempest_tpu. It turns the JAX package's
`History`, `Current`, `ModeStatistics` and `ClusterModel` fields, given as numpy arrays,
into this package's dataclasses, and back. It imports no jax: callers
pass `np.array(jax_value)` for each field. The arrays are copied, because
numpy views of JAX arrays are read-only and `torch.from_numpy` warns on
them.

A JAX state is global. Given a particle mesh, `history_from_numpy` and
`current_from_numpy` return this rank's block of it
(`parallel.mesh.shard_history`); given the mesh's group, the `_to_numpy`
functions gather the blocks back into the global state.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .cluster import MODEL_TENSORS as CLUSTER_FIELDS
from .cluster import ClusterModel
from .modes import ModeStatistics
from .state import Current, History
from .utils.host import fetch_tree

HISTORY_FIELDS = (
    "u", "x", "logl", "mis_c", "beta", "logz", "ess", "cv",
    "acceptance", "efficiency", "steps", "calls",
)
CURRENT_FIELDS = (
    "u", "x", "logl", "assignments", "beta", "logz", "ess", "cv",
    "acceptance", "efficiency",
)
CURRENT_COUNTERS = ("steps", "calls", "iteration")
MODE_FIELDS = (
    "means", "covariances", "degrees_of_freedom", "inv_covariances",
    "chol_covariances", "k_mask",
)


def _tensor(value, device) -> torch.Tensor:
    return torch.from_numpy(np.array(value, copy=True)).to(device)


def _blobs(fields: Mapping[str, np.ndarray], device):
    value = fields.get("blobs")
    return None if value is None else _tensor(value, device)


def history_from_numpy(fields: Mapping[str, np.ndarray], device, mesh=None,
                       axis_name: str = "particles") -> History:
    """History from the JAX History's fields (HISTORY_FIELDS, `t` and,
    optionally, `blobs`); this rank's block of it given a particle mesh."""
    hist = History(
        **{k: _tensor(fields[k], device) for k in HISTORY_FIELDS}, t=int(fields["t"]),
        blobs=_blobs(fields, device),
    )
    if mesh is None:
        return hist
    from .parallel.mesh import shard_history

    return shard_history(hist, mesh, axis_name)


def history_to_numpy(hist: History, group=None) -> Dict[str, np.ndarray]:
    """The History's fields as numpy, gathered over `group` under a mesh."""
    tree = fetch_tree(hist, group)
    out = {k: tree[k] for k in HISTORY_FIELDS}
    out["t"] = np.int32(hist.count())
    if hist.blobs is not None:
        out["blobs"] = tree["blobs"]
    return out


def current_from_numpy(fields: Mapping[str, np.ndarray], device, mesh=None,
                       axis_name: str = "particles") -> Current:
    """Current from the JAX Current's fields (CURRENT_FIELDS, CURRENT_COUNTERS
    and, optionally, `blobs`); this rank's block of it given a particle mesh."""
    cur = Current(
        **{k: _tensor(fields[k], device) for k in CURRENT_FIELDS},
        **{k: int(fields[k]) for k in CURRENT_COUNTERS},
        blobs=_blobs(fields, device),
    )
    if mesh is None:
        return cur
    from .parallel.mesh import shard_current

    return shard_current(cur, mesh, axis_name)


def current_to_numpy(cur: Current, group=None) -> Dict[str, np.ndarray]:
    """The Current's fields as numpy, gathered over `group` under a mesh."""
    tree = fetch_tree(cur, group)
    out = {k: tree[k] for k in CURRENT_FIELDS}
    out.update({k: np.int32(int(getattr(cur, k))) for k in CURRENT_COUNTERS})
    if cur.blobs is not None:
        out["blobs"] = tree["blobs"]
    return out


def modes_from_numpy(fields: Mapping[str, np.ndarray], device) -> ModeStatistics:
    return ModeStatistics(**{k: _tensor(fields[k], device) for k in MODE_FIELDS})


def modes_to_numpy(modes: ModeStatistics) -> Dict[str, np.ndarray]:
    return {k: getattr(modes, k).detach().cpu().numpy().copy() for k in MODE_FIELDS}


def cluster_model_from_numpy(fields: Mapping[str, np.ndarray], device) -> ClusterModel:
    """ClusterModel from the JAX model's fields (CLUSTER_FIELDS, the static
    `normalize` flag and, optionally, the carried `fitted` flag)."""
    return ClusterModel(
        **{k: _tensor(fields[k], device) for k in CLUSTER_FIELDS},
        normalize=bool(fields["normalize"]),
        fitted=bool(fields.get("fitted", True)),
    )


def cluster_model_to_numpy(model: ClusterModel) -> Dict[str, np.ndarray]:
    out = {k: getattr(model, k).detach().cpu().numpy().copy() for k in CLUSTER_FIELDS}
    out["normalize"] = model.normalize
    out["fitted"] = model.fitted
    return out
