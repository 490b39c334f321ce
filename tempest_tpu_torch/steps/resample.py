"""Resampling step: draw the next active set from ALL historical particles.

Counterpart of tempest_tpu/steps/resample.py:26-57: the CDF is inverted
over the t-major flattened weights, and each walker's cluster label comes
from `cluster_predict` with the fitted model, or is 0 without clustering.
The uniforms come in as an argument: (n,) for multinomial resampling, one
for systematic. Under a particle mesh (`group`, fused.py:168-177) the rows
come from `parallel.collective.sharded_resample` on the global positions,
and each rank labels its own block of walkers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..cluster import ClusterModel, cluster_predict
from ..ops.tools import multinomial_resample, systematic_resample
from ..parallel.collective import positions, sharded_resample
from ..state import History, gather_history


def resample(
    uniforms: torch.Tensor,
    hist: History,
    weights: torch.Tensor,
    n_particles: int,
    method: str = "mult",
    cluster_model: Optional[ClusterModel] = None,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """(u, x, logl, blobs, assignments) of the new active set; blobs is None
    when the history has none.

    `weights` are the normalized (T_max, N) MIS weights; masked slots carry
    zero weight and are never selected. With `cluster_model` the walkers
    are labelled by it; without, all get label 0. With `group`, `hist` and
    `weights` are this rank's blocks, `n_particles` is the global N and the
    set comes back as this rank's block.
    """
    if group is not None:
        u, x, logl, blobs = sharded_resample(
            positions(uniforms, n_particles, method), hist, weights, group)
    else:
        N = hist.n_particles
        w_flat = weights.reshape(-1)
        if method == "mult":
            idx = multinomial_resample(uniforms, w_flat)
        elif method == "syst":
            idx = systematic_resample(uniforms, n_particles, w_flat)
        else:
            raise ValueError(f"Unknown resample method {method}")
        u, x, logl, blobs = gather_history(hist, idx // N, idx % N)
    if cluster_model is not None:
        assignments = cluster_predict(cluster_model, u)
    else:
        assignments = torch.zeros((u.shape[0],), dtype=torch.int32, device=u.device)
    return u, x, logl, blobs, assignments
