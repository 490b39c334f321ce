"""Resampling step: draw the next active set from ALL historical particles.

Counterpart of tempest_tpu/steps/resample.py:26-57 on the unclustered
path: the CDF is inverted over the t-major flattened weights and every
walker gets cluster label 0. The uniforms come in as an argument: (n,)
for multinomial resampling, one for systematic.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.tools import multinomial_resample, systematic_resample
from ..state import History, gather_history


def resample(
    uniforms: torch.Tensor,
    hist: History,
    weights: torch.Tensor,
    n_particles: int,
    method: str = "mult",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(u, x, logl, assignments) of the new active set.

    `weights` are the normalized (T_max, N) MIS weights; masked slots carry
    zero weight and are never selected.
    """
    N = hist.n_particles
    w_flat = weights.reshape(-1)
    if method == "mult":
        idx = multinomial_resample(uniforms, w_flat)
    elif method == "syst":
        idx = systematic_resample(uniforms, n_particles, w_flat)
    else:
        raise ValueError(f"Unknown resample method {method}")
    u, x, logl = gather_history(hist, idx // N, idx % N)
    assignments = torch.zeros((n_particles,), dtype=torch.int32, device=u.device)
    return u, x, logl, assignments
