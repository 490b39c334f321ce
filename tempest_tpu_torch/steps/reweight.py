"""Reweighting step: pick the next inverse temperature, ESS mode.

Counterpart of the ESS-mode branch of tempest_tpu/steps/reweight.py
(:195-224) and its final weights/ESS/CV/logZ (:243-248). The bisection is
`ops.cuda_reweight.ess_bisect_beta`: the CUDA kernel for a history on the
GPU, its plain version for a history on the CPU. Dynamic/CV mode waits for
ROADMAP.md queue 1, item 11.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.cuda_reweight import ess_bisect_beta
from ..ops.tools import ess_from_logw, volume_variation_dtn
from ..state import History, logw_from_denominator, mis_denominator


class ReweightResult(NamedTuple):
    beta: torch.Tensor  # () new inverse temperature
    weights: torch.Tensor  # (T_max, N) normalized importance weights (masked)
    ess: torch.Tensor  # () effective sample size at beta
    cv: torch.Tensor  # () volume variation at beta
    logz: torch.Tensor  # () evidence estimate at beta


def reweight(hist: History, beta_prev: torch.Tensor, ess_target: float) -> ReweightResult:
    """Select the next beta by ESS bisection and compute the MIS weights.

    The beta-independent denominator is computed once (O(S)); invalid
    slots enter the bisection with Bm = +inf, so they weigh nothing.
    `hist.t` must be at least 1.
    """
    dtype, device = hist.logl.dtype, hist.logl.device
    denom = mis_denominator(hist)
    bm = torch.where(hist.sample_mask(), denom, torch.full_like(denom, float("inf")))
    scal = torch.stack(
        [
            torch.as_tensor(beta_prev, dtype=torch.float32, device=device).reshape(()),
            torch.tensor(ess_target, dtype=torch.float32, device=device),
        ]
    )
    beta, _ = ess_bisect_beta(hist.logl.reshape(-1), bm.reshape(-1), scal)
    beta = beta[0].to(dtype)

    logw, logz = logw_from_denominator(hist, denom, beta)
    weights = torch.exp(logw)  # normalized; masked entries are exp(-inf) = 0
    ess = ess_from_logw(logw)
    cv = volume_variation_dtn(hist.u, weights, mask=hist.sample_mask())
    return ReweightResult(beta=beta, weights=weights, ess=ess, cv=cv, logz=logz)
