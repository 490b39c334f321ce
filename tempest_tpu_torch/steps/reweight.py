"""Reweighting step: pick the next inverse temperature.

Counterpart of tempest_tpu/steps/reweight.py. Two modes, as there:

- ESS mode (:195-224): the bisection is `ops.cuda_reweight.ess_bisect_beta`,
  the CUDA kernel for a history on the GPU, its plain version for a
  history on the CPU. Under a particle mesh (`group`) JAX bypasses its
  kernel (tempest_tpu/fused.py:225) and bisects in XLA
  (`_find_beta_bisection`, :122-166); so does the port, at any world size:
  `_sharded_ess_beta` reduces each probe's ESS over the ranks.
- Dynamic mode (`volume_variation`, :225-241): an ESS bracket
  (`_find_ess_bracket`, :73-119), then a bisection on the volume-variation
  CV inside it (`_find_beta_bisection`, :122-166), with the boundary rules
  of :234-241. JAX runs no Pallas kernel in this mode, so neither does the
  port: plain PyTorch on the history's device. Every probe evaluates ESS or
  `volume_variation_dtn` over the whole masked history and reads one
  boolean on the host. `PROBES` counts the dynamic reweights and their
  probes in this process.

Both end with the final weights, ESS, CV and logZ at the chosen beta
(:243-248). Under a mesh every reduction goes over the ranks' blocks, and
each host decision reads a reduced value, the same on every rank, so the
ranks take the same probes and reach the same beta.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import (
    BETA_RTOL,
    BETA_TOLERANCE,
    ESS_TOLERANCE,
    MAX_BISECTION_ITERATIONS,
    METRIC_ATOL,
    METRIC_ATOL_CV,
)
from ..ops.cuda_reweight import ess_bisect_beta
from ..ops.tools import ess_from_logw_psum, volume_variation_dtn
from ..state import History, logw_from_denominator, masked_logw, mis_denominator

# Dynamic-mode reweights and their probes (ESS evaluations of the bracket
# search, CV evaluations of the boundary tests and the bisection).
PROBES = {"reweights": 0, "ess_bracket": 0, "cv": 0}


class ReweightResult(NamedTuple):
    beta: torch.Tensor  # () new inverse temperature
    weights: torch.Tensor  # (T_max, N) normalized importance weights (masked)
    ess: torch.Tensor  # () effective sample size at beta
    cv: torch.Tensor  # () volume variation at beta
    logz: torch.Tensor  # () evidence estimate at beta


def _interval_tol(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Bracket-scaled interval tolerance (reweight.py:41-44)."""
    scale = torch.clamp(torch.maximum(lo.abs(), hi.abs()), min=torch.finfo(lo.dtype).tiny)
    return torch.maximum(BETA_RTOL * scale, BETA_TOLERANCE * scale)


def _find_ess_bracket(ess_at: Callable, beta_prev, target, one):
    """[beta_low, beta_high] where ESS crosses the target (reweight.py:73-119):
    both beta_prev when ESS(beta_prev) <= target, both 1 when ESS(1) >=
    target, else bisected down to the interval tolerance."""
    ess_cur, ess_one = ess_at(beta_prev), ess_at(one)
    if bool(ess_cur > target) and bool(ess_one >= target):
        return one, one
    if bool(ess_cur <= target) or bool(ess_one >= target):
        return beta_prev, beta_prev
    lo, hi = beta_prev, one
    for _ in range(MAX_BISECTION_ITERATIONS):
        if not bool((hi - lo) > _interval_tol(lo, hi)):
            break
        mid = 0.5 * (lo + hi)
        if bool(ess_at(mid) >= target):
            lo = mid
        else:
            hi = mid
    return lo, hi


def _find_cv_bisection(cv_at: Callable, lo, hi, target):
    """Bisection of beta on CV in [lo, hi] (reweight.py:122-166, dynamic):
    stop when |CV - target| < max(ESS_TOLERANCE |target|, METRIC_ATOL_CV),
    the interval is below tolerance or beta is 1; CV rises with beta;
    non-finite CV counts as 1e10; at most 200 probes."""
    atol = torch.clamp(ESS_TOLERANCE * target.abs(), min=METRIC_ATOL_CV)
    beta = 0.5 * (lo + hi)
    for _ in range(MAX_BISECTION_ITERATIONS):
        beta = 0.5 * (lo + hi)
        metric = cv_at(beta)
        metric = torch.where(torch.isfinite(metric), metric, torch.full_like(metric, 1e10))
        converged = (metric - target).abs() < atol
        if bool(converged | ((hi - lo) < _interval_tol(lo, hi)) | (beta == 1.0)):
            break
        if bool(metric < target):
            lo = beta
        else:
            hi = beta
    return beta


def _sharded_ess_beta(hist: History, denom, beta_prev, ess_target: float, group):
    """The next beta in ESS mode under a mesh: XLA's bisection of
    tempest_tpu/steps/reweight.py:195-224 and :122-166. Stay when
    ESS(beta_prev) <= target, jump to 1 when ESS(1) >= target, else bisect
    [beta_prev, 1] until |ESS - target| < max(ESS_TOLERANCE target,
    METRIC_ATOL), the interval is below tolerance or beta is 1; non-finite
    ESS counts as 1e10; at most 200 probes. Each probe reduces its ESS over
    the ranks (two collectives)."""
    dtype, device = hist.logl.dtype, hist.logl.device
    one = torch.ones((), dtype=dtype, device=device)
    target = torch.tensor(ess_target, dtype=dtype, device=device)

    def ess_at(beta):  # ESS does not depend on the normalization
        return ess_from_logw_psum(masked_logw(hist, denom, beta), group)

    if bool(ess_at(beta_prev) <= target):
        return beta_prev
    if bool(ess_at(one) >= target):
        return one
    atol = max(ESS_TOLERANCE * abs(float(ess_target)), METRIC_ATOL)
    lo, hi = beta_prev, one
    beta = 0.5 * (lo + hi)
    for _ in range(MAX_BISECTION_ITERATIONS):
        beta = 0.5 * (lo + hi)
        metric = ess_at(beta)
        metric = torch.where(torch.isfinite(metric), metric, torch.full_like(metric, 1e10))
        done = ((metric - target).abs() < atol) | ((hi - lo) < _interval_tol(lo, hi)) | (beta == 1.0)
        if bool(done):
            break
        if bool(metric >= target):
            lo = beta
        else:
            hi = beta
    return beta


def _dynamic_beta(hist: History, denom, beta_prev, ess_target: float, cv_target: float,
                  group=None):
    """The next beta in dynamic mode (reweight.py:225-241)."""
    dtype, device = hist.logl.dtype, hist.logl.device
    mask = hist.sample_mask()
    one = torch.ones((), dtype=dtype, device=device)
    target = torch.tensor(ess_target, dtype=dtype, device=device)
    cv_goal = torch.tensor(cv_target, dtype=dtype, device=device)
    PROBES["reweights"] += 1

    def ess_at(beta):
        PROBES["ess_bracket"] += 1
        return ess_from_logw_psum(logw_from_denominator(hist, denom, beta, group=group)[0], group)

    def cv_at(beta):
        PROBES["cv"] += 1
        logw, _ = logw_from_denominator(hist, denom, beta, group=group)
        return volume_variation_dtn(hist.u, torch.exp(logw), mask=mask, group=group)

    beta_low, beta_high = _find_ess_bracket(ess_at, beta_prev, target, one)
    if bool(beta_low == beta_high):  # no crossing
        return beta_low
    # Target above CV(beta_high) -> beta_high; at or below CV(beta_prev) ->
    # stay; else bisect between them.
    if bool(cv_goal >= cv_at(beta_high)):
        return beta_high
    if bool(cv_goal <= cv_at(beta_prev)):
        return beta_prev
    return _find_cv_bisection(cv_at, beta_prev, beta_high, cv_goal)


def reweight(
    hist: History,
    beta_prev: torch.Tensor,
    ess_target: float,
    cv_target: float = 0.0,
    dynamic: bool = False,
    group=None,
) -> ReweightResult:
    """Select the next beta and compute the MIS weights.

    The beta-independent denominator is computed once (O(S)); in ESS mode
    invalid slots enter the kernel with Bm = +inf, so they weigh nothing.
    `hist.t` must be at least 1. With `group` (a particle mesh) `hist` is
    this rank's block and the weights come back as its block.
    """
    dtype, device = hist.logl.dtype, hist.logl.device
    denom = mis_denominator(hist)
    beta_prev = torch.as_tensor(beta_prev, dtype=dtype, device=device).reshape(())
    if dynamic:
        beta = _dynamic_beta(hist, denom, beta_prev, ess_target, cv_target, group)
    elif group is not None:
        beta = _sharded_ess_beta(hist, denom, beta_prev, ess_target, group)
    else:
        bm = torch.where(hist.sample_mask(), denom, torch.full_like(denom, float("inf")))
        scal = torch.stack([beta_prev, torch.full((), ess_target, dtype=dtype, device=device)])
        beta, _ = ess_bisect_beta(hist.logl.reshape(-1), bm.reshape(-1), scal)
        beta = beta[0]

    logw, logz = logw_from_denominator(hist, denom, beta, group=group)
    weights = torch.exp(logw)  # normalized; masked entries are exp(-inf) = 0
    ess = ess_from_logw_psum(logw, group)
    cv = volume_variation_dtn(hist.u, weights, mask=hist.sample_mask(), group=group)
    return ReweightResult(beta=beta, weights=weights, ess=ess, cv=cv, logz=logz)
