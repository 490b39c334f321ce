"""Mode statistics for the preconditioned MCMC proposals.

Counterpart of tempest_tpu/modes.py: per-mode means, covariances and
degrees of freedom with their Cholesky factors and inverses, padded to
K_max modes with a `k_mask`. The JAX `vmap` over modes becomes a Python
loop over the K_max slots (one slot on the unclustered path).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .student import fit_mvstud_weighted, regularized_cholesky, sort_columns


@dataclasses.dataclass
class ModeStatistics:
    means: torch.Tensor  # (K_max, d)
    covariances: torch.Tensor  # (K_max, d, d)
    degrees_of_freedom: torch.Tensor  # (K_max,)
    inv_covariances: torch.Tensor  # (K_max, d, d)
    chol_covariances: torch.Tensor  # (K_max, d, d)
    k_mask: torch.Tensor  # (K_max,) bool — which slots are real modes

    @property
    def k_max(self) -> int:
        return self.means.shape[0]

    @property
    def n_dim(self) -> int:
        return self.means.shape[1]

    def n_modes(self) -> torch.Tensor:
        return torch.sum(self.k_mask)


def _decompose(cov: torch.Tensor):
    """Batched Cholesky and inverse with the diagonal floor where Cholesky
    fails (modes.py:46-59); cov is (K, d, d)."""
    cov2, L = regularized_cholesky(cov)
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device).expand_as(cov)
    inv = torch.cholesky_solve(eye, L, upper=False)
    return cov2, L, inv


def make_mode_statistics(
    means: torch.Tensor,
    covariances: torch.Tensor,
    degrees_of_freedom: torch.Tensor,
    k_mask: Optional[torch.Tensor] = None,
) -> ModeStatistics:
    """Construct with precomputed decompositions (modes.py:62-84)."""
    means = torch.atleast_2d(means)
    if covariances.dim() == 2:
        covariances = covariances[None]
    degrees_of_freedom = torch.atleast_1d(degrees_of_freedom)
    if k_mask is None:
        k_mask = torch.ones((means.shape[0],), dtype=torch.bool, device=means.device)
    covs, chols, invs = _decompose(covariances)
    return ModeStatistics(
        means=means,
        covariances=covs,
        degrees_of_freedom=degrees_of_freedom,
        inv_covariances=invs,
        chol_covariances=chols,
        k_mask=k_mask,
    )


def identity_mode_statistics(
    n_dim: int, k_max: int = 1, dof: float = 1e6, dtype=torch.float32, device=None
) -> ModeStatistics:
    """Single identity mode, the placeholder at beta = 0 (modes.py:87-100)."""
    covs = torch.eye(n_dim, dtype=dtype, device=device).expand(k_max, n_dim, n_dim).clone()
    return ModeStatistics(
        means=torch.zeros((k_max, n_dim), dtype=dtype, device=device),
        covariances=covs,
        degrees_of_freedom=torch.full((k_max,), dof, dtype=dtype, device=device),
        inv_covariances=covs.clone(),
        chol_covariances=covs.clone(),
        k_mask=torch.arange(k_max, device=device) < 1,
    )


def _fit_one_mode(u, w_cluster, dof_fallback, sort_cache):
    """Weighted Student-t fit of one mode; an empty mode gets identity
    statistics (modes.py:103-123)."""
    d = u.shape[1]
    empty = torch.sum(w_cluster) <= 0.0
    mean, cov, dof = fit_mvstud_weighted(u, w_cluster, sort_cache=sort_cache)
    fallback = torch.full_like(dof, dof_fallback)
    dof = torch.where(torch.isfinite(dof), dof, fallback)
    mean = torch.where(empty, torch.zeros_like(mean), mean)
    cov = torch.where(empty, torch.eye(d, dtype=cov.dtype, device=cov.device), cov)
    dof = torch.where(empty, fallback, dof)
    return mean, cov, dof, ~empty


def fit_mode_statistics(
    u: torch.Tensor,
    weights: torch.Tensor,
    labels: torch.Tensor,
    k_max: int,
    dof_fallback: float = 1e6,
) -> ModeStatistics:
    """Per-mode weighted Student-t fits (modes.py:126-156).

    `weights` must already be masked; `labels` assigns each sample to a
    mode in [0, k_max). Deterministic: the weighted EM draws nothing.
    """
    sort_cache = sort_columns(u)
    fits = [
        _fit_one_mode(u, torch.where(labels == k, weights, torch.zeros_like(weights)),
                      dof_fallback, sort_cache)
        for k in range(k_max)
    ]
    means, covs, dofs, mask = (torch.stack(parts) for parts in zip(*fits))
    covs, chols, invs = _decompose(covs)
    return ModeStatistics(
        means=means,
        covariances=covs,
        degrees_of_freedom=dofs,
        inv_covariances=invs,
        chol_covariances=chols,
        k_mask=mask,
    )


def fit_global_mode(
    u: torch.Tensor, weights: torch.Tensor, dof_fallback: float = 1e6
) -> ModeStatistics:
    """One global weighted Student-t fit (modes.py:159-168)."""
    labels = torch.zeros(u.shape[0], dtype=torch.int32, device=u.device)
    return fit_mode_statistics(u, weights, labels, k_max=1, dof_fallback=dof_fallback)
