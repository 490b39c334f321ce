"""Mode statistics for the preconditioned MCMC proposals.

Counterpart of tempest_tpu/modes.py: per-mode means, covariances and
degrees of freedom with their Cholesky factors and inverses, padded to
K_max modes with a `k_mask`. The JAX `vmap` over modes (:141-147) becomes
one batched EM over the (K_max, n) weight matrix
(`student.fit_mvstud_weighted_modes`), with the weighted-median presort
shared; each mode stops at its own exit. The inverse covariances are two
triangular solves on the Cholesky factor, which a CUDA graph can capture
(torch's `cholesky_solve` of a batch runs MAGMA, which syncs the host).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .loops import Loops
from .student import fit_mvstud_weighted_modes, regularized_cholesky, sort_columns


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
    L_inv = torch.linalg.solve_triangular(L, eye, upper=False)
    inv = torch.linalg.solve_triangular(L.transpose(-1, -2), L_inv, upper=True)
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


def fit_mode_statistics(
    u: torch.Tensor,
    weights: torch.Tensor,
    labels: torch.Tensor,
    k_max: int,
    dof_fallback: float = 1e6,
    loops: Optional[Loops] = None,
) -> ModeStatistics:
    """Per-mode weighted Student-t fits (modes.py:103-156), batched over
    the k_max modes; an empty mode gets identity statistics.

    `weights` must already be masked; `labels` assigns each sample to a
    mode in [0, k_max). Deterministic: the weighted EM draws nothing.
    `loops` runs the EM loop (`student.fit_mvstud_weighted_modes`).
    """
    onehot = labels[None, :] == torch.arange(k_max, device=labels.device)[:, None]
    w_k = torch.where(onehot, weights[None, :], torch.zeros_like(weights[None, :]))  # (k_max, n)
    d = u.shape[1]
    empty = torch.sum(w_k, dim=1) <= 0.0
    means, covs, dofs = fit_mvstud_weighted_modes(u, w_k, sort_cache=sort_columns(u),
                                                  loops=loops)
    fallback = torch.full_like(dofs, dof_fallback)
    dofs = torch.where(torch.isfinite(dofs) & ~empty, dofs, fallback)
    means = torch.where(empty[:, None], torch.zeros_like(means), means)
    eye = torch.eye(d, dtype=covs.dtype, device=covs.device)
    covs, chols, invs = _decompose(torch.where(empty[:, None, None], eye, covs))
    return ModeStatistics(
        means=means,
        covariances=covs,
        degrees_of_freedom=dofs,
        inv_covariances=invs,
        chol_covariances=chols,
        k_mask=~empty,
    )


def fit_global_mode(
    u: torch.Tensor, weights: torch.Tensor, dof_fallback: float = 1e6,
    loops: Optional[Loops] = None,
) -> ModeStatistics:
    """One global weighted Student-t fit (modes.py:159-168): the same
    function with k_max = 1."""
    labels = torch.zeros(u.shape[0], dtype=torch.int32, device=u.device)
    return fit_mode_statistics(u, weights, labels, k_max=1, dof_fallback=dof_fallback,
                               loops=loops)
