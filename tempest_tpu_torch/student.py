"""Weighted multivariate Student-t fit by EM.

Counterpart of tempest_tpu/student.py: the unweighted `fit_mvstud`
(:164-217) and `fit_mvstud_weighted` (:248-326) with the weighted-median
start (:220-244), the 16-way log-space
multisection for nu (`_opt_nu`, :137-160) on the cancellation-free
stationarity equation (:65-103), and the `_nu_converged` exit (:106-134).

The JAX `lax.while_loop` becomes a Python loop whose exit test reads one
boolean per EM iteration from the device. A covariance that is not
positive definite is detected through `cholesky_ex`'s `info` (torch's
`cholesky` raises where jnp's returns NaN) and gets the same
max(1e-6, 1e-6 |trace|) diagonal floor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_REG_FLOOR = 1e-6
_NU_LOG_LO = -69.0  # log(1e-30)
_NU_LOG_HI = 13.815511  # log(1e6) == log(DOF_FALLBACK); see student.py:38-44
_NU_SPLIT = 16
_NU_PASSES = 5


def regularized_cholesky(cov: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cov, L) with the diagonal floor applied where Cholesky fails.

    Works on (d, d) or batched (..., d, d) input; no host sync.
    """
    d = cov.shape[-1]
    L, info = torch.linalg.cholesky_ex(cov)
    bad = (info != 0) | ~torch.isfinite(L).all(dim=(-2, -1))
    trace = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)
    reg = torch.clamp(_REG_FLOOR * trace.abs(), min=_REG_FLOOR)
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
    cov2 = torch.where(bad[..., None, None], cov + eye * reg[..., None, None], cov)
    L2 = torch.where(bad[..., None, None], torch.linalg.cholesky_ex(cov2).L, L)
    return cov2, L2


def _log_minus_digamma(x: torch.Tensor) -> torch.Tensor:
    """log(x) - digamma(x), by its asymptotic series beyond x = 20."""
    direct = torch.log(x) - torch.special.digamma(x)
    inv = 1.0 / x
    series = 0.5 * inv + (1.0 / 12.0) * inv * inv - (1.0 / 120.0) * inv**4
    return torch.where(x > 20.0, series, direct)


def _nu_objective(log_nu: torch.Tensor, delta: torch.Tensor, dim: int, wbar) -> torch.Tensor:
    """The nu M-step's stationarity function at each of `log_nu` (student.py:80-103)."""
    nu = torch.exp(log_nu)[..., None]
    e = (dim - delta) / (nu + delta)  # w = 1 + e
    data_term = torch.sum(wbar * (torch.log1p(e) - e), dim=-1)
    nu = nu[..., 0]
    return _log_minus_digamma(nu / 2.0) - _log_minus_digamma((nu + dim) / 2.0) + data_term


def _nu_converged(nu: torch.Tensor, last_nu: torch.Tensor, tolerance: float) -> torch.Tensor:
    """|d nu| <= tol * max(1, |nu|), or |d(1/nu)| <= 1000 eps (student.py:106-134)."""
    tol = tolerance * torch.clamp(nu.abs(), min=1.0)
    inv_tol = 1000.0 * torch.finfo(nu.dtype).eps
    safe_last = torch.where(last_nu == 0.0, torch.full_like(last_nu, float("inf")), last_nu)
    return ((last_nu - nu).abs() <= tol) | ((1.0 / safe_last - 1.0 / nu).abs() <= inv_tol)


def _opt_nu(delta: torch.Tensor, dim: int, wbar) -> torch.Tensor:
    """Root of the stationarity function in log nu; +inf for the Gaussian limit."""
    dtype, device = delta.dtype, delta.device
    hi0 = torch.tensor(_NU_LOG_HI, dtype=dtype, device=device)
    is_inf = _nu_objective(hi0, delta, dim, wbar) >= 0.0
    fracs = torch.arange(1, _NU_SPLIT, dtype=dtype, device=device) / _NU_SPLIT  # (15,)
    lo = torch.tensor(_NU_LOG_LO, dtype=dtype, device=device)
    hi = hi0
    for _ in range(_NU_PASSES):
        mids = lo + (hi - lo) * fracs  # ascending
        count = torch.sum(_nu_objective(mids, delta, dim, wbar) > 0.0)
        grid = torch.cat([lo[None], mids, hi[None]])  # (17,)
        lo, hi = grid[count], grid[count + 1]
    nu = torch.exp(0.5 * (lo + hi))
    return torch.where(is_inf, torch.full_like(nu, float("inf")), nu)


def fit_mvstud(
    data: torch.Tensor, tolerance: float = 1e-6, max_iter: int = 100
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multivariate Student-t EM on unweighted data (n, dim) -> (mu, Sigma,
    nu) (student.py:164-217); nu == +inf signals the Gaussian limit.

    It starts from the per-dimension median as `jnp.median` takes it, the
    mean of the two middle values for even n (`torch.median` would return
    the lower one), and from the biased covariance plus diag(var) / n."""
    n, dim = data.shape
    dtype, device = data.dtype, data.device
    mu = torch.quantile(data, 0.5, dim=0)
    xc = data - torch.mean(data, dim=0)
    Sigma = (xc.T @ xc) / n + torch.diag(torch.var(data, dim=0, correction=0)) / n
    nu = torch.tensor(20.0, dtype=dtype, device=device)
    last_nu = torch.zeros((), dtype=dtype, device=device)
    hit_inf = torch.zeros((), dtype=torch.bool, device=device)
    eye = torch.eye(dim, dtype=dtype, device=device)
    ones = torch.ones((n, 1), dtype=dtype, device=device)

    for _ in range(max_iter):
        if bool(_nu_converged(nu, last_nu, tolerance) | hit_inf):  # one sync per iteration
            break
        Sigma, L = regularized_cholesky(Sigma)
        diffs = data - mu
        sol = diffs @ torch.linalg.solve_triangular(L, eye, upper=False).T
        delta = torch.sum(sol * sol, dim=1)

        nu_new = _opt_nu(delta, dim, 1.0 / n)
        now_inf = ~torch.isfinite(nu_new)

        w = (nu_new + dim) / (nu_new + delta)
        Sigma_new = (diffs.T * w) @ diffs / n
        # Numerator and denominator as columns of one reduction, summed in
        # one order, as XLA sums both: a constant column then gives its
        # value exactly, as in JAX.
        sums = torch.sum(w[:, None] * torch.cat([data, ones], dim=1), dim=0)
        mu_new = sums[:dim] / sums[dim]

        # On the Gaussian-limit exit the current (mu, Sigma) are returned.
        mu = torch.where(now_inf, mu, mu_new)
        Sigma = torch.where(now_inf, Sigma, Sigma_new)
        last_nu, nu, hit_inf = nu, nu_new, now_inf

    Sigma, _ = regularized_cholesky(Sigma)
    return mu, Sigma, nu


def _weighted_median_presorted(
    d_sorted: torch.Tensor, order: torch.Tensor, wbar: torch.Tensor
) -> torch.Tensor:
    """Per-dimension weighted median given the stable column sort of the data."""
    cum = torch.cumsum(wbar[order], dim=0)  # (n, d)
    idx = torch.argmax((cum >= 0.5 - 1e-7).to(torch.int8), dim=0)  # first True
    return torch.gather(d_sorted, 0, idx[None, :])[0]


def sort_columns(data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted data, order) per column; a stable sort, like jnp.argsort."""
    order = torch.argsort(data, dim=0, stable=True)
    return torch.gather(data, 0, order), order


def fit_mvstud_weighted(
    data: torch.Tensor,
    weights: torch.Tensor,
    tolerance: float = 1e-6,
    max_iter: int = 100,
    sort_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted multivariate Student-t EM: data (n, dim), weights (n,).

    Returns (mu, Sigma, nu); nu == +inf signals the Gaussian limit.
    `sort_cache` is `sort_columns(data)`, for callers that fit several
    weightings of the same points.
    """
    weights = weights.to(data.dtype)
    n, dim = data.shape
    dtype = data.dtype

    total = torch.sum(weights)
    wbar = weights / torch.where(total > 0, total, torch.ones_like(total))
    n_eff = 1.0 / torch.clamp(torch.sum(wbar * wbar), min=torch.finfo(dtype).tiny)

    if sort_cache is None:
        sort_cache = sort_columns(data)
    mu = _weighted_median_presorted(sort_cache[0], sort_cache[1], wbar)
    wmean = torch.sum(wbar[:, None] * data, dim=0)
    xc = data - wmean
    cov_w = (xc.T * wbar) @ xc
    var_w = torch.sum(wbar[:, None] * xc * xc, dim=0)
    Sigma = cov_w + torch.diag(var_w) / n_eff
    nu = torch.tensor(20.0, dtype=dtype, device=data.device)
    last_nu = torch.zeros((), dtype=dtype, device=data.device)
    hit_inf = torch.zeros((), dtype=torch.bool, device=data.device)
    eye = torch.eye(dim, dtype=dtype, device=data.device)

    for _ in range(max_iter):
        if bool(_nu_converged(nu, last_nu, tolerance) | hit_inf):  # one sync per iteration
            break
        Sigma, L = regularized_cholesky(Sigma)
        diffs = data - mu
        L_inv = torch.linalg.solve_triangular(L, eye, upper=False)
        sol = diffs @ L_inv.T
        delta = torch.sum(sol * sol, dim=1)

        nu_new = _opt_nu(delta, dim, wbar)
        now_inf = ~torch.isfinite(nu_new)

        g = (nu_new + dim) / (nu_new + delta)  # E-step scale
        wg = wbar * g
        Sigma_new = (diffs.T * wg) @ diffs
        mu_new = torch.sum(wg[:, None] * data, dim=0) / torch.sum(wg)

        # On the Gaussian-limit exit the current (mu, Sigma) are returned.
        mu = torch.where(now_inf, mu, mu_new)
        Sigma = torch.where(now_inf, Sigma, Sigma_new)
        last_nu, nu, hit_inf = nu, nu_new, now_inf

    Sigma, _ = regularized_cholesky(Sigma)
    return mu, Sigma, nu
