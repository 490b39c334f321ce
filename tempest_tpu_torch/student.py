"""Weighted multivariate Student-t fit by EM.

Counterpart of tempest_tpu/student.py: the unweighted `fit_mvstud`
(:164-217) and `fit_mvstud_weighted` (:248-326) with the weighted-median
start (:220-244), the 16-way log-space
multisection for nu (`_opt_nu`, :137-160) on the cancellation-free
stationarity equation (:65-103), and the `_nu_converged` exit (:106-134).

`fit_mvstud_weighted_modes` fits K weightings of the same points at once,
as `jax.vmap` of `fit_mvstud_weighted` does (tempest_tpu/modes.py:141-147):
one batched EM whose `lax.while_loop` (student.py:295) becomes a device
loop (`loops.run_loop`, "mode_em") with a done flag per weighting. A
weighting stops at its own exit (converged, Gaussian limit or `max_iter`
iterations) and its (mu, Sigma, nu) are frozen from then on; the loop's
predicate, "any weighting active", is read once a chunk. The unweighted
`fit_mvstud` keeps a Python loop that reads one boolean per EM iteration.
A covariance that is not positive definite is detected through
`cholesky_ex`'s `info` (torch's `cholesky` raises where jnp's returns
NaN) and gets the same max(1e-6, 1e-6 |trace|) diagonal floor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .loops import Loops, run_loop
# The weighted-median start (student.py:220-231): the kernel of
# `ops.cuda_median` on CUDA tensors, its plain version on CPU ones.
from .ops.cuda_median import weighted_median_presorted as _weighted_median_presorted

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
    """The nu M-step's stationarity function (student.py:80-103) at each of
    `log_nu` (..., M), for squared distances `delta` (..., n) under the
    weights `wbar` ((..., n), or one number for equal weights)."""
    nu = torch.exp(log_nu)[..., None]
    dl = delta[..., None, :]
    e = (dim - dl) / (nu + dl)  # w = 1 + e
    wb = wbar[..., None, :] if torch.is_tensor(wbar) else wbar
    data_term = torch.sum(wb * (torch.log1p(e) - e), dim=-1)
    nu = nu[..., 0]
    return _log_minus_digamma(nu / 2.0) - _log_minus_digamma((nu + dim) / 2.0) + data_term


def _nu_converged(nu: torch.Tensor, last_nu: torch.Tensor, tolerance: float) -> torch.Tensor:
    """|d nu| <= tol * max(1, |nu|), or |d(1/nu)| <= 1000 eps (student.py:106-134)."""
    tol = tolerance * torch.clamp(nu.abs(), min=1.0)
    inv_tol = 1000.0 * torch.finfo(nu.dtype).eps
    safe_last = torch.where(last_nu == 0.0, torch.full_like(last_nu, float("inf")), last_nu)
    return ((last_nu - nu).abs() <= tol) | ((1.0 / safe_last - 1.0 / nu).abs() <= inv_tol)


def _opt_nu(delta: torch.Tensor, dim: int, wbar) -> torch.Tensor:
    """Root of the stationarity function in log nu for each leading index of
    `delta` (..., n); +inf for the Gaussian limit."""
    dtype, device, lead = delta.dtype, delta.device, delta.shape[:-1]
    hi = torch.full(lead, _NU_LOG_HI, dtype=dtype, device=device)
    is_inf = _nu_objective(hi[..., None], delta, dim, wbar)[..., 0] >= 0.0
    fracs = torch.arange(1, _NU_SPLIT, dtype=dtype, device=device) / _NU_SPLIT  # (15,)
    lo = torch.full(lead, _NU_LOG_LO, dtype=dtype, device=device)
    for _ in range(_NU_PASSES):
        mids = lo[..., None] + (hi - lo)[..., None] * fracs  # ascending
        count = torch.sum(_nu_objective(mids, delta, dim, wbar) > 0.0, dim=-1)
        grid = torch.cat([lo[..., None], mids, hi[..., None]], dim=-1)  # (..., 17)
        lo = torch.gather(grid, -1, count[..., None])[..., 0]
        hi = torch.gather(grid, -1, count[..., None] + 1)[..., 0]
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


def sort_columns(data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted data, order) per column, both contiguous (the median kernel
    takes no other layout; argsort follows the layout of a strided `data`);
    a stable sort, like jnp.argsort."""
    order = torch.argsort(data, dim=0, stable=True).contiguous()
    return torch.gather(data, 0, order).contiguous(), order


def _em_body(c, k):
    """One EM iteration of every weighting still active (student.py:300-324);
    the others keep their values."""
    dim = k["data"].shape[1]
    active = c["active"]
    Sigma, L = regularized_cholesky(c["Sigma"])
    diffs = k["data"] - c["mu"][:, None, :]  # (K, n, dim)
    L_inv = torch.linalg.solve_triangular(L, k["eye"].expand_as(L), upper=False)
    sol = diffs @ L_inv.transpose(-1, -2)
    delta = torch.sum(sol * sol, dim=-1)  # (K, n)

    nu_new = _opt_nu(delta, dim, k["wbar"])
    now_inf = ~torch.isfinite(nu_new)

    g = (nu_new[:, None] + dim) / (nu_new[:, None] + delta)  # E-step scale
    wg = k["wbar"] * g
    Sigma_new = (diffs.transpose(-1, -2) * wg[:, None, :]) @ diffs
    mu_new = torch.sum(wg[..., None] * k["data"], dim=1) / torch.sum(wg, dim=1)[:, None]

    # On the Gaussian-limit exit the current (mu, Sigma) are kept.
    step = active & ~now_inf
    mu = torch.where(step[:, None], mu_new, c["mu"])
    Sigma = torch.where(step[:, None, None], Sigma_new, torch.where(active[:, None, None], Sigma,
                                                                      c["Sigma"]))
    last_nu = torch.where(active, c["nu"], c["last_nu"])
    nu = torch.where(active, nu_new, c["nu"])
    i = c["i"] + active.to(torch.int32)
    hit_inf = torch.where(active, now_inf, c["hit_inf"])
    active = ~_nu_converged(nu, last_nu, k["tolerance"]) & (i < k["max_iter"]) & ~hit_inf
    return dict(mu=mu, Sigma=Sigma, nu=nu, last_nu=last_nu, i=i, hit_inf=hit_inf, active=active,
                go=torch.any(active))


def fit_mvstud_weighted_modes(
    data: torch.Tensor,
    weights: torch.Tensor,
    tolerance: float = 1e-6,
    max_iter: int = 100,
    sort_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    loops: Optional[Loops] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted multivariate Student-t EM of the points `data` (n, dim)
    under each row of `weights` (K, n): (mu (K, dim), Sigma (K, dim, dim),
    nu (K,)); nu == +inf signals the Gaussian limit. `sort_cache` is
    `sort_columns(data)`; `loops` runs the EM loop (default: a read after
    every EM iteration, no graph)."""
    weights = weights.to(data.dtype)
    n, dim = data.shape
    dtype, device = data.dtype, data.device

    total = torch.sum(weights, dim=1, keepdim=True)
    wbar = weights / torch.where(total > 0, total, torch.ones_like(total))  # (K, n)
    n_eff = 1.0 / torch.clamp(torch.sum(wbar * wbar, dim=1), min=torch.finfo(dtype).tiny)

    if sort_cache is None:
        sort_cache = sort_columns(data)
    mu = _weighted_median_presorted(sort_cache[0], sort_cache[1], wbar)  # (K, dim)
    wmean = torch.sum(wbar[..., None] * data, dim=1)  # (K, dim)
    xc = data - wmean[:, None, :]  # (K, n, dim)
    cov_w = (xc.transpose(-1, -2) * wbar[:, None, :]) @ xc
    var_w = torch.sum(wbar[..., None] * xc * xc, dim=1)
    Sigma = cov_w + torch.diag_embed(var_w) / n_eff[:, None, None]
    K = weights.shape[0]
    nu = torch.full((K,), 20.0, dtype=dtype, device=device)
    last_nu = torch.zeros((K,), dtype=dtype, device=device)
    active = ~_nu_converged(nu, last_nu, tolerance) & (max_iter > 0)
    carry = dict(mu=mu, Sigma=Sigma, nu=nu, last_nu=last_nu,
                 i=torch.zeros((K,), dtype=torch.int32, device=device),
                 hit_inf=torch.zeros((K,), dtype=torch.bool, device=device),
                 active=active, go=torch.any(active))
    consts = dict(data=data, wbar=wbar, eye=torch.eye(dim, dtype=dtype, device=device),
                  tolerance=torch.full((), tolerance, dtype=dtype, device=device),
                  max_iter=torch.full((), max_iter, dtype=torch.int32, device=device))
    out = run_loop(loops, "mode_em", _em_body, carry, consts)
    Sigma, _ = regularized_cholesky(out["Sigma"])
    return out["mu"], Sigma, out["nu"]


def fit_mvstud_weighted(
    data: torch.Tensor,
    weights: torch.Tensor,
    tolerance: float = 1e-6,
    max_iter: int = 100,
    sort_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    loops: Optional[Loops] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted multivariate Student-t EM: data (n, dim), weights (n,).

    Returns (mu, Sigma, nu); nu == +inf signals the Gaussian limit.
    `sort_cache` is `sort_columns(data)`, for callers that fit several
    weightings of the same points.
    """
    mu, Sigma, nu = fit_mvstud_weighted_modes(data, weights[None], tolerance, max_iter,
                                              sort_cache, loops)
    return mu[0], Sigma[0], nu[0]
