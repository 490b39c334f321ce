"""Stateless numerics on tensors: logsumexp, ESS, resampling, trimming, CV.

Counterpart of tempest_tpu/ops/tools.py. Every function keeps the JAX
function's shapes and mask semantics; the resamplers take their uniforms
as an argument instead of a PRNG key, so a test can feed both packages the
same numbers.

The reductions over the particle axis take `group`, the process group of a
particle mesh (tempest_tpu_torch/parallel/), where JAX's take `axis_name`:
with a group each rank reduces its own block and an `all_reduce` combines
the ranks, so every rank holds the same result; with `group=None` the
plain function runs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .cuda_linalg import eigvalsh


def logsumexp(logx: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """Numerically-stable logsumexp robust to all -inf inputs (tools.py:21-28)."""
    if dim is None:
        logx = logx.reshape(-1)
        dim = 0
    m = torch.amax(logx, dim=dim, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.sum(torch.exp(logx - m_safe), dim=dim, keepdim=True)
    out = torch.where(torch.isfinite(m), m_safe + torch.log(s), m)
    return out if keepdim else out.squeeze(dim)


def effective_sample_size(
    weights: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """ESS = 1 / sum(w_norm^2) of (possibly unnormalized) weights; `mask`
    zeroes invalid slots first (tools.py:31-41)."""
    w = weights
    if mask is not None:
        w = torch.where(mask, w, torch.zeros_like(w))
    w = w / torch.sum(w)
    return 1.0 / torch.sum(w * w)


def ess_from_logw(logw: torch.Tensor) -> torch.Tensor:
    """ESS directly from (unnormalized) log-weights; -inf entries contribute 0
    (tools.py:44-48)."""
    return torch.exp(2.0 * logsumexp(logw) - logsumexp(2.0 * logw))


def compute_ess(logw: torch.Tensor) -> torch.Tensor:
    """Normalized ESS fraction in (0, 1] of a 1-D log-weight vector
    (tools.py:51-53)."""
    return ess_from_logw(logw) / logw.shape[0]


def increment_logz(logw: torch.Tensor) -> torch.Tensor:
    """logsumexp of log-weights (tools.py:56-58)."""
    return logsumexp(logw)


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """`x` reduced over the ranks of `group` (a new tensor; `x` untouched)."""
    y = x.detach().reshape(-1).clone()
    dist.all_reduce(y, op=op, group=group)
    return y.reshape(x.shape)


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the ranks of `group`; `x` itself without one (tools.py:243-244)."""
    return x if group is None else _all_reduce(x, dist.ReduceOp.SUM, group)


def _pmax(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _all_reduce(x, dist.ReduceOp.MAX, group)


def logsumexp_psum(logx: torch.Tensor, group=None) -> torch.Tensor:
    """Logsumexp over all of `logx` and over the ranks of `group`
    (tools.py:166-180): a MAX then a SUM reduction; all -inf gives -inf."""
    if group is None:
        return logsumexp(logx)
    m = _pmax(torch.amax(logx), group)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = _psum(torch.sum(torch.exp(logx - m_safe)), group)
    return torch.where(torch.isfinite(m), m_safe + torch.log(s), m)


def ess_from_logw_psum(logw: torch.Tensor, group=None) -> torch.Tensor:
    """ESS from log-weights over the ranks of `group` (tools.py:183-187).

    With a group the two logsumexps share one MAX reduction (the maximum of
    2 logw is twice that of logw, and doubling is exact) and one SUM of both
    partial sums, so a probe costs two collectives instead of four."""
    if group is None:
        return ess_from_logw(logw)
    m = _pmax(torch.amax(logw), group)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    shifted = logw - m_safe
    s = _psum(torch.stack([torch.sum(torch.exp(shifted)), torch.sum(torch.exp(2.0 * shifted))]),
              group)
    lse1 = torch.where(finite, m_safe + torch.log(s[0]), m)
    lse2 = torch.where(finite, 2.0 * m_safe + torch.log(s[1]), 2.0 * m)
    return torch.exp(2.0 * lse1 - lse2)


def systematic_resample(u0: torch.Tensor, size: int, weights: torch.Tensor) -> torch.Tensor:
    """Systematic resampling from one uniform `u0` (tools.py:61-77)."""
    w = weights / torch.sum(weights)
    positions = (u0.reshape(()) + torch.arange(size, dtype=w.dtype, device=w.device)) / size
    return _invert_cdf(w, positions)


def multinomial_resample(uniforms: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Multinomial resampling by inverting the CDF at `uniforms`
    (tools.py:80-94); returns one index per uniform."""
    w = weights / torch.sum(weights)
    return _invert_cdf(w, uniforms.to(w.dtype))


SCAN_ROW = 1024


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum along the last dimension, the same bits on
    every call.

    `torch.cumsum` of one long CUDA vector combines its tiles in the order
    they finish, so its float sums change in the last bits from call to
    call, and a resampling uniform near a CDF edge then picks another
    particle. Here each vector is scanned as rows of `SCAN_ROW`, each in a
    fixed order, and every row adds the total of the rows before it."""
    n = x.shape[-1]
    if n <= SCAN_ROW:
        return torch.cumsum(x, dim=-1)
    rows = -(-n // SCAN_ROW)
    lead = x.shape[:-1]
    within = torch.cumsum(
        torch.nn.functional.pad(x, (0, rows * SCAN_ROW - n)).reshape(*lead, rows, SCAN_ROW),
        dim=-1,
    )
    before = torch.cat([torch.zeros_like(within[..., :1, -1]), cumsum(within[..., :-1, -1])],
                       dim=-1)
    return (within + before[..., None]).reshape(*lead, -1)[..., :n]


def _invert_cdf(w: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """The first index whose CDF reaches each position (tools.py:89-94), and
    never one of zero weight. Where the weights end in zeros (the history's
    unfilled rows) and the CDF's float sum stops short of 1, JAX's guard
    cdf[-1] = 1 hands the positions past the shortfall to the last index,
    a zero-weight slot; here they go to the last index of nonzero weight.
    Every other position takes JAX's index."""
    n = w.shape[0]
    cdf = cumsum(w)
    cdf[-1:].fill_(1.0)  # guard against rounding shortfall (a fill: no host copy)
    idx = torch.searchsorted(cdf, positions, right=False)  # side="left"
    last = torch.amax(torch.where(w > 0, torch.arange(n, device=w.device), 0))
    return torch.minimum(torch.clamp(idx, 0, n - 1), last)


def trim_weights_mask(
    weights: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    ess: float = 0.99,
    bins: int = 1000,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trim tiny weights while preserving an ESS fraction, as a mask.

    tools.py:97-163: all `bins` percentile thresholds are evaluated at once
    with suffix sums over the sorted valid weights, and the largest one
    that keeps `ess` of the untrimmed ESS is chosen. Returns
    (keep_mask, trimmed normalized weights) of the input shape.
    """
    w = weights
    n = w.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=w.device)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    w = torch.where(mask, w, zero)
    w = w / torch.sum(w)
    n_valid = torch.sum(mask)

    ess_total = 1.0 / torch.sum(w * w)

    # Invalid entries sort to +inf at the end: the first n_valid sorted
    # slots are the valid weights ascending.
    w_sorted, _ = torch.sort(torch.where(mask, w, torch.full_like(w, float("inf"))))

    percentiles = torch.linspace(0.0, 99.0, bins, dtype=w.dtype, device=w.device)
    # np.percentile: index = p/100 * (n_valid - 1), linear interpolation
    virt = percentiles / 100.0 * (n_valid - 1).to(w.dtype)
    lo = torch.floor(virt).long()
    hi = torch.ceil(virt).long()
    frac = virt - lo.to(w.dtype)
    thresholds = w_sorted[lo] * (1.0 - frac) + w_sorted[hi] * frac  # (bins,)

    finite = torch.isfinite(w_sorted)
    cum_w = cumsum(torch.where(finite, w_sorted, zero))
    cum_w2 = cumsum(torch.where(finite, w_sorted * w_sorted, zero))
    total_w = cum_w[n - 1]
    total_w2 = cum_w2[n - 1]
    cut = torch.searchsorted(w_sorted, thresholds, right=False)  # (bins,)
    before = torch.clamp(cut - 1, min=0)
    kept_w = total_w - torch.where(cut > 0, cum_w[before], zero)
    kept_w2 = total_w2 - torch.where(cut > 0, cum_w2[before], zero)
    # 1e-300 underflows to 0 in float32, exactly as in the JAX function.
    ess_trimmed = (kept_w * kept_w) / torch.clamp(kept_w2, min=1e-300)
    ok = ess_trimmed / ess_total >= ess  # (bins,)

    bin_ids = torch.arange(bins, device=w.device)
    best = torch.amax(torch.where(ok, bin_ids, torch.full_like(bin_ids, -1)))
    # bin 0 keeps everything; a 1-element index, as a 0-d one would sync the host
    threshold = thresholds.index_select(0, torch.clamp(best, min=0).reshape(1))

    keep = mask & (w >= threshold)
    w_keep = torch.where(keep, w, zero)
    return keep, w_keep / torch.sum(w_keep)


def volume_variation_dtn(
    u: torch.Tensor, w: torch.Tensor, mask: Optional[torch.Tensor] = None, group=None
) -> torch.Tensor:
    """Influence-function CV of the confidence-ellipsoid volume over the
    (d, T, N) history layout (tools.py:190-240); with `group`, over the
    ranks' blocks of the particle axis, each reduction local and then
    summed over the ranks (at most (d, d) values)."""
    d = u.shape[0]
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    if mask is not None:
        w = torch.where(mask, w, zero)
    w = w / _psum(torch.sum(w), group)

    mean = _psum(torch.einsum("dtn,tn->d", u, w), group)
    uc = u - mean[:, None, None]
    if mask is not None:
        uc = torch.where(mask[None], uc, zero)
    flat = uc.reshape(d, -1)
    cov = _psum((flat * w.reshape(1, -1)) @ flat.T, group)  # (d, d)

    eigvals = eigvalsh(cov)
    tol = torch.amax(torch.abs(eigvals)) * d * torch.finfo(u.dtype).eps
    rank = torch.sum(eigvals > tol)
    reg = 1e-6 * torch.trace(cov)
    eye = torch.eye(d, dtype=u.dtype, device=u.device)
    cov = torch.where(rank < d, cov + eye * reg, cov)

    cov_inv = torch.linalg.inv_ex(cov).inverse
    d2 = torch.sum((cov_inv.T @ flat) * flat, dim=0).reshape(w.shape)
    deviation = torch.clamp(d2 - d, -1e6, 1e6)
    cv = 0.5 * torch.sqrt(_psum(torch.sum(w * w * deviation * deviation), group))

    n_valid = torch.sum(mask) if mask is not None else torch.tensor(w.numel(), device=u.device)
    n_valid = _psum(n_valid, group)
    bad = (~torch.isfinite(cv)) | (n_valid < d + 1) | (~torch.all(torch.isfinite(cov_inv)))
    return torch.where(bad, torch.full_like(cv, 1e10), cv)


def volume_variation(
    x: torch.Tensor, w: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Influence-function CV of the confidence-ellipsoid volume of (n, d)
    samples (tools.py:247-287): 0.5 sqrt(sum_i w_i^2 (d_i^2 - d)^2) with the
    Mahalanobis distances under the weighted covariance; 1e10 for too few
    samples or a singular or non-finite covariance."""
    n, d = x.shape
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if w is None:
        w = torch.ones((n,), dtype=x.dtype, device=x.device)
    if mask is not None:
        w = torch.where(mask, w, zero)
    w = w / torch.sum(w)

    mean = torch.sum(x * w[:, None], dim=0)
    xc = x - mean
    if mask is not None:
        xc = torch.where(mask[:, None], xc, zero)
    cov = xc.T @ (xc * w[:, None])

    eigvals = eigvalsh(cov)
    tol = torch.amax(torch.abs(eigvals)) * d * torch.finfo(x.dtype).eps
    rank = torch.sum(eigvals > tol)
    reg = 1e-6 * torch.trace(cov)
    cov = torch.where(rank < d, cov + torch.eye(d, dtype=x.dtype, device=x.device) * reg, cov)

    cov_inv = torch.linalg.inv_ex(cov).inverse
    d2 = torch.sum((xc @ cov_inv) * xc, dim=1)
    deviation = torch.clamp(d2 - d, -1e6, 1e6)
    cv = 0.5 * torch.sqrt(torch.sum(w * w * deviation * deviation))

    n_valid = torch.sum(mask) if mask is not None else n
    bad = (~torch.isfinite(cv)) | (n_valid < d + 1) | (~torch.all(torch.isfinite(cov_inv)))
    return torch.where(bad, torch.full_like(cv, 1e10), cv)
