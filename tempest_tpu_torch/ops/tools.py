"""Stateless numerics on tensors: logsumexp, ESS, resampling, trimming, CV.

Counterpart of tempest_tpu/ops/tools.py. Every function keeps the JAX
function's shapes and mask semantics; the resamplers take their uniforms
as an argument instead of a PRNG key, so a test can feed both packages the
same numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


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


def ess_from_logw(logw: torch.Tensor) -> torch.Tensor:
    """ESS directly from (unnormalized) log-weights; -inf entries contribute 0
    (tools.py:44-48)."""
    return torch.exp(2.0 * logsumexp(logw) - logsumexp(2.0 * logw))


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
    """Inclusive cumulative sum of a 1-D tensor, the same bits on every call.

    `torch.cumsum` of one long CUDA vector combines its tiles in the order
    they finish, so its float sums change in the last bits from call to
    call, and a resampling uniform near a CDF edge then picks another
    particle. Here the vector is scanned as rows of `SCAN_ROW`, each in a
    fixed order, and every row adds the total of the rows before it."""
    n = x.shape[0]
    if n <= SCAN_ROW:
        return torch.cumsum(x, dim=0)
    rows = -(-n // SCAN_ROW)
    within = torch.cumsum(
        torch.nn.functional.pad(x, (0, rows * SCAN_ROW - n)).reshape(rows, SCAN_ROW), dim=1
    )
    before = torch.cat([torch.zeros_like(within[:1, -1]), cumsum(within[:-1, -1])])
    return (within + before[:, None]).reshape(-1)[:n]


def _invert_cdf(w: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    cdf = cumsum(w)
    cdf[-1] = 1.0  # guard against rounding shortfall
    idx = torch.searchsorted(cdf, positions, right=False)  # side="left"
    return torch.clamp(idx, 0, w.shape[0] - 1)


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
    threshold = thresholds[torch.clamp(best, min=0)]  # bin 0 keeps everything

    keep = mask & (w >= threshold)
    w_keep = torch.where(keep, w, zero)
    return keep, w_keep / torch.sum(w_keep)


def volume_variation_dtn(
    u: torch.Tensor, w: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Influence-function CV of the confidence-ellipsoid volume over the
    (d, T, N) history layout (tools.py:190-240, unsharded)."""
    d = u.shape[0]
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    if mask is not None:
        w = torch.where(mask, w, zero)
    w = w / torch.sum(w)

    mean = torch.einsum("dtn,tn->d", u, w)
    uc = u - mean[:, None, None]
    if mask is not None:
        uc = torch.where(mask[None], uc, zero)
    flat = uc.reshape(d, -1)
    cov = (flat * w.reshape(1, -1)) @ flat.T  # (d, d)

    eigvals = torch.linalg.eigvalsh(cov)
    tol = torch.amax(torch.abs(eigvals)) * d * torch.finfo(u.dtype).eps
    rank = torch.sum(eigvals > tol)
    reg = 1e-6 * torch.trace(cov)
    eye = torch.eye(d, dtype=u.dtype, device=u.device)
    cov = torch.where(rank < d, cov + eye * reg, cov)

    cov_inv = torch.linalg.inv_ex(cov).inverse
    d2 = torch.sum((cov_inv.T @ flat) * flat, dim=0).reshape(w.shape)
    deviation = torch.clamp(d2 - d, -1e6, 1e6)
    cv = 0.5 * torch.sqrt(torch.sum(w * w * deviation * deviation))

    n_valid = torch.sum(mask) if mask is not None else torch.tensor(w.numel(), device=u.device)
    bad = (~torch.isfinite(cv)) | (n_valid < d + 1) | (~torch.all(torch.isfinite(cov_inv)))
    return torch.where(bad, torch.full_like(cv, 1e10), cv)
