"""The beta = 0 warm-up: fresh prior draws with the infinite-logl patch.

Counterpart of tempest_tpu/steps/mutate.py:27-68 (itself the reference's
mutate.py:99-149). Particles whose log-likelihood is infinite are replaced,
blobs included, by uniform picks among the finite ones, and logZ gains
log(n_finite / N).
The uniforms come in as arguments: `u_draw` (N, d) for the prior draw and
`patch_uniforms` (N,) for the multinomial pick of replacements.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..ops.tools import multinomial_resample


class WarmupResult(NamedTuple):
    u: torch.Tensor
    x: torch.Tensor
    logl: torch.Tensor
    blobs: Optional[torch.Tensor]  # (N, B) or None
    logz_correction: torch.Tensor  # additive logZ correction


def warmup(
    u_draw: torch.Tensor,
    patch_uniforms: torch.Tensor,
    log_likelihood_batch: Callable,
    prior_transform_batch: Callable,
) -> WarmupResult:
    """Evaluate the prior draw `u_draw` and patch infinite log-likelihoods.
    `log_likelihood_batch` returns (logl, blobs or None)."""
    n_particles = u_draw.shape[0]
    dtype = u_draw.dtype
    u = u_draw
    x = prior_transform_batch(u)
    logl, blobs = log_likelihood_batch(x)
    logl = logl.to(dtype)

    inf_mask = torch.isinf(logl)
    n_finite = torch.sum(~inf_mask)
    any_inf = torch.any(inf_mask)
    can_patch = any_inf & (n_finite > 0)

    p = torch.where(inf_mask, torch.zeros_like(logl), torch.ones_like(logl))
    p = p / torch.clamp(torch.sum(p), min=1.0)
    repl = multinomial_resample(patch_uniforms, p)

    sel = can_patch & inf_mask
    u = torch.where(sel[:, None], u[repl], u)
    x = torch.where(sel[:, None], x[repl], x)
    logl = torch.where(sel, logl[repl], logl)
    if blobs is not None:
        blobs = torch.where(sel[:, None], blobs[repl], blobs)

    frac = n_finite.to(dtype) / n_particles
    logz_corr = torch.where(any_inf, torch.log(frac), torch.zeros((), dtype=dtype, device=u.device))
    return WarmupResult(u=u, x=x, logl=logl, blobs=blobs, logz_correction=logz_corr)
