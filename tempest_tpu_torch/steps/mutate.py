"""The beta = 0 warm-up: fresh prior draws with the infinite-logl patch.

Counterpart of tempest_tpu/steps/mutate.py:27-68 (itself the reference's
mutate.py:99-149). Particles whose log-likelihood is infinite are replaced,
blobs included, by uniform picks among the finite ones, and logZ gains
log(n_finite / N).
The uniforms come in as arguments: `u_draw` (N, d) for the prior draw and
`patch_uniforms` (N,) for the multinomial pick of replacements. A host
likelihood (`utils.wrappers.HostLikelihood`) is called with no `active`
flag: a warm-up always evaluates its draw.

Under a particle mesh (`group`) `u_draw` is this rank's block of the global
draw and `patch_uniforms` are global: the count of finite particles is
summed over the ranks, and the replacements are picked from the global set
by the claim and reduce-scatter of the sharded resampler; whether to patch
is decided on the device, so the patch reads nothing on the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..ops.tools import _psum, multinomial_resample
from ..parallel.collective import gather_rows


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
    group=None,
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
    if group is not None:
        return _sharded_patch(u, x, logl, blobs, inf_mask, patch_uniforms, group)
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


def _sharded_patch(u, x, logl, blobs, inf_mask, patch_uniforms, group) -> WarmupResult:
    """The patch over the ranks' blocks, decided on the device as the
    single-device patch is (JAX's `can_patch` and `jnp.where`): the gather
    of replacement rows always runs, its rows taken only where a row is
    infinite and some row, on any rank, is finite. The finite count is
    summed over the ranks, so every rank runs the same collectives. Where
    no row is finite the sampling weights are divided by 1, not 0, so the
    unused gather stays finite."""
    dtype = u.dtype
    n_global = patch_uniforms.shape[0]
    n_finite = _psum(torch.sum(~inf_mask), group)
    any_inf = n_finite < n_global
    sel = any_inf & (n_finite > 0) & inf_mask
    p = torch.where(inf_mask, torch.zeros_like(logl), torch.ones_like(logl))
    p = p / torch.clamp(n_finite, min=1).to(dtype)
    arrays = [u.T[:, None], x.T[:, None], logl[None, None]]
    if blobs is not None:
        arrays.append(blobs.T[:, None])
    rows = gather_rows(patch_uniforms, p[None], arrays, group)
    u = torch.where(sel[:, None], rows[0], u)
    x = torch.where(sel[:, None], rows[1], x)
    logl = torch.where(sel, rows[2][:, 0], logl)
    if blobs is not None:
        blobs = torch.where(sel[:, None], rows[3], blobs)
    frac = n_finite.to(dtype) / n_global
    logz_corr = torch.where(any_inf, torch.log(frac), torch.zeros((), dtype=dtype, device=u.device))
    return WarmupResult(u=u, x=x, logl=logl, blobs=blobs, logz_correction=logz_corr)
