"""Vectorized periodic/reflective boundary handling.

Counterpart of tempest_tpu/ops/boundary.py: boundary sets are boolean
masks of length n_dim, and every function works on a whole walker batch.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def make_boundary_masks(
    n_dim: int,
    periodic: Optional[Sequence[int]] = None,
    reflective: Optional[Sequence[int]] = None,
    device=None,
):
    """(periodic_mask, reflective_mask, strict_mask) bool tensors (boundary.py:17-30)."""
    p = torch.zeros(n_dim, dtype=torch.bool, device=device)
    r = torch.zeros(n_dim, dtype=torch.bool, device=device)
    if periodic is not None:
        p[list(periodic)] = True
    if reflective is not None:
        r[list(reflective)] = True
    return p, r, ~(p | r)


def apply_boundary_conditions(
    u: torch.Tensor, periodic_mask: torch.Tensor, reflective_mask: torch.Tensor
) -> torch.Tensor:
    """Wrap periodic coords mod 1; fold reflective coords back into [0, 1]
    (boundary.py:33-48)."""
    wrapped = torch.remainder(u, 1.0)
    n_reflect = torch.floor(u)
    remainder = u - n_reflect
    even = torch.remainder(n_reflect, 2.0) == 0.0
    reflected = torch.where(even, remainder, 1.0 - remainder)
    out = torch.where(periodic_mask, wrapped, u)
    return torch.where(reflective_mask, reflected, out)


def check_bounds(u: torch.Tensor, strict_mask: torch.Tensor) -> torch.Tensor:
    """Per-walker validity: strict coords must lie in [0, 1] (boundary.py:51-55)."""
    ok = ((u >= 0.0) & (u <= 1.0)) | ~strict_mask
    return torch.all(ok, dim=-1)
