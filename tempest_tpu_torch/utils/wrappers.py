"""Likelihood and prior-transform wrapping.

Counterpart of tempest_tpu/utils/wrappers.py: `FunctionWrapper` (:24-33),
`build_prior_transform` (:36-40) and the vectorized path of
`build_log_likelihood` (:133-139). The user's callables are torch
functions on (N, d) tensors. Per-point likelihoods, host likelihoods,
pools and blobs wait for ROADMAP.md queue 1, item 11; the config refuses
them before these functions run.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch


class FunctionWrapper:
    """Picklable closure binding extra args/kwargs."""

    def __init__(self, f: Callable, args: Optional[List[Any]], kwargs: Optional[Dict[str, Any]]):
        self.f = f
        self.args = [] if args is None else args
        self.kwargs = {} if kwargs is None else kwargs

    def __call__(self, x):
        return self.f(x, *self.args, **self.kwargs)


def build_prior_transform(prior_transform: Callable, vectorize: bool) -> Callable:
    """Batched u (N, d) -> x (N, d)."""
    if not vectorize:
        raise NotImplementedError(
            "per-point prior transforms wait for ROADMAP.md queue 1, item 11"
        )
    return prior_transform


def build_log_likelihood(log_likelihood: Callable, vectorize: bool, dtype=torch.float32) -> Callable:
    """Batched x (N, d) -> logl (N,) of `dtype`."""
    if not vectorize:
        raise NotImplementedError("per-point likelihoods wait for ROADMAP.md queue 1, item 11")

    def batched_vec(x):
        return torch.as_tensor(log_likelihood(x)).to(dtype)

    return batched_vec
