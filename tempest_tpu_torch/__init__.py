"""tempest_tpu_torch — Persistent Sampling in PyTorch for NVIDIA GPUs.

The PyTorch counterpart of `tempest_tpu` (the JAX package beside it, which
is the reference this package is tested against). It implements
Persistent Sampling (Karamanis & Seljak 2025, arXiv:2407.20722): the
adaptive ESS temperature ladder with persistent multiple-importance-
sampling reweighting over all past particles, hierarchical BIC-gated
Gaussian-mixture clustering with one Student-t preconditioner per
cluster, tpCN or RWM mutation, and evidence estimation, in float32 or
float64. The ESS bisection (in both dtypes) and the `hardware_prng=True`
draws run as hand-written CUDA kernels on the GPU (`ops/cuda_reweight.py`,
`ops/cuda_prng.py`). The weighted Gaussian-mixture classes are
`cluster.GaussianMixture` and `cluster.HierarchicalGaussianMixture`.

This package imports `torch` and never `jax`.
"""

__version__ = "0.1.0"

__all__ = ["Sampler"]


def __getattr__(name):
    # Lazy import, as in tempest_tpu/__init__.py: utility-only users do not
    # pull in the whole sampler stack.
    if name == "Sampler":
        from .sampler import Sampler

        return Sampler
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
