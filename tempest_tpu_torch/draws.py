"""Random draws of the sampler.

Every stochastic step of the port is a function of explicit draws; the
loops take those draws from a draws object with three methods (`warmup`,
`resample`, `mcmc_step`). `Draws` takes all of them from one seeded
`torch.Generator` on the sampler's device. `HardwareDraws`, the source of
`hardware_prng=True`, routes each MCMC step's draws to the Philox kernels
of `ops/cuda_prng.py` as tempest_tpu/mcmc.py:187-192 and :272-315 route
them to the Pallas kernels. A test can hand a loop another object with the
same methods (for instance one that replays the JAX package's key chain)
and compare values with `tempest_tpu`, not only distributions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .ops import cuda_prng, philox

# Routing thresholds of the hardware-PRNG path. On the TPU they were a
# scoped-VMEM budget and launch-cost crossovers; here they only pick the
# route, as in JAX, until the H100 measures its own (ROADMAP queue 2).
FUSED_DRAWS_MAX_ELEMS = 1 << 19  # tempest_tpu/ops/pallas_prng.py:226, 235
HW_NORMAL_MIN_ELEMS = 1 << 20  # tempest_tpu/mcmc.py:51, 187
HW_GAMMA_MIN_WALKERS = 1 << 16  # tempest_tpu/mcmc.py:52, 306


class Draws:
    """The draws of one run, from a seeded generator on `device`."""

    def __init__(self, seed: int, device, dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def _uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, dtype=self.dtype, device=self.device)

    def warmup(self, n: int, d: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The prior draw (n, d) and the (n,) uniforms of the infinite-logl patch."""
        return self._uniform((n, d)), self._uniform((n,))

    def resample(self, n: int, method: str) -> torch.Tensor:
        """Uniforms of the resampler: (n,) for "mult", one for "syst"."""
        return self._uniform((n,) if method == "mult" else ())

    def mcmc_step(
        self, n_candidates: int, n: int, d: int, gamma_shape: Optional[torch.Tensor]
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        """One MCMC step: (R, n, d) proposal normals, the (n,) unit-scale
        gamma(gamma_shape) mixture draws (tpCN only, else None) and the (n,)
        acceptance uniforms."""
        g = None
        if gamma_shape is not None:
            g = torch._standard_gamma(gamma_shape, generator=self.generator)
        z = torch.randn(
            (n_candidates, n, d), generator=self.generator, dtype=self.dtype, device=self.device
        )
        return z, g, self._uniform((n,))


class HardwareDraws(Draws):
    """`hardware_prng=True`: MCMC-step draws from the Philox kernels.

    The key is the seed's two 32-bit words and every kernel call takes the
    next call index, so a reset (a new object) restarts the stream. The
    warm-up and resampling draws, and the draws below the routing
    thresholds, still come from the generator, as in JAX.
    """

    def __init__(self, seed: int, device, dtype=torch.float32):
        super().__init__(seed, device, dtype)
        self.key = philox.key_from_seed(seed)
        self.counter = 0

    def _calls(self, n: int) -> int:
        first = self.counter
        self.counter += n
        return first

    def mcmc_step(self, n_candidates, n, d, gamma_shape):
        z_shape = (n_candidates, n, d)
        n_z = n_candidates * n * d
        if gamma_shape is not None and n_z <= FUSED_DRAWS_MAX_ELEMS:  # tpCN only
            return cuda_prng.hw_mutation_draws(self.key, self._calls(1), gamma_shape, z_shape)
        g = None
        if gamma_shape is not None:
            if n >= HW_GAMMA_MIN_WALKERS:
                g = cuda_prng.hw_gamma(self.key, self._calls(philox.GAMMA_CALLS), gamma_shape)
            else:
                g = torch._standard_gamma(gamma_shape, generator=self.generator)
        if n_z >= HW_NORMAL_MIN_ELEMS:
            z = cuda_prng.hw_normal(self.key, self._calls(1), z_shape, self.device)
        else:
            z = torch.randn(z_shape, generator=self.generator, dtype=self.dtype, device=self.device)
        return z, g, self._uniform((n,))
