"""Random draws of the sampler, taken from one `torch.Generator`.

Every stochastic step of the port is a function of explicit draws; the
loops take those draws from a `Draws` object. This one is backed by a
generator on the sampler's device. A test can hand a loop another object
with the same three methods (for instance one that replays the JAX
package's key chain) and compare values with `tempest_tpu`, not only
distributions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


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
