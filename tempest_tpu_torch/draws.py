"""Random draws of the sampler.

Every stochastic step of the port is a function of explicit draws; the
loops take those draws from a draws object with four methods (`warmup`,
`resample`, `mcmc_step`, `bootstrap`). `Draws` takes all of them from one
seeded `torch.Generator` on the sampler's device. `HardwareDraws`, the source of
`hardware_prng=True`, routes each MCMC step's draws to the Philox kernels
of `ops/cuda_prng.py` as tempest_tpu/mcmc.py:187-192 and :272-315 route
them to the Pallas kernels. A test can hand a loop another object with the
same methods (for instance one that replays the JAX package's key chain)
and compare values with `tempest_tpu`, not only distributions.

`get_state()` / `set_state()` carry the whole draw state through a
checkpoint as numpy arrays: the generator's own state (for a CUDA
generator its seed and offset, `torch.Generator.get_state`), and for
`HardwareDraws` also the Philox key and call counter. Restoring it
continues the stream where it stopped; nothing is re-seeded.
`seed_from_key_words` is the rule for a file that holds no such state (one
the JAX package wrote, with a threefry key that torch cannot continue), and
`key_words` its inverse, the key a port file hands the JAX package.

Under a particle mesh every rank seeds its draws alike and draws the
global arrays; `BlockDraws` keeps the rank's block of the per-walker ones.
So W ranks draw what one device draws, and a sharded run follows the
unsharded one up to the rounding of reductions, as JAX's logical threefry
arrays make it do there. The draw state is then replicated.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .ops import cuda_prng, philox

# Routing thresholds of the hardware-PRNG path. On the TPU they were a
# scoped-VMEM budget and launch-cost crossovers; here they only pick the
# route, as in JAX, until the H100 measures its own (ROADMAP queue 2).
FUSED_DRAWS_MAX_ELEMS = 1 << 19  # tempest_tpu/ops/pallas_prng.py:226, 235
HW_NORMAL_MIN_ELEMS = 1 << 20  # tempest_tpu/mcmc.py:51, 187
HW_GAMMA_MIN_WALKERS = 1 << 16  # tempest_tpu/mcmc.py:52, 306


class Draws:
    """The draws of one run, from a seeded generator on `device`.

    `graph_safe`: every draw comes from `generator` through PyTorch's
    Philox kernels (and, for `HardwareDraws`, from kernels that read their
    call counter on the device), so a CUDA graph that registers the
    generator (and the counter, `loops.Loops.counters`) replays the draws
    of its capture's eager run from the current position."""

    graph_safe = True

    def __init__(self, seed: int, device, dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        self.generator = torch.Generator(device=self.device)
        self.reseed(seed)

    def reseed(self, seed: int) -> None:
        """Start the stream of `seed` again, on the same generator object
        (which CUDA graphs may hold)."""
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

    def bootstrap(self, n_bootstrap: int, t_max: int) -> torch.Tensor:
        """(n_bootstrap, t_max) uniforms of the block bootstrap of logZ."""
        return self._uniform((n_bootstrap, t_max))

    def get_state(self) -> Dict[str, np.ndarray]:
        return {"generator": self.generator.get_state().numpy().copy()}

    def tell(self):
        """The generator's position: its Philox offset on a CUDA device
        (advanced alike by every MCMC step of one shape), its whole state
        on the CPU."""
        if self.device.type == "cuda":
            return self.generator.get_offset()
        return self.generator.get_state()

    def seek(self, position) -> None:
        """Put the generator back to a position from `tell`."""
        if self.device.type == "cuda":
            self.generator.set_offset(position)
        else:
            self.generator.set_state(position)

    def key_words(self) -> np.ndarray:
        """The run's seed as the two uint32 words of a threefry key
        (`jax.random.PRNGKey(seed)`)."""
        seed = self.generator.initial_seed()
        return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=np.uint32)

    def set_state(self, state: Dict[str, np.ndarray]) -> None:
        self.generator.set_state(torch.from_numpy(np.asarray(state["generator"], np.uint8)))


def seed_from_key_words(words) -> int:
    """The seed a run resumed from a threefry key continues with: the two
    uint32 key words (w0, w1) as the 64-bit integer (w0 << 32) | w1."""
    w0, w1 = (int(w) & 0xFFFFFFFF for w in np.asarray(words).reshape(-1)[-2:])
    return (w0 << 32) | w1


class HardwareDraws(Draws):
    """`hardware_prng=True`: MCMC-step draws from the Philox kernels.

    The key is the seed's two 32-bit words and every kernel call takes the
    next call index, so a reset (`reseed`) restarts the stream. The key and
    the call counter are a `cuda_prng.PhiloxCounter`: two words on the
    sampler's device that the kernels read, and their host mirror (`key`,
    `counter`), which `tell`, `seek` and `get_state` read. A step launches
    on the words and adds its calls to them on the stream, so its launches
    replay in a CUDA graph (`graph_safe`); a graph's replay does not run
    this object's Python, so the loop that replays it advances the mirror
    (`loops.Loops.counters`). The warm-up and resampling draws, and the
    draws below the routing thresholds, still come from the generator, as
    in JAX. So do all the draws of a run in another dtype than float32: the
    kernels draw float32 only, and JAX's `hw_prng_supported`
    (pallas_prng.py:46-48) sends every other dtype to threefry, so the flag
    does not apply there.
    """

    calls: Optional[cuda_prng.PhiloxCounter] = None

    def reseed(self, seed: int) -> None:
        super().reseed(seed)
        key = philox.key_from_seed(seed)
        if self.calls is None:
            self.calls = cuda_prng.PhiloxCounter(key, self.device)
        else:  # the same words, which CUDA graphs may hold
            self.calls.set_key(key)
            self.calls.seek(0)

    @property
    def key(self) -> philox.Key:
        return self.calls.key

    @property
    def counter(self) -> int:
        return self.calls.counter

    def tell(self):
        return super().tell(), self.calls.counter

    def seek(self, position) -> None:
        super().seek(position[0])
        self.calls.seek(position[1])

    def get_state(self) -> Dict[str, np.ndarray]:
        return {**super().get_state(), "philox_key": np.array(self.key, dtype=np.uint32),
                "philox_counter": np.array(self.counter, dtype=np.int64)}

    def set_state(self, state: Dict[str, np.ndarray]) -> None:
        super().set_state(state)
        if "philox_key" in state:  # absent from a file written by plain Draws
            self.calls.set_key(tuple(int(w) for w in state["philox_key"]))
            self.calls.seek(int(state["philox_counter"]))

    def mcmc_step(self, n_candidates, n, d, gamma_shape):
        if self.dtype != torch.float32:
            return super().mcmc_step(n_candidates, n, d, gamma_shape)
        z_shape = (n_candidates, n, d)
        n_z = n_candidates * n * d
        calls = self.calls
        if gamma_shape is not None and n_z <= FUSED_DRAWS_MAX_ELEMS:  # tpCN only
            out = calls.mutation_draws(0, gamma_shape, z_shape)
            calls.advance(1)
            return out
        used = 0
        g = None
        if gamma_shape is not None:
            if n >= HW_GAMMA_MIN_WALKERS:
                g = calls.gamma(used, gamma_shape)
                used += philox.GAMMA_CALLS
            else:
                g = torch._standard_gamma(gamma_shape, generator=self.generator)
        if n_z >= HW_NORMAL_MIN_ELEMS:
            z = calls.normal(used, z_shape)
            used += 1
        else:
            z = torch.randn(z_shape, generator=self.generator, dtype=self.dtype, device=self.device)
        calls.advance(used)
        return z, g, self._uniform((n,))


class BlockDraws:
    """The rank's block of each global draw, under a particle mesh.

    `draws` (a `Draws` or `HardwareDraws`, seeded alike on every rank)
    draws the arrays of the whole run; this object hands on the warm-up's
    prior draw and the MCMC steps' normals, gamma draws and acceptance
    uniforms for walkers [rank n, (rank + 1) n), where n is the rank's
    block width. The warm-up's patch uniforms, the resampling uniforms and
    the bootstrap's are global, as the collectives that use them need.
    `graph_safe`, `generator`, `calls`, `tell` and `seek` are the wrapped
    draws': every rank draws the global arrays, so the position is global
    and the same on every rank.
    """

    def __init__(self, draws: Draws, rank: int, world: int):
        self.draws, self.rank, self.world = draws, rank, world

    @property
    def graph_safe(self) -> bool:
        return getattr(self.draws, "graph_safe", False)

    @property
    def generator(self) -> Optional[torch.Generator]:
        return getattr(self.draws, "generator", None)

    @property
    def calls(self) -> Optional[cuda_prng.PhiloxCounter]:
        return getattr(self.draws, "calls", None)

    @property
    def tell(self):
        """The wrapped draws' `tell` (None for a source without one, which
        the MCMC loop then does not put back)."""
        return getattr(self.draws, "tell", None)

    @property
    def seek(self):
        return getattr(self.draws, "seek", None)

    def _block(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        n = t.shape[dim] // self.world
        return t.narrow(dim, self.rank * n, n)

    def warmup(self, n: int, d: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """`n` is the global N."""
        u, patch = self.draws.warmup(n, d)
        return self._block(u), patch

    def reseed(self, seed: int) -> None:
        self.draws.reseed(seed)

    def resample(self, n: int, method: str) -> torch.Tensor:
        return self.draws.resample(n, method)

    def mcmc_step(self, n_candidates, n, d, gamma_shape):
        """`n` is the rank's block width; `gamma_shape` the global (N,) shapes."""
        z, g, u = self.draws.mcmc_step(n_candidates, n * self.world, d, gamma_shape)
        return self._block(z, 1), None if g is None else self._block(g), self._block(u)

    def bootstrap(self, n_bootstrap: int, t_max: int) -> torch.Tensor:
        return self.draws.bootstrap(n_bootstrap, t_max)

    def get_state(self) -> Dict[str, np.ndarray]:
        return self.draws.get_state()

    def set_state(self, state: Dict[str, np.ndarray]) -> None:
        self.draws.set_state(state)

    def key_words(self) -> np.ndarray:
        return self.draws.key_words()
