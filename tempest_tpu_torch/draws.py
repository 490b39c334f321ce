"""Random draws of the sampler.

Every stochastic step of the port is a function of explicit draws; the
loops take those draws from a draws object with four methods (`warmup`,
`resample`, `mcmc_step`, `bootstrap`). `Draws` takes the bootstrap's draws
from one seeded `torch.Generator` on the sampler's device, and on the CPU
every other draw too. On a CUDA device (`keyed`, float32 and float64 alike)
every draw of an iteration (the warm-up's prior draw and patch uniforms,
the resampling uniforms and every draw of an MCMC step) comes from the
Philox kernels of `ops/cuda_prng.py` in the run's dtype (their float64
entries draw in double: 53-bit uniforms, Box-Muller and Marsaglia-Tsang
in double, 16 rounds), keyed by a call counter on the
device (`cuda_prng.PhiloxCounter`), as JAX carries its threefry key in the
`while_loop`'s carry (tempest_tpu/mcmc.py:289, tempest_tpu/fused.py:430):
a draw adds its calls to the counter's device word, a step times its
`active` flag, so a step past the stop of its chain draws nothing new and
the loop that runs the steps need not put anything back; inside a
conditional body the calls count only where the body runs
(`PhiloxCounter.guards`). That lets a CUDA graph run the whole chain as one
WHILE node (`mcmc.py`), and the whole annealing run as one (`fused.py`),
which a generator's host-side Philox offset, fixed at capture, would not.
So no CUDA graph of a sampler draws from the generator. A keyed draw on a
CUDA tensor goes to its kernel or raises; nothing falls back to the
generator. `HardwareDraws`, the source of `hardware_prng=True` in float32,
draws from the same kernels under another key, `philox.key_from_seed(seed)`
where `Draws` takes `philox.draws_key(seed)`, so the two flags stay two
streams, as threefry and the hardware PRNG are in JAX; it is keyed on
every device (on the CPU through the kernels' plain versions). In float64
the flag does not apply, as in JAX (`hw_prng_supported`,
pallas_prng.py:46-48): the sampler takes `Draws` there
(`core.SamplerCore._make_draws`). A test can
hand a loop another object with the same methods (for instance one that
replays the JAX package's key chain) and compare values with `tempest_tpu`,
not only distributions.

`get_state()` / `set_state()` carry the whole draw state through a
checkpoint as numpy arrays: the generator's own state (for a CUDA
generator its seed and offset, `torch.Generator.get_state`), and the key
and call counter of the keyed steps (`step_key`, `step_counter` for
`Draws`; `philox_key`, `philox_counter` for `HardwareDraws`). Restoring it
continues the stream where it stopped; nothing is re-seeded, and a file
without the keyed words restarts the keyed stream at counter 0.
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

# The largest R N d of a step the mutation-draws kernel draws (its z block
# fitted the TPU's scoped VMEM); past it a keyed step takes the gamma, normal
# and uniform kernels.
FUSED_DRAWS_MAX_ELEMS = 1 << 19  # tempest_tpu/ops/pallas_prng.py:226, 235


class Draws:
    """The draws of one run, from a seeded generator on `device`, and where
    `keyed` (float32 or float64 on a CUDA device; `KEYED_ON_CPU` adds the
    CPU) every draw but the bootstrap's from the Philox kernels on the call
    counter `calls` (the warm-up's, the resampling's and the MCMC steps'),
    in the run's dtype. A keyed CUDA graph registers the counter
    (`loops.Loops.counters`) and replays the draws of its capture's eager
    run from the counter's current word."""

    calls: Optional[cuda_prng.PhiloxCounter] = None
    # The checkpoint names of the keyed steps' key and call counter.
    STATE_KEYS = ("step_key", "step_counter")
    KEYED_ON_CPU = False

    def __init__(self, seed: int, device, dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        self.keyed = dtype in cuda_prng.DTYPES and (
            self.KEYED_ON_CPU or self.device.type == "cuda")
        self.generator = torch.Generator(device=self.device)
        self.reseed(seed)

    def step_key(self, seed: int) -> Optional[philox.Key]:
        """The key of the keyed steps of seed `seed` (None: not keyed)."""
        return philox.draws_key(seed) if self.keyed else None

    def reseed(self, seed: int) -> None:
        """Start the stream of `seed` again, on the same generator object
        and call counter words (which CUDA graphs may hold)."""
        self.generator.manual_seed(int(seed))
        key = self.step_key(seed)
        if key is None:
            return
        if self.calls is None:
            self.calls = cuda_prng.PhiloxCounter(key, self.device)
        else:
            self.calls.set_key(key)
            self.calls.seek(0)

    @property
    def key(self) -> philox.Key:
        return self.calls.key

    @property
    def counter(self) -> int:
        """The keyed steps' call counter (a host read of its device word;
        0 where no step is keyed)."""
        return 0 if self.calls is None else self.calls.counter

    def _uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, dtype=self.dtype, device=self.device)

    def warmup(self, n: int, d: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The prior draw (n, d) and the (n,) uniforms of the infinite-logl
        patch; keyed, two calls of the uniform kernel, in (0, 1]."""
        if not self.keyed:
            return self._uniform((n, d)), self._uniform((n,))
        out = self.calls.uniform(0, (n, d), self.dtype), self.calls.uniform(1, (n,), self.dtype)
        self.calls.advance(2)
        return out

    def resample(self, n: int, method: str) -> torch.Tensor:
        """Uniforms of the resampler: (n,) for "mult", one for "syst"; keyed,
        one call of the uniform kernel, in (0, 1]."""
        shape = (n,) if method == "mult" else ()
        if not self.keyed:
            return self._uniform(shape)
        out = self.calls.uniform(0, shape, self.dtype)
        self.calls.advance(1)
        return out

    def mcmc_step(
        self, n_candidates: int, n: int, d: int, gamma_shape: Optional[torch.Tensor],
        active: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        """One MCMC step: (R, n, d) proposal normals, the (n,) unit-scale
        gamma(gamma_shape) mixture draws (tpCN only, else None) and the (n,)
        acceptance uniforms. Keyed, the step's calls count only where the 0-d
        bool `active` holds (always where it is None)."""
        if self.keyed:
            return self._keyed_step(n_candidates, n, d, gamma_shape, active)
        g = None
        if gamma_shape is not None:
            g = torch._standard_gamma(gamma_shape, generator=self.generator)
        z = torch.randn(
            (n_candidates, n, d), generator=self.generator, dtype=self.dtype, device=self.device
        )
        return z, g, self._uniform((n,))

    def _keyed_step(self, n_candidates, n, d, gamma_shape, active):
        """Every draw of a step from the Philox kernels on `calls`, in the
        run's dtype: the mutation-draws kernel (one call) for tpCN at
        R n d <= 2^19, else the gamma kernel (tpCN; 13 calls in float32, 33
        in float64), the normal kernel and the uniform kernel (one call
        each)."""
        calls, dtype = self.calls, self.dtype
        z_shape = (n_candidates, n, d)
        if gamma_shape is not None and n_candidates * n * d <= FUSED_DRAWS_MAX_ELEMS:
            out, used = calls.mutation_draws(0, gamma_shape, z_shape), 1
        else:
            used, g = 0, None
            if gamma_shape is not None:
                g, used = calls.gamma(0, gamma_shape), philox.gamma_calls(gamma_shape.dtype)
            z = calls.normal(used, z_shape, dtype)
            out, used = (z, g, calls.uniform(used + 1, (n,), dtype)), used + 2
        calls.advance(used, active)
        return out

    def bootstrap(self, n_bootstrap: int, t_max: int) -> torch.Tensor:
        """(n_bootstrap, t_max) uniforms of the block bootstrap of logZ."""
        return self._uniform((n_bootstrap, t_max))

    def get_state(self) -> Dict[str, np.ndarray]:
        state = {"generator": self.generator.get_state().numpy().copy()}
        if self.calls is not None:
            key, counter = self.STATE_KEYS
            state[key] = np.array(self.key, dtype=np.uint32)
            state[counter] = np.array(self.counter, dtype=np.uint64).astype(np.int64)
        return state

    def tell(self):
        """The generator's position, its state (the eager MCMC chunks put
        unkeyed draws back to it). Keyed draws do not move it."""
        return self.generator.get_state()

    def seek(self, position) -> None:
        """Put the generator back to a position from `tell`."""
        self.generator.set_state(position)

    def key_words(self) -> np.ndarray:
        """The run's seed as the two uint32 words of a threefry key
        (`jax.random.PRNGKey(seed)`)."""
        seed = self.generator.initial_seed()
        return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=np.uint32)

    def set_state(self, state: Dict[str, np.ndarray]) -> None:
        self.generator.set_state(torch.from_numpy(np.asarray(state["generator"], np.uint8)))
        if self.calls is None:
            return
        key, counter = self.STATE_KEYS
        if key in state:
            self.calls.set_key(tuple(int(w) for w in state[key]))
            self.calls.seek(int(np.asarray(state[counter]).astype(np.uint64)))
        else:  # a file of another source: the keyed stream starts again
            self.calls.seek(0)


def seed_from_key_words(words) -> int:
    """The seed a run resumed from a threefry key continues with: the two
    uint32 key words (w0, w1) as the 64-bit integer (w0 << 32) | w1."""
    w0, w1 = (int(w) & 0xFFFFFFFF for w in np.asarray(words).reshape(-1)[-2:])
    return (w0 << 32) | w1


class HardwareDraws(Draws):
    """`hardware_prng=True`: MCMC-step draws from the Philox kernels.

    The key is the seed's two 32-bit words (`philox.key_from_seed`) and
    every kernel call takes the next call index, so a reset (`reseed`)
    restarts the stream. The key and the call counter are a
    `cuda_prng.PhiloxCounter`, made whatever the device. Every draw of an
    iteration is keyed as `Draws`' are on the card, on the CPU too (the
    plain versions): the warm-up's and the resampling's too, which JAX
    takes from threefry, so that a CUDA graph can run the whole annealing
    loop. JAX's `hw_prng_supported` (pallas_prng.py:46-48) sends every
    other dtype than float32 to threefry, so the sampler makes this object
    in float32 only (`core.SamplerCore._make_draws`).
    """

    STATE_KEYS = ("philox_key", "philox_counter")
    KEYED_ON_CPU = True

    def step_key(self, seed: int) -> philox.Key:
        return philox.key_from_seed(seed)


class BlockDraws:
    """The rank's block of each global draw, under a particle mesh.

    `draws` (a `Draws` or `HardwareDraws`, seeded alike on every rank)
    draws the arrays of the whole run; this object hands on the warm-up's
    prior draw and the MCMC steps' normals, gamma draws and acceptance
    uniforms for walkers [rank n, (rank + 1) n), where n is the rank's
    block width. The warm-up's patch uniforms, the resampling uniforms and
    the bootstrap's are global, as the collectives that use them need.
    `keyed`, `generator`, `calls`, `tell` and `seek` are the wrapped
    draws': every rank draws the global arrays, so the position is global
    and the same on every rank.
    """

    def __init__(self, draws: Draws, rank: int, world: int):
        self.draws, self.rank, self.world = draws, rank, world

    @property
    def keyed(self) -> bool:
        return getattr(self.draws, "keyed", False)

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

    def mcmc_step(self, n_candidates, n, d, gamma_shape, active=None):
        """`n` is the rank's block width; `gamma_shape` the global (N,) shapes."""
        extra = {} if active is None else {"active": active}
        z, g, u = self.draws.mcmc_step(n_candidates, n * self.world, d, gamma_shape, **extra)
        return self._block(z, 1), None if g is None else self._block(g), self._block(u)

    def bootstrap(self, n_bootstrap: int, t_max: int) -> torch.Tensor:
        return self.draws.bootstrap(n_bootstrap, t_max)

    def get_state(self) -> Dict[str, np.ndarray]:
        return self.draws.get_state()

    def set_state(self, state: Dict[str, np.ndarray]) -> None:
        self.draws.set_state(state)

    def key_words(self) -> np.ndarray:
        return self.draws.key_words()
