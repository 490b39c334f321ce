"""The fused iteration of `run()` and `sample()`.

Counterpart of tempest_tpu/fused.py: `_make_iteration_fn` (:38-250) and
`make_fused_iteration` (:338) run the whole iteration as one device
program, and `make_fused_run` (:365-456) runs the whole annealing loop on
the device with its termination test there (:411-426). Here:

- `make_fused_iteration` is the `iteration.py` pipeline with its loops in
  chunks (`CHUNKS` bodies between two reads of the exit predicate) through
  one `loops.Loops` of the sampler; the loops include the reweight's
  bisections under a mesh and in dynamic mode (`steps/reweight.py`).
  Between the loops the iteration runs straight through on the stream; it
  reads beta once (the warm-up branch, JAX's `lax.cond` at :242) and
  nothing else.
- The annealing loop is `SamplerCore.run_sampling`'s, on every route: its
  termination test needs no read while 1 - beta >= 1e-4 (the iteration
  read beta already); past that it evaluates the posterior ESS on the
  device and reads it once. Capacity grows as core.py:449-462 grows it.
- With `loops.graphs` on (`run(on_device=True)` on a CUDA device) every
  loop chunk (the ESS bracket, the CV bisection, the sharded ESS
  bisection, the mode EM, the GMM EM, each split round's head and tail,
  the MCMC steps with the likelihood inside) is captured once per shape as
  a CUDA graph and replayed from static buffers updated in place
  (`loops.py`); the draws' generator is registered with each graph, and
  the hardware-PRNG call counter with the loops (`Loops.counters`). A
  capture that fails raises `loops.CaptureError`. Without graphs
  (`on_device=False`, `sample()`, or the CPU) the same chunks run eagerly,
  so the two give the same results, as in JAX.

The fused route covers every configuration but `host_likelihood=True`
(`fused_route`): one device or a particle mesh (`mesh=`, fused.py:102-112,
:168-177, :225; the chunks' collectives are captured with them on CUDA,
and the draws are a `draws.BlockDraws`, whose position is global), ESS or
dynamic mode (:223-224), with or without clustering, at any
`cluster_every`, in float32 or float64, with the generator's draws or
`hardware_prng=True` (whose kernels read their call counter from the
device, `draws.HardwareDraws`). A host likelihood runs on the host by
design and keeps the eager route of `iteration.py`, whose loops read
after every body. The TPU-only parts of the JAX module are not ported:
the layout pins (:253-292), donation (:295-312) and the relay watchdog's
dispatch budget (core.py:366-463).
"""

from __future__ import annotations

from typing import Callable

from .config import SamplerConfig
from .iteration import make_iteration
from .loops import Loops

# Bodies a chunk runs before the host reads the loop's exit. The MCMC loop's
# first chunk is the n_steps * d steps its clamp always runs.
CHUNKS = {"ess_bracket": 8, "cv_bisect": 8, "ess_sharded": 8, "mode_em": 4, "gmm_em": 4,
          "mcmc": 8}


def fused_route(config: SamplerConfig) -> bool:
    """Whether `config` runs the fused iteration: all but a host likelihood."""
    return not config.host_likelihood


def make_fused_iteration(
    config: SamplerConfig, log_likelihood_batch: Callable, prior_transform_batch: Callable,
) -> Callable:
    """The iteration with chunked loops: `iteration(draws, hist, cur, model)
    -> (hist, cur, model)`; `iteration.loops.graphs` turns the CUDA graphs
    on, with the generators in `iteration.loops.generators` registered."""
    return make_iteration(config, log_likelihood_batch, prior_transform_batch,
                          Loops(config.device, CHUNKS))
