"""The fused iteration of `run()` and `sample()`, and the device run loop.

Counterpart of tempest_tpu/fused.py: `_make_iteration_fn` (:38-250) and
`make_fused_iteration` (:338) run the whole iteration as one device
program, and `make_fused_run` (:365-456) runs the whole annealing loop on
the device with its termination test there (:411-426). Here:

- `make_fused_iteration` is the `iteration.py` pipeline with its loops in
  chunks (`CHUNKS` bodies between two reads of the exit predicate) through
  one `loops.Loops` of the sampler; the loops include the reweight's
  bisections under a mesh and in dynamic mode (`steps/reweight.py`), which
  run in their loop form (a WHILE node each) where the loops are graphed.
  Between the loops the iteration runs straight through on the stream; it
  reads beta once (the warm-up branch, JAX's `lax.cond` at :242) and
  nothing else.
- `make_fused_run` is the annealing loop as one `loops.Loops.repeat`,
  "run": its body is one whole iteration, its predicate JAX's `cond`
  (:411-426, `run_predicate`): go on while 1 - beta >= 1e-4, or else while
  the posterior ESS at beta = 1 is below n_total (evaluated only where beta
  is finished: a `loops.when`), and while t < capacity. Its carry is the
  history, written in place (`state.commit`), the active set with the
  iteration counter, step and call counts as device words, and the
  carried cluster model with its `fitted` flag. Every configuration
  takes it: float32 or float64 (on the card
  every draw of either is keyed, `draws.Draws.keyed`), on one device or a
  particle mesh (the predicate's ESS reduced over the ranks,
  `run_predicate`'s `group`), in ESS or dynamic mode (the bisections'
  WHILE nodes, the dynamic boundary rules' IF nodes), clustered or not at
  any `cluster_every`, either `hardware_prng`, a torch likelihood or a
  host one (`host_likelihood=True`: its host-call kernel in the warm-up's
  IF body and the MCMC chain's WHILE body, served by the thread that
  replays the graph, `utils.wrappers.HostLikelihood`; the predicate ANDs
  in the word that kernel sets where the likelihood raised, so the loop
  ends after that iteration and the replay re-raises the exception).
  `SamplerCore.run_sampling` drives it for `run(on_device=True)` without `save_every`, as
  `_run_on_device` does (tempest_tpu/core.py:334-464): the first iteration
  (t = 0) on the per-iteration route, as `make_fused_run` requires
  (:380), then one dispatch of the loop, one read of `t` after it, and,
  where the history filled first, the capacity doubled and the loop
  entered again.
- With `loops.graphs` on (`run(on_device=True)` on a CUDA device) the run
  loop is one CUDA graph whose top level is a WHILE node: its body holds
  the iteration's IF nodes (the warm-up and mutation branches, the cluster
  cadence, the split rounds, the termination test's ESS, dynamic mode's CV
  step) and the WHILE nodes of the MCMC chain and of the reweight's
  bisections (the ESS bracket under a mesh, the CV bisection inside the CV
  step's IF node, the sharded ESS bisection), so a dispatch is one replay
  and the host reads nothing between iterations; under a mesh the
  collectives are captured inside those bodies, every rank replaying its
  own graph and reading the same `t`. The per-iteration route with graphs
  (the first iteration of a run on the device, or `loops.graphs` turned on
  by hand around `sample()`) replays its loops as CUDA graphs (`loops.py`) between
  host decisions: the bisections and the MCMC chain in their loop form,
  one replay of a WHILE node each, the EM loops in chunks, each captured
  once per shape, all replayed from static buffers updated in place; the
  draws' call counter is registered with the loops (`Loops.counters`). A
  capture that fails raises `loops.CaptureError`; nothing falls back. Without
  graphs (`on_device=False`, `sample()`, or the CPU) the same loops run
  eagerly, so the routes give the same results, as in JAX; on the CPU
  `run(on_device=True)` takes the run loop too, a Python loop whose
  decisions the host reads.

The fused route covers every configuration, as JAX builds its fused
iteration for every one (tempest_tpu/core.py:151-155): one
device or a particle mesh (`mesh=`, fused.py:102-112, :168-177, :225; the
chunks' collectives are captured with them on CUDA, and the draws are a
`draws.BlockDraws`, whose position is global), ESS or dynamic mode
(:223-224), with or without clustering, at any `cluster_every`, in float32
or float64, either `hardware_prng`, and a host likelihood, which JAX calls
through `jax.pure_callback` inside its program: on the CPU one counted
read a sweep, on the card the host-call kernel (`ops.cuda_host`). The
eager iteration of `iteration.py` alone (a read after every body) is the
tests' reference. The
TPU-only parts of the JAX module are not ported: the layout pins
(:253-292), donation (:295-312) and the relay watchdog's dispatch budget
(core.py:366-463), so a dispatch runs until the loop ends or the history
fills.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from .cluster import MODEL_TENSORS, ClusterModel
from .config import SamplerConfig
from .iteration import make_iteration
from .loops import Loops
from .ops.tools import ess_from_logw_psum
from .parallel.mesh import particle_group
from .state import Current, History, compute_logw_and_logz

Tensors = Dict[str, torch.Tensor]

# Bodies a chunk runs before the host reads the loop's exit. The MCMC loop's
# first chunk is the n_steps * d steps its clamp always runs.
CHUNKS = {"ess_bracket": 8, "cv_bisect": 8, "ess_sharded": 8, "mode_em": 4, "gmm_em": 4,
          "mcmc": 8}

# The annealing ends once 1 - beta < BETA_DONE and the posterior ESS reached
# n_total (core.py:360-374, fused.py:421).
BETA_DONE = 1e-4


def make_fused_iteration(
    config: SamplerConfig, log_likelihood_batch: Callable, prior_transform_batch: Callable,
) -> Callable:
    """The iteration with chunked loops: `iteration(draws, hist, cur, model)
    -> (hist, cur, model)`; `iteration.loops.graphs` turns the CUDA graphs
    on, with the draws' call counter in `iteration.loops.counters`."""
    return make_iteration(config, log_likelihood_batch, prior_transform_batch,
                          Loops(config.device, CHUNKS))


def beta_unfinished(beta: torch.Tensor) -> torch.Tensor:
    """1 - beta >= 1e-4, in beta's dtype (fused.py:421)."""
    return 1.0 - beta >= BETA_DONE


def ess_below(hist: History, n_total, group=None) -> torch.Tensor:
    """Whether the posterior ESS of the MIS weights at beta = 1 is below
    `n_total` (fused.py:414-419)."""
    logw, _ = compute_logw_and_logz(hist, 1.0, group=group)
    return ess_from_logw_psum(logw, group) < n_total


def run_predicate(loops: Loops, hist: History, beta: torch.Tensor, n_total,
                  group=None) -> torch.Tensor:
    """JAX's `cond` of the run loop (fused.py:411-426) as a 0-d bool: beta
    unfinished, or else the posterior ESS below `n_total` (evaluated only
    where beta is finished, `loops.when`), and t < capacity; and no host
    call's likelihood raised (`Loops.unhalted`)."""
    unfinished = beta_unfinished(beta)
    go = loops.when(~unfinished, lambda s: {"go": ess_below(hist, n_total, group)},
                    {"go": unfinished}, "termination")["go"]
    return loops.unhalted(go & (hist.t < hist.capacity), group)


# The carry of the run loop: the history's fields (its host mirror of t
# left out), the active set's and the carried model's, by prefix.
_HISTORY = tuple(f.name for f in dataclasses.fields(History) if f.name != "t_host")
_CURRENT = tuple(f.name for f in dataclasses.fields(Current))


def pack(hist: History, cur: Current, model: ClusterModel) -> Tensors:
    """The run loop's carry: every field a tensor on the device."""
    dev = hist.logl.device
    out = {"h." + f: getattr(hist, f) for f in _HISTORY if getattr(hist, f) is not None}
    for f in _CURRENT:
        value = getattr(cur, f)
        if value is None:
            continue
        if not isinstance(value, torch.Tensor):  # a host count: a device word
            dtype = torch.int64 if f == "iteration" else torch.int32
            value = torch.full((), int(value), dtype=dtype, device=dev)
        out["c." + f] = value
    out.update({"m." + f: getattr(model, f) for f in MODEL_TENSORS})
    fitted = model.fitted
    out["m.fitted"] = (fitted.reshape(()) if isinstance(fitted, torch.Tensor)
                       else torch.full((), bool(fitted), device=dev))  # a fill: no host copy
    return out


def unpack(c: Tensors, normalize: bool) -> Tuple[History, Current, ClusterModel]:
    """`pack`'s inverse, on the same tensors; the history's host mirror of t
    is unknown (`History.t_host` None)."""
    hist = History(**{f: c.get("h." + f) for f in _HISTORY}, t_host=None)
    cur = Current(**{f: c.get("c." + f) for f in _CURRENT})
    model = ClusterModel(**{f: c["m." + f] for f in MODEL_TENSORS}, normalize=normalize,
                         fitted=c["m.fitted"])
    return hist, cur, model


def make_fused_run(config: SamplerConfig, iteration: Callable) -> Callable:
    """The whole annealing run as one loop (fused.py:365-456):
    `run(draws, hist, cur, model, n_total) -> (hist, cur, model)` runs
    `iteration` (`make_fused_iteration`'s) while `run_predicate` holds,
    from a history with t >= 1 (under a mesh, this rank's block; the
    predicate's ESS reduced over the ranks); it returns at termination or
    when the history is full (t == capacity), with `cur.iteration`, `cur.steps`,
    `cur.calls` and `model.fitted` device words and `hist.t_host` unknown.
    With `iteration.loops.graphs` on a CUDA device the loop is one replay
    of the "run" stretch (a WHILE node); elsewhere a Python loop that reads
    its predicate after every iteration."""
    loops: Loops = iteration.loops
    normalize = config.normalize
    group = None if config.mesh is None else particle_group(config.mesh, config.particle_axis)

    def run(draws, hist: History, cur: Current, model: ClusterModel,
            n_total: int) -> Tuple[History, Current, ClusterModel]:
        def body(c: Tensors, k: Tensors) -> Tensors:
            h, cu, m = iteration(draws, *unpack(c, normalize))
            return dict(pack(h, cu, m), n_total=c["n_total"])

        def pred(c: Tensors) -> torch.Tensor:
            h, cu, _ = unpack(c, normalize)
            return run_predicate(loops, h, cu.beta, c["n_total"], group)

        carry = dict(pack(hist, cur, model), n_total=torch.full(
            (), int(n_total), dtype=torch.int64, device=hist.logl.device))
        out = loops.repeat("run", pred, body, carry, {}, static=(id(draws),))
        return unpack(out, normalize)

    return run
