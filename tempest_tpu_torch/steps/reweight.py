"""Reweighting step: pick the next inverse temperature.

Counterpart of tempest_tpu/steps/reweight.py. Two modes, as there:

- ESS mode (:195-224): the bisection is `ops.cuda_reweight.ess_bisect_beta`,
  the CUDA kernel for a history on the GPU, its plain version for a
  history on the CPU. Under a particle mesh (`group`) JAX bypasses its
  kernel (tempest_tpu/fused.py:225) and bisects in XLA
  (`_find_beta_bisection`, :122-166); so does the port, at any world size:
  `_sharded_ess_beta` reduces each probe's ESS over the ranks.
- Dynamic mode (`volume_variation`, :225-241): an ESS bracket
  (`_find_ess_bracket`, :73-119), then a bisection on the volume-variation
  CV inside it (`_find_beta_bisection`, :122-166), with the boundary rules
  of :234-241. JAX runs no Pallas kernel in this mode. The port's bracket
  on a GPU outside a mesh is one launch of the ESS kernel's bracket mode
  (`ops.cuda_reweight.ess_bracket`); the CV's eigenvalues come from
  `ops.cuda_linalg.eigvalsh`, the port's kernel for a CUDA tensor, which
  reads nothing on the host.

The three bisections (the bracket on the CPU or under a mesh, the CV
bisection and the sharded ESS bisection) are device loops of
`loops.Loops`, as JAX's `lax.while_loop`s: the carry is (lo, hi, beta, i,
done) with JAX's rules; the stay, jump and CV boundary tests are
`torch.where`s and the loop's initial `done`; a body that runs past `done`
changes nothing, so every form gives the same bits. Where the loops are
graphed or inside a stretch (the body of the device run loop,
`fused.make_fused_run`) each is `Loops.repeat`: a CUDA-graph WHILE node
that reads nothing. Elsewhere (eager runs, the CPU) it runs its bodies in
chunks (`fused.CHUNKS`: "ess_bracket", "cv_bisect", "ess_sharded"; one
body a chunk by default) and reads `done` once a chunk. Dynamic mode's
decisions follow the same split: inside a stretch `crossing` is the
device bool lo != hi and the CV step is a `loops.when` on it, an IF node
holding the two boundary CVs and the "cv_bisect" WHILE node, whose initial
`done` is the boundary test; outside a stretch the host reads the bracket
(the kernel's (lo, hi) or the loop's last read) and, in chunks, the
boundary rules before the loop. `PROBES` counts the dynamic reweights and
the probes of each kind in device words (`loops.DeviceCounts`), added on
the stream from each loop's `i` and the bracket kernel's probe word, so
a run of the device run loop counts them as an eager run does, and the
host reads them only when asked.

Both end with the final weights, ESS, CV and logZ at the chosen beta
(:243-248). Under a mesh every reduction goes over the ranks' blocks, a
body's ESS or CV reductions are its collectives, and each read is of a
reduced value, the same on every rank, so the ranks run the same bodies
and reach the same beta.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..config import (
    BETA_RTOL,
    BETA_TOLERANCE,
    ESS_TOLERANCE,
    MAX_BISECTION_ITERATIONS,
    METRIC_ATOL,
    METRIC_ATOL_CV,
)
from ..loops import DeviceCounts, Loops
from ..ops.cuda_reweight import ess_bisect_beta, ess_bracket
from ..ops.tools import ess_from_logw_psum, logsumexp_psum, volume_variation_dtn
from ..state import History, logw_from_denominator, mis_denominator

Tensors = Dict[str, torch.Tensor]

# Dynamic-mode reweights and the probes of each bisection: ESS evaluations
# of the bracket search (ESS(beta_prev) and ESS(1) included), CV
# evaluations of the boundary tests and the bisection, and the ESS
# evaluations of the sharded ESS-mode bisection.
PROBES = DeviceCounts("reweights", "ess_bracket", "cv", "ess_sharded")


class ReweightResult(NamedTuple):
    beta: torch.Tensor  # () new inverse temperature
    weights: torch.Tensor  # (T_max, N) normalized importance weights (masked)
    ess: torch.Tensor  # () effective sample size at beta
    cv: torch.Tensor  # () volume variation at beta
    logz: torch.Tensor  # () evidence estimate at beta


def _interval_tol(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Bracket-scaled interval tolerance (reweight.py:41-44)."""
    scale = torch.clamp(torch.maximum(lo.abs(), hi.abs()), min=torch.finfo(lo.dtype).tiny)
    return torch.maximum(BETA_RTOL * scale, BETA_TOLERANCE * scale)


# ---------------------------------------------------------------------------
# Probes: functions of the loop constants `k` (logl, denom, keep; u and mask
# for the CV), as `state.logw_from_denominator` computes them.
# ---------------------------------------------------------------------------
def _logw(k: Tensors, beta: torch.Tensor, group, normalize: bool) -> torch.Tensor:
    logw = beta * k["logl"] - k["denom"]
    logw = torch.where(k["keep"], logw, torch.full_like(logw, float("-inf")))
    return logw - logsumexp_psum(logw, group) if normalize else logw


def _ess(k: Tensors, beta: torch.Tensor, group) -> torch.Tensor:
    """ESS of the normalized weights (dynamic mode's `ess_at`)."""
    return ess_from_logw_psum(_logw(k, beta, group, True), group)


def _ess_unnormalized(k: Tensors, beta: torch.Tensor, group) -> torch.Tensor:
    """ESS of the unnormalized weights (the sharded ESS-mode bisection's)."""
    return ess_from_logw_psum(_logw(k, beta, group, False), group)


def _cv(k: Tensors, beta: torch.Tensor, group) -> torch.Tensor:
    w = torch.exp(_logw(k, beta, group, True))
    return volume_variation_dtn(k["u"], w, mask=k["mask"], group=group)


def _consts(hist: History, denom: torch.Tensor, target: float, atol_floor: float) -> Tensors:
    dtype, device = hist.logl.dtype, hist.logl.device
    mask = hist.sample_mask()
    target_t = torch.full((), target, dtype=dtype, device=device)  # a fill: no host copy
    return {"logl": hist.logl, "denom": denom, "keep": mask & torch.isfinite(hist.logl),
            "mask": mask, "target": target_t,
            "atol": torch.clamp(ESS_TOLERANCE * target_t.abs(), min=atol_floor)}


# ---------------------------------------------------------------------------
# Loop bodies
# ---------------------------------------------------------------------------
def _bracket_open(lo, hi, i) -> torch.Tensor:
    """The bracket loop's condition (reweight.py:90-94)."""
    return ((hi - lo) > _interval_tol(lo, hi)) & (i < MAX_BISECTION_ITERATIONS)


def _bracket_body(group) -> Callable[[Tensors, Tensors], Tensors]:
    """One probe of the ESS bracket (reweight.py:96-102): the midpoint's
    ESS at or above the target moves lo up, else hi down."""

    def body(c: Tensors, k: Tensors) -> Tensors:
        lo, hi, go = c["lo"], c["hi"], ~c["done"]
        mid = 0.5 * (lo + hi)
        up = _ess(k, mid, group) >= k["target"]
        lo = torch.where(go & up, mid, lo)
        hi = torch.where(go & ~up, mid, hi)
        i = c["i"] + go.to(c["i"].dtype)
        return {"lo": lo, "hi": hi, "i": i, "done": ~_bracket_open(lo, hi, i)}

    return body


def _metric_body(metric_at: Callable, group, dynamic: bool) -> Callable[[Tensors, Tensors], Tensors]:
    """One probe of the metric bisection (reweight.py:122-166): converged
    when |metric - target| < the dual tolerance (`k["atol"]`), the
    interval is below tolerance or beta is 1; a non-finite metric counts
    as 1e10; CV rises with beta (dynamic), ESS falls; 200 probes at most."""

    def body(c: Tensors, k: Tensors) -> Tensors:
        lo, hi, go = c["lo"], c["hi"], ~c["done"]
        beta = 0.5 * (lo + hi)
        metric = metric_at(k, beta, group)
        metric = torch.where(torch.isfinite(metric), metric, torch.full_like(metric, 1e10))
        target = k["target"]
        conv = (((metric - target).abs() < k["atol"]) | ((hi - lo) < _interval_tol(lo, hi))
                | (beta == 1.0))
        up = metric < target if dynamic else metric >= target
        lo = torch.where(go & ~conv & up, beta, lo)
        hi = torch.where(go & ~conv & ~up, beta, hi)
        i = c["i"] + go.to(c["i"].dtype)
        done = c["done"] | conv | (i >= MAX_BISECTION_ITERATIONS)
        return {"lo": lo, "hi": hi, "beta": torch.where(go, beta, c["beta"]), "i": i,
                "done": done}

    return body


def _going(c: Tensors) -> torch.Tensor:
    """The bisection loops' predicate: not done."""
    return ~c["done"]


def _loop_form(loops: Loops) -> bool:
    """Whether the bisections run as `Loops.repeat`: where the loops are
    graphed or inside a stretch."""
    return loops.graphed or loops.inside


def _loop(loops: Loops, name: str, body, carry: Tensors, consts: Tensors, group,
          *keys: str) -> Tuple[Tensors, Optional[List[float]]]:
    """Loop `name` to its end: the carry, and the last read of the carry's
    `keys` on the host, or None where nothing was read. In the loop form
    (`_loop_form`) `Loops.repeat`, a WHILE node that reads nothing;
    elsewhere chunks of `loops.chunk(name)` bodies, a read of `done` (with
    `keys`) after each."""
    if _loop_form(loops):
        return loops.repeat(name, _going, body, carry, consts, static=(id(group),)), None
    run = loops.start(name, body, carry, consts, static=(id(group),))
    while True:
        run.advance(loops.chunk(name))
        values = run.read("done", *keys)
        if values[0]:
            return run.result(), values[1:]


def _metric_carry(lo, hi, done) -> Tensors:
    return {"lo": lo, "hi": hi, "beta": 0.5 * (lo + hi),
            "i": torch.zeros((), dtype=torch.int32, device=lo.device), "done": done}


# ---------------------------------------------------------------------------
# The three bisections
# ---------------------------------------------------------------------------
def _find_ess_bracket(hist: History, denom, beta_prev, ess_target: float, group=None,
                      loops: Optional[Loops] = None):
    """(beta_low, beta_high, crossing) where ESS crosses the target
    (reweight.py:73-119): both beta_prev when ESS(beta_prev) <= target,
    both 1 when ESS(1) >= target as well (the jump), else [beta_prev, 1]
    bisected down to the interval tolerance; `crossing` is beta_low !=
    beta_high, a host bool where the host read the bracket and a 0-d
    device bool inside a stretch (or after the loop form of a graphed
    bracket loop). A history on a GPU outside a mesh takes one launch of
    the ESS kernel's bracket mode (and, outside a stretch, one read of its
    (lo, hi)); elsewhere the "ess_bracket" loop runs. The ESS evaluations
    are added to `PROBES` on the device."""
    loops = loops or Loops(hist.logl.device)
    k = _consts(hist, denom, ess_target, METRIC_ATOL)
    if group is None and hist.logl.device.type == "cuda":
        bm = torch.where(k["mask"], denom, torch.full_like(denom, float("inf")))
        bracket, probes = ess_bracket(hist.logl.reshape(-1), bm.reshape(-1),
                                      torch.stack([beta_prev, k["target"]]))
        PROBES.add("ess_bracket", probes, bracket.device)
        if loops.inside:
            return bracket[0], bracket[1], bracket[0] != bracket[1]
        lo_h, hi_h = loops.read("ess_bracket", bracket)
        return bracket[0], bracket[1], lo_h != hi_h
    lo, hi, crossing, probes = _bracket_search(k, beta_prev, group, loops)
    PROBES.add("ess_bracket", probes, lo.device)
    return lo, hi, crossing


def _bracket_search(k: Tensors, beta_prev, group, loops: Loops):
    """Stay, jump or the "ess_bracket" loop on the constants `k`: the
    bracket (lo, hi), `crossing` (lo != hi: a host bool from the loop's last
    read, or a device bool where the loop read nothing) and the ESS
    evaluations it made (a 0-d int32 device word)."""
    target = k["target"]
    one = torch.ones_like(beta_prev)
    ess_cur, ess_one = _ess(k, beta_prev, group), _ess(k, one, group)
    stay = (ess_cur <= target) | (ess_one >= target)
    edge = torch.where((ess_cur > target) & (ess_one >= target), one, beta_prev)
    lo = torch.where(stay, edge, beta_prev)
    hi = torch.where(stay, edge, one)
    i = torch.zeros((), dtype=torch.int32, device=lo.device)
    out, read = _loop(loops, "ess_bracket", _bracket_body(group),
                      {"lo": lo, "hi": hi, "i": i, "done": ~_bracket_open(lo, hi, i)},
                      k, group, "lo", "hi")
    crossing = out["lo"] != out["hi"] if read is None else read[0] != read[1]
    return out["lo"], out["hi"], crossing, 2 + out["i"]


def ess_bracket_loop(logl: torch.Tensor, bm: torch.Tensor, scal: torch.Tensor,
                     loops: Optional[Loops] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic mode's ESS bracket by the "ess_bracket" loop: the plain
    version of the ESS kernel's bracket mode (`ops.cuda_reweight.
    ess_bracket`), on its inputs. logl: log-likelihoods and bm: the MIS
    denominator, +inf on the slots left out, of one shape; scal: (2,) =
    (beta_prev, target). Returns the (2,) bracket (lo, hi) in the inputs'
    dtype and the (1,) int32 count of ESS evaluations."""
    loops = loops or Loops(logl.device)
    k = {"logl": logl, "denom": bm, "keep": torch.isfinite(logl) & (bm != float("inf")),
         "target": scal[1]}
    lo, hi, _, probes = _bracket_search(k, scal[0], None, loops)
    return torch.stack([lo, hi]), probes.reshape(1)


def _find_cv_beta(hist: History, denom, beta_prev, beta_high, cv_target: float, group=None,
                  loops: Optional[Loops] = None) -> torch.Tensor:
    """The beta of the CV target in [beta_prev, beta_high] (reweight.py:
    226-241): beta_high when the target is at or above CV(beta_high),
    beta_prev when at or below CV(beta_prev), else the CV bisection, the
    "cv_bisect" loop, whose initial `done` is that boundary test: in its
    loop form (graphed, or inside a stretch) a WHILE node that runs no body
    where a rule holds; in chunks the host reads the rules first (most
    reweights end there) and runs the loop only where neither holds."""
    loops = loops or Loops(hist.logl.device)
    device = hist.logl.device
    k = _consts(hist, denom, cv_target, METRIC_ATOL_CV)
    k["u"] = hist.u
    goal = k["target"]
    take_high = goal >= _cv(k, beta_high, group)
    stay = goal <= _cv(k, beta_prev, group)
    PROBES.add("cv", 2, device)
    edge = take_high | stay
    if not _loop_form(loops) and loops.read("cv_bisect", edge)[0]:  # counted as the loop's
        return torch.where(take_high, beta_high, beta_prev)
    out, _ = _loop(loops, "cv_bisect", _metric_body(_cv, group, dynamic=True),
                   _metric_carry(beta_prev, beta_high, edge), k, group)
    PROBES.add("cv", out["i"], device)
    return torch.where(take_high, beta_high, torch.where(stay, beta_prev, out["beta"]))


def _sharded_ess_beta(hist: History, denom, beta_prev, ess_target: float, group,
                      loops: Optional[Loops] = None) -> torch.Tensor:
    """The next beta in ESS mode under a mesh: XLA's bisection of
    tempest_tpu/steps/reweight.py:195-224 and :122-166. Stay when
    ESS(beta_prev) <= target, jump to 1 when ESS(1) >= target, else bisect
    [beta_prev, 1] on the ESS with the dual tolerance max(ESS_TOLERANCE
    target, METRIC_ATOL). Each probe reduces its ESS over the ranks (two
    collectives)."""
    loops = loops or Loops(hist.logl.device)
    k = _consts(hist, denom, ess_target, METRIC_ATOL)
    one = torch.ones_like(beta_prev)
    stay = _ess_unnormalized(k, beta_prev, group) <= k["target"]
    jump = _ess_unnormalized(k, one, group) >= k["target"]
    out, _ = _loop(loops, "ess_sharded", _metric_body(_ess_unnormalized, group, dynamic=False),
                   _metric_carry(beta_prev, one, stay | jump), k, group)
    PROBES.add("ess_sharded", 2 + out["i"], hist.logl.device)
    return torch.where(stay, beta_prev, torch.where(jump, one, out["beta"]))


def _dynamic_beta(hist: History, denom, beta_prev, ess_target: float, cv_target: float,
                  group=None, loops: Optional[Loops] = None) -> torch.Tensor:
    """The next beta in dynamic mode (reweight.py:225-241): without an ESS
    crossing beta_low; else the CV rules inside the bracket, a
    `loops.when` on `crossing`: inside a stretch an IF node (the CV's
    eigenvalue launches and probes only where the bracket crosses, as an
    eager run makes them), elsewhere decided on the host."""
    loops = loops or Loops(hist.logl.device)
    PROBES.add("reweights", 1, hist.logl.device)
    beta_low, beta_high, crossing = _find_ess_bracket(hist, denom, beta_prev, ess_target, group,
                                                      loops)

    def cv_step(s: Tensors) -> Tensors:
        return {"beta": _find_cv_beta(hist, denom, beta_prev, beta_high, cv_target, group,
                                      loops)}

    return loops.when(crossing, cv_step, {"beta": beta_low}, "cv_step")["beta"]


def reweight(
    hist: History,
    beta_prev: torch.Tensor,
    ess_target: float,
    cv_target: float = 0.0,
    dynamic: bool = False,
    group=None,
    loops: Optional[Loops] = None,
) -> ReweightResult:
    """Select the next beta and compute the MIS weights.

    The beta-independent denominator is computed once (O(S)); in ESS mode
    invalid slots enter the kernel with Bm = +inf, so they weigh nothing.
    `hist.t` must be at least 1. With `group` (a particle mesh) `hist` is
    this rank's block and the weights come back as its block. `loops` runs
    the bisection loops (default: a read after every probe).
    """
    dtype, device = hist.logl.dtype, hist.logl.device
    denom = mis_denominator(hist)
    beta_prev = torch.as_tensor(beta_prev, dtype=dtype, device=device).reshape(())
    if dynamic:
        beta = _dynamic_beta(hist, denom, beta_prev, ess_target, cv_target, group, loops)
    elif group is not None:
        beta = _sharded_ess_beta(hist, denom, beta_prev, ess_target, group, loops)
    else:
        bm = torch.where(hist.sample_mask(), denom, torch.full_like(denom, float("inf")))
        scal = torch.stack([beta_prev, torch.full((), ess_target, dtype=dtype, device=device)])
        beta, _ = ess_bisect_beta(hist.logl.reshape(-1), bm.reshape(-1), scal)
        beta = beta[0]

    logw, logz = logw_from_denominator(hist, denom, beta, group=group)
    weights = torch.exp(logw)  # normalized; masked entries are exp(-inf) = 0
    ess = ess_from_logw_psum(logw, group)
    cv = volume_variation_dtn(hist.u, weights, mask=hist.sample_mask(), group=group)
    return ReweightResult(beta=beta, weights=weights, ess=ess, cv=cv, logz=logz)
