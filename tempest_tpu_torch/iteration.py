"""One Persistent Sampling iteration.

Counterpart of tempest_tpu/fused.py `_make_iteration_fn` (:38-250):

1. reweight: the next beta by ESS bisection, or in dynamic mode by the CV
   bisection inside an ESS bracket, and the MIS weights (skipped at t ==
   0, where the first-iteration values of :227-236 are set instead of
   running the reweight on an empty history);
2. at beta == 0, the warm-up branch (:195-207): fresh prior draws;
3. otherwise trim the weights and keep the top-`train_max_points` samples
   by weight (:113-129); with clustering, fit the hierarchical Gaussian
   mixture on them when the cadence asks for it (every iteration with
   `cluster_every == 1`; else when `iteration % cluster_every == 0` or the
   carried model is still the unfitted placeholder, :149-160), label them
   with the model, then fit one Student-t mode per cluster (:162-164),
   else one global mode (:165-167); resample, labelling the walkers with
   the model, and run the adaptive MCMC;
4. commit the active set, blob rows included, to the history.

Every draw comes from the draws object passed in. The iteration's loops
(the bisections of the reweight under a mesh or in dynamic mode, the mode
EM, the GMM EM, the split rounds, the MCMC steps) run through `loops`
(`loops.Loops`): by default each reads its exit after every body;
`fused.py` hands in chunked, optionally graphed loops. With graphs on, a
cluster fit and the fit points' labels are one replay of the "hgm_fit"
stretch, its split rounds conditional nodes that read nothing
(`cluster.hgm_fit`).

The iteration's two decisions, the branch of step 2 (JAX's `lax.cond` at
:242-245) and the cluster cadence of step 3 (:149-160), are `loops.when`s.
Called by the host (`iteration(draws, hist, cur, model)`), it reads beta
once, which decides the branch (`iteration.beta` keeps it) and, with the
Python `iteration` and `model.fitted`, the cadence; it reads nothing else
between the loops. Run as the body of the device run loop
(`fused.make_fused_run`, inside a stretch: `loops.inside`), both are
decided on the device, on `cur.beta == 0`, the device word of the
iteration counter and the device flag `model.fitted`: CUDA-graph IF nodes
that read nothing, around the warm-up's prior draw, the mutation (its
cluster fit, itself an IF node on the cadence, and its MCMC chain, a
WHILE node) and the rest; the reweight then decides on the device too
(dynamic mode's CV step an IF node, the bisections WHILE nodes,
`steps/reweight.py`). Both give the same bits. The commit writes slot
`t` through the device word `hist.t` (`state.commit`). Each stage runs
inside a `utils.profiling.annotate` range ("ps/reweight", "ps/cluster",
"ps/fit", "ps/resample", "ps/mutate", "ps/warmup", "ps/commit"), which
`torch.profiler` reports as the stage's time when the host runs it; in the
device run loop the ranges mark its capture, not its replays. The JAX
package's `_pin_history_layouts` and donation have no counterpart here.

Under a particle mesh (`config.mesh`) the history, the active set and the
weights are this rank's blocks (parallel/mesh.py) and the draws a
`draws.BlockDraws`. The stages then reduce over the ranks: the reweight,
the fit points (`sharded_select_fit_points`, fused.py:102-112, replicated
on every rank), the resampling (fused.py:168-177), the warm-up patch and
the MCMC sums. The cluster and mode fits run on the replicated fit points
on every rank, and rank 0's results are broadcast, so every rank carries
the same model whatever the rounding of its fits.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .cluster import MODEL_TENSORS, ClusterModel, cluster_predict, fit_uniforms, hgm_fit
from .config import DOF_FALLBACK, TRIM_BINS, TRIM_ESS, SamplerConfig
from .loops import Loops
from .mcmc import MCMCKernel
from .modes import fit_global_mode, fit_mode_statistics
from .ops.boundary import make_boundary_masks
from .ops.tools import trim_weights_mask
from .parallel.collective import broadcast_from_first, sharded_select_fit_points
from .parallel.mesh import particle_group
from .state import Current, History, commit
from .steps.mutate import warmup
from .steps.resample import resample
from .steps.reweight import reweight
from .utils.profiling import annotate


def select_fit_points(
    hist: History, weights: torch.Tensor, train_max_points: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(u_fit (m, d), w_fit (m,), keep_fit (m,)): the trimmed weights and,
    once the history holds more than `train_max_points` samples, only the
    heaviest of them (fused.py:114-130). `keep_fit` marks the rows the
    clustering may use."""
    keep, w_trim = trim_weights_mask(
        weights.reshape(-1),
        mask=hist.sample_mask().reshape(-1),
        ess=TRIM_ESS,
        bins=TRIM_BINS,
    )
    u_all = hist.u.reshape(hist.n_dim, -1)
    if train_max_points and train_max_points < w_trim.shape[0]:
        w_fit, idx = torch.topk(w_trim, train_max_points)
        return u_all[:, idx].T, w_fit, w_fit > 0.0
    return u_all.T, w_trim, keep


def make_iteration(
    config: SamplerConfig, log_likelihood_batch: Callable, prior_transform_batch: Callable,
    loops: Optional[Loops] = None,
) -> Callable:
    """Build `iteration(draws, hist, cur, model) -> (hist, cur, model)`;
    `model` is the ClusterModel carried from the last fit (the one-cluster
    placeholder, `fitted=False`, before it). `log_likelihood_batch` returns
    (logl, blobs or None); one that has a `bind` (the host crossing,
    `utils.wrappers.HostLikelihood`) is bound to the loops here. The caller
    grows the history so that capacity > hist.t. `iteration.loops` runs the
    loops; after a call, `iteration.beta` is the iteration's beta on the
    host."""
    cfg = config
    loops = loops or Loops(cfg.device)
    bind = getattr(log_likelihood_batch, "bind", None)
    if bind is not None:  # its reads, stretches and halt word
        bind(loops)
    N, d = cfg.n_particles, cfg.n_dim
    group = None if cfg.mesh is None else particle_group(cfg.mesh, cfg.particle_axis)
    p_mask, r_mask, s_mask = make_boundary_masks(d, cfg.periodic, cfg.reflective, device=cfg.device)
    mcmc = MCMCKernel(
        log_likelihood_batch,
        prior_transform_batch,
        d,
        method=cfg.sample,
        n_steps=cfg.n_steps,
        n_max_steps=cfg.n_max_steps,
        periodic_mask=p_mask,
        reflective_mask=r_mask,
        strict_mask=s_mask,
        n_candidates=cfg.n_candidates,
        dtype=cfg.dtype,
        group=group,
    )
    ess_target = cfg.ess_ratio * N
    dynamic = cfg.volume_variation is not None
    cv_target = cfg.volume_variation or 0.0
    # The clusterer's settings (fused.py:79-83): 2 d points per child (4 d
    # when n_max_clusters caps K), at most k_max - 1 split rounds, and the
    # k-means++ uniforms of the fixed fit key.
    min_points = 2 * d if cfg.n_max_clusters is None else 4 * d
    round_cap = 1000 if cfg.n_max_clusters is None else cfg.n_max_clusters - 1
    max_rounds = max(min(round_cap, cfg.k_max - 1), 0)
    uniforms = fit_uniforms(cfg.k_max, device=cfg.device, dtype=cfg.dtype) if cfg.clustering else None

    def fit_clusters(k):
        """The cluster fit on the fit points and their labels by the new
        model: on the graphed route one replay of the "hgm_fit" stretch."""
        model, _, _ = hgm_fit(
            k["u_fit"], k["w_fit"], k["keep_fit"],
            min_points=min_points,
            threshold_modifier=cfg.split_threshold,
            k_max=cfg.k_max,
            max_rounds=max_rounds,
            normalize=cfg.normalize,
            split_all=cfg.split_all,
            leaf_fit_points=cfg.leaf_fit_points or None,
            uniforms=uniforms,
            loops=loops,
        )
        model = replicated(model)
        return dict({f: getattr(model, f) for f in MODEL_TENSORS},
                    labels=cluster_predict(model, k["u_fit"]))

    def fit_points(hist: History, weights):
        if group is None:
            return select_fit_points(hist, weights, cfg.train_max_points)
        S = hist.capacity * N
        return sharded_select_fit_points(
            hist.u, weights, hist.t, min(cfg.train_max_points or S, S), group)

    def replicated(fitted):
        return fitted if group is None else broadcast_from_first(fitted, group)

    def refit(cur: Current, model: ClusterModel):
        """Whether to fit the clusters this iteration (fused.py:149-160):
        True with `cluster_every == 1`; else the cadence or an unfitted
        model, a Python bool from host values or a 0-d device bool."""
        if cfg.cluster_every == 1:
            return True
        if isinstance(model.fitted, bool) and isinstance(cur.iteration, int):
            return not model.fitted or cur.iteration % cfg.cluster_every == 0
        return ~torch.as_tensor(model.fitted, device=cfg.device) | (
            cur.iteration % cfg.cluster_every == 0)

    def cluster(cur: Current, model: ClusterModel, u_fit, w_fit, keep_fit):
        """(model, labels of the fit points): the new fit where `refit`
        holds, else the carried model and its labels."""
        points = dict(u_fit=u_fit, w_fit=w_fit, keep_fit=keep_fit)

        def fit(_):
            return loops.once("hgm_fit", fit_clusters, points) if loops.graphed \
                else fit_clusters(points)

        go = refit(cur, model)
        if go is True:
            out = fit(None)
        else:
            out = dict({f: getattr(model, f) for f in MODEL_TENSORS},
                       labels=cluster_predict(model, u_fit))
            out = loops.when(go, fit, out, "hgm_fit")
        labels = out.pop("labels")
        return ClusterModel(**out, normalize=cfg.normalize, fitted=model.fitted), labels

    def mutate_branch(draws, hist: History, cur: Current, weights, s):
        """The mutation (fused.py:86-190) on the branch state `s`."""
        model = ClusterModel(**{f: s[f] for f in MODEL_TENSORS}, normalize=cfg.normalize,
                             fitted=s["fitted"])
        with annotate("ps/fit"):
            u_fit, w_fit, keep_fit = fit_points(hist, weights)
        if cfg.clustering:
            with annotate("ps/cluster"):
                model, labels = cluster(cur, model, u_fit, w_fit, keep_fit)
            with annotate("ps/fit"):
                modes = replicated(fit_mode_statistics(
                    u_fit, w_fit, labels, k_max=cfg.k_max, dof_fallback=DOF_FALLBACK,
                    loops=loops,
                ))
        else:
            with annotate("ps/fit"):
                modes = replicated(fit_global_mode(u_fit, w_fit, dof_fallback=DOF_FALLBACK,
                                                   loops=loops))
        with annotate("ps/resample"):
            u, x, logl, blobs, assignments = resample(
                draws.resample(N, cfg.resample), hist, weights, N, method=cfg.resample,
                cluster_model=model if cfg.clustering else None, group=group,
            )
        with annotate("ps/mutate"):
            res = mcmc(draws, u, x, logl, assignments, cur.beta, modes, blobs=blobs, loops=loops)
        out = dict(s, u=res.u, x=res.x, logl=res.logl, assignments=assignments,
                   efficiency=res.efficiency.to(cfg.dtype),
                   acceptance=res.acceptance.to(cfg.dtype), steps=res.steps,
                   calls=s["calls"] + res.n_call_sweeps,
                   fitted=_true_like(s["fitted"]),
                   **{f: getattr(model, f) for f in MODEL_TENSORS})
        if blobs is not None:
            out["blobs"] = res.blobs
        return out

    def warmup_branch(draws, s):
        """The warm-up (fused.py:192-207) on the branch state `s`."""
        u_draw, patch_uniforms = draws.warmup(N, d)
        wr = warmup(u_draw, patch_uniforms, log_likelihood_batch, prior_transform_batch, group)
        out = dict(s, u=wr.u, x=wr.x, logl=wr.logl,
                   assignments=torch.zeros((wr.u.shape[0],), dtype=torch.int32,
                                           device=cfg.device),
                   logz=s["logz"] + wr.logz_correction,
                   calls=s["calls"] + 1,  # one full-batch sweep
                   steps=_like(s["steps"], 1), acceptance=torch.ones_like(s["acceptance"]),
                   efficiency=torch.ones_like(s["efficiency"]))
        if wr.blobs is not None:
            out["blobs"] = wr.blobs
        return out

    def iteration(
        draws, hist: History, cur: Current, model: ClusterModel
    ) -> Tuple[History, Current, ClusterModel]:
        device = loops.inside  # the body of the device run loop: decide there
        if hist.t_host == 0:
            # Nothing committed yet: the first-iteration values.
            zero = torch.zeros((), dtype=cfg.dtype, device=cfg.device)
            cur.beta, cur.cv = zero, zero.clone()
            cur.ess = torch.full((), ess_target, dtype=cfg.dtype, device=cfg.device)
            weights = None
            warm = True
            iteration.beta = 0.0
        else:
            with annotate("ps/reweight"):
                rw = reweight(hist, cur.beta, ess_target, cv_target=cv_target,
                              dynamic=dynamic, group=group, loops=loops)
                cur.beta = rw.beta.to(cfg.dtype)
                if device:
                    warm = cur.beta == 0.0
                else:
                    iteration.beta = loops.read("beta", cur.beta)[0]
                    warm = iteration.beta == 0.0
            cur.logz = rw.logz.to(cfg.dtype)
            cur.ess = rw.ess.to(cfg.dtype)
            cur.cv = rw.cv.to(cfg.dtype)
            weights = rw.weights
        cur.iteration += 1

        # beta == 0: the target is still the prior — fresh draws instead of
        # fit/resample/MCMC; the carried model stays as it is.
        s = dict({f: getattr(model, f) for f in MODEL_TENSORS}, fitted=model.fitted,
                 u=cur.u, x=cur.x, logl=cur.logl, assignments=cur.assignments, logz=cur.logz,
                 calls=cur.calls, steps=cur.steps, acceptance=cur.acceptance,
                 efficiency=cur.efficiency)
        if cur.blobs is not None:
            s["blobs"] = cur.blobs
        with annotate("ps/warmup"):
            s = loops.when(warm, lambda s: warmup_branch(draws, s), s, "warmup")
        s = loops.when(_not(warm), lambda s: mutate_branch(draws, hist, cur, weights, s), s,
                       "mutate")
        cur.u, cur.x, cur.logl, cur.blobs = s["u"], s["x"], s["logl"], s.get("blobs")
        cur.assignments, cur.logz, cur.calls, cur.steps = (
            s["assignments"], s["logz"], s["calls"], s["steps"])
        cur.acceptance, cur.efficiency = s["acceptance"], s["efficiency"]
        if s["fitted"] is not model.fitted or any(s[f] is not getattr(model, f)
                                                  for f in MODEL_TENSORS):
            model = ClusterModel(**{f: s[f] for f in MODEL_TENSORS}, normalize=cfg.normalize,
                                 fitted=s["fitted"])
        with annotate("ps/commit"):
            return commit(hist, cur), cur, model

    iteration.loops, iteration.beta = loops, None
    return iteration


def _not(pred):
    """The negation of a Python bool or a 0-d device bool."""
    return not pred if isinstance(pred, bool) else ~pred


def _true_like(flag):
    """True, as a Python bool or as a 0-d device bool like `flag`."""
    return True if isinstance(flag, bool) else torch.ones_like(flag)


def _like(value, number: int):
    """`number` as `value` holds numbers: a Python int or a tensor like it."""
    return torch.full_like(value, number) if isinstance(value, torch.Tensor) else number
