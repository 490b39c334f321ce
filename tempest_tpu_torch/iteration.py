"""One Persistent Sampling iteration.

Counterpart of tempest_tpu/fused.py `_make_iteration_fn` (:38-250), run
eagerly:

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
(`cluster.hgm_fit`). Between the loops the stages run straight through
on the device; the one host read outside them is beta, for the warm-up
branch (`iteration.beta` keeps it). Each
stage runs inside a `utils.profiling.annotate` range ("ps/reweight",
"ps/cluster", "ps/fit", "ps/resample", "ps/mutate", "ps/warmup", "ps/commit"), which
`torch.profiler` reports as the stage's time; without a profiler a range
costs a few microseconds. The JAX package's `_pin_history_layouts` and
donation have no counterpart here.

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
    (logl, blobs or None). The caller grows the history so that capacity >
    hist.t. `iteration.loops` runs the loops; after a call, `iteration.beta`
    is the iteration's beta on the host."""
    cfg = config
    loops = loops or Loops(cfg.device)
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

    def mutate_branch(draws, hist: History, cur: Current, weights, model):
        with annotate("ps/fit"):
            u_fit, w_fit, keep_fit = fit_points(hist, weights)
        if cfg.clustering:
            with annotate("ps/cluster"):
                if not model.fitted or cur.iteration % cfg.cluster_every == 0:
                    points = dict(u_fit=u_fit, w_fit=w_fit, keep_fit=keep_fit)
                    fit = (loops.once("hgm_fit", fit_clusters, points) if loops.graphed
                           else fit_clusters(points))
                    labels = fit.pop("labels")
                    model = ClusterModel(**fit, normalize=cfg.normalize)
                else:
                    labels = cluster_predict(model, u_fit)
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
        cur.u, cur.x, cur.logl, cur.blobs = res.u, res.x, res.logl, res.blobs
        cur.assignments = assignments
        cur.efficiency = res.efficiency.to(cfg.dtype)
        cur.acceptance = res.acceptance.to(cfg.dtype)
        cur.steps = res.steps
        cur.calls += res.n_call_sweeps
        return model

    def warmup_branch(draws, cur: Current) -> None:
        u_draw, patch_uniforms = draws.warmup(N, d)
        wr = warmup(u_draw, patch_uniforms, log_likelihood_batch, prior_transform_batch, group)
        cur.u, cur.x, cur.logl, cur.blobs = wr.u, wr.x, wr.logl, wr.blobs
        cur.assignments = torch.zeros((wr.u.shape[0],), dtype=torch.int32, device=cfg.device)
        cur.logz = cur.logz + wr.logz_correction
        cur.calls += 1  # one full-batch sweep
        cur.steps = 1
        cur.acceptance = torch.ones((), dtype=cfg.dtype, device=cfg.device)
        cur.efficiency = torch.ones((), dtype=cfg.dtype, device=cfg.device)

    def iteration(
        draws, hist: History, cur: Current, model: ClusterModel
    ) -> Tuple[History, Current, ClusterModel]:
        if hist.t == 0:
            # Nothing committed yet: the first-iteration values.
            zero = torch.zeros((), dtype=cfg.dtype, device=cfg.device)
            cur.beta, cur.cv = zero, zero.clone()
            cur.ess = torch.full((), ess_target, dtype=cfg.dtype, device=cfg.device)
            weights = None
            iteration.beta = 0.0
        else:
            with annotate("ps/reweight"):
                rw = reweight(hist, cur.beta, ess_target, cv_target=cv_target,
                              dynamic=dynamic, group=group, loops=loops)
                cur.beta = rw.beta.to(cfg.dtype)
                iteration.beta = loops.read("beta", cur.beta)[0]
            cur.logz = rw.logz.to(cfg.dtype)
            cur.ess = rw.ess.to(cfg.dtype)
            cur.cv = rw.cv.to(cfg.dtype)
            weights = rw.weights
        cur.iteration += 1

        # beta == 0: the target is still the prior — fresh draws instead of
        # fit/resample/MCMC; the carried model stays as it is.
        if iteration.beta == 0.0:
            with annotate("ps/warmup"):
                warmup_branch(draws, cur)
        else:
            model = mutate_branch(draws, hist, cur, weights, model)
        with annotate("ps/commit"):
            return commit(hist, cur), cur, model

    iteration.loops, iteration.beta = loops, None
    return iteration
