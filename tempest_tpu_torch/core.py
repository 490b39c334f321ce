"""SamplerCore — the Persistent Sampling annealing loop.

Counterpart of tempest_tpu/core.py: construction (the blob schema, the
model wrappers) and `reset`, capacity pre-growth and doubling (:239-272),
`run_sampling` (:274-324) with the termination rule of `_not_termination`
(:466-477), `save_every` checkpoints and `resume_state_path`, the final
logZ at beta = 1, and the posterior (with blobs), evidence (with the
block-bootstrap error), results and state-file extraction. The fitted
cluster model is carried from iteration to iteration in `cluster_model`
(in JAX, `_fused_model` and `_fused_fitted`), and saved with the state.

Every configuration (one device or a mesh, ESS or dynamic mode, a torch
or a host likelihood) runs the fused iteration (`fused.py`) for `run()`
and `sample()` alike, as JAX runs its fused iteration for both: its loops
in chunks, one host read a chunk, and a host likelihood's crossing once a
sweep (on the CPU one counted read, on the card the host-call kernel).
`iteration.make_iteration` alone (a read after every body) is the tests'
reference. `run(on_device=True)` without
`save_every` (which keeps the host loop, core.py:309, and under a mesh its
sharded checkpoints) runs the annealing loop itself on the device, as
`_run_on_device` does (core.py:334-464), for every configuration (float32
or float64, one device or a mesh, ESS or dynamic mode, a host likelihood
too: its host-call kernel inside the graph's bodies, served by the thread
that replays it, `utils.wrappers.HostLikelihood`):
the first iteration on the per-iteration route, then the loop of
`fused.make_fused_run`, whose predicate is the termination test, until
it ends or the history fills; the host reads `t` once a dispatch, and
where the history filled it checks the termination, doubles the capacity
and enters again. On a CUDA device the loop's CUDA graphs are on
(`loops.Loops.graphs`), so a dispatch is one graph replay; a host
likelihood that raises ends the loop after its step, and the replay
re-raises its exception (`reset()` then starts clean). Every other route
(`on_device=False`, `save_every`) anneals in the host loop of
`run_sampling`, whose termination test takes the beta the
iteration read (`iteration.beta`) and reads the posterior ESS once beta is
finished, the run loop's predicate (`fused.beta_unfinished`,
`fused.ess_below`) evaluated by the host. All routes give the same
results. The first draws object is kept for the sampler's life and
reseeded in place, as the graphs hold its call counter's words. The
dispatch-budget chunking of the TPU whole-run program is not ported
(ROADMAP.md queue 1, item 12).

With a particle mesh (`config.mesh`, parallel/) each rank holds its block
of the particle axis (core.py:158-165, :222-272): N must divide by the
ranks; the history and the active set are made and grown on the block; the
draws are a `draws.BlockDraws`. The posterior, the results and the current
dict gather the blocks (`utils.host.fetch`), so every rank returns the
values of the whole run in the order of a run on one device. A run of more
than one rank saves sharded checkpoints (a directory, as JAX's multi-process
runs do); a sharded file loads only into a sampler with a mesh, a
single file into either, each rank taking its block.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from .cluster import ClusterModel, single_cluster_model
from .config import SamplerConfig
from .draws import BlockDraws, Draws, HardwareDraws, seed_from_key_words
from .fused import beta_unfinished, ess_below, make_fused_iteration, make_fused_run
from .ops.tools import ess_from_logw_psum, systematic_resample, trim_weights_mask
from .parallel.mesh import particle_group, shard_current, shard_history
from .state import (
    Current,
    History,
    bootstrap_logz_err,
    compute_logw_and_logz,
    grow_history,
    make_current,
    make_history,
)
from .utils.checkpoint import (
    load_checkpoint,
    load_checkpoint_sharded,
    save_checkpoint,
    save_checkpoint_sharded,
)
from .utils.host import fetch
from .utils.progress import ProgressBar
from .utils.wrappers import (
    FunctionWrapper,
    make_pool_map,
    build_blob_schema,
    build_log_likelihood,
    build_prior_transform,
)


class SamplerCore:
    """Internal coordinator; the public Sampler facade delegates here."""

    def __init__(self, config: SamplerConfig):
        self.config = cfg = config
        self.n_dim = cfg.n_dim
        self.n_particles = cfg.n_particles
        self.dtype = cfg.dtype
        self.device = cfg.device
        self.group = None
        self.world, self.rank = 1, 0
        if cfg.mesh is not None:
            self.group = particle_group(cfg.mesh, cfg.particle_axis)
            self.world = dist.get_world_size(self.group)
            self.rank = dist.get_rank(self.group)
            if cfg.n_particles % self.world != 0:
                raise ValueError(
                    f"n_particles ({cfg.n_particles}) must be divisible by the "
                    f"mesh size ({self.world}) to shard the particle axis."
                )
        self.n_local = cfg.n_particles // self.world

        wrapped = FunctionWrapper(
            cfg.log_likelihood, cfg.log_likelihood_args, cfg.log_likelihood_kwargs
        )
        self.blob_schema = build_blob_schema(
            wrapped,
            cfg.n_dim,
            cfg.blobs_dtype is not None,
            cfg.host_likelihood,
            cfg.blobs_dtype,
            declared_size=cfg.blob_size,
            prior_transform=cfg.prior_transform,
            vectorize=cfg.vectorize,
        )
        self.blob_size = None if self.blob_schema is None else self.blob_schema.width
        if self.world > 1 and self.blob_schema is not None and self.blob_schema.is_object:
            raise ValueError("object blobs are stored per process; a mesh of more than one "
                             "rank runs numeric blobs only")
        self._blobs_dtype = None if self.blob_schema is None else self.blob_schema.device_dtype
        # The host map of host_likelihood=True (a spawned pool for pool=<int>).
        self.pool_map = make_pool_map(cfg.pool) if cfg.host_likelihood else None
        self._prior_batch = build_prior_transform(cfg.prior_transform, cfg.vectorize)
        self._loglike_batch = build_log_likelihood(
            wrapped,
            cfg.vectorize,
            self.blob_schema is not None,
            cfg.host_likelihood,
            dtype=cfg.dtype,
            schema=self.blob_schema,
            pool_map=self.pool_map,
        )
        self._iteration = make_fused_iteration(cfg, self._loglike_batch, self._prior_batch)
        self._run = make_fused_run(cfg, self._iteration)
        self.draws = None
        self.pbar: Optional[ProgressBar] = None
        self.reset()

    # ------------------------------------------------------------------
    def reset(self, random_state: Optional[int] = None) -> None:
        """Clear the sampler state for a fresh run with seed `random_state`
        (default: the config's, else 0)."""
        cfg = self.config
        seed = random_state if random_state is not None else (cfg.random_state or 0)
        self.draws = self._make_draws(seed)
        self.cluster_model: ClusterModel = self._placeholder_model()
        self.hist: History = make_history(
            cfg.history_capacity, self.n_local, cfg.n_dim, dtype=cfg.dtype,
            device=self.device, blob_size=self.blob_size, blobs_dtype=self._blobs_dtype,
        )
        self.cur: Current = make_current(
            self.n_local, cfg.n_dim, dtype=cfg.dtype, device=self.device,
            blob_size=self.blob_size, blobs_dtype=self._blobs_dtype,
        )
        self.n_total: Optional[int] = None
        self.logz_err = None
        self.t0 = 0

    def _make_draws(self, seed: int):
        """The draws of seed `seed`: made once, then reseeded in place, as
        the loops' graphs hold their call counter."""
        if self.draws is not None:
            self.draws.reseed(seed)
            return self.draws
        # hardware_prng applies to float32 only, as JAX's hw_prng_supported
        # (pallas_prng.py:46-48): float64 draws what it draws without the flag
        hardware = self.config.hardware_prng and self.dtype == torch.float32
        draws = (HardwareDraws if hardware else Draws)(seed, self.device, self.dtype)
        loops = self._iteration.loops
        loops.counters = [draws.calls] if draws.calls is not None else []
        return draws if self.group is None else BlockDraws(draws, self.rank, self.world)

    def _placeholder_model(self) -> ClusterModel:
        cfg = self.config
        return single_cluster_model(
            cfg.n_dim, cfg.k_max if cfg.clustering else 1, cfg.dtype, cfg.normalize, self.device
        )

    def close(self) -> None:
        """End the worker processes of `pool=<int>`, if any were started."""
        close = getattr(self.pool_map, "close", None)
        if close is not None:
            close()

    def _pregrow_capacity(self) -> None:
        """Size the history for a typical run when the user left the
        capacity at its default: ceil(n_total / N) + 40 slots, rounded up
        to a multiple of 16."""
        if not self.config.auto_capacity or self.n_total is None:
            return
        need = -(-int(self.n_total) // self.n_particles) + 40
        need = -(-need // 16) * 16
        if self.hist.capacity < need:
            self.hist = grow_history(self.hist, need)

    def _ensure_capacity(self) -> None:
        if self.hist.count() >= self.hist.capacity:
            self.hist = grow_history(self.hist, self.hist.capacity * 2)

    # ------------------------------------------------------------------
    def run_sampling(
        self,
        n_total: int = 4096,
        progress: bool = True,
        resume_state_path: Union[str, Path, None] = None,
        save_every: Optional[int] = None,
        on_device: bool = False,
    ) -> None:
        """Anneal until beta reaches 1 and the posterior ESS reaches n_total
        (core.py:274-324). With `resume_state_path`, continue from that
        file; with `save_every`, write `<output_label>_<iteration>.state`
        every `save_every` iterations and `<output_label>_final.state` at
        the end, into `output_dir`."""
        t0 = 0
        if resume_state_path is not None:
            self.load_sampler_state(resume_state_path)
            t0 = self.cur.iteration
        self.n_total = int(n_total)
        self.t0 = t0
        self._pregrow_capacity()
        self.pbar = ProgressBar(progress, initial=t0)
        if self.pbar.enabled:
            self.pbar.update_stats(dict(
                beta=float(self.cur.beta), calls=self.calls_total(),
                ESS=int(self.config.ess_ratio * self.n_particles), logZ=float(self.cur.logz),
                logL=0.0, acc=0.0, steps=0, eff=0.0, K=1,
            ))
        loops = self._iteration.loops
        loops.graphs = on_device and save_every is None
        try:
            if on_device and save_every is None:
                self._run_on_device(t0)
            else:
                beta = None  # read once, where a resumed run starts
                while self._not_termination(beta):
                    self._step(save_every, t0)
                    beta = self._iteration.beta
        finally:
            loops.graphs = False

        # Final evidence at beta = 1 over the whole history.
        _, logz = compute_logw_and_logz(self.hist, 1.0, group=self.group)
        self.cur.logz = logz.to(self.dtype)
        self.logz_err = None
        cfg = self.config
        if save_every is not None:
            self.save_sampler_state(cfg.output_dir / f"{cfg.output_label}_final.state")
        self.pbar.close()
        self.pbar = None

    def posterior_ess(self) -> float:
        """ESS of the MIS weights of the whole history at beta = 1."""
        logw, _ = compute_logw_and_logz(self.hist, 1.0, group=self.group)
        return float(ess_from_logw_psum(logw, self.group))

    def _fetch(self, t: torch.Tensor, dim: Optional[int] = None) -> np.ndarray:
        """`t` as numpy; under a mesh gathered along the particle dimension `dim`."""
        return fetch(t, self.group, dim)

    def _run_on_device(self, t0: int) -> None:
        """The annealing loop on the device (core.py:334-464): the first
        iteration on the per-iteration route, then dispatches of the run
        loop, one read of `t` (with the iteration counter and the model's
        `fitted` flag) after each; where the history filled before the
        termination test failed, the test on the host, the capacity doubled
        and the loop entered again. The progress bar moves once a dispatch.
        Under a mesh every rank dispatches its own loop, whose collectives
        meet the other ranks', and reads the same `t` (the history's slots
        are shared, its particle axis sharded), so the ranks stop, test and
        grow their blocks together."""
        if self.hist.count() == 0:
            self._step(None, t0)
        loops = self._iteration.loops
        while True:
            self._ensure_capacity()
            hist, cur, model = self._run(self.draws, self.hist, self.cur, self.cluster_model,
                                         self.n_total)
            t, iteration, fitted = loops.read("run", hist.t, cur.iteration, model.fitted)
            hist.t_host, cur.iteration, model.fitted = int(t), int(iteration), bool(fitted)
            self.hist, self.cur, self.cluster_model = hist, cur, model
            if self.pbar is not None:
                self.pbar.update_iter(cur.iteration - self.pbar.count)
            self._update_progress_bar()
            if hist.t_host < hist.capacity or not self._not_termination():
                break
        self._prune_blob_store()

    def _not_termination(self, beta: Optional[float] = None) -> bool:
        """Continue while 1 - beta >= 1e-4 or the posterior ESS < n_total,
        the run loop's predicate (`fused.beta_unfinished`,
        `fused.ess_below`) on the host; `beta` is the current beta where the
        host has it already. Under a mesh both read values that are the same
        on every rank."""
        if self.hist.count() == 0:
            return True
        beta = self.cur.beta.cpu() if beta is None else torch.tensor(beta, dtype=self.dtype)
        if bool(beta_unfinished(beta)):
            return True
        below = ess_below(self.hist, self.n_total or 0, self.group)
        return bool(self._iteration.loops.read("termination", below)[0])

    def execute_iteration(self, save_every: Optional[int] = None, t0: int = 0) -> dict:
        """One reweight -> fit -> resample -> mutate -> commit iteration
        (core.py:480-604); the state after it, as `get_current_dict`."""
        self._step(save_every, t0)
        return self.get_current_dict()

    def _step(self, save_every: Optional[int], t0: int) -> None:
        """One iteration, after the checkpoint `save_every` asks for."""
        cfg = self.config
        it = self.cur.iteration
        if save_every is not None and (it - t0) % int(save_every) == 0 and it != t0:
            self.save_sampler_state(cfg.output_dir / f"{cfg.output_label}_{it}.state")
        self._ensure_capacity()
        if self.pbar is not None:
            self.pbar.update_iter()
        self.hist, self.cur, self.cluster_model = self._iteration(
            self.draws, self.hist, self.cur, self.cluster_model
        )
        self._update_progress_bar()
        self._prune_blob_store()

    def _prune_blob_store(self) -> None:
        """Drop the object-blob payloads whose ids are no longer in the
        history or the active set (rejected MCMC proposals; core.py:606-617)."""
        sch = self.blob_schema
        if sch is None or not sch.is_object:
            return
        live = np.concatenate([fetch(self.hist.blobs).reshape(-1),
                               fetch(self.cur.blobs).reshape(-1)])
        sch.prune_store(live)

    # ------------------------------------------------------------------
    def compute_posterior(
        self,
        resample: bool = False,
        return_blobs: bool = False,
        trim_importance_weights: bool = True,
        return_logw: bool = False,
        ess_trim: float = 0.99,
        bins_trim: int = 1000,
    ):
        """(x, weights, logl[, blobs][, logw]) as numpy arrays
        (core.py:636-702); blobs only when the run has them."""
        logw, _ = compute_logw_and_logz(self.hist, 1.0, group=self.group)
        valid = self._fetch(self.hist.sample_mask(), 1).reshape(-1)
        logw_np = self._fetch(logw, 1).reshape(-1)

        def snd(arr):  # (B, T, N) -> (S, B), t-major sample order
            a = np.moveaxis(self._fetch(arr, 2), 0, -1)
            return a.reshape(-1, a.shape[-1])

        x = snd(self.hist.x)
        logl = self._fetch(self.hist.logl, 1).reshape(-1)
        blobs = None if self.hist.blobs is None else snd(self.hist.blobs)

        weights = np.exp(logw_np - np.max(logw_np[valid]))
        weights[~valid] = 0.0
        weights /= weights.sum()

        if trim_importance_weights:
            keep, w_trim = trim_weights_mask(
                torch.from_numpy(weights), mask=torch.from_numpy(valid),
                ess=ess_trim, bins=bins_trim,
            )
            sel = keep.numpy()
            weights = w_trim.numpy()[sel]
        else:
            sel = valid
            weights = weights[sel]
        x, logl, logw_np = x[sel], logl[sel], logw_np[sel]
        if blobs is not None:
            blobs = blobs[sel]

        if resample:
            u0 = self.draws.resample(1, "syst").cpu()
            idx = systematic_resample(u0, len(weights), torch.from_numpy(weights)).numpy()
            x, logl, logw_np = x[idx], logl[idx], logw_np[idx]
            if blobs is not None:
                blobs = blobs[idx]
            weights = np.ones(len(idx)) / len(idx)

        out = [x, weights, logl]
        if return_blobs and blobs is not None:
            out.append(self.blob_schema.unpack(blobs))
        if return_logw:
            out.append(logw_np)
        return tuple(out)

    def compute_evidence(self, n_bootstrap: int = 0):
        """(logz, logz_err) (core.py:704-717): logz_err is None, as in the
        reference, unless n_bootstrap > 0 asks for the block-bootstrap
        error, whose uniforms come from the run's draws."""
        if n_bootstrap > 0 and self.hist.count() > 0:
            uniforms = self.draws.bootstrap(int(n_bootstrap), self.hist.capacity)
            return float(self.cur.logz), float(
                bootstrap_logz_err(self.hist, uniforms, group=self.group))
        return float(self.cur.logz), self.logz_err

    def compute_results(self) -> dict:
        """The full per-iteration history (core.py:719-746)."""
        h = self.hist
        t = h.count()
        logw, _ = compute_logw_and_logz(h, 1.0, group=self.group)
        out = {
            "u": np.moveaxis(self._fetch(h.u[:, :t], 2), 0, -1),
            "x": np.moveaxis(self._fetch(h.x[:, :t], 2), 0, -1),
            "logl": self._fetch(h.logl[:t], 1),
            "beta": fetch(h.beta[:t]),
            "logz": fetch(h.logz[:t]),
            "ess": fetch(h.ess[:t]),
            "cv": fetch(h.cv[:t]),
            "acceptance": fetch(h.acceptance[:t]),
            "efficiency": fetch(h.efficiency[:t]),
            "steps": fetch(h.steps[:t]),
            "calls": fetch(h.calls[:t]).astype(np.int64) * self.n_particles,
            "iter": np.arange(1, t + 1),
        }
        if h.blobs is not None:
            b = np.moveaxis(self._fetch(h.blobs[:, :t], 2), 0, -1)  # (t, N, B)
            un = self.blob_schema.unpack(b.reshape(t * self.n_particles, -1))
            out["blobs"] = un.reshape((t, self.n_particles) + un.shape[1:])
        out["logw"] = self._fetch(logw, 1).reshape(-1)[
            self._fetch(h.sample_mask(), 1).reshape(-1)]
        return out

    # ------------------------------------------------------------------
    def save_sampler_state(self, path: Union[str, Path]) -> None:
        """Write the state, draw state and carried model to `path`
        (core.py:749-769; utils/checkpoint.py): a sharded directory when the
        mesh has more than one rank (every rank calls this), else one file."""
        meta = {"n_total": self.n_total, "random_state": self.config.random_state, "version": 1}
        if self.world > 1:
            save_checkpoint_sharded(Path(path), self.hist, self.cur, self.draws.get_state(),
                                    self.group, meta, model=self.cluster_model,
                                    rng_key=self.draws.key_words())
            return
        sch = self.blob_schema
        store = sch.store if sch is not None and sch.is_object else None
        save_checkpoint(Path(path), self.hist, self.cur, self.draws.get_state(), meta,
                        blob_store=store, model=self.cluster_model,
                        rng_key=self.draws.key_words())

    def load_sampler_state(self, path: Union[str, Path]) -> None:
        """Continue from a file of either package (core.py:771-792): the
        port's own draw state where the file has one, else draws re-seeded
        from the JAX file's key words (draws.seed_from_key_words). Under a
        mesh each rank takes its block, of a sharded directory or a file."""
        path = Path(path)
        if path.is_dir():
            if self.group is None:
                raise ValueError(
                    f"{path} is a per-host sharded checkpoint; construct the "
                    "Sampler with the same (or a compatible) mesh to load it."
                )
            ck = load_checkpoint_sharded(path, self.device, self.dtype, self.group)
        else:
            ck = load_checkpoint(path, self.device, self.dtype)
            if self.group is not None:
                ck.hist = shard_history(ck.hist, self.config.mesh, self.config.particle_axis)
                ck.cur = shard_current(ck.cur, self.config.mesh, self.config.particle_axis)
        self.hist, self.cur = ck.hist, ck.cur
        if ck.draws is not None:
            self.draws.set_state(ck.draws)
        else:
            self.draws = self._make_draws(seed_from_key_words(ck.rng_key))
        self.cluster_model = ck.model if ck.model is not None else self._placeholder_model()
        if ck.blob_store is not None and self.blob_schema is not None:
            self.blob_schema.store = ck.blob_store
        if ck.meta.get("n_total") is not None:
            self.n_total = ck.meta["n_total"]

    # ------------------------------------------------------------------
    def get_current_dict(self) -> dict:
        c = self.cur
        return {
            "u": self._fetch(c.u, 0),
            "x": self._fetch(c.x, 0),
            "logl": self._fetch(c.logl, 0),
            "blobs": None if c.blobs is None else self.blob_schema.unpack(self._fetch(c.blobs, 0)),
            "assignments": self._fetch(c.assignments, 0),
            "beta": float(c.beta),
            "logz": float(c.logz),
            "ess": float(c.ess),
            "cv": float(c.cv),
            "acceptance": float(c.acceptance),
            "efficiency": float(c.efficiency),
            "steps": int(c.steps),
            "calls": self.calls_total(),
            "iter": int(c.iteration),
        }

    def calls_total(self) -> int:
        """Cumulative raw likelihood calls (sweeps times n_particles)."""
        return int(self.cur.calls) * self.n_particles

    def _update_progress_bar(self) -> None:
        if self.pbar is None or not self.pbar.enabled:
            return
        c = self.cur
        self.pbar.update_stats(dict(
            calls=self.calls_total(), beta=float(c.beta), ESS=int(float(c.ess)),
            logZ=float(c.logz), logL=float(torch.mean(c.logl)), acc=float(c.acceptance),
            steps=int(c.steps), eff=float(c.efficiency),
            K=int(self.cluster_model.n_clusters()), CV=float(c.cv),
        ))
