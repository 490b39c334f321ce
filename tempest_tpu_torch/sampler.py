"""Public Sampler facade.

Counterpart of tempest_tpu/sampler.py: the same constructor keywords
(:27-69) without the TPU-only knobs (`on_device_dispatch_budget_s`,
`donate_state`, `fused`; ROADMAP.md queue 1, item 12), plus `device`; its
extras are dtype, device, host_likelihood, mesh (a particle mesh from
`parallel.make_particle_mesh`, one rank per device), k_max and
history_capacity. The
model functions are per-point torch functions of one (d,) point by default
(`vectorize=False`, mapped with `torch.func.vmap`; see
`utils/wrappers.py` for what such a function may do), torch functions of
(N, d) batches with `vectorize=True`, or Python functions of one numpy
point with `host_likelihood=True`.

The default `device="cuda"` needs a GPU: without one, construction raises
from PyTorch; nothing moves to the CPU unless `device="cpu"` is asked for.
A pickled sampler keeps its device: unpickled where that device is
missing, it raises.

Under a mesh every rank constructs the same Sampler and calls the same
methods in the same order: most of them hold collectives.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Union

from . import interop
from .config import SamplerConfig
from .core import SamplerCore


class Sampler:
    """Persistent Sampling on one torch device, or on a particle mesh."""

    def __init__(
        self,
        prior_transform: callable,
        log_likelihood: callable,
        n_dim: int,
        n_particles: Optional[int] = None,
        ess_ratio: float = 2.0,
        volume_variation: Optional[float] = None,
        log_likelihood_args: Optional[list] = None,
        log_likelihood_kwargs: Optional[dict] = None,
        vectorize: bool = False,
        blobs_dtype: Optional[str] = None,
        periodic: Optional[list] = None,
        reflective: Optional[list] = None,
        pool: Optional[Union[int, object]] = None,
        clustering: bool = True,
        normalize: bool = True,
        cluster_every: int = 1,
        split_threshold: float = 1.0,
        n_max_clusters: Optional[int] = None,
        sample: str = "tpcn",
        n_steps: Optional[int] = None,
        n_max_steps: Optional[int] = None,
        resample: str = "mult",
        output_dir: Optional[str] = None,
        output_label: Optional[str] = None,
        random_state: Optional[int] = None,
        dtype=None,
        host_likelihood: bool = False,
        mesh=None,
        k_max: Optional[int] = None,
        history_capacity: Optional[int] = None,
        blob_size: Optional[int] = None,
        n_candidates: Optional[int] = None,
        train_max_points: Optional[int] = None,
        split_all: Optional[bool] = None,
        leaf_fit_points: Optional[int] = None,
        hardware_prng: bool = False,
        device="cuda",
    ):
        extra = {}
        if dtype is not None:
            extra["dtype"] = dtype
        if k_max is not None:
            extra["k_max"] = k_max
        if history_capacity is not None:
            extra["history_capacity"] = history_capacity
            extra["auto_capacity"] = False  # user-fixed; run() won't pre-grow
        if blob_size is not None:
            extra["blob_size"] = blob_size
        if n_candidates is not None:
            extra["n_candidates"] = n_candidates
        if train_max_points is not None:
            extra["train_max_points"] = train_max_points
        if split_all is not None:
            extra["split_all"] = split_all
        if leaf_fit_points is not None:
            extra["leaf_fit_points"] = leaf_fit_points

        config = SamplerConfig(
            prior_transform=prior_transform,
            log_likelihood=log_likelihood,
            n_dim=n_dim,
            n_particles=n_particles,
            ess_ratio=ess_ratio,
            volume_variation=volume_variation,
            log_likelihood_args=log_likelihood_args,
            log_likelihood_kwargs=log_likelihood_kwargs,
            vectorize=vectorize,
            blobs_dtype=blobs_dtype,
            periodic=periodic,
            reflective=reflective,
            pool=pool,
            clustering=clustering,
            normalize=normalize,
            cluster_every=cluster_every,
            split_threshold=split_threshold,
            n_max_clusters=n_max_clusters,
            sample=sample,
            n_steps=n_steps,
            n_max_steps=n_max_steps,
            resample=resample,
            output_dir=output_dir,
            output_label=output_label,
            random_state=random_state,
            host_likelihood=host_likelihood,
            mesh=mesh,
            hardware_prng=hardware_prng,
            device=device,
            **extra,
        )
        self._core = SamplerCore(config)

    # ------------------------------------------------------------------
    def run(
        self,
        n_total: int = 4096,
        progress: bool = True,
        resume_state_path: Union[str, Path, None] = None,
        save_every: Optional[int] = None,
        on_device: bool = False,
    ):
        """Run until beta reaches 1 and the posterior ESS reaches n_total.

        With `on_device=True` (and no `save_every`) the whole annealing
        loop runs on the device (fused.py), on a CUDA device as one CUDA
        graph replay; the results are those of `on_device=False`. A torch
        likelihood that reads the host cannot be captured: it raises, and
        runs with on_device=False. On a CUDA device a host likelihood
        (`host_likelihood=True`) is called once a sweep by this thread while
        the host-call kernel waits for it on the card (`ops.cuda_host`),
        inside the graph's replay with on_device=True and eagerly without:
        it must make no CUDA call that waits for the sampler's device work
        (no `torch.cuda.synchronize()`, no copy of a tensor of its stream to
        the host, no new CUDA allocation), or the kernel waits for it
        forever. An exception it raises ends the run after its step and is
        raised here; `reset()` then starts a clean run."""
        return self._core.run_sampling(
            n_total=n_total,
            progress=progress,
            resume_state_path=resume_state_path,
            save_every=save_every,
            on_device=on_device,
        )

    def sample(self, save_every: Optional[int] = None, t0: int = 0) -> dict:
        """Perform a single PS iteration."""
        return self._core.execute_iteration(save_every=save_every, t0=t0)

    def posterior(
        self,
        resample: bool = False,
        return_blobs: bool = False,
        trim_importance_weights: bool = True,
        return_logw: bool = False,
        ess_trim: float = 0.99,
        bins_trim: int = 1000,
    ) -> tuple:
        """Posterior samples (x, weights, logl[, logw]) as numpy arrays."""
        return self._core.compute_posterior(
            resample=resample,
            return_blobs=return_blobs,
            trim_importance_weights=trim_importance_weights,
            return_logw=return_logw,
            ess_trim=ess_trim,
            bins_trim=bins_trim,
        )

    def evidence(self, n_bootstrap: int = 0):
        """(logz, logz_err). logz_err is None, as in the reference, unless
        n_bootstrap > 0 (e.g. 256) asks for the iteration-block bootstrap
        error over the MIS history (state.bootstrap_logz_err)."""
        return self._core.compute_evidence(n_bootstrap=n_bootstrap)

    def save_state(self, path: Union[str, Path]):
        """Write the run's state to `path` (utils/checkpoint.py)."""
        self._core.save_sampler_state(Path(path))

    def load_state(self, path: Union[str, Path]):
        """Continue from a state file of this package or of tempest_tpu."""
        self._core.load_sampler_state(Path(path))

    def close(self):
        """End the worker processes of `pool=<int>`, if any were started."""
        self._core.close()

    def results(self) -> dict:
        """Full per-iteration history plus the final log-weights."""
        return self._core.compute_results()

    def reset(self, random_state=None):
        """Clear the state for a fresh run."""
        self._core.reset(random_state=random_state)

    # ------------------------------------------------------------------
    # Pickling (sampler.py:200-260): the mesh and the pool are dropped;
    # tensors travel as numpy arrays, gathered from every rank under a mesh
    # (a collective), and go back onto the configured device, with the draw
    # state and the carried cluster model, so the unpickled sampler
    # continues the same stream on one device.
    def __getstate__(self):
        core = self._core
        sch = core.blob_schema
        return {
            "config": dataclasses.replace(core.config, mesh=None, pool=None),
            "hist": interop.history_to_numpy(core.hist, core.group),
            "cur": interop.current_to_numpy(core.cur, core.group),
            "draws": core.draws.get_state(),
            "model": interop.cluster_model_to_numpy(core.cluster_model),
            "n_total": core.n_total,
            "blob_store": sch.store if sch is not None and sch.is_object else None,
        }

    def __setstate__(self, state):
        self._core = core = SamplerCore(state["config"])
        core.hist = interop.history_from_numpy(state["hist"], core.device)
        core.cur = interop.current_from_numpy(state["cur"], core.device)
        core.draws.set_state(state["draws"])
        core.cluster_model = interop.cluster_model_from_numpy(state["model"], core.device)
        core.n_total = state["n_total"]
        if state["blob_store"] is not None:
            core.blob_schema.store = state["blob_store"]

    # ------------------------------------------------------------------
    @property
    def n_dim(self) -> int:
        return self._core.config.n_dim

    @property
    def n_particles(self) -> int:
        return self._core.config.n_particles

    @property
    def ess_ratio(self) -> float:
        return self._core.config.ess_ratio

    @property
    def volume_variation(self) -> Optional[float]:
        return self._core.config.volume_variation

    @property
    def n_steps(self) -> int:
        return self._core.config.n_steps

    @property
    def n_max_steps(self) -> int:
        return self._core.config.n_max_steps

    @property
    def n_total(self) -> Optional[int]:
        return self._core.n_total

    @property
    def resample(self) -> str:
        return self._core.config.resample

    @property
    def clustering(self) -> bool:
        return self._core.config.clustering

    @property
    def vectorize(self) -> bool:
        return self._core.config.vectorize

    @property
    def output_dir(self) -> Path:
        return self._core.config.output_dir

    @property
    def output_label(self) -> str:
        return self._core.config.output_label

    @property
    def random_state(self) -> Optional[int]:
        return self._core.config.random_state

    @property
    def periodic(self) -> Optional[list]:
        return self._core.config.periodic

    @property
    def reflective(self) -> Optional[list]:
        return self._core.config.reflective

    @property
    def device(self):
        return self._core.device

    @property
    def beta(self) -> float:
        return float(self._core.cur.beta)

    @property
    def logz(self) -> float:
        return float(self._core.cur.logz)

    @property
    def ess(self) -> float:
        return float(self._core.cur.ess)

    @property
    def cv(self) -> Optional[float]:
        return float(self._core.cur.cv)

    @property
    def calls(self) -> int:
        return self._core.calls_total()

    @property
    def state(self):
        """Access to internal state (history/current) for diagnostics."""
        return self._core
