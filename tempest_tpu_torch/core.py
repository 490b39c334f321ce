"""SamplerCore — the Persistent Sampling annealing loop.

Counterpart of tempest_tpu/core.py: construction and `reset`, capacity
pre-growth and doubling (:239-272), `run_sampling` (:274-324) with the
termination rule of `_not_termination` (:466-477) and the final logZ at
beta = 1, and the posterior, evidence and results extraction. The fitted
cluster model is carried from iteration to iteration in `cluster_model`
(in JAX, `s.state.trainer.cluster_model`). `run(on_device=True)` is
accepted and runs the same eager loop as `on_device=False`: there is one
code path. The dispatch-budget chunking
of the TPU whole-run program is not ported (ROADMAP.md queue 1, item 12).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .cluster import ClusterModel, single_cluster_model
from .config import SamplerConfig, not_ported
from .draws import Draws, HardwareDraws
from .iteration import make_iteration
from .ops.tools import ess_from_logw, systematic_resample, trim_weights_mask
from .state import (
    Current,
    History,
    compute_logw_and_logz,
    grow_history,
    make_current,
    make_history,
)
from .utils.wrappers import FunctionWrapper, build_log_likelihood, build_prior_transform


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class SamplerCore:
    """Internal coordinator; the public Sampler facade delegates here."""

    def __init__(self, config: SamplerConfig):
        self.config = cfg = config
        self.n_dim = cfg.n_dim
        self.n_particles = cfg.n_particles
        self.dtype = cfg.dtype
        self.device = cfg.device

        wrapped = FunctionWrapper(
            cfg.log_likelihood, cfg.log_likelihood_args, cfg.log_likelihood_kwargs
        )
        self._prior_batch = build_prior_transform(cfg.prior_transform, cfg.vectorize)
        self._loglike_batch = build_log_likelihood(wrapped, cfg.vectorize, dtype=cfg.dtype)
        self._iteration = make_iteration(cfg, self._loglike_batch, self._prior_batch)
        self.reset()

    # ------------------------------------------------------------------
    def reset(self, random_state: Optional[int] = None) -> None:
        """Clear the sampler state for a fresh run with seed `random_state`
        (default: the config's, else 0)."""
        cfg = self.config
        seed = random_state if random_state is not None else (cfg.random_state or 0)
        draws = HardwareDraws if cfg.hardware_prng else Draws
        self.draws = draws(seed, self.device, self.dtype)
        self.cluster_model: ClusterModel = single_cluster_model(
            cfg.n_dim, cfg.k_max if cfg.clustering else 1, cfg.dtype, cfg.normalize, self.device
        )
        self.hist: History = make_history(
            cfg.history_capacity, cfg.n_particles, cfg.n_dim, dtype=cfg.dtype, device=self.device
        )
        self.cur: Current = make_current(
            cfg.n_particles, cfg.n_dim, dtype=cfg.dtype, device=self.device
        )
        self.n_total: Optional[int] = None
        self.logz_err = None

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
        if self.hist.t >= self.hist.capacity:
            self.hist = grow_history(self.hist, self.hist.capacity * 2)

    # ------------------------------------------------------------------
    def run_sampling(
        self,
        n_total: int = 4096,
        progress: bool = True,
        resume_state_path=None,
        save_every: Optional[int] = None,
        on_device: bool = False,
    ) -> None:
        """Anneal until beta reaches 1 and the posterior ESS reaches n_total.

        `progress` is accepted for API parity; the progress bar is not
        ported yet (ROADMAP.md queue 1, item 11), so nothing is drawn.
        """
        if resume_state_path is not None or save_every is not None:
            raise not_ported("checkpoints (resume_state_path, save_every)", "queue 1, item 11")
        self.n_total = int(n_total)
        self._pregrow_capacity()
        while self._not_termination():
            self._advance()

        # Final evidence at beta = 1 over the whole history.
        _, logz = compute_logw_and_logz(self.hist, 1.0)
        self.cur.logz = logz.to(self.dtype)
        self.logz_err = None

    def posterior_ess(self) -> float:
        """ESS of the MIS weights of the whole history at beta = 1."""
        logw, _ = compute_logw_and_logz(self.hist, 1.0)
        return float(ess_from_logw(logw))

    def _not_termination(self) -> bool:
        """Continue while 1 - beta >= 1e-4 or the posterior ESS < n_total."""
        if self.hist.t == 0:
            return True
        if 1.0 - float(self.cur.beta) >= 1e-4:
            return True
        return self.posterior_ess() < (self.n_total or 0)

    def execute_iteration(self, save_every: Optional[int] = None, t0: int = 0) -> dict:
        """One reweight -> fit -> resample -> mutate -> commit iteration."""
        if save_every is not None:
            raise not_ported("checkpoints (save_every)", "queue 1, item 11")
        self._advance()
        return self.get_current_dict()

    def _advance(self) -> None:
        self._ensure_capacity()
        self.hist, self.cur, self.cluster_model = self._iteration(
            self.draws, self.hist, self.cur, self.cluster_model
        )

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
        """(x, weights, logl[, logw]) as numpy arrays (core.py:636-702)."""
        if return_blobs:
            raise not_ported("blobs", "queue 1, item 11")
        logw, _ = compute_logw_and_logz(self.hist, 1.0)
        valid = _host(self.hist.sample_mask()).reshape(-1)
        logw_np = _host(logw).reshape(-1)

        def snd(arr):  # (B, T, N) -> (S, B), t-major sample order
            a = np.moveaxis(_host(arr), 0, -1)
            return a.reshape(-1, a.shape[-1])

        x = snd(self.hist.x)
        logl = _host(self.hist.logl).reshape(-1)

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

        if resample:
            u0 = self.draws.resample(1, "syst").cpu()
            idx = systematic_resample(u0, len(weights), torch.from_numpy(weights)).numpy()
            x, logl, logw_np = x[idx], logl[idx], logw_np[idx]
            weights = np.ones(len(idx)) / len(idx)

        out = [x, weights, logl]
        if return_logw:
            out.append(logw_np)
        return tuple(out)

    def compute_evidence(self, n_bootstrap: int = 0):
        """(logz, logz_err); logz_err is None, as in the reference."""
        if n_bootstrap > 0:
            raise not_ported("the bootstrap logZ error (n_bootstrap > 0)", "queue 1, item 11")
        return float(self.cur.logz), self.logz_err

    def compute_results(self) -> dict:
        """The full per-iteration history (core.py:719-746)."""
        h = self.hist
        t = h.t
        logw, _ = compute_logw_and_logz(h, 1.0)
        return {
            "u": np.moveaxis(_host(h.u[:, :t]), 0, -1),
            "x": np.moveaxis(_host(h.x[:, :t]), 0, -1),
            "logl": _host(h.logl[:t]),
            "beta": _host(h.beta[:t]),
            "logz": _host(h.logz[:t]),
            "ess": _host(h.ess[:t]),
            "cv": _host(h.cv[:t]),
            "acceptance": _host(h.acceptance[:t]),
            "efficiency": _host(h.efficiency[:t]),
            "steps": _host(h.steps[:t]),
            "calls": _host(h.calls[:t]).astype(np.int64) * self.n_particles,
            "iter": np.arange(1, t + 1),
            "logw": _host(logw).reshape(-1)[_host(h.sample_mask()).reshape(-1)],
        }

    # ------------------------------------------------------------------
    def get_current_dict(self) -> dict:
        c = self.cur
        return {
            "u": _host(c.u),
            "x": _host(c.x),
            "logl": _host(c.logl),
            "assignments": _host(c.assignments),
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
