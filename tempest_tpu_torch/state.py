"""Particle state: preallocated history buffers and the MIS weight math.

Counterpart of tempest_tpu/state.py. The layouts are the JAX package's, so
the tests compare like with like: `u`/`x` are (d, T_max, N) and
`logl`/`mis_c` are (T_max, N); slots `>= t` are masked out of every
computation.

Unlike the immutable JAX pytrees, `History` is updated in place: `commit`
writes iteration slot `t` with `index_copy_`-style slice assignment and
advances the Python integer `t`. Nothing else holds a reference to the
buffers, so no caller sees a half-written history.

Under a particle mesh each rank holds its block of the particle axis
(parallel/mesh.py), so `n_particles` is the block's width. `commit` and the
MIS accumulator are per sample and stay local; the functions that reduce
over samples take the mesh's `group` and count the global N.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from .ops.tools import logsumexp, logsumexp_psum, _pmax, _psum

_NEG_INF = float("-inf")


@dataclasses.dataclass
class History:
    """Rectangular particle history; valid iterations are [0, t)
    (state.py:43-118)."""

    u: torch.Tensor  # (d, T_max, N) unit-hypercube coordinates
    x: torch.Tensor  # (d, T_max, N) physical coordinates
    logl: torch.Tensor  # (T_max, N)
    # Running MIS-denominator accumulator (state.py:50-57):
    #   mis_c[t', s] = logsumexp_{t < T} (beta_t * logl[t', s] - logZ_t)
    mis_c: torch.Tensor  # (T_max, N)
    beta: torch.Tensor  # (T_max,)
    logz: torch.Tensor  # (T_max,)
    ess: torch.Tensor  # (T_max,)
    cv: torch.Tensor  # (T_max,)
    acceptance: torch.Tensor  # (T_max,)
    efficiency: torch.Tensor  # (T_max,)
    steps: torch.Tensor  # (T_max,) int32
    calls: torch.Tensor  # (T_max,) int32 cumulative likelihood-call sweeps
    t: int  # number of committed iterations
    blobs: Optional[torch.Tensor] = None  # (B, T_max, N) blob rows, or None

    @property
    def capacity(self) -> int:
        return self.u.shape[1]

    @property
    def n_particles(self) -> int:
        return self.u.shape[2]

    @property
    def n_dim(self) -> int:
        return self.u.shape[0]

    def iter_mask(self) -> torch.Tensor:
        """(T_max,) bool — which iteration slots are valid."""
        return torch.arange(self.capacity, device=self.logl.device) < self.t

    def sample_mask(self) -> torch.Tensor:
        """(T_max, N) bool — which history samples are valid."""
        return self.iter_mask()[:, None].expand(self.capacity, self.n_particles)


@dataclasses.dataclass
class Current:
    """Active particle set and per-iteration scalars (state.py:212-229).

    The float scalars are 0-d tensors on the device, so the loop reads them
    on the host only where it branches; `iteration` is a Python integer,
    `steps` and `calls` Python integers or, after an MCMC mutation, 0-d
    int32 tensors on the device (its step count is never read on the
    host: `int()` them where they are reported).
    """

    u: torch.Tensor  # (N, d)
    x: torch.Tensor  # (N, d)
    logl: torch.Tensor  # (N,)
    assignments: torch.Tensor  # (N,) int32 cluster labels
    beta: torch.Tensor
    logz: torch.Tensor
    ess: torch.Tensor
    cv: torch.Tensor
    acceptance: torch.Tensor
    efficiency: torch.Tensor
    steps: Union[int, torch.Tensor]
    calls: Union[int, torch.Tensor]  # cumulative likelihood-call sweeps (see History.calls)
    iteration: int
    blobs: Optional[torch.Tensor] = None  # (N, B) blob rows, or None


def make_history(
    capacity: int,
    n_particles: int,
    n_dim: int,
    dtype=torch.float32,
    device=None,
    blob_size: Optional[int] = None,
    blobs_dtype=None,
) -> History:
    """Allocate an empty history buffer (state.py:151-179), with (B, T_max,
    N) blob rows of `blobs_dtype` (default `dtype`) when `blob_size` is set."""

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def neg_inf():
        return torch.full((capacity, n_particles), _NEG_INF, dtype=dtype, device=device)

    return History(
        u=zeros(n_dim, capacity, n_particles),
        x=zeros(n_dim, capacity, n_particles),
        logl=neg_inf(),
        mis_c=neg_inf(),
        beta=zeros(capacity),
        logz=zeros(capacity),
        ess=zeros(capacity),
        cv=zeros(capacity),
        acceptance=zeros(capacity),
        efficiency=zeros(capacity),
        steps=torch.zeros(capacity, dtype=torch.int32, device=device),
        calls=torch.zeros(capacity, dtype=torch.int32, device=device),
        t=0,
        blobs=None if blob_size is None else torch.zeros(
            (blob_size, capacity, n_particles), dtype=blobs_dtype or dtype, device=device),
    )


def make_current(
    n_particles: int,
    n_dim: int,
    dtype=torch.float32,
    device=None,
    blob_size: Optional[int] = None,
    blobs_dtype=None,
) -> Current:
    """An empty active set (state.py:232-258)."""

    def scalar():
        return torch.zeros((), dtype=dtype, device=device)

    return Current(
        u=torch.zeros((n_particles, n_dim), dtype=dtype, device=device),
        x=torch.zeros((n_particles, n_dim), dtype=dtype, device=device),
        logl=torch.full((n_particles,), _NEG_INF, dtype=dtype, device=device),
        assignments=torch.zeros((n_particles,), dtype=torch.int32, device=device),
        beta=scalar(),
        logz=scalar(),
        ess=scalar(),
        cv=scalar(),
        acceptance=scalar(),
        efficiency=scalar(),
        steps=0,
        calls=0,
        iteration=0,
        blobs=None if blob_size is None else torch.zeros(
            (n_particles, blob_size), dtype=blobs_dtype or dtype, device=device),
    )


def grow_history(hist: History, new_capacity: int) -> History:
    """Grow the capacity with contents preserved (state.py:182-209)."""
    cap = hist.capacity
    if new_capacity <= cap:
        raise ValueError(f"new capacity {new_capacity} must exceed {cap}")

    def pad(arr, fill=0.0, dim=0):
        shape = list(arr.shape)
        shape[dim] = new_capacity - cap
        filler = torch.full(shape, fill, dtype=arr.dtype, device=arr.device)
        return torch.cat([arr, filler], dim=dim)

    return History(
        u=pad(hist.u, dim=1),
        x=pad(hist.x, dim=1),
        logl=pad(hist.logl, _NEG_INF),
        mis_c=pad(hist.mis_c, _NEG_INF),
        beta=pad(hist.beta),
        logz=pad(hist.logz),
        ess=pad(hist.ess),
        cv=pad(hist.cv),
        acceptance=pad(hist.acceptance),
        efficiency=pad(hist.efficiency),
        steps=pad(hist.steps, 0),
        calls=pad(hist.calls, 0),
        t=hist.t,
        blobs=None if hist.blobs is None else pad(hist.blobs, 0, dim=1),
    )


def gather_history(
    hist: History, t_idx: torch.Tensor, n_idx: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(u, x, logl, blobs) rows for sample coordinates (t, n); u/x come back
    as (k, d), blobs as (k, B) or None (state.py:121-148)."""
    s_idx = t_idx * hist.n_particles + n_idx
    d = hist.n_dim
    u = hist.u.reshape(d, -1)[:, s_idx].T
    x = hist.x.reshape(d, -1)[:, s_idx].T
    logl = hist.logl.reshape(-1)[s_idx]
    blobs = None
    if hist.blobs is not None:
        blobs = hist.blobs.reshape(hist.blobs.shape[0], -1)[:, s_idx].T
    return u, x, logl, blobs


def _masked_term(beta, logl: torch.Tensor, logz) -> torch.Tensor:
    """beta * logl - logz, forced to -inf where logl is not finite
    (0 * -inf would be NaN)."""
    term = beta * logl - logz
    return torch.where(torch.isfinite(logl), term, torch.full_like(term, _NEG_INF))


def commit(hist: History, cur: Current) -> History:
    """Append the current state as iteration slot `t`, in place
    (state.py:261-321).

    Also maintains the MIS accumulator: each committed row gains one
    logaddexp with the new (beta_T, logZ_T) term — O(S) — and the new row
    is a logsumexp over all T+1 committed temperatures — O(N*T). The
    caller must ensure capacity > t.
    """
    t = hist.t
    if t >= hist.capacity:
        raise ValueError(f"history is full (capacity {hist.capacity}); grow it first")
    beta_T = cur.beta.to(hist.logl.dtype)
    logz_T = cur.logz.to(hist.logl.dtype)

    # Rows of the committed iterations (slots < t) — rows >= t stay -inf.
    hist.mis_c[:t] = torch.logaddexp(hist.mis_c[:t], _masked_term(beta_T, hist.logl[:t], logz_T))

    # The new iteration's row over all t' <= t.
    hist.beta[t] = beta_T
    hist.logz[t] = logz_T
    vals = _masked_term(hist.beta[: t + 1, None], cur.logl[None, :], hist.logz[: t + 1, None])
    hist.mis_c[t] = logsumexp(vals, dim=0)

    hist.u[:, t] = cur.u.T
    hist.x[:, t] = cur.x.T
    hist.logl[t] = cur.logl
    if hist.blobs is not None:
        hist.blobs[:, t] = cur.blobs.T
    hist.ess[t] = cur.ess
    hist.cv[t] = cur.cv
    hist.acceptance[t] = cur.acceptance
    hist.efficiency[t] = cur.efficiency
    # Counters go in by fill: assigning a Python number copies from the host,
    # and a 0-d device tensor fills on the device.
    hist.steps[t:t + 1].fill_(cur.steps)
    hist.calls[t:t + 1].fill_(cur.calls)
    hist.t = t + 1
    return hist


# ---------------------------------------------------------------------------
# The MIS / balance-heuristic weight computation.
# ---------------------------------------------------------------------------
def mis_denominator(hist: History) -> torch.Tensor:
    """B_s = mis_c_s - log(T), the beta-independent MIS denominator — O(S)
    (state.py:327-338). Shape (T_max, N)."""
    return hist.mis_c - math.log(max(hist.t, 1))


def mis_denominator_exact(hist: History) -> torch.Tensor:
    """Full-matrix O(S*T) denominator, the reference formulation
    (state.py:341-363); the ground truth in tests. Shape (T_max, N)."""
    it_mask = hist.iter_mask()
    log_mix = torch.where(
        it_mask,
        torch.full_like(hist.beta, -math.log(max(hist.t, 1))),
        torch.full_like(hist.beta, _NEG_INF),
    )
    rows = []
    for logl_row in hist.logl:
        b = logl_row[:, None] * hist.beta[None, :] - hist.logz[None, :] + log_mix[None, :]
        b = torch.where(it_mask[None, :], b, torch.full_like(b, _NEG_INF))
        rows.append(logsumexp(b, dim=1))
    return torch.stack(rows)


def rebuild_mis_c(hist: History) -> History:
    """Recompute the accumulator from scratch, in place (state.py:366-371):
    for checkpoints written before it existed."""
    c = mis_denominator_exact(hist) + math.log(max(hist.t, 1))
    hist.mis_c = torch.where(hist.iter_mask()[:, None], c, torch.full_like(c, _NEG_INF))
    return hist


def global_particles(hist: History, group=None) -> int:
    """The run's N: the block's width times the ranks of `group`."""
    return hist.n_particles * (1 if group is None else dist.get_world_size(group))


def masked_logw(hist: History, denom: torch.Tensor, beta_final) -> torch.Tensor:
    """Unnormalized log-weights beta_final * logl_s - B_s; non-finite logl
    and invalid slots get -inf, exactly zero weight."""
    beta_final = torch.as_tensor(beta_final, dtype=hist.logl.dtype, device=hist.logl.device)
    keep = hist.sample_mask() & torch.isfinite(hist.logl)
    logw = beta_final * hist.logl - denom
    return torch.where(keep, logw, torch.full_like(logw, _NEG_INF))


def logw_from_denominator(
    hist: History, denom: torch.Tensor, beta_final, normalize: bool = True, group=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-weights (T_max, N) and logZ at `beta_final` (state.py:374-400).

    logw_s = beta_final * logl_s - B_s;  logz = logsumexp_s(logw_s) - log(t*N),
    the logsumexp over every rank of `group` and N the global count.
    """
    logw = masked_logw(hist, denom, beta_final)
    lse = logsumexp_psum(logw, group)
    if hist.t > 0:
        logz_new = lse - math.log(hist.t * global_particles(hist, group))
    else:
        logz_new = torch.full((), _NEG_INF, dtype=logw.dtype, device=logw.device)
    if normalize:
        logw = logw - lse
    return logw, logz_new


def bootstrap_logz_err(hist: History, uniforms: torch.Tensor, beta_final=1.0,
                       group=None) -> torch.Tensor:
    """Iteration-block bootstrap standard error of the MIS logZ
    (state.py:403-437).

    With L_t = logsumexp_n(logw[t, :]), logZ = logsumexp_t(L_t) - log(N t);
    each of the n_bootstrap replicates draws t blocks with replacement and
    the error is the std of the replicate logZs. `uniforms` (n_bootstrap,
    T_max) pick the blocks: index min(floor(u t), t - 1); slots j >= t are
    masked out of each replicate. Under a mesh each L_t is reduced over the
    ranks of `group` (a MAX and a SUM of T_max values), so the replicates
    are the same on every rank.
    """
    logw = masked_logw(hist, mis_denominator(hist), beta_final)
    L = logsumexp(logw, dim=1)  # (T_max,), -inf where invalid
    if group is not None:
        m = _pmax(L, group)
        m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        s = _psum(torch.exp(L - m_safe), group)
        L = torch.where(torch.isfinite(m), m_safe + torch.log(s), m)
    t = max(hist.t, 1)
    idx = torch.clamp((uniforms * t).to(torch.int32), max=t - 1)
    draws = L[idx.long()]  # (B, T_max)
    in_run = torch.arange(hist.capacity, device=L.device)[None, :] < t
    draws = torch.where(in_run, draws, torch.full_like(draws, _NEG_INF))
    logz_b = logsumexp(draws, dim=1) - math.log(float(t * global_particles(hist, group)))
    mean = torch.mean(logz_b)
    return torch.sqrt(torch.mean((logz_b - mean) ** 2))


def compute_logw_and_logz(
    hist: History, beta_final, normalize: bool = True, group=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Importance log-weights for all historical samples at `beta_final`
    and the evidence estimate (state.py:440-456)."""
    return logw_from_denominator(hist, mis_denominator(hist), beta_final, normalize, group)
