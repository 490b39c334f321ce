"""Particle state: preallocated history buffers and the MIS weight math.

Counterpart of tempest_tpu/state.py. The layouts are the JAX package's, so
the tests compare like with like: `u`/`x` are (d, T_max, N) and
`logl`/`mis_c` are (T_max, N); slots `>= t` are masked out of every
computation.

Unlike the immutable JAX pytrees, `History` is updated in place: `commit`
writes iteration slot `t` through a device index (`index_copy_`) and adds
one to `t`, a 0-d int64 on the history's device, as JAX's donated buffers
alias the slot it writes (state.py:261-321). No function here reads `t` on
the host: every mask, slot and count is formed from the device word (JAX's
row masks over the whole capacity and dynamic index at `t`), so the same
code runs inside a CUDA-graph loop body that the host never stops.
`t_host` is the host's mirror of `t` where the host knows it (an eager
commit advances both; None after a device loop until the caller reads the
word), for the host's branches: growing the capacity, the first iteration.
Nothing else holds a reference to the buffers, so no caller sees a
half-written history.

Under a particle mesh each rank holds its block of the particle axis
(parallel/mesh.py), so `n_particles` is the block's width. `commit` and the
MIS accumulator are per sample and stay local; the functions that reduce
over samples take the mesh's `group` and count the global N.
"""

from __future__ import annotations

import dataclasses
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
    t: torch.Tensor  # () int64 on the device: the committed iterations
    blobs: Optional[torch.Tensor] = None  # (B, T_max, N) blob rows, or None
    t_host: Optional[int] = None  # the host's mirror of t, None where unknown

    def __post_init__(self):
        # A Python int t (a new or loaded history) becomes the device word
        # and its mirror; a tensor is kept, its mirror as given.
        if not isinstance(self.t, torch.Tensor):
            self.t_host = int(self.t)
            self.t = torch.full((), self.t_host, dtype=torch.int64, device=self.logl.device)

    def count(self) -> int:
        """The committed iterations on the host: the mirror, else one read."""
        if self.t_host is None:
            self.t_host = int(self.t)
        return self.t_host

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
    on the host only where it branches; `iteration` is a Python integer
    (a 0-d int64 on the device inside the device run loop, `fused.py`),
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
    iteration: Union[int, torch.Tensor]
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
    """Grow the capacity with contents preserved (state.py:182-209); `t`
    stays a device word."""
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
        t=hist.t.clone(),
        blobs=None if hist.blobs is None else pad(hist.blobs, 0, dim=1),
        t_host=hist.t_host,
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


def _slot(value, like: torch.Tensor) -> torch.Tensor:
    """`value` (a Python number or a 0-d tensor) as a (1,) tensor of
    `like`'s dtype and device, made on the device (a fill: no host copy)."""
    if isinstance(value, torch.Tensor):
        return value.reshape(1).to(like.dtype)
    return torch.full((1,), value, dtype=like.dtype, device=like.device)


def commit(hist: History, cur: Current) -> History:
    """Append the current state as iteration slot `t`, in place
    (state.py:261-321), on JAX's masked formulation: no host `t` in any
    shape, slice or index.

    Also maintains the MIS accumulator (`_mis_c_after_commit`, :261-294):
    each committed row (the rows below `t`) gains one logaddexp with the new
    (beta_T, logZ_T) term, O(S), and row `t` becomes a logsumexp over the
    temperatures of slots 0..t, O(N T_max). Every slot is written through
    the device index `t`. The caller must ensure capacity > t (checked
    where the host mirror knows `t`).
    """
    if hist.t_host is not None and hist.t_host >= hist.capacity:
        raise ValueError(f"history is full (capacity {hist.capacity}); grow it first")
    dtype, dev = hist.logl.dtype, hist.logl.device
    idx = hist.t.reshape(1)
    beta_T = cur.beta.to(dtype)
    logz_T = cur.logz.to(dtype)
    rows = torch.arange(hist.capacity, device=dev)

    # Rows of the committed iterations (slots < t); rows >= t stay -inf.
    term = _masked_term(beta_T, hist.logl, logz_T)
    hist.mis_c.copy_(torch.where((rows < hist.t)[:, None], torch.logaddexp(hist.mis_c, term),
                                 hist.mis_c))

    # The new iteration's row over the slots t' <= t.
    hist.beta.index_copy_(0, idx, beta_T.reshape(1))
    hist.logz.index_copy_(0, idx, logz_T.reshape(1))
    vals = _masked_term(hist.beta[:, None], cur.logl[None, :], hist.logz[:, None])
    vals = torch.where((rows <= hist.t)[:, None], vals, torch.full_like(vals, _NEG_INF))
    hist.mis_c.index_copy_(0, idx, logsumexp(vals, dim=0)[None])

    hist.u.index_copy_(1, idx, cur.u.T[:, None].to(dtype))
    hist.x.index_copy_(1, idx, cur.x.T[:, None].to(dtype))
    hist.logl.index_copy_(0, idx, cur.logl[None].to(dtype))
    if hist.blobs is not None:
        hist.blobs.index_copy_(1, idx, cur.blobs.T[:, None].to(hist.blobs.dtype))
    for name in ("ess", "cv", "acceptance", "efficiency", "steps", "calls"):
        field = getattr(hist, name)
        field.index_copy_(0, idx, _slot(getattr(cur, name), field))
    hist.t.add_(1)
    if hist.t_host is not None:
        hist.t_host += 1
    return hist


# ---------------------------------------------------------------------------
# The MIS / balance-heuristic weight computation.
# ---------------------------------------------------------------------------
def _log_t(hist: History) -> torch.Tensor:
    """log(max(t, 1)) in the history's dtype, from the device word."""
    return torch.log(torch.clamp(hist.t, min=1).to(hist.logl.dtype))


def mis_denominator(hist: History) -> torch.Tensor:
    """B_s = mis_c_s - log(T), the beta-independent MIS denominator — O(S)
    (state.py:327-338). Shape (T_max, N)."""
    return hist.mis_c - _log_t(hist)


def mis_denominator_exact(hist: History) -> torch.Tensor:
    """Full-matrix O(S*T) denominator, the reference formulation
    (state.py:341-363); the ground truth in tests. Shape (T_max, N)."""
    it_mask = hist.iter_mask()
    log_mix = torch.where(it_mask, -_log_t(hist), torch.full_like(hist.beta, _NEG_INF))
    rows = []
    for logl_row in hist.logl:
        b = logl_row[:, None] * hist.beta[None, :] - hist.logz[None, :] + log_mix[None, :]
        b = torch.where(it_mask[None, :], b, torch.full_like(b, _NEG_INF))
        rows.append(logsumexp(b, dim=1))
    return torch.stack(rows)


def rebuild_mis_c(hist: History) -> History:
    """Recompute the accumulator from scratch, in place (state.py:366-371):
    for checkpoints written before it existed."""
    c = mis_denominator_exact(hist) + _log_t(hist)
    hist.mis_c = torch.where(hist.iter_mask()[:, None], c, torch.full_like(c, _NEG_INF))
    return hist


def global_particles(hist: History, group=None) -> int:
    """The run's N: the block's width times the ranks of `group`."""
    return hist.n_particles * (1 if group is None else dist.get_world_size(group))


def masked_logw(hist: History, denom: torch.Tensor, beta_final) -> torch.Tensor:
    """Unnormalized log-weights beta_final * logl_s - B_s; non-finite logl
    and invalid slots get -inf, exactly zero weight."""
    dtype, dev = hist.logl.dtype, hist.logl.device
    beta_final = (beta_final.to(dtype) if isinstance(beta_final, torch.Tensor)
                  else torch.full((), beta_final, dtype=dtype, device=dev))  # a fill: no copy
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
    n_total = (hist.t * global_particles(hist, group)).to(logw.dtype)
    logz_new = torch.where(hist.t > 0, lse - torch.log(torch.clamp(n_total, min=1.0)),
                           torch.full_like(lse, _NEG_INF))
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
    T_max) pick the blocks: index min(floor(u t), t - 1), t at least 1 and
    read from the device word; slots j >= t are masked out of each
    replicate. Under a mesh each L_t is reduced over the
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
    t = torch.clamp(hist.t, min=1)
    idx = torch.minimum((uniforms * t).to(torch.int32), t - 1)
    draws = L[idx.long()]  # (B, T_max)
    in_run = torch.arange(hist.capacity, device=L.device)[None, :] < t
    draws = torch.where(in_run, draws, torch.full_like(draws, _NEG_INF))
    n_total = (t * global_particles(hist, group)).to(L.dtype)
    logz_b = logsumexp(draws, dim=1) - torch.log(n_total)
    mean = torch.mean(logz_b)
    return torch.sqrt(torch.mean((logz_b - mean) ** 2))


def compute_logw_and_logz(
    hist: History, beta_final, normalize: bool = True, group=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Importance log-weights for all historical samples at `beta_final`
    and the evidence estimate (state.py:440-456)."""
    return logw_from_denominator(hist, mis_denominator(hist), beta_final, normalize, group)
