"""Adaptive MCMC mutation: tpCN and random-walk Metropolis.

Counterpart of tempest_tpu/mcmc.py:138-433, with both forms of the
per-walker matrix products and JAX's switch between them (:250-257): while
N d^2 <= `_GATHER_ELEMS_LIMIT` (N the walkers over every rank, as JAX
counts them under pjit) the Cholesky factors and inverse covariances are
gathered once per mutation to (N, d, d) and each product is a per-walker
einsum (:110-135); past it nothing (N, d, d) is made, and each product
loops over all K modes with one dense (N, d) x (d, d) (or (R N, d) x
(d, d)) matmul a mode, a walker taking its own mode's value (`_mode_quadratic`,
`_mode_matmul`, :76-107). `Walkers.form` says which form a mutation holds.
The loop over the modes is a static Python loop, so it is captured into a
graphed body as it stands, and it skips no empty mode. The
hardware-PRNG branches (:187-192, :272-315) live in the draws source:
with `hardware_prng=True` in float32 the loop is handed a
`draws.HardwareDraws` (float64 takes `Draws`, the flag not applying),
which routes each step's draws to the Philox kernels by the same size
thresholds. Semantics kept:

- tpCN proposal u' = mu + sqrt(1 - s^2)(u - mu) + s sqrt(g) L z with the
  inverse-gamma mixture scale g, and the Student-t density-ratio factor
  (:296-338); RWM proposal u' = u + s L z;
- `n_candidates` i.i.d. candidates per walker, the first in-bounds one
  taken by a where-chain, alpha = 0 for walkers with none (:168-219);
- tempered Metropolis alpha = min(1, exp(beta dlogl + factor)), NaN -> 0;
  the accepted walkers take the proposal's blob rows too (:341-342);
- per-cluster Robbins-Monro adaptation of sigma toward 0.234, clipped to
  [0, min(2.38/sqrt(d), 0.99)] for tpCN (:355-380);
- the adaptive stop n_steps d (0.234/acc)(sigma_0/sigma)^2 clamped to
  [n_steps d, n_max_steps d] (:382-392).

`MCMCKernel.step` is the pure step on explicit draws; a walker, the
sigmas and the step count stay as they are once the chain is done, as the
JAX `lax.while_loop` (:417) stops there. The step index is a device
tensor, so `rate = 1/(iteration + 1)` and the stop test are computed on the
device. `MCMCKernel.__call__` runs the chain while JAX's `cond` holds (:280:
not done) and, a guard JAX does without while n_final is finite, the step
count is below the clamp's ceiling `n_max_steps d` (a NaN n_final would
never stop the chain); a step takes its draws from a `Draws` or
`HardwareDraws` object. Two routes:

- graphed (`loops.graphed`) on keyed draws (`draws.keyed`: every step draw
  from the Philox kernels on a call counter in device words that a step
  advances only while active, as JAX's key rides in the loop's carry; on
  the card in float32 and float64 alike), on one device or a mesh: the
  loop form `loops.Loops.repeat`, one CUDA-graph WHILE node that runs the
  real steps and reads nothing (a stretch of its own, or nested in the
  mutation's IF node of the device run loop, `fused.make_fused_run`).
  `steps` stays a device tensor. A graphed loop takes keyed draws only.
- otherwise (eager, the CPU, a test's source): the device loop "mcmc" in
  chunks (`loops.Loops.start`): with a chunk length of 1 it reads the stop
  flag after every step; with a longer one its first chunk is the
  `n_steps d` steps the clamp always runs, and each later chunk runs that
  many steps before one read. A chunk's steps past the stop change no
  walker; their number is counted in `loops.stats["mcmc"]["past_stop"]`
  (their kernel launches are the only trace they leave). On keyed draws
  they draw nothing new either. Generator draws (the CPU's) they do
  consume, which the next stage must not see: the draws object is put
  back (`Draws.seek`) to its position before the first step past the stop.
  A draws object without `tell`/`seek` (a test's one-iteration source) is
  not put back.

So graphed and eager runs give the same bits. `steps` and `n_call_sweeps`
count the real steps only. Every batched likelihood is handed the step's
`active` flag with the walkers' logl and blob rows; a host likelihood
(`utils.wrappers.HostLikelihood`) then calls nothing on the host for a
step past the stop; graphed, the chain's
predicate ANDs in the word its host-call kernel sets where the likelihood
raised (`Loops.unhalted`), so the WHILE node ends after that step.

Under a particle mesh (`group`) each rank mutates its block of walkers.
The cluster counts are summed over the ranks once per mutation, and each
step's acceptance sums in one `all_reduce` (mcmc.py:218-229, :256), so the
step sizes and the stop test are the same on every rank. The draws are
global (draws.BlockDraws keeps the rank's block), so the walkers'
gamma shapes are gathered over the ranks: `Walkers.gamma_shape` is then
the global (N,) vector. The gather and the cluster counts run before the
loop; the step's `all_reduce` runs inside each body (captured with it on
CUDA), and every rank reads the same reduced stop flag, so the ranks run
the same bodies and put the global draws back alike.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from .loops import Loops
from .modes import ModeStatistics
from .ops.boundary import apply_boundary_conditions, check_bounds
from .ops.tools import _psum
from .parallel.mesh import all_gather


class MCMCResult(NamedTuple):
    u: torch.Tensor
    x: torch.Tensor
    logl: torch.Tensor
    blobs: Optional[torch.Tensor]  # (N, B) or None
    efficiency: torch.Tensor
    acceptance: torch.Tensor
    steps: torch.Tensor  # () int32, on the walkers' device
    n_call_sweeps: torch.Tensor  # batched likelihood evaluations of all walkers


GATHERED, K_LOOP = "gathered", "k_loop"

# Past this many gathered-matrix elements, N d^2, the per-walker matrices
# are not gathered and each product loops over the modes instead
# (mcmc.py:124): at N = 2^20 and d = 100 one gathered float32 set would
# take 42 GB.
_GATHER_ELEMS_LIMIT = 1 << 21


def gathers(n_walkers: int, n_dim: int) -> bool:
    """Whether a mutation of `n_walkers` walkers (over every rank) gathers
    the per-walker matrices (mcmc.py:250): N d^2 <= `_GATHER_ELEMS_LIMIT`."""
    return n_walkers * n_dim * n_dim <= _GATHER_ELEMS_LIMIT


@dataclasses.dataclass
class Walkers:
    """What one mutation holds fixed: the walkers' modes and matrices, in
    one of two forms (`form`): the gathered (N, d, d) `chol` and `inv`, or
    the modes' (K, d, d) `chol_covariances` and `inv_covariances`, which the
    products index by `assignments`."""

    assignments: torch.Tensor  # (N,)
    beta: torch.Tensor  # ()
    mu: torch.Tensor  # (N, d) mode mean per walker
    dof: torch.Tensor  # (N,)
    onehot: torch.Tensor  # (N, K)
    count_k: torch.Tensor  # (K,) over all ranks
    gamma_shape: Optional[torch.Tensor] = None  # (N,) tpCN only; global under a mesh
    chol: Optional[torch.Tensor] = None  # (N, d, d) gathered Cholesky factors
    inv: Optional[torch.Tensor] = None  # (N, d, d) gathered inverse covariances
    chol_covariances: Optional[torch.Tensor] = None  # (K, d, d), the K-loop form
    inv_covariances: Optional[torch.Tensor] = None  # (K, d, d), the K-loop form

    @property
    def form(self) -> str:
        """`GATHERED` or `K_LOOP`."""
        return GATHERED if self.chol is not None else K_LOOP

    def quadratic(self, diff: torch.Tensor) -> torch.Tensor:
        """diff_n^T Sigma_{a(n)}^-1 diff_n, (N,)."""
        if self.chol is not None:
            return _quadratic(diff, self.inv)
        return _mode_quadratic(diff, self.assignments, self.inv_covariances)

    def mode_step(self, z: torch.Tensor) -> torch.Tensor:
        """z_rn @ L_{a(n)}^T for z (R, N, d)."""
        if self.chol is not None:
            return torch.einsum("rnj,nij->rni", z, self.chol)
        return _mode_matmul(z, self.assignments, self.chol_covariances)


@dataclasses.dataclass
class ChainState:
    u: torch.Tensor
    x: torch.Tensor
    logl: torch.Tensor
    blobs: Optional[torch.Tensor]  # (N, B) or None
    sigmas: torch.Tensor  # (K,)
    iteration: torch.Tensor  # () int32: the real steps so far
    alpha_mean: torch.Tensor
    done: torch.Tensor  # () bool


def _tensors(obj) -> dict:
    """A dataclass's tensor fields (None left out), by name."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _quadratic(diff: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """diff_n^T M_n diff_n for per-walker matrices (N, d, d) (mcmc.py:127-130)."""
    v = torch.einsum("nj,nji->ni", diff, mats)
    return torch.sum(v * diff, dim=1)


# The K-loop form (mcmc.py:76-107). JAX adds where(a(n) == k, value, 0) to
# a zero accumulator for each mode; a walker's own mode gives its only
# nonzero term, so taking where(a(n) == k, value, acc) gives the same values
# with one pass fewer a mode.
def _mode_quadratic(diff: torch.Tensor, assignments: torch.Tensor,
                    mats: torch.Tensor) -> torch.Tensor:
    """diff_n^T M_{a(n)} diff_n -> (N,) for the modes' matrices (K, d, d):
    one (N, d) x (d, d) matmul a mode, every mode run."""
    acc = torch.zeros(diff.shape[0], dtype=diff.dtype, device=diff.device)
    for k in range(mats.shape[0]):
        dk = torch.sum((diff @ mats[k]) * diff, dim=1)
        acc = torch.where(assignments == k, dk, acc)
    return acc


def _mode_matmul(z: torch.Tensor, assignments: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """z_rn @ M_{a(n)}^T -> (R, N, d) for z (R, N, d) and the modes'
    matrices (K, d, d): one (R N, d) x (d, d) matmul a mode, every mode run."""
    acc = torch.zeros_like(z)
    for k in range(mats.shape[0]):
        acc = torch.where((assignments == k)[None, :, None], z @ mats[k].T, acc)
    return acc


class MCMCKernel:
    """Adaptive mutation (mcmc.py:138-433).

    log_likelihood_batch: (x (N, d), active, logl, blobs) -> (logl (N,),
        blobs (N, B) or None); `active` is the step's 0-d bool and logl,
        blobs the walkers' own (`utils.wrappers.build_log_likelihood`)
    prior_transform_batch: u (N, d) -> x (N, d)
    """

    def __init__(
        self,
        log_likelihood_batch: Callable,
        prior_transform_batch: Callable,
        n_dim: int,
        method: str = "tpcn",
        n_steps: int = 1,
        n_max_steps: int = 20,
        periodic_mask: Optional[torch.Tensor] = None,
        reflective_mask: Optional[torch.Tensor] = None,
        strict_mask: Optional[torch.Tensor] = None,
        n_candidates: int = 8,
        dtype=torch.float32,
        group=None,
    ):
        self.group = group
        self.world = 1 if group is None else dist.get_world_size(group)
        self.log_likelihood_batch = log_likelihood_batch
        self.prior_transform_batch = prior_transform_batch
        self.n_dim = n_dim
        self.is_tpcn = method == "tpcn"
        self.n_candidates = n_candidates
        if periodic_mask is None:
            periodic_mask = torch.zeros(n_dim, dtype=torch.bool)
        if reflective_mask is None:
            reflective_mask = torch.zeros(n_dim, dtype=torch.bool)
        if strict_mask is None:
            strict_mask = ~(periodic_mask | reflective_mask)
        self.periodic_mask = periodic_mask
        self.reflective_mask = reflective_mask
        self.strict_mask = strict_mask
        # In the run's dtype, as the JAX package computes these constants in
        # its default float (float64 under x64).
        sqrt_d = torch.sqrt(torch.tensor(float(n_dim), dtype=dtype))
        self.sigma_0 = float(torch.tensor(2.38, dtype=dtype) / sqrt_d)
        self.sigma_cap = min(self.sigma_0, float(torch.tensor(0.99, dtype=dtype)))
        self.n_steps_min = float(n_steps * n_dim)
        self.n_steps_cap = float(n_max_steps * n_dim)

    # ------------------------------------------------------------------
    def prepare(self, assignments, beta, modes: ModeStatistics) -> Walkers:
        """Gather the per-walker mode quantities once per mutation, the
        matrices too where `gathers` holds for the walkers of every rank (and
        move the boundary masks to the walkers' device, outside any
        capture)."""
        dev = assignments.device
        self.periodic_mask, self.reflective_mask, self.strict_mask = (
            m.to(dev) for m in (self.periodic_mask, self.reflective_mask, self.strict_mask))
        k_max = modes.k_max
        dtype = modes.means.dtype
        onehot = (assignments[:, None] == torch.arange(k_max, device=assignments.device)).to(dtype)
        dof = modes.degrees_of_freedom[assignments]
        gamma_shape = None
        if self.is_tpcn:
            dof_all = dof if self.group is None else all_gather(dof, self.group, 0)
            gamma_shape = (self.n_dim + dof_all) / 2.0
        if gathers(assignments.shape[0] * self.world, self.n_dim):  # JAX counts every rank
            mats = dict(chol=modes.chol_covariances[assignments],
                        inv=modes.inv_covariances[assignments])
        else:
            mats = dict(chol_covariances=modes.chol_covariances,
                        inv_covariances=modes.inv_covariances)
        return Walkers(
            assignments=assignments,
            beta=torch.as_tensor(beta, dtype=dtype, device=assignments.device),
            mu=modes.means[assignments],
            dof=dof,
            onehot=onehot,
            count_k=_psum(torch.sum(onehot, dim=0), self.group),
            gamma_shape=gamma_shape,
            **mats,
        )

    def initial_state(self, u, x, logl, k_max: int, blobs=None) -> ChainState:
        sigma = self.sigma_cap if self.is_tpcn else self.sigma_0
        return ChainState(
            u=u, x=x, logl=logl, blobs=blobs,
            sigmas=torch.full((k_max,), sigma, dtype=u.dtype, device=u.device),
            iteration=torch.zeros((), dtype=torch.int32, device=u.device),
            alpha_mean=torch.zeros((), dtype=u.dtype, device=u.device),
            done=torch.zeros((), dtype=torch.bool, device=u.device),
        )

    def going(self, done: torch.Tensor, iteration: torch.Tensor) -> torch.Tensor:
        """Whether the chain takes another step: JAX's `cond`, not done
        (mcmc.py:280-281), and below the clamp's ceiling."""
        return ~done & (iteration < self.n_steps_cap)

    def _propose(self, w: Walkers, u, diff, sigma_w, scale_w, z):
        """First in-bounds of the R candidates per walker, and whether any was."""
        step = w.mode_step(z)  # z_rn @ L_{a(n)}^T
        if self.is_tpcn:
            cand = (
                w.mu
                + torch.sqrt(1.0 - sigma_w**2)[:, None] * diff
                + (sigma_w * scale_w)[:, None] * step
            )
        else:
            cand = u + sigma_w[:, None] * step
        dev = cand.device
        cand = apply_boundary_conditions(
            cand, self.periodic_mask.to(dev), self.reflective_mask.to(dev)
        )
        valid = check_bounds(cand, self.strict_mask.to(dev))  # (R, N)
        any_valid = torch.any(valid, dim=0)
        prop = cand[-1]
        for r in range(cand.shape[0] - 2, -1, -1):
            prop = torch.where(valid[r][:, None], cand[r], prop)
        return torch.where(any_valid[:, None], prop, cand[0]), any_valid

    def step(self, w: Walkers, s: ChainState, z, g, u_acc) -> ChainState:
        """One Metropolis step on explicit draws: z (R, N, d) normals, g (N,)
        unit gamma(w.gamma_shape) draws (tpCN; ignored for RWM), u_acc (N,)
        acceptance uniforms; under a mesh, this rank's blocks of them. A
        chain that is done stays as it is."""
        dtype = s.u.dtype
        active = self.going(s.done, s.iteration)
        iteration = s.iteration + 1
        sigmas = s.sigmas
        sigma_w = sigmas[w.assignments]
        diff = s.u - w.mu
        if self.is_tpcn:
            dot = w.quadratic(diff)
            g_scale = 2.0 / (w.dof + dot)
            scale_w = torch.sqrt(1.0 / (g * g_scale))
        else:
            scale_w = torch.ones_like(s.logl)

        u_prime, valid = self._propose(w, s.u, diff, sigma_w, scale_w, z)
        x_prime = self.prior_transform_batch(u_prime)
        # a host crossing calls nothing past the stop; the torch likelihoods ignore these
        logl_prime, blobs_prime = self.log_likelihood_batch(x_prime, active, s.logl, s.blobs)
        logl_prime = logl_prime.to(dtype)

        if self.is_tpcn:
            dot_p = w.quadratic(u_prime - w.mu)
            coeff = -0.5 * (self.n_dim + w.dof)
            factor = -coeff * torch.log1p(dot_p / w.dof) + coeff * torch.log1p(dot / w.dof)
        else:
            factor = torch.zeros_like(s.logl)

        alpha = torch.exp(w.beta * (logl_prime - s.logl) + factor)
        alpha = torch.nan_to_num(torch.clamp(alpha, max=1.0), nan=0.0)
        alpha = torch.where(valid, alpha, torch.zeros_like(alpha))

        accept = (u_acc < alpha) & active
        u = torch.where(accept[:, None], u_prime, s.u)
        x = torch.where(accept[:, None], x_prime, s.x)
        logl = torch.where(accept, logl_prime, s.logl)
        blobs = s.blobs
        if blobs is not None:
            blobs = torch.where(accept[:, None], blobs_prime, blobs)

        # Per-cluster Robbins-Monro adaptation toward 0.234, on sums over
        # every walker (one reduction over the ranks under a mesh).
        k_max = w.onehot.shape[1]
        sums = _psum(torch.cat([torch.sum(w.onehot * alpha[:, None], dim=0),
                                torch.stack([torch.sum(accept.to(dtype)), torch.sum(alpha)])]),
                     self.group)
        n_walkers = s.u.shape[0] * self.world
        alpha_k = sums[:k_max]
        mean_accept = sums[k_max] / n_walkers
        mean_alpha = sums[k_max + 1] / n_walkers
        mean_acc_k = alpha_k / torch.clamp(w.count_k, min=1.0)
        rate = 1.0 / (iteration.to(dtype) + 1.0)
        new_sigmas = sigmas + rate * (mean_acc_k - 0.234)
        if self.is_tpcn:
            new_sigmas = torch.clamp(new_sigmas, 0.0, self.sigma_cap)
        sigmas = torch.where((w.count_k > 0) & active, new_sigmas, sigmas)

        # Adaptive termination: population-weighted sigma over non-empty clusters.
        w_sigma = torch.sum(w.count_k * sigmas) / torch.clamp(torch.sum(w.count_k), min=1.0)
        n_adaptive = (
            self.n_steps_min
            * (0.234 / torch.clamp(mean_accept, min=0.01))
            * (self.sigma_0 / torch.clamp(w_sigma, min=1e-6)) ** 2
        )
        n_final = torch.clamp(n_adaptive, self.n_steps_min, self.n_steps_cap)
        return ChainState(
            u=u, x=x, logl=logl, blobs=blobs, sigmas=sigmas,
            iteration=torch.where(active, iteration, s.iteration),
            alpha_mean=torch.where(active, mean_alpha, s.alpha_mean),
            done=s.done | (iteration.to(dtype) >= n_final),
        )

    # ------------------------------------------------------------------
    def __call__(
        self, draws, u, x, logl, assignments, beta, modes: ModeStatistics, blobs=None,
        loops: Optional[Loops] = None,
    ) -> MCMCResult:
        """Run the adaptive chain to its stop rule, drawing from `draws`;
        `loops` runs the step loop (default: a read after every step)."""
        w = self.prepare(assignments, beta, modes)
        s = self.initial_state(u, x, logl, modes.k_max, blobs)
        n, d = u.shape
        loops = loops or Loops(u.device)
        keyed = getattr(draws, "keyed", False)
        if loops.graphed and not (keyed and draws.calls in loops.counters):
            raise ValueError("a graphed MCMC loop needs keyed draws (draws.Draws on a CUDA "
                             "device, or a draws.BlockDraws of them) whose call counter is "
                             "registered with its Loops (Loops.counters)")

        body = self.body(draws, n, d, keyed)
        if keyed and loops.graphed:
            # a host call that raised ends the chain after its step (`Loops.halt`)
            out = loops.repeat("mcmc", lambda c: loops.unhalted(self.pred(c), self.group), body,
                               _tensors(s), _tensors(w), static=(id(draws),))
        else:
            out = self._chunks(loops, draws, body, _tensors(s), _tensors(w), keyed)
        s = ChainState(**dict(out, blobs=out.get("blobs")))
        k_mask = modes.k_mask
        mean_sigma = torch.sum(torch.where(k_mask, s.sigmas, torch.zeros_like(s.sigmas))) / (
            torch.clamp(torch.sum(k_mask), min=1)
        )
        return MCMCResult(
            u=s.u, x=s.x, logl=s.logl, blobs=s.blobs,
            efficiency=mean_sigma / self.sigma_0,
            acceptance=s.alpha_mean,
            steps=s.iteration,
            n_call_sweeps=s.iteration,
        )

    def pred(self, carry) -> torch.Tensor:
        """The loop's predicate on its carry (`going`)."""
        return self.going(carry["done"], carry["iteration"])

    def body(self, draws, n: int, d: int, keyed: bool):
        """The loop body of the chain: one step on `draws`' next draws, on
        the carry and constants as dicts of tensors (`ChainState`,
        `Walkers`); a keyed step draws only while the chain goes on."""
        def body(c, k):
            state = ChainState(**dict(c, blobs=c.get("blobs")))
            extra = {"active": self.going(state.done, state.iteration)} if keyed else {}
            z, g, u_acc = draws.mcmc_step(self.n_candidates, n, d, k.get("gamma_shape"), **extra)
            return _tensors(self.step(Walkers(**k), state, z, g, u_acc))

        return body

    def _chunks(self, loops: Loops, draws, body, carry, consts, keyed: bool):
        """The chain as the chunked loop "mcmc" (never graphed: a graphed
        chain is keyed and takes `Loops.repeat`), the draws put back where a
        chunk ran past the stop (keyed draws need not be)."""
        run = loops.start("mcmc", body, carry, consts, static=(id(draws),))
        chunk = loops.chunk("mcmc")
        length = int(self.n_steps_min) if chunk > 1 else 1
        tell, seek = (None, None) if keyed else (getattr(draws, "tell", None),
                                                 getattr(draws, "seek", None))
        positions = []  # the draws' position before each step run
        ran = 0
        while True:
            ran += length
            if tell is None:
                run.advance(length)
            else:
                run.advance(length, before_body=lambda: positions.append(tell()))
            done, steps = run.read("done", "iteration")
            if done or steps >= self.n_steps_cap:
                break
            length = chunk
        steps = int(steps)
        loops.stats["mcmc"]["past_stop"] += ran - steps
        if steps < len(positions):  # the chunk ran past the stop
            seek(positions[steps])
        return run.result()
