"""tempest_tpu_torch on an NVIDIA GPU: the CUDA kernels and the sampler.

Every test here is marked `cuda` and skips on a host without a GPU. The
file imports neither jax nor tempest_tpu, so it also runs where JAX is not
installed; there, skip tests/conftest.py (which configures JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The ESS kernel must take as many probes as its plain version and end
within 1e-6 (relative) of its beta, or else on a beta whose plain ESS meets
the stop rule; and always within 2e-3, the documented drift between two
bisections that sum in different orders (tests/test_pallas.py:53-54).
Stay and jump are exact, with 2 probes, and two launches on the same
inputs give the same bits. Both routes of its
launch plan are held to it: slices in shared memory (S <= 393,216) and
slices streamed from L2 (S >= 393,217). Its float64 instantiation must
take the plain version's probes and end within 1e-12 (relative) of its
beta, on both routes (S <= 196,608 held, S >= 196,609 streamed); a float64
run launches it once per reweight and no PRNG kernel. The PRNG kernels
and their plain versions (ops/philox.py) on the card and on one key and
call index, at the tolerances of chip_smoke.py's kernel phase: bits
exactly equal, normals and uniforms within 1e-5 absolute, gamma draws
within 1e-5 relative except at most max(1, 1e-4 n) of them (a
Marsaglia-Tsang test that falls within float rounding of its bound may go
the other way when a math function's last bit differs). `hw_gamma` is one
launch of the gamma kernel and no normal or bits launch.

The fused route's loops (loops.py, fused.py): a replayed CUDA graph of each
loop chunk (the mode EM, the GMM EM and the split rounds' head and tail, the
MCMC steps) gives the eager chunk's values bit for bit and draws the eager
step's numbers; the ESS kernel captures, and each replay counts its launch;
`run(on_device=True)` repeats `on_device=False` bit for bit; a likelihood
that reads the host fails its capture with an error naming on_device=False.
With `hardware_prng=True` in float32 the PRNG kernels read their call
counter from the device (`cuda_prng.PhiloxCounter`): on each of the three
routes of `HardwareDraws` (thresholds lowered) a graphed MCMC loop and a
graphed run repeat the eager ones bit for bit, with the same kernel
launches and the same final call counter on the host and on the device,
and a capture leaves the counter where it was.

The eigenvalue kernel (`ops.cuda_linalg`, csrc/sym_eigvals.cu) against
torch.linalg.eigvalsh of the float64 copy at d = 1 to 240 (each side of
the last d held in shared memory in either type: past it, the
global-workspace route), on SPD, indefinite, rank-deficient and diagonal
matrices in float32 and float64, within 16 d eps max|lambda|; the CV's
rank decision equal; NaN out for a non-finite matrix; a launch captured in
a graph replays to the eager launch's bits. Dynamic mode and a mesh of one rank
over NCCL (in a process of its own) repeat `on_device=False` bit for bit
with `on_device=True`; dynamic mode's ESS bracket is one launch of the ESS
kernel's bracket mode a reweight.

The weighted-median kernel (`ops.cuda_median`, csrc/weighted_median.cu)
equals its plain version (torch.cumsum's serial sums, the first crossing,
a gather) bit for bit, in float32 and float64, at A's (16, 4096, 10), B's
(1, 524,288, 10) and rosenbrock100's (1, 8192, 100) shapes and on ragged
shapes with all-zero rows (which give d_sorted[0]); a fit launches it once.
The bracket mode of the ESS kernel (`cuda_reweight.ess_bracket`) against
its plain version, the "ess_bracket" loop (`steps.reweight.ess_bracket_loop`)
on the same CUDA tensors, on the histories of tests/test_torch_dynamic.py
and at S = 196,608 (held on chip: dynamic mode's 1024 x 192 history with 48
rows filled, and one all filled), 524,288 and 1,048,576 (streamed): the same
probes; stay and jump exact; in float64 each end within 1e-12 (relative);
in float32 the same ends, or else the plain ESS at the first midpoint
decided the other way within 1e-5 (relative) of the target (the kernel's
s1^2 / s2 rounds otherwise than the plain version's normalised ESS), and
the ends always within 2e-3.

The EM kernels (`ops.cuda_em`, csrc/gmm_em.cu and csrc/mvstud_em.cu)
against their plain loops, the "gmm_em" and "mode_em" device loops on the
same CUDA tensors, by chip_smoke.py's rule (stated above its EM_STEP_RTOL;
each kernel iteration against one plain body from the kernel's state, then
the whole fit): the GMM EM at
A's leaf fits, every covariance type, K = 1, 2 and 16, a leaf with all-zero
weights, an indefinite start (the sqrt(reg) I factor) and an exit at
max_iter; the Student-t EM at A's, the unclustered paths', B's and
rosenbrock100's (K, n, d), a mode with all-zero weights, a singular start
(the diagonal floor), an exit at max_iter and the Gaussian-limit exit; in
float32 and float64; the CTA size of 256 threads, which the launch plan
takes in float32 only, in float64 from sources edited to take it always;
one launch a loop, two launches the same bits, and a graph replay equal to
an eager launch, counted as a launch, with no read.
"""

import json
import math
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from tempest_tpu_torch import Sampler
from tempest_tpu_torch import cluster as tc
from tempest_tpu_torch import draws as draws_mod
from tempest_tpu_torch import modes as tm
from tempest_tpu_torch.config import ESS_TOLERANCE, METRIC_ATOL
from tempest_tpu_torch.draws import Draws, HardwareDraws
from tempest_tpu_torch.fused import CHUNKS
from tempest_tpu_torch.loops import Loops
from tempest_tpu_torch.mcmc import MCMCKernel
from tempest_tpu_torch.ops import cuda_prng, cuda_reweight, philox, tools
from tempest_tpu_torch.ops.tools import ess_from_logw, logsumexp
from tempest_tpu_torch.state import commit, make_current, make_history, mis_denominator
from tempest_tpu_torch.steps import reweight as rw_mod


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _ess(logl, bm, beta) -> float:
    keep = torch.isfinite(logl) & (bm != float("inf"))
    logw = torch.where(keep, beta * logl - bm, torch.full_like(logl, float("-inf")))
    return float(ess_from_logw(logw - logsumexp(logw)))


def _assert_beta_matches(logl, bm, scal, got, want):
    """(beta, probes) of the kernel against the plain version's."""
    (bk, pk), (br, pr) = [(b.item(), p.item()) for b, p in (got, want)]
    assert pk == pr, (bk, pk, br, pr)
    if pr == 2:  # stay or jump
        assert bk == br
        return
    target = scal[1].item()
    close = abs(bk - br) <= 1e-6 * max(abs(br), 1e-30)
    stops = abs(_ess(logl, bm, bk) - target) < max(ESS_TOLERANCE * abs(target), METRIC_ATOL)
    assert abs(bk - br) < 2e-3 and (close or stops), (bk, br, pr)


def _synthetic(device, cap, N, t_fill, seed, dtype=torch.float32):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    h = make_history(cap, N, 2, dtype=dtype, device=device)
    c = make_current(N, 2, dtype=dtype, device=device)
    for t in range(t_fill):
        c.logl = -torch.exp(1.0 + 2.0 * torch.randn(N, generator=g, device=device, dtype=dtype))
        c.beta = torch.tensor(0.0 if t < 2 else 0.01 * t, device=device, dtype=dtype)
        c.logz = torch.tensor(-0.2 * t, device=device, dtype=dtype)
        commit(h, c)
    inf = torch.tensor(float("inf"), device=device, dtype=dtype)
    bm = torch.where(h.sample_mask(), mis_denominator(h), inf)
    return h.logl.reshape(-1).contiguous(), bm.reshape(-1).contiguous()


ON_CHIP_MAX = cuda_reweight.ESS_CLUSTER * cuda_reweight.ESS_SLICE_MAX  # 393,216


@pytest.mark.cuda
@pytest.mark.parametrize(
    "cap,N,t_fill,S",
    [
        (64, 1024, 40, None),  # the canonical S = 65,536
        (7, 1000, 5, None),  # ragged
        (8, 64, 2, None),  # tiny, unfilled slots
        (8, 49152, 6, ON_CHIP_MAX),  # the last S held on chip
        (8, 49153, 6, ON_CHIP_MAX + 1),  # the first S streamed
        (8, 131072, 8, None),  # B's S = 1,048,576
    ],
)
def test_kernel_matches_plain_version(cuda_device, cap, N, t_fill, S):
    logl, bm = _synthetic(cuda_device, cap, N, t_fill, seed=cap)
    if S is not None:
        logl, bm = logl[:S], bm[:S]
    plan = cuda_reweight.plan_launch(logl.numel())
    assert plan.resident == (logl.numel() <= ON_CHIP_MAX)
    before = cuda_reweight.LAUNCHES
    bp = 0.0 if t_fill < 3 else 0.01 * (t_fill - 1)  # the last committed beta
    cur, one = _ess(logl, bm, bp), _ess(logl, bm, 1.0)
    assert cur > 1.01 * one
    cases = [(bp, 1.5 * cur), (bp, 0.5 * one), (bp, (cur * one) ** 0.5), (0.0, 2.0 * N),
             (0.1, 0.5)]
    kinds = set()
    for beta_prev, target in cases:
        scal = torch.tensor([beta_prev, target], device=cuda_device)
        beta_k, probes_k = cuda_reweight.ess_bisect_beta(logl, bm, scal)
        again, _ = cuda_reweight.ess_bisect_beta(logl, bm, scal)
        beta_r, probes_r = cuda_reweight.ess_bisect_beta_reference(logl, bm, scal)
        torch.cuda.synchronize()
        assert torch.equal(beta_k.view(torch.int32), again.view(torch.int32))  # same bits
        _assert_beta_matches(logl, bm, scal, (beta_k, probes_k), (beta_r, probes_r))
        if probes_r.item() == 2:
            kinds.add("stay" if beta_r.item() == scal[0].item() else "jump")
        else:
            kinds.add("bisect")
    assert kinds == {"stay", "jump", "bisect"}
    assert cuda_reweight.LAUNCHES == before + 2 * len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [65536, ON_CHIP_MAX + 1])
def test_kernel_with_every_sample_dropped(cuda_device, S):
    """No finite logl: ESS is NaN everywhere and counts as 1e10, as in the
    plain version, which then bisects up to its bracket tolerance."""
    logl = torch.full((S,), float("-inf"), device=cuda_device)
    bm = torch.zeros(S, device=cuda_device)
    scal = torch.tensor([0.25, 100.0], device=cuda_device)
    got = cuda_reweight.ess_bisect_beta(logl, bm, scal)
    want = cuda_reweight.ess_bisect_beta_reference(logl, bm, scal)
    torch.cuda.synchronize()
    assert want[1].item() > 2
    _assert_beta_matches(logl, bm, scal, got, want)


@pytest.mark.cuda
def test_kernel_takes_unaligned_views(cuda_device):
    """A view that starts one float in is not 16-byte aligned: the kernel
    reads it by scalar loads, on both routes."""
    logl, bm = _synthetic(cuda_device, 8, 49153, 6, seed=3)
    for S in (65535, ON_CHIP_MAX + 3):
        lv, bv = logl[1:S + 1], bm[1:S + 1]
        scal = torch.tensor([0.0, 2.0 * 49153], device=cuda_device)
        got = cuda_reweight.ess_bisect_beta(lv, bv, scal)
        want = cuda_reweight.ess_bisect_beta_reference(lv, bv, scal)
        torch.cuda.synchronize()
        _assert_beta_matches(lv, bv, scal, got, want)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    logl, bm = _synthetic(cuda_device, 4, 32, 3, seed=1)
    scal = torch.tensor([0.0, 64.0], device=cuda_device)
    with pytest.raises(ValueError):
        cuda_reweight.ess_bisect_beta(logl.half(), bm.half(), scal.half())
    with pytest.raises(ValueError):  # one dtype for all three
        cuda_reweight.ess_bisect_beta(logl.double(), bm.double(), scal)
    with pytest.raises(ValueError):
        cuda_reweight.ess_bisect_beta(logl[::2], bm[::2], scal)
    with pytest.raises(ValueError):
        cuda_reweight.ess_bisect_beta(logl, bm.cpu(), scal)


ON_CHIP_MAX_F64 = cuda_reweight.ESS_CLUSTER * cuda_reweight.slice_max(torch.float64)  # 196,608


@pytest.mark.cuda
@pytest.mark.parametrize(
    "cap,N,t_fill,S",
    [
        (64, 1024, 40, None),  # the canonical S = 65,536
        (7, 1000, 5, None),  # ragged
        (8, 24576, 8, ON_CHIP_MAX_F64),  # the last float64 S held on chip
        (8, 24577, 8, ON_CHIP_MAX_F64 + 1),  # the first streamed
        (8, 131072, 8, None),  # B's S = 1,048,576
    ],
)
def test_float64_kernel_matches_plain_version(cuda_device, cap, N, t_fill, S):
    logl, bm = _synthetic(cuda_device, cap, N, t_fill, seed=cap, dtype=torch.float64)
    if S is not None:
        logl, bm = logl[:S], bm[:S]
    assert cuda_reweight.plan_launch(logl.numel(), torch.float64).resident == (
        logl.numel() <= ON_CHIP_MAX_F64)
    before = cuda_reweight.LAUNCHES_F64
    bp = 0.01 * (t_fill - 1)
    cur, one = _ess(logl, bm, bp), _ess(logl, bm, 1.0)
    cases = [(bp, 1.5 * cur), (bp, 0.5 * one), (bp, (cur * one) ** 0.5), (0.0, 2.0 * N)]
    kinds = set()
    for beta_prev, target in cases:
        scal = torch.tensor([beta_prev, target], device=cuda_device, dtype=torch.float64)
        beta_k, probes_k = cuda_reweight.ess_bisect_beta(logl, bm, scal)
        again, _ = cuda_reweight.ess_bisect_beta(logl, bm, scal)
        beta_r, probes_r = cuda_reweight.ess_bisect_beta_reference(logl, bm, scal)
        torch.cuda.synchronize()
        assert beta_k.dtype == torch.float64
        assert torch.equal(beta_k.view(torch.int64), again.view(torch.int64))  # same bits
        bk, br = beta_k.item(), beta_r.item()
        assert probes_k.item() == probes_r.item(), (bk, br)
        assert abs(bk - br) <= 1e-12 * abs(br), (bk, br)
        kinds.add("bisect" if probes_r.item() > 2 else ("stay" if br == bp else "jump"))
    assert kinds == {"stay", "jump", "bisect"}
    assert cuda_reweight.LAUNCHES_F64 == before + 2 * len(cases)


@pytest.mark.cuda
def test_float64_sampler_runs_through_the_double_kernel(cuda_device):
    def loglike(x):
        return -0.5 * torch.sum(x * x, dim=-1)

    s = Sampler(lambda u: 20.0 * u - 10.0, loglike, n_dim=4, n_particles=256, vectorize=True,
                random_state=1, history_capacity=32, dtype=torch.float64, hardware_prng=True,
                device=cuda_device)
    before = (cuda_reweight.LAUNCHES, cuda_reweight.LAUNCHES_F64, dict(cuda_prng.LAUNCHES))
    s.run(n_total=1024)
    assert s.state.hist.logl.dtype == torch.float64
    assert cuda_reweight.LAUNCHES == before[0]
    assert cuda_reweight.LAUNCHES_F64 - before[1] == s.state.hist.t - 1
    assert cuda_prng.LAUNCHES == before[2]
    assert s.beta >= 1.0 - 1e-4
    assert abs(s.evidence()[0] - (-4 * math.log(20.0) + 2 * math.log(2 * math.pi))) < 0.5


@pytest.mark.cuda
def test_sampler_runs_through_the_kernel(cuda_device):
    def loglike(x):
        return -0.5 * torch.sum(x * x, dim=-1)

    s = Sampler(lambda u: 20.0 * u - 10.0, loglike, n_dim=4, n_particles=256, vectorize=True,
                clustering=False, random_state=1, history_capacity=32, device=cuda_device)
    before = cuda_reweight.LAUNCHES
    s.run(n_total=1024)
    assert s.state.hist.logl.is_cuda
    assert cuda_reweight.LAUNCHES - before == s.state.hist.t - 1
    assert s.beta >= 1.0 - 1e-4
    assert abs(s.evidence()[0] - (-4 * math.log(20.0) + 2 * math.log(2 * math.pi))) < 0.5


KEY = philox.key_from_seed(42)


def _gamma_mismatches(got, want):
    return int(torch.sum(torch.abs(got - want) > 1e-5 * torch.abs(want)))


@pytest.mark.cuda
# 8 x 131072 x 10 is the large-ensemble path's R*N*d: several grid-stride
# passes per thread.
@pytest.mark.parametrize("total", [1 << 20, 1001, 8 * 131072 * 10])
def test_normal_and_bits_kernels_match_plain(cuda_device, total):
    before = dict(cuda_prng.LAUNCHES)
    z = cuda_prng.hw_normal(KEY, 3, (total,), cuda_device)
    b = cuda_prng.hw_bits(KEY, 4, (total,), cuda_device)
    torch.cuda.synchronize()
    assert torch.equal(b, philox.bits(KEY, 4, total, cuda_device))
    assert float(torch.max(torch.abs(z - philox.normal(KEY, 3, total, cuda_device)))) <= 1e-5
    u = cuda_prng.hw_uniform(KEY, 4, (total,), cuda_device)
    assert float(u.min()) > 0.0 and float(u.max()) <= 1.0
    assert cuda_prng.LAUNCHES["normal"] == before["normal"] + 1
    assert cuda_prng.LAUNCHES["bits"] == before["bits"] + 2


GAMMA_ALPHAS = (0.02, 0.5, 0.7, 1.5, 7.5, 50.0)


@pytest.mark.cuda
# Ragged blocks of 4, B's N (2^17), B's N + 3 and 2^18; each alpha, and all
# six in turn. The 13 call indices cross 2^32, the counter's high word.
@pytest.mark.parametrize("n", [1, 3, 5, 1000, 131072, 131075, 262144])
@pytest.mark.parametrize("a", GAMMA_ALPHAS + ("mixed",))
def test_gamma_matches_plain(cuda_device, n, a):
    if a == "mixed":
        alpha = torch.tensor(GAMMA_ALPHAS, device=cuda_device).repeat(-(-n // 6))[:n].contiguous()
    else:
        alpha = torch.full((n,), a, device=cuda_device)
    counter = (1 << 32) - 5
    before = dict(cuda_prng.LAUNCHES)
    g = cuda_prng.hw_gamma(KEY, counter, alpha)
    after = dict(cuda_prng.LAUNCHES)
    want = philox.gamma(KEY, counter, alpha)
    torch.cuda.synchronize()
    assert {k: after[k] - before[k] for k in after} == {
        "mutation_draws": 0, "normal": 0, "bits": 0, "gamma": 1}
    assert g.shape == alpha.shape and g.dtype == torch.float32
    assert bool(torch.all(torch.isfinite(g) & (g >= 0.0)))  # U^(1/0.02) may underflow to 0
    assert _gamma_mismatches(g, want) <= max(1, 1e-4 * n)
    if n >= 131072 and a in (0.5, 1.5, 7.5, 50.0):
        assert float(g.min()) > 0.0 and abs(float(g.mean()) - a) < 5 * (a / n) ** 0.5 + 0.01


@pytest.mark.cuda
def test_gamma_rejects_what_it_does_not_take(cuda_device):
    alpha = torch.full((1001,), 2.5, device=cuda_device)
    for bad in (alpha.double(), alpha[::2], alpha.reshape(7, 143).t()):
        with pytest.raises(ValueError):
            cuda_prng.hw_gamma(KEY, 0, bad)
    with pytest.raises(ValueError):  # call indices past 2^64 - 1
        cuda_prng.hw_gamma(KEY, (1 << 64) - philox.GAMMA_CALLS + 1, alpha)
    # A contiguous view that starts one float in: alpha is read by scalar loads.
    view = alpha[1:]
    got = cuda_prng.hw_gamma(KEY, 3, view)
    want = philox.gamma(KEY, 3, view)
    torch.cuda.synchronize()
    assert _gamma_mismatches(got, want) <= 1


@pytest.mark.cuda
# (8, 6553, 10): the largest shape the fused route takes (R N d <= 2^19).
@pytest.mark.parametrize("R,N,d", [(8, 1024, 10), (8, 1000, 10), (8, 6553, 10)])
def test_mutation_draws_kernel_matches_plain(cuda_device, R, N, d):
    # alpha above 1, below 1 (boosted), and small enough that later rounds
    # decide (tests/test_torch_launch.py checks that they do for these draws)
    third = N // 3
    alpha = torch.cat([torch.full((third,), 7.5), torch.full((third,), 0.7),
                       torch.full((N - 2 * third,), 0.02)]).to(cuda_device)
    before = cuda_prng.LAUNCHES["mutation_draws"]
    z, g, u = cuda_prng.hw_mutation_draws(KEY, 5, alpha, (R, N, d))
    wz, wg, wu = philox.mutation_draws(KEY, 5, alpha, (R, N, d))
    torch.cuda.synchronize()
    assert cuda_prng.LAUNCHES["mutation_draws"] == before + 1
    assert z.shape == (R, N, d) and g.shape == u.shape == (N,)
    assert float(torch.max(torch.abs(z - wz))) <= 1e-5
    assert float(torch.max(torch.abs(u - wu))) <= 1e-5
    assert _gamma_mismatches(g, wg) <= max(1, 1e-4 * N)
    with pytest.raises(ValueError):
        cuda_prng.hw_mutation_draws(KEY, 5, alpha.double(), (R, N, d))


@pytest.mark.cuda
def test_sampler_runs_hardware_prng_through_the_kernel(cuda_device):
    def loglike(x):
        return -0.5 * torch.sum(x * x, dim=-1)

    s = Sampler(lambda u: 20.0 * u - 10.0, loglike, n_dim=4, n_particles=256, vectorize=True,
                hardware_prng=True, random_state=1, history_capacity=32, device=cuda_device)
    before = dict(cuda_prng.LAUNCHES)
    s.run(n_total=1024)
    res = s.results()
    steps = int(res["steps"][res["beta"] > 0].sum())
    assert cuda_prng.LAUNCHES["mutation_draws"] - before["mutation_draws"] == steps
    assert cuda_prng.LAUNCHES["normal"] == before["normal"]
    assert s.beta >= 1.0 - 1e-4
    assert abs(s.evidence()[0] - (-4 * math.log(20.0) + 2 * math.log(2 * math.pi))) < 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65536, 196608, 1048576])
def test_cumsum_same_bits_on_every_call(cuda_device, n):
    # torch.cumsum of one long CUDA vector is not: the resampling CDF of a
    # 192 x 1024 history moved between calls, and with it a seeded run.
    g = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.rand(n, generator=g, device=cuda_device)
    first = tools.cumsum(x)
    for _ in range(20):
        assert torch.equal(tools.cumsum(x), first)
    want = torch.cumsum(x.double(), dim=0)
    assert float(torch.max(torch.abs(first.double() - want) / want)) < 1e-6


@pytest.mark.cuda
def test_seeded_run_repeats_on_the_card(cuda_device):
    def loglike(x):
        return -0.5 * torch.sum(x * x, dim=-1)

    runs = []
    for _ in range(2):
        s = Sampler(lambda u: 20.0 * u - 10.0, loglike, n_dim=4, n_particles=512,
                    vectorize=True, clustering=False, volume_variation=1.0, random_state=3,
                    history_capacity=256, device=cuda_device)
        s.run(n_total=2048)
        runs.append(s.results())
    assert runs[0]["beta"].tobytes() == runs[1]["beta"].tobytes()
    assert runs[0]["logz"].tobytes() == runs[1]["logz"].tobytes()


# ---------------------------------------------------------------------------
# The fused route's loops as CUDA graphs
# ---------------------------------------------------------------------------
def _loops(device, graphs, generators=(), counters=()):
    return Loops(device, CHUNKS, graphs=graphs, generators=list(generators),
                 counters=list(counters))


# HardwareDraws' routes at N walkers and R N d normals, by threshold:
# "mutation" the mutation-draws kernel (tpCN), "large" the gamma and normal
# kernels, "below" the generator alone.
def _hw_route(monkeypatch, route, n, n_z):
    values = {"mutation": (1 << 19, 1 << 16, 1 << 20), "large": (0, n, n_z),
              "below": (0, n + 1, n_z + 1)}[route]
    for name, value in zip(("FUSED_DRAWS_MAX_ELEMS", "HW_GAMMA_MIN_WALKERS",
                            "HW_NORMAL_MIN_ELEMS"), values):
        monkeypatch.setattr(draws_mod, name, value)


def _points(device, seed, n=4096, d=10, k=3):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    centers = 4.0 * torch.randn(k, d, generator=g, device=device)
    labels = torch.randint(0, k, (n,), generator=g, device=device, dtype=torch.int32)
    x = centers[labels] + torch.randn(n, d, generator=g, device=device) / torch.sqrt(
        torch.rand(n, 1, generator=g, device=device) + 0.2)
    return x, torch.rand(n, generator=g, device=device) + 0.1, labels


@pytest.mark.cuda
def test_graphed_mode_fits_equal_eager(cuda_device):
    graphed = _loops(cuda_device, True)
    for seed in (1, 2):  # the second call replays the first call's graphs
        x, w, labels = _points(cuda_device, seed)
        want = tm.fit_mode_statistics(x, w, labels, k_max=8, loops=_loops(cuda_device, False))
        got = tm.fit_mode_statistics(x, w, labels, k_max=8, loops=graphed)
        for name in ("means", "covariances", "degrees_of_freedom", "inv_covariances",
                     "chol_covariances", "k_mask"):
            assert torch.equal(getattr(got, name), getattr(want, name)), (seed, name)
    stats = graphed.stats["mode_em"]  # one kernel launch a fit, as one replay, no read
    assert stats["captures"] == 1 and stats["replays"] == 2 and stats["reads"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("split_all", [True, False])
def test_graphed_split_rounds_equal_eager(cuda_device, split_all):
    graphed = _loops(cuda_device, True)
    for seed in (3, 4):
        x, w, _ = _points(cuda_device, seed, n=8192)
        mask = torch.ones(x.shape[0], dtype=torch.bool, device=cuda_device)
        args = dict(min_points=20, threshold_modifier=1.0, k_max=16, max_rounds=15,
                    normalize=True, split_all=split_all, leaf_fit_points=2048)
        model_e, labels_e, n_e = tc.hgm_fit(x, w, mask, loops=_loops(cuda_device, False), **args)
        model_g, labels_g, n_g = tc.hgm_fit(x, w, mask, loops=graphed, **args)
        assert n_g == n_e >= 2 and torch.equal(labels_g, labels_e)
        for name in ("centers", "covariances", "weights", "k_mask", "chol_inv", "logdet"):
            assert torch.equal(getattr(model_g, name), getattr(model_e, name)), (seed, name)
    for name in ("gmm_em", "split_head", "split_tail"):
        assert graphed.stats[name]["captures"] >= 1 and graphed.stats[name]["replays"] >= 2, name


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["tpcn", "rwm"])
def test_graphed_mcmc_equals_eager(cuda_device, method):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(7)
    n, d = 1024, 10
    u = 0.5 + 0.02 * torch.randn(n, d, generator=g, device=cuda_device)
    modes = tm.make_mode_statistics(torch.full((d,), 0.5, device=cuda_device),
                                    1e-2 * torch.eye(d, device=cuda_device),
                                    torch.tensor(6.0, device=cuda_device))

    def loglike(x):  # proposals wider than the target: the chain runs past n_steps d
        return -8.0 * torch.sum(x * x, dim=-1)

    kernel = MCMCKernel(lambda x: (loglike(x), None), lambda v: 20.0 * v - 10.0, d,
                        method=method)
    x = 20.0 * u - 10.0
    assign = torch.zeros(n, dtype=torch.int32, device=cuda_device)
    beta = torch.tensor(0.3, device=cuda_device)
    draws = Draws(11, cuda_device)
    graphed = _loops(cuda_device, True, [draws.generator])
    for _ in range(2):  # the second run replays the first run's graphs
        start = draws.tell()
        want = kernel(draws, u, x, loglike(x), assign, beta, modes,
                      loops=_loops(cuda_device, False))
        end = draws.tell()
        draws.seek(start)
        got = kernel(draws, u, x, loglike(x), assign, beta, modes, loops=graphed)
        assert draws.tell() == end
        assert got.steps == want.steps > kernel.n_steps_min
        for name in ("u", "x", "logl", "efficiency", "acceptance"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert graphed.stats["mcmc"]["captures"] >= 2  # the first chunk and a later one


@pytest.mark.cuda
def test_graphed_draws_are_the_eager_steps_draws(cuda_device):
    draws = Draws(13, cuda_device)
    shape = torch.full((1024,), 7.5, device=cuda_device)

    def body(c, k):
        z, g, u = draws.mcmc_step(8, 1024, 10, k["shape"])
        return dict(z=z, g=g, u=u, go=c["go"])

    carry = dict(z=torch.zeros(8, 1024, 10, device=cuda_device),
                 g=torch.zeros(1024, device=cuda_device), u=torch.zeros(1024, device=cuda_device),
                 go=torch.ones((), dtype=torch.bool, device=cuda_device))
    start = draws.tell()
    eager = [draws.mcmc_step(8, 1024, 10, shape) for _ in range(3)]
    step = (draws.tell() - start) // 3
    draws.seek(start)
    run = _loops(cuda_device, True, [draws.generator]).start("draws", body, carry,
                                                               dict(shape=shape))
    for i, (z, g, u) in enumerate(eager):
        run.advance(1)
        assert draws.tell() == start + (i + 1) * step
        assert torch.equal(run.carry["z"], z) and torch.equal(run.carry["g"], g)
        assert torch.equal(run.carry["u"], u)


@pytest.mark.cuda
def test_ess_kernel_captures_and_counts_replays(cuda_device):
    logl, bm = _synthetic(cuda_device, 64, 1024, 20, seed=5)
    scal = torch.tensor([0.05, 2048.0], device=cuda_device)
    want = cuda_reweight.ess_bisect_beta(logl, bm, scal)
    loops = _loops(cuda_device, True)

    def bisect(k):
        beta, probes = cuda_reweight.ess_bisect_beta(k["logl"], k["bm"], k["scal"])
        return dict(beta=beta, probes=probes)

    before = cuda_reweight.LAUNCHES
    for _ in range(3):
        got = loops.once("ess", bisect, dict(logl=logl, bm=bm, scal=scal))
        assert torch.equal(got["beta"], want[0]) and torch.equal(got["probes"], want[1])
    assert cuda_reweight.LAUNCHES - before == 3  # the replays; not the capture or its warm-up
    assert loops.stats["ess"]["captures"] == 1 and loops.stats["ess"]["replays"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    dict(clustering=True), dict(clustering=False),
    # The fused route in float64, where hardware_prng does not apply: its
    # graphed MCMC chunks put the draws back by the generator's offset.
    dict(clustering=True, hardware_prng=True, dtype=torch.float64),
], ids=["clustered", "unclustered", "float64-hardware_prng"])
def test_run_on_device_repeats_on_device_false(cuda_device, extra):
    def loglike(x):  # paired 4-D Rosenbrock: chains run past their first chunk
        return -torch.sum(100.0 * (x[..., 1::2] - x[..., ::2] ** 2) ** 2
                          + (1.0 - x[..., ::2]) ** 2, dim=-1)

    runs, launches = [], []
    for on_device in (False, True):
        s = Sampler(lambda u: 20.0 * u - 10.0, loglike, n_dim=4, n_particles=256,
                    vectorize=True, k_max=4, random_state=2, history_capacity=32,
                    device=cuda_device, **extra)
        before = cuda_reweight.LAUNCHES + cuda_reweight.LAUNCHES_F64
        s.run(n_total=1024, progress=False, on_device=on_device)
        launches.append(cuda_reweight.LAUNCHES + cuda_reweight.LAUNCHES_F64 - before)
        runs.append(s)
    (off, on), (r_off, r_on) = runs, (runs[0].results(), runs[1].results())
    for name in ("beta", "logz", "steps", "calls"):
        assert r_on[name].tobytes() == r_off[name].tobytes(), name
    assert on.evidence()[0] == off.evidence()[0] and launches[0] == launches[1] > 0
    assert r_on["steps"].max() > 4  # past the first chunk (n_steps d = 4 steps)
    assert (on.state.draws.get_state()["generator"].tobytes()
            == off.state.draws.get_state()["generator"].tobytes())
    stats = on.state._iteration.loops.stats
    assert stats["mcmc"]["replays"] > 0 and off.state._iteration.loops.stats["mcmc"]["replays"] == 0


@pytest.mark.cuda
def test_per_point_likelihood_with_blobs_captures(cuda_device):
    """The reference's default call form, a per-point function mapped by
    torch.func.vmap, with blobs: its MCMC steps replay as graphs too."""
    def loglike(x):
        return -0.5 * torch.sum(x * x), torch.sum(x * x)

    runs = []
    for on_device in (False, True):
        s = Sampler(lambda u: 20.0 * u - 10.0, loglike, n_dim=4, n_particles=256, k_max=4,
                    random_state=2, history_capacity=32, device=cuda_device)
        s.run(n_total=1024, progress=False, on_device=on_device)
        runs.append(s)
    assert runs[0].results()["logz"].tobytes() == runs[1].results()["logz"].tobytes()
    assert runs[1].state._iteration.loops.stats["mcmc"]["replays"] > 0
    _, _, _, r2 = runs[1].posterior(return_blobs=True)
    x = runs[1].posterior()[0]
    assert torch.allclose(torch.as_tensor(r2).reshape(-1), torch.as_tensor(x * x).sum(1),
                          rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["mutation", "large", "below"])
def test_graphed_hardware_prng_mcmc_equals_eager(cuda_device, route, monkeypatch):
    n, d = 1024, 10
    _hw_route(monkeypatch, route, n, 8 * n * d)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(7)
    u = 0.5 + 0.02 * torch.randn(n, d, generator=g, device=cuda_device)
    modes = tm.make_mode_statistics(torch.full((d,), 0.5, device=cuda_device),
                                    1e-2 * torch.eye(d, device=cuda_device),
                                    torch.tensor(6.0, device=cuda_device))

    def loglike(x):  # proposals wider than the target: the chain runs past n_steps d
        return -8.0 * torch.sum(x * x, dim=-1)

    kernel = MCMCKernel(lambda x: (loglike(x), None), lambda v: 20.0 * v - 10.0, d)
    x = 20.0 * u - 10.0
    assign = torch.zeros(n, dtype=torch.int32, device=cuda_device)
    beta = torch.tensor(0.3, device=cuda_device)
    draws = HardwareDraws(11, cuda_device)
    graphed = _loops(cuda_device, True, [draws.generator], [draws.calls])
    per_step = {"mutation": 1, "large": philox.GAMMA_CALLS + 1, "below": 0}[route]
    for _ in range(2):  # the second run replays the first run's graphs
        start = draws.tell()
        before = dict(cuda_prng.LAUNCHES)
        want = kernel(draws, u, x, loglike(x), assign, beta, modes,
                      loops=_loops(cuda_device, False))
        eager = {k: v - before[k] for k, v in cuda_prng.LAUNCHES.items()}
        end = draws.tell()
        draws.seek(start)
        before = dict(cuda_prng.LAUNCHES)
        got = kernel(draws, u, x, loglike(x), assign, beta, modes, loops=graphed)
        replayed = {k: v - before[k] for k, v in cuda_prng.LAUNCHES.items()}
        assert draws.tell() == end and draws.calls.read() == (end[1], draws.key)
        assert end[1] - start[1] == per_step * want.steps
        assert replayed == eager
        assert got.steps == want.steps > kernel.n_steps_min
        for name in ("u", "x", "logl", "efficiency", "acceptance"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert graphed.stats["mcmc"]["captures"] >= 2 and graphed.stats["mcmc"]["replays"] >= 4


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["mutation", "large"])
def test_capture_leaves_the_call_counter(cuda_device, route, monkeypatch):
    n, d = 1024, 10
    _hw_route(monkeypatch, route, n, 8 * n * d)
    draws = HardwareDraws(13, cuda_device)
    draws.calls.seek(1 << 32)  # the counter's high word in use
    shape = torch.full((n,), 7.5, device=cuda_device)

    def body(c, k):
        z, g, u = draws.mcmc_step(8, n, d, k["shape"])
        return dict(z=z, g=g, u=u, go=c["go"])

    start = draws.tell()
    eager = [draws.mcmc_step(8, n, d, shape) for _ in range(2)]
    per_step = (draws.counter - start[1]) // 2
    assert per_step == {"mutation": 1, "large": philox.GAMMA_CALLS + 1}[route]
    draws.seek(start)
    carry = dict(z=torch.zeros(8, n, d, device=cuda_device), g=torch.zeros(n, device=cuda_device),
                 u=torch.zeros(n, device=cuda_device),
                 go=torch.ones((), dtype=torch.bool, device=cuda_device))
    loops = _loops(cuda_device, True, [draws.generator], [draws.calls])
    run = loops.start("draws", body, carry, dict(shape=shape))
    launches = dict(cuda_prng.LAUNCHES)
    loops._graph(run._key, body, run.carry, run.consts, 1)  # capture only
    torch.cuda.synchronize()
    assert draws.tell() == start and draws.calls.read() == (start[1], draws.key)
    assert cuda_prng.LAUNCHES == launches
    for i, (z, g, u) in enumerate(eager):
        run.advance(1)  # a replay of the captured step
        assert draws.tell()[1] == start[1] + (i + 1) * per_step
        assert draws.calls.read() == (draws.counter, draws.key)
        assert torch.equal(run.carry["z"], z) and torch.equal(run.carry["u"], u)
        assert torch.equal(run.carry["g"], g)
    kernel = "mutation_draws" if route == "mutation" else "gamma"
    assert cuda_prng.LAUNCHES[kernel] == launches[kernel] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["mutation", "large", "below"])
def test_hardware_prng_run_on_device_repeats_on_device_false(cuda_device, route, monkeypatch):
    """A whole float32 hardware_prng run (N = 256, d = 4, R N d = 8,192) on
    each route, with and without graphs: the same results, launches and
    call counter."""
    _hw_route(monkeypatch, route, 256, 8 * 256 * 4)

    def loglike(x):  # paired 4-D Rosenbrock: chains run past their first chunk
        return -torch.sum(100.0 * (x[..., 1::2] - x[..., ::2] ** 2) ** 2
                          + (1.0 - x[..., ::2]) ** 2, dim=-1)

    runs, launches = [], []
    for on_device in (False, True):
        s = Sampler(lambda u: 20.0 * u - 10.0, loglike, n_dim=4, n_particles=256,
                    vectorize=True, k_max=4, random_state=2, history_capacity=32,
                    hardware_prng=True, device=cuda_device)
        assert s.state.fused
        before = {**cuda_prng.LAUNCHES, "ess": cuda_reweight.LAUNCHES}
        s.run(n_total=1024, progress=False, on_device=on_device)
        after = {**cuda_prng.LAUNCHES, "ess": cuda_reweight.LAUNCHES}
        launches.append({k: v - before[k] for k, v in after.items()})
        runs.append(s)
    (off, on), (r_off, r_on) = runs, (runs[0].results(), runs[1].results())
    for name in ("beta", "logz", "steps", "calls"):
        assert r_on[name].tobytes() == r_off[name].tobytes(), name
    assert on.evidence()[0] == off.evidence()[0] and launches[0] == launches[1]
    # One launch a step run: the real steps and those a chunk ran past the
    # stop (whose draws are put back), in both modes.
    bodies = [x.state._iteration.loops.stats["mcmc"]["bodies"] for x in (off, on)]
    assert bodies[0] == bodies[1] >= int(r_on["steps"][r_on["beta"] > 0].sum())
    kernel = {"mutation": "mutation_draws", "large": "gamma", "below": None}[route]
    if kernel:
        assert launches[1][kernel] == bodies[1]
    else:
        assert all(launches[1][k] == 0 for k in cuda_prng.LAUNCHES)
    s_on, s_off = on.state.draws.get_state(), off.state.draws.get_state()
    assert all(s_on[k].tobytes() == s_off[k].tobytes() for k in s_off)
    assert on.state.draws.calls.read() == (off.state.draws.counter, off.state.draws.key)
    stats = on.state._iteration.loops.stats
    assert stats["mcmc"]["replays"] > 0 and r_on["steps"].max() > 4


_HOST_READ_RUN = textwrap.dedent("""
    import torch
    from tempest_tpu_torch import Sampler
    from tempest_tpu_torch.loops import CaptureError

    def loglike(x):
        scale = 1.0 + 0.0 * float(x.abs().max().item())  # a host read
        return -0.5 * scale * torch.sum(x * x, dim=-1)

    s = Sampler(lambda u: 20.0 * u - 10.0, loglike, n_dim=2, n_particles=128, vectorize=True,
                clustering=False, random_state=1, history_capacity=32, device="cuda")
    s.run(n_total=256, progress=False, on_device=False)
    print("EAGER_OK", s.beta)
    s.reset(random_state=1)
    try:
        s.run(n_total=256, progress=False, on_device=True)
    except CaptureError as exc:
        print("CAPTURE_ERROR", exc)
    else:
        print("NO_ERROR")
""")


@pytest.mark.cuda
def test_capture_of_a_host_read_raises(cuda_device):
    # A failed capture leaves the process's CUDA libraries in an uncertain
    # state, so it runs in a process of its own.
    proc = subprocess.run([sys.executable, "-c", _HOST_READ_RUN], capture_output=True, text=True,
                          timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert "EAGER_OK 1.0" in proc.stdout, proc.stdout + proc.stderr[-3000:]
    assert "CAPTURE_ERROR" in proc.stdout, proc.stdout + proc.stderr[-3000:]
    assert "'mcmc' loop" in proc.stdout and "on_device=False" in proc.stdout, proc.stdout


# ---------------------------------------------------------------------------
# The eigenvalue kernel (csrc/sym_eigvals.cu) and the loops it lets capture
# ---------------------------------------------------------------------------
def _symmetric(device, batch, d, kind, dtype, seed=0):
    """(batch, d, d) symmetric matrices: SPD, indefinite, rank-deficient
    (rank d // 2) or diagonal."""
    g = torch.Generator(device="cpu")
    g.manual_seed(seed + d)
    x = torch.randn(batch, d, d, generator=g, dtype=torch.float64)
    if kind == "spd":
        a = x @ x.transpose(1, 2) / d + 0.1 * torch.eye(d, dtype=torch.float64)
    elif kind == "indefinite":
        a = x + x.transpose(1, 2)
    elif kind == "rank_deficient":
        y = x[:, :, : max(d // 2, 1)]
        a = y @ y.transpose(1, 2)
    else:
        a = torch.diag_embed(torch.randn(batch, d, generator=g, dtype=torch.float64))
    return a.to(device=device, dtype=dtype)


EIG_KINDS = ("spd", "indefinite", "rank_deficient", "diagonal")
# The CV's d = 10 and the rosenbrock100 path's 100; 64 and 128 fill whole
# warps; 168 / 169 and 238 / 239 are the last d held in shared memory and
# the first past it (the global-workspace route) in float64 and float32.
EIG_DIMS = (1, 2, 3, 10, 50, 64, 100, 128, 168, 169, 238, 239, 240)
EIG_LAST_RESIDENT = {torch.float32: 238, torch.float64: 168}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", EIG_KINDS)
@pytest.mark.parametrize("d", EIG_DIMS)
def test_sym_eigvals_matches_eigvalsh(cuda_device, d, kind, dtype):
    """Against torch.linalg.eigvalsh of the float64 copy: |dlambda| <= 16 d
    eps max|lambda|. The Householder reduction's computed tridiagonal is
    that of A + E with ||E|| a small multiple of d eps ||A||, and the
    multisection brackets each of its eigenvalues within 2 eps ||T||;
    ||A||_2 = max|lambda|, and LAPACK's backward error is of the same
    order, so 16 d eps bounds both with room at every d tested."""
    from tempest_tpu_torch.ops import cuda_linalg

    assert cuda_linalg.plan_launch(d, dtype).resident == (d <= EIG_LAST_RESIDENT[dtype])
    a = _symmetric(cuda_device, 3, d, kind, dtype)
    before = cuda_linalg.LAUNCHES
    got, rounds = cuda_linalg._launch(a, rounds=True)
    again = cuda_linalg.eigvalsh(a)
    torch.cuda.synchronize()
    assert cuda_linalg.LAUNCHES == before + 2
    want = torch.linalg.eigvalsh(a.double().cpu())
    scale = want.abs().amax(dim=1, keepdim=True)
    err = (got.double().cpu() - want).abs()
    assert got.dtype == dtype and got.shape == (3, d)
    assert torch.all(err <= 16 * d * torch.finfo(dtype).eps * scale), float(err.max())
    assert torch.equal(got, again)  # a launch repeats its bits
    assert torch.all(torch.diff(got, dim=1) >= 0)
    assert 0 < int(rounds.min()) and int(rounds.max()) < cuda_linalg.MAX_ROUNDS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", EIG_KINDS)
def test_sym_eigvals_keeps_the_cv_rank_decision(cuda_device, kind, dtype):
    """volume_variation_dtn's rank test, eigvals > max|eigvals| d eps, takes
    the same decision (rank < d or not) on the kernel's eigenvalues as on
    torch.linalg.eigvalsh's, at the CV's d = 10."""
    from tempest_tpu_torch.ops import cuda_linalg

    d = 10
    a = _symmetric(cuda_device, 8, d, kind, dtype, seed=3)

    def short_rank(eig):
        tol = eig.abs().amax(dim=1, keepdim=True) * d * torch.finfo(dtype).eps
        return (eig > tol).sum(dim=1) < d

    assert torch.equal(short_rank(cuda_linalg.eigvalsh(a)), short_rank(torch.linalg.eigvalsh(a)))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [5, 100, 240])
def test_sym_eigvals_nonfinite_and_refusals(cuda_device, d):
    """A matrix with a NaN or an infinity in its lower triangle gives NaN
    eigenvalues, its neighbours in the batch their own."""
    from tempest_tpu_torch.ops import cuda_linalg

    a = _symmetric(cuda_device, 3, d, "spd", torch.float32)
    a[1, d - 1, d // 2] = float("nan")
    a[2, d - 1, 0] = float("inf")
    got = cuda_linalg.eigvalsh(a)
    assert torch.equal(got[0], cuda_linalg.eigvalsh(a[:1])[0])
    assert torch.all(torch.isfinite(got[0])) and torch.all(torch.isnan(got[1:]))
    with pytest.raises(ValueError, match="float32 or float64"):
        cuda_linalg.eigvalsh(a.half())
    with pytest.raises(ValueError, match="d, d"):
        cuda_linalg.eigvalsh(torch.zeros(3, 4, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [10, 100, 240])
def test_sym_eigvals_replays_in_a_graph(cuda_device, d, dtype):
    """A launch captured in a CUDA graph replays to the eager launch's bits
    on new inputs written into its static buffer."""
    from tempest_tpu_torch.ops import cuda_linalg

    static = _symmetric(cuda_device, 4, d, "spd", dtype)
    cuda_linalg.eigvalsh(static)  # build, load and opt in before the capture
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin()
        out = cuda_linalg.eigvalsh(static)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    for seed in (5, 6):
        new = _symmetric(cuda_device, 4, d, "indefinite", dtype, seed=seed)
        static.copy_(new)
        graph.replay()
        assert torch.equal(out, cuda_linalg.eigvalsh(new))


@pytest.mark.cuda
def test_dynamic_run_on_device_repeats_on_device_false(cuda_device):
    """Dynamic mode on the fused route: graphed, it repeats the eager run
    bit for bit; its ESS bracket is one launch of the ESS kernel's bracket
    mode a reweight (no "ess_bracket" loop body, no ESS-mode launch); the
    CV's eigenvalues come from the kernel, never torch.linalg.eigvalsh."""
    from tempest_tpu_torch.ops import cuda_linalg

    def loglike(x):  # chained 4-D Rosenbrock
        return -torch.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
                          + (1.0 - x[..., :-1]) ** 2, dim=-1)

    runs, launches, brackets = [], [], []
    for on_device in (False, True):
        s = Sampler(lambda u: 20.0 * u - 10.0, loglike, n_dim=4, n_particles=256,
                    vectorize=True, clustering=False, volume_variation=1.0, random_state=2,
                    history_capacity=64, device=cuda_device)
        assert s.state.fused
        before = (cuda_linalg.LAUNCHES, cuda_reweight.BRACKET_LAUNCHES, cuda_reweight.LAUNCHES,
                  rw_mod.PROBES["reweights"])
        s.run(n_total=1024, progress=False, on_device=on_device)
        launches.append(cuda_linalg.LAUNCHES - before[0])
        brackets.append(cuda_reweight.BRACKET_LAUNCHES - before[1])
        assert cuda_reweight.LAUNCHES == before[2]
        assert brackets[-1] == rw_mod.PROBES["reweights"] - before[3] == s.state.hist.t - 1 > 0
        runs.append(s)
    (off, on), (r_off, r_on) = runs, (runs[0].results(), runs[1].results())
    for name in ("beta", "logz", "ess", "cv", "steps", "calls"):
        assert r_on[name].tobytes() == r_off[name].tobytes(), name
    assert on.beta == 1.0 and launches[0] == launches[1] > 0 and brackets[0] == brackets[1]
    stats = on.state._iteration.loops.stats
    assert stats["ess_bracket"]["bodies"] == 0 and stats["mcmc"]["replays"] > 0


_MESH_RUN = textwrap.dedent("""
    import json, socket
    import torch
    import torch.distributed as dist
    from tempest_tpu_torch import Sampler
    from tempest_tpu_torch.parallel import make_particle_mesh
    from tempest_tpu_torch.parallel.distributed import initialize

    def loglike(x):
        return -torch.sum(100.0 * (x[..., 1::2] - x[..., ::2] ** 2) ** 2
                          + (1.0 - x[..., ::2]) ** 2, dim=-1)

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    initialize(f"127.0.0.1:{port}", 1, 0, device="cuda", timeout=120)
    try:
        mesh = make_particle_mesh(device="cuda")
        rows = []
        for on_device in (False, True):
            s = Sampler(lambda u: 20.0 * u - 10.0, loglike, n_dim=4, n_particles=256,
                        vectorize=True, k_max=4, random_state=2, history_capacity=32,
                        device="cuda", mesh=mesh)
            s.run(n_total=1024, progress=False, on_device=on_device)
            r = s.results()
            stats = s.state._iteration.loops.stats
            rows.append({k: r[k].tobytes().hex() for k in ("beta", "logz", "steps")}
                        | {"fused": s.state.fused, "beta1": s.beta,
                           "replays": stats["ess_sharded"]["replays"]})
        print("MESH " + json.dumps(rows))
    finally:
        dist.destroy_process_group()
""")


@pytest.mark.cuda
def test_mesh_run_on_device_repeats_on_device_false(cuda_device):
    """A particle mesh of one rank over NCCL (in a process of its own): the
    sharded ESS bisection and the MCMC steps, their collectives captured
    with the chunks, replay bit for bit."""
    proc = subprocess.run([sys.executable, "-c", _MESH_RUN], capture_output=True, text=True,
                          timeout=600, cwd=Path(__file__).resolve().parents[1])
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("MESH ")]
    assert proc.returncode == 0 and line, proc.stdout + proc.stderr[-3000:]
    off, on = json.loads(line[0][5:])
    assert off["fused"] and on["fused"] and on["beta1"] == 1.0
    for k in ("beta", "logz", "steps"):
        assert on[k] == off[k], k
    assert on["replays"] > 0 and off["replays"] == 0


# ---------------------------------------------------------------------------
# The weighted-median kernel (ops/cuda_median.py, csrc/weighted_median.cu)
# ---------------------------------------------------------------------------
def _median_inputs(device, K, n, d, dtype, seed, zero_rows=(), ties=False):
    """(d_sorted, order, wbar) as a fit makes them: the stable column sort of
    the points, exponential weights with a tenth of them zero, each row
    normalized; the rows in `zero_rows` all zero."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g, dtype=torch.float64)
    if ties:
        x = torch.round(4.0 * x)
    w = torch.empty(K, n, dtype=torch.float64).exponential_(generator=g)
    w[torch.rand(K, n, generator=g) < 0.1] = 0.0
    for k in zero_rows:
        w[k] = 0.0
    x, w = x.to(device=device, dtype=dtype), w.to(device=device, dtype=dtype)
    total = w.sum(dim=1, keepdim=True)
    wbar = w / torch.where(total > 0, total, torch.ones_like(total))
    order = torch.argsort(x, dim=0, stable=True)
    return torch.gather(x, 0, order), order, wbar


def _same_bits(a, b):
    view = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(view), b.view(view))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K,n,d,zero_rows", [
    (16, 4096, 10, (3, 15)),  # A's clustered fit, two empty modes
    (1, 524288, 10, ()),  # B's fit_global_mode
    (1, 8192, 100, ()),  # rosenbrock100
    (3, 257, 4, (1,)),  # ragged: a partial tile
    (5, 4097, 3, (0, 4)),  # one past a float32 tile
    (2, 1, 1, ()),  # one point
    (4, 10000, 7, (0, 1, 2, 3)),  # every row empty
])
def test_weighted_median_kernel_equals_plain_bit_for_bit(cuda_device, dtype, K, n, d, zero_rows):
    """The kernel gives the plain version's bits (torch.cumsum's serial
    sums in the working type), two launches the same; an all-zero row
    gives d_sorted[0]."""
    from tempest_tpu_torch.ops import cuda_median

    d_sorted, order, wbar = _median_inputs(cuda_device, K, n, d, dtype, seed=n + d,
                                           zero_rows=zero_rows)
    before = cuda_median.LAUNCHES
    got = cuda_median.weighted_median_presorted(d_sorted, order, wbar)
    again = cuda_median.weighted_median_presorted(d_sorted, order, wbar)
    want = cuda_median.weighted_median_presorted_reference(d_sorted, order, wbar)
    torch.cuda.synchronize()
    assert cuda_median.LAUNCHES == before + 2
    assert _same_bits(got, want) and _same_bits(got, again)
    for k in zero_rows:
        assert torch.equal(got[k], d_sorted[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_weighted_median_kernel_edges(cuda_device, dtype):
    """Ties in the data; weights (n,) for one row; a row whose running sum
    lands exactly on the threshold rounded to the type; rows whose sum never
    reaches it (index 0)."""
    from tempest_tpu_torch.ops import cuda_median

    d_sorted, order, wbar = _median_inputs(cuda_device, 4, 3000, 5, dtype, seed=9, ties=True)
    thr = torch.tensor(cuda_median.THRESHOLD, dtype=dtype).item()
    n = wbar.shape[1]
    exact = torch.zeros(n, dtype=dtype, device=cuda_device)
    exact[order[7, 0]] = thr  # the 8th point of column 0 brings the sum to thr exactly
    exact[order[9, 0]] = 1.0 - thr
    wbar = torch.cat([wbar, exact[None], 0.3 * wbar[:1]])  # the last row sums to 0.3
    got = cuda_median.weighted_median_presorted(d_sorted, order, wbar)
    want = cuda_median.weighted_median_presorted_reference(d_sorted, order, wbar)
    one = cuda_median.weighted_median_presorted(d_sorted, order, wbar[0])
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    assert got[4, 0] == d_sorted[7, 0] and torch.equal(got[5], d_sorted[0])
    assert _same_bits(one, want[0])


@pytest.mark.cuda
def test_weighted_median_kernel_rejects_what_it_does_not_take(cuda_device):
    from tempest_tpu_torch.ops import cuda_median

    d_sorted, order, wbar = _median_inputs(cuda_device, 2, 100, 3, torch.float32, seed=1)
    f = cuda_median.weighted_median_presorted
    for args in [(d_sorted.half(), order, wbar.half()),  # a type it does not run
                 (d_sorted, order, wbar.double()),  # one type for data and weights
                 (d_sorted, order.int(), wbar),  # int64 order
                 (d_sorted.t().contiguous().t(), order, wbar),  # not contiguous
                 (d_sorted, order, wbar[:, :50]),  # n differs
                 (d_sorted, order.cpu(), wbar)]:  # two devices
        with pytest.raises(ValueError):
            f(*args)


@pytest.mark.cuda
def test_fits_launch_the_median_kernel_once_a_fit(cuda_device):
    """`fit_mvstud_weighted_modes` on the card: one median launch, and the
    median it starts from is the plain version's."""
    from tempest_tpu_torch import student
    from tempest_tpu_torch.ops import cuda_median

    d_sorted, order, wbar = _median_inputs(cuda_device, 4, 2048, 5, torch.float32, seed=3)
    data = torch.empty_like(d_sorted).scatter_(0, order, d_sorted)
    before = cuda_median.LAUNCHES
    student.fit_mvstud_weighted_modes(data, wbar, sort_cache=(d_sorted, order))
    assert cuda_median.LAUNCHES == before + 1


# ---------------------------------------------------------------------------
# The bracket mode of the ESS kernel (dynamic mode's ESS bracket)
# ---------------------------------------------------------------------------
# tests/test_torch_dynamic.py's CASES (fill, seed, contract, ESS target as a
# multiple of ESS(beta_prev) or "jump"), without their CV targets; that file
# imports JAX, this one does not.
DYNAMIC_CASES = [(3, 0, True, 0.6), (5, 1, True, 0.5), (5, 1, True, 1.5), (7, 2, True, 0.3),
                 (7, 2, True, 0.8), (7, 2, True, "jump"), (2, 3, True, 0.7), (3, 0, False, 0.6),
                 (5, 1, False, 0.5), (7, 2, False, 0.3), (2, 3, False, 0.7)]


def _dynamic_history(device, fill, seed, contract, dtype):
    """tests/test_torch_dynamic.py's `build_history`, committed by the port:
    (logl, bm) of a (8, 64) history in 3-D."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, dim, cap = 64, 3, 8
    hist, cur = make_history(cap, n, dim, dtype=dtype, device=device), make_current(
        n, dim, dtype=dtype, device=device)
    np_type = np.float64 if dtype == torch.float64 else np.float32
    for t in range(fill):
        width = 1.0 / (1.0 + t) if contract else 4.0
        u = np.clip(0.5 + width * rng.normal(0, 0.25, (n, dim)), 0.0, 1.0).astype(np_type)
        cur.u = cur.x = torch.from_numpy(u).to(device)
        cur.logl = torch.from_numpy((-0.5 * np.sum(((u - 0.5) / 0.05) ** 2, axis=1))
                                    .astype(np_type)).to(device)
        cur.beta = torch.tensor(0.002 * t * t, dtype=dtype, device=device)
        cur.logz = torch.tensor(-0.3 * t, dtype=dtype, device=device)
        commit(hist, cur)
    inf = torch.tensor(float("inf"), device=device, dtype=dtype)
    bm = torch.where(hist.sample_mask(), mis_denominator(hist), inf)
    return hist.logl.reshape(-1).contiguous(), bm.reshape(-1).contiguous(), float(
        hist.beta[fill - 1])


def _assert_bracket_matches(logl, bm, scal, got, want):
    """The bracket mode's ((lo, hi), probes) against the plain version's:
    the same probes; stay and jump exact; in float64 each end within 1e-12
    (relative); in float32 the same ends, or else the plain ESS at the first
    midpoint decided the other way within 1e-5 (relative) of the target,
    and the ends always within 2e-3."""
    (bk, pk), (br, pr) = got, want
    assert pk.item() == pr.item(), (bk.tolist(), br.tolist(), pk.item(), pr.item())
    (lo_k, hi_k), (lo_r, hi_r) = bk.tolist(), br.tolist()
    if pr.item() == 2 or torch.equal(bk, br):
        assert torch.equal(bk, br), (bk.tolist(), br.tolist())
        return
    if bk.dtype == torch.float64:
        assert abs(lo_k - lo_r) <= 1e-12 * abs(lo_r) and abs(hi_k - hi_r) <= 1e-12 * abs(hi_r)
        return
    assert abs(lo_k - lo_r) < 2e-3 and abs(hi_k - hi_r) < 2e-3, (bk.tolist(), br.tolist())
    target = scal[1].item()
    lo, hi = scal[0].cpu(), torch.ones((), dtype=bk.dtype)
    for _ in range(pr.item() - 2):
        mid = 0.5 * (lo + hi)
        up_k, up_r = lo_k >= mid.item(), lo_r >= mid.item()
        if up_k != up_r:
            assert abs(_ess(logl, bm, mid.item()) - target) <= 1e-5 * abs(target), mid.item()
            return
        lo, hi = (mid, hi) if up_r else (lo, mid)
    raise AssertionError(f"brackets {bk.tolist()} and {br.tolist()} differ with no decision "
                         "taken the other way")


def _bracket_cases(logl, bm, bp, n):
    cur, one = _ess(logl, bm, bp), _ess(logl, bm, 1.0)
    return [(bp, 1.5 * cur), (bp, 0.5 * one), (bp, (cur * one) ** 0.5), (0.0, 2.0 * n),
            (bp, 0.9 * cur)]


def _check_bracket_cases(device, logl, bm, cases, dtype, kinds):
    for beta_prev, target in cases:
        scal = torch.tensor([beta_prev, target], device=device, dtype=dtype)
        got = cuda_reweight.ess_bracket(logl, bm, scal)
        again = cuda_reweight.ess_bracket(logl, bm, scal)
        want = rw_mod.ess_bracket_loop(logl, bm, scal)
        torch.cuda.synchronize()
        assert got[0].dtype == dtype and got[0].shape == (2,)
        assert _same_bits(got[0], again[0]) and torch.equal(got[1], again[1])
        _assert_bracket_matches(logl, bm, scal, got, want)
        lo, hi = want[0].tolist()
        kinds.add("bisect" if want[1].item() > 2 else ("jump" if lo == 1.0 else "stay"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bracket_kernel_on_the_dynamic_histories(cuda_device, dtype):
    """The bracket mode against its plain version on the histories of
    tests/test_torch_dynamic.py, at their targets and at a bracket's
    stay, jump and bisection targets."""
    kinds = set()
    before = cuda_reweight.BRACKET_LAUNCHES
    launches = 0
    for fill, seed, contract, ess_mult in DYNAMIC_CASES:
        logl, bm, bp = _dynamic_history(cuda_device, fill, seed, contract, dtype)
        cur, one = _ess(logl, bm, bp), _ess(logl, bm, 1.0)
        target = 0.5 * one if ess_mult == "jump" else ess_mult * cur
        cases = [(bp, target)] + _bracket_cases(logl, bm, bp, 64)
        _check_bracket_cases(cuda_device, logl, bm, cases, dtype, kinds)
        launches += 2 * len(cases)
    assert kinds == {"stay", "jump", "bisect"}
    assert cuda_reweight.BRACKET_LAUNCHES == before + launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cap,N,t_fill,S,beta_prev", [
    # dynamic mode's history, most rows masked, from its last row's beta; held on chip
    (192, 1024, 48, 196608, 0.47),
    (8, 24576, 8, 196608, 0.07),  # the same S all filled
    (8, 65536, 8, 524288, 0.07),  # streamed in both types
    (8, 131072, 8, 1048576, 0.07),  # B's
])
def test_bracket_kernel_matches_plain_version(cuda_device, dtype, cap, N, t_fill, S, beta_prev):
    logl, bm = _synthetic(cuda_device, cap, N, t_fill, seed=N, dtype=dtype)
    assert logl.numel() == S
    assert cuda_reweight.plan_launch(S, dtype).resident == (S <= ON_CHIP_MAX_F64 or (
        dtype == torch.float32 and S <= ON_CHIP_MAX))
    kinds = set()
    _check_bracket_cases(cuda_device, logl, bm, _bracket_cases(logl, bm, beta_prev, N), dtype,
                         kinds)
    assert kinds == {"stay", "jump", "bisect"}


@pytest.mark.cuda
def test_bracket_kernel_rejects_what_it_does_not_take(cuda_device):
    logl, bm = _synthetic(cuda_device, 4, 32, 3, seed=1)
    scal = torch.tensor([0.0, 64.0], device=cuda_device)
    for args in [(logl.half(), bm.half(), scal.half()), (logl.double(), bm.double(), scal),
                 (logl[::2], bm[::2], scal), (logl, bm.cpu(), scal)]:
        with pytest.raises(ValueError):
            cuda_reweight.ess_bracket(*args)


@pytest.mark.cuda
def test_bracket_kernel_captures(cuda_device):
    """A launch captured in a CUDA graph reads beta_prev and the target from
    its device words at every replay."""
    logl, bm = _synthetic(cuda_device, 8, 4096, 6, seed=5)
    scal = torch.tensor([0.0, 3000.0], device=cuda_device)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        cuda_reweight.ess_bracket(logl, bm, scal)  # warm-up: the build and the attributes
        with torch.cuda.graph(graph, stream=stream):
            out, probes = cuda_reweight.ess_bracket(logl, bm, scal)
    torch.cuda.current_stream().wait_stream(stream)
    for target in (3000.0, 1500.0, 8000.0):
        scal.copy_(torch.tensor([0.04, target], device=cuda_device))
        graph.replay()
        want = cuda_reweight.ess_bracket(logl, bm, scal)
        torch.cuda.synchronize()
        assert torch.equal(out, want[0]) and torch.equal(probes, want[1])


# ---------------------------------------------------------------------------
# The EM kernels (ops/cuda_em.py; csrc/gmm_em.cu, csrc/mvstud_em.cu)
# ---------------------------------------------------------------------------
# Each kernel against its plain loop ("gmm_em": cluster._gmm_em_plain;
# "mode_em": student._mode_em_plain) on the same CUDA tensors from the same
# start, by chip_smoke.py's rule (stated, with the measured readings behind
# its limits, above its EM_STEP_RTOL): step by step, each of the kernel's
# iterations against one plain body from the kernel's state before it, and
# the whole fit against the plain loop's (float64 within 1e-9, float32
# within 2e-3 normwise, with the same counts), a fit that parts allowed
# only where the plain loop parts from itself when only the order of its
# sums changes, or at an exit decided within 16 ulps. The data are made
# from a seed at the paths' shapes.
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from tempest_tpu_torch import student as ts  # noqa: E402
from tempest_tpu_torch.ops import _build, cuda_em  # noqa: E402


def _mixture_points(rng, n, d, k):
    centers = 4.0 * rng.normal(size=(k, d))
    labels = rng.integers(0, k, size=n)
    scale = 1.0 / np.sqrt(rng.uniform(size=(n, 1)) + 0.2)
    return centers[labels] + rng.normal(size=(n, d)) * scale


def _gmm_start(device, B, n, d, K, cov, dtype, seed, zero_leaf=False, indefinite=False,
               max_iter=1000):
    rng = np.random.default_rng(seed)
    X = np.stack([_mixture_points(rng, n, d, 3) for _ in range(B)])
    w = rng.uniform(0.1, 1.0, size=(B, n))
    if zero_leaf:
        w[-1] = 0.0
    u = rng.uniform(size=(B, K))
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    Xb, sw, carry = tc._gmm_start(t(X), t(w), K, t(u), max_iter, cov)
    if indefinite:  # the sqrt(reg) I factor where Cholesky fails
        carry["covs"] = carry["covs"].clone()
        carry["covs"][0, -1] = -torch.eye(d, dtype=dtype, device=device)
    return Xb, sw, carry


def _run_gmm(Xb, sw, carry, cov, max_iter=1000):
    return tc._gmm_em(Xb, sw, carry, max_iter, 1e-3, 1e-6, cov, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,d,K,cov", [
    (16, 2048, 10, 2, "full"),  # A's leaf fits: 16 leaf slots, leaf_fit_points, K = 2
    (1, 2048, 10, 2, "full"),
    (4, 2048, 10, 2, "tied"),
    (4, 2048, 10, 2, "diag"),
    (4, 2048, 10, 2, "spherical"),
    (2, 2048, 10, 1, "full"),
    (2, 4096, 10, 16, "full"),
    (2, 1000, 3, 16, "spherical"),
])
def test_gmm_em_kernel_matches_plain_loop(cuda_device, dtype, B, n, d, K, cov):
    Xb, sw, carry = _gmm_start(cuda_device, B, n, d, K, cov, dtype, seed=B * 100 + K)
    cs.em_gmm_case((B, n, d, K, cov), Xb, sw, carry, cov)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["zero_leaf", "indefinite", "max_iter"])
def test_gmm_em_kernel_edge_cases(cuda_device, dtype, case):
    max_iter = 3 if case == "max_iter" else 1000
    Xb, sw, carry = _gmm_start(cuda_device, 4, 2048, 10, 2, "full", dtype, seed=7,
                               zero_leaf=case == "zero_leaf", indefinite=case == "indefinite",
                               max_iter=max_iter)
    report = cs.em_gmm_case(case, Xb, sw, carry, "full", max_iter)
    if case == "max_iter":
        got = _run_gmm(Xb, sw, carry, "full", max_iter)
        assert bool((got["n_iter"] == 3).all()) and not bool(got["done"].any())
    assert not report["parted"], report["parted"]


def _mode_start(device, K, n, d, dtype, seed, zero_mode=False, singular=False, gaussian=False,
                max_iter=100):
    rng = np.random.default_rng(seed)
    if gaussian:
        data = rng.normal(size=(n, d))
    else:
        data = rng.standard_t(4.0, size=(n, d)) * rng.uniform(0.5, 2.0, size=d)
        data[:, 1:] += 0.3 * data[:, :-1]
    labels = rng.integers(0, K, size=n)
    w = rng.uniform(0.05, 1.0, size=(K, n)) * (labels[None] == np.arange(K)[:, None])
    if zero_mode:
        w[-1] = 0.0
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    carry, consts = ts._mode_start(t(data), t(w), 1e-6, max_iter)
    if singular:  # the max(1e-6, 1e-6 |trace|) floor where Cholesky fails
        carry["Sigma"] = carry["Sigma"].clone()
        carry["Sigma"][0] = 0.0
    return carry, consts


def _run_modes(carry, consts):
    return ts._mode_em(carry, consts, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K,n,d", [
    (16, 4096, 10),  # A's clustered fit: k_max modes of 4 N fit points
    (1, 4096, 10),  # the unclustered and dynamic paths' global fit
    (1, 524288, 10),  # B's global fit
    (1, 8192, 100),  # rosenbrock100's
])
def test_mvstud_em_kernel_matches_plain_loop(cuda_device, dtype, K, n, d):
    carry, consts = _mode_start(cuda_device, K, n, d, dtype, seed=K + d)
    cs.em_mode_case((K, n, d), carry, consts)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["zero_mode", "singular", "max_iter", "gaussian"])
def test_mvstud_em_kernel_edge_cases(cuda_device, dtype, case):
    max_iter = 3 if case == "max_iter" else 100
    carry, consts = _mode_start(cuda_device, 4, 4096, 10, dtype, seed=11,
                                zero_mode=case == "zero_mode", singular=case == "singular",
                                gaussian=case == "gaussian", max_iter=max_iter)
    report = cs.em_mode_case(case, carry, consts)
    if case == "max_iter":
        assert report["iterations"] == [3] * 4
    if case == "gaussian":  # the Gaussian-limit exit: nu = +inf, mu and Sigma kept
        assert report["gaussian_limit"] > 0
    assert not report["parted"], report["parted"]


@pytest.mark.cuda
def test_em_kernels_small_cta_in_float64(cuda_device, tmp_path, monkeypatch):
    """The 256-thread CTA plan, which the launch plan takes in float32 past
    64 CTAs only, held by the float64 rule: sources whose plan always takes
    256 threads (scripts/em_designs.py's edit of em_common.cuh)."""
    src = tmp_path / "csrc"
    import shutil
    shutil.copytree(_build.CSRC, src)
    header = (src / "em_common.cuh").read_text()
    rule = "return elem == 4 && ctas > 64 ? kSmallCta : kLargeCta;"
    assert rule in header
    (src / "em_common.cuh").write_text(header.replace(rule, "return kSmallCta;"))
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "_loaded", {})
    assert cuda_em.plan(cuda_em.MVSTUD_LIBRARY, 16, 4096, 10, 8)["threads"] == 256
    assert cuda_em.plan(cuda_em.GMM_LIBRARY, 16, 2048, 10, 2, 0, 8)["threads"] == 256
    Xb, sw, carry = _gmm_start(cuda_device, 16, 2048, 10, 2, "full", torch.float64, seed=5)
    cs.em_gmm_case("256 threads", Xb, sw, carry, "full")
    for K, n, d in ((16, 4096, 10), (1, 8192, 100)):
        carry, consts = _mode_start(cuda_device, K, n, d, torch.float64, seed=K + d)
        cs.em_mode_case(f"256 threads {(K, n, d)}", carry, consts)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_em_kernels_repeat_their_bits(cuda_device, dtype):
    Xb, sw, carry = _gmm_start(cuda_device, 16, 2048, 10, 2, "full", dtype, seed=5)
    a, b = _run_gmm(Xb, sw, carry, "full"), _run_gmm(Xb, sw, carry, "full")
    for k in ("pi", "means", "covs", "lb", "n_iter", "done"):
        assert torch.equal(a[k], b[k]), k
    mc, mk = _mode_start(cuda_device, 16, 4096, 10, dtype, seed=6)
    a, b = _run_modes(mc, mk), _run_modes(mc, mk)
    for k in ("mu", "Sigma", "nu", "last_nu", "i", "hit_inf", "active"):
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_em_kernels_replay_in_graphs(cuda_device, dtype):
    graphed = _loops(cuda_device, True)
    for seed in (1, 2):  # the second call replays the first call's graphs
        Xb, sw, carry = _gmm_start(cuda_device, 16, 2048, 10, 2, "full", dtype, seed=seed)
        want = _run_gmm(Xb, sw, carry, "full")
        before = cuda_em.LAUNCHES["gmm_em"]
        got = tc._gmm_em(Xb, sw, carry, 1000, 1e-3, 1e-6, "full", graphed)
        assert cuda_em.LAUNCHES["gmm_em"] == before + 1  # the replay counts its launch
        for k in ("pi", "means", "covs", "lb", "n_iter", "done"):
            assert torch.equal(got[k], want[k]), (seed, k)
        mc, mk = _mode_start(cuda_device, 16, 4096, 10, dtype, seed=seed)
        want = _run_modes(mc, mk)
        before = cuda_em.LAUNCHES["mvstud_em"]
        got = ts._mode_em(mc, mk, graphed)
        assert cuda_em.LAUNCHES["mvstud_em"] == before + 1
        for k in ("mu", "Sigma", "nu", "last_nu", "i", "hit_inf", "active"):
            assert torch.equal(got[k], want[k]), (seed, k)
    for name in ("gmm_em", "mode_em"):
        stats = graphed.stats[name]
        assert stats["captures"] == 1 and stats["replays"] == 2 and stats["reads"] == 0, name
