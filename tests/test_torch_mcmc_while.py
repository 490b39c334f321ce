"""The MCMC chain on keyed draws and in the loop form (`Loops.repeat`).

On a CUDA device in float32 every draw of an MCMC step comes from the
Philox kernels, keyed by a call counter in device words that a step
advances only while its chain is active (`draws.Draws.keyed`); graphed,
the chain runs as `Loops.repeat`, one CUDA-graph WHILE node, and eagerly in
chunks. Here the keyed source runs on its plain version (`ops/philox.py`:
`HardwareDraws`, keyed in float32 on every device, and `KeyedDraws`, the
`Draws` stream keyed on the CPU too), the loop form is `Loops.repeat`'s
Python loop, and the checks are exact (bits), but for the comparison with
`tempest_tpu.mcmc`'s `while_loop` fed the JAX draws through the draw hook:
there atol 1e-5 on u (float32 elementwise and d x d arithmetic in another
order, as tests/test_torch_mcmc.py states) and the same step count.
"""

import jax
import numpy as np
import pytest
import torch

from tempest_tpu.mcmc import make_mcmc_kernel
from tempest_tpu_torch import Sampler
from tempest_tpu_torch import core as core_mod
from tempest_tpu_torch import draws as draws_mod
from tempest_tpu_torch import modes as tm
from tempest_tpu_torch.draws import Draws, HardwareDraws
from tempest_tpu_torch.loops import Loops
from tempest_tpu_torch.mcmc import MCMCKernel, _tensors
from tempest_tpu_torch.ops import philox
from test_torch_mcmc import (N, JaxKeyDraws, _problem, loglike_j, loglike_t, prior_j,
                             prior_t)

torch.set_num_threads(1)

# A step's call indices on each keyed route: the mutation-draws kernel; the
# gamma (13), normal and uniform kernels; RWM's normal and uniform.
CALLS = {("tpcn", "mutation"): 1, ("tpcn", "large"): philox.GAMMA_CALLS + 2,
         ("rwm", "mutation"): 2, ("rwm", "large"): 2}


class KeyedDraws(Draws):
    """`Draws` with its keyed steps (`philox.draws_key`) on the CPU too."""

    KEYED_ON_CPU = True


def _chain(method, d=3, n=64):
    g = torch.Generator().manual_seed(7)
    u = 0.5 + 0.02 * torch.randn(n, d, generator=g)
    modes = tm.make_mode_statistics(torch.full((d,), 0.5), 1e-2 * torch.eye(d),
                                    torch.tensor(6.0))

    def loglike(x):  # proposals wider than the target: the chain runs past n_steps d
        return -8.0 * torch.sum(x * x, dim=-1)

    kernel = MCMCKernel(lambda x, *_: (loglike(x), None), lambda v: 20.0 * v - 10.0, d,
                        method=method)
    x = 20.0 * u - 10.0
    args = (u, x, loglike(x), torch.zeros(n, dtype=torch.int32), torch.tensor(0.3), modes)
    return kernel, args


def _run(kernel, args, form, seed=11, hardware=False):
    """The chain on keyed draws: the loop form (`form="repeat"`) or chunks of
    `form` steps, driven as `MCMCKernel.__call__` drives them; the final
    carry (every ChainState tensor), the draws and the loops."""
    draws = (HardwareDraws if hardware else KeyedDraws)(seed, "cpu")
    u, x, logl, assignments, beta, modes = args
    carry = _tensors(kernel.initial_state(u, x, logl, modes.k_max))
    consts = _tensors(kernel.prepare(assignments, beta, modes))
    body = kernel.body(draws, *u.shape, keyed=True)
    if form == "repeat":
        loops = Loops("cpu")
        out = loops.repeat("mcmc", kernel.pred, body, carry, consts)
    else:
        loops = Loops("cpu", {"mcmc": form})
        out = kernel._chunks(loops, draws, body, carry, consts, keyed=True)
    return out, draws, loops


@pytest.mark.parametrize("route", ["mutation", "large"])
@pytest.mark.parametrize("method", ["tpcn", "rwm"])
@pytest.mark.parametrize("form", [1, 3, 8])
def test_chunks_and_the_loop_form_give_the_same_bits(monkeypatch, method, route, form):
    """Chunk lengths 1, 3 and 8 and the loop form: the same u, x, logl,
    sigmas, acceptance, steps and final counter, which is the steps times a
    step's calls: a step past the stop draws nothing new."""
    if route == "large":
        monkeypatch.setattr(draws_mod, "FUSED_DRAWS_MAX_ELEMS", 0)
    kernel, args = _chain(method)
    want, wdraws, wloops = _run(kernel, args, "repeat")
    got, draws, loops = _run(kernel, args, form)
    steps = int(want["iteration"])
    assert steps > kernel.n_steps_min
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert draws.counter == wdraws.counter == steps * CALLS[method, route]
    # The loop form runs the real steps only and reads after each; the
    # chunks may run past the stop, and count those steps apart.
    assert wloops.stats["mcmc"]["bodies"] == steps
    assert wloops.stats["mcmc"]["reads"] == steps + 1
    bodies = loops.stats["mcmc"]["bodies"]
    assert bodies >= steps and loops.stats["mcmc"]["past_stop"] == bodies - steps
    assert torch.equal(draws.generator.get_state(), wdraws.generator.get_state())


def _chain64(method):
    """`_chain` in float64: its modes made again from float64 moments."""
    kernel, (u, x, logl, assignments, beta, _) = _chain(method)
    d = u.shape[1]
    modes = tm.make_mode_statistics(torch.full((d,), 0.5, dtype=torch.float64),
                                    1e-2 * torch.eye(d, dtype=torch.float64),
                                    torch.tensor(6.0, dtype=torch.float64))
    kernel64 = MCMCKernel(kernel.log_likelihood_batch, kernel.prior_transform_batch,
                          kernel.n_dim, method=method, dtype=torch.float64)
    return kernel64, (u.double(), x.double(), logl.double(), assignments, beta.double(), modes)


@pytest.mark.parametrize("route", ["mutation", "large"])
@pytest.mark.parametrize("form", [1, 8])
def test_float64_chunks_and_the_loop_form_give_the_same_bits(monkeypatch, route, form):
    """The float64 chain on keyed float64 draws (the `_f64` kernels' plain
    versions): chunks of 1 and 8 and the loop form give the same bits; the
    final counter is the steps times a step's calls (1, or 33 + 2)."""
    if route == "large":
        monkeypatch.setattr(draws_mod, "FUSED_DRAWS_MAX_ELEMS", 0)
    kernel, args = _chain64("tpcn")

    def run(form):
        draws = KeyedDraws(11, "cpu", torch.float64)
        u, x, logl, assignments, beta, modes = args
        carry = _tensors(kernel.initial_state(u, x, logl, modes.k_max))
        consts = _tensors(kernel.prepare(assignments, beta, modes))
        body = kernel.body(draws, *u.shape, keyed=True)
        if form == "repeat":
            return Loops("cpu").repeat("mcmc", kernel.pred, body, carry, consts), draws
        return kernel._chunks(Loops("cpu", {"mcmc": form}), draws, body, carry, consts,
                              keyed=True), draws

    want, wdraws = run("repeat")
    got, draws = run(form)
    steps = int(want["iteration"])
    assert steps > kernel.n_steps_min and want["u"].dtype == torch.float64
    for name in want:
        assert torch.equal(got[name], want[name]), name
    per_step = 1 if route == "mutation" else philox.GAMMA_CALLS_F64 + 2
    assert draws.counter == wdraws.counter == steps * per_step


@pytest.mark.parametrize("hardware", [False, True])
def test_eager_chain_on_keyed_draws_runs_in_chunks(hardware):
    """`MCMCKernel.__call__` off a graph runs keyed draws in chunks (the
    fused route's 8 steps a read): the loop form's bits, fewer reads."""
    kernel, args = _chain("tpcn")
    want, wdraws, wloops = _run(kernel, args, "repeat", hardware=hardware)
    draws = (HardwareDraws if hardware else KeyedDraws)(11, "cpu")
    loops = Loops("cpu", {"mcmc": 8})
    res = kernel(draws, *args, loops=loops)
    steps = int(want["iteration"])
    assert int(res.steps) == steps and torch.equal(res.u, want["u"])
    assert torch.equal(res.logl, want["logl"]) and torch.equal(res.acceptance, want["alpha_mean"])
    assert draws.counter == wdraws.counter
    stats = loops.stats["mcmc"]
    assert stats["chunks"] > 0 and stats["reads"] < wloops.stats["mcmc"]["reads"]
    assert stats["past_stop"] == stats["bodies"] - steps


def test_hardware_draws_keyed_take_their_own_key():
    """Keyed HardwareDraws draw as keyed Draws do, under philox.key_from_seed
    where Draws take philox.draws_key: two streams."""
    kernel, args = _chain("tpcn")
    plain, pdraws, _ = _run(kernel, args, "repeat")
    hard, hdraws, _ = _run(kernel, args, "repeat", hardware=True)
    assert pdraws.key == philox.draws_key(11) != hdraws.key == philox.key_from_seed(11)
    assert not torch.equal(plain["u"], hard["u"])
    assert hdraws.counter == int(hard["iteration"])


def test_keyed_step_draws_from_the_kernels_plain_versions(monkeypatch):
    """What a keyed step returns, call by call: the mutation draws at
    R n d <= 2^19 (tpCN), else gamma, normal and uniform on successive call
    indices; an inactive step returns draws and leaves the counter."""
    n, d = 64, 3
    alpha = torch.linspace(0.4, 9.0, n)
    draws = KeyedDraws(5, "cpu")
    key = philox.draws_key(5)
    z, g, u = draws.mcmc_step(8, n, d, alpha)
    wz, wg, wu = philox.mutation_draws(key, 0, alpha, (8, n, d))
    assert torch.equal(z, wz) and torch.equal(g, wg) and torch.equal(u, wu)
    draws.mcmc_step(8, n, d, alpha, active=torch.tensor(False))
    assert draws.counter == 1
    monkeypatch.setattr(draws_mod, "FUSED_DRAWS_MAX_ELEMS", 0)
    z, g, u = draws.mcmc_step(8, n, d, alpha, active=torch.tensor(True))
    assert torch.equal(g, philox.gamma(key, 1, alpha))
    assert torch.equal(z.reshape(-1), philox.normal(key, 1 + philox.GAMMA_CALLS, 8 * n * d, "cpu"))
    assert torch.equal(u, philox.uniform(key, 2 + philox.GAMMA_CALLS, n, "cpu"))
    assert draws.counter == 1 + philox.GAMMA_CALLS + 2
    z, g, u = draws.mcmc_step(8, n, d, None)  # RWM: normal and uniform
    first = 1 + philox.GAMMA_CALLS + 2
    assert g is None and torch.equal(u, philox.uniform(key, first + 1, n, "cpu"))
    assert draws.counter == first + 2


def test_keyed_draws_on_the_cpu_only_when_asked():
    """Draws on the CPU keep the generator for their steps (the JAX-draw
    hooks' tests see no change); HardwareDraws are keyed on every device;
    in float64 Draws are keyed where asked (the card, or KEYED_ON_CPU: the
    kernels' float64 entries)."""
    assert not Draws(1, "cpu").keyed and Draws(1, "cpu").calls is None
    assert HardwareDraws(1, "cpu").keyed and KeyedDraws(1, "cpu").keyed
    f64 = torch.float64
    assert KeyedDraws(1, "cpu", f64).keyed and KeyedDraws(1, "cpu", f64).calls is not None
    assert not Draws(1, "cpu", f64).keyed and HardwareDraws(1, "cpu", f64).keyed
    assert KeyedDraws(1, "cpu", torch.float16).calls is None  # the kernels draw no other dtype


def test_state_round_trip_and_a_file_without_the_keyed_words():
    """get_state/set_state carry the key and counter of the keyed steps; a
    state without them restarts the keyed stream at counter 0."""
    n, d = 32, 2
    alpha = torch.full((n,), 3.0)
    draws = KeyedDraws(9, "cpu")
    for _ in range(3):
        draws.mcmc_step(8, n, d, alpha)
    state = draws.get_state()
    assert int(state["step_counter"]) == 3
    assert tuple(int(w) for w in state["step_key"]) == philox.draws_key(9)
    nxt = draws.mcmc_step(8, n, d, alpha)
    other = KeyedDraws(4, "cpu")
    other.set_state(state)
    assert other.key == draws.key and other.counter == 3
    assert all(torch.equal(a, b) for a, b in zip(other.mcmc_step(8, n, d, alpha), nxt))
    plain = {"generator": state["generator"]}  # a file of a generator-only source
    other.set_state(plain)
    assert other.counter == 0 and other.key == draws.key
    fresh = KeyedDraws(9, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(other.mcmc_step(8, n, d, alpha),
                                                 fresh.mcmc_step(8, n, d, alpha)))


def _sampler(hardware_prng):
    return Sampler(lambda u: 20.0 * u - 10.0,
                   lambda x: -torch.sum(100.0 * (x[..., 1::2] - x[..., ::2] ** 2) ** 2
                                        + (1.0 - x[..., ::2]) ** 2, dim=-1),
                   n_dim=2, n_particles=48, vectorize=True, k_max=4, random_state=3,
                   history_capacity=24, hardware_prng=hardware_prng, device="cpu")


@pytest.mark.parametrize("hardware_prng", [False, True])
def test_run_resumed_from_its_state_equals_the_uninterrupted_one(tmp_path, monkeypatch,
                                                                 hardware_prng):
    """A run on keyed draws stopped after 6 iterations and resumed from its
    state file gives the uninterrupted run's next iterations bit for bit."""
    monkeypatch.setattr(core_mod, "Draws", KeyedDraws)
    s = _sampler(hardware_prng)
    assert s.state.draws.keyed
    for _ in range(6):
        s.sample()
    path = tmp_path / "keyed.state"
    s.save_state(path)
    ahead = [s.sample() for _ in range(3)]
    # mutations, one of which adapts past the chain's n_steps d = 2 steps
    assert all(a["beta"] > 0.0 for a in ahead) and max(a["steps"] for a in ahead) > 2
    loaded = _sampler(hardware_prng)
    loaded.load_state(path)
    assert loaded.state.draws.counter > 0
    for a, b in zip(ahead, [loaded.sample() for _ in range(3)]):
        assert a["iter"] == b["iter"] and a["beta"] == b["beta"] and a["logz"] == b["logz"]
        assert a["steps"] == b["steps"] and a["calls"] == b["calls"]
        np.testing.assert_array_equal(a["u"], b["u"])
        np.testing.assert_array_equal(a["logl"], b["logl"])
    assert loaded.state.draws.counter == s.state.draws.counter


class _KeyedJaxDraws(JaxKeyDraws):
    """The JAX key chain through the keyed draw hook: a step takes the next
    key whatever `active` says, as the loop form runs real steps only."""

    keyed = True

    def mcmc_step(self, n_candidates, n, d, gamma_shape, active=None):
        return super().mcmc_step(n_candidates, n, d, gamma_shape)


def _narrow_j(x):  # width 0.05 where loglike_j's is 0.25: the stop falls past n_steps d
    return 5.0 * loglike_j(x)


def _narrow_t(x):
    return 5.0 * loglike_t(x)


@pytest.mark.parametrize("method,d,n_steps,n_max_steps,seed", [
    ("tpcn", 2, 1, 20, 3), ("tpcn", 3, 2, 20, 7), ("rwm", 3, 1, 20, 6),
])
def test_loop_form_stops_where_jax_while_loop_stops(method, d, n_steps, n_max_steps, seed):
    """The loop form's exit (JAX's `~done`, and the cap) on an adaptive
    stop between n_steps d and n_max_steps d steps: the same step count as
    tempest_tpu.mcmc's while_loop on the same inputs and draws, u within
    atol 1e-5."""
    u, modes_j, modes_t = _problem(seed=seed, d=d, dof=5.0)
    key = jax.random.PRNGKey(200 + seed)
    jax_kernel = make_mcmc_kernel(lambda x: (_narrow_j(x), None), prior_j, d, method=method,
                                  n_steps=n_steps, n_max_steps=n_max_steps)
    x = prior_j(jax.numpy.asarray(u))
    res_j = jax_kernel(key, jax.numpy.asarray(u), x, _narrow_j(x), None,
                       jax.numpy.zeros(N, jax.numpy.int32),
                       jax.numpy.asarray(1.0, jax.numpy.float32), modes_j)
    port = MCMCKernel(lambda x, *_: (_narrow_t(x), None), prior_t, d, method=method,
                      n_steps=n_steps, n_max_steps=n_max_steps)
    ut = torch.from_numpy(u)
    xt = prior_t(ut)
    carry = _tensors(port.initial_state(ut, xt, _narrow_t(xt), modes_t.k_max))
    consts = _tensors(port.prepare(torch.zeros(N, dtype=torch.int32), torch.tensor(1.0), modes_t))
    loops = Loops("cpu")
    out = loops.repeat("mcmc", port.pred, port.body(_KeyedJaxDraws(key), N, d, keyed=True),
                       carry, consts)
    steps = int(res_j.steps)
    assert n_steps * d < steps < n_max_steps * d  # the adaptive stop, not a bound
    assert int(out["iteration"]) == steps == loops.stats["mcmc"]["bodies"]
    np.testing.assert_allclose(out["u"].numpy(), np.asarray(res_j.u), atol=1e-5)


def test_loop_form_stops_at_the_cap_on_a_nan_stop():
    """A NaN n_final never sets `done`: the loop form stops at the clamp's
    ceiling n_max_steps d, and the chunks stop there too."""
    kernel, args = _chain("tpcn")
    kernel.n_steps_min = float("nan")  # n_final = clamp(NaN, ...) = NaN
    res, draws, loops = _run(kernel, args, "repeat")
    assert int(res["iteration"]) == kernel.n_steps_cap == loops.stats["mcmc"]["bodies"]
    assert draws.counter == int(kernel.n_steps_cap)
    chunked, cdraws, _ = _run(kernel, args, 1)
    assert torch.equal(chunked["u"], res["u"]) and cdraws.counter == draws.counter
