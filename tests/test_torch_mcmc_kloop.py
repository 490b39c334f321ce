"""The K-loop form of the port's mutation (mcmc.py) against tempest_tpu.

Past N d^2 = `_GATHER_ELEMS_LIMIT` = 2^21 (N the walkers of every rank)
JAX's `make_mcmc_kernel` gathers no per-walker (N, d, d) matrices and runs
each product as one dense matmul a mode (tempest_tpu/mcmc.py:76-107,
:250-257); the port takes the same form at the same N, and says so in
`Walkers.form`.

1. `_mode_quadratic` and `_mode_matmul` against JAX's on the same numpy
   inputs (K = 4 modes, one of them empty; (N, d) = (64, 7), R = 3): rtol
   1e-5 in float32 and 1e-12 in float64 (the same products, summed in
   another order).
2. The switch at its boundary, d = 32: N = 2048 (N d^2 = 2^21) gathers,
   N = 2049 does not; under a two-rank mesh a rank's 1025 walkers (2050 in
   all) take the K-loop form and its 1024 (2048) the gathered one. A
   K-loop mutation holds no (N, d, d) tensor.
3. A whole chain past the limit, (N, d) = (2049, 32), on JAX's own draws
   (`JaxKeyDraws`), n_steps = n_max_steps = 1: u within atol 1e-5 of
   `make_mcmc_kernel`'s, as tests/test_torch_mcmc.py holds it.
4. The K-loop chain on keyed draws (K = 3 modes, one empty) in the loop
   form (`Loops.repeat`, the graphed route's) and in chunks of 1 and 8: the
   same bits, float32 and float64; and each product of the K-loop form
   against the gathered form's on the same walkers (float64, 1e-12).
5. Whole runs with every mutation in the K-loop form, clustered and not,
   and clustered under a particle mesh of one rank (gloo, in this
   process): the run loop (`run(on_device=True)`) bit for bit the
   per-iteration route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempest_tpu import mcmc as jax_mcmc
from tempest_tpu.mcmc import make_mcmc_kernel
from tempest_tpu.modes import make_mode_statistics
from tempest_tpu_torch import Sampler, interop
from tempest_tpu_torch import mcmc as tmc
from tempest_tpu_torch import modes as tm
from tempest_tpu_torch.loops import Loops
from tempest_tpu_torch.mcmc import MCMCKernel, _tensors
from test_torch_mcmc import JaxKeyDraws
from test_torch_mcmc_while import KeyedDraws

torch.set_num_threads(1)

RTOL = {"float32": 1e-5, "float64": 1e-12}


def _mode_inputs(dtype, n=64, d=7, k=4, r=3, seed=0):
    """diff (N, d), z (R, N, d), assignments in [0, K) with mode 2 empty,
    and K symmetric positive-definite matrices."""
    rng = np.random.default_rng(seed)
    diff = rng.normal(size=(n, d)).astype(dtype)
    z = rng.normal(size=(r, n, d)).astype(dtype)
    assignments = rng.choice([0, 1, 3], size=n).astype(np.int32)
    a = rng.normal(size=(k, d, d))
    mats = (a @ a.transpose(0, 2, 1) + d * np.eye(d)).astype(dtype)
    return diff, z, assignments, mats


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mode_quadratic_matches_jax(dtype):
    diff, _, assignments, mats = _mode_inputs(dtype)
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(jax_mcmc._mode_quadratic(
            jnp.asarray(diff), jnp.asarray(assignments), jnp.asarray(mats)))
    got = tmc._mode_quadratic(torch.from_numpy(diff), torch.from_numpy(assignments),
                              torch.from_numpy(mats))
    assert got.dtype == getattr(torch, dtype) and want.dtype == np.dtype(dtype)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mode_matmul_matches_jax(dtype):
    _, z, assignments, mats = _mode_inputs(dtype)
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(jax_mcmc._mode_matmul(
            jnp.asarray(z), jnp.asarray(assignments), jnp.asarray(mats)))
    got = tmc._mode_matmul(torch.from_numpy(z), torch.from_numpy(assignments),
                           torch.from_numpy(mats))
    assert got.shape == z.shape and got.dtype == getattr(torch, dtype)
    # rtol on the products' scale: an entry that nearly cancels has no
    # relative precision of its own
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RTOL[dtype] * float(np.max(np.abs(want))))


def _modes(d, k=1, dtype=torch.float32, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(k, d, d)) * 0.01
    cov = torch.tensor(a @ a.transpose(0, 2, 1) + 9e-4 * np.eye(d), dtype=dtype)
    means = torch.tensor(0.5 + 0.01 * rng.normal(size=(k, d)), dtype=dtype)
    return tm.make_mode_statistics(means, cov, torch.full((k,), 5.0, dtype=dtype))


@pytest.mark.parametrize("n_local,world,form", [
    (2048, 1, tmc.GATHERED),  # N d^2 = 2^21: the limit itself gathers
    (2049, 1, tmc.K_LOOP),
    (1024, 2, tmc.GATHERED),  # two ranks: 2048 walkers in all
    (1025, 2, tmc.K_LOOP),  # 2050 in all, though 1025 d^2 is under the limit
])
def test_the_switch_counts_every_rank(n_local, world, form):
    d = 32
    kernel = MCMCKernel(lambda x, *_: (-torch.sum(x * x, dim=-1), None), lambda v: v, d)
    kernel.world = world  # the decision alone: no collective runs with group=None
    assert tmc.gathers(n_local * world, d) == (form == tmc.GATHERED)
    modes = _modes(d)
    w = kernel.prepare(torch.zeros(n_local, dtype=torch.int32), torch.tensor(0.5), modes)
    assert w.form == form
    held = {k: tuple(v.shape) for k, v in _tensors(w).items()}
    big = {k: s for k, s in held.items() if len(s) == 3}
    if form == tmc.GATHERED:
        assert big == {"chol": (n_local, d, d), "inv": (n_local, d, d)}
    else:
        assert big == {"chol_covariances": (1, d, d), "inv_covariances": (1, d, d)}


def record_forms(monkeypatch) -> list:
    """The forms (`Walkers.form`) of the mutations `MCMCKernel.prepare`
    makes from here to the end of the test, in order."""
    taken = []
    prepare = MCMCKernel.prepare

    def recording_prepare(self, *args):
        w = prepare(self, *args)
        taken.append(w.form)
        return w

    monkeypatch.setattr(MCMCKernel, "prepare", recording_prepare)
    return taken


def test_chain_past_the_limit_matches_jax(monkeypatch):
    """(N, d) = (2049, 32): both packages take the K-loop form; the port,
    fed JAX's draws, ends where `make_mcmc_kernel` does."""
    n, d = 2049, 32
    assert not jax_mcmc._GATHER_ELEMS_LIMIT >= n * d * d and not tmc.gathers(n, d)
    rng = np.random.default_rng(21)
    u = (0.5 + 0.03 * rng.normal(size=(n, d))).astype(np.float32)
    a = rng.normal(size=(d, d)).astype(np.float32) * 0.01
    cov = (a @ a.T + 0.0009 * np.eye(d)).astype(np.float32)
    modes_j = make_mode_statistics(jnp.asarray(u.mean(0, keepdims=True)), jnp.asarray(cov[None]),
                                   jnp.asarray([5.0], jnp.float32))
    modes_t = interop.modes_from_numpy(
        {k: np.array(getattr(modes_j, k)) for k in interop.MODE_FIELDS}, "cpu")

    def loglike_j(x):
        return -0.5 * jnp.sum((x - 0.3) ** 2, axis=-1) / 0.25

    def loglike_t(x):
        return -0.5 * torch.sum((x - 0.3) ** 2, dim=-1) / 0.25

    beta, key = 0.4, jax.random.PRNGKey(2049)
    jax_kernel = make_mcmc_kernel(lambda x: (loglike_j(x), None), lambda v: 20.0 * v - 10.0, d,
                                  n_steps=1, n_max_steps=1)
    x = 20.0 * jnp.asarray(u) - 10.0
    res_j = jax_kernel(key, jnp.asarray(u), x, loglike_j(x), None, jnp.zeros(n, jnp.int32),
                       jnp.asarray(beta, jnp.float32), modes_j)

    port = MCMCKernel(lambda x, *_: (loglike_t(x), None), lambda v: 20.0 * v - 10.0, d,
                      n_steps=1, n_max_steps=1)
    taken = record_forms(monkeypatch)
    ut = torch.from_numpy(u)
    xt = 20.0 * ut - 10.0
    res_t = port(JaxKeyDraws(key), ut, xt, loglike_t(xt), torch.zeros(n, dtype=torch.int32),
                 torch.tensor(beta), modes_t)

    assert taken == [tmc.K_LOOP]
    assert res_t.steps == int(res_j.steps) == d
    np.testing.assert_allclose(res_t.u.numpy(), np.asarray(res_j.u), atol=1e-5)
    np.testing.assert_allclose(res_t.logl.numpy(), np.asarray(res_j.logl), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(res_t.acceptance), float(res_j.acceptance), atol=1e-5)
    assert not np.allclose(res_t.u.numpy(), u)  # the chain moved


def _kloop_chain(dtype, n=96, d=3, k=3):
    """A chain of K modes (mode 1 empty) forced into the K-loop form."""
    g = torch.Generator().manual_seed(3)
    u = (0.5 + 0.02 * torch.randn(n, d, generator=g)).to(dtype)
    modes = _modes(d, k, dtype)
    assignments = torch.where(torch.arange(n) % 2 == 0, 0, 2).to(torch.int32)

    def loglike(x):
        return -8.0 * torch.sum(x * x, dim=-1)

    kernel = MCMCKernel(lambda x, *_: (loglike(x), None), lambda v: 20.0 * v - 10.0, d, dtype=dtype)
    x = 20.0 * u - 10.0
    return kernel, (u, x, loglike(x), assignments, torch.tensor(0.3, dtype=dtype), modes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", ["repeat", 1, 8])
def test_kloop_chain_loop_form_and_chunks_give_the_same_bits(monkeypatch, dtype, form):
    monkeypatch.setattr(tmc, "_GATHER_ELEMS_LIMIT", 0)
    kernel, (u, x, logl, assignments, beta, modes) = _kloop_chain(dtype)

    def run(how):
        draws = KeyedDraws(5, "cpu", dtype)
        w = kernel.prepare(assignments, beta, modes)
        assert w.form == tmc.K_LOOP
        carry = _tensors(kernel.initial_state(u, x, logl, modes.k_max))
        body = kernel.body(draws, *u.shape, keyed=True)
        if how == "repeat":
            return Loops("cpu").repeat("mcmc", kernel.pred, body, carry, _tensors(w)), draws
        return kernel._chunks(Loops("cpu", {"mcmc": how}), draws, body, carry, _tensors(w),
                              keyed=True), draws

    want, wdraws = run("repeat")
    got, draws = run(form)
    steps = int(want["iteration"])
    assert steps >= kernel.n_steps_min and want["u"].dtype == dtype
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert draws.counter == wdraws.counter
    assert not torch.equal(want["u"], u)


def test_the_two_forms_agree_on_the_same_walkers(monkeypatch):
    """One mutation's products in both forms, K = 3 with an empty mode,
    float64: the quadratic and the proposal step within 1e-12."""
    kernel, (u, _, _, assignments, beta, modes) = _kloop_chain(torch.float64)
    gathered = kernel.prepare(assignments, beta, modes)
    monkeypatch.setattr(tmc, "_GATHER_ELEMS_LIMIT", 0)
    looped = kernel.prepare(assignments, beta, modes)
    assert (gathered.form, looped.form) == (tmc.GATHERED, tmc.K_LOOP)
    diff = u - gathered.mu
    z = torch.randn((4,) + u.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(looped.quadratic(diff), gathered.quadratic(diff), rtol=1e-12,
                               atol=0)
    torch.testing.assert_close(looped.mode_step(z), gathered.mode_step(z), rtol=1e-12,
                               atol=1e-15)


@pytest.fixture
def forms(monkeypatch):
    """The forms of the mutations prepared in the test, every one of them
    forced into the K-loop form (the limit lowered to 0)."""
    monkeypatch.setattr(tmc, "_GATHER_ELEMS_LIMIT", 0)
    return record_forms(monkeypatch)


@pytest.mark.parametrize("case", ["clustered", "unclustered"])
def test_kloop_run_loop_equals_the_per_iteration_route(forms, case):
    """Every mutation in the K-loop form (the limit lowered to 0), clustered
    with up to four modes and unclustered: `run(on_device=True)`, the run
    loop, gives the per-iteration route's bits, as
    tests/test_torch_fused_run.py holds it for the gathered form."""
    from test_torch_fused_run import CASES, _bimodal

    runs = []
    for on_device in (False, True):
        s = Sampler(lambda u: 8.0 * u - 4.0, _bimodal, n_dim=2, n_particles=96, vectorize=True,
                    random_state=11, device="cpu", history_capacity=16, **CASES[case])
        s.run(n_total=256, progress=False, on_device=on_device)
        runs.append(s)
    off, on = runs
    assert forms and set(forms) == {tmc.K_LOOP}
    assert on.state._iteration.loops.stats["run"]["reads"] > 0
    r_off, r_on = off.results(), on.results()
    for name in ("beta", "logz", "steps", "calls", "u", "logl", "ess"):
        assert r_off[name].tobytes() == r_on[name].tobytes(), name
    assert on.beta == 1.0
    if case == "clustered":
        assert int(on.state.cluster_model.n_clusters()) > 1


@pytest.fixture(scope="module")
def gloo_mesh(tmp_path_factory):
    """A particle mesh of one rank over gloo, in this process."""
    import torch.distributed as dist

    from tempest_tpu_torch.parallel import make_particle_mesh
    from tempest_tpu_torch.parallel.distributed import initialize

    initialize(f"file://{tmp_path_factory.mktemp('gloo') / 'store'}", 1, 0, device="cpu",
               timeout=60)
    try:
        yield make_particle_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_kloop_under_a_mesh(forms, gloo_mesh):
    """The K-loop form under a particle mesh (one rank over gloo), its
    step's sums reduced over the group: the run loop gives the
    per-iteration route's bits."""
    from test_torch_fused_run import _bimodal

    runs = []
    for on_device in (False, True):
        s = Sampler(lambda u: 8.0 * u - 4.0, _bimodal, n_dim=2, n_particles=96, vectorize=True,
                    random_state=5, device="cpu", history_capacity=16, clustering=True, k_max=4,
                    mesh=gloo_mesh)
        s.run(n_total=256, progress=False, on_device=on_device)
        runs.append(s)
    off, on = runs
    assert forms and set(forms) == {tmc.K_LOOP}
    assert on.state._iteration.loops.stats["run"]["reads"] > 0
    r_off, r_on = off.results(), on.results()
    for name in ("beta", "logz", "steps", "calls", "u", "logl"):
        assert r_off[name].tobytes() == r_on[name].tobytes(), name
    assert on.beta == 1.0
