"""The fused route of tempest_tpu_torch (fused.py, loops.py) on the CPU.

1. The mode fits batched over the k_max modes against
   `tempest_tpu.modes.fit_mode_statistics` (k_max = 8, two modes empty,
   the others stopping at different EM iterations), at the tolerances of
   tests/test_torch_student_modes.py: means rtol 1e-3, covariances rtol
   1e-3 with atol 1e-3 of the largest entry, 1/nu within 1e-3.
2. `hgm_fit` with its rounds on device counts and chunked EM loops against
   JAX on tests/test_torch_cluster.py's cases and tolerances.
3. The MCMC loop in chunks of 1, 3 and 8 steps against the loop that reads
   after every step: the walkers, log-likelihoods, efficiency, acceptance
   and step count identical, and the generator left where the per-step
   loop leaves it; with the generator's draws and with `HardwareDraws` on
   each of its three routes (the thresholds lowered so that N = 64 reaches
   them), whose call counter (host mirror and device word) must end where
   the per-step loop leaves it too.
4. One fused iteration against the JAX package's fused iteration on that
   iteration's own JAX draws (tests/test_torch_clustered_slice.py's case
   and tolerances).
5. `Sampler.run(on_device=True)` against `on_device=False` from one seed:
   the ladder and logZ identical (tests/test_sampler.py:86 asks 0.6 of
   JAX's two loops, which are bit-exact replicas as these must be).
6. No loop body reads the host: a whole fused iteration with
   `Tensor.__bool__`, `.item()`, `.tolist()`, `__int__` and `__float__`
   raising everywhere but in `Loops.read`.
7. `hardware_prng=True` in float32 on the fused route: a whole run equal
   bit for bit to the same run on the eager iteration (`iteration.py`
   with a read after every body), on the mutation-draws route and on the
   gamma-and-normal route; and a state file written by the eager route
   (`philox_key`, `philox_counter`) loads into the fused route and
   continues as the eager run does.
8. Dynamic mode and the mesh on the fused route: a dynamic run with
   `on_device=True` and False equal bit for bit to the eager iteration
   whose loops read after every body; the ESS bisection under a mesh of
   one rank (gloo, in this process) as a device loop in chunks of 1, 3
   and 8 against JAX's XLA bisection; `draws.BlockDraws`' position.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cluster import DATA, _jax_hgm, t
from test_torch_clustered_slice import D, N, _bimodal_j, _bimodal_t, _prior
from test_torch_slice import JaxIterationDraws
import test_torch_dynamic as dyn

from tempest_tpu import Sampler as JaxSampler
from tempest_tpu import modes as jm
from tempest_tpu_torch import Sampler, interop, student
from tempest_tpu_torch import cluster as tc
from tempest_tpu_torch import draws as draws_mod
from tempest_tpu_torch import modes as tm
from tempest_tpu_torch.cluster import single_cluster_model
from tempest_tpu_torch.config import SamplerConfig
from tempest_tpu_torch.draws import Draws, HardwareDraws
from tempest_tpu_torch.fused import CHUNKS, make_fused_iteration
from tempest_tpu_torch.iteration import make_iteration
from tempest_tpu_torch.loops import Loops
from tempest_tpu_torch.mcmc import MCMCKernel
from tempest_tpu_torch.steps.reweight import reweight

torch.set_num_threads(1)


def _modes_data(seed=0, n=3000, d=3):
    """Points of six Student-t clusters of different tails (one Gaussian),
    labelled 0, 1, 2, 4, 5, 7 of k_max = 8: modes 3 and 6 are empty."""
    rng = np.random.default_rng(seed)
    labels = rng.choice([0, 1, 2, 4, 5, 7], size=n)
    dofs = {0: 3.0, 1: 6.0, 2: None, 4: 15.0, 5: 2.5, 7: 40.0}
    x = np.empty((n, d), np.float32)
    for k, dof in dofs.items():
        m = labels == k
        z = rng.normal(size=(m.sum(), d))
        if dof is not None:
            z = z / np.sqrt(rng.chisquare(dof, size=(m.sum(), 1)) / dof)
        x[m] = (k + 0.3 * k * z).astype(np.float32)
    w = rng.exponential(size=n).astype(np.float32)
    return x, w, labels.astype(np.int32)


def test_batched_mode_fits_match_jax():
    x, w, labels = _modes_data()
    mj = jm.fit_mode_statistics(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels), k_max=8,
                                dof_fallback=1e6)
    loops = Loops("cpu", CHUNKS)
    mt = tm.fit_mode_statistics(t(x), t(w), t(labels), k_max=8, dof_fallback=1e6, loops=loops)
    assert mt.k_mask.tolist() == np.asarray(mj.k_mask).tolist()
    assert mt.k_mask.tolist() == [True, True, True, False, True, True, False, True]
    np.testing.assert_allclose(mt.means.numpy(), np.asarray(mj.means), rtol=1e-3, atol=1e-6)
    cov_j = np.asarray(mj.covariances)
    np.testing.assert_allclose(mt.covariances.numpy(), cov_j, rtol=1e-3,
                               atol=1e-3 * np.abs(cov_j).max())
    inv_t = 1.0 / mt.degrees_of_freedom.numpy()
    inv_j = 1.0 / np.asarray(mj.degrees_of_freedom)
    np.testing.assert_allclose(inv_t, inv_j, atol=1e-3)

    # The modes stop at different EM iterations: fitted alone, each runs
    # its own count; batched, the loop runs as long as the slowest.
    iters = []
    for k in range(8):
        alone = Loops("cpu")
        student.fit_mvstud_weighted(t(x), t(np.where(labels == k, w, 0.0)), loops=alone)
        iters.append(alone.stats["mode_em"]["bodies"])
    real = [n for k, n in enumerate(iters) if k not in (3, 6)]
    assert len(set(real)) > 2, iters
    chunk = CHUNKS["mode_em"]
    assert loops.stats["mode_em"]["bodies"] == chunk * -(-max(iters) // chunk)
    assert loops.stats["mode_em"]["reads"] == -(-max(iters) // chunk)


@pytest.mark.parametrize("split_all,leaf_fit_points", [(True, 256), (False, None)])
@pytest.mark.parametrize("data", sorted(DATA))
def test_hgm_fit_device_rounds_match_jax(data, split_all, leaf_fit_points):
    X, w, mask = DATA[data]()
    k_max = 4
    model_j, labels_j, n_j = _jax_hgm(X, w, mask, k_max, split_all, leaf_fit_points)
    loops = Loops("cpu", CHUNKS)
    model_t, labels_t, n_t = tc.hgm_fit(
        t(X), t(w), t(mask), min_points=4, threshold_modifier=1.0, k_max=k_max,
        max_rounds=k_max - 1, normalize=True, split_all=split_all,
        leaf_fit_points=leaf_fit_points, loops=loops,
    )
    assert n_t.dtype == torch.int32 and n_t.dim() == 0 and int(n_t) == int(n_j)
    np.testing.assert_array_equal(labels_t.numpy(), np.asarray(labels_j))
    assert model_t.k_mask.tolist() == np.asarray(model_j.k_mask).tolist()
    for name in ("centers", "covariances", "weights", "chol_inv", "logdet"):
        want = np.asarray(getattr(model_j, name))
        np.testing.assert_allclose(getattr(model_t, name).numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)
    # The CPU route's host loop: one read a round, and one a chunk of each
    # round's EM loop.
    rounds = loops.stats["split_round"]["reads"]
    assert 1 <= rounds <= k_max - 1 and loops.stats["gmm_em"]["reads"] >= rounds


def _chain_problem(seed=3, n=64, d=2):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.45, 0.55, size=(n, d)).astype(np.float32)
    modes = tm.make_mode_statistics(torch.zeros(d), 0.002 * torch.eye(d), torch.tensor(5.0))
    return torch.from_numpy(u), modes


# Likelihood sharpness by kernel: tpCN runs 33 steps on this problem and
# RWM 7, past the 4 steps of the first chunk.
SHARP = {"tpcn": 1.0, "rwm": 16.0}

# The draws of the chain tests: the generator's, or HardwareDraws (keyed) on
# one of its routes at N = 64, R = 8, d = 2 (R N d = 1,024), by the
# mutation-draws kernel's size limit: "mutation" that kernel (tpCN; 1 call a
# step; RWM the normal and uniform kernels, 2), "large" the gamma, normal and
# uniform kernels (13 + 1 + 1 calls a step, 2 for RWM).
ROUTES = {
    "mutation": dict(FUSED_DRAWS_MAX_ELEMS=1 << 19),
    "large": dict(FUSED_DRAWS_MAX_ELEMS=0),
}


def _route_draws(monkeypatch, route):
    """A factory of the draws of `route` (None: the generator's)."""
    if route is None:
        return Draws
    for name, value in ROUTES[route].items():
        monkeypatch.setattr(draws_mod, name, value)
    return HardwareDraws


def _draws_position(draws):
    """Everything a draws object's stream continues from, device words included."""
    pos = [draws.generator.get_state()]
    if isinstance(draws, HardwareDraws):
        pos += [draws.counter, draws.key, draws.calls.read()]
    return pos


def _same_position(a, b) -> bool:
    return torch.equal(a[0], b[0]) and a[1:] == b[1:]


def _chain_kernel(method):
    def loglike(x):
        return -0.5 * SHARP[method] * torch.sum(x * x, dim=-1)

    return MCMCKernel(lambda x, *_: (loglike(x), None), _prior, 2, method=method, n_steps=2,
                      n_max_steps=20), loglike


@pytest.mark.parametrize("route", [None, "mutation", "large"])
@pytest.mark.parametrize("chunk", [1, 3, 5, 8])
@pytest.mark.parametrize("method", ["tpcn", "rwm"])
def test_chunked_mcmc_equals_per_step_loop(chunk, method, route, monkeypatch):
    u, modes = _chain_problem()
    kernel, loglike = _chain_kernel(method)
    assign = torch.zeros(u.shape[0], dtype=torch.int32)
    x = _prior(u)
    make = _route_draws(monkeypatch, route)

    def run(loops):
        draws = make(5, "cpu")
        res = kernel(draws, u, x, loglike(x), assign, torch.tensor(0.4), modes, loops=loops)
        return res, _draws_position(draws)

    want, state_want = run(None)
    loops = Loops("cpu", {"mcmc": chunk})
    got, state_got = run(loops)
    assert got.steps == got.n_call_sweeps == want.steps > kernel.n_steps_min
    for name in ("u", "x", "logl", "efficiency", "acceptance"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert _same_position(state_got, state_want)
    if route is not None:  # the calls of the real steps, and the words agree
        per_step = {"mutation": {"tpcn": 1, "rwm": 2}, "large": {"tpcn": 15, "rwm": 2}}[route][
            method]
        assert state_got[1] == per_step * want.steps
        assert state_got[3] == (state_got[1], state_got[2])
    first = int(kernel.n_steps_min) if chunk > 1 else 1
    bodies = first + chunk * -(-(want.steps - first) // chunk)
    assert loops.stats["mcmc"]["bodies"] == bodies
    assert loops.stats["mcmc"]["reads"] == 1 + (bodies - first) // chunk


@pytest.mark.parametrize("route", [None, "mutation", "large"])
def test_chunked_mcmc_runs_past_the_stop(route, monkeypatch):
    """Chunks of 3 and 8 tpCN steps run past the stop on this problem with
    the generator's draws, chunks of 8 (the fused route's) on HardwareDraws'
    "mutation" route, and chunks of 5 on its "large" route (28 steps, which
    chunks of 3 and 8 end on), so the equality above includes putting the
    generator back and keyed steps past the stop that draw nothing."""
    u, modes = _chain_problem()
    kernel, loglike = _chain_kernel("tpcn")
    x = _prior(u)
    draws = _route_draws(monkeypatch, route)(5, "cpu")
    res = kernel(draws, u, x, loglike(x), torch.zeros(u.shape[0], dtype=torch.int32),
                 torch.tensor(0.4), modes)
    chunks = {None: (3, 8), "mutation": (8,), "large": (5,)}[route]
    assert all((res.steps - kernel.n_steps_min) % chunk for chunk in chunks), res.steps


def test_one_fused_iteration_matches_jax():
    js = JaxSampler(_prior, _bimodal_j, n_dim=D, n_particles=N, vectorize=True,
                    clustering=True, k_max=4, random_state=0, history_capacity=16)
    core = js.state
    while int(core._fused_model.n_clusters()) < 2 or int(core.hist.t) < 9:
        js.sample()
    fields_h = {k: np.array(getattr(core.hist, k)) for k in interop.HISTORY_FIELDS + ("t",)}
    fields_c = {k: np.array(getattr(core.cur, k))
                for k in interop.CURRENT_FIELDS + interop.CURRENT_COUNTERS}
    it_key = jax.random.split(core.key)[1]  # what core._next_key() hands the iteration
    out_j = js.sample()
    model_j = core._fused_model

    cfg = SamplerConfig(prior_transform=_prior, log_likelihood=_bimodal_t, n_dim=D,
                        n_particles=N, vectorize=True, clustering=True, k_max=4, device="cpu")
    iteration = make_fused_iteration(cfg, lambda x, *_: (_bimodal_t(x), None), _prior)
    th = interop.history_from_numpy(fields_h, "cpu")
    tc_ = interop.current_from_numpy(fields_c, "cpu")
    placeholder = single_cluster_model(D, 4, normalize=True)
    th, tc_, model_t = iteration(JaxIterationDraws(it_key), th, tc_, placeholder)

    assert int(model_t.n_clusters()) == int(model_j.n_clusters()) >= 2
    for name in ("centers", "covariances", "weights"):
        want = np.asarray(getattr(model_j, name))
        np.testing.assert_allclose(getattr(model_t, name).numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)
    np.testing.assert_array_equal(tc_.assignments.numpy(), out_j["assignments"])
    assert th.t == int(core.hist.t) and tc_.iteration == out_j["iter"]
    assert iteration.beta == float(tc_.beta)
    assert abs(float(tc_.beta) - out_j["beta"]) < 1e-5
    assert abs(float(tc_.logz) - out_j["logz"]) < 1e-5
    assert tc_.steps == out_j["steps"] and tc_.calls * N == out_j["calls"]
    np.testing.assert_allclose(tc_.u.numpy(), out_j["u"], atol=1e-4)
    np.testing.assert_allclose(tc_.logl.numpy(), out_j["logl"], atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(float(tc_.acceptance), out_j["acceptance"], atol=1e-4)
    for name in ("mode_em", "gmm_em", "split_round", "mcmc", "beta"):
        assert iteration.loops.stats[name]["reads"] > 0, name


@pytest.mark.parametrize("extra,fused", [
    ({}, True),
    ({"clustering": False, "cluster_every": 3}, True),
    ({"dtype": torch.float64, "hardware_prng": True}, True),  # the flag does not apply
    # The kernels read their call counter from the device (HardwareDraws),
    # so a graph replays their launches: float32 joins the fused route.
    ({"hardware_prng": True}, True),
    # The bisections of dynamic mode and of the mesh are device loops.
    ({"volume_variation": 1.0}, True),
    ({"mesh": "gloo"}, True),
    ({"mesh": "gloo", "volume_variation": 1.0}, True),
    # A host likelihood crosses to the host through its host-call kernel
    # inside the graphs, or one counted read eagerly.
    ({"host_likelihood": True}, True),
])
def test_fused_route_by_configuration(extra, fused, request):
    if "mesh" in extra:
        extra = dict(extra, mesh=request.getfixturevalue("gloo_mesh"))
    s = Sampler(_prior, _bimodal_t, n_dim=D, n_particles=N, vectorize=True, device="cpu",
                **extra)
    assert fused_iteration(s) == fused
    # run(on_device=True) takes the device run loop on the whole fused
    # route, float32 or float64 (every draw keyed on the card), on one
    # device or a mesh, in ESS or dynamic mode, with a host likelihood too
    assert (s.state._run is not None) == fused


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


def _sampler(clustering, seed=3, **extra):
    return Sampler(_prior, _bimodal_t, n_dim=D, n_particles=N, vectorize=True, k_max=4,
                   clustering=clustering, random_state=seed, history_capacity=32, device="cpu",
                   **extra)


@pytest.mark.parametrize("clustering", [True, False])
def test_run_on_device_equals_host_loop(clustering):
    runs = []
    for on_device in (False, True):
        s = _sampler(clustering)
        s.run(n_total=512, progress=False, on_device=on_device)
        runs.append(s)
    off, on = runs
    res_off, res_on = off.results(), on.results()
    assert off.state.hist.t == on.state.hist.t
    np.testing.assert_array_equal(res_on["beta"], res_off["beta"])
    np.testing.assert_array_equal(res_on["logz"], res_off["logz"])
    np.testing.assert_array_equal(res_on["steps"], res_off["steps"])
    np.testing.assert_array_equal(res_on["calls"], res_off["calls"])
    assert on.evidence()[0] == off.evidence()[0] and on.beta == 1.0
    assert abs(on.evidence()[0] - (-D * np.log(20.0))) < 0.6


READS = ("__bool__", "item", "tolist", "__int__", "__float__")


def test_loop_bodies_read_nothing(monkeypatch, gloo_mesh):
    """Every loop body and straight-line stretch between two loops of a whole
    fused iteration runs with the host reads of a tensor raising: the
    clustered iteration's loops; dynamic mode's ESS bracket and CV
    bisection; the ESS bisection under a mesh."""
    s = _sampler(True, seed=4)
    core = s.state
    while int(core.cluster_model.n_clusters()) < 2 or core.hist.t < 6:
        s.sample()
    saved = {name: getattr(torch.Tensor, name) for name in READS}

    def refuse(name):
        def read(*args, **kwargs):
            raise AssertionError(f"host read Tensor.{name} in a loop body")
        return read

    def patch(on):
        for name in READS:
            setattr(torch.Tensor, name, refuse(name) if on else saved[name])

    ran = set()

    def guarded(name, fn):
        def run(*args):
            ran.add(name)
            patch(True)
            try:
                return fn(*args)
            finally:
                patch(False)
        return run

    plain_start, plain_once = Loops.start, Loops.once
    monkeypatch.setattr(Loops, "start", lambda self, name, body, *a, **k: plain_start(
        self, name, guarded(name, body), *a, **k))
    monkeypatch.setattr(Loops, "once", lambda self, name, fn, *a, **k: plain_once(
        self, name, guarded(name, fn), *a, **k))
    def iterate(core):
        core.hist, core.cur, core.cluster_model = core._iteration(
            core.draws, core.hist, core.cur, core.cluster_model)

    try:
        iterate(core)
        assert ran == {"mode_em", "gmm_em", "split_head", "split_tail", "mcmc"}, ran
        # The same iteration with its cluster fit decided on the device, as
        # the graphed route's "hgm_fit" stretch runs it: no split-round read.
        loops = core._iteration.loops
        ran.clear()
        reads = loops.stats["split_round"]["reads"]
        with loops.stretch():
            iterate(core)
        assert ran == {"mode_em", "gmm_em", "split_head", "split_tail", "mcmc"}, ran
        assert loops.stats["split_round"]["reads"] == reads
        with pytest.raises(AssertionError, match="host read"):
            guarded("check", lambda: bool(torch.ones(1) > 0))()
        # Dynamic mode on a history of test_torch_dynamic.py whose reweight
        # bisects on the CV; the ESS bisection in a mesh run's iterations.
        ran.clear()
        th = dyn.to_port(dyn.build_history(5, 1, contract=False))
        beta_prev = float(th.beta[4])
        reweight(th, torch.tensor(beta_prev), 0.5 * dyn.port_ess(th, beta_prev), cv_target=0.09,
                 dynamic=True, loops=Loops("cpu", CHUNKS))
        assert ran == {"ess_bracket", "cv_bisect"}, ran
        mesh_run = _sampler(False, seed=4, mesh=gloo_mesh).state
        ran.clear()
        for _ in range(3):
            iterate(mesh_run)
        assert "ess_sharded" in ran, ran
    finally:
        patch(False)


def _dynamic_sampler(seed=3, **extra):
    return _sampler(False, seed=seed, volume_variation=0.3, **extra)


def test_dynamic_run_on_device_equals_per_probe_iteration():
    """Dynamic mode on the fused route with run(on_device=True) and False,
    and on the eager iteration whose loops read after every body: the same
    results bit for bit; the fused route reads its bisections once a chunk."""
    runs = []
    for on_device in (False, True):
        s = _dynamic_sampler()
        assert fused_iteration(s)
        s.run(n_total=512, progress=False, on_device=on_device)
        runs.append(s)
    eager = eager_route(_dynamic_sampler())
    assert not fused_iteration(eager)
    eager.run(n_total=512, progress=False)
    runs.append(eager)
    results = [x.results() for x in runs]
    for r in results[1:]:
        for name in ("beta", "logz", "ess", "cv", "steps", "calls"):
            assert r[name].tobytes() == results[0][name].tobytes(), name
    assert runs[0].beta == 1.0 and len({x.evidence()[0] for x in runs}) == 1
    fused, per_body = (x.state._iteration.loops.stats for x in (runs[0], eager))
    bracket = "ess_bracket"
    assert per_body[bracket]["reads"] == per_body[bracket]["bodies"] > 0
    assert fused[bracket]["bodies"] == CHUNKS[bracket] * fused[bracket]["reads"]
    assert fused[bracket]["reads"] < per_body[bracket]["reads"]
    # The CV loop reads its boundary rules once, then runs only to bisect.
    assert per_body["cv_bisect"]["reads"] >= per_body["cv_bisect"]["bodies"]
    assert fused["cv_bisect"]["reads"] <= per_body["cv_bisect"]["reads"]
    assert fused["cv_bisect"]["bodies"] % CHUNKS["cv_bisect"] == 0


def _jax_ess_history(seed, spread, fill=4, N_=64, D_=2):
    from test_torch_reweight import build_history

    return build_history(fill, N=N_, D=D_, seed=seed, spread=spread)


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("seed,spread,beta_prev,target", [
    (0, 2.0, 0.1, 128.0), (1, 8.0, 0.3, 128.0), (2, 0.5, 0.0, 128.0), (3, 4.0, 0.9, 128.0),
    (5, 12.0, 0.5, 1e9),  # stay
    (6, 0.01, 0.2, 16.0),  # jump
])
def test_sharded_ess_loop_equals_jax(gloo_mesh, seed, spread, beta_prev, target, chunk):
    """The ESS bisection under a mesh (one rank over gloo), as a device loop
    in chunks of 1, 3 and 8 bodies, against JAX's XLA bisection
    (`reweight(use_pallas=False)`): beta within 1e-5 (relative) and ESS,
    logZ at test_torch_dynamic.py's tolerances; stay and jump exact; every
    chunk length gives the per-probe loop's beta bit for bit."""
    from tempest_tpu.steps.reweight import reweight as jax_reweight
    from tempest_tpu_torch.parallel.mesh import particle_group
    from tempest_tpu_torch.steps.reweight import reweight as port_reweight
    from test_torch_reweight import to_port

    hist = _jax_ess_history(seed, spread)
    th = to_port(hist)
    group = particle_group(gloo_mesh)
    want = jax_reweight(hist, jnp.asarray(beta_prev, jnp.float32), target, use_pallas=False)
    loops = Loops("cpu", {"ess_sharded": chunk})
    got = port_reweight(th, torch.tensor(beta_prev), target, group=group, loops=loops)
    per_probe = port_reweight(th, torch.tensor(beta_prev), target, group=group)
    bj = float(want.beta)
    if bj in (beta_prev, 1.0):
        assert float(got.beta) == bj
    assert abs(float(got.beta) - bj) <= 1e-5 * max(abs(bj), 1e-30)
    assert torch.equal(got.beta, per_probe.beta)
    np.testing.assert_allclose(float(got.ess), float(want.ess), rtol=1e-5)
    np.testing.assert_allclose(float(got.logz), float(want.logz), atol=1e-5)
    stats = loops.stats["ess_sharded"]
    assert stats["reads"] >= 1 and stats["bodies"] == chunk * stats["reads"]


def test_sharded_ess_cases_cover_stay_jump_and_bisect(gloo_mesh):
    from tempest_tpu_torch.parallel.mesh import particle_group
    from tempest_tpu_torch.steps.reweight import reweight as port_reweight
    from test_torch_reweight import to_port

    seen = set()
    for seed, spread, beta_prev, target in ((0, 2.0, 0.1, 128.0), (5, 12.0, 0.5, 1e9),
                                            (6, 0.01, 0.2, 16.0)):
        th = to_port(_jax_ess_history(seed, spread))
        beta = float(port_reweight(th, torch.tensor(beta_prev), target,
                                   group=particle_group(gloo_mesh)).beta)
        seen.add("stay" if beta == beta_prev else "jump" if beta == 1.0 else "bisect")
    assert seen == {"stay", "jump", "bisect"}


@pytest.mark.parametrize("hardware", [False, True])
def test_block_draws_tell_seek_round_trip(hardware):
    """A BlockDraws is keyed as its draws are: its position is theirs
    (global: the generator's, or the keyed steps' call counter), and
    seeking back repeats the rank's block of a step."""
    from tempest_tpu_torch.draws import BlockDraws

    inner = (HardwareDraws if hardware else Draws)(7, "cpu")
    block = BlockDraws(inner, 1, 2)
    assert block.keyed == inner.keyed and block.generator is inner.generator
    assert block.calls is (inner.calls if hardware else None) and block.keyed == hardware
    gamma_shape = torch.full((64,), 3.0)
    block.mcmc_step(8, 32, 2, gamma_shape)
    p = block.calls.counter if hardware else block.tell()
    first = block.mcmc_step(8, 32, 2, gamma_shape)
    if hardware:
        assert block.calls.counter == p + 1
        block.calls.seek(p)
    else:
        assert not torch.equal(block.tell(), p)
        block.seek(p)
    again = block.mcmc_step(8, 32, 2, gamma_shape)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert first[0].shape == (8, 32, 2) and first[1].shape == (32,)


def _hw_sampler(seed=3, **extra):
    return Sampler(_prior, _bimodal_t, n_dim=D, n_particles=N, vectorize=True, k_max=4,
                   clustering=False, hardware_prng=True, random_state=seed,
                   history_capacity=32, device="cpu", **extra)


def eager_route(sampler):
    """`sampler` on the eager iteration of iteration.py, whose loops read
    after every body: the fused route's reference."""
    core = sampler.state
    counters = core._iteration.loops.counters
    core._iteration = make_iteration(core.config, core._loglike_batch, core._prior_batch)
    core._iteration.loops.counters = counters
    core._run = None
    return sampler


def fused_iteration(sampler) -> bool:
    """Whether `sampler` runs the fused iteration (its loops in chunks)."""
    return sampler.state._iteration.loops.chunks == CHUNKS


@pytest.mark.parametrize("route", ["mutation", "large"])
def test_hardware_prng_fused_run_equals_eager_iteration(route, monkeypatch):
    """N = 128, R = 8, d = 4: the mutation-draws kernel's route by default;
    past the mutation-draws kernel's limit (set to 0), the gamma, normal and
    uniform kernels'."""
    if route == "large":
        monkeypatch.setattr(draws_mod, "FUSED_DRAWS_MAX_ELEMS", 0)
    fused = _hw_sampler()
    fused.run(n_total=512, progress=False)
    eager = eager_route(_hw_sampler())
    assert fused_iteration(fused) and not fused_iteration(eager)
    eager.run(n_total=512, progress=False)
    r_f, r_e = fused.results(), eager.results()
    for name in ("beta", "logz", "steps", "calls"):
        assert r_f[name].tobytes() == r_e[name].tobytes(), name
    assert fused.evidence()[0] == eager.evidence()[0] and fused.beta == 1.0
    calls = {"mutation": 1, "large": 15}[route]
    # Every MCMC step's calls, and the keyed warm-up (2 calls) and
    # resampling (1 call) draws of each iteration.
    mutations = r_f["beta"] > 0
    assert fused.state.draws.counter == eager.state.draws.counter == calls * int(
        r_f["steps"][mutations].sum()) + 2 * int((~mutations).sum()) + int(mutations.sum())
    s_f, s_e = fused.state.draws.get_state(), eager.state.draws.get_state()
    assert all(np.array_equal(s_f[k], s_e[k]) for k in s_e) and set(s_f) == set(s_e)
    assert fused.state.draws.calls.read() == (fused.state.draws.counter, fused.state.draws.key)
    # The fused route read its MCMC loop once a chunk; the eager one once a step.
    reads = {s: x.state._iteration.loops.stats["mcmc"]["reads"] for s, x in (("f", fused),
                                                                           ("e", eager))}
    assert reads["f"] < reads["e"]


def test_hardware_prng_state_file_of_the_eager_route_continues_fused(tmp_path):
    """A file the eager route wrote (draws.philox_key and philox_counter, as
    before the fused route took the flag) loads into a fused sampler, which
    runs the next iterations as the eager run did."""
    eager = eager_route(_hw_sampler(output_dir=str(tmp_path)))
    eager.run(n_total=512, progress=False, save_every=5)
    path = tmp_path / "ps_10.state"
    with np.load(path) as f:
        assert {"draws.philox_key", "draws.philox_counter"} <= set(f.files)
        counter = int(f["draws.philox_counter"])
    assert counter > 0
    fused = _hw_sampler(seed=9)
    assert fused_iteration(fused)
    fused.load_state(path)
    assert fused.state.draws.counter == counter
    assert fused.state.draws.calls.read() == (counter, eager.state.draws.key)
    for _ in range(3):
        fused.sample()
    assert fused.state.hist.t == 13 and eager.state.hist.t > 13
    r_f, r_e = fused.results(), eager.results()
    for name in ("beta", "logz", "steps", "calls"):
        assert r_f[name].tobytes() == r_e[name][:13].tobytes(), name
    assert fused.state.draws.calls.read()[0] == fused.state.draws.counter > counter
