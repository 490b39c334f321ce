"""The device run loop (`fused.make_fused_run`) and the device word `t`.

1. State functions on the device word `t` (`state.commit`,
   `mis_denominator`, `compute_logw_and_logz`, `bootstrap_logz_err`)
   against tempest_tpu's `state.commit` and `mis_denominator` at t = 1, a
   middle t and t = capacity - 1, with -inf rows; and against the host-`t`
   formulation the port used before (slices [:t]), on the committed rows.
   Tolerance atol 1e-5 (rtol 1e-5 where values are large): float32
   logsumexp chains summed in another order; the bootstrap 1e-5.
2. The run predicate (`fused.run_predicate`) against the host's
   `_not_termination` and against JAX's `compute_logw_and_logz` +
   `ess_from_logw`, beta either side of 1 - 1e-4, the ESS either side of
   n_total, t at capacity: the same booleans.
3. `Sampler.run(on_device=True)` of both packages, the port fed JAX's key
   chain (`JaxRunDraws`): the first iterations agree value for value (beta
   and logZ within 1e-5, the committed rows within 1e-4, as
   tests/test_torch_slice.py); the whole run ends at beta = 1 with logZ
   within 0.5 of JAX's (the runs part after a few iterations, as float32
   chains in another summation order do). The same in dynamic mode, CV
   bisections included (CV within 1e-4 relative).
4. The run loop against the per-iteration route, bit for bit on the CPU:
   clustered (`cluster_every` 1 and 3), unclustered, `hardware_prng`, a
   capacity that fills and grows mid-run, dynamic mode with and without
   that; and the iteration with its decisions taken on the device (inside
   a stretch: every branch runs and `torch.where` selects, as a capture's
   warm-up runs them, and the bisections run as `Loops.repeat`) against
   the host's decisions, the warm-up branch taken at t >= 1 and dynamic
   mode's CV step included, with the same probes.
5. Keyed warm-up and resampling uniforms: the Philox formula
   (`philox.uniform`) at the counter; a draw inside an untaken conditional
   body leaves the counter where it was.
6. Float64 on the run loop, on keyed float64 draws (`KeyedDraws` in
   float64: the card's stream, `philox.draws_key`, through the plain
   versions of the `_f64` kernels): the 4-D Gaussian of
   tests/test_float64.py and a small dynamic case, bit for bit with the
   per-iteration route, the draw state included; the keyed float64 warm-up
   and resampling uniforms are `philox.uniform_f64` at the counter; and a
   float64 keyed run resumed from a state file (which carries `step_key`
   and `step_counter`) equal to the run that went on.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tempest_tpu.state as js
from tempest_tpu import Sampler as JaxSampler
from tempest_tpu.ops.tools import ess_from_logw as jax_ess_from_logw
import tempest_tpu_torch.state as ts
from tempest_tpu_torch import Sampler
from tempest_tpu_torch.draws import Draws
from tempest_tpu_torch.fused import CHUNKS, run_predicate
from tempest_tpu_torch.loops import Loops
from tempest_tpu_torch.ops import philox
from tempest_tpu_torch.ops.tools import logsumexp
from tempest_tpu_torch.steps import reweight as rw_mod

torch.set_num_threads(1)

CAP, N, D = 8, 32, 3


class KeyedDraws(Draws):
    """`Draws` keyed on the CPU too (the card's float32 draws)."""

    KEYED_ON_CPU = True


def _iterations(seed, n_iters):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n_iters):
        u = rng.uniform(size=(N, D)).astype(np.float32)
        logl = rng.normal(-8.0, 3.0, N).astype(np.float32)
        logl[rng.choice(N, 3, replace=False)] = -np.inf
        out.append(dict(u=u, logl=logl, beta=np.float32(0.13 * t), logz=np.float32(-0.3 * t)))
    return out


def _commit_host_t(h, u, logl, beta, logz):
    """The port's commit before `t` became a device word: slices [:t]."""
    t = h["t"]
    term = lambda b, l, z: np.where(np.isfinite(l), b * l - z, -np.inf)  # noqa: E731
    with np.errstate(invalid="ignore"):
        h["mis_c"][:t] = torch.logaddexp(torch.from_numpy(h["mis_c"][:t]), torch.from_numpy(
            term(beta, h["logl"][:t], logz).astype(np.float32))).numpy()
        h["beta"][t], h["logz"][t] = beta, logz
        vals = term(h["beta"][:t + 1, None], logl[None, :], h["logz"][:t + 1, None])
    h["mis_c"][t] = logsumexp(torch.from_numpy(vals.astype(np.float32)), dim=0).numpy()
    h["logl"][t] = logl
    h["t"] = t + 1


def _build(seed, n_iters):
    jh, jc = js.make_history(CAP, N, D), js.make_current(N, D)
    th, tc = ts.make_history(CAP, N, D), ts.make_current(N, D)
    old = dict(t=0, mis_c=np.full((CAP, N), -np.inf, np.float32),
               logl=np.full((CAP, N), -np.inf, np.float32),
               beta=np.zeros(CAP, np.float32), logz=np.zeros(CAP, np.float32))
    for it in _iterations(seed, n_iters):
        jc = jc.replace(u=jnp.asarray(it["u"]), x=jnp.asarray(2 * it["u"]),
                        logl=jnp.asarray(it["logl"]), beta=jnp.asarray(it["beta"]),
                        logz=jnp.asarray(it["logz"]))
        jh = js.commit(jh, jc)
        tc.u, tc.x = torch.from_numpy(it["u"]), torch.from_numpy(2 * it["u"])
        tc.logl = torch.from_numpy(it["logl"])
        tc.beta, tc.logz = torch.tensor(it["beta"]), torch.tensor(it["logz"])
        th = ts.commit(th, tc)
        _commit_host_t(old, it["u"], it["logl"], it["beta"], it["logz"])
    return jh, th, old


@pytest.mark.parametrize("n_iters", [1, 4, CAP - 1])
def test_device_t_state_functions_match_jax_and_the_host_t_ones(n_iters):
    jh, th, old = _build(n_iters, n_iters)
    assert isinstance(th.t, torch.Tensor) and th.t.dtype == torch.int64 and th.t.dim() == 0
    assert int(th.t) == th.t_host == int(jh.t) == n_iters
    for name in ("u", "x", "logl", "beta", "logz"):
        np.testing.assert_array_equal(getattr(th, name).numpy(), np.asarray(getattr(jh, name)))
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(th.mis_c.numpy(), np.asarray(jh.mis_c), **tol)
    np.testing.assert_allclose(ts.mis_denominator(th).numpy(), np.asarray(js.mis_denominator(jh)),
                               **tol)
    # the host-t formulation, on the committed rows (the rest stay -inf)
    np.testing.assert_allclose(th.mis_c.numpy()[:n_iters], old["mis_c"][:n_iters], **tol)
    assert np.all(np.isneginf(th.mis_c.numpy()[n_iters:]))
    np.testing.assert_allclose(
        ts.mis_denominator(th).numpy()[:n_iters],
        old["mis_c"][:n_iters] - np.float32(math.log(n_iters)), **tol)
    for beta in (0.0, 0.41, 1.0):
        logw_t, logz_t = ts.compute_logw_and_logz(th, beta)
        logw_j, logz_j = js.compute_logw_and_logz(jh, beta)
        np.testing.assert_allclose(logw_t.numpy(), np.asarray(logw_j), **tol)
        np.testing.assert_allclose(float(logz_t), float(logz_j), atol=1e-5)
    key = jax.random.PRNGKey(n_iters)
    uniforms = np.array(jax.random.uniform(key, (64, CAP)))
    err_j = float(js.bootstrap_logz_err(jh, key, n_bootstrap=64))
    err_t = float(ts.bootstrap_logz_err(th, torch.from_numpy(uniforms)))
    assert abs(err_t - err_j) < 1e-5


def test_commit_writes_through_the_device_word_in_place():
    """Slot t is written in place: the buffers keep their storage, `t` its
    tensor, and the mirror follows."""
    _, th, _ = _build(5, 2)
    ptrs = {k: getattr(th, k).data_ptr() for k in ("u", "logl", "mis_c", "beta", "t")}
    tc = ts.make_current(N, D)
    tc.logl = torch.zeros(N)
    ts.commit(th, tc)
    assert {k: getattr(th, k).data_ptr() for k in ptrs} == ptrs
    assert int(th.t) == th.t_host == 3 and torch.equal(th.logl[2], torch.zeros(N))
    grown = ts.grow_history(th, 2 * CAP)
    assert int(grown.t) == grown.t_host == 3 and grown.t is not th.t


# ---------------------------------------------------------------------------
# 2. The run predicate
# ---------------------------------------------------------------------------
def _sampler(**kw):
    args = dict(n_dim=2, n_particles=64, vectorize=True, clustering=False, random_state=5,
                history_capacity=16, device="cpu")
    args.update(kw)
    return Sampler(lambda u: 20.0 * u - 10.0, lambda x: -0.5 * torch.sum(x * x, dim=-1), **args)


@pytest.mark.parametrize("beta", [1.0 - 1.5e-4, 1.0 - 1e-4, 1.0 - 0.5e-4, 1.0])
@pytest.mark.parametrize("n_total_scale", [0.5, 2.0])
def test_run_predicate_matches_the_host_test_and_jax(beta, n_total_scale):
    s = _sampler()
    for _ in range(6):
        s.sample()
    core = s.state
    hist = core.hist
    logw_j, _ = js.compute_logw_and_logz(_jax_history(hist), 1.0)
    ess = float(jax_ess_from_logw(logw_j))
    n_total = int(round(ess * n_total_scale))
    core.n_total = n_total
    beta_t = torch.tensor(beta, dtype=torch.float32)
    core.cur.beta = beta_t
    want = bool(np.float32(1.0) - np.float32(beta) >= np.float32(1e-4)) or ess < n_total
    loops = Loops("cpu")
    got = bool(run_predicate(loops, hist, beta_t, n_total))
    assert got == core._not_termination() == core._not_termination(float(beta_t)) == want
    full = ts.grow_history(hist, hist.capacity + 1)  # a copy, then filled
    while full.count() < full.capacity:
        ts.commit(full, core.cur)
    assert int(full.t) == full.capacity and not bool(run_predicate(loops, full, beta_t, n_total))


def _jax_history(th):
    jh = js.make_history(th.capacity, th.n_particles, th.n_dim)
    return jh.replace(**{k: jnp.asarray(getattr(th, k).numpy()) for k in
                         ("u", "x", "logl", "mis_c", "beta", "logz")},
                      t=jnp.asarray(th.count(), jnp.int32))


# ---------------------------------------------------------------------------
# 3. Against JAX's make_fused_run
# ---------------------------------------------------------------------------
class JaxRunDraws:
    """The draws of tempest_tpu's fused run from its master key: each
    iteration takes `key, k = split(key)` (fused.py:430); the warm-up draws
    from `split(k)` (steps/mutate.py:36), the mutation resamples from and
    mutates on `split(k, 3)[1:]` (fused.py:89)."""

    def __init__(self, key):
        self.key = key

    def _next(self):
        self.key, k = jax.random.split(self.key)
        return k

    def warmup(self, n, d):
        k_draw, k_patch = jax.random.split(self._next())
        u = np.array(jax.random.uniform(k_draw, (n, d), dtype=jnp.float32))
        p = np.array(jax.random.uniform(k_patch, (n,), dtype=jnp.float32))
        return torch.from_numpy(u), torch.from_numpy(p)

    def resample(self, n, method):
        _, k_res, self.k_mut = jax.random.split(self._next(), 3)
        return torch.from_numpy(np.array(jax.random.uniform(k_res, (n,), dtype=jnp.float32)))

    def mcmc_step(self, n_candidates, n, d, gamma_shape):
        self.k_mut, k_g, k_p, k_a = jax.random.split(self.k_mut, 4)
        g = torch.from_numpy(np.array(
            jax.random.gamma(k_g, jnp.asarray(gamma_shape.numpy()), dtype=jnp.float32)))
        z = np.array(jax.random.normal(k_p, (n_candidates, n, d), dtype=jnp.float32))
        acc = np.array(jax.random.uniform(k_a, (n,), dtype=jnp.float32))
        return torch.from_numpy(z), g, torch.from_numpy(acc)


def test_run_route_against_jax_make_fused_run():
    """A 3-D Gaussian, N = 128, unclustered; JAX's whole run and the port's
    on JAX's key chain. The first 6 iterations (two warm-ups, then
    mutations) agree value for value."""
    d, n = 3, 128
    kw = dict(n_dim=d, n_particles=n, vectorize=True, clustering=False, random_state=7,
              history_capacity=32)
    jsamp = JaxSampler(lambda u: 20.0 * u - 10.0, lambda x: -0.5 * jnp.sum(x * x, axis=-1), **kw)
    key = jsamp.state.key
    jsamp.run(n_total=512, progress=False, on_device=True)
    tsamp = Sampler(lambda u: 20.0 * u - 10.0, lambda x: -0.5 * torch.sum(x * x, dim=-1),
                    device="cpu", **kw)
    tsamp.state.draws = JaxRunDraws(key)
    tsamp.run(n_total=512, progress=False, on_device=True)
    assert tsamp.state._iteration.loops.stats["run"]["reads"] > 0  # the run loop ran
    r_j, r_t = jsamp.results(), tsamp.results()
    first = 6
    assert np.all(r_t["beta"][:2] == 0.0) and r_t["beta"][first - 1] > 0.0
    np.testing.assert_allclose(r_t["beta"][:first], r_j["beta"][:first], atol=1e-5)
    np.testing.assert_allclose(r_t["logz"][:first], r_j["logz"][:first], atol=1e-5)
    np.testing.assert_array_equal(r_t["steps"][:first], r_j["steps"][:first])
    np.testing.assert_allclose(r_t["u"][:first], r_j["u"][:first], atol=1e-4)
    np.testing.assert_allclose(r_t["logl"][:first], r_j["logl"][:first], atol=1e-4, rtol=1e-5)
    assert tsamp.beta == 1.0 and float(jsamp.beta) == 1.0
    assert abs(tsamp.evidence()[0] - float(jsamp.evidence()[0])) < 0.5


def test_dynamic_run_route_against_jax_make_fused_run():
    """Dynamic mode: JAX's whole run (`make_fused_run`, its bracket and CV
    bisection inside the run's `while_loop`) and the port's run loop on
    JAX's key chain, a 3-D Gaussian, N = 128: the first iterations agree
    value for value (CV bisections among them), CV included, at the
    tolerances of the ESS-mode test."""
    d, n = 3, 128
    kw = dict(n_dim=d, n_particles=n, vectorize=True, clustering=False, random_state=7,
              history_capacity=32, volume_variation=0.05)
    jsamp = JaxSampler(lambda u: 20.0 * u - 10.0, lambda x: -0.5 * jnp.sum(x * x, axis=-1), **kw)
    key = jsamp.state.key
    jsamp.run(n_total=512, progress=False, on_device=True)
    tsamp = Sampler(lambda u: 20.0 * u - 10.0, lambda x: -0.5 * torch.sum(x * x, dim=-1),
                    device="cpu", **kw)
    assert tsamp.state._iteration.loops.chunks == CHUNKS
    tsamp.state.draws = JaxRunDraws(key)
    tsamp.run(n_total=512, progress=False, on_device=True)
    stats = tsamp.state._iteration.loops.stats
    assert stats["run"]["reads"] > 0 and stats["cv_bisect"]["bodies"] > 0  # CV bisections ran
    r_j, r_t = jsamp.results(), tsamp.results()
    first = 8
    assert np.all(r_t["beta"][:2] == 0.0) and r_t["beta"][first - 1] > 0.0
    np.testing.assert_allclose(r_t["beta"][:first], r_j["beta"][:first], atol=1e-5)
    np.testing.assert_allclose(r_t["logz"][:first], r_j["logz"][:first], atol=1e-5)
    np.testing.assert_allclose(r_t["cv"][:first], r_j["cv"][:first], rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(r_t["steps"][:first], r_j["steps"][:first])
    np.testing.assert_allclose(r_t["u"][:first], r_j["u"][:first], atol=1e-4)
    np.testing.assert_allclose(r_t["logl"][:first], r_j["logl"][:first], atol=1e-4, rtol=1e-5)
    assert tsamp.beta == 1.0 and float(jsamp.beta) == 1.0
    assert abs(tsamp.evidence()[0] - float(jsamp.evidence()[0])) < 0.5


# ---------------------------------------------------------------------------
# 4. The run loop against the per-iteration route
# ---------------------------------------------------------------------------
def _bimodal(x):
    a = -0.5 * torch.sum(((x - 2.0) / 0.6) ** 2, dim=-1)
    b = -0.5 * torch.sum(((x + 2.0) / 0.6) ** 2, dim=-1)
    return torch.logaddexp(a, b)


CASES = {
    "clustered": dict(clustering=True, k_max=4),
    "cluster_every_3": dict(clustering=True, k_max=4, cluster_every=3),
    "unclustered": dict(clustering=False),
    "hardware_prng": dict(clustering=True, k_max=4, hardware_prng=True),
    "capacity_fills": dict(clustering=False, history_capacity=4),
    "dynamic": dict(clustering=False, volume_variation=0.03),
    "dynamic_capacity_fills": dict(clustering=False, volume_variation=0.03, history_capacity=4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_loop_equals_the_per_iteration_route(case):
    runs = []
    for on_device in (False, True):
        s = Sampler(lambda u: 8.0 * u - 4.0, _bimodal, n_dim=2, n_particles=96, vectorize=True,
                    random_state=11, device="cpu", **{"history_capacity": 16, **CASES[case]})
        s.run(n_total=256, progress=False, on_device=on_device)
        runs.append(s)
    off, on = runs
    assert on.state._iteration.loops.chunks == CHUNKS and on.state._iteration.loops.stats["run"]["reads"] > 0
    assert "run" not in off.state._iteration.loops.stats
    r_off, r_on = off.results(), on.results()
    for name in ("beta", "logz", "steps", "calls", "u", "logl", "ess", "cv"):
        assert r_off[name].tobytes() == r_on[name].tobytes(), name
    assert off.evidence()[0] == on.evidence()[0] and on.beta == 1.0
    assert off.state.cur.iteration == on.state.cur.iteration == on.state.hist.count()
    assert isinstance(on.state.cur.iteration, int)
    assert bool(on.state.cluster_model.fitted) == bool(off.state.cluster_model.fitted)
    if case.endswith("capacity_fills"):
        assert on.state.hist.capacity > 4
    if case.startswith("dynamic"):  # CV bisections ran inside the run loop
        assert on.state._iteration.loops.stats["cv_bisect"]["bodies"] > 0
    s_off, s_on = off.state.draws.get_state(), on.state.draws.get_state()
    assert all(np.array_equal(s_off[k], s_on[k]) for k in s_off)


@pytest.mark.parametrize("case", ["clustered", "cluster_every_3", "unclustered", "dynamic"])
def test_device_decisions_equal_host_decisions(case):
    """Each iteration of a run on keyed draws, taken once with the host's
    decisions and once inside a stretch (`cur.beta == 0`, the cadence on the
    device words of the iteration counter and `model.fitted`, dynamic
    mode's CV step on the bracket's `crossing`: every branch runs,
    `torch.where` selects, draws and probes in an untaken branch count
    nothing; the bisections run as `Loops.repeat`): the same bits and
    probes, the second iteration's warm-up branch at t = 1 included."""
    samplers = []
    for _ in range(2):
        s = Sampler(lambda u: 8.0 * u - 4.0, _bimodal, n_dim=2, n_particles=64,
                    vectorize=True, random_state=4, history_capacity=16, device="cpu",
                    **CASES[case])
        s.state.draws = KeyedDraws(4, "cpu")
        samplers.append(s)
    host, dev = (s.state for s in samplers)
    dev._iteration.loops.counters = [dev.draws.calls]
    host.execute_iteration()  # t = 0: the first iteration's values, on the host
    dev.execute_iteration()
    warmups_at_t = []
    probes = []
    for _ in range(7):
        t = host.hist.count()
        before = dict(rw_mod.PROBES)
        host.execute_iteration()
        middle = dict(rw_mod.PROBES)
        device_words(dev)
        with dev._iteration.loops.stretch():
            dev.hist, dev.cur, dev.cluster_model = dev._iteration(
                dev.draws, dev.hist, dev.cur, dev.cluster_model)
        host_words(dev)
        probes.append([{k: b[k] - a[k] for k in a}
                       for a, b in ((before, middle), (middle, dict(rw_mod.PROBES)))])
        if host.compute_results()["beta"][-1] == 0.0:
            warmups_at_t.append(t)
        r_h, r_d = host.compute_results(), dev.compute_results()
        for name in ("beta", "logz", "steps", "calls", "u", "x", "logl", "mis_c"):
            if name == "mis_c":
                assert torch.equal(host.hist.mis_c, dev.hist.mis_c)
                continue
            assert r_h[name].tobytes() == r_d[name].tobytes(), name
        assert host.draws.counter == dev.draws.counter
        for f in ("centers", "covariances", "k_mask"):
            assert torch.equal(getattr(host.cluster_model, f), getattr(dev.cluster_model, f))
    assert 1 in warmups_at_t and host.compute_results()["beta"][-1] > 0.0
    assert all(h == d for h, d in probes), probes
    if case == "dynamic":  # the CV step's bisection ran inside the stretch
        assert sum(h["reweights"] for h, _ in probes) == 7
        assert dev._iteration.loops.stats["cv_bisect"]["bodies"] > 0
        assert not dev._iteration.loops.stats["cv_step"].get("reads")


def device_words(core):
    """The active set's counters and the model's flag as device words, as
    the run loop carries them."""
    core.cur.iteration = torch.tensor(core.cur.iteration, dtype=torch.int64)
    core.cur.steps = torch.as_tensor(core.cur.steps, dtype=torch.int32)
    core.cur.calls = torch.as_tensor(core.cur.calls, dtype=torch.int32)
    core.cluster_model.fitted = torch.tensor(bool(core.cluster_model.fitted))
    core.hist.t_host = None


def host_words(core):
    core.cur.iteration = int(core.cur.iteration)
    core.cluster_model.fitted = bool(core.cluster_model.fitted)
    core.hist.t_host = int(core.hist.t)


# ---------------------------------------------------------------------------
# 5. Keyed warm-up and resampling uniforms
# ---------------------------------------------------------------------------
def test_keyed_warmup_and_resample_uniforms_are_the_philox_formula():
    draws = KeyedDraws(21, "cpu")
    key = philox.draws_key(21)
    u, patch = draws.warmup(16, 3)
    assert torch.equal(u.reshape(-1), philox.uniform(key, 0, 48, "cpu"))
    assert torch.equal(patch, philox.uniform(key, 1, 16, "cpu"))
    assert draws.counter == 2
    r = draws.resample(16, "mult")
    assert torch.equal(r, philox.uniform(key, 2, 16, "cpu")) and draws.counter == 3
    s = draws.resample(16, "syst")
    assert s.shape == () and torch.equal(s.reshape(1), philox.uniform(key, 3, 1, "cpu"))
    assert float(u.min()) > 0.0 and float(u.max()) <= 1.0
    assert not Draws(21, "cpu").keyed  # the CPU's Draws keep the generator


@pytest.mark.parametrize("taken", [False, True])
def test_a_draw_in_an_untaken_body_leaves_the_counter(taken):
    draws = KeyedDraws(3, "cpu")
    loops = Loops("cpu", counters=[draws.calls])
    state = {"r": torch.zeros(8)}
    pred = torch.tensor(taken)
    with loops.stretch():
        out = loops.when(pred, lambda s: {"r": draws.resample(8, "mult")}, state, "probe")
        loops.when(pred, lambda s: {"r": draws.warmup(8, 1)[0][:, 0]}, state, "probe")
    assert draws.counter == (3 if taken else 0) and not draws.calls.guards
    want = philox.uniform(philox.draws_key(3), 0, 8, "cpu") if taken else torch.zeros(8)
    assert torch.equal(out["r"], want)
    # outside a stretch the host decides: an untaken body does not run
    assert loops.when(torch.tensor(False), lambda s: {"r": draws.resample(8, "mult")},
                      state, "probe") is state
    assert draws.counter == (3 if taken else 0) and loops.stats["probe"]["reads"] == 1


# ---------------------------------------------------------------------------
# 6. Float64 on the run loop
# ---------------------------------------------------------------------------
def _gauss4(x):
    return -0.5 * torch.sum(x * x, dim=-1) - 0.5 * 4 * math.log(2 * math.pi)


F64_CASES = {
    "gaussian4": dict(prior=lambda u: 20.0 * u - 10.0, loglike=_gauss4, n_dim=4,
                      n_particles=128, clustering=False, n_total=512),
    "dynamic": dict(prior=lambda u: 8.0 * u - 4.0, loglike=_bimodal, n_dim=2, n_particles=96,
                    clustering=False, volume_variation=0.03, n_total=256),
}


def _f64_sampler(case, seed=11, **extra):
    kw = dict(F64_CASES[case])
    prior, loglike, n_total = kw.pop("prior"), kw.pop("loglike"), kw.pop("n_total")
    s = Sampler(prior, loglike, vectorize=True, random_state=seed, device="cpu",
                history_capacity=16, dtype=torch.float64, **kw, **extra)
    s.state.draws = KeyedDraws(seed, "cpu", torch.float64)
    s.state._iteration.loops.counters = [s.state.draws.calls]
    return s, n_total


@pytest.mark.parametrize("case", sorted(F64_CASES))
def test_float64_run_loop_equals_the_per_iteration_route(case):
    runs = []
    for on_device in (False, True):
        s, n_total = _f64_sampler(case)
        assert s.state._iteration.loops.chunks == CHUNKS and s.state.draws.keyed
        s.run(n_total=n_total, progress=False, on_device=on_device)
        runs.append(s)
    off, on = runs
    assert on.state._iteration.loops.stats["run"]["reads"] > 0
    assert "run" not in off.state._iteration.loops.stats
    r_off, r_on = off.results(), on.results()
    assert r_on["u"].dtype == np.float64 and on.beta == 1.0
    for name in ("beta", "logz", "steps", "calls", "u", "logl", "ess", "cv"):
        assert r_off[name].tobytes() == r_on[name].tobytes(), name
    assert off.evidence()[0] == on.evidence()[0] and math.isfinite(on.evidence()[0])
    assert off.state.draws.counter == on.state.draws.counter > 0
    s_off, s_on = off.state.draws.get_state(), on.state.draws.get_state()
    assert set(s_on) == {"generator", "step_key", "step_counter"}
    assert all(np.array_equal(s_off[k], s_on[k]) for k in s_off)
    if case == "dynamic":
        assert on.state._iteration.loops.stats["cv_bisect"]["bodies"] > 0


def test_keyed_float64_warmup_and_resample_uniforms_are_the_philox_formula():
    draws = KeyedDraws(21, "cpu", torch.float64)
    key = philox.draws_key(21)
    u, patch = draws.warmup(16, 3)
    assert u.dtype == patch.dtype == torch.float64
    assert torch.equal(u.reshape(-1), philox.uniform_f64(key, 0, 48, "cpu"))
    assert torch.equal(patch, philox.uniform_f64(key, 1, 16, "cpu"))
    r = draws.resample(16, "mult")
    assert torch.equal(r, philox.uniform_f64(key, 2, 16, "cpu")) and draws.counter == 3
    assert not Draws(21, "cpu", torch.float64).keyed  # the CPU's Draws keep the generator


def test_float64_keyed_run_resumes_from_a_state_file(tmp_path):
    """A float64 keyed run's state file holds the call counter's words; a
    fresh sampler that loads it runs the next iterations as the run that
    went on did, bit for bit."""
    s, _ = _f64_sampler("gaussian4", seed=3)
    for _ in range(5):
        s.sample()
    path = tmp_path / "f64.state"
    s.save_state(path)
    saved = s.state.draws.counter
    with np.load(path, allow_pickle=True) as f:
        assert int(f["draws.step_counter"]) == saved > 0
    went_on = [s.sample() for _ in range(3)]
    r, _ = _f64_sampler("gaussian4", seed=99)
    r.load_state(path)
    assert r.state.draws.counter == saved and r.state.draws.key == s.state.draws.key
    resumed = [r.sample() for _ in range(3)]
    for a, b in zip(went_on, resumed):
        for k in ("beta", "logz", "steps", "calls", "iter"):
            assert a[k] == b[k], k
        assert a["u"].tobytes() == b["u"].tobytes() and a["u"].dtype == np.float64
    assert r.state.draws.counter == s.state.draws.counter
