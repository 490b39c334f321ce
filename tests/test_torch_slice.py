"""The port's whole unclustered slice against tempest_tpu.

1. One iteration, value for value: the JAX sampler runs a 4-D Gaussian
   (N = 128), and a 100-D one (N = 256, the rosenbrock100 path's width),
   past its warm-up; its state goes through `interop` into the port, which
   runs the next iteration on the JAX iteration's own draws (the resample
   uniforms from k_res and the MCMC key chain from k_mut, fused.py:89).
   beta, logZ, the fitted mode and the mutated particles must agree with
   what JAX computes for that iteration. Tolerances: beta and logZ 1e-5
   (the same float32 bisection and logsumexp), mode rtol 1e-3 (float32 EM
   with other summation orders), particles atol 1e-4 after the whole
   adaptive chain. The 4-D mutation gathers its per-walker matrices; the
   100-D one (N d^2 = 2.56 M > 2^21) takes the K-loop form, as JAX's does.
2. A whole run on the CPU: the tests/test_end_to_end.py problem and bar.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempest_tpu import Sampler as JaxSampler
from tempest_tpu.config import TRIM_BINS, TRIM_ESS
from tempest_tpu.modes import fit_global_mode as jax_fit_global_mode
from tempest_tpu.ops.tools import trim_weights_mask as jax_trim
from tempest_tpu.steps.reweight import reweight as jax_reweight
from tempest_tpu_torch import Sampler, interop
from tempest_tpu_torch.cluster import single_cluster_model
from tempest_tpu_torch.config import SamplerConfig
from tempest_tpu_torch.iteration import make_iteration, select_fit_points
from tempest_tpu_torch.mcmc import GATHERED, K_LOOP
from tempest_tpu_torch.modes import fit_global_mode
from tempest_tpu_torch.steps.reweight import reweight
from test_torch_mcmc_kloop import record_forms

torch.set_num_threads(1)

D4, N4 = 4, 128


class JaxIterationDraws:
    """The draws of one tempest_tpu mutate branch, from its iteration key."""

    def __init__(self, it_key):
        _k_train, self.k_res, self.k_mut = jax.random.split(it_key, 3)

    def resample(self, n, method):
        assert method == "mult"
        return torch.from_numpy(np.array(jax.random.uniform(self.k_res, (n,), dtype=jnp.float32)))

    def mcmc_step(self, n_candidates, n, d, gamma_shape):
        self.k_mut, k_g, k_p, k_a = jax.random.split(self.k_mut, 4)
        g = torch.from_numpy(np.array(
            jax.random.gamma(k_g, jnp.asarray(gamma_shape.numpy()), dtype=jnp.float32)))
        z = np.array(jax.random.normal(k_p, (n_candidates, n, d), dtype=jnp.float32))
        acc = np.array(jax.random.uniform(k_a, (n,), dtype=jnp.float32))
        return torch.from_numpy(z), g, torch.from_numpy(acc)


def _prior(u):
    return 20.0 * u - 10.0


def _loglike_j(x):
    return -0.5 * jnp.sum(x * x, axis=-1)


def _loglike_t(x):
    return -0.5 * torch.sum(x * x, dim=-1)


def test_one_iteration_value_for_value(monkeypatch):
    assert _one_iteration(monkeypatch, D4, N4) == [GATHERED]  # N d^2 = 2048


def test_one_iteration_value_for_value_at_d100(monkeypatch):
    """The rosenbrock100 path's width: d = 100 (the CV's eigenvalues, the
    100 x 100 mode covariance), at N = 256 and the same tolerances. N d^2 =
    2.56 M is past the gather limit (2^21): JAX's mutation and the port's
    take the K-loop form."""
    assert _one_iteration(monkeypatch, 100, 256) == [K_LOOP]


def _one_iteration(monkeypatch, d, n):
    """The checks above; returns the forms of the port's mutations
    (`Walkers.form`)."""
    forms = record_forms(monkeypatch)
    js = JaxSampler(_prior, _loglike_j, n_dim=d, n_particles=n, vectorize=True,
                    clustering=False, random_state=0, history_capacity=16)
    while js.state.cur.beta == 0.0 or int(js.state.hist.t) < 5:
        js.sample()
    core = js.state
    hist_j, cur_j = core.hist, core.cur
    fields_h = {k: np.array(getattr(hist_j, k)) for k in interop.HISTORY_FIELDS + ("t",)}
    fields_c = {k: np.array(getattr(cur_j, k))
                for k in interop.CURRENT_FIELDS + interop.CURRENT_COUNTERS}
    it_key = jax.random.split(core.key)[1]  # what core._next_key() hands the iteration

    # What JAX computes in that iteration, stage by stage ...
    target = 2.0 * n
    rw_j = jax_reweight(hist_j, cur_j.beta, target, use_pallas=False)
    _, w_trim = jax_trim(rw_j.weights.reshape(-1), mask=hist_j.sample_mask().reshape(-1),
                         ess=TRIM_ESS, bins=TRIM_BINS)
    modes_j = jax_fit_global_mode(hist_j.u.reshape(d, -1).T, w_trim, dof_fallback=1e6)
    # ... and as one iteration.
    out_j = js.sample()

    th = interop.history_from_numpy(fields_h, "cpu")
    tc = interop.current_from_numpy(fields_c, "cpu")
    rw_t = reweight(th, tc.beta, target)
    assert abs(float(rw_t.beta) - float(rw_j.beta)) < 1e-5
    assert abs(float(rw_t.logz) - float(rw_j.logz)) < 1e-5
    modes_t = fit_global_mode(*select_fit_points(th, rw_t.weights, 4096)[:2], dof_fallback=1e6)
    np.testing.assert_allclose(modes_t.means.numpy(), np.asarray(modes_j.means), rtol=1e-3)
    cov_j = np.asarray(modes_j.covariances)
    np.testing.assert_allclose(modes_t.covariances.numpy(), cov_j, rtol=1e-3,
                               atol=1e-3 * np.abs(cov_j).max())
    assert abs(1 / float(modes_t.degrees_of_freedom[0])
               - 1 / float(modes_j.degrees_of_freedom[0])) < 1e-3

    cfg = SamplerConfig(prior_transform=_prior, log_likelihood=_loglike_t, n_dim=d,
                        n_particles=n, vectorize=True, clustering=False, device="cpu")
    iteration = make_iteration(cfg, lambda x, *_: (_loglike_t(x), None), _prior)
    th, tc, _ = iteration(JaxIterationDraws(it_key), th, tc, single_cluster_model(d, 1))

    assert th.t == int(core.hist.t) and tc.iteration == out_j["iter"]
    assert abs(float(tc.beta) - out_j["beta"]) < 1e-5
    assert abs(float(tc.logz) - out_j["logz"]) < 1e-5
    assert tc.steps == out_j["steps"] and tc.calls * n == out_j["calls"]
    np.testing.assert_allclose(tc.u.numpy(), out_j["u"], atol=1e-4)
    np.testing.assert_allclose(tc.logl.numpy(), out_j["logl"], atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(float(tc.acceptance), out_j["acceptance"], atol=1e-4)
    np.testing.assert_allclose(th.mis_c.numpy(), np.asarray(core.hist.mis_c), atol=1e-4,
                               rtol=1e-5)
    return forms


N_DIM = 10
ANALYTIC_LOGZ = -N_DIM * math.log(20.0)


def _gauss_loglike(x):
    return -0.5 * torch.sum(x * x, dim=-1) - 0.5 * N_DIM * math.log(2 * math.pi)


@pytest.mark.parametrize("seed", [0, 1])
def test_10d_gaussian_end_to_end(seed):
    """The bar of tests/test_end_to_end.py, on the port."""
    s = Sampler(_prior, _gauss_loglike, n_dim=N_DIM, n_particles=512, vectorize=True,
                clustering=False, random_state=seed, history_capacity=64, device="cpu")
    s.run(n_total=2048, progress=False, on_device=True)

    assert s.beta > 0.99
    logz, err = s.evidence()
    assert err is None and abs(logz - ANALYTIC_LOGZ) < 0.5
    assert s.state.posterior_ess() >= 2048

    x, w, logl = s.posterior()
    mean = np.average(x, axis=0, weights=w)
    var = np.average((x - mean) ** 2, axis=0, weights=w)
    np.testing.assert_allclose(mean, 0.0, atol=0.25)
    np.testing.assert_allclose(var, 1.0, atol=0.5)
    assert float(s.state.cur.acceptance) > 0.1

    xs, ws, _ = s.posterior(resample=True)
    assert xs.shape == x.shape and np.allclose(ws, 1.0 / len(ws))


# ---------------------------------------------------------------------------
# Blobs, the refit cadence and the bootstrap error, value for value
# ---------------------------------------------------------------------------
def _blob_loglike_j(x):
    return -0.5 * jnp.sum(x * x), jnp.sum(x), x[0]


def _blob_loglike_t(x):
    return -0.5 * torch.sum(x * x), torch.sum(x), x[0]


def _state_fields(core):
    hist = {k: np.array(getattr(core.hist, k)) for k in interop.HISTORY_FIELDS + ("t", "blobs")
            if getattr(core.hist, k) is not None}
    cur = {k: np.array(getattr(core.cur, k))
           for k in interop.CURRENT_FIELDS + interop.CURRENT_COUNTERS + ("blobs",)
           if getattr(core.cur, k) is not None}
    return hist, cur


def test_one_iteration_with_blobs_value_for_value():
    """Per-point functions (the default call form) with two blob values:
    the blob rows follow resampling and the MCMC accept as in JAX (blobs
    atol 1e-4, as the particles)."""
    js = JaxSampler(_prior, _blob_loglike_j, n_dim=D4, n_particles=N4, clustering=False,
                    random_state=1, history_capacity=16)
    while js.state.cur.beta == 0.0 or int(js.state.hist.t) < 4:
        js.sample()
    core = js.state
    fields_h, fields_c = _state_fields(core)
    it_key = jax.random.split(core.key)[1]
    out_j = js.sample()

    s = Sampler(_prior, _blob_loglike_t, n_dim=D4, n_particles=N4, clustering=False,
                device="cpu")
    assert s.state.blob_schema.width == 2 and not s.vectorize
    iteration = make_iteration(s.state.config, s.state._loglike_batch, s.state._prior_batch)
    th = interop.history_from_numpy(fields_h, "cpu")
    tc = interop.current_from_numpy(fields_c, "cpu")
    th, tc, _ = iteration(JaxIterationDraws(it_key), th, tc, single_cluster_model(D4, 1))

    assert abs(float(tc.beta) - out_j["beta"]) < 1e-5 and tc.steps == out_j["steps"]
    np.testing.assert_allclose(tc.u.numpy(), out_j["u"], atol=1e-4)
    np.testing.assert_allclose(tc.blobs.numpy(), np.asarray(core.cur.blobs), atol=1e-4)
    np.testing.assert_allclose(tc.blobs.numpy(), out_j["blobs"], atol=1e-4)
    np.testing.assert_allclose(th.blobs.numpy(), np.asarray(core.hist.blobs), atol=1e-4)
    np.testing.assert_allclose(tc.blobs[:, 0].numpy(), tc.x.sum(dim=1).numpy(), atol=1e-5)


D_BI, N_BI = 4, 128
NORM_BI = -0.5 * D_BI * math.log(2 * math.pi * 0.25)


def _bimodal_j(x):
    a = NORM_BI - 0.5 * jnp.sum((x - 3.0) ** 2, axis=-1) / 0.25
    b = NORM_BI - 0.5 * jnp.sum((x + 3.0) ** 2, axis=-1) / 0.25
    return jnp.logaddexp(a, b) - jnp.log(2.0)


def _bimodal_t(x):
    a = NORM_BI - 0.5 * torch.sum((x - 3.0) ** 2, dim=-1) / 0.25
    b = NORM_BI - 0.5 * torch.sum((x + 3.0) ** 2, dim=-1) / 0.25
    return torch.logaddexp(a, b) - math.log(2.0)


@pytest.mark.parametrize("refit", [False, True])
def test_one_iteration_cluster_every_3_value_for_value(refit):
    """cluster_every=3: off the cadence the iteration labels with the model
    carried from the last fit; on it, it refits (fused.py:149-160). Model,
    labels and particles as in tests/test_torch_clustered_slice.py."""
    js = JaxSampler(_prior, _bimodal_j, n_dim=D_BI, n_particles=N_BI, vectorize=True,
                    clustering=True, k_max=4, cluster_every=3, random_state=0,
                    history_capacity=16)
    core = js.state
    while (int(core._fused_model.n_clusters()) < 2 or int(core.hist.t) < 8
           or ((int(core.cur.iteration) + 1) % 3 == 0) != refit):
        js.sample()
    fields_h, fields_c = _state_fields(core)
    model_fields = {k: np.array(getattr(core._fused_model, k)) for k in interop.CLUSTER_FIELDS}
    model_fields.update(normalize=core._fused_model.normalize, fitted=bool(core._fused_fitted))
    carried = interop.cluster_model_from_numpy(model_fields, "cpu")
    it_key = jax.random.split(core.key)[1]
    out_j = js.sample()
    model_j = core._fused_model

    cfg = SamplerConfig(prior_transform=_prior, log_likelihood=_bimodal_t, n_dim=D_BI,
                        n_particles=N_BI, vectorize=True, clustering=True, k_max=4,
                        cluster_every=3, device="cpu")
    iteration = make_iteration(cfg, lambda x, *_: (_bimodal_t(x), None), _prior)
    th = interop.history_from_numpy(fields_h, "cpu")
    tc = interop.current_from_numpy(fields_c, "cpu")
    th, tc, model_t = iteration(JaxIterationDraws(it_key), th, tc, carried)

    assert (model_t is carried) == (not refit) and model_t.fitted
    for name in ("centers", "covariances", "weights"):
        want = np.asarray(getattr(model_j, name))
        np.testing.assert_allclose(getattr(model_t, name).numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)
    np.testing.assert_array_equal(tc.assignments.numpy(), out_j["assignments"])
    assert abs(float(tc.beta) - out_j["beta"]) < 1e-5
    assert abs(float(tc.logz) - out_j["logz"]) < 1e-5
    np.testing.assert_allclose(tc.u.numpy(), out_j["u"], atol=1e-4)


def test_bootstrap_logz_err_on_jax_uniforms():
    """The block bootstrap fed the JAX uniforms of its key: equal to 1e-5."""
    from tempest_tpu.state import bootstrap_logz_err as jax_bootstrap

    from tempest_tpu_torch.state import bootstrap_logz_err

    js = JaxSampler(_prior, _loglike_j, n_dim=D4, n_particles=N4, vectorize=True,
                    clustering=False, random_state=2, history_capacity=16)
    for _ in range(9):
        js.sample()
    hist = js.state.hist
    key = jax.random.PRNGKey(9)
    want = float(jax_bootstrap(hist, key, n_bootstrap=64))
    uniforms = np.array(jax.random.uniform(key, (64, hist.capacity)))
    th = interop.history_from_numpy(
        {k: np.array(getattr(hist, k)) for k in interop.HISTORY_FIELDS + ("t",)}, "cpu")
    got = float(bootstrap_logz_err(th, torch.from_numpy(uniforms)))
    assert want > 0.0 and abs(got - want) < 1e-5
