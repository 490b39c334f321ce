"""The port's clustered slice and its hardware-PRNG path against tempest_tpu.

1. One clustered iteration, value for value: the JAX sampler runs a 4-D
   bimodal mixture until its clusterer has split; its state goes through
   `interop` into the port, which runs the next iteration on that
   iteration's own JAX draws (tests/test_torch_slice.py's pattern). The
   clusterer's fixed fit key is reproduced by the port, so the fitted
   model, the labels and everything after them must agree. Tolerances are
   those of tests/test_torch_slice.py: beta and logZ 1e-5, particles
   atol 1e-4; the cluster model rtol 1e-3 (float32 EM run to a 1e-3 bound
   tolerance) with K and every label equal.
2. Whole runs on the CPU: the 4-D bimodal mixture clustered (K >= 2,
   balanced mass, logZ within 0.5, as tests/test_multimodal.py asks in
   10-D), and a 4-D Gaussian with hardware_prng=True (beta = 1 and logZ
   within 0.5, as tests/test_tpu_smoke.py:246-255), once on the fused
   draws route and once on the separate normal and gamma route.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import JaxIterationDraws

from tempest_tpu import Sampler as JaxSampler
from tempest_tpu_torch import Sampler, interop
from tempest_tpu_torch import draws as draws_mod
from tempest_tpu_torch.cluster import single_cluster_model
from tempest_tpu_torch.config import SamplerConfig
from tempest_tpu_torch.iteration import make_iteration
from tempest_tpu_torch.ops import philox

torch.set_num_threads(1)

D, N, SEP, SIGMA = 4, 128, 3.0, 0.5
ANALYTIC_LOGZ = -D * math.log(20.0)
NORM = -0.5 * D * math.log(2 * math.pi * SIGMA**2)


def _prior(u):
    return 20.0 * u - 10.0


def _bimodal_j(x):
    a = NORM - 0.5 * jnp.sum((x - SEP) ** 2, axis=-1) / SIGMA**2
    b = NORM - 0.5 * jnp.sum((x + SEP) ** 2, axis=-1) / SIGMA**2
    return jnp.logaddexp(a, b) - jnp.log(2.0)


def _bimodal_t(x):
    a = NORM - 0.5 * torch.sum((x - SEP) ** 2, dim=-1) / SIGMA**2
    b = NORM - 0.5 * torch.sum((x + SEP) ** 2, dim=-1) / SIGMA**2
    return torch.logaddexp(a, b) - math.log(2.0)


def _gauss_t(x):
    return -0.5 * torch.sum(x * x, dim=-1) - 0.5 * x.shape[-1] * math.log(2 * math.pi)


def test_one_clustered_iteration_value_for_value():
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
    iteration = make_iteration(cfg, lambda x, *_: (_bimodal_t(x), None), _prior)
    th = interop.history_from_numpy(fields_h, "cpu")
    tc = interop.current_from_numpy(fields_c, "cpu")
    placeholder = single_cluster_model(D, 4, normalize=True)
    th, tc, model_t = iteration(JaxIterationDraws(it_key), th, tc, placeholder)

    assert int(model_t.n_clusters()) == int(model_j.n_clusters()) >= 2
    for name in ("centers", "covariances", "weights"):
        want = np.asarray(getattr(model_j, name))
        np.testing.assert_allclose(getattr(model_t, name).numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)
    np.testing.assert_array_equal(tc.assignments.numpy(), out_j["assignments"])
    assert th.t == int(core.hist.t) and tc.iteration == out_j["iter"]
    assert abs(float(tc.beta) - out_j["beta"]) < 1e-5
    assert abs(float(tc.logz) - out_j["logz"]) < 1e-5
    assert tc.steps == out_j["steps"] and tc.calls * N == out_j["calls"]
    np.testing.assert_allclose(tc.u.numpy(), out_j["u"], atol=1e-4)
    np.testing.assert_allclose(tc.logl.numpy(), out_j["logl"], atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(float(tc.acceptance), out_j["acceptance"], atol=1e-4)


def test_bimodal_clustered_run():
    s = Sampler(_prior, _bimodal_t, n_dim=D, n_particles=N, vectorize=True, k_max=8,
                random_state=4, history_capacity=32, device="cpu")
    assert s.clustering
    s.run(n_total=512, progress=False)
    assert s.beta >= 1.0 - 1e-4
    assert int(s.state.cluster_model.n_clusters()) >= 2
    x, w, _ = s.posterior()
    mass_pos = float(np.sum(w[x[:, 0] > 0]))
    assert 0.3 < mass_pos < 0.7
    assert abs(s.evidence()[0] - ANALYTIC_LOGZ) < 0.5


@pytest.mark.parametrize("route", ["fused", "separate"])
def test_hardware_prng_gaussian_run(route, monkeypatch):
    if route == "separate":  # the large-ensemble route, at CPU size
        monkeypatch.setattr(draws_mod, "FUSED_DRAWS_MAX_ELEMS", 0)
    s = Sampler(_prior, _gauss_t, n_dim=D, n_particles=N, vectorize=True, clustering=True,
                hardware_prng=True, k_max=4, random_state=2, history_capacity=32, device="cpu")
    s.run(n_total=512, progress=False)
    assert s.beta == 1.0
    assert abs(s.evidence()[0] - ANALYTIC_LOGZ) < 0.5
    res = s.results()
    mutations = res["beta"] > 0  # beta = 0 is warm-up
    steps = int(res["steps"][mutations].sum())  # the MCMC steps
    per_step = 1 if route == "fused" else philox.GAMMA_CALLS + 2
    # and the keyed warm-up (2 calls) and resampling (1 call) draws
    assert s.state.draws.counter == per_step * steps + 2 * int((~mutations).sum()) + int(
        mutations.sum())
