"""The clustered host-route state of tempest_tpu_torch against tempest_tpu on
the CPU, with the one tolerance it needs: a resampling position at a CDF
edge.

tests/test_torch_clustered_slice.py's bimodal 4-D problem (N = 128,
k_max = 4) with its likelihood as a per-point numpy function and
host_likelihood=True: JAX's sampler runs (seed 0) until its model has two
clusters and t >= 9; then one fused iteration of JAX, and one of the port
from the same state on that iteration's own JAX draws, through the host
crossing (`HostLikelihood`, the plain route of CPU tensors). Held:

- K equal, and the model within test_torch_clustered_slice.py's rtol 1e-3;
- every label equal to JAX's, except where the resampling position lies
  within EDGE_EPS float32 eps (relative) of the port's CDF at the index
  before its pick: there JAX's label equals the port model's label of that
  neighbouring index; exactly one such walker at seed 0;
- the port's resampled indices equal to those of JAX's `reweight` and
  `multinomial_resample` jitted apart, on the iteration's resampling key,
  with the same exemption.

Why the exemption: the two packages agree bit for bit on beta and on the
MIS denominator at this state, but XLA:CPU contracts JAX's
`beta * logl - B` (tempest_tpu/state.py:393) into one fma, and `jnp.exp`
and `torch.exp` differ in the last bit, so the CDFs differ by float
rounding; JAX's whole-iteration program moves its CDF edge onto the
position where JAX's pieces jitted apart, like the port, do not
(scripts/cluster_label_witness.py prints both picks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_clustered_slice import D, N, _bimodal_t, _prior
from test_torch_host_route import _bimodal_np
from test_torch_slice import JaxIterationDraws

from tempest_tpu import Sampler as JaxSampler
from tempest_tpu.ops.tools import multinomial_resample as jax_multinomial
from tempest_tpu.steps.reweight import reweight as jax_reweight
from tempest_tpu_torch import interop
from tempest_tpu_torch.cluster import cluster_predict, single_cluster_model
from tempest_tpu_torch.config import SamplerConfig
from tempest_tpu_torch.fused import make_fused_iteration
from tempest_tpu_torch.ops import tools
from tempest_tpu_torch.steps import resample as resample_mod
from tempest_tpu_torch.utils.wrappers import HostLikelihood, make_pool_map

torch.set_num_threads(1)

EDGE_EPS = 4  # float32 eps, relative to the CDF at the index before the pick


def test_clustered_host_state_within_the_cdf_edge(monkeypatch):
    js = JaxSampler(_prior, _bimodal_np, n_dim=D, n_particles=N, host_likelihood=True,
                    clustering=True, k_max=4, random_state=0, history_capacity=16)
    core = js.state
    while int(core._fused_model.n_clusters()) < 2 or int(core.hist.t) < 9:
        js.sample()
    # copies: the next sample() donates the state's buffers
    hist_j = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), core.hist)
    beta_prev = np.asarray(core.cur.beta).copy()
    fields_h = {k: np.array(getattr(core.hist, k)) for k in interop.HISTORY_FIELDS + ("t",)}
    fields_c = {k: np.array(getattr(core.cur, k))
                for k in interop.CURRENT_FIELDS + interop.CURRENT_COUNTERS}
    it_key = jax.random.split(core.key)[1]  # what core._next_key() hands the iteration
    out_j = js.sample()
    model_j = core._fused_model
    # JAX's pieces jitted apart, on the mutate branch's key (fused.py: split(key, 3)[1])
    rw = jax_reweight(hist_j, beta_prev, core.config.ess_ratio * N, cv_target=0.0,
                      dynamic=False, use_pallas=True)
    apart = np.asarray(jax.jit(jax_multinomial, static_argnums=1)(
        jax.random.split(it_key, 3)[1], N, rw.weights.reshape(-1)))

    seen = {}
    invert = resample_mod.multinomial_resample

    def spy(uniforms, w):
        idx = invert(uniforms, w)
        seen.update(uniforms=uniforms.clone(), w=w.clone(), idx=idx.clone())
        return idx

    monkeypatch.setattr(resample_mod, "multinomial_resample", spy)
    cfg = SamplerConfig(prior_transform=_prior, log_likelihood=_bimodal_t, n_dim=D,
                        n_particles=N, vectorize=True, clustering=True, k_max=4,
                        device="cpu", host_likelihood=True)
    crossing = HostLikelihood(_bimodal_np, make_pool_map(None), torch.float32)
    iteration = make_fused_iteration(cfg, crossing, _prior)
    th = interop.history_from_numpy(fields_h, "cpu")
    tc = interop.current_from_numpy(fields_c, "cpu")
    u_all = th.u.reshape(D, -1).T.clone()
    th, tc, model_t = iteration(JaxIterationDraws(it_key), th, tc,
                                single_cluster_model(D, 4, normalize=True))

    assert int(model_t.n_clusters()) == int(model_j.n_clusters()) >= 2
    for name in ("centers", "covariances", "weights"):
        want = np.asarray(getattr(model_j, name))
        np.testing.assert_allclose(getattr(model_t, name).numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)

    idx, uniforms = seen["idx"], seen["uniforms"]
    w = seen["w"] / seen["w"].sum()
    cdf = tools.cumsum(w)
    before = cdf[(idx - 1).clamp(min=0)]
    eps = torch.finfo(torch.float32).eps
    edge = ((idx > 0) & ((uniforms - before).abs() <= EDGE_EPS * eps * before)).numpy()
    labels, labels_j = tc.assignments.numpy(), out_j["assignments"]
    np.testing.assert_array_equal(labels[~edge], labels_j[~edge])
    neighbours = cluster_predict(model_t, u_all[(idx - 1).clamp(min=0)]).numpy()
    np.testing.assert_array_equal(labels_j[edge], neighbours[edge])
    assert int(edge.sum()) == 1, np.nonzero(edge)[0]
    np.testing.assert_array_equal(idx.numpy()[~edge], apart[~edge])
    assert np.all((apart[edge] == idx.numpy()[edge]) | (apart[edge] == idx.numpy()[edge] - 1))
