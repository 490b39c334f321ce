"""mcmc.py of the port against tempest_tpu, value for value.

The port's chain is fed the JAX kernel's own draws: a replay object walks
the JAX key chain exactly as mcmc.py:289 does (`split(key, 4)` per step;
`gamma(k_g, g_shape)`, `normal(k_p, (R, N, d))`, `uniform(k_a, (N,))`).
With n_steps == n_max_steps == s the adaptive stop falls at exactly s * d
steps in both packages, so each case compares the state after that many
steps. Tolerance atol 1e-5: float32 elementwise and d x d matrix
arithmetic in a different order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempest_tpu.mcmc import make_mcmc_kernel
from tempest_tpu.modes import make_mode_statistics
from tempest_tpu_torch import interop
from tempest_tpu_torch.mcmc import MCMCKernel

torch.set_num_threads(1)

N = 96


class JaxKeyDraws:
    """Replays the draws of tempest_tpu's MCMC loop from its key."""

    def __init__(self, key):
        self.key = key

    def mcmc_step(self, n_candidates, n, d, gamma_shape):
        self.key, k_g, k_p, k_a = jax.random.split(self.key, 4)
        g = None
        if gamma_shape is not None:
            g = torch.from_numpy(np.array(
                jax.random.gamma(k_g, jnp.asarray(gamma_shape.numpy()), dtype=jnp.float32)))
        z = np.array(jax.random.normal(k_p, (n_candidates, n, d), dtype=jnp.float32))
        acc = np.array(jax.random.uniform(k_a, (n,), dtype=jnp.float32))
        return torch.from_numpy(z), g, torch.from_numpy(acc)


def _problem(seed, d, dof):
    rng = np.random.default_rng(seed)
    u = (0.5 + 0.03 * rng.normal(size=(N, d))).astype(np.float32)
    a = rng.normal(size=(d, d)).astype(np.float32) * 0.01
    cov = (a @ a.T + 0.0009 * np.eye(d)).astype(np.float32)
    means = u.mean(0, keepdims=True)
    modes_j = make_mode_statistics(jnp.asarray(means), jnp.asarray(cov[None]),
                                   jnp.asarray([dof], jnp.float32))
    modes_t = interop.modes_from_numpy(
        {k: np.array(getattr(modes_j, k)) for k in interop.MODE_FIELDS}, "cpu")
    return u, modes_j, modes_t


def prior_j(u):
    return 20.0 * u - 10.0


def loglike_j(x):
    return -0.5 * jnp.sum((x - 0.3) ** 2, axis=-1) / 0.25


def prior_t(u):
    return 20.0 * u - 10.0


def loglike_t(x):
    return -0.5 * torch.sum((x - 0.3) ** 2, dim=-1) / 0.25


@pytest.mark.parametrize("method,d,s", [
    ("tpcn", 1, 1), ("tpcn", 1, 2), ("tpcn", 1, 3), ("tpcn", 3, 2),
    ("rwm", 1, 1), ("rwm", 1, 3), ("rwm", 3, 2),
])
def test_steps_match_jax_draw_for_draw(method, d, s):
    u, modes_j, modes_t = _problem(seed=d * 10 + s, d=d, dof=5.0)
    beta = 0.4
    key = jax.random.PRNGKey(100 + s)
    jax_kernel = make_mcmc_kernel(
        lambda x: (loglike_j(x), None), prior_j, d, method=method, n_steps=s, n_max_steps=s
    )
    x = prior_j(jnp.asarray(u))
    res_j = jax_kernel(key, jnp.asarray(u), x, loglike_j(x), None,
                       jnp.zeros(N, jnp.int32), jnp.asarray(beta, jnp.float32), modes_j)

    port = MCMCKernel(lambda x, *_: (loglike_t(x), None), prior_t, d, method=method, n_steps=s,
                      n_max_steps=s)
    ut = torch.from_numpy(u)
    xt = prior_t(ut)
    res_t = port(JaxKeyDraws(key), ut, xt, loglike_t(xt), torch.zeros(N, dtype=torch.int32),
                 torch.tensor(beta), modes_t)

    assert res_t.steps == int(res_j.steps) == s * d
    np.testing.assert_allclose(res_t.u.numpy(), np.asarray(res_j.u), atol=1e-5)
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x), atol=1e-4)
    # logl reaches ~10 in size, where one float32 ulp is ~1e-6: rtol 1e-5 too.
    np.testing.assert_allclose(res_t.logl.numpy(), np.asarray(res_j.logl), atol=1e-5, rtol=1e-5)
    # sigma of the single mode = efficiency * sigma_0
    np.testing.assert_allclose(float(res_t.efficiency) * port.sigma_0,
                               float(res_j.efficiency) * port.sigma_0, atol=1e-5)
    np.testing.assert_allclose(float(res_t.acceptance), float(res_j.acceptance), atol=1e-5)
    assert not np.allclose(res_t.u.numpy(), u)  # the chain moved


def test_pure_step_matches_loop():
    """`step` on explicit draws is the loop body: one step by hand equals
    the loop stopped after one step."""
    u, _, modes_t = _problem(seed=7, d=1, dof=4.0)
    port = MCMCKernel(lambda x, *_: (loglike_t(x), None), prior_t, 1, method="tpcn", n_steps=1,
                      n_max_steps=1)
    ut = torch.from_numpy(u)
    xt = prior_t(ut)
    assign = torch.zeros(N, dtype=torch.int32)
    w = port.prepare(assign, torch.tensor(0.4), modes_t)
    s0 = port.initial_state(ut, xt, loglike_t(xt), modes_t.k_max)
    z, g, acc = JaxKeyDraws(jax.random.PRNGKey(5)).mcmc_step(8, N, 1, w.gamma_shape)
    s1 = port.step(w, s0, z, g, acc)
    res = port(JaxKeyDraws(jax.random.PRNGKey(5)), ut, xt, loglike_t(xt), assign,
               torch.tensor(0.4), modes_t)
    assert bool(s1.done) and res.steps == s1.iteration == 1
    assert torch.equal(res.u, s1.u) and torch.equal(res.logl, s1.logl)
