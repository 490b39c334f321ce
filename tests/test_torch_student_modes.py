"""student.py and modes.py of the port against tempest_tpu.

Both packages fit the same numpy-made weighted data. Tolerances: mean and
covariance rtol 1e-3, because the float32 EM runs up to 100 iterations
with sums taken in different orders; nu is compared as 1/nu within 1e-3,
the natural parameter of the fit (student.py:106-134), which is 0 in the
Gaussian limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempest_tpu import modes as jm
from tempest_tpu import student as js
from tempest_tpu_torch import modes as tm
from tempest_tpu_torch import student as ts

torch.set_num_threads(1)


def _data(seed, n, d, nu):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(d, d)) / np.sqrt(d)
    z = rng.normal(size=(n, d)) @ (a + np.eye(d)).T
    if nu is not None:
        z = z / np.sqrt(rng.chisquare(nu, size=(n, 1)) / nu)
    x = (0.5 + 0.05 * z).astype(np.float32)
    w = rng.exponential(size=n).astype(np.float32)
    w[rng.choice(n, n // 10, replace=False)] = 0.0
    return x, w


def _inv_nu(nu):
    return 0.0 if not np.isfinite(nu) else 1.0 / nu


@pytest.mark.parametrize("seed,n,d,nu", [(0, 3000, 3, 4.0), (1, 2000, 5, 15.0), (2, 2000, 4, None)])
def test_fit_mvstud_weighted_matches_jax(seed, n, d, nu):
    x, w = _data(seed, n, d, nu)
    mu_j, cov_j, nu_j = js.fit_mvstud_weighted(jnp.asarray(x), jnp.asarray(w))
    mu_t, cov_t, nu_t = ts.fit_mvstud_weighted(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-3)
    cov_j = np.asarray(cov_j)
    np.testing.assert_allclose(cov_t.numpy(), cov_j, rtol=1e-3, atol=1e-3 * np.abs(cov_j).max())
    assert abs(_inv_nu(float(nu_t)) - _inv_nu(float(nu_j))) < 1e-3, (float(nu_t), float(nu_j))


def test_weighted_median_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 7, size=(200, 3)).astype(np.float32)  # many ties
    w = rng.exponential(size=200).astype(np.float32)
    wbar = w / w.sum()
    got = ts._weighted_median_presorted(*ts.sort_columns(torch.from_numpy(x)),
                                        torch.from_numpy(wbar))
    want = js._weighted_median(jnp.asarray(x), jnp.asarray(wbar))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_global_mode_matches_jax(seed):
    x, w = _data(seed + 10, 2500, 4, 6.0)
    mj = jm.fit_global_mode(jnp.asarray(x), jnp.asarray(w), dof_fallback=1e6)
    mt = tm.fit_global_mode(torch.from_numpy(x), torch.from_numpy(w), dof_fallback=1e6)
    np.testing.assert_allclose(mt.means.numpy(), np.asarray(mj.means), rtol=1e-3)
    for name in ("covariances", "chol_covariances"):
        want = np.asarray(getattr(mj, name))
        np.testing.assert_allclose(getattr(mt, name).numpy(), want, rtol=1e-3,
                                   atol=1e-3 * np.abs(want).max(), err_msg=name)
    inv_j = np.asarray(mj.inv_covariances)
    np.testing.assert_allclose(mt.inv_covariances.numpy(), inv_j, rtol=2e-3,
                               atol=2e-3 * np.abs(inv_j).max())
    assert abs(1.0 / float(mt.degrees_of_freedom[0]) - 1.0 / float(mj.degrees_of_freedom[0])) < 1e-3
    assert mt.k_mask.tolist() == [True] == np.asarray(mj.k_mask).tolist()


def test_empty_mode_gets_identity():
    x, _ = _data(5, 100, 3, None)
    w = np.zeros(100, np.float32)
    mj = jm.fit_global_mode(jnp.asarray(x), jnp.asarray(w), dof_fallback=1e6)
    mt = tm.fit_global_mode(torch.from_numpy(x), torch.from_numpy(w), dof_fallback=1e6)
    assert mt.k_mask.tolist() == [False] == np.asarray(mj.k_mask).tolist()
    np.testing.assert_array_equal(mt.covariances.numpy(), np.asarray(mj.covariances))
    assert float(mt.degrees_of_freedom[0]) == 1e6


def test_decompose_regularizes_singular_covariance():
    """torch's cholesky raises on a non-PD matrix where jnp's returns NaN;
    the port reads cholesky_ex's info and applies the same diagonal floor."""
    v = np.array([1.0, 2.0, -1.0], np.float32)
    cov = np.stack([np.outer(v, v), np.diag([2.0, 1.0, 0.5]).astype(np.float32)])
    cj, lj, ij = (np.asarray(a) for a in jax.vmap(jm._decompose)(jnp.asarray(cov)))
    ct, lt, it = (a.numpy() for a in tm._decompose(torch.from_numpy(cov)))
    np.testing.assert_array_equal(ct, cj)  # the floor: + max(1e-6, 1e-6 |trace|) I
    assert ct[0, 0, 0] > cov[0, 0, 0] and np.array_equal(ct[1], cov[1])
    assert np.all(np.isfinite(lt)) and np.all(np.isfinite(it))
    np.testing.assert_allclose(lt, lj, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(lt @ np.swapaxes(lt, 1, 2), ct, atol=1e-5)
    np.testing.assert_allclose(it[1], ij[1], rtol=1e-5)


def test_identity_and_made_mode_statistics_match_jax():
    ij = jm.identity_mode_statistics(3, k_max=2)
    it = tm.identity_mode_statistics(3, k_max=2)
    for name in ("means", "covariances", "degrees_of_freedom", "inv_covariances",
                 "chol_covariances", "k_mask"):
        np.testing.assert_array_equal(getattr(it, name).numpy(), np.asarray(getattr(ij, name)))
    x, w = _data(6, 500, 3, 5.0)
    cov = np.cov(x.T).astype(np.float32)
    mj = jm.make_mode_statistics(jnp.asarray(x.mean(0)), jnp.asarray(cov), jnp.asarray(7.0))
    mt = tm.make_mode_statistics(torch.from_numpy(x.mean(0)), torch.from_numpy(cov),
                                 torch.tensor(7.0))
    assert mt.k_max == 1 and mt.n_dim == 3 and int(mt.n_modes()) == 1
    np.testing.assert_allclose(mt.chol_covariances.numpy(), np.asarray(mj.chol_covariances),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(mt.inv_covariances.numpy(), np.asarray(mj.inv_covariances),
                               rtol=1e-4)
