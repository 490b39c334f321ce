"""The port's Gaussian-mixture facades against tempest_tpu.cluster.

1. Every facade and hierarchical case of tests/test_cluster.py (:83-238)
   on `tempest_tpu_torch.cluster`, with `device="cpu"`.
2. Value for value against JAX on the same X and `random_state`, for each
   covariance type with n_init 1 and 4: weights, means and covariances to
   rtol 1e-4 (float32 EM with other summation orders; atol 1e-5 of the
   largest entry, for the zeros off the diagonal), `n_iter_` and labels
   equal, `bic` to rtol 1e-5; the hierarchical fit of each type with every
   label, K and `predict_proba` (atol 1e-5) equal.

Both packages compute in float32 here: JAX without x64, as the test
process runs it, and numpy input becomes float32 in the port as in JAX. The
data of part 2 is chosen so that the n_init starts end at lower bounds
apart by more than float32 rounding: two starts that reach the same
optimum with the components swapped tie to the last bits, and then either
package may keep either order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempest_tpu import cluster as jc
from tempest_tpu_torch import cluster as tc
from tempest_tpu_torch.cluster import GaussianMixture, HierarchicalGaussianMixture

torch.set_num_threads(1)

TYPES = ["full", "tied", "diag", "spherical"]


def two_blobs(n=200, sep=4.0, seed=0, d=2):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, d)) * 0.3
    b = rng.standard_normal((n, d)) * 0.3 + sep
    return np.concatenate([a, b])


def gm(**kw):
    return GaussianMixture(device="cpu", **kw)


def hgm(**kw):
    return HierarchicalGaussianMixture(device="cpu", **kw)


# ---------------------------------------------------------------------------
# 1. tests/test_cluster.py's facade and hierarchical cases, on the port
# ---------------------------------------------------------------------------
class TestGaussianMixtureFacade:
    def test_fit_returns_self_and_sets_attributes(self):
        g = gm(n_components=2, random_state=0)
        out = g.fit(two_blobs(seed=10))
        assert out is g
        assert g.weights_.shape == (2,)
        assert g.means_.shape == (2, 2)
        assert g.covariances_.shape == (2, 2, 2)
        assert g.converged_
        assert g.n_iter_ >= 1
        assert np.isfinite(g.lower_bound_)
        np.testing.assert_allclose(np.sort(g.means_[:, 0]), [0.0, 4.0], atol=0.3)

    def test_predict_separates_blobs(self):
        X = two_blobs(seed=11)
        labels = gm(n_components=2, random_state=1).fit(X).predict(X)
        assert labels.shape == (400,)
        assert len(set(labels[:200])) == 1
        assert len(set(labels[200:])) == 1
        assert labels[0] != labels[-1]

    def test_bic_prefers_two_components_for_bimodal(self):
        X = two_blobs(seed=12)
        bic1 = gm(n_components=1, random_state=2, n_init=4).fit(X).bic(X)
        bic2 = gm(n_components=2, random_state=2, n_init=4).fit(X).bic(X)
        assert bic2 < bic1

    @pytest.mark.parametrize("ctype", TYPES)
    def test_covariance_types(self, ctype):
        X = np.random.default_rng(13).standard_normal((300, 3))
        g = gm(covariance_type=ctype, random_state=3).fit(X)
        assert g.covariances_.shape == (1, 3, 3)
        assert np.all(np.isfinite(g.covariances_))
        assert np.isfinite(g.bic(X))

    def test_sample_weight_honored(self):
        X = two_blobs(seed=14)
        w = np.concatenate([np.ones(200), np.zeros(200)])
        g = gm(n_components=1, random_state=4).fit(X, sample_weight=w)
        np.testing.assert_allclose(g.means_[0], [0.0, 0.0], atol=0.2)

    def test_unfitted_raises(self):
        g = gm()
        with pytest.raises(ValueError, match="not fitted"):
            g.predict(np.zeros((4, 2)))
        with pytest.raises(ValueError, match="not fitted"):
            g.bic(np.zeros((4, 2)))

    def test_bad_covariance_type_raises(self):
        with pytest.raises(ValueError, match="covariance_type"):
            gm(covariance_type="banana")


class TestHGM:
    def test_splits_bimodal(self):
        X = two_blobs(seed=7, sep=8.0)
        h = hgm(k_max=8).fit(X)
        assert h.n_clusters_ == 2
        assert abs(h.labels_[:200].mean() - h.labels_[200:].mean()) > 0.9

    def test_no_split_unimodal(self):
        X = np.random.default_rng(8).standard_normal((300, 2))
        assert hgm(k_max=8).fit(X).n_clusters_ == 1

    def test_min_points_blocks_split(self):
        X = two_blobs(n=12, seed=9, sep=8.0)
        assert hgm(min_points=20, k_max=8).fit(X).n_clusters_ == 1

    def test_threshold_modifier_blocks_split(self):
        X = two_blobs(seed=10, sep=5.0)
        assert hgm(threshold_modifier=1e6, k_max=8).fit(X).n_clusters_ == 1

    def test_invalid_threshold_raises(self):
        with pytest.raises(ValueError):
            hgm(threshold_modifier=0.0)

    def test_normalize_path(self):
        X = two_blobs(seed=11, sep=8.0) * np.array([1000.0, 0.001])
        h = hgm(normalize=True, k_max=8).fit(X)
        assert h.n_clusters_ == 2
        pred = h.predict(X)
        assert abs(pred[:200].mean() - pred[200:].mean()) > 0.9

    def test_predict_proba_sums_to_one(self):
        X = two_blobs(seed=12, sep=8.0)
        h = hgm(k_max=8).fit(X)
        proba = h.predict_proba(X)
        assert proba.shape == (400, h.n_clusters_)
        np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-4)

    def test_weighted_fit(self):
        X = two_blobs(seed=13, sep=8.0)
        w = np.concatenate([np.ones(200), np.zeros(200) + 1e-12])
        assert hgm(k_max=8).fit(X, sample_weight=w).n_clusters_ == 1

    def test_masked_fit(self):
        X = np.concatenate([two_blobs(seed=14, sep=8.0), np.full((50, 2), 100.0)])
        mask = np.arange(450) < 400
        assert hgm(k_max=8).fit(X, mask=mask).n_clusters_ == 2

    def test_k_max_cap(self):
        rng = np.random.default_rng(15)
        X = np.concatenate([rng.standard_normal((100, 2)) * 0.2 + c for c in [0, 10, 20, 30]])
        assert hgm(k_max=2).fit(X).n_clusters_ <= 2


class TestNInitRestarts:
    def test_best_of_n_lower_bound_not_worse(self):
        X = torch.tensor(two_blobs(seed=3), dtype=torch.float32)
        w = torch.ones(400)
        key = tc.threefry.prng_key(5)
        single = tc.gmm_fit(key, X, w, 2)
        multi = tc.gmm_fit(key, X, w, 2, n_init=5)
        assert float(multi.lower_bound) >= float(single.lower_bound) - 1e-6

    def test_n_init_plumbed_through_hgm(self):
        X = two_blobs(seed=4)
        h = hgm(n_init=3, k_max=4).fit(X)
        assert h.n_clusters_ == 2
        assert len(np.unique(h.predict(X))) == 2


# ---------------------------------------------------------------------------
# 2. Value for value against JAX
# ---------------------------------------------------------------------------
def three_blobs():
    """Three unequal blobs fitted with two components: the n_init starts
    merge different pairs and end at distinct lower bounds."""
    rng = np.random.default_rng(5)
    X = np.concatenate([rng.normal([0, 0], 0.4, (150, 2)), rng.normal([3, 0], 0.6, (100, 2)),
                        rng.normal([1.5, 3], 0.5, (60, 2))]).astype(np.float32)
    return X, rng.uniform(0.5, 1.5, len(X)).astype(np.float32)


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n_init", [1, 4])
@pytest.mark.parametrize("ctype", TYPES)
def test_gaussian_mixture_value_for_value(ctype, n_init):
    X, w = three_blobs()
    kw = dict(n_components=2, covariance_type=ctype, n_init=n_init, random_state=0)
    j = jc.GaussianMixture(**kw).fit(X, sample_weight=w)
    p = gm(**kw).fit(X, sample_weight=w)
    assert isinstance(p.means_, np.ndarray) and p.means_.dtype == np.float32
    assert p.n_iter_ == j.n_iter_ and p.converged_ == j.converged_
    for name in ("weights_", "means_", "covariances_"):
        _close(getattr(p, name), getattr(j, name), 1e-4)
    assert abs(p.lower_bound_ - j.lower_bound_) <= 1e-5 * abs(j.lower_bound_)
    np.testing.assert_array_equal(p.predict(X), j.predict(X))
    assert p.bic(X) == pytest.approx(j.bic(X), rel=1e-5)


@pytest.mark.parametrize("ctype", TYPES)
def test_hierarchical_mixture_value_for_value(ctype):
    X = two_blobs(seed=21, d=3)
    j = jc.HierarchicalGaussianMixture(k_max=4, covariance_type=ctype).fit(X)
    p = hgm(k_max=4, covariance_type=ctype).fit(X)
    assert p.n_clusters_ == j.n_clusters_ == 2
    np.testing.assert_array_equal(p.labels_, j.labels_)
    np.testing.assert_array_equal(p.predict(X), j.predict(X))
    np.testing.assert_allclose(p.predict_proba(X), j.predict_proba(X), atol=1e-5)
    for name in ("centers", "covariances", "weights"):
        want = np.asarray(getattr(j.model, name))
        _close(getattr(p.model, name).numpy(), want, 1e-4)


@pytest.mark.parametrize("ctype", TYPES)
def test_m_step_and_bic_of_each_type(ctype):
    """`_m_step` and `gmm_bic` on the same responsibilities and parameters."""
    X, w = three_blobs()
    resp = np.random.default_rng(2).dirichlet([1.0, 1.0], size=len(X)).astype(np.float32)
    want = jc._m_step(jnp.asarray(X), jnp.asarray(resp), jnp.asarray(w), ctype)
    got = tc._m_step(torch.from_numpy(X)[None], torch.from_numpy(resp)[None],
                     torch.from_numpy(w)[None], ctype)
    for g, wv in zip(got, want):
        _close(g[0].numpy(), np.asarray(wv), 1e-5)
    params = jc.GMMParams(*want, jnp.asarray(0.0), jnp.asarray(1))
    mask = np.arange(len(X)) < 250
    bic_j = float(jc.gmm_bic(params, jnp.asarray(X), jnp.asarray(mask), ctype))
    p_t = tc.GMMParams(*(g[0] for g in got), torch.tensor(0.0), torch.tensor(1))
    bic_t = float(tc.gmm_bic(p_t, torch.from_numpy(X), torch.from_numpy(mask), ctype))
    assert bic_t == pytest.approx(bic_j, rel=1e-5)


def test_gmm_functions_on_a_jax_key():
    """gmm_fit on the two words of jax.random.PRNGKey(1) equals JAX's fit."""
    X = two_blobs(seed=5).astype(np.float32)
    j = jc.gmm_fit(jax.random.PRNGKey(1), jnp.asarray(X), jnp.ones(400), 2)
    p = tc.gmm_fit(tc.threefry.prng_key(1), torch.from_numpy(X), torch.ones(400), 2)
    assert int(p.n_iter) == int(j.n_iter)
    _close(p.means.numpy(), np.asarray(j.means), 1e-4)
    np.testing.assert_array_equal(tc.gmm_predict(p, torch.from_numpy(X)).numpy(),
                                  np.asarray(jc.gmm_predict(j, jnp.asarray(X))))


def test_float64_input_stays_float64():
    """A float64 torch tensor keeps its dtype; `dtype=torch.float64` turns
    numpy input into float64 too; numpy input is float32 otherwise."""
    X = two_blobs(seed=6)
    assert gm(n_components=2).fit(X).means_.dtype == np.float32
    assert gm(n_components=2).fit(torch.from_numpy(X)).means_.dtype == np.float64
    g = gm(n_components=2, dtype=torch.float64).fit(X)
    assert g.means_.dtype == np.float64 and g.predict(X).shape == (400,)
    h = hgm(k_max=4, dtype=torch.float64).fit(X)
    assert h.model.centers.dtype == torch.float64 and h.n_clusters_ == 2
