"""tempest_tpu_torch.cluster against tempest_tpu.cluster on the same inputs.

Inputs are made with numpy from a seed. Tolerances: the density, M-step
and mixture scores rtol 1e-5 (float32, other summation orders); the
k-means++ responsibilities rtol 1e-5 with JAX's own uniforms; the fits
(split round, hgm_fit) must agree on every decision (eligibility, K and
every label), with centers and covariances at rtol 1e-3, because a float32
EM run to tol 1e-3 on the bound may stop one iteration apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempest_tpu import cluster as jc
from tempest_tpu_torch import cluster as tc
from tempest_tpu_torch import interop
from tempest_tpu_torch.loops import Loops

torch.set_num_threads(1)

D = 2


def bimodal(seed=0, n=600):
    rng = np.random.default_rng(seed)
    half = n // 2
    X = np.concatenate([
        rng.normal([-3.0, 0.0], 0.5, size=(half, D)),
        rng.normal([3.0, 1.0], [0.4, 0.8], size=(n - half, D)),
    ]).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    mask = rng.uniform(size=n) > 0.05
    return X, w, mask


def unimodal(seed=1, n=600):
    rng = np.random.default_rng(seed)
    X = rng.normal([1.0, -2.0], [1.0, 0.5], size=(n, D)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    return X, w, np.ones(n, dtype=bool)


def blobs(seed=2, n=600, k=4, spread=6.0):
    """k tight blobs `spread` apart on a square grid: every leaf that holds
    two or more of them splits."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(k)))
    centers = spread * np.array([(i % side, i // side) for i in range(k)], dtype=np.float64)
    X = (centers[rng.integers(0, k, size=n)] + rng.normal(0.0, 0.3, size=(n, D)))
    w = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    return X.astype(np.float32), w, np.ones(n, dtype=bool)


DATA = {"bimodal": bimodal, "unimodal": unimodal}


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def spd(rng, k):
    a = rng.normal(size=(k, D, D)).astype(np.float32)
    return (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(D, dtype=np.float32)).astype(np.float32)


def test_log_gauss_m_step_and_mixture_scores():
    rng = np.random.default_rng(3)
    X, w, _ = bimodal(3, 200)
    means = rng.normal(size=(2, D)).astype(np.float32)
    covs = spd(rng, 2)
    covs[1] = np.nan  # the identity fallback of a failed Cholesky
    for k in range(2):
        want = np.asarray(jc._log_gauss(jnp.asarray(X), means[k], covs[k], 1e-6))
        got = tc._log_gauss(t(X)[None], t(means[k])[None], t(covs[k])[None], 1e-6)[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)

    resp = rng.dirichlet([1.0, 1.0], size=len(X)).astype(np.float32)
    pi_j, mu_j, cov_j = jc._m_step(jnp.asarray(X), jnp.asarray(resp), jnp.asarray(w), "full")
    pi_t, mu_t, cov_t = tc._m_step(t(X)[None], t(resp)[None], t(w)[None])
    for got, want in ((pi_t, pi_j), (mu_t, mu_j), (cov_t, cov_j)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)

    covs = spd(rng, 2)
    pi = np.array([0.3, 0.7], dtype=np.float32)
    lp_j, lik_j = jc._mixture_scores(jnp.asarray(X), pi, means, covs, 1e-6)
    lp_t, lik_t = tc._mixture_scores(t(X)[None], t(pi)[None], t(means)[None], t(covs)[None], 1e-6)
    np.testing.assert_allclose(lp_t[0].numpy(), np.asarray(lp_j), rtol=1e-5)
    np.testing.assert_allclose(lik_t[0].numpy(), np.asarray(lik_j), rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize("n_components", [2, 3])
def test_kmeanspp_init_on_jax_uniforms(n_components):
    X, w, _ = bimodal(4, 300)
    sw = w / w.sum()
    key = jax.random.PRNGKey(7)
    uniforms = [float(jax.random.uniform(k, ())) for k in jax.random.split(key, n_components)]
    want = np.asarray(jc._kmeanspp_init(key, jnp.asarray(X), jnp.asarray(sw), n_components))
    got = tc._kmeanspp_init(t(X)[None], t(sw)[None], n_components, torch.tensor([uniforms]))[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("k_max", [1, 8, 16])
def test_fit_uniforms_equal_jax_random(k_max):
    leaves = jax.random.split(jax.random.PRNGKey(42), k_max)
    want = [[float(jax.random.uniform(k, ())) for k in jax.random.split(leaf, 2)]
            for leaf in leaves]
    got = tc.fit_uniforms(k_max)
    assert got.dtype == torch.float32
    assert got.tolist() == want
    if k_max == 16:
        assert abs(got[0, 0].item() - 0.2358249) < 1e-7
        assert abs(got[0, 1].item() - 0.4164864) < 1e-7


def _gmm_agrees(p_t, p_j):
    np.testing.assert_allclose(p_t.weights.numpy(), np.asarray(p_j.weights), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(p_t.means.numpy(), np.asarray(p_j.means), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(p_t.covariances.numpy(), np.asarray(p_j.covariances),
                               rtol=1e-3, atol=1e-4)


def test_gmm_fit_scores_two_leaves():
    """The batched EM of two leaves at once equals two JAX fits."""
    X, w, _ = bimodal(5, 400)
    w2 = np.where(X[:, 0] > 0, w, 0.0).astype(np.float32)  # a leaf of one mode
    u = tc.fit_uniforms(2)
    p_t, lp_t, lik_t = tc._gmm_fit_scores(t(X).expand(2, -1, -1), t(np.stack([w, w2])), 2, u)
    for b, wb in enumerate((w, w2)):
        p_j, lp_j, lik_j = jc._gmm_fit_scores(jax.random.split(jax.random.PRNGKey(42), 2)[b],
                                               jnp.asarray(X), jnp.asarray(wb), 2)
        assert int(p_t.n_iter[b]) == int(p_j.n_iter)
        _gmm_agrees(tc.GMMParams(*(a[b] for a in p_t)), p_j)
        np.testing.assert_allclose(lik_t[b].numpy(), np.asarray(lik_j), rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("n_sub", [None, 256])
@pytest.mark.parametrize("data", sorted(DATA))
def test_split_round(data, n_sub):
    X, w, mask = DATA[data]()
    k_max, k_slots = 4, 2
    labels = np.where(mask, np.where(X[:, 1] > 0.5, 1, 0), -1).astype(np.int32)
    out_j = jc._split_round(
        jax.random.PRNGKey(42), jnp.asarray(X), jnp.asarray(w), jnp.asarray(labels),
        jnp.asarray(2, jnp.int32), jnp.asarray(2 * D, jnp.int32), 1.0, k_max, "full",
        1, n_sub, k_slots,
    )
    out_t = tc._split_round(tc.fit_uniforms(k_max), t(X), t(w), t(labels), 2, 2 * D, 1.0,
                            k_max, n_sub, k_slots)
    assert out_t["eligible"].tolist() == np.asarray(out_j["eligible"]).tolist()
    np.testing.assert_array_equal(out_t["child"].numpy(), np.asarray(out_j["child"]))
    imp_j = np.asarray(out_j["improvement"])
    np.testing.assert_allclose(out_t["improvement"].numpy(), imp_j, rtol=1e-3)


def _jax_hgm(X, w, mask, k_max, split_all, leaf_fit_points, normalize=True, max_rounds=None):
    return jc.hgm_fit(
        jax.random.PRNGKey(42), jnp.asarray(X), jnp.asarray(w), jnp.asarray(mask),
        jnp.asarray(2 * D, jnp.int32), jnp.asarray(1.0, jnp.float32), k_max, "full",
        k_max - 1 if max_rounds is None else max_rounds, normalize, 1, split_all,
        leaf_fit_points,
    )


def _assert_hgm_agrees(port, jax_fit):
    """The port's (model, labels, n_leaves) against JAX's: every decision
    equal, the fitted values at rtol 1e-3."""
    (model_t, labels_t, n_t), (model_j, labels_j, n_j) = port, jax_fit
    assert n_t.dtype == torch.int32 and n_t.dim() == 0 and int(n_t) == int(n_j)
    np.testing.assert_array_equal(labels_t.numpy(), np.asarray(labels_j))
    assert model_t.k_mask.tolist() == np.asarray(model_j.k_mask).tolist()
    for name in ("centers", "covariances", "weights", "chol_inv", "logdet"):
        want = np.asarray(getattr(model_j, name))
        np.testing.assert_allclose(getattr(model_t, name).numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("split_all,leaf_fit_points", [(True, 256), (False, None)])
@pytest.mark.parametrize("data", sorted(DATA))
def test_hgm_fit(data, split_all, leaf_fit_points):
    X, w, mask = DATA[data]()
    k_max = 4
    model_j, labels_j, n_j = _jax_hgm(X, w, mask, k_max, split_all, leaf_fit_points)
    port = tc.hgm_fit(
        t(X), t(w), t(mask), min_points=2 * D, threshold_modifier=1.0, k_max=k_max,
        max_rounds=k_max - 1, normalize=True, split_all=split_all,
        leaf_fit_points=leaf_fit_points,
    )
    _assert_hgm_agrees(port, (model_j, labels_j, n_j))
    assert (int(port[2]) >= 2) == (data == "bimodal")


# The edge cases of the round schedule: (data, k_max, max_rounds, split_all,
# the leaf count and the rounds the port's host loop runs).
HGM_EDGES = {
    # one Gaussian: nothing is eligible in the first round
    "nothing_eligible": (unimodal, 4, 3, True, 1, 1),
    # four blobs, k_max 4: the second prefix round (width 2) fills it
    "k_max_in_prefix": (blobs, 4, 3, True, 4, 2),
    # one split a round, stopped by max_rounds = 2 < k_max - 1
    "max_rounds": (blobs, 8, 2, False, 3, 2),
}


@pytest.mark.parametrize("case", sorted(HGM_EDGES))
def test_hgm_fit_round_schedule_edges(case):
    data, k_max, max_rounds, split_all, leaves, rounds = HGM_EDGES[case]
    X, w, mask = data()
    loops = Loops("cpu")
    port = tc.hgm_fit(t(X), t(w), t(mask), min_points=2 * D, threshold_modifier=1.0,
                      k_max=k_max, max_rounds=max_rounds, normalize=True, split_all=split_all,
                      loops=loops)
    _assert_hgm_agrees(port, _jax_hgm(X, w, mask, k_max, split_all, None,
                                      max_rounds=max_rounds))
    assert int(port[2]) == leaves and loops.stats["split_round"]["reads"] == rounds


@pytest.mark.parametrize("k_max,max_rounds,split_all", [(8, 1000, True), (8, 1000, False),
                                                        (6, 3, True), (16, 15, True)])
@pytest.mark.parametrize("seed", [0, 1])
def test_hgm_fit_rounds_within_their_bound(seed, k_max, max_rounds, split_all):
    """Every round splits a leaf or ends the fit, so the host loop runs at
    most min(max_rounds, k_max - 1) rounds: the conditional rounds of the
    one-stretch fit. That fit, decided on the device (a stretch's warm-up
    runs every round and selects), gives the host loop's bits with no read."""
    X, w, mask = blobs(seed, n=800, k=12 + seed, spread=5.0)
    args = dict(min_points=2 * D, threshold_modifier=1.0, k_max=k_max,
                max_rounds=max_rounds, normalize=True, split_all=split_all)
    host = Loops("cpu")
    model_h, labels_h, n_h = tc.hgm_fit(t(X), t(w), t(mask), loops=host, **args)
    assert 1 <= host.stats["split_round"]["reads"] <= min(max_rounds, k_max - 1)
    device = Loops("cpu")
    with device.stretch():
        model_d, labels_d, n_d = tc.hgm_fit(t(X), t(w), t(mask), loops=device, **args)
    assert device.stats["split_round"]["reads"] == 0
    assert torch.equal(n_d, n_h) and torch.equal(labels_d, labels_h)
    for name in tc.MODEL_TENSORS:
        assert torch.equal(getattr(model_d, name), getattr(model_h, name)), name


def test_cluster_predict_on_a_jax_model():
    X, w, mask = bimodal(6)
    model_j, _, _ = _jax_hgm(X, w, mask, 4, True, None)
    fields = {k: np.asarray(getattr(model_j, k)) for k in interop.CLUSTER_FIELDS}
    fields["normalize"] = model_j.normalize
    model_t = interop.cluster_model_from_numpy(fields, "cpu")
    assert int(model_t.n_clusters()) == int(model_j.n_clusters()) >= 2
    Xq = np.concatenate([X, np.full((3, D), 50.0, np.float32)])  # far rows: nearest-center fallback
    got = tc.cluster_predict(model_t, t(Xq))
    assert got.dtype == torch.int32
    want = np.asarray(jc.cluster_predict(model_j, jnp.asarray(Xq)))
    np.testing.assert_array_equal(got.numpy(), want)
    back = interop.cluster_model_to_numpy(model_t)
    assert back["normalize"] == model_j.normalize
    np.testing.assert_array_equal(back["centers"], fields["centers"])


def test_single_cluster_model_matches_jax():
    j = jc.single_cluster_model(3, 4, normalize=True)
    p = tc.single_cluster_model(3, 4, normalize=True)
    assert p.normalize and p.k_max == 4 and int(p.n_clusters()) == 1
    for name in interop.CLUSTER_FIELDS:
        np.testing.assert_allclose(getattr(p, name).numpy().astype(np.float64),
                                   np.asarray(getattr(j, name)).astype(np.float64), rtol=1e-6)
