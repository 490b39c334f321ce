"""The public functions of `tempest_tpu.ops` and `tempest_tpu.student` on the
port, against the JAX package.

Every case of tests/test_tools.py that calls `effective_sample_size`,
`compute_ess`, `increment_logz` or the (n, d) `volume_variation`, and every
case of tests/test_student.py, runs both packages on the same numpy-made
float32 input: the port must give JAX's value, and the case's own bar.
Tolerances: rtol 1e-6 for the ESS and logZ helpers (a handful of float32
sums), 1e-4 for the CV (an eigen-decomposition and an inverse of a
covariance summed in another order, as tests/test_torch_tools.py holds
`volume_variation_dtn`); the 1e10 flag exactly. The Student-t fits as in
tests/test_torch_student_modes.py: mean and covariance rtol 1e-3, nu as
1/nu within 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tempest_tpu.ops as jops
import tempest_tpu_torch.ops as tops
from tempest_tpu import student as js
from tempest_tpu_torch import student as ts

torch.set_num_threads(1)


def test_ops_exports_match_jax():
    assert tops.__all__ == jops.__all__
    assert all(callable(getattr(tops, name)) for name in tops.__all__)


def _both(fn_name, *arrays, **kw):
    """(port, JAX) values of ops.<fn_name> on the same float32 inputs."""
    t_args = [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays]
    j_args = [None if a is None else jnp.asarray(a) for a in arrays]
    return (float(getattr(tops, fn_name)(*t_args, **kw)),
            float(getattr(jops, fn_name)(*j_args, **kw)))


_SKEWED = np.array([0.5, 0.25, 0.125, 0.125], np.float32)

# (weights, mask, the reference's expected ESS)
ESS_CASES = {
    "uniform": (np.ones(100, np.float32), None, 100.0),
    "degenerate": (np.eye(50, dtype=np.float32)[7], None, 1.0),
    "skewed": (_SKEWED, None, 1.0 / np.sum(_SKEWED.astype(np.float64) ** 2)),
    "unnormalized": (np.array([1.0, 2.0, 3.0], np.float32) * 17.0, None, 36.0 / 14.0),
    "masked": (np.array([1.0, 1.0, 99.0, 99.0], np.float32),
               np.array([True, True, False, False]), 2.0),
}


@pytest.mark.parametrize("case", list(ESS_CASES))
def test_effective_sample_size(case):
    w, mask, expected = ESS_CASES[case]
    got, want = _both("effective_sample_size", w, mask)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.isclose(got, expected, rtol=1e-5)


def test_ess_from_logw_matches_effective_sample_size():
    logw = np.array([-1.0, -2.0, -0.5, -3.0], np.float32)
    got, want = _both("ess_from_logw", logw)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.isclose(got, _both("effective_sample_size", np.exp(logw))[0], rtol=1e-4)


@pytest.mark.parametrize("logw,expected", [
    (np.zeros(64, np.float32), 1.0),
    (np.array([0.0, 0.0, -np.inf, -np.inf], np.float32), 0.5),
    (np.random.default_rng(0).normal(-2.0, 3.0, 500).astype(np.float32), None),
])
def test_compute_ess(logw, expected):
    got, want = _both("compute_ess", logw)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if expected is not None:
        assert np.isclose(got, expected, rtol=1e-5)


@pytest.mark.parametrize("logw", [
    np.array([-1.0, -2.0, -3.0], np.float32),
    np.array([-np.inf, 0.5, -np.inf], np.float32),
    np.random.default_rng(1).normal(-2.0, 3.0, 500).astype(np.float32),
])
def test_increment_logz(logw):
    got, want = _both("increment_logz", logw)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    expected = np.log(np.sum(np.exp(logw.astype(np.float64))))
    assert np.isclose(got, expected, rtol=1e-6)


def _vv_inputs(case):
    """(x, w, mask) of each tests/test_tools.py TestVolumeVariation case."""
    if case == "gaussian":
        return np.random.default_rng(0).standard_normal((5000, 3)), None, None
    if case == "too_few":
        return np.random.default_rng(0).standard_normal((3, 5)), None, None
    if case == "weighted_uniform":
        return np.random.default_rng(2).standard_normal((500, 2)), np.ones(500), None
    if case == "masked":
        rng = np.random.default_rng(3)
        x = np.concatenate([rng.standard_normal((400, 2)), np.full((100, 2), 1e6)])
        return x, None, np.arange(500) < 400
    if case == "weighted":
        rng = np.random.default_rng(4)
        return rng.standard_normal((800, 4)), rng.exponential(size=800), None
    return np.zeros((100, 4)), None, None  # degenerate


@pytest.mark.parametrize("case", ["gaussian", "too_few", "weighted_uniform", "masked",
                                  "weighted", "degenerate"])
def test_volume_variation(case):
    x, w, mask = _vv_inputs(case)
    x = x.astype(np.float32)
    w = None if w is None else w.astype(np.float32)
    got, want = _both("volume_variation", x, w, mask)
    if want == 1e10:
        assert got == 1e10
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4)
    if case == "gaussian":
        assert 0.0 <= got < 0.1
    elif case == "too_few":
        assert got == pytest.approx(1e10)
    elif case == "weighted_uniform":
        assert np.isclose(got, _both("volume_variation", x)[0], rtol=1e-4)
    elif case == "masked":
        assert np.isclose(got, _both("volume_variation", x[:400])[0], rtol=1e-3)
    elif case == "degenerate":
        assert np.isfinite(got)


def _student_data(case):
    """The data of each tests/test_student.py case, in float32."""
    rng = np.random.default_rng({"gaussian": 0, "heavy": 1, "one_dim": 2, "line": 3,
                                 "repeat": 4, "offset": 5, "outliers": 4, "correlated": 5,
                                 "scales": 6, "tiny": 7, "heavy5": 0}.get(case, 0))
    if case == "gaussian":
        x = rng.standard_normal((2000, 2))
    elif case == "heavy":
        g = rng.standard_normal((4000, 2))
        x = g / np.sqrt(rng.chisquare(3.0, size=4000) / 3.0)[:, None]
    elif case == "one_dim":
        x = rng.standard_normal((500, 1)) * 2.0 + 3.0
    elif case == "constant":
        x = np.ones((100, 3))
    elif case == "line":
        t = rng.standard_normal(200)
        x = np.stack([t, 2 * t], axis=1)
    elif case == "repeat":
        x = rng.standard_normal((300, 2))
    elif case == "offset":
        x = rng.standard_normal((1000, 3)) + np.array([1.0, -2.0, 0.5])
    elif case == "heavy5":
        x = rng.standard_t(3.0, (4096, 5))
    elif case == "outliers":
        x = np.concatenate([rng.standard_normal((1900, 2)), rng.standard_normal((100, 2)) * 15.0])
    elif case == "correlated":
        x = rng.standard_normal((4000, 2)) @ np.array([[1.0, 0.0], [0.9, 0.3]]).T
    elif case == "scales":
        x = rng.standard_normal((3000, 2)) * np.array([1e-3, 1e3])
    else:  # tiny
        x = rng.standard_normal((5, 3))
    return x.astype(np.float32)


def _inv_nu(nu):
    return 0.0 if not np.isfinite(nu) else 1.0 / nu


STUDENT_CASES = ["gaussian", "heavy", "one_dim", "constant", "line", "repeat", "offset",
                 "heavy5", "outliers", "correlated", "scales", "tiny"]


@pytest.mark.parametrize("case", STUDENT_CASES)
def test_fit_mvstud_matches_jax(case):
    x = _student_data(case)
    mu_t, cov_t, nu_t = ts.fit_mvstud(torch.from_numpy(x))
    mu_j, cov_j, nu_j = (np.asarray(a) for a in js.fit_mvstud(jnp.asarray(x)))
    mu_t, cov_t, nu_t = mu_t.numpy(), cov_t.numpy(), float(nu_t)
    assert mu_t.shape == mu_j.shape and cov_t.shape == cov_j.shape
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-3, atol=1e-3 * max(np.abs(mu_j).max(), 1e-3))
    np.testing.assert_allclose(cov_t, cov_j, rtol=1e-3, atol=1e-3 * np.abs(cov_j).max())
    assert abs(_inv_nu(nu_t) - _inv_nu(float(nu_j))) < 1e-3, (nu_t, float(nu_j))

    # The bars of tests/test_student.py.
    assert np.all(np.isfinite(mu_t)) and np.all(np.isfinite(cov_t))
    assert np.all(np.linalg.eigvalsh(cov_t.astype(np.float64)) > 0)
    if case == "gaussian":
        assert nu_t > 20.0 or np.isinf(nu_t)
        np.testing.assert_allclose(mu_t, [0.0, 0.0], atol=0.15)
        np.testing.assert_allclose(cov_t, np.eye(2), atol=0.2)
    elif case == "heavy":
        assert np.isfinite(nu_t) and 1.0 < nu_t < 10.0
    elif case == "one_dim":
        assert abs(float(mu_t[0]) - 3.0) < 0.3
    elif case == "repeat":
        again = ts.fit_mvstud(torch.from_numpy(x))
        np.testing.assert_array_equal(again[0].numpy(), mu_t)
        np.testing.assert_array_equal(again[1].numpy(), cov_t)
    elif case == "offset":
        np.testing.assert_allclose(mu_t, [1.0, -2.0, 0.5], atol=0.2)
    elif case == "heavy5":
        assert np.isfinite(nu_t) and nu_t < 15.0
    elif case == "outliers":
        assert np.isfinite(nu_t) and nu_t < 20.0
        np.testing.assert_allclose(mu_t, [0.0, 0.0], atol=0.25)
    elif case == "correlated":
        corr = cov_t[0, 1] / np.sqrt(cov_t[0, 0] * cov_t[1, 1])
        assert abs(corr - 0.9 / np.sqrt(0.9)) < 0.05
    elif case == "scales":
        assert 0.5e-6 < cov_t[0, 0] < 2e-6 and 0.5e6 < cov_t[1, 1] < 2e6


def test_fit_mvstud_starts_from_jax_median():
    """An even count: jnp.median averages the two middle values, and so must
    the port's start (torch.median would take the lower one)."""
    x = np.array([[0.0, 5.0], [1.0, 7.0], [4.0, 6.0], [10.0, 8.0]], np.float32)
    mu_t, cov_t, _ = ts.fit_mvstud(torch.from_numpy(x), max_iter=0)  # the start itself
    mu_j, cov_j, _ = js.fit_mvstud(jnp.asarray(x), max_iter=0)
    np.testing.assert_array_equal(mu_t.numpy(), np.asarray(mu_j))
    assert mu_t.tolist() == [2.5, 6.5]
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), rtol=1e-6)
