"""ops/tools.py and ops/boundary.py of the port against tempest_tpu.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: rtol 1e-5 for float32 reductions whose summation order differs;
exact for the boundary ops (elementwise, same formulas); and at least 99 %
equal indices for the resamplers, because a cumsum taken in another order
can move a uniform across a CDF edge; never an index of zero weight, not
even past a CDF whose float sum stops short of 1 before a zero tail (where
JAX's guard picks the last, zero-weight slot). The port's row-blocked `cumsum`
against a float64 cumsum: rtol 1e-6. `ops.cuda_linalg.eigvalsh` on the CPU
is `torch.linalg.eigvalsh` bit for bit, within 16 d eps max|lambda| of
XLA's float32 `jnp.linalg.eigvalsh` (two LAPACK-style solvers' rounding),
and raises on any device but cpu and cuda.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempest_tpu.ops import boundary as jb
from tempest_tpu.ops import tools as jt
from tempest_tpu_torch.ops import boundary as tb
from tempest_tpu_torch.ops import cuda_linalg
from tempest_tpu_torch.ops import tools as tt

torch.set_num_threads(1)


def _logw(seed, n=500, n_neg_inf=20):
    rng = np.random.default_rng(seed)
    logw = rng.normal(-3.0, 4.0, n).astype(np.float32)
    logw[rng.choice(n, n_neg_inf, replace=False)] = -np.inf
    return logw


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_logsumexp_and_ess(seed):
    logw = _logw(seed)
    np.testing.assert_allclose(
        tt.logsumexp(torch.from_numpy(logw)).numpy(), np.asarray(jt.logsumexp(jnp.asarray(logw))),
        rtol=1e-5,
    )
    two_d = logw.reshape(20, 25)
    for axis in (0, 1):
        np.testing.assert_allclose(
            tt.logsumexp(torch.from_numpy(two_d), dim=axis).numpy(),
            np.asarray(jt.logsumexp(jnp.asarray(two_d), axis=axis)),
            rtol=1e-5,
        )
    np.testing.assert_allclose(
        tt.ess_from_logw(torch.from_numpy(logw)).numpy(),
        np.asarray(jt.ess_from_logw(jnp.asarray(logw))),
        rtol=1e-5,
    )


def test_logsumexp_all_neg_inf():
    x = np.full((4, 3), -np.inf, np.float32)
    assert tt.logsumexp(torch.from_numpy(x)).item() == -np.inf
    assert np.all(tt.logsumexp(torch.from_numpy(x), dim=1).numpy() == -np.inf)


@pytest.mark.parametrize("seed,n_valid", [(0, 600), (1, 450), (2, 37)])
def test_trim_weights_mask(seed, n_valid):
    rng = np.random.default_rng(seed)
    w = (rng.exponential(size=600) ** 3).astype(np.float32)
    mask = np.arange(600) < n_valid
    keep_j, w_j = jt.trim_weights_mask(jnp.asarray(w), mask=jnp.asarray(mask))
    keep_t, w_t = tt.trim_weights_mask(torch.from_numpy(w), mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-12)
    assert keep_t.sum() < n_valid  # the trim did cut the light tail


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resamplers_fed_jax_uniforms(seed):
    rng = np.random.default_rng(seed)
    w = rng.exponential(size=4000).astype(np.float32)
    w[rng.choice(4000, 1000, replace=False)] = 0.0
    key = jax.random.PRNGKey(seed)
    n = 3000

    idx_j = np.asarray(jt.multinomial_resample(key, n, jnp.asarray(w)))
    us = np.array(jax.random.uniform(key, (n,), dtype=jnp.float32))
    idx_t = tt.multinomial_resample(torch.from_numpy(us), torch.from_numpy(w)).numpy()
    assert np.mean(idx_t == idx_j) >= 0.99
    assert np.all(w[idx_t] > 0)

    idx_j = np.asarray(jt.systematic_resample(key, n, jnp.asarray(w)))
    u0 = np.array(jax.random.uniform(key, ()))
    idx_t = tt.systematic_resample(torch.from_numpy(u0), n, torch.from_numpy(w)).numpy()
    assert np.mean(idx_t == idx_j) >= 0.99
    assert np.all(w[idx_t] > 0)


@pytest.mark.parametrize("method", ["mult", "syst"])
def test_resamplers_skip_a_zero_weight_tail(method):
    """The history's unfilled rows weigh 0 at the end of the flat weights.
    Where the CDF's float sum stops short of 1 before them, JAX's guard
    cdf[-1] = 1 (tools.py:89-94) gives the positions past the shortfall
    the last index, a slot of zero weight: on the card at N = 2^20 and
    d = 100 (benchmarks/large_scale.py) such a walker joined the active set
    with logl -inf. The port gives them the last index of nonzero weight,
    and every other position the index of JAX's rule on the same CDF."""
    rng = np.random.default_rng(0)
    w = rng.exponential(size=4096).astype(np.float32)
    w[3072:] = 0.0  # the unfilled rows
    wt = torch.from_numpy(w)
    cdf = tt.cumsum(wt / torch.sum(wt))
    assert float(cdf[3071]) < 1.0  # the shortfall this test is about
    guard = cdf.clone()
    guard[-1] = 1.0
    if method == "mult":
        pos = np.append(rng.uniform(size=2000), [np.nextafter(float(cdf[3071]), 2.0), 1.0])
        pos = torch.from_numpy(pos.astype(np.float32))
        got = tt.multinomial_resample(pos, wt)
    else:
        u0 = torch.tensor(np.float32(1.0))  # the uniforms lie in (0, 1]
        n = 3000
        pos = (u0 + torch.arange(n, dtype=torch.float32)) / n
        got = tt.systematic_resample(u0, n, wt)
    jax_rule = torch.clamp(torch.searchsorted(guard, pos, right=False), 0, w.size - 1)
    tail = w[jax_rule.numpy()] == 0
    assert tail.any() and np.all(jax_rule.numpy()[tail] == w.size - 1)
    assert np.all(w[got.numpy()] > 0)
    assert np.all(got.numpy()[tail] == 3071)
    assert torch.equal(got[torch.from_numpy(~tail)], jax_rule[torch.from_numpy(~tail)])


@pytest.mark.parametrize("n", [1, 1000, 1024, 1025, 4097, 70000, 1100000])
def test_cumsum_rows(n):
    # The row scan against a float64 cumsum, relative 1e-6; up to one row
    # it is torch.cumsum itself.
    x = np.random.default_rng(n).random(n).astype(np.float32)
    got = tt.cumsum(torch.from_numpy(x)).numpy()
    want = np.cumsum(x.astype(np.float64))
    assert got.shape == (n,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if n <= tt.SCAN_ROW:
        np.testing.assert_array_equal(got, torch.cumsum(torch.from_numpy(x), 0).numpy())


def test_volume_variation_dtn():
    rng = np.random.default_rng(4)
    u = rng.uniform(size=(3, 6, 40)).astype(np.float32)
    w = rng.exponential(size=(6, 40)).astype(np.float32)
    mask = np.broadcast_to((np.arange(6) < 4)[:, None], (6, 40))
    cv_j = float(jt.volume_variation_dtn(jnp.asarray(u), jnp.asarray(w), mask=jnp.asarray(mask)))
    cv_t = float(tt.volume_variation_dtn(torch.from_numpy(u), torch.from_numpy(w),
                                         mask=torch.from_numpy(mask.copy())))
    np.testing.assert_allclose(cv_t, cv_j, rtol=1e-4)
    # Too few valid samples for a d x d covariance: both flag 1e10.
    few = np.zeros((6, 40), bool)
    few[0, :2] = True
    assert float(tt.volume_variation_dtn(torch.from_numpy(u), torch.from_numpy(w),
                                         mask=torch.from_numpy(few))) == 1e10


def cv100_inputs(seed=5):
    """The CV at the rosenbrock100 path's d = 100: a (100, 8, 256) history
    of uniforms with the first 6 slots filled (1,536 samples), exponential
    weights."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(100, 8, 256))
    w = rng.exponential(size=(8, 256))
    mask = np.broadcast_to((np.arange(8) < 6)[:, None], (8, 256)).copy()
    return u, w, mask


def test_volume_variation_dtn_at_d100():
    """float32, on the CPU route (LAPACK's eigenvalues, then the rank test,
    an inverse and the Mahalanobis distances): rtol 1e-5. Under x64 it is
    held to 1e-12 in tests/test_torch_float64.py."""
    u, w, mask = (a.astype(np.float32) if a.dtype != bool else a for a in cv100_inputs())
    cv_j = float(jt.volume_variation_dtn(jnp.asarray(u), jnp.asarray(w), mask=jnp.asarray(mask)))
    cv_t = float(tt.volume_variation_dtn(torch.from_numpy(u), torch.from_numpy(w),
                                         mask=torch.from_numpy(mask)))
    assert cv_j < 1e10
    np.testing.assert_allclose(cv_t, cv_j, rtol=1e-5)


def _symmetric(rng, batch, d, kind):
    """(batch, d, d) symmetric matrices: SPD, indefinite, rank-deficient
    (rank d // 2, an exact zero eigenvalue) or diagonal."""
    x = rng.normal(size=(batch, d, d))
    if kind == "spd":
        return x @ np.swapaxes(x, 1, 2) / d + 0.1 * np.eye(d)
    if kind == "indefinite":
        return x + np.swapaxes(x, 1, 2)
    if kind == "rank_deficient":
        y = x[:, :, : max(d // 2, 1)]
        return y @ np.swapaxes(y, 1, 2)
    return np.stack([np.diag(rng.normal(size=d)) for _ in range(batch)])


@pytest.mark.parametrize("kind", ["spd", "indefinite", "rank_deficient", "diagonal"])
@pytest.mark.parametrize("d", [1, 3, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eigvalsh_plain_route(dtype, d, kind):
    a = torch.from_numpy(_symmetric(np.random.default_rng(d), 3, d, kind)).to(dtype)
    got = cuda_linalg.eigvalsh(a)
    assert got.dtype == dtype and got.shape == (3, d)
    assert torch.equal(got, torch.linalg.eigvalsh(a))
    if dtype == torch.float32:
        want = np.asarray(jnp.linalg.eigvalsh(jnp.asarray(a.numpy())))
        scale = np.abs(want).max(axis=1, keepdims=True)
        assert np.all(np.abs(got.numpy() - want) <= 16 * d * np.finfo(np.float32).eps * scale)


def test_eigvalsh_refuses_other_devices():
    with pytest.raises(ValueError, match="cpu or cuda"):
        cuda_linalg.eigvalsh(torch.empty(2, 3, 3, device="meta"))


def test_eigvalsh_launch_plan():
    """Each matrix in shared memory up to d = 238 in float32 and 168 in
    float64 (227 KB a CTA), a global workspace past that."""
    for dtype, last in ((torch.float32, 238), (torch.float64, 168)):
        assert cuda_linalg.plan_launch(last, dtype).resident
        assert cuda_linalg.plan_launch(last - 1, dtype).resident
        assert not cuda_linalg.plan_launch(last + 1, dtype).resident
        assert cuda_linalg.plan_launch(last, dtype).smem <= cuda_linalg.SMEM_MAX
    assert cuda_linalg.plan_launch(10).m == cuda_linalg.plan_launch(9).m == 10


def test_boundary_ops_exact():
    rng = np.random.default_rng(5)
    u = rng.uniform(-2.5, 3.5, size=(7, 64, 5)).astype(np.float32)
    pj, rj, sj = jb.make_boundary_masks(5, periodic=[0, 3], reflective=[1])
    pt, rt, st = tb.make_boundary_masks(5, periodic=[0, 3], reflective=[1])
    for a, b in ((pt, pj), (rt, rj), (st, sj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    out_j = np.asarray(jb.apply_boundary_conditions(jnp.asarray(u), pj, rj))
    out_t = tb.apply_boundary_conditions(torch.from_numpy(u), pt, rt).numpy()
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(
        tb.check_bounds(torch.from_numpy(out_t), st).numpy(),
        np.asarray(jb.check_bounds(jnp.asarray(out_j), sj)),
    )
