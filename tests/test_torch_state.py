"""state.py of the port against tempest_tpu: a sequence of commits.

The same numpy-made iterations (some log-likelihoods -inf) are committed
to a JAX and a port history. Tolerance atol 1e-5 (rtol 1e-5 where values
are large): every quantity is a float32 logsumexp/logaddexp chain whose
summation order differs between the two packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tempest_tpu.state as js
import tempest_tpu_torch.state as ts
from tempest_tpu_torch import interop

torch.set_num_threads(1)

CAP, N, D = 8, 48, 3


def _iterations(seed, n_iters):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n_iters):
        u = rng.uniform(size=(N, D)).astype(np.float32)
        logl = rng.normal(-8.0, 3.0, N).astype(np.float32)
        logl[rng.choice(N, 3, replace=False)] = -np.inf
        out.append(dict(u=u, logl=logl, beta=np.float32(0.15 * t), logz=np.float32(-0.4 * t)))
    return out


def _build(seed, n_iters):
    jh = js.make_history(CAP, N, D)
    jc = js.make_current(N, D)
    th = ts.make_history(CAP, N, D)
    tc = ts.make_current(N, D)
    for it in _iterations(seed, n_iters):
        jc = jc.replace(u=jnp.asarray(it["u"]), x=jnp.asarray(2 * it["u"]),
                        logl=jnp.asarray(it["logl"]), beta=jnp.asarray(it["beta"]),
                        logz=jnp.asarray(it["logz"]))
        jh = js.commit(jh, jc)
        tc.u, tc.x = torch.from_numpy(it["u"]), torch.from_numpy(2 * it["u"])
        tc.logl = torch.from_numpy(it["logl"])
        tc.beta, tc.logz = torch.tensor(it["beta"]), torch.tensor(it["logz"])
        th = ts.commit(th, tc)
    return jh, th


@pytest.mark.parametrize("seed,n_iters", [(0, 1), (1, 4), (2, 8)])
def test_commits_match_jax(seed, n_iters):
    jh, th = _build(seed, n_iters)
    assert th.t == int(jh.t) == n_iters
    for name in ("u", "x", "logl", "beta", "logz"):
        np.testing.assert_array_equal(getattr(th, name).numpy(), np.asarray(getattr(jh, name)))
    np.testing.assert_allclose(th.mis_c.numpy(), np.asarray(jh.mis_c), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        ts.mis_denominator(th).numpy(), np.asarray(js.mis_denominator(jh)), atol=1e-5, rtol=1e-5
    )
    for beta in (0.0, 0.37, 1.0):
        logw_t, logz_t = ts.compute_logw_and_logz(th, beta)
        logw_j, logz_j = js.compute_logw_and_logz(jh, beta)
        np.testing.assert_allclose(logw_t.numpy(), np.asarray(logw_j), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(float(logz_t), float(logz_j), atol=1e-5)


@pytest.mark.parametrize("seed,n_iters", [(3, 2), (4, 7)])
def test_accumulator_matches_exact_denominator(seed, n_iters):
    jh, th = _build(seed, n_iters)
    exact = ts.mis_denominator_exact(th).numpy()
    # The full-matrix form computes 0 * -inf = NaN at beta_0 = 0 for -inf
    # log-likelihoods, in both packages; the accumulator masks them.
    np.testing.assert_allclose(exact, np.asarray(js.mis_denominator_exact(jh)),
                               atol=1e-5, rtol=1e-5, equal_nan=True)
    finite = np.isfinite(th.logl.numpy())
    np.testing.assert_allclose(ts.mis_denominator(th).numpy()[finite], exact[finite],
                               atol=1e-5, rtol=1e-5)


def test_unfilled_slots_weigh_nothing():
    _, th = _build(5, 3)
    logw, logz = ts.compute_logw_and_logz(th, 0.5)
    assert torch.all(logw[3:] == -np.inf)
    assert torch.all(logw[th.logl == -np.inf] == -np.inf)
    assert np.isfinite(float(logz))
    assert float(ts.logw_from_denominator(ts.make_history(CAP, N, D), th.mis_c, 0.5)[1]) == -np.inf


def test_grow_and_gather_match_jax():
    jh, th = _build(6, 5)
    jg = js.grow_history(jh, 16)
    tg = ts.grow_history(th, 16)
    assert tg.capacity == 16 and tg.t == 5
    for name in interop.HISTORY_FIELDS:
        np.testing.assert_allclose(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    rng = np.random.default_rng(6)
    t_idx = rng.integers(0, 5, 30).astype(np.int32)
    n_idx = rng.integers(0, N, 30).astype(np.int32)
    got = ts.gather_history(tg, torch.from_numpy(t_idx).long(), torch.from_numpy(n_idx).long())
    want = js.gather_history(jg, jnp.asarray(t_idx), jnp.asarray(n_idx))[:3]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        ts.grow_history(tg, 8)


def test_interop_round_trip():
    jh, th = _build(7, 4)
    fields = {k: np.array(getattr(jh, k)) for k in interop.HISTORY_FIELDS + ("t",)}
    h = interop.history_from_numpy(fields, "cpu")
    back = interop.history_to_numpy(h)
    for k in fields:
        np.testing.assert_array_equal(back[k], fields[k], err_msg=k)
    assert h.t == 4 and h.steps.dtype == torch.int32


def test_interop_current_and_modes_round_trip():
    from tempest_tpu.modes import identity_mode_statistics

    jc = js.make_current(N, D).replace(beta=jnp.asarray(0.25, jnp.float32),
                                       iteration=jnp.asarray(6, jnp.int32))
    fields = {k: np.array(getattr(jc, k))
              for k in interop.CURRENT_FIELDS + interop.CURRENT_COUNTERS}
    cur = interop.current_from_numpy(fields, "cpu")
    assert cur.iteration == 6 and float(cur.beta) == 0.25 and cur.u.shape == (N, D)
    back = interop.current_to_numpy(cur)
    for k in fields:
        np.testing.assert_array_equal(back[k], fields[k], err_msg=k)

    jm = identity_mode_statistics(D, k_max=3)
    mfields = {k: np.array(getattr(jm, k)) for k in interop.MODE_FIELDS}
    modes = interop.modes_from_numpy(mfields, "cpu")
    assert modes.k_max == 3 and modes.k_mask.dtype == torch.bool
    for k, v in interop.modes_to_numpy(modes).items():
        np.testing.assert_array_equal(v, mfields[k], err_msg=k)
