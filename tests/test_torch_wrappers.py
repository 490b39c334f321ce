"""Model-function wrapping of the port against tempest_tpu.

- Per-point functions (`vectorize=False`, the default) mapped with
  `torch.func.vmap` equal the vectorized forms on the same numpy-made
  points (rtol 1e-6: the same float32 operations), and, with blobs, equal
  the JAX package's `jax.vmap`ped per-point wrapper on the same inputs
  (rtol 1e-6 on logl and blobs).
- `build_blob_schema` gives the JAX layout for every declaration form, and
  detecting blobs evaluates no likelihood on real data: the probe runs on
  the meta device, and a function that cannot run there (it builds CPU
  tensors) means no blobs, as a failing `jax.eval_shape` does.
- `host_likelihood=True`: numpy per-point functions on the host equal the
  torch function; a pool object's `.map` is used; `pool=<int>` runs one
  small run on spawned workers and `close()` ends them.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempest_tpu.utils.blobs import BlobSchema as JaxBlobSchema
from tempest_tpu.utils.wrappers import build_blob_schema as jax_build_blob_schema
from tempest_tpu.utils.wrappers import build_log_likelihood as jax_build_log_likelihood
from tempest_tpu_torch import Sampler
from tempest_tpu_torch.utils.blobs import BlobSchema
from tempest_tpu_torch.utils.wrappers import (
    FunctionWrapper,
    SpawnPoolMap,
    make_pool_map,
    build_blob_schema,
    build_log_likelihood,
    build_prior_transform,
)

torch.set_num_threads(1)

N, D = 33, 4


def _points(seed=0):
    return np.random.default_rng(seed).uniform(-2, 2, (N, D)).astype(np.float32)


def rosen_t(x):
    return -torch.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2 + (1.0 - x[..., :-1]) ** 2,
                      dim=-1)


def rosen_j(x):
    return -jnp.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2 + (1.0 - x[..., :-1]) ** 2,
                    axis=-1)


def blobs_t(x):
    return rosen_t(x), torch.sum(x * x), x[:2]


def blobs_j(x):
    return rosen_j(x), jnp.sum(x * x), x[:2]


def prior_t(u):
    return 20.0 * u - 10.0


def test_per_point_equals_vectorized():
    x = torch.from_numpy(_points())
    per_point = build_log_likelihood(rosen_t, vectorize=False, have_blobs=False,
                                     host_likelihood=False)
    batched = build_log_likelihood(rosen_t, vectorize=True, have_blobs=False,
                                   host_likelihood=False)
    (a, none_a), (b, none_b) = per_point(x), batched(x)
    assert none_a is None and none_b is None and a.shape == (N,)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
    u = torch.rand(N, D, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(build_prior_transform(prior_t, False)(u).numpy(),
                               build_prior_transform(prior_t, True)(u).numpy(), rtol=1e-6)


def test_per_point_blobs_equal_jax():
    x = _points(2)
    schema_j = jax_build_blob_schema(blobs_j, D, False, False)
    schema_t = build_blob_schema(blobs_t, D, False, False)
    assert (schema_t.width, schema_t.np_dtype) == (schema_j.width, schema_j.np_dtype) == (
        3, np.float32)
    logl_j, rows_j = jax_build_log_likelihood(blobs_j, False, True, False, N,
                                              schema=schema_j)(jnp.asarray(x))
    logl_t, rows_t = build_log_likelihood(blobs_t, False, True, False,
                                          schema=schema_t)(torch.from_numpy(x))
    np.testing.assert_allclose(logl_t.numpy(), np.asarray(logl_j), rtol=1e-6)
    np.testing.assert_allclose(rows_t.numpy(), np.asarray(rows_j), rtol=1e-6)
    assert rows_t.shape == (N, 3) and rows_t.dtype == torch.float32


def _scalar_t(x):
    return rosen_t(x)


def _scalar_j(x):
    return rosen_j(x)


def _mixed_t(x):
    return rosen_t(x), torch.sum(x), torch.as_tensor(3, dtype=torch.int32, device=x.device)


def _mixed_j(x):
    return rosen_j(x), jnp.sum(x), jnp.asarray(3, jnp.int32)


@pytest.mark.parametrize("case", [
    dict(fns=(blobs_t, blobs_j)),  # auto-detected
    dict(fns=(_scalar_t, _scalar_j)),  # no blobs
    dict(fns=(_mixed_t, _mixed_j)),  # auto-detected, mixed dtypes
    dict(fns=(blobs_t, blobs_j), vectorize=True),  # vectorized: none unless declared
    dict(fns=(blobs_t, blobs_j), have_blobs=True, blobs_dtype="float32"),  # width probed
    dict(fns=(blobs_t, blobs_j), have_blobs=True, blobs_dtype="float32", declared_size=3),
    dict(fns=(blobs_t, blobs_j), have_blobs=True,
         blobs_dtype=[("r2", np.float32), ("head", np.float32, (2,))]),
    dict(fns=(blobs_t, blobs_j), have_blobs=True, blobs_dtype="U4"),
])
def test_blob_schema_equals_jax(case):
    fn_t, fn_j = case.pop("fns")
    args = dict(have_blobs=False, host_likelihood=False)
    args.update(case)
    want = jax_build_blob_schema(fn_j, D, **args)
    got = build_blob_schema(fn_t, D, **args)
    if want is None:
        assert got is None
        return
    assert (got.width, got.np_dtype, got.is_object, got.is_struct) == (
        want.width, want.np_dtype, want.is_object, want.is_struct)


def test_host_blob_width_from_one_midpoint_call_equals_jax():
    def host_ll(x):
        return float(-np.sum(x * x)), np.sum(x), x[:2]

    with pytest.warns(UserWarning, match="ONE likelihood evaluation"):
        want = jax_build_blob_schema(host_ll, D, True, True, "float64", prior_transform=lambda u: u)
    with pytest.warns(UserWarning, match="ONE likelihood evaluation"):
        got = build_blob_schema(host_ll, D, True, True, "float64", prior_transform=prior_t)
    assert (got.width, got.np_dtype) == (want.width, want.np_dtype) == (3, np.float64)


class CountingLikelihood:
    """Counts the calls that see real data (not the meta device)."""

    def __init__(self, fn):
        self.fn, self.real_calls = fn, 0

    def __call__(self, x):
        if x.device.type != "meta":
            self.real_calls += 1
        return self.fn(x)


def test_detection_makes_no_real_likelihood_call():
    ll = CountingLikelihood(blobs_t)
    s = Sampler(prior_t, ll, n_dim=D, n_particles=16, clustering=False, device="cpu")
    assert ll.real_calls == 0 and s.state.blob_schema.width == 3
    s.sample()
    assert ll.real_calls == 1  # one vmapped call of the warm-up draw


def _cpu_constant_ll(x):
    shift = torch.tensor([0.5, -0.5, 0.25, 0.0])  # a CPU tensor: fails on meta
    return -torch.sum((x - shift) ** 2), x[0]


def test_probe_failure_means_no_blobs():
    ll = CountingLikelihood(_cpu_constant_ll)
    s = Sampler(prior_t, ll, n_dim=D, n_particles=16, clustering=False, device="cpu")
    assert s.state.blob_schema is None and ll.real_calls == 0


def _np_rosen(x):
    return float(-np.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2))


def _np_rosen_blobs(x):
    return _np_rosen(x), float(np.sum(x * x)), x[0]


def test_host_likelihood_equals_torch():
    x = torch.from_numpy(_points(4))
    logl, blobs = build_log_likelihood(_np_rosen, False, False, True)(x)
    assert blobs is None and logl.dtype == torch.float32
    np.testing.assert_allclose(logl.numpy(), rosen_t(x).numpy(), rtol=1e-5)
    schema = BlobSchema(np.float32, blob_size=2)
    logl_b, rows = build_log_likelihood(_np_rosen_blobs, False, True, True, schema=schema)(x)
    np.testing.assert_allclose(logl_b.numpy(), logl.numpy())
    np.testing.assert_allclose(rows[:, 0].numpy(), torch.sum(x * x, dim=-1).numpy(), rtol=1e-5)
    np.testing.assert_array_equal(rows[:, 1].numpy(), x[:, 0].numpy())


def _gauss_np(x):
    return float(-0.5 * np.sum(x * x) - 0.5 * x.shape[0] * math.log(2 * math.pi))


def _prior5(u):
    return 10.0 * u - 5.0


def test_pool_object_map_is_used():
    calls = {"n": 0}

    class CountingPool:
        def map(self, f, xs):
            calls["n"] += 1
            return [f(x) for x in xs]

    s = Sampler(_prior5, _gauss_np, n_dim=2, n_particles=64, host_likelihood=True,
                pool=CountingPool(), clustering=False, random_state=0, device="cpu")
    s.run(n_total=256, progress=False)
    assert calls["n"] > 0 and s.beta == 1.0
    assert abs(s.evidence()[0] + 2 * math.log(10.0)) < 0.7


def test_int_pool_run_and_close():
    s = Sampler(_prior5, _gauss_np, n_dim=2, n_particles=16, host_likelihood=True, pool=2,
                clustering=False, random_state=1, n_max_steps=2, device="cpu")
    pool_map = s.state.pool_map
    assert isinstance(pool_map, SpawnPoolMap) and pool_map.pool is None
    try:
        s.run(n_total=32, progress=False)
        assert pool_map.pool is not None and s.beta == 1.0
        assert math.isfinite(s.evidence()[0])
    finally:
        s.close()
    assert pool_map.pool is None


def test_int_pool_gives_the_bits_of_no_pool():
    """pool=2 on the run loop: the spawned workers' logl, pickled back,
    give pool=None's run bit for bit."""
    runs = []
    for pool in (None, 2):
        s = Sampler(_prior5, _gauss_np, n_dim=2, n_particles=16, host_likelihood=True,
                    pool=pool, clustering=False, random_state=1, n_max_steps=2, device="cpu")
        try:
            s.run(n_total=32, progress=False, on_device=True)
            runs.append(s.results())
        finally:
            s.close()
    for key in ("beta", "logz", "steps", "calls", "logl"):
        assert runs[0][key].tobytes() == runs[1][key].tobytes(), key


def test_pool_without_host_likelihood_warns_and_bad_pool_raises():
    with pytest.warns(UserWarning, match="pool is ignored"):
        Sampler(prior_t, rosen_t, n_dim=D, pool=2, vectorize=True, device="cpu")
    with pytest.raises(ValueError, match="pool must be"):
        make_pool_map("four")


def _shifted(x, shift, scale=1.0):
    return -scale * torch.sum((x - shift) ** 2)


def test_likelihood_args_and_kwargs_are_bound():
    wrapped = FunctionWrapper(_shifted, [0.5], {"scale": 2.0})
    x = torch.from_numpy(_points(5))
    logl, _ = build_log_likelihood(wrapped, False, False, False)(x)
    np.testing.assert_allclose(logl.numpy(), (-2.0 * torch.sum((x - 0.5) ** 2, dim=-1)).numpy(),
                               rtol=1e-6)
    s = Sampler(prior_t, _shifted, n_dim=D, n_particles=16, log_likelihood_args=[0.5],
                log_likelihood_kwargs={"scale": 2.0}, clustering=False, device="cpu")
    assert s.state.blob_schema is None and s.sample()["logl"].shape == (16,)

