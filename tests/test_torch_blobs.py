"""Blobs in the port against tempest_tpu.

1. `BlobSchema`: pack and unpack equal the JAX schema's on the cases of
   tests/test_blobs.py (exact: both are numpy code on the same items).
2. The blob rows through the state: make, commit, grow and gather with
   blobs equal the JAX functions on the same numpy-made iterations, and
   the warm-up's patch of infinite log-likelihoods moves the blob rows
   with the particles, value for value on the JAX warm-up's own uniforms.
3. Whole runs on the CPU with the semantics tests/test_blobs.py asks of
   the JAX package: auto-detection from a tuple return, several trailing
   values in order, no blobs, structured and mixed-dtype blobs, object
   payloads that follow their particles, and the object store through a
   state file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tempest_tpu.state as js
import tempest_tpu_torch.state as ts
from tempest_tpu.steps.mutate import make_warmup_kernel
from tempest_tpu.utils.blobs import BlobSchema as JaxBlobSchema
from tempest_tpu.utils.blobs import infer_np_dtype_from_result as jax_infer
from tempest_tpu_torch import Sampler, interop
from tempest_tpu_torch.steps.mutate import warmup
from tempest_tpu_torch.utils.blobs import BlobSchema, infer_np_dtype_from_result

torch.set_num_threads(1)

STRUCT = np.dtype([("chi2", np.float32), ("vec", np.float32, (2,))])
MIXED = np.dtype([("a", np.float32), ("k", np.int32)])

SCHEMA_CASES = {
    "simple_width1": (np.float32, 1, [(1.5,), (2.5,)]),
    "simple_vector": (np.float64, 3, [(np.arange(3.0),), (np.arange(3.0) + 1,)]),
    "structured": (STRUCT, None, [(1.0, np.array([2.0, 3.0])), (4.0, np.array([5.0, 6.0]))]),
    "mixed_fields": (MIXED, None, [(1.5, 3), (2.5, 4)]),
    "string": ("U8", None, [("abc",), ("defghijklmnop",)]),
    "object": ("object", None, [({"tag": 1},), ([1, 2],), ("x",)]),
}


@pytest.mark.parametrize("case", sorted(SCHEMA_CASES))
def test_pack_and_unpack_equal_jax(case):
    dtype, size, items = SCHEMA_CASES[case]
    j, t = JaxBlobSchema(dtype, blob_size=size), BlobSchema(dtype, blob_size=size)
    assert (t.width, t.is_object, t.is_struct, t.np_dtype) == (
        j.width, j.is_object, j.is_struct, j.np_dtype)
    rows_j, rows_t = j.pack(items), t.pack(items)
    np.testing.assert_array_equal(rows_t, rows_j)
    assert rows_t.dtype == torch.empty(0, dtype=t.device_dtype).numpy().dtype
    out_j, out_t = j.unpack(rows_j), t.unpack(rows_t)
    assert out_t.dtype == out_j.dtype and out_t.shape == out_j.shape
    if t.is_object:
        assert list(out_t) == list(out_j)
    else:
        np.testing.assert_array_equal(out_t, out_j)


def test_object_store_prune_equal_jax():
    j, t = JaxBlobSchema("object"), BlobSchema("object")
    for sch in (j, t):
        sch.pack([(i,) for i in range(5)])
        sch.prune_store(np.array([0, 3, -1]))
    assert t.store == j.store == [0, None, None, 3, None]


@pytest.mark.parametrize("value", [1.5, "abc", np.float32(2.0), (1.0, "a"), [1, [2, 3]]])
def test_infer_dtype_equal_jax(value):
    assert infer_np_dtype_from_result(value) == jax_infer(value)


# ---------------------------------------------------------------------------
# Blob rows through the state
# ---------------------------------------------------------------------------
CAP, N, D, B = 6, 24, 2, 3


def _pair_with_blobs(n_iters, seed=0):
    rng = np.random.default_rng(seed)
    jh = js.make_history(CAP, N, D, blob_size=B, blobs_dtype=jnp.float32)
    jc = js.make_current(N, D, blob_size=B, blobs_dtype=jnp.float32)
    th = ts.make_history(CAP, N, D, blob_size=B, blobs_dtype=torch.float32)
    tc = ts.make_current(N, D, blob_size=B, blobs_dtype=torch.float32)
    for t in range(n_iters):
        u = rng.uniform(size=(N, D)).astype(np.float32)
        logl = rng.normal(-5.0, 2.0, N).astype(np.float32)
        blobs = rng.normal(size=(N, B)).astype(np.float32)
        beta, logz = np.float32(0.2 * t), np.float32(-0.3 * t)
        jc = jc.replace(u=jnp.asarray(u), x=jnp.asarray(u), logl=jnp.asarray(logl),
                        blobs=jnp.asarray(blobs), beta=jnp.asarray(beta), logz=jnp.asarray(logz))
        jh = js.commit(jh, jc)
        tc.u, tc.x, tc.logl = torch.from_numpy(u), torch.from_numpy(u), torch.from_numpy(logl)
        tc.blobs = torch.from_numpy(blobs)
        tc.beta, tc.logz = torch.tensor(beta), torch.tensor(logz)
        ts.commit(th, tc)
    return jh, th


def test_history_blobs_commit_grow_gather_equal_jax():
    jh, th = _pair_with_blobs(4)
    assert th.blobs.shape == (B, CAP, N) and th.t == 4
    np.testing.assert_array_equal(th.blobs.numpy(), np.asarray(jh.blobs))
    jg, tg = js.grow_history(jh, 12), ts.grow_history(th, 12)
    np.testing.assert_array_equal(tg.blobs.numpy(), np.asarray(jg.blobs))
    rng = np.random.default_rng(1)
    t_idx, n_idx = rng.integers(0, 4, 20), rng.integers(0, N, 20)
    got = ts.gather_history(tg, torch.from_numpy(t_idx), torch.from_numpy(n_idx))
    want = js.gather_history(jg, jnp.asarray(t_idx), jnp.asarray(n_idx))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = interop.history_to_numpy(th)
    np.testing.assert_array_equal(back["blobs"], np.asarray(jh.blobs))
    assert interop.history_from_numpy(back, "cpu").blobs.shape == (B, CAP, N)


def test_warmup_patch_moves_blobs_like_jax():
    """Particles with x0 > 2 get logl = -inf; the patch replaces them, blob
    rows included, from the finite ones (JAX uniforms fed to the port)."""
    n, d = 64, 2

    def prior_j(u):
        return 10.0 * u - 5.0

    def ll_j(x):
        logl = jnp.where(x[:, 0] > 2.0, -jnp.inf, -0.5 * jnp.sum(x * x, axis=-1))
        return logl, jnp.stack([jnp.sum(x, axis=-1), x[:, 1]], axis=-1)

    def ll_t(x):
        logl = torch.where(x[:, 0] > 2.0, float("-inf"), -0.5 * torch.sum(x * x, dim=-1))
        return logl, torch.stack([torch.sum(x, dim=-1), x[:, 1]], dim=-1)

    key = jax.random.PRNGKey(3)
    want = make_warmup_kernel(ll_j, prior_j, n, d)(key)
    k_draw, k_patch = jax.random.split(key)
    u_draw = torch.from_numpy(np.array(jax.random.uniform(k_draw, (n, d), dtype=jnp.float32)))
    patch_u = torch.from_numpy(np.array(jax.random.uniform(k_patch, (n,), dtype=jnp.float32)))
    got = warmup(u_draw, patch_u, ll_t, lambda u: 10.0 * u - 5.0)
    assert bool(torch.all(torch.isfinite(got.logl)))
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), atol=1e-6)
    np.testing.assert_allclose(got.logl.numpy(), np.asarray(want.logl), atol=1e-5)
    np.testing.assert_allclose(got.blobs.numpy(), np.asarray(want.blobs), atol=1e-5)
    np.testing.assert_allclose(float(got.logz_correction), float(want.logz_correction),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Whole runs (tests/test_blobs.py's semantics)
# ---------------------------------------------------------------------------
def _prior(u):
    return 10.0 * u - 5.0


def _run(ll, n_total=64, **kw):
    kw.setdefault("n_particles", 32)
    s = Sampler(_prior, ll, n_dim=2, random_state=0, device="cpu", **kw)
    s.run(n_total=n_total, progress=False)
    return s


def _ll_sum(x):
    return -0.5 * torch.sum(x * x), torch.sum(x)


def _ll_sum_max(x):
    return -0.5 * torch.sum(x * x), torch.sum(x), torch.max(x)


def _ll_plain(x):
    return -0.5 * torch.sum(x * x)


def _ll_struct(x):
    return -0.5 * torch.sum(x * x), torch.sum(x), x * 2.0


def _ll_mixed(x):
    return -0.5 * torch.sum(x * x), torch.sum(x), torch.full_like(x[0], 3, dtype=torch.int32)


def test_tuple_return_detected_without_dtype():
    s = _run(_ll_sum)
    x, w, logl, blobs = s.posterior(return_blobs=True)
    assert blobs.shape == x.shape[:1]
    np.testing.assert_allclose(blobs, x.sum(axis=1), rtol=1e-5, atol=1e-6)


def test_multiple_trailing_values_packed_in_order():
    s = _run(_ll_sum_max)
    x, w, logl, blobs = s.posterior(return_blobs=True)
    assert blobs.shape == (x.shape[0], 2)
    np.testing.assert_allclose(blobs[:, 0], x.sum(axis=1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(blobs[:, 1], x.max(axis=1), rtol=1e-5)
    cur = s.sample()["blobs"]
    assert cur.shape == (32, 2)


def test_no_blobs_unchanged():
    s = _run(_ll_plain)
    assert s.state.blob_schema is None
    assert len(s.posterior(return_blobs=True)) == 3


def test_structured_run_and_results():
    dt = [("s", np.float32), ("v", np.float32, (2,))]
    s = _run(_ll_struct, blobs_dtype=dt)
    x, w, logl, blobs = s.posterior(return_blobs=True)
    assert blobs.dtype == np.dtype(dt)
    np.testing.assert_allclose(blobs["s"], x.sum(axis=1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(blobs["v"], 2.0 * x, rtol=1e-5)
    r = s.results()
    assert r["blobs"].dtype == np.dtype(dt) and r["blobs"].shape == (s.state.hist.t, 32)


def test_mixed_field_dtypes():
    s = _run(_ll_mixed, blobs_dtype=[("a", np.float32), ("k", np.int32)])
    x, w, logl, blobs = s.posterior(return_blobs=True)
    assert blobs["k"].dtype == np.int32 and np.all(blobs["k"] == 3)


def _ll_object(x):
    return -0.5 * float(np.sum(x * x)), {"tag": round(float(x[0]), 3)}


def _object_sampler(**kw):
    return Sampler(_prior, _ll_object, n_dim=2, n_particles=16, host_likelihood=True,
                   blobs_dtype="object", random_state=0, n_max_steps=3, device="cpu", **kw)


def test_object_payloads_follow_particles():
    s = _object_sampler()
    s.run(n_total=32, progress=False)
    x, w, logl, blobs = s.posterior(return_blobs=True)
    assert blobs.dtype == object
    for xi, b in zip(x[:20], blobs[:20]):
        assert b is not None and abs(b["tag"] - round(float(xi[0]), 3)) < 5e-3
    live = set(np.concatenate([s.state.hist.blobs.numpy().ravel(),
                               s.state.cur.blobs.numpy().ravel()]).tolist())
    store = s.state.blob_schema.store
    assert all((store[i] is None) == (i not in live) for i in range(len(store)))


def test_object_store_checkpoint_roundtrip(tmp_path):
    s = _object_sampler()
    s.run(n_total=32, progress=False)
    path = tmp_path / "obj.state"
    s.save_state(path)
    s2 = _object_sampler()
    s2.load_state(path)
    x, w, logl, blobs = s2.posterior(return_blobs=True)
    assert blobs.dtype == object and blobs[0] is not None
    assert list(blobs) == list(s.posterior(return_blobs=True)[3])
