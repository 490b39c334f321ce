"""Checkpoints of the port, and files of the JAX package read by it.

1. The format-1 fixture tests/fixtures/v1_checkpoint.state loads into the
   port with the values the JAX `load_checkpoint` gives (layout moved,
   `mis_c` rebuilt to atol 1e-5, calls converted to sweeps; the rest
   exact), and resumes to beta = 1.
2. A format-2 file written by the JAX package in the test, blobs included,
   loads with its exact values and resumes in the port; the port's draws
   are re-seeded from the file's threefry key words by
   `draws.seed_from_key_words`.
3. The port's own round trips are exact on the CPU: the iterations after
   a save equal, bit for bit, those of a sampler that loaded the file
   (with `Draws` and with `HardwareDraws`, with the cluster model carried
   by `cluster_every=3`), and those of an unpickled copy.
4. `save_every` writes its files, and a pickle taken mid-run finishes.
"""

import math
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempest_tpu import Sampler as JaxSampler
from tempest_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from tempest_tpu_torch import Sampler, interop
from tempest_tpu_torch.draws import Draws, HardwareDraws, seed_from_key_words
from tempest_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "v1_checkpoint.state")
ANALYTIC_3D = 1.5 * math.log(2 * math.pi) - 3 * math.log(20.0)  # -0.5|x|^2 on U(-10, 10)^3


def _prior(u):
    return -10.0 + 20.0 * u


def _loglike_t(x):
    return -0.5 * torch.sum(x * x, dim=-1)


def _loglike_j(x):
    return -0.5 * jnp.sum(x * x, axis=-1)


def _fixture_sampler(**kw):
    # The configuration the fixture was written with (tests/test_checkpoint_compat.py).
    return Sampler(_prior, _loglike_t, n_dim=3, n_particles=32, vectorize=True,
                   clustering=False, random_state=7, history_capacity=24, device="cpu", **kw)


def _assert_state_equal(hist_t, cur_t, hist_j, cur_j, mis_c_atol=0.0):
    for k in interop.HISTORY_FIELDS:
        want = np.asarray(getattr(hist_j, k))
        got = getattr(hist_t, k).numpy()
        if k == "mis_c":
            valid = np.isfinite(want)
            np.testing.assert_array_equal(np.isfinite(got), valid)
            np.testing.assert_allclose(got[valid], want[valid], atol=mis_c_atol, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    assert hist_t.t == int(hist_j.t)
    for k in interop.CURRENT_FIELDS:
        np.testing.assert_array_equal(getattr(cur_t, k).numpy(), np.asarray(getattr(cur_j, k)),
                                      err_msg=k)
    for k in interop.CURRENT_COUNTERS:
        assert getattr(cur_t, k) == int(getattr(cur_j, k)), k


def test_v1_fixture_loads_like_jax():
    hist_j, cur_j, key_j, meta_j, store_j = jax_load_checkpoint(FIXTURE)
    ck = load_checkpoint(FIXTURE, "cpu")
    assert ck.hist.u.shape == (3, 24, 32) and ck.hist.t == 6
    _assert_state_equal(ck.hist, ck.cur, hist_j, cur_j, mis_c_atol=1e-5)
    assert ck.meta == meta_j and ck.blob_store is None and store_j is None
    assert ck.draws is None and ck.model is None
    np.testing.assert_array_equal(ck.rng_key, np.asarray(key_j))


def test_v1_fixture_resumes():
    s = _fixture_sampler()
    s.run(n_total=128, progress=False, resume_state_path=FIXTURE)
    assert s.beta == 1.0 and math.isfinite(s.logz)
    assert s.state.hist.t > 6 and s.state.cur.iteration > 6
    key = np.asarray(jax_load_checkpoint(FIXTURE)[2])
    assert s.state.draws.generator.initial_seed() == seed_from_key_words(key)


def _blob_loglike_j(x):
    return -0.5 * jnp.sum(x * x), jnp.sum(x)


def _blob_loglike_t(x):
    return -0.5 * torch.sum(x * x), torch.sum(x)


@pytest.mark.parametrize("blobs", [False, True])
def test_jax_v2_file_loads_and_resumes(tmp_path, blobs):
    if blobs:  # per-point functions with an auto-detected blob
        kw = dict(n_dim=3, n_particles=32, clustering=False, random_state=5, history_capacity=24)
        js = JaxSampler(_prior, _blob_loglike_j, **kw)
    else:
        kw = dict(n_dim=3, n_particles=32, vectorize=True, clustering=False, random_state=5,
                  history_capacity=24)
        js = JaxSampler(_prior, _loglike_j, **kw)
    for _ in range(5):
        js.sample()
    path = tmp_path / "jax_v2.state"
    js.save_state(path)
    ck = load_checkpoint(path, "cpu")
    _assert_state_equal(ck.hist, ck.cur, js.state.hist, js.state.cur)
    if blobs:
        np.testing.assert_array_equal(ck.hist.blobs.numpy(), np.asarray(js.state.hist.blobs))
        np.testing.assert_array_equal(ck.cur.blobs.numpy(), np.asarray(js.state.cur.blobs))

    s = Sampler(_prior, _blob_loglike_t if blobs else _loglike_t, device="cpu", **kw)
    s.run(n_total=128, progress=False, resume_state_path=path)
    assert s.beta == 1.0 and s.state.hist.t > 5 and s.state.cur.iteration > 5
    assert abs(s.logz - ANALYTIC_3D) < 1.0
    if blobs:
        x, _, _, b = s.posterior(return_blobs=True)
        np.testing.assert_allclose(b, x.sum(axis=1), rtol=1e-5, atol=1e-5)


def _clustered_sampler(hardware_prng, cluster_every, **kw):
    return Sampler(_prior, _loglike_t, n_dim=3, n_particles=48, vectorize=True, k_max=4,
                   cluster_every=cluster_every, hardware_prng=hardware_prng, random_state=11,
                   history_capacity=24, device="cpu", **kw)


def _same_iterations(a, b):
    for x, y in zip(a, b):
        assert x["iter"] == y["iter"] and x["beta"] == y["beta"] and x["logz"] == y["logz"]
        np.testing.assert_array_equal(x["u"], y["u"])
        np.testing.assert_array_equal(x["logl"], y["logl"])
        np.testing.assert_array_equal(x["assignments"], y["assignments"])


@pytest.mark.parametrize("hardware_prng", [False, True])
@pytest.mark.parametrize("cluster_every", [1, 3])
def test_round_trip_continues_the_same_stream(tmp_path, hardware_prng, cluster_every):
    s = _clustered_sampler(hardware_prng, cluster_every)
    for _ in range(7):
        s.sample()
    path = tmp_path / "round.state"
    s.save_state(path)
    copy = pickle.loads(pickle.dumps(s))
    ahead = [s.sample() for _ in range(3)]
    assert ahead[-1]["beta"] > 0.0 and ahead[-1]["steps"] > 0

    loaded = _clustered_sampler(hardware_prng, cluster_every)
    loaded.load_state(path)
    assert isinstance(loaded.state.draws, HardwareDraws if hardware_prng else Draws)
    _same_iterations(ahead, [loaded.sample() for _ in range(3)])
    _same_iterations(ahead, [copy.sample() for _ in range(3)])
    if hardware_prng:
        assert loaded.state.draws.counter == s.state.draws.counter > 0


def test_save_every_writes_its_files(tmp_path):
    s = _fixture_sampler(output_dir=str(tmp_path), output_label="run")
    s.run(n_total=128, progress=False, save_every=3)
    t = s.state.cur.iteration
    files = sorted(os.listdir(tmp_path))
    assert files == sorted([f"run_{i}.state" for i in range(3, t, 3)] + ["run_final.state"])
    ck = load_checkpoint(tmp_path / "run_3.state", "cpu")
    assert ck.cur.iteration == 3 and ck.hist.t == 3 and ck.meta["n_total"] == 128
    assert set(ck.draws) == {"generator"}


def test_pickle_mid_run_finishes():
    s = _clustered_sampler(False, 1)
    for _ in range(4):
        s.sample()
    s2 = pickle.loads(pickle.dumps(s))
    assert s2.state.hist.t == 4 and s2.state.device == torch.device("cpu")
    s2.run(n_total=256, progress=False)
    assert s2.beta == 1.0 and abs(s2.evidence()[0] - ANALYTIC_3D) < 0.5


def test_draw_state_round_trip():
    for cls in (Draws, HardwareDraws):
        a = cls(3, "cpu")
        a.warmup(8, 2)
        state = a.get_state()
        b = cls(99, "cpu")
        b.set_state(state)
        torch.testing.assert_close(a.warmup(8, 2), b.warmup(8, 2), rtol=0, atol=0)
    assert seed_from_key_words(np.array([1, 2], np.uint32)) == (1 << 32) | 2
