"""A host likelihood on the fused route and the device run loop of
tempest_tpu_torch, against tempest_tpu on the CPU.

A host likelihood (`host_likelihood=True`) crosses to the host through
`utils.wrappers.HostLikelihood`: on the CPU one counted read of the points
and the step's `active` flag a sweep (`Loops.fetch("likelihood", ...)`), the
host-call kernel's plain version. Inputs are made by numpy from a seed.

1. One fused iteration fed JAX's draws: tests/test_torch_slice.py's
   unclustered 4-D problem (N = 128) with its likelihood as a per-point
   numpy function, through JAX's fused iteration (`jax.pure_callback` on
   the CPU) and the port's, at the tolerances of tests/test_torch_slice.py
   :10-11 and :117-135: beta and logZ 1e-5, particles and logl atol 1e-4
   (logl rtol 1e-5), the MIS sums atol 1e-4.
2. `run(on_device=True)` (the run loop, on the CPU a Python loop) equals
   `run(on_device=False)` and the eager iteration (a read after every
   body) bit for bit, clustered and unclustered.
3. Exactly once: a counting pool's map calls equal the run's likelihood
   sweeps on both routes, with chunks of MCMC steps that ran past the stop
   (which call nothing); a stretch's device-decided iteration calls the
   likelihood only in the bodies it takes.
4. Object blobs on the fused route, as tests/test_blobs.py:140-170: the
   payloads follow their particles with run(on_device=True), a checkpoint
   round-trips, and the store is pruned.
5. A likelihood that raises in a later iteration raises its own exception
   from run(on_device=True); `reset()` then gives the clean run's bits.
6. JAX's run(on_device=True) of the host Gaussian of
   tests/test_sampler.py:182-191 and the port's both land within 0.5 of the
   analytic logZ.
7. No loop body reads the host but through the crossing: a whole fused
   iteration of a host likelihood with `Tensor.__bool__`, `.item()`,
   `.tolist()`, `__int__`, `__float__` and `.numpy()` raising everywhere
   but in the crossing's counted read.
"""

import math

import jax
import numpy as np
import pytest
import torch
from test_torch_clustered_slice import D, N, NORM, SEP, SIGMA, _prior
from test_torch_fused import eager_route, fused_iteration
from test_torch_slice import JaxIterationDraws

from tempest_tpu import Sampler as JaxSampler
from tempest_tpu_torch import Sampler, interop
from tempest_tpu_torch.cluster import single_cluster_model
from tempest_tpu_torch.config import SamplerConfig
from tempest_tpu_torch.fused import CHUNKS, make_fused_iteration
from tempest_tpu_torch.loops import Loops
from tempest_tpu_torch.utils.wrappers import HostLikelihood, make_pool_map

torch.set_num_threads(1)


def _bimodal_np(x):
    """tests/test_torch_clustered_slice.py's bimodal likelihood of one numpy point."""
    a = NORM - 0.5 * np.sum((x - SEP) ** 2) / SIGMA**2
    b = NORM - 0.5 * np.sum((x + SEP) ** 2) / SIGMA**2
    return float(np.logaddexp(a, b) - math.log(2.0))


class CountingPool:
    """A host pool that maps in this thread and counts its map calls."""

    def __init__(self):
        self.calls = 0

    def map(self, f, xs):
        self.calls += 1
        return [f(x) for x in xs]


def _gauss_half_np(x):
    """tests/test_torch_slice.py's likelihood, -|x|^2 / 2, of one numpy point."""
    return float(-0.5 * np.sum(x * x))


def test_one_fused_iteration_matches_jax():
    """tests/test_torch_slice.py's unclustered 4-D iteration (N = 128), its
    likelihood on the host: JAX's fused iteration with `pure_callback` past
    its warm-up, then the port's fused iteration on the same state and the
    JAX iteration's own draws."""
    js = JaxSampler(_prior, _gauss_half_np, n_dim=D, n_particles=N, host_likelihood=True,
                    clustering=False, random_state=0, history_capacity=16)
    core = js.state
    while js.state.cur.beta == 0.0 or int(core.hist.t) < 5:
        js.sample()
    fields_h = {k: np.array(getattr(core.hist, k)) for k in interop.HISTORY_FIELDS + ("t",)}
    fields_c = {k: np.array(getattr(core.cur, k))
                for k in interop.CURRENT_FIELDS + interop.CURRENT_COUNTERS}
    it_key = jax.random.split(core.key)[1]  # what core._next_key() hands the iteration
    out_j = js.sample()

    cfg = SamplerConfig(prior_transform=_prior, log_likelihood=_gauss_half_np, n_dim=D,
                        n_particles=N, vectorize=True, host_likelihood=True, clustering=False,
                        device="cpu")
    pool = CountingPool()
    crossing = HostLikelihood(_gauss_half_np, make_pool_map(pool), torch.float32)
    iteration = make_fused_iteration(cfg, crossing, _prior)
    assert crossing.loops is iteration.loops
    th = interop.history_from_numpy(fields_h, "cpu")
    tc_ = interop.current_from_numpy(fields_c, "cpu")
    th, tc_, _ = iteration(JaxIterationDraws(it_key), th, tc_, single_cluster_model(D, 1))

    assert th.t == int(core.hist.t) and tc_.iteration == out_j["iter"]
    assert abs(float(tc_.beta) - out_j["beta"]) < 1e-5
    assert abs(float(tc_.logz) - out_j["logz"]) < 1e-5
    assert tc_.steps == out_j["steps"] and tc_.calls * N == out_j["calls"]
    np.testing.assert_allclose(tc_.u.numpy(), out_j["u"], atol=1e-4)
    np.testing.assert_allclose(tc_.logl.numpy(), out_j["logl"], atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(float(tc_.acceptance), out_j["acceptance"], atol=1e-4)
    np.testing.assert_allclose(th.mis_c.numpy(), np.asarray(core.hist.mis_c), atol=1e-4,
                               rtol=1e-5)
    # one call a real step; the chunks' steps past the stop read and call nothing
    stats = iteration.loops.stats
    assert pool.calls == int(tc_.steps)
    assert stats["likelihood"]["reads"] == stats["mcmc"]["bodies"]


def _sampler(clustering, seed=3, likelihood=_bimodal_np, pool=None, n_dim=D, **extra):
    return Sampler(_prior, likelihood, n_dim=n_dim, n_particles=N, vectorize=True,
                   host_likelihood=True, k_max=4, clustering=clustering, random_state=seed,
                   history_capacity=32, device="cpu", pool=pool, **extra)


def _sweeps(s) -> int:
    """The likelihood sweeps of sampler (or core) `s`'s run."""
    return int(getattr(s, "state", s).cur.calls)


@pytest.mark.parametrize("clustering", [True, False])
def test_run_on_device_equals_host_loop(clustering):
    """The run loop, the fused route's host loop and the eager iteration
    give the same bits; the pool maps once a sweep on each, chunks past
    the stop included."""
    runs, pools = [], []
    for route in ("on_device=True", "on_device=False", "eager"):
        pool = CountingPool()
        s = _sampler(clustering, pool=pool)
        if route == "eager":
            eager_route(s)
        assert fused_iteration(s) == (route != "eager")
        s.run(n_total=512, progress=False, on_device=route == "on_device=True")
        runs.append(s)
        pools.append(pool)
    results = [s.results() for s in runs]
    for r in results[1:]:
        for name in ("beta", "logz", "ess", "steps", "calls", "logl"):
            assert r[name].tobytes() == results[0][name].tobytes(), name
    assert len({s.evidence()[0] for s in runs}) == 1 and runs[0].beta == 1.0
    assert abs(runs[0].evidence()[0] - (-D * np.log(20.0))) < 0.6
    for s, pool in zip(runs, pools):
        assert pool.calls == _sweeps(s) > 0
    fused = runs[0].state._iteration.loops.stats
    assert fused["run"]["bodies"] > 0  # the run loop's iterations (after the first)
    if not clustering:  # its chunks ran past the stop, and called nothing there
        assert fused["mcmc"]["past_stop"] > 0
    assert fused["likelihood"]["reads"] == fused["mcmc"]["bodies"] + (
        runs[0].results()["beta"] == 0).sum()


def test_stretch_calls_only_taken_bodies():
    """Each iteration of a run on keyed draws, taken once with the host's
    decisions and once inside `loops.stretch()`, where every conditional
    body runs and `torch.where` selects (tests/test_torch_fused_run.py's
    device-decided iteration): the same bits, and the likelihood called
    only in the bodies taken (the crossing ANDs the warm-up's guards), once
    a real sweep."""
    from test_torch_fused_run import KeyedDraws, device_words, host_words

    pools = [CountingPool(), CountingPool()]
    samplers = [_sampler(True, seed=5, pool=p) for p in pools]
    for s in samplers:
        s.state.draws = KeyedDraws(5, "cpu")
    host, dev = (s.state for s in samplers)
    dev._iteration.loops.counters = [dev.draws.calls]
    host.execute_iteration()  # t = 0, on the host
    dev.execute_iteration()
    for _ in range(6):
        host.execute_iteration()
        device_words(dev)
        with dev._iteration.loops.stretch():
            dev.hist, dev.cur, dev.cluster_model = dev._iteration(
                dev.draws, dev.hist, dev.cur, dev.cluster_model)
        host_words(dev)
        r_h, r_d = host.compute_results(), dev.compute_results()
        for name in ("beta", "logz", "steps", "calls", "u", "logl"):
            assert r_h[name].tobytes() == r_d[name].tobytes(), name
        assert pools[0].calls == pools[1].calls == _sweeps(host)
    assert host.compute_results()["beta"][-1] > 0.0


def _ll_object(x):
    return -0.5 * float(np.sum(x * x)), {"tag": round(float(x[0]), 3)}


def _object_sampler(**kw):
    return Sampler(lambda u: 10.0 * u - 5.0, _ll_object, n_dim=2, n_particles=16,
                   host_likelihood=True, blobs_dtype="object", random_state=0, n_max_steps=3,
                   device="cpu", **kw)


def test_object_blobs_on_the_run_loop(tmp_path):
    s = _object_sampler()
    assert fused_iteration(s)
    s.run(n_total=32, progress=False, on_device=True)
    x, w, logl, blobs = s.posterior(return_blobs=True)
    assert blobs.dtype == object and len(blobs) > 0
    for xi, b in zip(x, blobs):  # every payload follows its particle
        assert b is not None and abs(b["tag"] - round(float(xi[0]), 3)) < 5e-3
    # the store is pruned: the ids of rejected proposals hold None
    store = s.state.blob_schema.store
    live = {int(i) for i in s.state.hist.blobs.reshape(-1).tolist() if i >= 0}
    live |= {int(i) for i in s.state.cur.blobs.reshape(-1).tolist()}
    assert len(store) == _sweeps(s) * 16
    assert all((p is not None) == (i in live) for i, p in enumerate(store))
    assert sum(p is None for p in store) > 0
    path = tmp_path / "obj.state"
    s.save_state(path)
    s2 = _object_sampler()
    s2.load_state(path)
    x2, _, _, blobs2 = s2.posterior(return_blobs=True)
    assert np.array_equal(x2, x) and list(blobs2) == list(blobs)


class Flaky:
    """A likelihood that raises `Boom` from its `fail_at`-th call on, until
    `fail_at` is set to None."""

    def __init__(self, fail_at):
        self.fail_at, self.calls = fail_at, 0

    def __call__(self, x):
        self.calls += 1
        if self.fail_at is not None and self.calls >= self.fail_at:
            raise Boom(f"likelihood call {self.calls}")
        return _bimodal_np(x)


class Boom(RuntimeError):
    pass


def test_raising_likelihood_raises_and_reset_recovers():
    clean = _sampler(False, seed=7)
    clean.run(n_total=512, progress=False, on_device=True)
    sweeps = _sweeps(clean)
    flaky = Flaky(fail_at=N * (sweeps // 2) + 5)  # mid-sweep, in a later iteration
    s = _sampler(False, seed=7, likelihood=flaky)
    with pytest.raises(Boom, match="likelihood call"):
        s.run(n_total=512, progress=False, on_device=True)
    assert flaky.calls == flaky.fail_at  # nothing called after the failure
    flaky.fail_at = None
    s.reset(random_state=7)
    s.run(n_total=512, progress=False, on_device=True)
    for name in ("beta", "logz", "steps", "calls"):
        assert s.results()[name].tobytes() == clean.results()[name].tobytes(), name


HALF_WIDTH = 5.0  # tests/test_sampler.py's U(-5, 5)^2 prior


def _gauss_np(x):
    return float(-0.5 * np.sum(x**2) - 0.5 * 2 * np.log(2 * np.pi))


def test_run_on_device_lands_where_jax_does():
    def prior(u):
        return -HALF_WIDTH + 2 * HALF_WIDTH * u

    truth = -2 * np.log(2 * HALF_WIDTH)
    js = JaxSampler(prior, _gauss_np, n_dim=2, n_particles=128, host_likelihood=True,
                    clustering=False, random_state=0)
    js.run(n_total=512, progress=False, on_device=True)
    pool = CountingPool()
    ts = Sampler(prior, _gauss_np, n_dim=2, n_particles=128, vectorize=True,
                 host_likelihood=True, clustering=False, random_state=0, device="cpu", pool=pool)
    ts.run(n_total=512, progress=False, on_device=True)
    assert abs(js.evidence()[0] - truth) < 0.5
    assert abs(ts.evidence()[0] - truth) < 0.5
    assert ts.state._iteration.loops.stats["run"]["bodies"] > 0 and pool.calls == _sweeps(ts)


READS = ("__bool__", "item", "tolist", "__int__", "__float__", "numpy")


def test_loop_bodies_read_only_the_crossing(monkeypatch):
    """Every loop body and stretch of a whole fused iteration of a host
    likelihood runs with the host reads of a tensor raising, but inside the
    crossing's one counted read a sweep."""
    pool = CountingPool()
    s = _sampler(True, seed=4, pool=pool)
    core = s.state
    while int(core.cluster_model.n_clusters()) < 2 or core.hist.t < 6:
        s.sample()
    saved = {name: getattr(torch.Tensor, name) for name in READS}

    def refuse(name):
        def read(*args, **kwargs):
            raise AssertionError(f"host read Tensor.{name} in a loop body")
        return read

    def patch(on):
        for name in READS:
            setattr(torch.Tensor, name, refuse(name) if on else saved[name])

    ran, crossings = set(), []

    def guarded(name, fn):
        def run(*args):
            ran.add(name)
            patch(True)
            try:
                return fn(*args)
            finally:
                patch(False)
        return run

    plain_start, plain_fetch = Loops.start, Loops.fetch

    def fetch(self, name, *tensors):
        if name != "likelihood":
            return plain_fetch(self, name, *tensors)
        crossings.append(name)
        patch(False)  # the crossing's own read
        try:
            return plain_fetch(self, name, *tensors)
        finally:
            patch(True)

    monkeypatch.setattr(Loops, "start", lambda self, name, body, *a, **k: plain_start(
        self, name, guarded(name, body), *a, **k))
    monkeypatch.setattr(Loops, "fetch", fetch)
    calls, steps_before = pool.calls, _sweeps(s)
    try:
        core.hist, core.cur, core.cluster_model = core._iteration(
            core.draws, core.hist, core.cur, core.cluster_model)
    finally:
        patch(False)
    assert {"mode_em", "gmm_em", "mcmc"} <= ran, ran
    stats = core._iteration.loops.stats
    assert pool.calls - calls == _sweeps(s) - steps_before > 0
    assert len(crossings) >= pool.calls - calls
    with pytest.raises(AssertionError, match="host read"):
        guarded("check", lambda: torch.ones(2).numpy())()
    assert stats["likelihood"]["reads"] > 0 and CHUNKS["mcmc"] > 1


# ---------------------------------------------------------------------------
# The host side of the host-call kernel (ops/cuda_host.py) on numpy alone:
# the points a host function gets, and the serving loop's answers.
# ---------------------------------------------------------------------------
from tempest_tpu_torch.ops import cuda_host  # noqa: E402


def _host_box(n, d, fn, width=0):
    """A `cuda_host.Mailbox` over plain numpy memory (no device): the host
    side of the mailbox, served by hand."""
    box = object.__new__(cuda_host.Mailbox)
    raw = np.zeros(128 + 128 * (1 + (4 * n * d + 4 * n + 4 * n * width) // 128), np.uint8)
    box.fn, box.error, box.host_stamps = fn, None, []
    box.header = raw[:128].view(np.uint64)
    box.status = raw[72:76].view(np.int32)
    box.x = raw[128:128 + 4 * n * d].view(np.float32).reshape(n, d)
    box.logl = raw[128 + 4 * n * d:128 + 4 * n * d + 4 * n].view(np.float32)
    box.blobs = None
    return box


def _request(box, value):
    """The device's side of a request: its points, then the next sequence
    number."""
    box.x[...] = value
    box.header[0] += 1


def test_points_kept_by_the_host_function():
    """Each request's points reach the host function read-only, and a point
    it keeps does not change when the next request overwrites the mailbox."""
    kept = []

    def fn(points):
        assert not points.flags.writeable
        kept.extend(points)
        return np.zeros(len(points), np.float32), None

    box = _host_box(3, 2, fn)
    for value in (1.0, 2.0):
        _request(box, value)
        assert box.pending()
        box.serve()
        assert not box.pending() and box.status[0] == 0
    assert np.array_equal(np.stack(kept), np.repeat([1.0, 2.0], 3)[:, None] * np.ones(2))


def test_serving_loop_answers_and_aborts():
    """`serve_until_done`: each pending request is answered (logl, the
    status, the reply sequence); after a host function raises, its box
    answers every later request with the abort status and no call; an
    interrupt while polling answers every box's later requests so and is
    returned; the loop ends when `finished()` holds on a turn with no
    request pending."""
    calls = []

    def fn(points):
        calls.append(points.copy())
        if len(calls) == 2:
            raise ZeroDivisionError
        return np.full(len(points), float(len(calls)), np.float32), None

    boxes = [_host_box(4, 2, fn), _host_box(4, 2, fn)]
    script = iter([0, None, 1, 0, KeyboardInterrupt, 1, 0, True])

    def finished():
        k = next(script)
        if isinstance(k, type):
            raise k
        if k is None or k is True:
            return bool(k)
        _request(boxes[k], k + boxes[k].header[0] + 1)  # seen on the next turn
        return False

    stopped = cuda_host.serve_until_done(finished, boxes)
    assert isinstance(stopped, KeyboardInterrupt)
    # box 0's first two requests call fn, box 1's first raises; none after
    assert [float(c[0, 0]) for c in calls] == [1.0, 2.0, 2.0]
    assert isinstance(boxes[1].error, ZeroDivisionError)
    assert isinstance(boxes[0].error, KeyboardInterrupt)
    for box, requests in zip(boxes, (3, 2)):
        assert box.header[0] == box.header[8] == requests  # every request answered
        assert box.status[0] == cuda_host.ABORT
    assert np.all(boxes[0].logl == 3.0)  # the abort leaves the last good reply
    assert [s[0] for s in boxes[0].host_stamps] == [1, 2, 3]
