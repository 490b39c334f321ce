"""The port's Sampler over a particle mesh, its two-process drills and its
sharded checkpoints, against tempest_tpu.

The ranks are processes on the CPU over gloo, started and read by
tests/test_torch_parallel.py's `launch` and `spawn`, each running this
file as a script (`python tests/test_torch_distributed.py <mode> <rank>
<world> <store> <workdir> [args]`) that imports no JAX; every collective
times out after 60 s and every rank is killed after 120 s.

1. tests/test_parallel.py's five cases on the port at W ranks: a run end to
   end (logZ within 0.5 of -4 log 20, beta = 1, the history local on
   N/W), the same run as `mesh=None` (the same t, the beta ladder within
   1e-3, logZ within 0.05), clustering, the divisibility error, and
   capacity growth from two slots; plus the mesh's own checks and a
   pickle taken under the mesh, which runs on as the sharded run does
   (the other paths' agreement is in tests/test_torch_parallel.py). The
   agreement holds where the sharded fit-point selection is exact:
   every rank's candidates cover its block of the history (m >= S/W), as
   on JAX's own 8-device test mesh, so `train_max_points` is raised to
   S/W at W = 2. At W = 2 the fused route (every loop in chunks, the
   sharded ESS bisection among them) repeats the eager iteration, whose
   loops read after every body, bit for bit; dynamic mode runs to beta = 1. Below that the selection skips the weight trim, JAX's
   documented deviation (tempest_tpu/parallel/collective.py:180-189); that
   run is held to the same t and logZ within 0.05, not to the ladder.
2. tests/test_distributed.py's two drills at W = 2: a clustered annealing
   whose two ranks report the identical logZ and t, then a sharded
   checkpoint (each rank writes only its half) loaded into a fresh sampler;
   and a run whose ranks are SIGKILLed after a mid-run sharded checkpoint
   and resumed by a fresh pair of processes, which must end with the t and
   the logZ of the uninterrupted run, bit for bit.
3. Sharded checkpoints across the packages: a file JAX's
   `save_checkpoint_sharded` wrote in one process on an 8-device mesh (one
   shard) loads into a W = 2 port run, value for value, and the run goes
   on to beta = 1; the drill's W = 2 port file loads in JAX's
   `load_checkpoint_sharded` on an 8-device mesh, value for value.
4. The device run loop under the mesh at W = 2 (`_w_run_loop`):
   run(on_device=True) equals on_device=False bit for bit in ESS mode,
   dynamic mode and with a history that fills; the iteration decided
   inside a stretch equals the host-decided one; the warm-up patch
   decided on the device equals the branch that read the host.
"""

import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_parallel import (
    _build,
    _exact_fit_points,
    _run_row,
    _same_on_every_rank,
    by_case,
    launch,
    report,
    spawn,
    worker_main,
)

REPO = Path(__file__).resolve().parents[1]
D = 4
ANALYTIC_LOGZ = -D * math.log(20.0)
HISTORY_LEAVES = ("u", "x", "logl", "mis_c", "beta", "logz", "ess", "cv", "acceptance",
                  "efficiency", "steps", "calls")


def _prior(u):
    return 20.0 * u - 10.0


def _fused(s) -> bool:
    """Whether sampler `s` runs the fused iteration (its loops in chunks)."""
    from tempest_tpu_torch.fused import CHUNKS

    return s.state._iteration.loops.chunks == CHUNKS


def _w_sampler(mesh, rank, world, workdir, cases):
    import pickle

    from tempest_tpu_torch.parallel import make_particle_mesh

    cases = cases.split(",")
    if "e2e" in cases:
        s = _build(mesh, 11)
        s.run(n_total=512, progress=False)
        x, w, _ = s.posterior()
        res = s.results()
        report({"case": "e2e", **_run_row(s), "evidence": s.evidence()[0],
                "posterior": [len(x), float(np.average(x[:, 0], weights=w))],
                "results_u": list(res["u"].shape), "logz_err": s.evidence(n_bootstrap=64)[1]})
    if "agree" in cases:
        s = _build(mesh, 5, train_max_points=_exact_fit_points(world))
        s.run(n_total=512, progress=False)
        report({"case": "agree", **_run_row(s)})
    if "agree_candidates" in cases:
        s = _build(mesh, 5)
        s.run(n_total=512, progress=False)
        report({"case": "agree_candidates", **_run_row(s)})
    if "clustering" in cases:
        s = _build(mesh, 2, clustering=True)
        s.run(n_total=512, progress=False)
        report({"case": "clustering", **_run_row(s),
                "clusters": int(s.state.cluster_model.n_clusters())})
    if "divisible" in cases:
        try:
            _build(mesh, 0, n_particles=101)
            report({"case": "divisible", "error": None})
        except ValueError as e:
            report({"case": "divisible", "error": str(e)})
    if "growth" in cases:
        s = _build(mesh, 0, n_particles=64, history_capacity=2)
        s.run(n_total=256, progress=False)
        report({"case": "growth", **_run_row(s)})
    if "checks" in cases:
        errors = []
        for bad in (lambda: make_particle_mesh(n_devices=world + 1, device="cpu"),
                    lambda: _build(mesh, 0, device="cuda")):
            try:
                bad()
                errors.append(None)
            except ValueError as e:
                errors.append(str(e))
        report({"case": "checks", "errors": errors})
    if "fused" in cases:
        # The fused route (loops in chunks) against the eager iteration,
        # whose loops read after every body: one run, bit for bit.
        from tempest_tpu_torch.iteration import make_iteration

        rows = []
        for fused in (True, False):
            s = _build(mesh, 3, clustering=True)
            if not fused:  # the eager iteration, the draws' counter kept
                core, counters = s.state, s.state._iteration.loops.counters
                core._iteration = make_iteration(core.config, core._loglike_batch,
                                                 core._prior_batch)
                core._iteration.loops.counters, core._run = counters, None
            s.run(n_total=512, progress=False)
            res = s.results()
            rows.append({"fused": _fused(s), "logz": s.logz, "t": s.state.hist.count(),
                         **{f"{k}_bits": res[k].tobytes().hex() for k in ("beta", "logz", "steps")},
                         "reads": dict(s.state._iteration.loops.stats["ess_sharded"])})
        report({"case": "fused", "runs": rows})
    if "dynamic" in cases:
        s = _build(mesh, 4, volume_variation=1.0)
        s.run(n_total=512, progress=False)
        report({"case": "dynamic", **_run_row(s), "fused": _fused(s),
                "cv_reads": s.state._iteration.loops.stats["ess_bracket"]["reads"]})
    if "pickle" in cases:
        s = _build(mesh, 5, clustering=True)
        for _ in range(8):
            s.sample()
        alone = pickle.loads(pickle.dumps(s))  # gathers; then one device, no mesh
        rows = [(s.sample(), alone.sample()) for _ in range(2)]
        report({"case": "pickle", "mesh": alone.state.config.mesh is None,
                "alone_n": alone.state.hist.u.shape[2],
                "rows": [[a["beta"], b["beta"], a["logz"], b["logz"]] for a, b in rows],
                "u": float(np.max(np.abs(rows[-1][0]["u"] - rows[-1][1]["u"])))})




def _digest(a) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


BISECTIONS = ("ess_sharded", "ess_bracket", "cv_bisect")
RUN_LOOP_CASES = {"ess": {}, "dynamic": {"volume_variation": 0.05},
                  "growth": {"history_capacity": 2}}


def _old_sharded_patch(u, x, logl, blobs, inf_mask, patch_uniforms, group):
    """The mesh's patch as it was, deciding on the host whether to patch."""
    from tempest_tpu_torch.ops.tools import _psum
    from tempest_tpu_torch.parallel.collective import gather_rows

    dtype = u.dtype
    n_global = patch_uniforms.shape[0]
    n_finite = _psum(torch.sum(~inf_mask), group)
    any_inf = n_finite < n_global
    if bool(any_inf & (n_finite > 0)):
        p = torch.where(inf_mask, torch.zeros_like(logl), torch.ones_like(logl))
        p = p / n_finite.to(dtype)
        arrays = [u.T[:, None], x.T[:, None], logl[None, None], blobs.T[:, None]]
        rows = gather_rows(patch_uniforms, p[None], arrays, group)
        u = torch.where(inf_mask[:, None], rows[0], u)
        x = torch.where(inf_mask[:, None], rows[1], x)
        logl = torch.where(inf_mask, rows[2][:, 0], logl)
        blobs = torch.where(inf_mask[:, None], rows[3], blobs)
    frac = n_finite.to(dtype) / n_global
    return u, x, logl, blobs, torch.where(any_inf, torch.log(frac), torch.zeros((), dtype=dtype))


def _w_run_loop(mesh, rank, world, workdir):
    """run(on_device=True) under the mesh against on_device=False (each
    RUN_LOOP_CASES row); the iteration with its decisions inside a stretch
    against the host's; the patch without a host read against the old
    branch."""
    from tempest_tpu_torch.parallel.mesh import particle_group
    from tempest_tpu_torch.steps import reweight as rw_mod
    from tempest_tpu_torch.steps.mutate import _sharded_patch

    for name, kw in RUN_LOOP_CASES.items():
        runs = []
        for on_device in (False, True):
            s = _build(mesh, 6, **kw)
            before = dict(rw_mod.PROBES)
            s.run(n_total=512, progress=False, on_device=on_device)
            res, stats = s.results(), s.state._iteration.loops.stats
            runs.append({"route": _fused(s), "logz": s.logz, "beta": s.beta,
                         "t": s.state.hist.count(), "capacity": s.state.hist.capacity,
                         "local_n": s.state.hist.u.shape[2],
                         "run_reads": stats["run"]["reads"] if "run" in stats else 0,
                         "cv_bodies": stats["cv_bisect"]["bodies"],
                         "probes": {k: rw_mod.PROBES[k] - before[k] for k in before},
                         **{f"bits_{k}": _digest(res[k]) for k in (
                             "beta", "logz", "steps", "calls", "u", "logl", "ess", "cv")}})
        report({"case": f"run_loop_{name}", "runs": runs})

    from tempest_tpu_torch.draws import BlockDraws, Draws

    class KeyedDraws(Draws):
        KEYED_ON_CPU = True

    def device_words(core):  # as the run loop carries them (tests/test_torch_fused_run.py)
        core.cur.iteration = torch.tensor(core.cur.iteration, dtype=torch.int64)
        core.cur.steps = torch.as_tensor(core.cur.steps, dtype=torch.int32)
        core.cur.calls = torch.as_tensor(core.cur.calls, dtype=torch.int32)
        core.cluster_model.fitted = torch.tensor(bool(core.cluster_model.fitted))
        core.hist.t_host = None

    def host_words(core):
        core.cur.iteration = int(core.cur.iteration)
        core.cluster_model.fitted = bool(core.cluster_model.fitted)
        core.hist.t_host = int(core.hist.t)

    # float64 on keyed float64 draws (the card's stream, on the `_f64`
    # kernels' plain versions): the run loop against on_device=False
    runs = []
    for on_device in (False, True):
        s = _build(mesh, 6, dtype=torch.float64)
        s.state.draws = BlockDraws(KeyedDraws(6, "cpu", torch.float64), rank, world)
        s.state._iteration.loops.counters = [s.state.draws.calls]
        s.run(n_total=512, progress=False, on_device=on_device)
        res, stats = s.results(), s.state._iteration.loops.stats
        runs.append({"route": _fused(s), "logz": s.logz, "beta": s.beta,
                     "dtype": str(res["u"].dtype), "counter": s.state.draws.calls.counter,
                     "run_reads": stats["run"]["reads"] if "run" in stats else 0,
                     **{f"bits_{k}": _digest(res[k]) for k in (
                         "beta", "logz", "steps", "calls", "u", "logl", "ess")}})
    report({"case": "run_loop_float64", "runs": runs})

    for name, kw in (("ess", {}), ("dynamic", {"volume_variation": 0.05})):
        host, dev = (_build(mesh, 8, **kw).state for _ in range(2))
        for core in (host, dev):  # keyed: a draw in an untaken branch counts nothing
            core.draws = BlockDraws(KeyedDraws(8, "cpu"), rank, world)
        dev._iteration.loops.counters = [dev.draws.calls]
        host.execute_iteration()
        dev.execute_iteration()
        same = []
        for _ in range(6):
            host.execute_iteration()
            device_words(dev)
            with dev._iteration.loops.stretch():
                dev.hist, dev.cur, dev.cluster_model = dev._iteration(
                    dev.draws, dev.hist, dev.cur, dev.cluster_model)
            host_words(dev)
            same.append(all(torch.equal(getattr(host.hist, f), getattr(dev.hist, f))
                            for f in ("u", "x", "logl", "mis_c", "beta", "logz", "ess", "cv")))
        stats = dev._iteration.loops.stats
        report({"case": f"decisions_{name}", "same": same,
                "beta": float(dev.hist.beta[dev.hist.count() - 1]),
                "chunks": sum(stats[k].get("chunks", 0) for k in BISECTIONS),
                "bodies": sum(stats[k].get("bodies", 0) for k in BISECTIONS)})

    group = particle_group(mesh, "particles")
    rng = np.random.default_rng(3)
    n_loc, d = 8, 3
    rows = {}
    for name, n_inf in (("some_inf", 5), ("none_inf", 0), ("all_inf", 8 * world)):
        u = rng.uniform(size=(8 * world, d)).astype(np.float32)
        logl = rng.normal(size=8 * world).astype(np.float32)
        logl[rng.choice(8 * world, n_inf, replace=False)] = -np.inf
        blobs = rng.normal(size=(8 * world, 2)).astype(np.float32)
        patch = torch.from_numpy(rng.uniform(size=8 * world).astype(np.float32))
        mine = slice(rank * n_loc, (rank + 1) * n_loc)
        args = (torch.from_numpy(u[mine]), torch.from_numpy(2.0 * u[mine]),
                torch.from_numpy(logl[mine]), torch.from_numpy(blobs[mine]))
        inf_mask = torch.isinf(args[2])
        got = _sharded_patch(*args, inf_mask, patch, group)
        want = _old_sharded_patch(*args, inf_mask, patch, group)
        patched = torch.sum(got.logl != args[2]).reshape(1)
        torch.distributed.all_reduce(patched, group=group)
        rows[name] = {"equal": all(torch.equal(a, b) for a, b in zip(
                          (got.u, got.x, got.logl, got.blobs, got.logz_correction), want)),
                      "patched": int(patched[0]),
                      "finite": bool(torch.all(torch.isfinite(got.logl))),
                      "logz_correction": float(got.logz_correction)}
    report({"case": "patch", "rows": rows})


def _drill_sampler(mesh, seed):
    """tests/distributed_worker.py's sampler. The capacity is pinned, so the
    full, interrupted and resumed runs hold buffers of one shape."""
    return _build(mesh, seed, clustering=True, history_capacity=64)


def _gathered(s, path, rank):
    """The global history of sampler `s`, gathered over its mesh (every rank
    calls this), written to `path` by rank 0."""
    from tempest_tpu_torch import interop

    fields = interop.history_to_numpy(s.state.hist, s.state.group)
    if rank == 0:
        np.savez(path, **{k: fields[k] for k in HISTORY_LEAVES + ("t",)})


def _w_anneal(mesh, rank, world, workdir):
    s = _drill_sampler(mesh, 7)
    s.run(n_total=512, progress=False)
    ckpt = workdir / "mp.state"
    s.save_state(ckpt)
    shard = np.load(ckpt / f"shard_{rank}" / "hist.u.npy", mmap_mode="r")
    _gathered(s, workdir / "mp_state.npz", rank)
    # A fresh sampler of another seed takes the whole run from the file.
    s2 = _build(mesh, 0, clustering=True)
    s2.load_state(ckpt)
    x, w, _ = s2.posterior()
    # tempest_tpu's own sharded file: the run continues from it to the end.
    s3 = _build(mesh, 123)
    s3.load_state(workdir / "jax.state")
    _gathered(s3, workdir / "jax_loaded.npz", rank)
    loaded_t = s3.state.hist.count()
    s3.run(n_total=512, progress=False)
    report({"logz": round(s.logz, 10), "t": s.state.hist.count(), "beta": s.beta,
            "shard_shape": list(shard.shape), "global_shape": [D, 64, 256],
            "is_dir": ckpt.is_dir(), "loaded_t": s2.state.hist.count(), "loaded_logz": s2.logz,
            "loaded_local_n": s2.state.hist.u.shape[2],
            "mean0": float(np.average(x[:, 0], weights=w)),
            "jax_loaded_t": loaded_t, "jax_run_beta": s3.beta, "jax_run_logz": s3.logz})


def _w_teardown(mesh, rank, world, workdir):
    """A sampler on the mesh, left in a reference cycle; reports the
    DeviceMeshes still alive when the worker destroys the group."""
    import gc

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    s = _build(mesh, 1)
    for _ in range(3):
        s.sample()
    s.cycle = s
    destroy = dist.destroy_process_group

    def counted():
        report({"live_meshes": sum(isinstance(o, DeviceMesh) for o in gc.get_objects())})
        destroy()

    dist.destroy_process_group = counted


def _w_drill(mesh, rank, world, workdir, mode):
    ckpt = workdir / "mid.state"
    if mode == "interrupt":
        # Save at t = 6, signal through a flag file, and sample on until the
        # parent kills this process.
        s = _drill_sampler(mesh, 7)
        for _ in range(100):
            s.sample()
            if s.state.hist.t == 6:
                s.save_state(ckpt)
                (workdir / f"saved_{rank}.flag").touch()
        return
    s = _drill_sampler(mesh, 123 if mode == "resume" else 7)  # state from the file
    s.run(n_total=512, progress=False, resume_state_path=ckpt if mode == "resume" else None)
    x, w, _ = s.posterior()
    report({"beta": s.beta, "logz": round(s.logz, 10), "t": s.state.hist.count(),
            "mean0": float(np.average(x[:, 0], weights=w))})


@pytest.fixture(scope="module")
def sampler_runs(tmp_path_factory):
    """world -> {case: [each rank's row]}: the W = 2 ranks run every case,
    the W = 4 ones the end-to-end run and the agreement."""
    cases = {2: "e2e,agree,agree_candidates,clustering,divisible,growth,checks,pickle,fused,"
                "dynamic",
             4: "e2e,agree"}
    runs = {}

    def get(world):
        if world not in runs:
            runs[world] = by_case(spawn(__file__, "sampler", world,
                                        tmp_path_factory.mktemp(f"s{world}"), cases[world]))
        return runs[world]

    return get


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_run_end_to_end(sampler_runs, world):
    r = _same_on_every_rank(sampler_runs(world)["e2e"])
    assert abs(r["logz"] - ANALYTIC_LOGZ) < 0.5 and r["evidence"] == r["logz"]
    assert r["beta"] == 1.0
    # The history stayed sharded: each rank holds N / W particles.
    assert r["local_n"] == r["local_logl"] == r["local_cur"] == 256 // world
    # posterior() and results() gather the whole run on every rank.
    assert r["results_u"] == [r["t"], 256, D] and r["posterior"][0] > 256
    assert abs(r["posterior"][1]) < 0.5 and 0.0 < r["logz_err"] < 0.5


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_matches_single_device(sampler_runs, world):
    r = _same_on_every_rank(sampler_runs(world)["agree"])
    s1 = _build(None, 5, train_max_points=_exact_fit_points(world))
    s1.run(n_total=512, progress=False)
    assert r["capacity"] * 256 // world <= _exact_fit_points(world)  # the exact selection
    assert abs(s1.logz - r["logz"]) < 0.05
    assert s1.state.hist.t == r["t"]
    np.testing.assert_allclose(s1.state.hist.beta[: r["t"]].numpy(), r["betas"], atol=1e-3)


def test_mesh_without_the_trim_stays_close(sampler_runs):
    """At W = 2 with the default train_max_points each rank's top-m does not
    cover its block, and the sharded selection skips the weight trim, as
    JAX's does: the run keeps the ladder's length and logZ."""
    r = _same_on_every_rank(sampler_runs(2)["agree_candidates"])
    assert r["capacity"] * 256 // 2 > 4096  # the candidate branch
    s1 = _build(None, 5)
    s1.run(n_total=512, progress=False)
    assert r["beta"] == 1.0 and s1.state.hist.t == r["t"]
    assert abs(s1.logz - r["logz"]) < 0.05


def test_mesh_with_clustering(sampler_runs):
    r = _same_on_every_rank(sampler_runs(2)["clustering"])
    assert r["beta"] == 1.0
    assert abs(r["logz"] - ANALYTIC_LOGZ) < 0.5


def test_mesh_divisibility_validated(sampler_runs):
    r = _same_on_every_rank(sampler_runs(2)["divisible"])
    assert r["error"] is not None and "divisible" in r["error"]


def test_capacity_growth_preserves_sharding(sampler_runs):
    r = _same_on_every_rank(sampler_runs(2)["growth"])
    assert r["t"] > 2 and r["capacity"] > 2  # growth happened
    assert r["local_n"] == r["local_cur"] == 32
    assert abs(r["logz"] - ANALYTIC_LOGZ) < 0.5


def test_mesh_checks(sampler_runs):
    r = _same_on_every_rank(sampler_runs(2)["checks"])
    assert "world size" in r["errors"][0]
    assert "device type" in r["errors"][1]


def test_pickle_under_mesh_runs_on_one_device(sampler_runs):
    """Pickling gathers the blocks and drops the mesh; the unpickled sampler
    runs on alone, on the same draws, as the sharded one does."""
    r = _same_on_every_rank(sampler_runs(2)["pickle"])
    assert r["mesh"] and r["alone_n"] == 256
    for beta_s, beta_a, logz_s, logz_a in r["rows"]:
        assert abs(beta_s - beta_a) <= 1e-5 * beta_s and abs(logz_s - logz_a) < 1e-4
    assert r["u"] < 1e-3




def test_fused_mesh_run_equals_per_body_iteration(sampler_runs):
    """At W = 2 the fused route (the sharded ESS bisection, the fits and
    the MCMC steps in chunks) repeats the eager iteration bit for bit."""
    fused, eager = _same_on_every_rank(sampler_runs(2)["fused"])["runs"]
    assert fused["fused"] and not eager["fused"]
    for k in ("beta_bits", "logz_bits", "steps_bits", "t"):
        assert fused[k] == eager[k], k
    assert fused["logz"] == eager["logz"] and abs(fused["logz"] - ANALYTIC_LOGZ) < 0.5
    assert fused["reads"]["reads"] < eager["reads"]["reads"]


def test_dynamic_mode_under_the_mesh(sampler_runs):
    r = _same_on_every_rank(sampler_runs(2)["dynamic"])
    assert r["fused"] and r["beta"] == 1.0 and r["cv_reads"] > 0
    assert abs(r["logz"] - ANALYTIC_LOGZ) < 0.5


@pytest.fixture(scope="module")
def run_loop_runs(tmp_path_factory):
    """{case: [each rank's row]} of `_w_run_loop` at W = 2."""
    return by_case(spawn(__file__, "run_loop", 2, tmp_path_factory.mktemp("run_loop")))


@pytest.mark.parametrize("name", sorted(RUN_LOOP_CASES))
def test_mesh_run_loop_equals_on_device_false(run_loop_runs, name):
    """At W = 2, run(on_device=True) under the mesh takes the device run loop
    (on the CPU a Python loop reading its predicate, the run predicate's ESS
    reduced over the ranks) and equals on_device=False bit for bit (beta,
    logZ, steps, calls, u, logl, ESS, CV) with the same probes: ESS mode,
    dynamic mode (CV bisections run) and a history that fills and grows
    on each rank's block."""
    off, on = _same_on_every_rank(run_loop_runs[f"run_loop_{name}"])["runs"]
    assert off["route"] and on["route"] and on["run_reads"] > 0 and off["run_reads"] == 0
    assert on == dict(off, run_reads=on["run_reads"])
    assert on["beta"] == 1.0 and abs(on["logz"] - ANALYTIC_LOGZ) < 0.5
    assert on["local_n"] == 128
    if name == "dynamic":
        assert on["cv_bodies"] > 0 and on["probes"]["reweights"] == on["t"] - 1
    if name == "growth":
        assert on["capacity"] > 2 and on["t"] > 2


def test_mesh_float64_run_loop_equals_on_device_false(run_loop_runs):
    """At W = 2 in float64 on keyed float64 draws (the card's draws, here
    the `_f64` kernels' plain versions): the run loop equals on_device=False
    bit for bit, the call counter included."""
    off, on = _same_on_every_rank(run_loop_runs["run_loop_float64"])["runs"]
    assert off["route"] and on["route"] and on["run_reads"] > 0 and off["run_reads"] == 0
    assert on == dict(off, run_reads=on["run_reads"]) and on["dtype"] == "float64"
    assert on["beta"] == 1.0 and abs(on["logz"] - ANALYTIC_LOGZ) < 0.5 and on["counter"] > 0


@pytest.mark.parametrize("name", ["ess", "dynamic"])
def test_mesh_device_decisions_equal_host_decisions(run_loop_runs, name):
    """At W = 2 the iteration with its decisions inside a stretch (the
    sharded ESS bisection, dynamic mode's bracket and CV bisection as
    `Loops.repeat`, the CV step and the branches as `loops.when`, each
    collective run on every rank alike) writes the host-decided
    iteration's history bit for bit, six iterations past the first."""
    r = _same_on_every_rank(run_loop_runs[f"decisions_{name}"])
    assert r["same"] == [True] * 6 and r["beta"] > 0.0
    assert r["chunks"] == 0 and r["bodies"] > 0  # the bisections in their loop form


def test_mesh_patch_decides_on_the_device(run_loop_runs):
    """The mesh's warm-up patch without a host read equals the old branch,
    bit for bit, where rows are infinite (patched), where none is
    (unchanged) and where all are (unchanged, logZ's correction -inf)."""
    rows = _same_on_every_rank(run_loop_runs["patch"])["rows"]
    assert all(r["equal"] for r in rows.values()), rows
    assert rows["some_inf"]["patched"] == 5 and rows["some_inf"]["finite"]
    assert rows["none_inf"]["patched"] == 0 and rows["none_inf"]["logz_correction"] == 0.0
    assert rows["all_inf"]["patched"] == 0 and rows["all_inf"]["logz_correction"] == -math.inf


def _jax_gaussian(x):
    import jax.numpy as jnp

    return -0.5 * jnp.sum(x * x, axis=-1) - 0.5 * D * jnp.log(2 * jnp.pi)


@pytest.fixture(scope="module")
def anneal(tmp_path_factory):
    """The drill's annealing at W = 2, with a sharded file of tempest_tpu's
    (one process, 8 devices, 9 iterations) for the ranks to load."""
    from tempest_tpu import Sampler as JaxSampler
    from tempest_tpu.parallel.mesh import make_particle_mesh as jax_mesh
    from tempest_tpu.utils.checkpoint import save_checkpoint_sharded

    workdir = tmp_path_factory.mktemp("anneal")
    js = JaxSampler(_prior, _jax_gaussian, n_dim=D, n_particles=256, vectorize=True,
                    clustering=False, random_state=3, mesh=jax_mesh(8), history_capacity=32)
    for _ in range(9):
        js.sample()
    save_checkpoint_sharded(workdir / "jax.state", js.state.hist, js.state.cur, js.state.key,
                            {"n_total": 512})
    jax_hist = {k: np.asarray(getattr(js.state.hist, k)) for k in HISTORY_LEAVES + ("t",)}
    rows = spawn(__file__, "anneal", 2, workdir)
    return workdir, [r[-1] for r in rows], jax_hist


def test_two_process_annealing_and_checkpoint(anneal):
    _, (r0, r1), _ = anneal
    # Both ranks run one program on replicated decisions: identical evidence.
    assert r0["logz"] == r1["logz"] and r0["t"] == r1["t"]
    assert r0["beta"] == r1["beta"] == 1.0
    assert abs(r0["logz"] - ANALYTIC_LOGZ) < 0.5
    assert r0["mean0"] == r1["mean0"] and abs(r0["mean0"]) < 0.5
    # The file is sharded: each rank wrote exactly its half of hist.u.
    assert r0["is_dir"] and r0["shard_shape"] == r1["shard_shape"] == [D, 64, 128]
    for r in (r0, r1):
        assert r["loaded_t"] == r0["t"] and abs(r["loaded_logz"] - r0["logz"]) < 1e-6
        assert r["loaded_local_n"] == 128


def test_jax_sharded_checkpoint_loads_in_port(anneal):
    workdir, rows, jax_hist = anneal
    with np.load(workdir / "jax_loaded.npz") as got:
        for k in HISTORY_LEAVES + ("t",):
            np.testing.assert_array_equal(got[k], jax_hist[k], err_msg=k)
    for r in rows:
        assert r["jax_loaded_t"] == int(jax_hist["t"]) == 9
        assert r["jax_run_beta"] == 1.0 and abs(r["jax_run_logz"] - ANALYTIC_LOGZ) < 0.5


def test_port_sharded_checkpoint_loads_in_jax(anneal):
    from tempest_tpu.parallel.mesh import make_particle_mesh as jax_mesh
    from tempest_tpu.utils.checkpoint import load_checkpoint_sharded

    workdir, _, _ = anneal
    hist, cur, key, meta = load_checkpoint_sharded(workdir / "mp.state", jax_mesh(8))
    assert meta["n_total"] == 512 and np.asarray(key).shape == (2,)
    assert cur.u.shape == (256, D) and not hist.u.sharding.is_fully_replicated
    with np.load(workdir / "mp_state.npz") as want:
        for k in HISTORY_LEAVES + ("t",):
            np.testing.assert_array_equal(np.asarray(getattr(hist, k)), want[k], err_msg=k)


def test_two_process_midrun_kill_and_resume(tmp_path):
    """A mid-run sharded checkpoint, both ranks SIGKILLed while they sample
    on, and a fresh pair of processes (another seed) resumes: the end is
    the uninterrupted run's, bit for bit."""
    full = [r[-1] for r in spawn(__file__, "drill", 2, tmp_path / "full", "full")]

    procs = launch(__file__, "drill", 2, tmp_path, "interrupt")
    flags = [tmp_path / "saved_0.flag", tmp_path / "saved_1.flag"]
    deadline = time.time() + 120
    try:
        while not all(f.exists() for f in flags):
            for i, p in enumerate(procs):
                assert p.poll() is None, f"interrupt rank {i} exited:\n{p.stdout.read()[-4000:]}"
            assert time.time() < deadline, "the checkpoint flags never appeared"
            time.sleep(0.2)
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=60)
    ckpt = tmp_path / "mid.state"
    assert (ckpt / "meta.json").exists()
    assert (ckpt / "shard_0").is_dir() and (ckpt / "shard_1").is_dir()

    resumed = [r[-1] for r in spawn(__file__, "drill", 2, tmp_path, "resume")]
    for rf, rr in zip(full, resumed):
        assert rr["beta"] == 1.0
        assert rr["t"] == rf["t"]
        assert rr["logz"] == rf["logz"]
        assert abs(rr["mean0"] - rf["mean0"]) < 1e-6


def test_ranks_free_the_mesh_before_destroying_the_group(tmp_path):
    """The cause of the two-rank fixture's intermittent failures: a rank
    whose DeviceMesh outlives destroy_process_group() is now and then
    aborted by PyTorch at exit (-6), after its work and its results. The
    worker frees every mesh, a sampler in a reference cycle included,
    before it destroys the group, and exits 0."""
    rows = spawn(__file__, "teardown", 2, tmp_path)
    assert [r[-1]["live_meshes"] for r in rows] == [0, 0]


def test_workers_import_no_jax():
    """A rank imports both test files, the port and torch, never JAX."""
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import test_torch_distributed, test_torch_parallel; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'tempest_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


if __name__ == "__main__":
    worker_main({"sampler": _w_sampler, "anneal": _w_anneal, "drill": _w_drill,
                 "teardown": _w_teardown, "run_loop": _w_run_loop})
