"""The port's particle mesh (tempest_tpu_torch/parallel/) against tempest_tpu.

The port runs one process per device over `torch.distributed`; here the
ranks are W = 2 or 4 processes on the CPU over gloo, started by `spawn`,
each running this file as a script (`python tests/test_torch_parallel.py
<mode> <rank> <world> <store> <workdir>`). The workers import no JAX: the
JAX side runs in the pytest process (on its 8-device CPU mesh from
conftest.py) and the two meet through npz files and JSON lines. Every rank
joins through a `file://` store of its own test directory, with a 60 s
timeout on every collective, and is killed if it outlives 120 s, so no
test can hang.

1. `sharded_resample` at W = 2 and 4, "mult" and "syst", with and without
   blobs, on the positions JAX's `collective._positions` makes: the rows
   must equal JAX's `sharded_resample` on a mesh of W devices and the
   port's unsharded `resample`, exactly.
2. `sharded_select_fit_points` at W = 2 and 4: the full-coverage branch
   (m >= S/W, the exact trim), the candidate branch (trim skipped, weights
   renormalized), the whole history (m = T N, canonical order) and tied
   weights in both branches. Rows, order and keep mask exactly, weights
   to rtol 1e-6, against JAX's on a mesh of W devices.
3. `logsumexp_psum`, `ess_from_logw_psum` and `volume_variation_dtn` with
   a group, at W = 2, against JAX's unsharded functions: rtol 1e-6 in
   float32 and 1e-12 in float64 (JAX under x64).
4. One clustered iteration at W = 2 on JAX's draws, against JAX's
   unsharded iteration with the tolerances of
   tests/test_torch_clustered_slice.py; the ranks get the global draws of
   the port's unsharded run of the same iteration, and keep their blocks.
5. The Sampler at W = 2 on the paths beyond the default one, against the
   same run with `mesh=None` (the same t, the beta ladder within 1e-3,
   logZ within 0.05): `hardware_prng=True` (the Philox draws of the global
   arrays, the same number of kernel calls), dynamic mode (the ESS bracket
   and the CV reduced over the ranks), float64, per-point likelihoods with
   blobs (the posterior's blobs equal to the function's) and systematic
   resampling. `train_max_points` is raised to S/W, so that the sharded
   fit-point selection is exact (see tests/test_torch_distributed.py).

The Sampler under a mesh, the two-process drills and the sharded
checkpoints are in tests/test_torch_distributed.py, which starts its ranks
with this file's `launch`, `collect` and `worker_main`.
"""

import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
INIT_TIMEOUT = 60  # seconds a collective may wait for the other ranks
RUN_TIMEOUT = 120  # seconds a spawned rank may live

D, N, CAP, T_FILL, B = 4, 256, 8, 6, 2  # the collectives' history
# (name, weights, m): S = CAP N = 2048, so S/W = 1024 at W = 2, 512 at W = 4.
SELECT_CASES = [("full", "w", 1536), ("candidates", "w", 300), ("whole", "w", CAP * N),
                ("ties_full", "w_tied", 1536), ("ties_candidates", "w_tied", 300)]
SEP, SIGMA, N_IT = 3.0, 0.5, 128  # tests/test_torch_clustered_slice.py's mixture
NORM = -0.5 * D * math.log(2 * math.pi * SIGMA**2)


def _prior(u):
    return 20.0 * u - 10.0


def _gauss_t(x):
    return -0.5 * torch.sum(x * x, dim=-1) - 0.5 * D * math.log(2 * math.pi)


def _build(mesh, seed, clustering=False, loglike=None, **kw):
    from tempest_tpu_torch import Sampler

    kw.setdefault("n_particles", 256)
    kw.setdefault("device", "cpu")
    kw.setdefault("vectorize", True)
    return Sampler(_prior, loglike or _gauss_t, n_dim=D, clustering=clustering,
                   random_state=seed, mesh=mesh, **kw)


def _gauss_point_blobs(x):
    """A per-point likelihood with two blobs, sum(x) and max(x)."""
    return (-0.5 * torch.sum(x * x) - 0.5 * D * math.log(2 * math.pi), torch.sum(x),
            torch.max(x))


# The paths that the mesh reaches beyond the default one, each run on the
# same seed with and without a mesh.
VARIANTS = {
    "hardware_prng": dict(hardware_prng=True),
    "dynamic": dict(volume_variation=1.0),
    "float64": dict(dtype=torch.float64),
    "blobs": dict(loglike=_gauss_point_blobs, vectorize=False),
    "syst": dict(resample="syst"),
}


def _exact_fit_points(world) -> int:
    """The default train_max_points (4096), raised to S/W where it is below:
    a run of n_total=512 at N = 256 holds S = 48 N samples (the capacity
    the run pre-grows to), and m >= S/W makes every rank's candidates
    cover its block."""
    return max(4096, 48 * 256 // world)


def _run_row(s) -> dict:
    h = s.state.hist
    t = h.count()
    return {"logz": s.logz, "beta": s.beta, "t": t, "betas": h.beta[:t].tolist(),
            "local_n": h.u.shape[2], "local_logl": h.logl.shape[1],
            "local_cur": s.state.cur.u.shape[0], "capacity": h.capacity}


def _same_on_every_rank(rows):
    for row in rows[1:]:
        assert row == rows[0]
    return rows[0]


def by_case(rows):
    """{case: [each rank's row]} from `spawn`'s rows."""
    return {row["case"]: [r[i] for r in rows] for i, row in enumerate(rows[0])}


def _bimodal_t(x):
    a = NORM - 0.5 * torch.sum((x - SEP) ** 2, dim=-1) / SIGMA**2
    b = NORM - 0.5 * torch.sum((x + SEP) ** 2, dim=-1) / SIGMA**2
    return torch.logaddexp(a, b) - math.log(2.0)


# ---------------------------------------------------------------------------
# Ranks
# ---------------------------------------------------------------------------
def launch(script, mode, world, workdir, *args):
    """Start `mode` of `script` on `world` ranks, each a process of its own
    with one thread, joined through a file store in `workdir`."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / "_".join(["store", mode, *map(str, args), str(world)])
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH"))
                                         if p)}
    return [subprocess.Popen(
        [sys.executable, str(script), mode, str(rank), str(world), str(store), str(workdir),
         *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(world)]


def collect(procs, label):
    """Each rank's RESULT lines, parsed. Every rank has RUN_TIMEOUT seconds
    from this call, on one deadline, and is killed if alive past it. If any
    rank fails, the error gives every rank's exit code, its seconds, what
    ended it (the kill at RUN_TIMEOUT, a collective's INIT_TIMEOUT, or its
    own error) and the last 4,000 characters of each failed rank's output."""
    start = time.monotonic()
    outs, seconds = [""] * len(procs), [0.0] * len(procs)

    def wait(i, p):  # a reader each, so that no rank blocks on a full pipe
        outs[i] = p.communicate()[0]
        seconds[i] = time.monotonic() - start

    readers = [threading.Thread(target=wait, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for r in readers:
        r.start()
    for r in readers:
        r.join(max(0.0, start + RUN_TIMEOUT - time.monotonic()))
    killed = [p.poll() is None for p in procs]
    for p, k in zip(procs, killed):
        if k:
            p.kill()
    for r in readers:
        r.join()
    if any(p.returncode != 0 for p in procs):
        lines = [f"{label}: a rank of {len(procs)} failed"]
        for rank, (p, out) in enumerate(zip(procs, outs)):
            lines.append(f"rank {rank}: exit code {p.returncode} after {seconds[rank]:.1f} s, "
                         f"{_ending(killed[rank], p.returncode, out)}")
        for rank, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                lines.append(f"--- rank {rank}'s output, last 4,000 characters:\n{out[-4000:]}")
        pytest.fail("\n".join(lines), pytrace=False)
    return [[json.loads(line[len("RESULT "):]) for line in out.splitlines()
             if line.startswith("RESULT ")] for out in outs]


def _ending(killed: bool, returncode: int, out: str) -> str:
    """What ended a rank, from its exit code and output."""
    if killed:
        return f"killed at RUN_TIMEOUT = {RUN_TIMEOUT} s"
    if returncode == 0:
        return "ran to its end"
    if re.search(r"[Tt]imed? ?out", out):
        return f"a collective or the store timed out (INIT_TIMEOUT = {INIT_TIMEOUT} s)"
    return "its own error"


def spawn(script, mode, world, workdir, *args):
    """Run `mode` of `script` on `world` ranks to its end (`launch`, `collect`)."""
    return collect(launch(script, mode, world, workdir, *args), mode)


def report(obj) -> None:
    print("RESULT " + json.dumps(obj), flush=True)


def worker_main(modes: dict) -> None:
    """A rank: join the group, build the particle mesh, run the mode."""
    import torch.distributed as dist

    from tempest_tpu_torch.parallel import make_particle_mesh
    from tempest_tpu_torch.parallel.distributed import initialize

    mode, rank, world, store, workdir, *args = sys.argv[1:]
    torch.set_num_threads(1)
    start = time.monotonic()
    initialize(f"file://{store}", int(world), int(rank), device="cpu", timeout=INIT_TIMEOUT)
    joined = time.monotonic()
    try:
        modes[mode](make_particle_mesh(device="cpu"), int(rank), int(world), Path(workdir),
                    *args)
    finally:
        # Free the mode's mesh and samplers (often in reference cycles) while
        # the group is up: a DeviceMesh over gloo left to the interpreter's
        # teardown now and then aborts the rank after its work is done, exit
        # code -6 (scripts/mesh_teardown_stress.py).
        gc.collect()
        dist.destroy_process_group()
        # The rank's own times, for a failure's report.
        print(f"RANK_SECONDS join {joined - start:.2f} run {time.monotonic() - joined:.2f}",
              flush=True)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _global_history(data, blobs=True):
    from tempest_tpu_torch.state import make_history

    hist = make_history(CAP, N, D, blob_size=B if blobs else None)
    hist.u, hist.x, hist.logl = _t(data["u"]), _t(data["x"]), _t(data["logl"])
    if blobs:
        hist.blobs = _t(data["blobs"])
    hist.t.fill_(T_FILL)
    hist.t_host = T_FILL
    return hist


def _w_ops(mesh, rank, world, workdir):
    from tempest_tpu_torch.ops.tools import (
        ess_from_logw_psum,
        logsumexp_psum,
        volume_variation_dtn,
    )
    from tempest_tpu_torch.parallel.collective import (
        positions,
        sharded_resample,
        sharded_select_fit_points,
    )
    from tempest_tpu_torch.parallel.mesh import block, particle_group, shard_history
    from tempest_tpu_torch.utils.host import fetch

    group = particle_group(mesh)
    data = dict(np.load(workdir / "ops_in.npz"))
    lo, hi = block(N, group)
    out = {}
    for blobs in (False, True):
        hist = shard_history(_global_history(data, blobs), mesh)
        for method in ("mult", "syst"):
            u, x, logl, bl = sharded_resample(positions(_t(data[f"uni_{method}"]), N, method),
                                              hist, _t(data["w"])[:, lo:hi], group)
            tag = f"res_{method}_{int(blobs)}"
            out.update({f"{tag}_u": fetch(u, group, 0), f"{tag}_x": fetch(x, group, 0),
                        f"{tag}_logl": fetch(logl, group, 0)})
            if blobs:
                out[f"{tag}_blobs"] = fetch(bl, group, 0)
    for name, wkey, m in SELECT_CASES:
        uf, wf, kf = sharded_select_fit_points(hist.u, _t(data[wkey])[:, lo:hi], T_FILL, m,
                                               group)
        out.update({f"sel_{name}_u": uf.numpy(), f"sel_{name}_w": wf.numpy(),
                    f"sel_{name}_keep": kf.numpy()})
    if world == 2:
        for dt in ("float32", "float64"):
            logw = _t(data[f"logw_{dt}"])[:, lo:hi]
            vu, vw = _t(data[f"vu_{dt}"])[:, :, lo:hi], _t(data[f"vw_{dt}"])[:, lo:hi]
            mask = _t(data["vmask"])[:, lo:hi]
            out[f"lse_{dt}"] = logsumexp_psum(logw, group).numpy()
            out[f"ess_{dt}"] = ess_from_logw_psum(logw, group).numpy()
            out[f"cv_{dt}"] = volume_variation_dtn(vu, vw, mask=mask, group=group).numpy()
            out[f"cv_nomask_{dt}"] = volume_variation_dtn(vu, vw, group=group).numpy()
    np.savez(workdir / f"ops_out_{rank}.npz", **out)


class _Replay:
    """The global draws of a recorded iteration, in order."""

    def __init__(self, data):
        self.data, self.step = data, 0
        self.gamma_diff = 0.0

    def resample(self, n, method):
        return _t(self.data["res_uniforms"])

    def mcmc_step(self, n_candidates, n, d, gamma_shape):
        i, self.step = self.step, self.step + 1
        self.gamma_diff = max(self.gamma_diff, float(torch.max(torch.abs(
            gamma_shape - _t(self.data[f"gshape_{i}"])))))
        return _t(self.data[f"z_{i}"]), _t(self.data[f"g_{i}"]), _t(self.data[f"a_{i}"])


def _w_iteration(mesh, rank, world, workdir):
    from tempest_tpu_torch import interop
    from tempest_tpu_torch.cluster import single_cluster_model
    from tempest_tpu_torch.config import SamplerConfig
    from tempest_tpu_torch.draws import BlockDraws
    from tempest_tpu_torch.iteration import make_iteration
    from tempest_tpu_torch.parallel.mesh import particle_group
    from tempest_tpu_torch.utils.host import fetch

    group = particle_group(mesh)
    data = dict(np.load(workdir / "iteration_in.npz"))
    cfg = SamplerConfig(prior_transform=_prior, log_likelihood=_bimodal_t, n_dim=D,
                        n_particles=N_IT, vectorize=True, clustering=True, k_max=4,
                        device="cpu", mesh=mesh)
    iteration = make_iteration(cfg, lambda x, *_: (_bimodal_t(x), None), _prior)
    th = interop.history_from_numpy({k[2:]: v for k, v in data.items() if k.startswith("h.")},
                                    "cpu", mesh)
    tc = interop.current_from_numpy({k[2:]: v for k, v in data.items() if k.startswith("c.")},
                                    "cpu", mesh)
    replay = _Replay(data)
    th, tc, model = iteration(BlockDraws(replay, rank, world), th, tc,
                              single_cluster_model(D, 4, normalize=True))
    out = {"u": fetch(tc.u, group, 0), "logl": fetch(tc.logl, group, 0),
           "assignments": fetch(tc.assignments, group, 0), "mis_c": fetch(th.mis_c, group, 1),
           "local_n": tc.u.shape[0], "beta": float(tc.beta), "logz": float(tc.logz),
           "steps": tc.steps, "calls": tc.calls, "iter": tc.iteration, "t": th.count(),
           "acceptance": float(tc.acceptance), "replayed": replay.step,
           "gamma_diff": replay.gamma_diff}
    out.update({f"m.{k}": getattr(model, k).numpy()
                for k in ("centers", "covariances", "weights", "k_mask")})
    np.savez(workdir / f"iteration_out_{rank}.npz", **out)


def _w_variants(mesh, rank, world, workdir):
    for name, kw in VARIANTS.items():
        s = _build(mesh, 5, train_max_points=_exact_fit_points(world), **kw)
        s.run(n_total=512, progress=False)
        row = {"case": f"variant_{name}", **_run_row(s),
               "dtype": str(s.state.hist.logl.dtype)}
        if name == "blobs":
            x, _, _, blobs = s.posterior(return_blobs=True)
            row["blob_err"] = float(np.max(np.abs(blobs - np.stack(
                [x.sum(axis=1), x.max(axis=1)], axis=1))))
        if name == "hardware_prng":
            row["counter"] = s.state.draws.draws.counter
        report(row)


# ---------------------------------------------------------------------------
# The JAX side and the checks
# ---------------------------------------------------------------------------
def _ops_data():
    rng = np.random.default_rng(0)
    u = rng.uniform(size=(D, CAP, N)).astype(np.float32)
    live = (np.arange(CAP) < T_FILL)[:, None]
    w = np.where(live, rng.exponential(size=(CAP, N)), 0.0).astype(np.float32)
    tied = np.where(live, rng.integers(0, 4, size=(CAP, N)), 0).astype(np.float32)
    data = {"u": u, "x": 20.0 * u - 10.0, "logl": rng.normal(size=(CAP, N)).astype(np.float32),
            "blobs": rng.normal(size=(B, CAP, N)).astype(np.float32),
            "w": w / w.sum(dtype=np.float32), "w_tied": tied / tied.sum(dtype=np.float32),
            "vmask": np.broadcast_to(live, (CAP, N)).copy()}
    logw = rng.normal(-3.0, 4.0, size=(CAP, N))
    logw[rng.uniform(size=(CAP, N)) < 0.05] = -np.inf
    vu, vw = rng.uniform(size=(D, CAP, N)), rng.exponential(size=(CAP, N))
    for dt in ("float32", "float64"):
        data[f"logw_{dt}"], data[f"vu_{dt}"], data[f"vw_{dt}"] = (
            logw.astype(dt), vu.astype(dt), vw.astype(dt))
    return data


def _keys():
    import jax

    return {"mult": jax.random.PRNGKey(3), "syst": jax.random.PRNGKey(4)}


@pytest.fixture(scope="module")
def ops(tmp_path_factory):
    """world -> (the inputs, each rank's outputs), one spawn per world."""
    import jax
    import jax.numpy as jnp

    data = _ops_data()
    keys = _keys()
    data["uni_mult"] = np.array(jax.random.uniform(keys["mult"], (N,), dtype=jnp.float32))
    data["uni_syst"] = np.array(jax.random.uniform(keys["syst"], ()))
    runs = {}

    def get(world):
        if world not in runs:
            workdir = tmp_path_factory.mktemp(f"ops{world}")
            np.savez(workdir / "ops_in.npz", **data)
            spawn(__file__, "ops", world, workdir)
            runs[world] = [dict(np.load(workdir / f"ops_out_{r}.npz")) for r in range(world)]
        return data, runs[world]

    return get


def _jax_history(data, blobs):
    import jax.numpy as jnp

    from tempest_tpu.state import make_history

    hist = make_history(CAP, N, D, blob_size=B if blobs else None)
    return hist.replace(u=jnp.asarray(data["u"]), x=jnp.asarray(data["x"]),
                        logl=jnp.asarray(data["logl"]), t=jnp.asarray(T_FILL, jnp.int32),
                        blobs=jnp.asarray(data["blobs"]) if blobs else None)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("method", ["mult", "syst"])
@pytest.mark.parametrize("blobs", [False, True], ids=["no_blobs", "blobs"])
def test_sharded_resample_equals_jax_and_unsharded(ops, world, method, blobs):
    import jax
    import jax.numpy as jnp

    from tempest_tpu.parallel.collective import sharded_resample as jax_sharded_resample
    from tempest_tpu.parallel.mesh import make_particle_mesh as jax_mesh
    from tempest_tpu_torch.steps.resample import resample

    data, outs = ops(world)
    run = jax.jit(functools.partial(jax_sharded_resample, mesh=jax_mesh(world),
                                    axis="particles", n_active=N, method=method))
    want = run(_keys()[method], hist=_jax_history(data, blobs), weights=jnp.asarray(data["w"]))
    plain = resample(_t(data[f"uni_{method}"]), _global_history(data, blobs), _t(data["w"]), N,
                     method=method)
    tag = f"res_{method}_{int(blobs)}"
    names = ["u", "x", "logl"] + (["blobs"] if blobs else [])
    for i, name in enumerate(names):
        got = outs[0][f"{tag}_{name}"]
        for other in outs[1:]:
            np.testing.assert_array_equal(other[f"{tag}_{name}"], got)
        np.testing.assert_array_equal(got, np.asarray(want[i]), err_msg=f"{name} vs JAX")
        np.testing.assert_array_equal(got, plain[i].numpy(), err_msg=f"{name} vs unsharded")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", [c[0] for c in SELECT_CASES])
def test_sharded_select_fit_points_equals_jax(ops, world, case):
    import jax
    import jax.numpy as jnp

    from tempest_tpu.parallel.collective import (
        sharded_select_fit_points as jax_select,
    )
    from tempest_tpu.parallel.mesh import make_particle_mesh as jax_mesh

    data, outs = ops(world)
    _, wkey, m = next(c for c in SELECT_CASES if c[0] == case)
    full = min(m, CAP * N // world) == CAP * N // world
    assert full == (case in ("full", "whole", "ties_full"))  # both branches are held
    run = jax.jit(functools.partial(jax_select, jax_mesh(world), "particles", m=m))
    want_u, want_w, want_keep = (np.asarray(a) for a in run(
        u=jnp.asarray(data["u"]), weights=jnp.asarray(data[wkey]), t=jnp.asarray(T_FILL)))
    got = [outs[0][f"sel_{case}_{k}"] for k in ("u", "w", "keep")]
    for other in outs[1:]:  # replicated
        for k, g in zip(("u", "w", "keep"), got):
            np.testing.assert_array_equal(other[f"sel_{case}_{k}"], g)
    assert got[0].shape == want_u.shape == (m, D)
    np.testing.assert_array_equal(got[0], want_u)
    np.testing.assert_array_equal(got[2], want_keep)
    np.testing.assert_allclose(got[1], want_w, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-6), ("float64", 1e-12)])
def test_psum_reductions_equal_jax(ops, dtype, rtol):
    import jax
    import jax.numpy as jnp

    from tempest_tpu.ops import tools as jt

    data, outs = ops(2)
    with jax.enable_x64(dtype == "float64"):
        logw = jnp.asarray(data[f"logw_{dtype}"])
        vu, vw = jnp.asarray(data[f"vu_{dtype}"]), jnp.asarray(data[f"vw_{dtype}"])
        want = {"lse": jt.logsumexp(logw), "ess": jt.ess_from_logw(logw),
                "cv": jt.volume_variation_dtn(vu, vw, mask=jnp.asarray(data["vmask"])),
                "cv_nomask": jt.volume_variation_dtn(vu, vw)}
        want = {k: np.asarray(v) for k, v in want.items()}
    for name, value in want.items():
        assert value.dtype == np.dtype(dtype)
        for out in outs:
            got = out[f"{name}_{dtype}"]
            assert got.dtype == value.dtype
            np.testing.assert_allclose(got, value, rtol=rtol, err_msg=name)


class _Recording:
    """A draws object that keeps what it hands out."""

    def __init__(self, inner):
        self.inner, self.saved, self.steps = inner, {}, 0

    def resample(self, n, method):
        self.saved["res_uniforms"] = self.inner.resample(n, method).numpy()
        return torch.from_numpy(self.saved["res_uniforms"])

    def mcmc_step(self, n_candidates, n, d, gamma_shape):
        z, g, a = self.inner.mcmc_step(n_candidates, n, d, gamma_shape)
        i, self.steps = self.steps, self.steps + 1
        self.saved.update({f"z_{i}": z.numpy(), f"g_{i}": g.numpy(), f"a_{i}": a.numpy(),
                           f"gshape_{i}": gamma_shape.numpy()})
        return z, g, a


def test_clustered_iteration_at_two_ranks_equals_jax(tmp_path):
    import jax
    import jax.numpy as jnp
    from test_torch_slice import JaxIterationDraws

    from tempest_tpu import Sampler as JaxSampler
    from tempest_tpu_torch import interop
    from tempest_tpu_torch.cluster import single_cluster_model
    from tempest_tpu_torch.config import SamplerConfig
    from tempest_tpu_torch.iteration import make_iteration

    def bimodal_j(x):
        a = NORM - 0.5 * jnp.sum((x - SEP) ** 2, axis=-1) / SIGMA**2
        b = NORM - 0.5 * jnp.sum((x + SEP) ** 2, axis=-1) / SIGMA**2
        return jnp.logaddexp(a, b) - jnp.log(2.0)

    js = JaxSampler(_prior, bimodal_j, n_dim=D, n_particles=N_IT, vectorize=True,
                    clustering=True, k_max=4, random_state=0, history_capacity=16)
    core = js.state
    while int(core._fused_model.n_clusters()) < 2 or int(core.hist.t) < 9:
        js.sample()
    fields_h = {k: np.array(getattr(core.hist, k)) for k in interop.HISTORY_FIELDS + ("t",)}
    fields_c = {k: np.array(getattr(core.cur, k))
                for k in interop.CURRENT_FIELDS + interop.CURRENT_COUNTERS}
    it_key = jax.random.split(core.key)[1]  # what core._next_key() hands the iteration
    out_j = js.sample()
    model_j = core._fused_model

    # The port's unsharded run of the iteration records the global draws.
    cfg = SamplerConfig(prior_transform=_prior, log_likelihood=_bimodal_t, n_dim=D,
                        n_particles=N_IT, vectorize=True, clustering=True, k_max=4, device="cpu")
    rec = _Recording(JaxIterationDraws(it_key))
    make_iteration(cfg, lambda x, *_: (_bimodal_t(x), None), _prior)(
        rec, interop.history_from_numpy(fields_h, "cpu"),
        interop.current_from_numpy(fields_c, "cpu"), single_cluster_model(D, 4, normalize=True))
    np.savez(tmp_path / "iteration_in.npz", **rec.saved,
             **{f"h.{k}": v for k, v in fields_h.items()},
             **{f"c.{k}": v for k, v in fields_c.items()})
    spawn(__file__, "iteration", 2, tmp_path)
    outs = [dict(np.load(tmp_path / f"iteration_out_{r}.npz")) for r in range(2)]

    for key, value in outs[0].items():
        np.testing.assert_array_equal(outs[1][key], value, err_msg=f"{key} differs by rank")
    r = outs[0]
    assert int(r["local_n"]) == N_IT // 2 and int(r["replayed"]) == rec.steps
    assert float(r["gamma_diff"]) < 1e-3  # the gathered shapes are the unsharded run's
    assert int(r["m.k_mask"].sum()) == int(model_j.n_clusters()) >= 2
    for name in ("centers", "covariances", "weights"):
        want = np.asarray(getattr(model_j, name))
        np.testing.assert_allclose(r[f"m.{name}"], want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)
    np.testing.assert_array_equal(r["assignments"], out_j["assignments"])
    assert int(r["t"]) == int(core.hist.t) and int(r["iter"]) == out_j["iter"]
    assert abs(float(r["beta"]) - out_j["beta"]) < 1e-5
    assert abs(float(r["logz"]) - out_j["logz"]) < 1e-5
    assert int(r["steps"]) == out_j["steps"] and int(r["calls"]) * N_IT == out_j["calls"]
    np.testing.assert_allclose(r["u"], out_j["u"], atol=1e-4)
    np.testing.assert_allclose(r["logl"], out_j["logl"], atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(float(r["acceptance"]), out_j["acceptance"], atol=1e-4)
    np.testing.assert_allclose(r["mis_c"], np.asarray(core.hist.mis_c), atol=1e-4, rtol=1e-5)


@pytest.fixture(scope="module")
def variant_runs(tmp_path_factory):
    return by_case(spawn(__file__, "variants", 2, tmp_path_factory.mktemp("variants")))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mesh_variant_matches_single_device(variant_runs, variant):
    """hardware_prng (the Philox draws of the global arrays), dynamic mode
    (the ESS bracket and the CV over the ranks), float64, per-point
    blobs and systematic resampling, at W = 2 against mesh=None."""
    r = _same_on_every_rank(variant_runs[f"variant_{variant}"])
    s1 = _build(None, 5, train_max_points=_exact_fit_points(2), **VARIANTS[variant])
    s1.run(n_total=512, progress=False)
    assert r["dtype"] == str(s1.state.hist.logl.dtype)
    assert r["beta"] == 1.0 and s1.state.hist.t == r["t"]
    assert abs(s1.logz - r["logz"]) < 0.05
    np.testing.assert_allclose(s1.state.hist.beta[: r["t"]].numpy(), r["betas"], atol=1e-3)
    if variant == "blobs":
        assert r["blob_err"] < 1e-5
    if variant == "hardware_prng":
        assert r["counter"] == s1.state.draws.counter > 0


if __name__ == "__main__":
    worker_main({"ops": _w_ops, "iteration": _w_iteration, "variants": _w_variants})
