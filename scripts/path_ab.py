"""A's, B's, dynamic mode's and rosenbrock100's runs in two versions of
tempest_tpu_torch, in turns on one GPU.

    python3 scripts/path_ab.py --parent DIR [--only float64|mutation|host]

DIR is a checkout of another commit (for instance `git archive <commit> |
tar -x -C build/parent`). The script runs `--one ROOT` in a process of its
own for ROOT = DIR, this checkout, this checkout, DIR, and prints each
run's numbers; each process imports tempest_tpu_torch from ROOT through
chip_smoke.py's `--package-root` (the paths' code is chip_smoke.py's, so
both versions run the same drive). One process:

- B (chip_smoke.py phase 8): its iterations up to the fourth mutation,
  graphed, after a capturing pass; the seconds of each mutation iteration;
  then the last one graphed under torch.profiler: wall, device ms, and the
  device ms of the weighted-median kernel and of torch.cumsum's scan;
- dynamic mode (phase 12, rosenbrock10_cv): seed 42 with
  run(on_device=True) after a capturing seed-43 run: wall, iterations,
  logZ, the loops' host reads, whether it took the device run loop;
  then iterations 21-23 graphed under the profiler: wall, device ms and
  blocking host reads an iteration, and `ps/reweight`'s host ms;
  every window also gives its MCMC reads and WHILE iterations an
  iteration, and the MCMC route ("while": one WHILE node graphed;
  "chunks": chunks of steps, a read each);
- A (phases 6 and 6b, the canonical clustered problem): seed 42 with
  run(on_device=True) after a capturing seed-43 run, then with
  run(on_device=False), in the fused route's MCMC chunks of 8 and then in
  chunks of 1 (a read after every step; the same steps and bits): wall,
  iterations, logZ, MCMC steps; then iterations 21-23 in
  each mode under the profiler: wall, device ms, idle share, blocking host
  reads, each loop's chunk reads and graph replays an iteration, and the
  stages' host ms;
- C and the cadence cell (phases 9 and 13, C with cluster_every=3): seed 4
  with run(on_device=True) after a capturing run, then with
  run(on_device=False): wall, iterations, logZ;
- A on a particle mesh of one rank over NCCL (phase 15): seed 42 with
  run(on_device=True) after a capturing seed-43 run: wall, iterations,
  logZ, host reads, whether it took the device run loop;
- rosenbrock100 (phase 16): seed 42 with run(on_device=True) after a
  capturing seed-43 run: wall, iterations, logZ; then iterations 21-23
  graphed under the profiler: wall, device ms, blocking host reads and
  `ps/fit`'s host ms an iteration;
- float64 (`float64_paths`; `--only float64` runs these alone): A in
  float64 with `hardware_prng` off and on, the 4-D Gaussian of
  tests/test_float64.py, dynamic mode (rosenbrock10_cv) and A on a
  one-rank mesh, each seed 42 (the Gaussian seed 1) with
  run(on_device=True) after a capturing run, then A with
  run(on_device=False): wall, iterations, ms an iteration, logZ, MCMC
  steps, the loops' host reads and replays in the timed run, whether it
  took the device run loop and its graph's nodes and depth; and B in
  float64 (phase 14) graphed after a capturing pass: the seconds of each
  mutation iteration;
- the mutation (`--only mutation` runs this alone): B graphed as above,
  with its profiled iteration; rosenbrock100's run(on_device=True) after
  a capturing run, and its graphed window as above; and the device ms of
  one tpCN step at B's and rosenbrock100's walkers (`chip_smoke.step_times`:
  a CUDA graph of `MCMCKernel.step` on fixed draws, replayed between CUDA
  events), in the form each version takes there;
- A with a host likelihood (`--only host` runs this alone; `host_paths`):
  A's configuration with `chip_smoke.rosenbrock_numpy`, a per-point numpy
  function, and host_likelihood=True, seed 42 with run(on_device=True)
  after a capturing seed-43 run, then with run(on_device=False): wall,
  iterations, ms an iteration, the seconds inside the pool's map and the
  rest, the loops' blocking reads an iteration, the map calls and the
  host-call kernel's handshakes (null for a package without it) beside
  the likelihood sweeps, logZ, and whether the run took the device run
  loop.

Each process prints one line `PATH_AB {json}`; the parent process prints
them in order and exits non-zero if one failed. About 2 min a process.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mcmc(w: dict) -> dict:
    """A window's MCMC route, reads and WHILE iterations an iteration."""
    return {k: w[k] for k in ("mcmc_route", "mcmc_reads_per_iter", "while_iterations_per_iter")}


def timed_run(cs, s, n_total: int) -> tuple:
    """Sampler `s`'s run(on_device=True): its wall and its loops' host reads."""
    import torch

    before = sum(v.get("reads", 0) for v in s.state._iteration.loops.stats.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(n_total=n_total, progress=False, on_device=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, sum(v.get("reads", 0) for v in s.state._iteration.loops.stats.values()) - before


def mesh_a(cs, device, **kw) -> dict:
    """A on a particle mesh of one rank over NCCL (phase 15): seed 42 with
    run(on_device=True) after a capturing seed-43 run: wall, iterations,
    logZ, the loops' host reads and whether it took the device run loop;
    `kw` goes to the sampler (dtype=torch.float64 for float64)."""
    import gc

    import torch.distributed as dist

    cs.initialize(f"127.0.0.1:{cs.free_port()}", 1, 0, device="cuda", timeout=300)
    try:
        m = cs.mesh_sampler(device, cs.make_particle_mesh(device="cuda"), cs.SEEDS[1], **kw)
        m.run(n_total=cs.N_TOTAL, progress=False, on_device=True)  # captures the graphs
        m.reset(random_state=cs.SEEDS[0])
        out = on_device_run(cs, m, cs.N_TOTAL)
        del m
        return out
    finally:
        gc.collect()  # the mesh and its sampler go while the group is up
        dist.destroy_process_group()


def on_device_run(cs, s, n_total: int) -> dict:
    """Sampler `s`'s timed run(on_device=True) (after a run that captured
    its graphs): wall, iterations, ms an iteration, logZ, MCMC steps, the
    loops' host reads and graph replays in the run, whether it took the
    device run loop, and that loop's graph (nodes, depth)."""
    loops = s.state._iteration.loops
    replays = sum(v.get("replays", 0) for v in loops.stats.values())
    wall, reads = timed_run(cs, s, n_total)
    iters = int(s.state.hist.t)
    graphs = [dict(nodes=g.nodes, depth=g.depth) for g in loops.graphs_of("run")] \
        if hasattr(loops, "graphs_of") else []
    return {"wall_s": wall, "iters": iters, "ms_per_iter": 1e3 * wall / iters,
            "logz": s.evidence()[0], "steps": int(s.results()["steps"].sum()), "reads": reads,
            "replays": sum(v.get("replays", 0) for v in loops.stats.values()) - replays,
            "run_loop": bool(loops.stats.get("run", {}).get("replays", 0)), "run_graphs": graphs}


def float64_paths(cs, device) -> dict:
    """The float64 paths: A with each hardware_prng, the 4-D Gaussian,
    dynamic mode and A on a one-rank mesh with run(on_device=True) after a
    capturing run, A also with run(on_device=False); B's mutation
    iterations graphed after a capturing pass."""
    import torch

    from tempest_tpu_torch import Sampler

    f64 = torch.float64
    out = {}
    for hw in (False, True):
        a = cs.canonical_sampler(device, cs.SEEDS[1], True, hw, f64)
        a.run(n_total=cs.N_TOTAL, progress=False, on_device=True)  # captures the graphs
        a.reset(random_state=cs.SEEDS[0])
        out[f"A hardware_prng={hw}"] = on_device_run(cs, a, cs.N_TOTAL)
        a.reset(random_state=cs.SEEDS[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.run(n_total=cs.N_TOTAL, progress=False, on_device=False)
        torch.cuda.synchronize()
        out[f"A hardware_prng={hw} on_device=False"] = {
            "wall_s": time.perf_counter() - t0, "iters": int(a.state.hist.t),
            "logz": a.evidence()[0], "steps": int(a.results()["steps"].sum())}
        del a
    g = Sampler(cs.prior_transform, cs.gaussian4, n_dim=4, n_particles=256, vectorize=True,
                clustering=False, random_state=2, dtype=f64, device=device)
    g.run(n_total=1024, progress=False, on_device=True)  # captures the graphs
    g.reset(random_state=1)
    out["gaussian4"] = on_device_run(cs, g, 1024)
    d = Sampler(cs.prior_transform, cs.rosenbrock_chained, n_dim=cs.N_DIM,
                n_particles=cs.N_PARTICLES, vectorize=True, clustering=False,
                history_capacity=192, volume_variation=1.0, random_state=cs.SEEDS[1],
                dtype=f64, device=device)
    d.run(n_total=cs.N_TOTAL, progress=False, on_device=True)  # captures the graphs
    d.reset(random_state=cs.SEEDS[0])
    out["dynamic"] = on_device_run(cs, d, cs.N_TOTAL)
    out["A_mesh"] = mesh_a(cs, device, dtype=f64)
    b, _ = cs.run_b(device, f64, "B float64 graphed (capturing)", graphs=True)
    b, rows = cs.run_b(device, f64, "B float64 graphed", graphs=True, s=b)
    out["B_mutation_s"] = [r["wall"] for r in rows if r["beta"] > 0.0]
    return out


def host_paths(cs, device) -> dict:
    """A with its likelihood on the host (`chip_smoke.host_a_sampler`, a
    `TimedPool` counting the map calls and their seconds): seed 42 with
    run(on_device=True) after a capturing seed-43 run, then with
    run(on_device=False): wall, iterations, ms an iteration, the seconds
    inside the pool's map and the rest, the loops' blocking host reads an
    iteration, the map calls and the host-call kernel's handshakes beside
    the likelihood sweeps, logZ."""
    import torch

    pool = cs.TimedPool()
    s = cs.host_a_sampler(device, cs.SEEDS[1], pool=pool)
    s.run(n_total=cs.N_TOTAL, progress=False, on_device=True)  # captures the graphs
    out = {}
    for on_device in (True, False):
        s.reset(random_state=cs.SEEDS[0])
        loops = s.state._iteration.loops
        reads = sum(v.get("reads", 0) for v in loops.stats.values())
        replays = loops.stats.get("run", {}).get("replays", 0)
        calls, seconds = pool.calls, pool.seconds
        served = None if cs.cuda_host is None else cs.cuda_host.HANDSHAKES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run(n_total=cs.N_TOTAL, progress=False, on_device=on_device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        iters = int(s.state.hist.t)
        host_s = pool.seconds - seconds
        out[f"on_device={on_device}"] = {
            "wall_s": wall, "iters": iters, "ms_per_iter": 1e3 * wall / iters,
            "pool_map_s": host_s, "rest_s": wall - host_s,
            "reads_per_iter": (sum(v.get("reads", 0) for v in loops.stats.values()) - reads)
            / iters,
            "map_calls": pool.calls - calls, "sweeps": int(s.state.cur.calls),
            "handshakes": None if served is None else cs.cuda_host.HANDSHAKES - served,
            "logz": s.evidence()[0],
            "run_loop": loops.stats.get("run", {}).get("replays", 0) > replays}
    return out


def one(root: str, only: str = "") -> dict:
    sys.argv = [sys.argv[0], "--package-root", root]  # chip_smoke reads it when imported
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs

    device = torch.device("cuda")
    cs.sleep_kernel()  # the profiles' warm-up names it while a profile loses nothing
    out = {"root": root, "package": os.path.dirname(os.path.dirname(cs.cuda_reweight.__file__))}
    if only == "mutation":
        out.update(mutation_paths(cs, device))
        return out
    if only == "host":
        out["host"] = host_paths(cs, device)
        return out
    out["float64"] = float64_paths(cs, device)
    if only == "float64":
        return out
    out.update(b_graphed(cs, device))

    s = cs.dynamic_sampler(device, cs.SEEDS[1])
    s.run(n_total=cs.N_TOTAL, progress=False, on_device=True)  # captures the graphs
    s.reset(random_state=cs.SEEDS[0])
    wall, reads = timed_run(cs, s, cs.N_TOTAL)
    iters, logz = int(s.state.hist.t), s.evidence()[0]
    w = cs.steady_window(s, True, n=3, device_only=False)  # resets the sampler
    out["dynamic"] = {"wall_s": wall, "iters": iters, "logz": logz, "reads": reads,
                      "run_loop": cs.run_loop(s),
                      "window_ms_per_iter": 1e3 * w["wall_per_iter"],
                      "device_ms_per_iter": w["device_ms_per_iter"], "idle": w["idle"],
                      "blocking_per_iter": w["blocking_per_iter"],
                      "reweight_host_ms": w["stages_ms"].get("ps/reweight"), **_mcmc(w)}

    a = cs.canonical_sampler(device, cs.SEEDS[1], clustering=True)
    a.run(n_total=cs.N_TOTAL, progress=False, on_device=True)  # captures the graphs
    out["A"] = {}
    chunks = a.state._iteration.loops.chunks
    for run in ("on_device=True", "on_device=False", "on_device=False, an MCMC read a step"):
        a.reset(random_state=cs.SEEDS[0])
        eight = chunks["mcmc"]
        if run.endswith("a step"):  # the same steps and bits, a read after each
            chunks["mcmc"] = 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            a.run(n_total=cs.N_TOTAL, progress=False, on_device=run == "on_device=True")
            torch.cuda.synchronize()
        finally:
            chunks["mcmc"] = eight
        out["A"][run] = {"wall_s": time.perf_counter() - t0, "iters": int(a.state.hist.t),
                         "logz": a.evidence()[0],
                         "steps": int(a.results()["steps"].sum())}
    for graphs in (True, False):
        w = cs.steady_window(a, graphs, n=3, device_only=False)  # resets the sampler
        out["A"][f"window graphs={graphs}"] = {
            "ms_per_iter": 1e3 * w["wall_per_iter"], "device_ms_per_iter": w["device_ms_per_iter"],
            "idle": w["idle"], "blocking_per_iter": w["blocking_per_iter"],
            "chunk_reads_per_iter": {k: v / w["n"] for k, v in w["reads"].items()},
            "replays_per_iter": {k: v / w["n"] for k, v in w["replays"].items() if v},
            "stages_ms": w["stages_ms"], **_mcmc(w)}

    for name, kw in (("C", {}), ("cadence", {"cluster_every": 3})):
        c = cs.c_sampler(device, **kw)
        c.run(n_total=512, progress=False, on_device=True)  # captures the graphs
        out[name] = {}
        for on_device in (True, False):
            c.reset(random_state=4)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c.run(n_total=512, progress=False, on_device=on_device)
            torch.cuda.synchronize()
            out[name][f"on_device={on_device}"] = {
                "wall_s": time.perf_counter() - t0, "iters": int(c.state.hist.t),
                "logz": c.evidence()[0]}

    out["A_mesh"] = mesh_a(cs, device)
    out["rosenbrock100"] = rosenbrock100(cs, device)
    return out


def b_graphed(cs, device) -> dict:
    """B's mutation iterations graphed after a capturing pass, and its last
    one under the profiler."""
    import torch

    g, _ = cs.run_b(device, torch.float32, "B graphed (capturing)", graphs=True)
    g, rows = cs.run_b(device, torch.float32, "B graphed", graphs=True, s=g)
    return {"B_mutation_s": [r["wall"] for r in rows if r["beta"] > 0.0],
            "B_profiled": cs.profile_b(g, len(rows) - 1)}


def mutation_paths(cs, device) -> dict:
    """B graphed, rosenbrock100 on the run loop, and one tpCN step's device
    ms at each one's walkers."""
    out = b_graphed(cs, device)
    out["rosenbrock100"] = rosenbrock100(cs, device)
    out["step_ms"] = cs.step_times(device, ("B", "rosenbrock100"))
    return out


def rosenbrock100(cs, device) -> dict:
    """rosenbrock100's seed 42 with run(on_device=True) after a capturing
    seed-43 run, and iterations 21-23 graphed under the profiler."""
    import torch

    r = cs.rosenbrock100_sampler(device, cs.SEEDS[1])
    r.run(n_total=cs.R100_TOTAL, progress=False, on_device=True)  # captures the graphs
    r.reset(random_state=cs.SEEDS[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.run(n_total=cs.R100_TOTAL, progress=False, on_device=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    iters, logz = int(r.state.hist.t), r.evidence()[0]
    w = cs.steady_window(r, True, n=3, device_only=False, n_total=cs.R100_TOTAL)
    return {"wall_s": wall, "iters": iters, "logz": logz,
            "window_ms_per_iter": 1e3 * w["wall_per_iter"],
            "device_ms_per_iter": w["device_ms_per_iter"],
            "blocking_per_iter": w["blocking_per_iter"],
            "idle": w["idle"], "fit_host_ms": w["stages_ms"].get("ps/fit"), **_mcmc(w)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", metavar="DIR", help="the other version's checkout")
    parser.add_argument("--only", choices=("float64", "mutation", "host"),
                        help="run the float64 paths, the mutation's or A's host likelihood "
                             "alone")
    parser.add_argument("--one", metavar="ROOT", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        print("PATH_AB " + json.dumps(one(os.path.abspath(args.one), args.only or "")),
              flush=True)
        return
    if not args.parent:
        parser.error("--parent DIR is required")
    parent = os.path.abspath(args.parent)
    results, ok = [], True
    only = ["--only", args.only] if args.only else []
    for root in (parent, REPO, REPO, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root, *only],
                              capture_output=True, text=True, timeout=1200)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("PATH_AB ")]
        if proc.returncode != 0 or not line:
            ok = False
            print(f"{root}: failed ({proc.returncode})\n{proc.stdout[-2000:]}{proc.stderr[-3000:]}",
                  flush=True)
            continue
        results.append(json.loads(line[0][len("PATH_AB "):]))
        r = results[-1]
        who = "parent" if root == parent else "this"
        if args.only == "mutation":
            print(f"{who} ({r['package']}): B seconds a mutation iteration graphed "
                  f"{[round(x, 4) for x in r['B_mutation_s']]}, profiled "
                  f"{json.dumps(r['B_profiled'])}; rosenbrock100 {json.dumps(r['rosenbrock100'])}; "
                  f"one tpCN step's device ms {json.dumps(r['step_ms'])}", flush=True)
            continue
        if args.only == "host":
            print(f"{who} ({r['package']}): A with a host likelihood {json.dumps(r['host'])}",
                  flush=True)
            continue
        print(f"{who} ({r['package']}): float64 {json.dumps(r['float64'])}", flush=True)
        if args.only:
            continue
        d = r["dynamic"]
        print(f"{'parent' if root == parent else 'this'} ({r['package']}): B seconds a mutation "
              f"iteration graphed {[round(x, 4) for x in r['B_mutation_s']]}, profiled "
              f"{json.dumps(r['B_profiled'])}; dynamic graphed {d['wall_s']:.3f} s, "
              f"{d['iters']} iterations, logZ {d['logz']!r}; window {d['window_ms_per_iter']:.1f} "
              f"ms an iteration, device {d['device_ms_per_iter']:.2f} ms, idle "
              f"{100 * d['idle']:.1f} %, blocking reads {d['blocking_per_iter']:.1f}, MCMC reads "
              f"{d['mcmc_reads_per_iter']:.1f} ({d['mcmc_route']}), ps/reweight "
              f"{d['reweight_host_ms']:.2f} ms; "
              f"dynamic run: reads {d['reads']}, run loop {d['run_loop']}; A mesh "
              f"{json.dumps(r['A_mesh'])}; "
              f"A {json.dumps(r['A'])}; C {json.dumps(r['C'])}; cadence "
              f"{json.dumps(r['cadence'])}; rosenbrock100 {json.dumps(r['rosenbrock100'])}",
              flush=True)
    print(json.dumps({"path_ab": results}), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
