"""A's, B's, dynamic mode's and rosenbrock100's runs in two versions of
tempest_tpu_torch, in turns on one GPU.

    python3 scripts/path_ab.py --parent DIR

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
  logZ; then iterations 21-23 graphed under the profiler: wall, device ms
  and blocking host reads an iteration, and `ps/reweight`'s host ms;
- A (phases 6 and 6b, the canonical clustered problem): seed 42 with
  run(on_device=True) after a capturing seed-43 run, then with
  run(on_device=False): wall, iterations, logZ; then iterations 21-23 in
  each mode under the profiler: wall, device ms, idle share, blocking host
  reads and each loop's chunk reads an iteration, and the stages' host ms;
- rosenbrock100 (phase 16): seed 42 with run(on_device=True) after a
  capturing seed-43 run: wall, iterations, logZ; then iterations 21-23
  graphed under the profiler: wall, device ms, blocking host reads and
  `ps/fit`'s host ms an iteration.

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


def one(root: str) -> dict:
    sys.argv = [sys.argv[0], "--package-root", root]  # chip_smoke reads it when imported
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs

    device = torch.device("cuda")
    out = {"root": root, "package": os.path.dirname(os.path.dirname(cs.cuda_reweight.__file__))}
    g, _ = cs.run_b(device, torch.float32, "B graphed (capturing)", graphs=True)
    g, rows = cs.run_b(device, torch.float32, "B graphed", graphs=True, s=g)
    out["B_mutation_s"] = [r["wall"] for r in rows if r["beta"] > 0.0]
    out["B_profiled"] = cs.profile_b(g, len(rows) - 1)

    s = cs.dynamic_sampler(device, cs.SEEDS[1])
    s.run(n_total=cs.N_TOTAL, progress=False, on_device=True)  # captures the graphs
    s.reset(random_state=cs.SEEDS[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(n_total=cs.N_TOTAL, progress=False, on_device=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    iters, logz = s.state.hist.t, s.evidence()[0]
    w = cs.steady_window(s, True, n=3, device_only=False)  # resets the sampler
    out["dynamic"] = {"wall_s": wall, "iters": iters, "logz": logz,
                      "window_ms_per_iter": 1e3 * w["wall_per_iter"],
                      "device_ms_per_iter": w["device_ms_per_iter"],
                      "blocking_per_iter": w["blocking_per_iter"],
                      "reweight_host_ms": w["stages_ms"].get("ps/reweight")}

    a = cs.canonical_sampler(device, cs.SEEDS[1], clustering=True)
    a.run(n_total=cs.N_TOTAL, progress=False, on_device=True)  # captures the graphs
    out["A"] = {}
    for on_device in (True, False):
        a.reset(random_state=cs.SEEDS[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.run(n_total=cs.N_TOTAL, progress=False, on_device=on_device)
        torch.cuda.synchronize()
        out["A"][f"on_device={on_device}"] = {
            "wall_s": time.perf_counter() - t0, "iters": a.state.hist.t,
            "logz": a.evidence()[0]}
    for graphs in (True, False):
        w = cs.steady_window(a, graphs, n=3, device_only=False)  # resets the sampler
        out["A"][f"window graphs={graphs}"] = {
            "ms_per_iter": 1e3 * w["wall_per_iter"], "device_ms_per_iter": w["device_ms_per_iter"],
            "idle": w["idle"], "blocking_per_iter": w["blocking_per_iter"],
            "chunk_reads_per_iter": {k: v / w["n"] for k, v in w["reads"].items()},
            "stages_ms": w["stages_ms"]}

    r = cs.rosenbrock100_sampler(device, cs.SEEDS[1])
    r.run(n_total=cs.R100_TOTAL, progress=False, on_device=True)  # captures the graphs
    r.reset(random_state=cs.SEEDS[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.run(n_total=cs.R100_TOTAL, progress=False, on_device=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    iters, logz = r.state.hist.t, r.evidence()[0]
    w = cs.steady_window(r, True, n=3, device_only=False, n_total=cs.R100_TOTAL)
    out["rosenbrock100"] = {"wall_s": wall, "iters": iters, "logz": logz,
                            "window_ms_per_iter": 1e3 * w["wall_per_iter"],
                            "device_ms_per_iter": w["device_ms_per_iter"],
                            "blocking_per_iter": w["blocking_per_iter"],
                            "fit_host_ms": w["stages_ms"].get("ps/fit")}
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", metavar="DIR", help="the other version's checkout")
    parser.add_argument("--one", metavar="ROOT", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        print("PATH_AB " + json.dumps(one(os.path.abspath(args.one))), flush=True)
        return
    if not args.parent:
        parser.error("--parent DIR is required")
    parent = os.path.abspath(args.parent)
    results, ok = [], True
    for root in (parent, REPO, REPO, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True, timeout=1200)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("PATH_AB ")]
        if proc.returncode != 0 or not line:
            ok = False
            print(f"{root}: failed ({proc.returncode})\n{proc.stdout[-2000:]}{proc.stderr[-3000:]}",
                  flush=True)
            continue
        results.append(json.loads(line[0][len("PATH_AB "):]))
        r = results[-1]
        d = r["dynamic"]
        print(f"{'parent' if root == parent else 'this'} ({r['package']}): B seconds a mutation "
              f"iteration graphed {[round(x, 4) for x in r['B_mutation_s']]}, profiled "
              f"{json.dumps(r['B_profiled'])}; dynamic graphed {d['wall_s']:.3f} s, "
              f"{d['iters']} iterations, logZ {d['logz']!r}; window {d['window_ms_per_iter']:.1f} "
              f"ms an iteration, device {d['device_ms_per_iter']:.2f} ms, blocking reads "
              f"{d['blocking_per_iter']:.1f}, ps/reweight {d['reweight_host_ms']:.2f} ms; "
              f"A {json.dumps(r['A'])}; rosenbrock100 {json.dumps(r['rosenbrock100'])}",
              flush=True)
    print(json.dumps({"path_ab": results}), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
