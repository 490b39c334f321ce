"""The device run loop of A under compute-sanitizer's memcheck, in float32
and float64, on one NVIDIA GPU.

    python3 scripts/run_loop_memcheck.py [--dtypes float32 float64] [--timeout S]
                                         [--log-dir DIR]

A (chip_smoke.py's canonical clustered problem, N = 1024, d = 10) captures
its run loop with a seed-43 run(on_device=True), then runs seed 42 on it
(one replay). Each dtype runs twice, each time in a process of its own:
once plainly and once under `compute-sanitizer --tool memcheck` (the
toolkit's, beside nvcc), which checks every device load and store of the
capture, the replay and the kernels around them. The kernels are built
first, outside the sanitizer. Each run prints its exit code, seconds, the
sanitizer's error summary and whether its result (a digest of the beta
ladder, logZ, steps, calls and committed logl) equals the plain run's.
The sanitizer's whole output goes to DIR/memcheck_<dtype>.log (default
build/memcheck). The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(dtype_name: str) -> dict:
    sys.argv = sys.argv[:1]  # chip_smoke reads its own arguments when imported
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs

    dtype = getattr(torch, dtype_name)
    device = torch.device("cuda")
    s = cs.canonical_sampler(device, cs.SEEDS[1], True, dtype=dtype)
    s.run(n_total=cs.N_TOTAL, progress=False, on_device=True)  # captures the run loop
    s.reset(random_state=cs.SEEDS[0])
    s.run(n_total=cs.N_TOTAL, progress=False, on_device=True)
    torch.cuda.synchronize()
    r = s.results()
    h = hashlib.sha256()
    for k in ("beta", "logz", "steps", "calls", "logl"):
        h.update(r[k].tobytes())
    stats = s.state._iteration.loops.stats["run"]
    return {"digest": h.hexdigest()[:16], "logz": s.evidence()[0], "iters": int(s.state.hist.t),
            "replays": stats.get("replays", 0), "reads": stats.get("reads", 0)}


def sanitizer() -> str:
    sys.path.insert(0, REPO)
    from tempest_tpu_torch.ops import _build

    path = os.path.join(os.path.dirname(_build._nvcc()), "compute-sanitizer")
    if not os.path.exists(path):
        raise SystemExit(f"no compute-sanitizer beside nvcc ({path})")
    return path


def build() -> None:
    """Every kernel library, outside the sanitizer (the runs load them)."""
    sys.path.insert(0, REPO)
    from tempest_tpu_torch.ops import (_build, cuda_em, cuda_graphs, cuda_linalg, cuda_median,
                                       cuda_prng, cuda_reweight)

    _build.build_all((cuda_reweight.LIBRARY, cuda_prng.LIBRARY, cuda_linalg.LIBRARY,
                      cuda_median.LIBRARY, cuda_em.GMM_LIBRARY, cuda_em.MVSTUD_LIBRARY,
                      cuda_graphs.LIBRARY))


def run(cmd: list, timeout: float, log: str = "") -> dict:
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=REPO)
        code, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as exc:
        code = "timeout"
        out = exc.stdout.decode() if isinstance(exc.stdout, bytes) else (exc.stdout or "")
        err = exc.stderr.decode() if isinstance(exc.stderr, bytes) else (exc.stderr or "")
    row = {"exit_code": code, "seconds": time.perf_counter() - t0}
    if log:
        os.makedirs(os.path.dirname(log), exist_ok=True)
        with open(log, "w") as f:
            f.write(out + "\n--- stderr ---\n" + err)
        row["log"] = os.path.relpath(log, REPO)
    line = [ln for ln in out.splitlines() if ln.startswith("MEMCHECK_RUN ")]
    if line:
        row.update(json.loads(line[-1][len("MEMCHECK_RUN "):]))
    summary = re.findall(r"ERROR SUMMARY: (\d+) error", out + err)
    if summary:
        row["sanitizer_errors"] = int(summary[-1])
    if "Device not supported" in out + err:  # the sanitizer checked nothing
        row["device_not_supported"] = True
    if not line:
        row["tail"] = (out + err)[-1500:]
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtypes", nargs="+", default=["float32", "float64"])
    parser.add_argument("--timeout", type=float, default=1500.0,
                        help="seconds a sanitized run may take")
    parser.add_argument("--log-dir", default=os.path.join(REPO, "build", "memcheck"),
                        help="where the sanitizer's output goes")
    parser.add_argument("--one", metavar="DTYPE", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        print("MEMCHECK_RUN " + json.dumps(one(args.one)), flush=True)
        return 0
    tool = sanitizer()
    build()
    me = os.path.abspath(__file__)
    rows, ok = {}, True
    for dtype in args.dtypes:
        plain = run([sys.executable, me, "--one", dtype], 600)
        checked = run([tool, "--tool", "memcheck", "--error-exitcode", "99", "--print-limit",
                       "50", sys.executable, me, "--one", dtype], args.timeout,
                      os.path.join(os.path.abspath(args.log_dir), f"memcheck_{dtype}.log"))
        checked["equal"] = checked.get("digest") is not None and checked.get(
            "digest") == plain.get("digest")
        rows[dtype] = {"plain": plain, "memcheck": checked}
        ok &= plain["exit_code"] == 0 and checked["exit_code"] == 0 and checked["equal"] \
            and checked.get("sanitizer_errors") == 0
        print(f"{dtype}: plain {json.dumps(plain)}; under memcheck {json.dumps(checked)}",
              flush=True)
    print(json.dumps({"memcheck": rows, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
