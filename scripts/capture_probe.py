"""How the capture of a CUDA-graph conditional node's body fails, case by
case, on one NVIDIA GPU.

    python3 scripts/capture_probe.py [--nested-only | --nccl | --host-node]

Builds scripts/capture_probe.cu with nvcc (sm_90a) into build/capture_probe/
and runs each case (IF or WHILE node; a fault inside the body's capture;
a way of ending the two captures: see the source's head) in a process of
its own, printing its exit code (-11: killed by SIGSEGV) and every CUDA
call that did not return cudaSuccess. csrc/graph_cond.cu takes its design
from this: on CUDA 12.8 every case whose body was captured straight into the
node's body graph and then failed died when the enclosing capture ended,
while the "child" cases lived. The last line is one JSON object: each
case's exit code.

`--host-node` runs only the host-function cases instead: a
`cudaLaunchHostFunc` inside a WHILE node's body (3 runs), captured straight
into the node's body graph ("tograph"), into a child graph ("child"), and a
`cudaGraphAddHostNode` into the body graph ("addnode"), each in a process
of its own, with the CUDA runtime and driver versions; where the graph
instantiates and runs, the host function's calls (HOSTFUNC_RAN), else
HOSTFUNC_REFUSED. The port's host likelihood calls the host from such
bodies through a kernel instead (csrc/host_call.cu).

`--nccl` runs only the NCCL cases instead: a process group of one rank
over NCCL (a free local port), and an all-reduce inside conditional
bodies built by `tempest_tpu_torch.loops.Loops`, as the port's run loop
builds them under a particle mesh: in a WHILE body, in an IF body, in both
nested (WHILE > IF, IF > WHILE) and three deep (WHILE > IF > WHILE, dynamic
mode's run loop > CV step > CV bisection). The cases run in one process
of their own, one group for all, each graphed (one replay of the stretch,
two inputs each) against the host's loop on the same inputs, and print
NCCL_OK where the values agree bit for bit, NCCL_WRONG where they differ,
or how the process ended before them; the last line is one JSON object,
each case's outcome.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from tempest_tpu_torch.ops import _build  # noqa: E402

KINDS = ("if", "while")
FAULTS = ("none", "sync", "pinned", "event", "malloc", "devsync")
STRATEGIES = ("torch", "destroy", "skipbody", "parentfirst", "child")
SHAPES = ("w1i", "w2i", "w3i", "wiw")
ROUTES = ("child", "tograph", "mixed")


def _run(exe: Path, args) -> tuple:
    run = subprocess.run([str(exe), *args], capture_output=True, text=True, timeout=60)
    lines = [ln.strip() for ln in run.stdout.splitlines()[1:] if "-> 0 cudaSuccess" not in ln]
    return run.returncode, lines


HOST_ROUTES = ("tograph", "child", "addnode")


def _outcome(rc: int, lines) -> str:
    said = " ".join(lines)
    words = [w for w in ("NESTED_OK", "NESTED_WRONG", "NESTED_FAILED", "ALIVE", "HOSTFUNC_RAN",
                         "HOSTFUNC_REFUSED") if w in said]
    return f"rc={rc} " + "+".join(words)


NCCL_CASES = ("while", "if", "while>if", "if>while", "while>if>while")


def _nccl_cases(cases, kind: str = "cuda") -> None:
    """The NCCL cases `cases`, in this process, one group for all: each
    stretch graphed against the host's loop, for two inputs, one line a
    case (`kind` "cpu": gloo and no graphs, a dry run of the code on a
    machine without a card)."""
    import socket

    import torch
    import torch.distributed as dist

    from tempest_tpu_torch.loops import Loops
    from tempest_tpu_torch.parallel.distributed import initialize

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    initialize(f"127.0.0.1:{port}", 1, 0, device=kind, timeout=60)
    device = torch.device("cuda", torch.cuda.current_device()) if kind == "cuda" else \
        torch.device("cpu")

    def psum(x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    def stretch(case, loops, inputs):
        def while_body(c, k):
            x = psum(0.5 * c["x"] + k["b"])
            if case.startswith("while>if"):
                x = loops.when(x.sum() > k["cut"], if_body, {"x": x}, "if")["x"]
            return {"x": x, "i": c["i"] + 1}

        def if_body(s):
            x = psum(s["x"] * 1.25 + 1.0)
            if case.endswith("if>while"):
                x = inner_while(x)
            return {"x": x}

        def inner_while(x):
            out = loops.repeat("inner", lambda c: c["j"] < 3,
                               lambda c, k: {"x": psum(c["x"] - 0.75), "j": c["j"] + 1},
                               {"x": x, "j": torch.zeros((), dtype=torch.int32, device=device)},
                               {})
            return out["x"]

        if case.startswith("while"):
            return loops.repeat("outer", lambda c: c["i"] < inputs["n"], while_body,
                                {"x": inputs["x"], "i": inputs["i"]},
                                {"b": inputs["b"], "cut": inputs["cut"]})
        return loops.when(inputs["x"].sum() > inputs["cut"], if_body, {"x": inputs["x"]},
                          "if")

    try:
        for case in cases:
            graphed, host = Loops(device, graphs=True), Loops(device)
            agree = []
            for n, cut in ((4, 30.0), (6, -1e9)):
                inputs = {"x": torch.arange(8, dtype=torch.float32, device=device),
                          "i": torch.zeros((), dtype=torch.int32, device=device),
                          "n": torch.full((), n, dtype=torch.int32, device=device),
                          "b": torch.full((), 0.5, device=device),
                          "cut": torch.full((), cut, device=device)}
                got = graphed.once("probe", lambda t: stretch(case, graphed, t), inputs)
                want = stretch(case, host, inputs)
                agree.append(torch.equal(got["x"], want["x"]))
            graph = (graphed.graphs_of("probe") or [None])[0]
            print(f"NCCL {case}: {'NCCL_OK' if all(agree) else 'NCCL_WRONG'} replays "
                  f"{graphed.stats['probe']['replays']} nodes {getattr(graph, 'nodes', None)} "
                  f"depth {getattr(graph, 'depth', None)}", flush=True)
    finally:
        dist.destroy_process_group()


def nccl_main() -> None:
    """The NCCL cases in one process of their own: each case's outcome, or
    how the process ended before it."""
    try:
        run = subprocess.run([sys.executable, __file__, "--nccl-cases", ",".join(NCCL_CASES)],
                             capture_output=True, text=True, timeout=600, cwd=REPO)
        said, end = run.stdout, f"rc={run.returncode} " + (
            run.stderr.strip().splitlines() or [""])[-1]
    except subprocess.TimeoutExpired as exc:
        said, end = exc.stdout or "", "timed out after 600 s"
    if isinstance(said, bytes):
        said = said.decode()
    outcomes = {}
    for case in NCCL_CASES:
        line = [ln for ln in said.splitlines() if ln.startswith(f"NCCL {case}: ")]
        outcomes[case] = line[0].split(": ", 1)[1] if line else f"not run: {end}"
        print(f"nccl {case}: {outcomes[case]}", flush=True)
    print(json.dumps({"nccl": outcomes}), flush=True)


def main() -> None:
    if sys.argv[1:2] == ["--nccl-cases"]:
        return _nccl_cases(sys.argv[2].split(","), *sys.argv[3:4])
    if "--nccl" in sys.argv[1:]:
        return nccl_main()
    out = REPO / "build" / "capture_probe"
    out.mkdir(parents=True, exist_ok=True)
    exe = out / "capture_probe"
    proc = subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O2",
                           "-o", str(exe), str(REPO / "scripts" / "capture_probe.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    codes, nested = {}, {}
    if "--host-node" in sys.argv[1:]:
        host = {}
        for route in HOST_ROUTES:
            rc, lines = _run(exe, ("hostfunc", route))
            host[route] = _outcome(rc, lines)
            print(f"hostfunc {route}: rc={rc} | " + " | ".join(lines), flush=True)
        print(json.dumps({"host_node": host}), flush=True)
        return
    if "--nested-only" not in sys.argv[1:]:
        for kind, fault, strategy in itertools.product(KINDS, FAULTS, STRATEGIES):
            rc, lines = _run(exe, (kind, fault, strategy))
            codes[f"{kind} {fault} {strategy}"] = rc
            print(f"{kind} {fault} {strategy}: rc={rc} | " + " | ".join(lines), flush=True)
    cases = [(shape, route, "none") for shape in SHAPES for route in ROUTES]
    cases += [(shape, "mixed", fault) for shape in ("w3i", "wiw") for fault in FAULTS[1:]]
    for shape, route, fault in cases:
        rc, lines = _run(exe, ("nested", shape, route, fault))
        nested[f"{shape} {route} {fault}"] = _outcome(rc, lines)
        print(f"nested {shape} {route} {fault}: rc={rc} | " + " | ".join(lines), flush=True)
    print(json.dumps({"capture_probe": codes, "nested": nested}), flush=True)


if __name__ == "__main__":
    main()
