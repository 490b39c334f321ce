"""How the capture of a CUDA-graph conditional node's body fails, case by
case, on one NVIDIA GPU.

    python3 scripts/capture_probe.py [--nested-only]

Builds scripts/capture_probe.cu with nvcc (sm_90a) into build/capture_probe/
and runs each case (IF or WHILE node; a fault inside the body's capture;
a way of ending the two captures: see the source's head) in a process of
its own, printing its exit code (-11: killed by SIGSEGV) and every CUDA
call that did not return cudaSuccess. csrc/graph_cond.cu takes its design
from this: on CUDA 12.8 every case whose body was captured straight into the
node's body graph and then failed died when the enclosing capture ended,
while the "child" cases lived. The last line is one JSON object: each
case's exit code.
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


def _outcome(rc: int, lines) -> str:
    said = " ".join(lines)
    words = [w for w in ("NESTED_OK", "NESTED_WRONG", "NESTED_FAILED", "ALIVE") if w in said]
    return f"rc={rc} " + "+".join(words)


def main() -> None:
    out = REPO / "build" / "capture_probe"
    out.mkdir(parents=True, exist_ok=True)
    exe = out / "capture_probe"
    proc = subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O2",
                           "-o", str(exe), str(REPO / "scripts" / "capture_probe.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    codes, nested = {}, {}
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
