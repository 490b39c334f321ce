"""Designs of the weighted-median kernel and of the ESS kernel's bracket mode,
timed on one NVIDIA GPU in turns.

    python3 scripts/kernel_designs.py [--calls 20]

Each design is this tree's source (`csrc/weighted_median.cu`,
`csrc/ess_bisect.cu`) with one constant changed, which this script does by
editing the source's text before it builds each one into
build/kernel_designs/ (one nvcc each, in parallel):

- the median: the source as it is (256 threads a CTA, 7 gathering warps,
  a chain group of 128 bytes); a chain group of 64 bytes (16 floats: less
  padding a stage, a test every 16 sums); gatherers that sleep between
  polls of a slot;
- the bracket: the source as it is (one level of the bisection tree a
  pass, 512 threads a CTA on the resident route); two and three levels (3
  and 7 betas a pass); 256 and 1024 threads a CTA on the resident route.

Every design is held against the plain version first (the median bit for
bit, the bracket by chip_smoke.py's `check_bracket`), then timed: device
ms a launch from torch.profiler's records of the kernel
(chip_smoke.device_ms), the designs in turns (in order, then back). The
median at A's own fit rows (chip_smoke.a_fit_inputs: seed 42, iteration
21), rosenbrock100's (1, 8192, 100) and B's (1, 524,288, 10); the bracket
(float32) at chip_smoke.BRACKET_SHAPES. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tempest_tpu_torch.ops import _build, cuda_median  # noqa: E402
from tempest_tpu_torch.steps import reweight as reweight_step  # noqa: E402

_WAIT = """        const bool done = bar_done(&r.empty[slot], parity);"""
MEDIAN = {
    "as_is": [],
    # a gatherer waiting for a slot sleeps between polls
    "sleeping_waits": [(_WAIT, _WAIT + "\n        if (!done) __nanosleep(256);")],
    "group_64_bytes": [("constexpr int kGroupBytes = 128;", "constexpr int kGroupBytes = 64;")],
}
_LEVELS = "constexpr int kBracketLevels = 1;"
BRACKET = {
    "as_is": [],
    "two_levels": [(_LEVELS, "constexpr int kBracketLevels = 2;")],
    "three_levels": [(_LEVELS, "constexpr int kBracketLevels = 3;")],
    "256_threads": [("constexpr int kBracketThreads = 512;",
                     "constexpr int kBracketThreads = 256;")],
    "1024_threads": [("constexpr int kBracketThreads = 512;",
                      "constexpr int kBracketThreads = 1024;")],
}
OUT = REPO / "build" / "kernel_designs"


def start(source: str, name: str, edits) -> tuple:
    """The source with `edits` (old, new) applied, its nvcc started."""
    text = (_build.CSRC / source).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"design {name}: {source} no longer holds {old!r} once")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    src.write_text(text)
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, lib


def load(proc, lib: Path, functions: dict) -> ctypes.CDLL:
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {lib.name}:\n{err[-4000:]}")
    handle = ctypes.CDLL(str(lib))
    for fn, argtypes in functions.items():
        getattr(handle, fn).argtypes = list(argtypes)
        getattr(handle, fn).restype = ctypes.c_int
    return handle


def in_turns(fns: dict, kernel: str, calls: int) -> dict:
    out = {k: [] for k in fns}
    for k in [*fns, *reversed(fns)]:
        out[k].append(cs.device_ms(fns[k], kernel, calls=calls))
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--calls", type=int, default=20)
    parser.add_argument("--only", choices=("median", "bracket"),
                        help="time the designs of one kernel only")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    device = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    builds = {}
    if args.only != "bracket":
        builds.update({("median", k): start("weighted_median.cu", f"median_{k}", e)
                       for k, e in MEDIAN.items()})
    if args.only != "median":
        builds.update({("bracket", k): start("ess_bisect.cu", f"bracket_{k}", e)
                       for k, e in BRACKET.items()})
    libs = {key: load(*b, cs.MEDIAN_FUNCTIONS if key[0] == "median" else cs.ESS_FUNCTIONS)
            for key, b in builds.items()}
    result = {"median": {}, "bracket": {}}

    timed = {"A": cs.a_fit_inputs(device)["median"][0]} if args.only != "bracket" else {}
    for label in ("rosenbrock100", "B") if args.only != "bracket" else ():
        K, n, d = cs.MEDIAN_SHAPES[label]
        timed[label] = cs.median_inputs(device, K, n, d, torch.float32, seed=n + d)
    for label, (ds, order, wbar) in timed.items():
        want = cuda_median.weighted_median_presorted_reference(ds, order, wbar)
        fns = {}
        for (kind, name), lib in libs.items():
            if kind != "median":
                continue
            fns[name] = cs.median_parent_fn(lib, ds, order, wbar)
            if not torch.equal(cs._bits(fns[name]()), cs._bits(want)):
                raise SystemExit(f"median {name} at {label}: not the plain version's bits")
        result["median"][label] = in_turns(fns, "weighted_median", args.calls)
        print(f"median {label} {(wbar.shape[0], *ds.shape)}: device ms in turns "
              f"{json.dumps(result['median'][label])}", flush=True)

    for label, *_ in cs.BRACKET_SHAPES if args.only != "median" else ():
        logl, bm, scal = cs.bracket_inputs(device, label)
        want = reweight_step.ess_bracket_loop(logl, bm, scal)
        fns = {}
        for (kind, name), lib in libs.items():
            if kind != "bracket":
                continue
            fns[name] = cs.bracket_raw(lib, logl, bm, scal)
            cs.check_bracket(f"bracket {name} {label}", logl, bm, scal, fns[name](), want)
        result["bracket"][label] = in_turns(fns, "ess_bracket_kernel", args.calls)
        print(f"bracket {label} S={logl.numel()} ({int(want[1].item())} probes): device ms in "
              f"turns {json.dumps(result['bracket'][label])}", flush=True)
    print(json.dumps({"kernel_designs": result}), flush=True)


if __name__ == "__main__":
    main()
