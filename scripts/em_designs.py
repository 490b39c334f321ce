"""The EM kernels at both CTA sizes, timed on one NVIDIA GPU in turns.

    python3 scripts/em_designs.py [--calls 3]

Both designs are `tempest_tpu_torch/csrc/gmm_em.cu` and `mvstud_em.cu`;
they differ only in the CTA size the launch plan picks (`em_common.cuh`,
`cta_for`), which this script fixes by editing a copy of the sources before
it builds each one into build/:

(256) every launch 256 threads a CTA;
(512) every launch 512 threads a CTA.

The port's plan takes 512, but 256 in float32 where the launch has more
than 64 CTAs. Each build's ptxas report (registers and spill bytes) is
printed, then the device time a launch from
torch.profiler's records of the kernel, the designs in turns (256, 512,
512, 256), on the inputs of chip_smoke.py's phase 4d: the GMM EM at A's
leaf fits (16, 2048, 10, K = 2) and the Student-t EM at A's (16, 4096, 10),
the unclustered (1, 4096, 10), B's (1, 524,288, 10) and rosenbrock100's
(1, 8192, 100) (K, n, d), in float32 and float64. The last line is one
JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tempest_tpu_torch import cluster as tc  # noqa: E402
from tempest_tpu_torch import student as ts  # noqa: E402
from tempest_tpu_torch.ops import _build  # noqa: E402

RULE = "return elem == 4 && ctas > 64 ? kSmallCta : kLargeCta;"
DESIGNS = {256: "return kSmallCta;", 512: "return kLargeCta;"}
MODE_SHAPES = {"A": (16, 4096, 10), "unclustered": (1, 4096, 10), "B": (1, 524288, 10),
               "rosenbrock100": (1, 8192, 100)}


def make_design(threads: int) -> Path:
    """A copy of csrc/ under build/ whose plan always takes `threads`."""
    out = Path(REPO) / "build" / f"em_design_{threads}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out)
    header = (out / "em_common.cuh").read_text()
    if RULE not in header:
        raise SystemExit("em_common.cuh's cta_for is not the rule this script edits")
    (out / "em_common.cuh").write_text(header.replace(RULE, DESIGNS[threads]))
    return out


def ptxas(src: Path) -> dict:
    nvcc = _build._nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    out = {}
    for name in ("gmm_em.cu", "mvstud_em.cu"):
        proc = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-cubin", "-o", os.devnull,
                               str(src / name)], capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise SystemExit(proc.stderr)
        out[name] = cs.ptxas_report(proc.stdout + proc.stderr)
    return out


def time_design(src: Path, device, calls: int) -> dict:
    """Device ms a launch of each case on the sources in `src`."""
    _build.CSRC = src
    _build._loaded.clear()
    out = {}
    for dtype in (torch.float32, torch.float64):
        tag = "f32" if dtype == torch.float32 else "f64"
        Xb, sw, carry = cs.em_gmm_inputs(device, 16, 2048, 10, 2, "full", dtype, 0)
        out[f"gmm_em A {tag}"] = cs.device_ms(
            lambda: tc._gmm_em(Xb, sw, carry, 1000, 1e-3, 1e-6, "full", None), "gmm_em_kernel",
            calls=calls)
        for label, (K, n, d) in MODE_SHAPES.items():
            mc, mk = cs.em_mode_inputs(device, K, n, d, dtype, seed=K + d)
            out[f"mvstud_em {label} {tag}"] = cs.device_ms(
                lambda: ts._mode_em(mc, mk, None), "mvstud_em_kernel", calls=calls)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--calls", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    device = torch.device("cuda")
    sources = {t: make_design(t) for t in DESIGNS}
    reports = {t: ptxas(src) for t, src in sources.items()}
    for t, r in reports.items():
        print(f"ptxas, {t} threads: {json.dumps(r)}", flush=True)
    times = {t: [] for t in DESIGNS}
    for t in (256, 512, 512, 256):
        times[t].append(time_design(sources[t], device, args.calls))
        print(f"{t} threads: {json.dumps({k: round(v, 4) for k, v in times[t][-1].items()})}",
              flush=True)
    print(json.dumps({"em_designs": {"ptxas": reports, "device_ms": times,
                                     "device": torch.cuda.get_device_name(0)}}), flush=True)


if __name__ == "__main__":
    main()
