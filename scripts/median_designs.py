"""Three designs of the weighted-median kernel's chain, timed on one NVIDIA
GPU in turns.

    python3 scripts/median_designs.py [--calls 20]

All three are `tempest_tpu_torch/csrc/weighted_median.cu` (one CTA a column,
warps 1-7 staging the gathered weights in shared memory, thread 0 adding
them serially); they differ only in the chain, which this script makes
by editing the source's text before it builds each one into build/:

(a) the port's kernel: 128 bytes a group (32 floats), each running sum
    tested with one predicate update, one branch a group;
(b) 32 bytes a group (8 floats), as first written;
(c) one test a group, of its last running sum (valid only where the
    sums cannot fall: weights >= 0 and no NaN, as those made here).

Each is held against the plain version bit for bit at A's (16, 4096, 10),
B's (1, 524,288, 10) and rosenbrock100's (1, 8192, 100) (K, n, d), then
timed there: device time a launch from torch.profiler's records of the
kernel, the designs in turns (a, b, c, c, b, a). Beside them the chain's
bound: the longest column's adds up to its crossing at 4 cycles an add
(FADD's latency) at the 1.98 GHz boost clock. The last line is one JSON
object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from tempest_tpu_torch.ops import _build, cuda_median  # noqa: E402

SHAPES = {"A": (16, 4096, 10), "B": (1, 524288, 10), "rosenbrock100": (1, 8192, 100)}
CLOCK_HZ, ADD_CYCLES = 1.98e9, 4

_GROUP = "constexpr int kGroupBytes = 128;"
_TEST_EACH = """      s = s + cur.v[e];
      hit |= s >= thr;
    }
    if (hit) {"""
_TEST_LAST = """      s = s + cur.v[e];
    }
    if (!(s < thr)) {"""
DESIGNS = {
    "a_port": [],
    "b_8_a_group": [(_GROUP, "constexpr int kGroupBytes = 32;")],
    "c_one_test_a_group": [(_TEST_EACH, _TEST_LAST)],
}


def build(name: str, edits) -> ctypes.CDLL:
    """The port's source with `edits` (old, new) applied, built with the
    port's nvcc flags into build/median_designs/."""
    src = (_build.CSRC / cuda_median.LIBRARY.source).read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"design {name}: the source no longer holds {old!r}")
        src = src.replace(old, new)
    out = Path(_build.BUILD_DIR).parent / "median_designs"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(src)
    lib = out / f"lib{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(out / f"{name}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    handle = ctypes.CDLL(str(lib))
    fn = handle.tempest_weighted_median
    fn.argtypes = cuda_median.LIBRARY.functions["tempest_weighted_median"]
    fn.restype = ctypes.c_int
    return handle


def inputs(K: int, n: int, d: int, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g).cuda()
    order = torch.argsort(x, dim=0, stable=True).contiguous()
    w = torch.rand(K, n, generator=g).cuda()
    return torch.gather(x, 0, order).contiguous(), order, w / w.sum(dim=1, keepdim=True)


def device_ms(fn, calls: int) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    for name in ("self_device_time_total", "self_cuda_time_total"):
        us = sum(getattr(e, name, 0.0) for e in prof.key_averages()
                 if "weighted_median_kernel" in e.key)
        if us:
            return us / 1e3 / calls
    raise RuntimeError("no device time recorded for the kernel")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--calls", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    print(torch.cuda.get_device_name(0), flush=True)
    libs = {name: build(name, edits) for name, edits in DESIGNS.items()}
    thr = torch.tensor(cuda_median.THRESHOLD, dtype=torch.float32).item()
    result = {}
    for label, (K, n, d) in SHAPES.items():
        ds, order, wbar = inputs(K, n, d)
        want = cuda_median.weighted_median_presorted_reference(ds, order, wbar)
        crossed = torch.cumsum(wbar[..., order], dim=-2) >= thr
        longest = int((torch.argmax(crossed.to(torch.int8), dim=-2) + 1).max())
        fns, outs = {}, {}
        for name, lib in libs.items():
            mu = outs[name] = torch.empty(K, d, device="cuda")
            fns[name] = (lambda f=lib.tempest_weighted_median, mu=mu: f(
                ds.data_ptr(), order.data_ptr(), wbar.data_ptr(), mu.data_ptr(), n, d, K, thr,
                torch.cuda.current_stream().cuda_stream))
            if fns[name]() != 0:
                raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        for name, mu in outs.items():
            if not torch.equal(mu.view(torch.int32), want.view(torch.int32)):
                raise RuntimeError(f"{name} at {(K, n, d)}: not the plain version's bits")
        times = {name: [] for name in fns}
        for name in (*fns, *reversed(fns)):
            times[name].append(device_ms(fns[name], args.calls))
        bound = 1e3 * longest * ADD_CYCLES / CLOCK_HZ
        result[label] = {"shape": [K, n, d], "longest_chain": longest, "chain_bound_ms": bound,
                         "device_ms": times}
        print(f"{label} (K, n, d) = {(K, n, d)}, longest chain {longest} adds, chain bound "
              f"{bound:.5f} ms; device ms a launch in turns: "
              + "; ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in times.items()), flush=True)
    print(json.dumps({"median_designs": result}), flush=True)


if __name__ == "__main__":
    main()
