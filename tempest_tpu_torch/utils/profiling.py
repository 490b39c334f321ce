"""Profiling helpers.

Counterpart of tempest_tpu/utils/profiling.py:18-47 over `torch.profiler`:
`trace(log_dir)` records everything inside the block, host and device, and
writes a Chrome trace into `log_dir` (open it in Perfetto or
chrome://tracing); `annotate(name)` labels a region, so it shows up as a
named range in a trace and as its own row of `key_averages()`; the
iteration's `ps/*` stage ranges are made with it. Without a profiler
running, a range costs a few microseconds. A range is a host event: inside
a CUDA graph it is recorded when the graph is captured, not when it is
replayed, so a profile of the device run loop (`fused.make_fused_run`)
shows one replay and its kernels by name, and the loops' body runs are
counted from device words (`loops.Loops.stats[name]["node_bodies"]`).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the block (CPU, and CUDA when a GPU is present) and write
    `<log_dir>/trace.json`; yields the profiler for its tables."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str) -> record_function:
    """A named range, as a context manager: `with annotate("ps/reweight"): ...`"""
    return record_function(name)


@contextlib.contextmanager
def maybe_trace(log_dir: Optional[str]) -> Iterator[Optional[profile]]:
    """trace(log_dir) if a directory is given, else a no-op."""
    if log_dir is None:
        yield None
    else:
        with trace(log_dir) as prof:
            yield prof
