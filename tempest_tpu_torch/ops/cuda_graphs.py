"""Conditional IF nodes of a CUDA graph, for `loops.Loops.when`.

JAX runs the hierarchical fit's split rounds as `lax.cond`s and a
`lax.while_loop` inside one device program (tempest_tpu/cluster.py:928-950).
A captured CUDA graph expresses such a decision as a conditional IF node:
its body graph runs at a launch only where a device flag is nonzero, so a
replay decides on the device and reads nothing. The PyTorch release the
port runs on has no call that makes one (later ones have
`CUDAGraph.begin_capture_to_if_node`), so `csrc/graph_cond.cu` makes it
with the CUDA runtime (`tempest_if_begin`, `tempest_if_end`; design note
there), built by nvcc at first use and loaded with ctypes (`_build`).

`if_body(pred, pool, stream)` captures what runs inside it on `stream` as
the body of an IF node on the 0-d CUDA bool `pred`, placed after the work
the current stream has captured so far. The body's allocations go to
`pool` (PyTorch's allocator routing, as `torch.cuda.use_mem_pool` does):
a memory pool of the graph's bodies (`body_pool`), not the graph's own,
to which PyTorch already routes the capture stream and which it routes
only once. The pool keeps the bodies' memory for the replays until
`release_pool`; bodies that run one after another in one graph may share
it, as a body's temporaries die inside it. A refusal raises, naming
CUDA's error; nothing falls back.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Iterator, List

import torch

from . import _build

_PTR = ctypes.c_void_p
LIBRARY = _build.CudaLibrary(
    "graph_cond.cu",
    {"tempest_if_begin": [_PTR] * 3, "tempest_if_end": [_PTR] * 2,
     "tempest_capture_nodes": [_PTR] * 2,
     "tempest_error_string": [ctypes.c_int, _PTR, ctypes.c_int64]},
)

# Launches of the one-thread kernel that sets a node's flag (`set_conditional`
# in the source), one a node a graph launch: a capture counts each node's,
# and `loops` puts them back and adds them again at every replay, as it
# does for the kernels.
LAUNCHES = 0


def _check(err: int, what: str) -> None:
    if err != 0:
        name = ctypes.create_string_buffer(128)
        _build.load(LIBRARY).tempest_error_string(err, name, len(name))
        raise RuntimeError(f"{what} failed with CUDA error {err} ({name.value.decode()})")


def _routing():
    """PyTorch's calls that route the current stream's allocations to a
    memory pool and end that (their names vary between releases)."""
    begin = (getattr(torch._C, "_cuda_beginAllocateCurrentStreamToPool", None)
             or getattr(torch._C, "_cuda_beginAllocateCurrentThreadToPool", None))
    end = (getattr(torch._C, "_cuda_endAllocateToPool", None)
           or getattr(torch._C, "_cuda_endAllocateCurrentStreamToPool", None))
    if begin is None or end is None or not hasattr(torch._C, "_cuda_releasePool"):
        raise RuntimeError(f"this PyTorch ({torch.__version__}) cannot route allocations to a "
                           "CUDA graph's memory pool")
    return begin, end


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


def body_pool(stream: torch.cuda.Stream):
    """A new memory pool for a graph's conditional bodies on `stream` (not
    the default stream), held (one use) until `release_pool`."""
    begin, end = _routing()
    pool, index = torch.cuda.graph_pool_handle(), _index(stream.device)
    with torch.cuda.stream(stream):
        begin(index, pool)  # makes the pool, with one use
        end(index, pool)
    return pool


def release_pool(device: torch.device, pool) -> None:
    """Drop `body_pool`'s use: the pool's memory goes back once free."""
    torch._C._cuda_releasePool(_index(device), pool)


def capture_nodes(stream: torch.cuda.Stream) -> int:
    """The top-level node count of the graph `stream` is capturing."""
    n = ctypes.c_int64()
    _check(_build.load(LIBRARY).tempest_capture_nodes(stream.cuda_stream, ctypes.byref(n)),
           "counting a graph's nodes")
    return n.value


@contextlib.contextmanager
def if_body(pred: torch.Tensor, pool, stream: torch.cuda.Stream) -> Iterator[List[int]]:
    """Inside a graph capture on the current stream: capture the block's
    work, on `stream` (made current), as the body of an IF node on `pred`.
    The list it yields gets the body's node count at the end."""
    if pred.dtype != torch.bool or pred.dim() != 0 or pred.device.type != "cuda":
        raise ValueError(f"a conditional node takes a 0-d CUDA bool, not {pred.dtype} "
                         f"{tuple(pred.shape)} on {pred.device}")
    begin, end = _routing()
    lib = _build.load(LIBRARY)
    index = _index(pred.device)
    parent = torch.cuda.current_stream(pred.device)
    _check(lib.tempest_if_begin(parent.cuda_stream, stream.cuda_stream, pred.data_ptr()),
           "making a CUDA-graph conditional node")
    global LAUNCHES
    LAUNCHES += 1
    nodes, n = [], ctypes.c_int64()
    try:
        with torch.cuda.stream(stream):
            begin(index, pool)
            try:
                yield nodes
            finally:
                end(index, pool)
                torch._C._cuda_releasePool(index, pool)
    except BaseException:
        lib.tempest_if_end(stream.cuda_stream, ctypes.byref(n))
        raise
    _check(lib.tempest_if_end(stream.cuda_stream, ctypes.byref(n)),
           "capturing a conditional node's body")
    nodes.append(n.value)
