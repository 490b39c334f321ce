"""Conditional IF and WHILE nodes of a CUDA graph, for `loops.Loops`.

JAX runs the hierarchical fit's split rounds as `lax.cond`s and a
`lax.while_loop` inside one device program (tempest_tpu/cluster.py:928-950),
and the adaptive MCMC chain as one `lax.while_loop` (tempest_tpu/mcmc.py:417).
A captured CUDA graph expresses such decisions as conditional nodes: an IF
node's body graph runs at a launch only where a device flag is nonzero, a
WHILE node's body graph runs for as long as its flag, set again at the end
of each run of the body, stays nonzero; so a replay decides on the device
and reads nothing. The PyTorch release the port runs on has no call that
makes one (later ones have `CUDAGraph.begin_capture_to_if_node`), so
`csrc/graph_cond.cu` makes them with the CUDA runtime (`tempest_cond_begin`,
`tempest_cond_end`, `tempest_capture_abort`, `tempest_capture_begin`,
`tempest_capture_discard`; design note there), built by
nvcc at first use and loaded with ctypes (`_build`). A body that holds no
conditional node is captured as a graph of its own and put into its node as
a child graph once its capture has ended well (`CHILD`); one that holds
nodes of its own is captured straight into its node's body graph
(`INTO_NODE`), as CUDA refuses a child graph that holds a conditional node.

`if_body(pred, pool, stream, route)` captures what runs inside it on
`stream` as the body of an IF node on the 0-d CUDA bool `pred`, placed after
the work the current stream has captured so far; `while_body(pred, pool,
stream, route)` as the body of a WHILE node, entered where `pred` holds and run again
where the body leaves `pred` true (the body writes its predicate into that
same tensor). The body's allocations go to
`pool` (PyTorch's allocator routing, as `torch.cuda.use_mem_pool` does):
a memory pool of the graph's bodies (`body_pool`), not the graph's own,
to which PyTorch already routes the capture stream and which it routes
only once. A nested body, on a stream of its own, takes a pool of its own
for the same reason. The pool keeps the bodies' memory for the replays
until `release_pool`; bodies that run one after another in one graph may
share it, as a body's temporaries die inside it. A refusal raises, naming
CUDA's error; nothing falls back. A body whose capture fails after it
began (a synchronizing call inside it, which PyTorch's sync check does not
always see) raises when its block ends, its own capture ended (each enclosing body's
block then ends its capture too, innermost first); `abort_capture` then ends
the enclosing capture without instantiating anything and puts PyTorch's
allocator routing and the graph's memory pool back, so the process lives
on (`loops.Loops` does this and raises `CaptureError`). PyTorch 2.11's
`CUDAGraph` has no call that abandons a capture, so the capture is ended
under it: the graph object is then left as `capture_end` never ran, which
its destructor takes as a capture that never ended (it releases nothing
and destroys no graph). Before that the process died: capturing a body
straight into its node's graph, CUDA 12.8 crashed in cudaStreamEndCapture
of the enclosing capture once the body's capture was invalidated
(`scripts/capture_probe.py`). With nodes nested, a raw cudaMalloc or
cudaDeviceSynchronize in an innermost body still kills the process, as the
enclosing bodies captured straight into their nodes are invalidated with it
(the probe's nested faults; neither comes from PyTorch's own calls), so
`loops.Loops` first captures each such body alone, outside any other
capture, and discards it (`alone`): the fault fails that capture alone.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Iterator, List, Sequence

import torch

from . import _build

_PTR = ctypes.c_void_p
LIBRARY = _build.CudaLibrary(
    "graph_cond.cu",
    {"tempest_cond_begin": [_PTR, _PTR, _PTR, ctypes.c_int, ctypes.c_int, _PTR, _PTR],
     "tempest_cond_end": [_PTR, _PTR, ctypes.c_uint64, _PTR, ctypes.c_int, ctypes.c_int, _PTR],
     "tempest_capture_abort": [_PTR, ctypes.c_int], "tempest_capture_nodes": [_PTR] * 2,
     "tempest_capture_begin": [_PTR], "tempest_capture_discard": [_PTR],
     "tempest_error_string": [ctypes.c_int, _PTR, ctypes.c_int64]},
)

# Launches of the one-thread kernel that sets a node's flag (`set_conditional`
# in the source): one a node a graph launch, and a WHILE node's one more
# each time its body runs. A capture counts each; `loops` puts them back and
# adds them again at every replay (a body's from its device word), as it
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


_IF, _WHILE = 0, 1
# How a body is captured: as a graph of its own, added to its node as a
# child graph (a body that holds no conditional node), or straight into the
# node's body graph (one that does).
CHILD, INTO_NODE = 0, 1


def _check_pred(pred: torch.Tensor) -> None:
    if pred.dtype != torch.bool or pred.dim() != 0 or pred.device.type != "cuda":
        raise ValueError(f"a conditional node takes a 0-d CUDA bool, not {pred.dtype} "
                         f"{tuple(pred.shape)} on {pred.device}")


@contextlib.contextmanager
def _cond_body(kind: int, pred: torch.Tensor, pool, stream: torch.cuda.Stream, route: int):
    """Inside a graph capture on the current stream: capture the block's
    work, on `stream` (made current), as the body of a conditional node of
    `kind` on `pred`, by `route`. Yields a record: its "handle", the node's,
    and at the end its "nodes", the body's node count. A body whose capture
    fails raises here with its capture ended; the enclosing capture is the
    caller's to abort (`abort_capture`)."""
    _check_pred(pred)
    begin, end = _routing()
    lib = _build.load(LIBRARY)
    index = _index(pred.device)
    parent = torch.cuda.current_stream(pred.device)
    handle, graph = ctypes.c_uint64(), ctypes.c_void_p()
    _check(lib.tempest_cond_begin(parent.cuda_stream, stream.cuda_stream, pred.data_ptr(), kind,
                                  route, ctypes.byref(handle), ctypes.byref(graph)),
           "making a CUDA-graph conditional node")
    record = {"handle": handle.value}
    global LAUNCHES
    LAUNCHES += 1
    n = ctypes.c_int64()
    try:
        with torch.cuda.stream(stream):
            begin(index, pool)
            try:
                yield record
            finally:
                end(index, pool)
                torch._C._cuda_releasePool(index, pool)
    except BaseException:
        lib.tempest_capture_abort(stream.cuda_stream, int(route == CHILD))
        raise
    _check(lib.tempest_cond_end(stream.cuda_stream, graph, handle, pred.data_ptr(), kind, route,
                                ctypes.byref(n)),
           "capturing a conditional node's body")
    record["nodes"] = n.value


@contextlib.contextmanager
def if_body(pred: torch.Tensor, pool, stream: torch.cuda.Stream,
            route: int = CHILD) -> Iterator[List[int]]:
    """Inside a graph capture on the current stream: capture the block's
    work, on `stream` (made current), as the body of an IF node on `pred`,
    by `route`. The list it yields gets the body's node count at the end."""
    nodes: List[int] = []
    with _cond_body(_IF, pred, pool, stream, route) as record:
        yield nodes
    nodes.append(record["nodes"])


@contextlib.contextmanager
def while_body(pred: torch.Tensor, pool, stream: torch.cuda.Stream,
               route: int = CHILD) -> Iterator[List[int]]:
    """Inside a graph capture on the current stream: capture the block's
    work, on `stream` (made current), by `route`, as the body of a WHILE
    node on `pred`:
    the body runs where `pred` holds when the node is reached, and again
    for as long as the block leaves `pred` (the same tensor) true, which
    a flag kernel placed after the block's work reads. The list it yields
    gets the body's node count at the end, that kernel included."""
    global LAUNCHES
    nodes: List[int] = []
    with _cond_body(_WHILE, pred, pool, stream, route) as record:
        yield nodes
        LAUNCHES += 1  # the flag kernel after the body's work
    nodes.append(record["nodes"])


@contextlib.contextmanager
def alone(pool, stream: torch.cuda.Stream) -> Iterator[None]:
    """Outside any other capture: capture the block's work on `stream`
    (made current) as a graph of its own, its allocations routed to `pool`
    (`body_pool`), and discard the graph, instantiating nothing: a trial of
    a conditional body. A capture that fails (a synchronizing call or a raw
    cudaMalloc inside it, which PyTorch's sync check does not see) raises,
    its capture ended; it fails alone, as no other capture is open."""
    begin, end = _routing()
    lib = _build.load(LIBRARY)
    index = _index(stream.device)
    _check(lib.tempest_capture_begin(stream.cuda_stream), "beginning a body's capture alone")
    try:
        with torch.cuda.stream(stream):
            begin(index, pool)
            try:
                yield
            finally:
                end(index, pool)
                torch._C._cuda_releasePool(index, pool)
    except BaseException:
        lib.tempest_capture_abort(stream.cuda_stream, 1)
        raise
    _check(lib.tempest_capture_discard(stream.cuda_stream), "capturing a body alone")


def abort_capture(graph: torch.cuda.CUDAGraph, stream: torch.cuda.Stream,
                  body_streams: Sequence[torch.cuda.Stream] = ()) -> None:
    """Abandon the capture `graph` began on `stream` after a failure (a
    conditional body's, or any other): end the captures of `body_streams`
    (by depth, the deepest ended first; a failed body has ended its own
    already) and of `stream` whatever their states, destroy the graph
    `stream` gives back, instantiate nothing, end PyTorch's routing of
    `stream`'s allocations to the graph's memory pool and drop the
    capture's use of that pool. PyTorch's
    `capture_end` is not called, so dropping `graph` ends nothing twice. The
    registered generators stay in capture mode: the caller takes them out
    (`loops.Loops._repair_generators`)."""
    lib = _build.load(LIBRARY)
    for body in reversed(list(body_streams)):  # a body's graph is its node's
        _check(lib.tempest_capture_abort(body.cuda_stream, 0), "aborting a body's capture")
    _check(lib.tempest_capture_abort(stream.cuda_stream, 1), "aborting a CUDA-graph capture")
    _, end = _routing()
    index = _index(stream.device)
    try:
        end(index, graph.pool())
    except RuntimeError:  # capture_end ran far enough to end the routing and keep the pool
        return
    torch._C._cuda_releasePool(index, graph.pool())
