"""The host-call kernel: a host function called from inside a CUDA graph.

JAX runs a host likelihood inside its one device program through a host
callback (tempest_tpu/utils/wrappers.py:88-131). A CUDA graph's conditional
bodies take kernel nodes and not host nodes, so here the call is a kernel
that hands the points to the host through a mailbox in mapped pinned
memory and waits for the reply (`csrc/host_call.cu`, design note there),
and the host thread that replays the graph serves it (`served`). Its plain
version, the route of CPU tensors, is `utils.wrappers.HostLikelihood.plain`:
a blocking read of the points, the call, a copy back.

`Mailbox(n, d, x_dtype, blob_width, blob_dtype, device, fn, failed)`
allocates one mailbox for points of shape (n, d) (kept for its owner's
life; freed when it is collected): its header, points, logl and blob-row
regions as numpy views, and two device words, the request count and the
word `failed` is given. `Mailbox.launch` launches the kernel on the current
stream (inside a capture it becomes two kernel nodes); `served(launch,
boxes)` runs `launch()` and serves the boxes' requests on this thread until
the work it queued has finished, then raises the first exception a host
function raised. `round_trip_ms(device)` is the link's round trip alone,
the bound's latency: a kernel's exchanges with a host C thread on mapped
memory, no Python in the loop. A failed build or launch raises; nothing
falls back.

A host function gets a read-only copy of the points, as JAX's callback
gets read-only arrays that it may keep: a point it keeps does not change
when the next request overwrites the mailbox.
"""

from __future__ import annotations

import ctypes
import gc
import time
import weakref
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from . import _build

_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64
LIBRARY = _build.CudaLibrary(
    "host_call.cu",
    {"tempest_host_alloc": [_I64, _PTR, _PTR], "tempest_host_free": [_PTR],
     "tempest_host_call": [_PTR, _PTR, _PTR, _I64, _PTR, _I64, _I64, _I64, _PTR, ctypes.c_int,
                           _I64, _PTR, _I64, _PTR, _PTR, _PTR],
     "tempest_host_pingpong": [ctypes.c_int, _PTR]},
)

# Launches of the host-call kernel in this process (one a call: its two
# kernels, which return at once where the step is inactive), and the
# requests the host served (`Mailbox.serve`: one an active call).
LAUNCHES = 0
HANDSHAKES = 0

# The header: the request sequence (device) at byte 0, the reply sequence
# (host) at 64 and the status (host) at 72; the regions start at multiples of
# 128 bytes.
_HEADER, _REPLY, _STATUS, _ALIGN = 128, 64, 72, 128
# The status a host function that raised leaves.
ABORT = 1
# The device stamps' ring (`csrc/host_call.cu` kRing): four a request.
STAMP_RING = 64


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


class Mailbox:
    """One mailbox of (n, d) points of numpy type `x_dtype`, logl (n,)
    float32 and (n, `blob_width`) blob rows of numpy type `blob_dtype` (none
    where the width is 0), on CUDA device `device`; `fn(points) -> (logl,
    rows or None)` is the host function its requests call, on a read-only
    copy of the points. `failed` is the int32 device word (one element) the
    kernel sets where `fn` raised. `stamps=True` records each request's
    device marks (`csrc/host_call.cu`) in `stamps` and its host marks
    (perf_counter_ns: request seen, `fn` entered, `fn` returned, reply
    written) in `host_stamps`."""

    def __init__(self, n: int, d: int, x_dtype, blob_width: int, blob_dtype, device,
                 fn: Callable, failed: torch.Tensor, stamps: bool = False):
        self.n, self.d, self.fn, self.failed = n, d, fn, failed
        self.device = torch.device(device)
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.x_dtype, self.blob_dtype = np.dtype(x_dtype), np.dtype(blob_dtype)
        self.x_bytes = n * d * self.x_dtype.itemsize
        if self.x_bytes % 4:
            raise ValueError(f"the host call takes points of 4 or 8 bytes, not {self.x_dtype}")
        self.blob_bytes = n * blob_width * self.blob_dtype.itemsize
        self.x_offset = _HEADER
        self.logl_offset = self.x_offset + _aligned(self.x_bytes)
        self.blobs_offset = self.logl_offset + _aligned(4 * n)
        total = self.blobs_offset + _aligned(max(self.blob_bytes, 1))
        lib = _build.load(LIBRARY)
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(self.device):
            _check(lib.tempest_host_alloc(total, ctypes.byref(host), ctypes.byref(dev)),
                   "allocating a host-call mailbox")
        self.address = dev.value
        weakref.finalize(self, lib.tempest_host_free, host.value)
        raw = np.ctypeslib.as_array((ctypes.c_uint8 * total).from_address(host.value))
        self.header = raw[:_HEADER].view(np.uint64)
        self.status = raw[_STATUS:_STATUS + 4].view(np.int32)
        self.x = raw[self.x_offset:self.x_offset + self.x_bytes].view(self.x_dtype).reshape(n, d)
        self.logl = raw[self.logl_offset:self.logl_offset + 4 * n].view(np.float32)
        self.blobs = (raw[self.blobs_offset:self.blobs_offset + self.blob_bytes]
                      .view(self.blob_dtype).reshape(n, blob_width) if self.blob_bytes else None)
        # requests made, and the post's CTAs arrived (csrc/host_call.cu)
        self.counter = torch.zeros(2, dtype=torch.int64, device=self.device)
        self.stamps = (torch.zeros(4 * STAMP_RING, dtype=torch.int64, device=self.device)
                       if stamps else None)
        self.host_stamps: Optional[List[tuple]] = [] if stamps else None
        self.error: Optional[BaseException] = None

    def launch(self, x: torch.Tensor, active: Optional[torch.Tensor], logl: torch.Tensor,
               blobs: Optional[torch.Tensor]) -> None:
        """The kernel on the current stream: `x` (n, d) out to the host
        where the one-element device bool `active` holds (None: always), the
        reply into `logl` (n,) float32 or float64 and `blobs` (n, B), which
        the caller made (and filled with what an inactive step keeps)."""
        global LAUNCHES
        if x.shape != (self.n, self.d) or x.device != self.device or not x.is_contiguous():
            raise ValueError(f"the mailbox takes contiguous ({self.n}, {self.d}) points on "
                             f"{self.device}, not {tuple(x.shape)} on {x.device}")
        if active is not None and (active.dtype != torch.bool or active.numel() != 1):
            raise ValueError("active must be one device bool")
        if logl.dtype not in (torch.float32, torch.float64) or logl.shape != (self.n,):
            raise ValueError(f"logl must be ({self.n},) float32 or float64, not "
                             f"{tuple(logl.shape)} {logl.dtype}")
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = _build.load(LIBRARY).tempest_host_call(
            stream, None if active is None else active.data_ptr(), x.data_ptr(), self.x_bytes,
            self.address, self.x_offset, self.logl_offset, self.blobs_offset, logl.data_ptr(),
            int(logl.dtype == torch.float64), self.n, None if blobs is None else blobs.data_ptr(),
            self.blob_bytes, self.counter.data_ptr(), self.failed.data_ptr(),
            None if self.stamps is None else self.stamps.data_ptr())
        _build.check(err, "host_call")
        LAUNCHES += 1

    def pending(self) -> bool:
        """Whether the device waits for a reply."""
        return self.header[0] != self.header[_REPLY // 8]

    def serve(self) -> None:
        """Answer the pending request: `fn` on a read-only copy of the
        points, its logl and blob rows written, then the status and the
        reply sequence; after an exception (kept in `error`) every request
        is answered with the abort status and no call."""
        global HANDSHAKES
        HANDSHAKES += 1
        seen = time.perf_counter_ns()
        seq = self.header[0]
        status, entered, returned = ABORT, seen, seen
        if self.error is None:
            try:
                points = self.x.copy()
                points.flags.writeable = False
                entered = time.perf_counter_ns()
                logl, rows = self.fn(points)
                returned = time.perf_counter_ns()
                self.logl[:] = logl
                if self.blobs is not None:
                    self.blobs[:] = rows
                status = 0
            except BaseException as exc:  # re-raised by `served` once the work ends
                self.error = exc
        self.status[0] = status
        self.header[_REPLY // 8] = seq
        if self.host_stamps is not None:
            self.host_stamps.append((int(seq), seen, entered, returned, time.perf_counter_ns()))


def serve_until_done(finished: Callable[[], bool], boxes: List[Mailbox],
                     stopped: Optional[BaseException] = None) -> Optional[BaseException]:
    """Serve the requests of `boxes` as they come until `finished()` holds
    on a turn that found none pending, and return the first exception that
    broke in (`stopped`, else an interrupt here): after it, every box
    answers with the abort status."""
    while True:
        try:
            busy = False
            for box in boxes:
                if box.pending():
                    box.serve()
                    busy = True
            if not busy and finished():
                return stopped
        except BaseException as exc:  # an interrupt: answer the rest with the abort status
            stopped = stopped or exc
            for box in boxes:
                box.error = box.error or exc


def served(launch: Callable[[], None], boxes: Iterable[Mailbox]) -> None:
    """`launch()` (work queued on the current stream, a graph replay), with
    the requests of `boxes` served on this thread until that work has
    finished (an event's query, `serve_until_done`); each box's `failed`
    word is set to 0 on the stream first. Makes no blocking CUDA call
    meanwhile, and `launch` must make none after it queues a host call: not
    even a new CUDA allocation, which waits for the device (the caller makes
    its tensors first). Raises the first exception a host function raised
    (after the work has finished)."""
    boxes = list(dict.fromkeys(boxes))
    for box in boxes:
        box.error = None
        box.failed.zero_()
    stopped: Optional[BaseException] = None
    # No cyclic garbage collection meanwhile: a collected mailbox's
    # cudaFreeHost would wait for the device, which waits for this thread.
    collecting = gc.isenabled()
    gc.disable()
    try:
        try:
            launch()
        except BaseException as exc:  # what it queued before it raised still waits for replies
            stopped = exc
        done = torch.cuda.Event()
        done.record()
        stopped = serve_until_done(done.query, boxes, stopped)
    finally:
        if collecting:
            gc.enable()
    errors = [box.error for box in boxes if box.error is not None]
    for box in boxes:
        box.error = None
    if stopped is not None:
        raise stopped
    if errors:
        raise errors[0]


def round_trip_ms(device, rounds: int = 1000) -> float:
    """Device ms of one exchange of the handshake's protocol between a
    kernel and a host C thread spinning on mapped memory (the mean of
    `rounds` in one launch, by CUDA events): the link's round trip."""
    ms = ctypes.c_float()
    with torch.cuda.device(torch.device(device)):
        _check(_build.load(LIBRARY).tempest_host_pingpong(rounds, ctypes.byref(ms)),
               "the host link's ping-pong")
    return float(ms.value)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")
