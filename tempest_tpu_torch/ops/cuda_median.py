"""The per-column weighted median: a CUDA kernel and its plain version.

Every weighted Student-t fit (`student.fit_mvstud_weighted_modes`) starts
from the weighted median of each column of its points, given their stable
column sort. The JAX package leaves this to XLA
(tempest_tpu/student.py:220-231); there is no Pallas kernel to port. Its
plain PyTorch version is a cumulative sum along the points, a first
crossing and a gather. On a CUDA tensor that `torch.cumsum` scans each
column in one thread that waits for every gathered load in turn: at the
large-ensemble fit's n = 524,288 points it took most of an iteration's
device time (PERF.md). A CUDA tensor goes to `csrc/weighted_median.cu`
(design note at the top of that file), which gives the plain version's
bits: it adds each column's nonzero weights in the same serial order in
the same type, and a zero weight leaves a running sum bit for bit as it
was (the argument is in the source; tests/test_torch_median.py checks it
on the plain version).

`weighted_median_presorted` picks its route only by the tensors' device:
CPU tensors go to the plain version, contiguous CUDA tensors of float32 or
float64 (order int64) to the kernel of their type, anything else raises.
A failed build or launch raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [ctypes.c_double, ctypes.c_void_p]
LIBRARY = _build.CudaLibrary(
    "weighted_median.cu",
    {"tempest_weighted_median": _SIGNATURE, "tempest_weighted_median_f64": _SIGNATURE},
)
ENTRIES = {torch.float32: "tempest_weighted_median", torch.float64: "tempest_weighted_median_f64"}

# Kernel launches made by `weighted_median_presorted` in this process (both types).
LAUNCHES = 0

# The first cumulative weight at or above this is the median's.
THRESHOLD = 0.5 - 1e-7
# As PyTorch compares it with a tensor of each type: rounded to the type.
_THRESHOLDS = {dtype: torch.tensor(THRESHOLD, dtype=dtype).item() for dtype in ENTRIES}


def weighted_median_presorted_reference(
    d_sorted: torch.Tensor, order: torch.Tensor, wbar: torch.Tensor
) -> torch.Tensor:
    """Per-column weighted median in plain PyTorch: `d_sorted`, `order` (n, d)
    the stable column sort of the data, `wbar` (n,) or (K, n) the weights;
    (d,) or (K, d)."""
    cum = torch.cumsum(wbar[..., order], dim=-2)  # (..., n, d), along the points
    idx = torch.argmax((cum >= THRESHOLD).to(torch.int8), dim=-2)  # first True, else 0
    return torch.gather(d_sorted.expand(cum.shape), -2, idx.unsqueeze(-2)).squeeze(-2)


def weighted_median_presorted(
    d_sorted: torch.Tensor, order: torch.Tensor, wbar: torch.Tensor
) -> torch.Tensor:
    """Per-column weighted median (d,) or (K, d) of the points whose stable
    column sort is (`d_sorted`, `order`) (n, d), under weights `wbar` (n,)
    or (K, n).

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream without a host sync."""
    device = d_sorted.device
    if order.device != device or wbar.device != device:
        raise ValueError(f"d_sorted, order and wbar must share one device (got {device}, "
                         f"{order.device}, {wbar.device})")
    if device.type == "cpu":
        return weighted_median_presorted_reference(d_sorted, order, wbar)
    if device.type != "cuda":
        raise ValueError(f"weighted_median_presorted runs on cpu or cuda tensors, not {device}")
    if d_sorted.dtype not in ENTRIES or wbar.dtype != d_sorted.dtype or order.dtype != torch.int64:
        raise ValueError(f"weighted_median_presorted runs float32 or float64 data and weights "
                         f"with int64 order, not {d_sorted.dtype}, {wbar.dtype}, {order.dtype}")
    if (d_sorted.dim() != 2 or order.shape != d_sorted.shape or wbar.dim() not in (1, 2)
            or wbar.shape[-1] != d_sorted.shape[0] or d_sorted.numel() == 0 or wbar.numel() == 0):
        raise ValueError(f"need d_sorted and order of one shape (n, d) with n, d > 0 and wbar of "
                         f"shape (n,) or (K, n); got {tuple(d_sorted.shape)}, "
                         f"{tuple(order.shape)}, {tuple(wbar.shape)}")
    for name, t in (("d_sorted", d_sorted), ("order", order), ("wbar", wbar)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    mu = _launch(d_sorted, order, wbar.reshape(-1, d_sorted.shape[0]))
    return mu if wbar.dim() == 2 else mu[0]


def _launch(d_sorted, order, wbar):
    global LAUNCHES
    if d_sorted.device.index != torch.cuda.current_device():  # the C entry launches there
        with torch.cuda.device(d_sorted.device):
            return _launch(d_sorted, order, wbar)
    entry = getattr(_build.load(LIBRARY), ENTRIES[d_sorted.dtype])
    (n, d), k = d_sorted.shape, wbar.shape[0]
    mu = torch.empty((k, d), dtype=d_sorted.dtype, device=d_sorted.device)
    stream = torch.cuda.current_stream(d_sorted.device).cuda_stream
    err = entry(d_sorted.data_ptr(), order.data_ptr(), wbar.data_ptr(), mu.data_ptr(), n, d, k,
                _THRESHOLDS[d_sorted.dtype], stream)
    _build.check(err, "weighted_median")
    LAUNCHES += 1
    return mu
