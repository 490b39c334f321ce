"""The ESS-mode temperature bisection: a CUDA kernel and its plain version.

Counterpart of tempest_tpu/ops/pallas_reweight.py, whose Pallas kernel
(`_kernel`, :55-111) runs the whole bisection in one TPU launch. Here the
bisection is the CUDA kernel in `csrc/ess_bisect.cu` (design note at the
top of that file), built with nvcc for sm_90a at first use and bound with
ctypes. It needs a Hopper card: one launch runs the whole bisection on one
thread-block cluster of `ESS_CLUSTER` = 16 CTAs (a non-portable cluster
size) of `ESS_THREADS[dtype]` threads, 1024 in float32 and 512 in float64
(whose state needs 128 registers a thread), each CTA owning one contiguous
slice of the S samples, with one cluster barrier per pass and no host
sync. The kernel is a template on its scalar type: `tempest_ess_bisect` runs float32 and
`tempest_ess_bisect_f64` float64 (the port's dtype=torch.float64 path,
where JAX runs XLA's float64 bisection). `plan_launch` picks the route by S
and the dtype: while a slice fits the shared memory, `ESS_SLICE_MAX`
float32 samples or half as many float64 ones (S <= 393,216 or 196,608),
each CTA holds its slice there, loaded and masked once; past that every
pass streams the slices from L2.

Both versions compute, for x = beta * logl - Bm,

    ESS(beta) = s1^2 / s2,  s1 = sum exp(x - m),  s2 = sum exp(2(x - m)),

stay at beta_prev when ESS(beta_prev) <= target, jump to 1 when
ESS(1) >= target, and otherwise bisect on [beta_prev, 1] with the dual
tolerance and the 200-probe cap of steps/reweight._find_beta_bisection.
One deliberate difference from the Pallas kernel: x is -inf wherever logl
is not finite or Bm is +inf, as in state.logw_from_denominator
(tempest_tpu/state.py:392-394). The Pallas kernel computes 0 * -inf = NaN
there at beta = 0, which makes ESS(0) NaN and skips the "stay" rule.

The same source has a bracket mode for dynamic mode, `ess_bracket` (C
entries `tempest_ess_bracket`, `tempest_ess_bracket_f64`): the bracket
search of tempest_tpu/steps/reweight.py:73-119 (stay, jump, or [beta_prev,
1] bisected on the interval tolerance alone). It returns (lo, hi) and its
probe count. It has a body of its own in the same launch shape (one
cluster of 16 CTAs on the route `plan_launch` picks by S, of
`BRACKET_THREADS` threads where the samples are held on chip): the
samples dealt out to the CTAs by chunks of 128, masked quads skipped,
each probe's partials pushed into every CTA's shared memory with
`st.async` on an mbarrier instead of a cluster barrier (design note in
the source). Its plain version is the "ess_bracket" device loop that
dynamic mode runs on the CPU and under a mesh
(`steps.reweight.ess_bracket_loop`), so the bracket's rules have one
PyTorch implementation.

`ess_bisect_beta` and `ess_bracket` pick their route only by the tensors'
device: CPU tensors go to the plain version, contiguous CUDA tensors of
float32 or float64 to the kernel of their type, anything else raises. A
failed build, a cluster that does not fit the card or a failed launch
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..config import (
    BETA_RTOL,
    BETA_TOLERANCE,
    ESS_TOLERANCE,
    MAX_BISECTION_ITERATIONS,
    METRIC_ATOL,
)
from . import _build
from .tools import ess_from_logw, logsumexp

_SIGNATURE = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
ENTRIES = {torch.float32: "tempest_ess_bisect", torch.float64: "tempest_ess_bisect_f64"}
BRACKET_ENTRIES = {torch.float32: "tempest_ess_bracket", torch.float64: "tempest_ess_bracket_f64"}
LIBRARY = _build.CudaLibrary(
    "ess_bisect.cu", {name: _SIGNATURE for name in (*ENTRIES.values(), *BRACKET_ENTRIES.values())}
)

# Kernel launches made by `ess_bisect_beta` in this process: float32 and
# float64 instantiations; and by `ess_bracket` (both types).
LAUNCHES = 0
LAUNCHES_F64 = 0
BRACKET_LAUNCHES = 0

ESS_CLUSTER = 16  # CTAs in the cluster: csrc kCluster
ESS_SLICE_MAX = 24576  # float32 samples a CTA holds in shared memory (192 KB): csrc kSliceMax
# Threads a CTA, by dtype: csrc kThreadsF32, kThreadsF64 (the kernel sets its
# own; the plan reports them). The bracket mode takes BRACKET_THREADS on the
# resident route (csrc kBracketThreads) and these on the streamed one.
ESS_THREADS = {torch.float32: 1024, torch.float64: 512}
BRACKET_THREADS = 512


class LaunchPlan(NamedTuple):
    cluster: int  # CTAs, one slice each
    slice: int  # samples per CTA, a multiple of 4
    resident: bool  # slice held in shared memory (else streamed from L2)
    threads: int  # threads a CTA


def slice_max(dtype=torch.float32) -> int:
    """Samples of `dtype` a CTA holds in shared memory: 192 KB for logl and Bm."""
    return ESS_SLICE_MAX * 4 // dtype.itemsize


def plan_launch(n: int, dtype=torch.float32) -> LaunchPlan:
    """The launch of the ESS kernel for S = n samples of `dtype`: the route
    by S and the dtype only (the bracket mode's too, whose CTA on the
    resident route has BRACKET_THREADS)."""
    per_cta = -(-n // ESS_CLUSTER)
    slice_ = max(4, -(-per_cta // 4) * 4)
    return LaunchPlan(ESS_CLUSTER, slice_, slice_ <= slice_max(dtype), ESS_THREADS[dtype])


# ---------------------------------------------------------------------------
# Plain PyTorch version: the XLA path's semantics
# (tempest_tpu/steps/reweight.py:122-166, 214-224).
# ---------------------------------------------------------------------------
def _interval_tol(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(torch.maximum(lo.abs(), hi.abs()), min=torch.finfo(lo.dtype).tiny)
    return torch.maximum(BETA_RTOL * scale, BETA_TOLERANCE * scale)


def ess_bisect_beta_reference(
    logl: torch.Tensor, bm: torch.Tensor, scal: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next beta for ESS mode, in plain PyTorch.

    logl: (S,) log-likelihoods; bm: (S,) masked MIS denominator (+inf on
    invalid slots); scal: (2,) = (beta_prev, target). Returns the (1,)
    beta in the inputs' dtype and the (1,) int32 count of ESS evaluations.
    """
    keep = torch.isfinite(logl) & (bm != float("inf"))
    neg_inf = torch.full_like(logl, float("-inf"))
    beta_prev, target = scal[0], scal[1]
    one = torch.ones((), dtype=logl.dtype, device=logl.device)

    def ess_at(beta):
        logw = torch.where(keep, beta * logl - bm, neg_inf)
        return ess_from_logw(logw - logsumexp(logw))

    ess_cur = ess_at(beta_prev)
    ess_one = ess_at(one)
    probes = 2
    if bool(ess_cur <= target):
        beta = beta_prev
    elif bool(ess_one >= target):
        beta = one
    else:
        lo, hi = beta_prev, one
        atol = max(ESS_TOLERANCE * abs(float(target)), METRIC_ATOL)
        for _ in range(MAX_BISECTION_ITERATIONS):
            beta = 0.5 * (lo + hi)
            metric = ess_at(beta)
            probes += 1
            metric = torch.where(torch.isfinite(metric), metric, torch.full_like(metric, 1e10))
            done = (
                bool(torch.abs(metric - target) < atol)
                or bool((hi - lo) < _interval_tol(lo, hi))
                or bool(beta == 1.0)
            )
            if done:
                break
            if bool(metric >= target):  # ESS decreases with beta
                lo = beta
            else:
                hi = beta
    return (
        beta.reshape(1).to(logl.dtype),
        torch.full((1,), probes, dtype=torch.int32, device=logl.device),
    )


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------
def ess_bisect_beta(
    logl: torch.Tensor, bm: torch.Tensor, scal: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next beta for ESS mode: (beta (1,) of the inputs' dtype, ESS
    evaluations (1,) i32).

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream without a host sync (scal stays on the device).
    """
    if _route("ess_bisect_beta", logl, bm, scal) == "cpu":
        return ess_bisect_beta_reference(logl, bm, scal)
    return _launch(logl, bm, scal, bracket=False)


def ess_bracket(
    logl: torch.Tensor, bm: torch.Tensor, scal: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic mode's ESS bracket: ((lo, hi) (2,) of the inputs' dtype, ESS
    evaluations (1,) i32), as `steps.reweight.ess_bracket_loop`.

    CPU tensors take that plain version; CUDA tensors launch the kernel's
    bracket mode on the current stream without a host sync (scal stays on
    the device).
    """
    if _route("ess_bracket", logl, bm, scal) == "cpu":
        from ..steps.reweight import ess_bracket_loop  # steps.reweight imports this module

        return ess_bracket_loop(logl, bm, scal)
    return _launch(logl, bm, scal, bracket=True)


def _route(what: str, logl, bm, scal) -> str:
    """The device type the inputs take, after the checks; raises on what
    neither route takes."""
    device = logl.device
    if bm.device != device or scal.device != device:
        raise ValueError(
            f"logl, bm and scal must share one device (got {device}, {bm.device}, {scal.device})"
        )
    if device.type == "cpu":
        return "cpu"
    if device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {device}")
    if logl.dtype not in ENTRIES:
        raise ValueError(f"{what} runs float32 or float64 tensors, not {logl.dtype}")
    for name, t in (("logl", logl), ("bm", bm), ("scal", scal)):
        if t.dtype != logl.dtype or not t.is_contiguous() or t.dim() != 1:
            raise ValueError(
                f"{name} must be a contiguous 1-D {logl.dtype} tensor "
                f"(got {t.dtype}, shape {tuple(t.shape)}, contiguous={t.is_contiguous()})"
            )
    if bm.shape != logl.shape or logl.numel() == 0 or scal.numel() != 2:
        raise ValueError(
            f"need logl and bm of one shape (S,) with S > 0 and scal of shape (2,); "
            f"got {tuple(logl.shape)}, {tuple(bm.shape)}, {tuple(scal.shape)}"
        )
    return "cuda"


def _launch(logl, bm, scal, bracket: bool):
    global LAUNCHES, LAUNCHES_F64, BRACKET_LAUNCHES
    if logl.device.index != torch.cuda.current_device():  # the C entry launches on the current one
        with torch.cuda.device(logl.device):
            return _launch(logl, bm, scal, bracket)
    entry = getattr(_build.load(LIBRARY), (BRACKET_ENTRIES if bracket else ENTRIES)[logl.dtype])
    plan = plan_launch(logl.numel(), logl.dtype)
    out = torch.empty(2 if bracket else 1, dtype=logl.dtype, device=logl.device)
    probes = torch.empty(1, dtype=torch.int32, device=logl.device)
    err = entry(
        logl.data_ptr(), bm.data_ptr(), scal.data_ptr(), out.data_ptr(), probes.data_ptr(),
        logl.numel(), plan.slice, int(plan.resident),
        torch.cuda.current_stream(logl.device).cuda_stream,
    )
    _build.check(err, "ess_bracket" if bracket else "ess_bisect")
    if bracket:
        BRACKET_LAUNCHES += 1
    elif logl.dtype == torch.float64:
        LAUNCHES_F64 += 1
    else:
        LAUNCHES += 1
    return out, probes
