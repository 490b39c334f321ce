"""The fits' two EM loops as CUDA kernels, one launch a loop.

JAX runs both EM loops of a fit as `lax.while_loop`s on the device, with no
host read: the GMM EM of the leaf fits (tempest_tpu/cluster.py:256, vmapped
over the leaves and starts) and the weighted Student-t EM of the mode fits
(tempest_tpu/student.py:323, vmapped over the modes by modes.py:145). The
port's plain versions are device loops of `loops.run_loop`: "gmm_em"
(`cluster._gmm_em_body`) and "mode_em" (`student._em_body`), each body a few
dozen small launches and each chunk of bodies one blocking host read. On a
CUDA tensor each loop is instead one launch of a hand-written kernel that
runs the loop itself (design notes at the top of the sources):

- `gmm_em`: `csrc/gmm_em.cu` (`tempest_gmm_em`, `_f64`), a batch of fits of
  any covariance type;
- `mvstud_em`: `csrc/mvstud_em.cu` (`tempest_mvstud_em`, `_f64`), K
  weightings of the same points.

Both take the loop's carry at its start and return it at the loop's end,
with "go" False. Their inputs that change between calls (the carry, the
tolerance and `max_iter`) are device tensors, so `loops.Loops.once` can
hold a launch in a CUDA graph. They take contiguous CUDA tensors of
float32 or float64 (int32 counts, bool flags) and raise on anything else;
a failed build or launch raises; nothing falls back. The callers pick the
route with `kernel_route`: CPU tensors go to the plain loop, CUDA tensors
to the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build

Tensors = Dict[str, torch.Tensor]

_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64
_GMM_SIGNATURE = [_PTR] * 13 + [_I64] * 5 + [ctypes.c_double, _PTR]
_MVSTUD_SIGNATURE = [_PTR] * 14 + [_I64] * 3 + [_PTR]
_HEADERS = ("em_common.cuh", "em_stamps.cuh")
GMM_LIBRARY = _build.CudaLibrary(
    "gmm_em.cu",
    {"tempest_gmm_em": _GMM_SIGNATURE, "tempest_gmm_em_f64": _GMM_SIGNATURE,
     "tempest_gmm_em_plan": [_I64] * 6 + [_PTR]},
    headers=_HEADERS,
)
MVSTUD_LIBRARY = _build.CudaLibrary(
    "mvstud_em.cu",
    {"tempest_mvstud_em": _MVSTUD_SIGNATURE, "tempest_mvstud_em_f64": _MVSTUD_SIGNATURE,
     "tempest_mvstud_em_plan": [_I64] * 4 + [_PTR]},
    headers=_HEADERS,
)
GMM_ENTRIES = {torch.float32: "tempest_gmm_em", torch.float64: "tempest_gmm_em_f64"}
MVSTUD_ENTRIES = {torch.float32: "tempest_mvstud_em", torch.float64: "tempest_mvstud_em_f64"}
COVARIANCE_CODES = {"full": 0, "tied": 1, "diag": 2, "spherical": 3}

# Kernel launches in this process, by kernel (both types each).
LAUNCHES = {"gmm_em": 0, "mvstud_em": 0}

# The plan's fields (csrc `tempest_gmm_em_plan`, `tempest_mvstud_em_plan`):
# CTAs a fit, the cluster size (1 where one fit takes the grid), whether it
# does (a cooperative launch), threads a CTA, shared memory bytes, whether
# the work area, the points and their per-point values lie in shared memory,
# the work area's elements, a CTA's points at most, the partials a CTA and
# reduction, then the scratch buffers' elements: per-point values, partials,
# global work area.
PLAN_FIELDS = ("ctas", "cluster", "grid", "threads", "smem", "work_in_smem", "work_elems",
               "x_resident", "points_resident", "points", "emax", "scratch", "part",
               "work_global")


def kernel_route(*tensors: torch.Tensor) -> bool:
    """Whether these tensors take a kernel (CUDA) or the plain loop (CPU);
    they must share one device, and any other device raises."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"the EM's tensors must share one device, got {device} and "
                             f"{t.device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the EM loops run on cpu or cuda tensors, not {device}")
    return device.type == "cuda"


def _check(what: str, tensors: Tensors, dtypes: Dict[str, torch.dtype],
           shapes: Dict[str, tuple]) -> None:
    """Type, shape and layout first (so a CPU test reaches them), the device last."""
    for name, t in tensors.items():
        if t.dtype != dtypes[name]:
            raise ValueError(f"{what}: {name} must be {dtypes[name]}, not {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{what}: {name} must have shape {shapes[name]}, "
                             f"not {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    device = next(iter(tensors.values())).device
    if device.type != "cuda" or any(t.device != device for t in tensors.values()):
        raise ValueError(f"{what} runs on CUDA tensors of one device, got "
                         f"{sorted({str(t.device) for t in tensors.values()})}")


def plan(library: _build.CudaLibrary, *args: int) -> Dict[str, int]:
    """A kernel's launch plan (`PLAN_FIELDS`) from its C plan entry."""
    entry = "tempest_gmm_em_plan" if library is GMM_LIBRARY else "tempest_mvstud_em_plan"
    out = (ctypes.c_int64 * len(PLAN_FIELDS))()
    _build.check(getattr(_build.load(library), entry)(*args, ctypes.addressof(out)), entry)
    return dict(zip(PLAN_FIELDS, out))


def _scratch(p: Dict[str, int], dtype, device):
    """The scratch buffers of a plan: per-point values, partials and work
    area; None where the plan has none."""
    def empty(key):
        return torch.empty(p[key], dtype=dtype, device=device) if p[key] else None

    return empty("scratch"), empty("part"), empty("work_global")


def _ptr(t) -> int:
    return None if t is None else t.data_ptr()


def gmm_em(X: torch.Tensor, sw: torch.Tensor, carry: Tensors, tol: torch.Tensor,
           max_iter: torch.Tensor, reg_covar: float, covariance_type: str) -> Tensors:
    """The GMM EM loop of `cluster._gmm_em` in one launch: X (B, n, d), sw
    (B, n) normalized weights, the carry pi (B, K), means (B, K, d), covs
    (B, K, d, d), lb (B,), n_iter (B,) int32 and done (B,) bool at the
    loop's start; tol (the type) and max_iter (int32) 0-d tensors. Returns
    the carry after the loop, with go False, on the current stream without
    a host sync."""
    if X.dtype not in GMM_ENTRIES:
        raise ValueError(f"gmm_em runs float32 or float64 data, not {X.dtype}")
    if covariance_type not in COVARIANCE_CODES:
        raise ValueError(f"Unknown covariance_type {covariance_type}")
    if X.dim() != 3 or carry["means"].dim() != 3 or 0 in X.shape:
        raise ValueError(f"gmm_em needs X (B, n, d) with B, n, d > 0 and means (B, K, d), got "
                         f"{tuple(X.shape)}, {tuple(carry['means'].shape)}")
    B, n, d = X.shape
    K = carry["means"].shape[1]
    f, i32 = X.dtype, torch.int32
    tensors = dict(X=X, sw=sw, tol=tol, max_iter=max_iter,
                   **{k: carry[k] for k in ("pi", "means", "covs", "lb", "n_iter", "done")})
    _check("gmm_em", tensors,
           dict(X=f, sw=f, pi=f, means=f, covs=f, lb=f, tol=f, n_iter=i32, max_iter=i32,
                done=torch.bool),
           dict(X=(B, n, d), sw=(B, n), pi=(B, K), means=(B, K, d), covs=(B, K, d, d), lb=(B,),
                n_iter=(B,), done=(B,), tol=(), max_iter=()))
    if X.device.index != torch.cuda.current_device():  # the C entry launches on the current one
        with torch.cuda.device(X.device):
            return gmm_em(X, sw, carry, tol, max_iter, reg_covar, covariance_type)
    cov = COVARIANCE_CODES[covariance_type]
    p = plan(GMM_LIBRARY, B, n, d, K, cov, X.element_size())
    wresp, part, work = _scratch(p, f, X.device)
    out = {k: carry[k].clone() for k in ("pi", "means", "covs", "lb", "n_iter", "done")}
    entry = getattr(_build.load(GMM_LIBRARY), GMM_ENTRIES[f])
    err = entry(X.data_ptr(), sw.data_ptr(), *(out[k].data_ptr() for k in
                                               ("pi", "means", "covs", "lb", "n_iter", "done")),
                tol.data_ptr(), max_iter.data_ptr(), _ptr(wresp), part.data_ptr(),
                _ptr(work), B, n, d, K, cov, float(reg_covar),
                torch.cuda.current_stream(X.device).cuda_stream)
    _build.check(err, "gmm_em")
    LAUNCHES["gmm_em"] += 1
    out["go"] = torch.zeros((), dtype=torch.bool, device=X.device)
    return out


def mvstud_em(data: torch.Tensor, wbar: torch.Tensor, carry: Tensors, tol: torch.Tensor,
              max_iter: torch.Tensor) -> Tensors:
    """The weighted Student-t EM loop of `student.fit_mvstud_weighted_modes`
    in one launch: data (n, d), wbar (K, n), the carry mu (K, d), Sigma (K,
    d, d), nu and last_nu (K,), i (K,) int32, hit_inf and active (K,) bool
    at the loop's start; tol (the type) and max_iter (int32) 0-d tensors.
    Returns the carry after the loop, with go False, on the current stream
    without a host sync."""
    if data.dtype not in MVSTUD_ENTRIES:
        raise ValueError(f"mvstud_em runs float32 or float64 data, not {data.dtype}")
    if data.dim() != 2 or wbar.dim() != 2 or 0 in data.shape or 0 in wbar.shape:
        raise ValueError(f"mvstud_em needs data (n, d) and wbar (K, n) with n, d, K > 0, got "
                         f"{tuple(data.shape)}, {tuple(wbar.shape)}")
    n, d = data.shape
    K = wbar.shape[0]
    f, i32, b = data.dtype, torch.int32, torch.bool
    keys = ("mu", "Sigma", "nu", "last_nu", "i", "hit_inf", "active")
    tensors = dict(data=data, wbar=wbar, tol=tol, max_iter=max_iter, **{k: carry[k] for k in keys})
    _check("mvstud_em", tensors,
           dict(data=f, wbar=f, mu=f, Sigma=f, nu=f, last_nu=f, tol=f, i=i32, max_iter=i32,
                hit_inf=b, active=b),
           dict(data=(n, d), wbar=(K, n), mu=(K, d), Sigma=(K, d, d), nu=(K,), last_nu=(K,),
                i=(K,), hit_inf=(K,), active=(K,), tol=(), max_iter=()))
    if data.device.index != torch.cuda.current_device():
        with torch.cuda.device(data.device):
            return mvstud_em(data, wbar, carry, tol, max_iter)
    p = plan(MVSTUD_LIBRARY, K, n, d, data.element_size())
    delta, part, work = _scratch(p, f, data.device)
    out = {k: carry[k].clone() for k in keys}
    entry = getattr(_build.load(MVSTUD_LIBRARY), MVSTUD_ENTRIES[f])
    err = entry(data.data_ptr(), wbar.data_ptr(), *(out[k].data_ptr() for k in keys),
                tol.data_ptr(), max_iter.data_ptr(), _ptr(delta), part.data_ptr(),
                _ptr(work), K, n, d, torch.cuda.current_stream(data.device).cuda_stream)
    _build.check(err, "mvstud_em")
    LAUNCHES["mvstud_em"] += 1
    out["go"] = torch.zeros((), dtype=torch.bool, device=data.device)
    return out
