"""Eigenvalues of symmetric matrices: a CUDA kernel and its plain version.

The volume-variation CV (`ops.tools.volume_variation_dtn` and
`volume_variation`) takes the eigenvalues of its (d, d) weighted covariance
for a rank test. The JAX package leaves this to XLA's `jnp.linalg.eigvalsh`
(tempest_tpu/ops/tools.py:214, :274); there is no Pallas kernel to port.
`torch.linalg.eigvalsh` of a CUDA tensor reads LAPACK's `info` on the host,
a blocking read that a CUDA graph cannot capture, and dynamic mode
evaluates the CV inside the bisection loop that the fused route replays as
a graph. So a CUDA tensor goes to `csrc/sym_eigvals.cu` (design note at
the top of that file): Householder tridiagonalization and Sturm-count
multisection, one CTA a matrix, the matrix in shared memory while it fits
(`plan_launch`), no host read.

`eigvalsh` picks its route only by the tensor's device: a CPU tensor goes
to `torch.linalg.eigvalsh`, the plain version (so the CPU route stays
LAPACK's, as JAX's CPU route is); a CUDA tensor of float32 or float64 to
the kernel of its type; anything else raises. A failed build or launch
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build

_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
LIBRARY = _build.CudaLibrary(
    "sym_eigvals.cu", {"tempest_sym_eigvals": _SIGNATURE, "tempest_sym_eigvals_f64": _SIGNATURE}
)
ENTRIES = {torch.float32: "tempest_sym_eigvals", torch.float64: "tempest_sym_eigvals_f64"}

# Kernel launches made by `eigvalsh` in this process (both types).
LAUNCHES = 0

SMEM_MAX = 232448  # the shared memory a CTA may opt into on sm_90: csrc kSmemMax
MAX_ROUNDS = 80  # the cap on an eigenvalue's multisection rounds: csrc kMaxRounds


class LaunchPlan(NamedTuple):
    m: int  # d rounded up to even: the matrix is held with a row pitch of m + 1
    resident: bool  # each matrix held in shared memory (else a global workspace)
    smem: int  # dynamic shared memory a CTA, bytes


def plan_launch(d: int, dtype=torch.float32) -> LaunchPlan:
    """The launch for (d, d) matrices of `dtype`: resident while the matrix
    (m rows of pitch m + 1), the tridiagonal, the product A v and the
    reduction scratch fit a CTA's shared memory (d <= 238 in float32,
    d <= 168 in float64); csrc `smem_bytes`."""
    m = d + (d & 1)
    size = dtype.itemsize
    extra = (3 * m + 32) * size
    resident = m * (m + 1) * size + extra <= SMEM_MAX
    return LaunchPlan(m, resident, m * (m + 1) * size + extra if resident else extra)


def eigvalsh(a: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues of the symmetric matrices `a` (..., d, d), read
    from their lower triangles, as `torch.linalg.eigvalsh(a)`.

    A CPU tensor takes `torch.linalg.eigvalsh`; a CUDA tensor launches the
    kernel on the current stream without a host sync (a matrix with a
    non-finite entry gives NaN eigenvalues there instead of an error)."""
    if a.device.type == "cpu":
        return torch.linalg.eigvalsh(a)
    if a.device.type != "cuda":
        raise ValueError(f"eigvalsh runs on cpu or cuda tensors, not {a.device}")
    if a.dtype not in ENTRIES:
        raise ValueError(f"eigvalsh runs float32 or float64 tensors, not {a.dtype}")
    if a.dim() < 2 or a.shape[-1] != a.shape[-2] or a.shape[-1] == 0:
        raise ValueError(f"eigvalsh needs (..., d, d) matrices with d >= 1, got {tuple(a.shape)}")
    return _launch(a)[0]


def _launch(a: torch.Tensor, rounds: bool = False):
    """(eigenvalues, the multisection rounds of each matrix's slowest
    eigenvalue as int32, or None)."""
    global LAUNCHES
    if a.device.index != torch.cuda.current_device():  # the C entry launches on the current one
        with torch.cuda.device(a.device):
            return _launch(a, rounds)
    d = a.shape[-1]
    batch = a.reshape(-1, d, d).contiguous()
    plan = plan_launch(d, a.dtype)
    out = torch.empty(batch.shape[:-1], dtype=a.dtype, device=a.device)
    work: Optional[torch.Tensor] = None
    if not plan.resident:
        work = torch.empty((batch.shape[0], plan.m, plan.m + 1), dtype=a.dtype, device=a.device)
    n_rounds = torch.empty(batch.shape[0], dtype=torch.int32, device=a.device) if rounds else None
    if batch.shape[0] == 0:
        return out.reshape(a.shape[:-1]), n_rounds
    entry = getattr(_build.load(LIBRARY), ENTRIES[a.dtype])
    err = entry(batch.data_ptr(), out.data_ptr(), None if work is None else work.data_ptr(),
                None if n_rounds is None else n_rounds.data_ptr(), batch.shape[0], d,
                int(plan.resident), torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "sym_eigvals")
    LAUNCHES += 1
    return out.reshape(a.shape[:-1]), n_rounds
