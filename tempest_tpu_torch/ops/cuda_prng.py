"""The hardware-PRNG draws: four CUDA kernels and their plain versions.

Counterpart of tempest_tpu/ops/pallas_prng.py: `hw_mutation_draws`,
`hw_normal`, `hw_uniform` and `hw_gamma`. The kernels are in
`csrc/prng_draws.cu` (design note at the top of that file), built with
nvcc for sm_90a at first use and bound with ctypes; the plain versions are
in `ops/philox.py`, with the same Philox4x32-10 counter layout, so a
kernel and its plain version give the same words.

A call takes the run's key (two 32-bit words) and a call index `counter`
(host integers, so no launch syncs the host) and draws what JAX would draw
from a fresh key. `hw_gamma` is one launch of the gamma kernel, where the
JAX function composes 13 Pallas calls with elementwise XLA ops
(pallas_prng.py:293-306); it draws the words of call indices counter ..
counter + 12 in the layout of `philox.gamma`, its plain version, so a run
that resumes from a file written before keeps its stream.

`hw_mutation_draws` launches one grid: CTAs of 256 threads, the first
ceil(8 N / 256) for the walkers (8 lanes each: six Marsaglia-Tsang rounds
side by side, the boost/accept block, one idle lane), the rest for the
R N d proposal normals (4 a thread). Its outputs are views of one buffer,
and its launch path is short: the C function is looked up once, the stream
is read without a device switch (the wrappers switch only for a device
other than the current one), and only the dtype, contiguity and 32-bit
index checks stay.

Dispatch is by device only, as in `ops/cuda_reweight.py`: a CPU tensor
takes the plain version, a CUDA float32 tensor the kernel, anything else
raises. `LAUNCHES` counts each kernel's launches in this process.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build, philox
from .philox import Key

LIBRARY = _build.CudaLibrary(
    "prng_draws.cu",
    {
        "tempest_normal": [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
                           ctypes.c_uint64, ctypes.c_void_p],
        "tempest_bits": [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
                         ctypes.c_uint64, ctypes.c_void_p],
        "tempest_mutation_draws": [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint64, ctypes.c_void_p,
        ],
        "tempest_gamma": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                          ctypes.c_uint32, ctypes.c_uint64, ctypes.c_void_p],
    },
    # No FMA contraction: the plain version's separate elementwise ops round
    # every product, and the kernel must round the same way.
    extra_flags=("-fmad=false",),
)

# Kernel launches made in this process, by kernel.
LAUNCHES = {"mutation_draws": 0, "normal": 0, "bits": 0, "gamma": 0}

_MAX_BLOCKS = 1 << 32  # the block index is one 32-bit counter word
_functions = {}  # C entry points by name, looked up once


def _route(device: torch.device, what: str) -> bool:
    """True for the kernel, False for the plain version; raises otherwise."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {device}")
    return True


def _check_call(key: Key, counter: int, total: int) -> None:
    if not all(0 <= int(k) <= philox.MASK32 for k in key):
        raise ValueError(f"key words must be 32-bit unsigned, got {key}")
    if not 0 <= int(counter) < (1 << 64):
        raise ValueError(f"counter must be a 64-bit unsigned index, got {counter}")
    if -(-total // 4) > _MAX_BLOCKS:
        raise ValueError(f"{total} draws exceed one call's 2^32 blocks of 4")


def _function(name: str):
    fn = _functions.get(name)
    if fn is None:
        fn = _functions[name] = getattr(_build.load(LIBRARY), name)
    return fn


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _elsewhere(device: torch.device) -> bool:
    """True for a CUDA device other than the current one: the C entries
    launch on the current device, so the wrapper switches to it first."""
    return device.index is not None and device.index != torch.cuda.current_device()


def hw_normal(key: Key, counter: int, shape, device) -> torch.Tensor:
    """Standard normals of `shape`, float32, by paired Box-Muller."""
    device = torch.device(device)
    total = int(torch.Size(shape).numel())
    _check_call(key, counter, total)
    if not _route(device, "hw_normal"):
        return philox.normal(key, counter, total, device).reshape(shape)
    if _elsewhere(device):
        with torch.cuda.device(device):
            return hw_normal(key, counter, shape, device)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if total:
        err = _function("tempest_normal")(
            out.data_ptr(), total, key[0], key[1], counter, _stream(device))
        _build.check(err, "normal")
        LAUNCHES["normal"] += 1
    return out


def hw_bits(key: Key, counter: int, shape, device) -> torch.Tensor:
    """Raw 32-bit words of `shape` as int32 bit patterns."""
    device = torch.device(device)
    total = int(torch.Size(shape).numel())
    _check_call(key, counter, total)
    if not _route(device, "hw_bits"):
        return philox.bits(key, counter, total, device).reshape(shape)
    if _elsewhere(device):
        with torch.cuda.device(device):
            return hw_bits(key, counter, shape, device)
    out = torch.empty(shape, dtype=torch.int32, device=device)
    if total:
        err = _function("tempest_bits")(
            out.data_ptr(), total, key[0], key[1], counter, _stream(device))
        _build.check(err, "bits")
        LAUNCHES["bits"] += 1
    return out


def hw_uniform(key: Key, counter: int, shape, device) -> torch.Tensor:
    """Uniforms in (0, 1] of `shape`: bits kernel plus the unit mapping."""
    return philox.unit_open_closed(hw_bits(key, counter, shape, device))


def hw_gamma(key: Key, counter: int, alpha: torch.Tensor) -> torch.Tensor:
    """gamma(alpha, 1) draws of alpha's shape, float32, by Marsaglia-Tsang
    in one launch on the words of call indices counter .. counter + 12."""
    _check_call(key, counter, alpha.numel())
    last = int(counter) + philox.GAMMA_CALLS - 1
    if last >= 1 << 64:
        raise ValueError(f"hw_gamma uses call indices {counter} .. {last}: past 2^64 - 1")
    if not _route(alpha.device, "hw_gamma"):
        return philox.gamma(key, counter, alpha)
    if _elsewhere(alpha.device):
        with torch.cuda.device(alpha.device):
            return hw_gamma(key, counter, alpha)
    if alpha.dtype != torch.float32 or not alpha.is_contiguous():
        raise ValueError(
            f"alpha must be a contiguous float32 tensor (got {alpha.dtype}, "
            f"contiguous={alpha.is_contiguous()})"
        )
    out = torch.empty(alpha.shape, dtype=torch.float32, device=alpha.device)
    n = alpha.numel()
    if n:
        err = _function("tempest_gamma")(
            alpha.data_ptr(), out.data_ptr(), n, key[0], key[1], counter, _stream(alpha.device))
        _build.check(err, "gamma")
        LAUNCHES["gamma"] += 1
    return out


def hw_mutation_draws(
    key: Key, counter: int, alpha: torch.Tensor, z_shape: Tuple[int, int, int]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(z (R, N, d), g (N,), acceptance uniforms (N,)) for one tpCN step in
    one launch; alpha (N,) are the gamma shapes."""
    R, N, d = z_shape
    if alpha.dim() != 1 or alpha.shape[0] != N:
        raise ValueError(f"alpha must have shape ({N},), got {tuple(alpha.shape)}")
    n_z = R * N * d
    _check_call(key, counter, n_z)
    if N > _MAX_BLOCKS:  # the walker index is one 32-bit counter word
        raise ValueError(f"{N} walkers exceed the 2^32 a call can index")
    if not _route(alpha.device, "hw_mutation_draws"):
        return philox.mutation_draws(key, counter, alpha, z_shape)
    if _elsewhere(alpha.device):
        with torch.cuda.device(alpha.device):
            return hw_mutation_draws(key, counter, alpha, z_shape)
    if alpha.dtype != torch.float32 or not alpha.is_contiguous():
        raise ValueError(
            f"alpha must be a contiguous float32 tensor (got {alpha.dtype}, "
            f"contiguous={alpha.is_contiguous()})"
        )
    out = torch.empty(n_z + 2 * N, dtype=torch.float32, device=alpha.device)
    z, g, u = out.split((n_z, N, N))
    if N:
        err = _function("tempest_mutation_draws")(
            alpha.data_ptr(), out.data_ptr(), n_z, N, key[0], key[1], counter,
            _stream(alpha.device),
        )
        _build.check(err, "mutation_draws")
        LAUNCHES["mutation_draws"] += 1
    return z.view(z_shape), g, u
