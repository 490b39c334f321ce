"""Build and load the port's CUDA sources.

Each source under `csrc/` is compiled by nvcc for sm_90a into its own
shared library with a plain C interface, named by a hash of the source and
its flags, in the `.gitignore`d `build/tempest_tpu_torch/`, and loaded with
ctypes. A build happens at first use (or all at once through `build_all`,
one nvcc per source, started together); a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Mapping, Sequence, Tuple

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "tempest_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


@dataclass(frozen=True)
class CudaLibrary:
    """One CUDA source and the C functions it exports.

    `functions` maps each exported name to its ctypes argument types; every
    function returns a cudaError_t as int.
    """

    source: str  # file name under csrc/
    functions: Mapping[str, Sequence[type]]
    extra_flags: Tuple[str, ...] = ()

    @property
    def stem(self) -> str:
        return Path(self.source).stem

    def path(self) -> Path:
        """The library built from the current source with these flags."""
        flags = NVCC_FLAGS + self.extra_flags
        h = hashlib.sha256(" ".join(flags).encode())
        h.update((CSRC / self.source).read_bytes())
        return BUILD_DIR / f"lib{self.stem}_{h.hexdigest()[:16]}.so"

    def _command(self, out: Path) -> list:
        return [_nvcc(), *NVCC_FLAGS, *self.extra_flags, "-o", str(out), str(CSRC / self.source)]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_HOME is not None:
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def build_all(libraries: Iterable[CudaLibrary]) -> Dict[str, Path]:
    """Compile every library not built yet, one nvcc each, all at once."""
    todo, done = [], {}
    for lib in libraries:
        out = lib.path()
        done[lib.source] = out
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = lib._command(tmp)
            todo.append((cmd, tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for cmd, tmp, out, proc in todo:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{stdout}{stderr}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return done


def load(lib: CudaLibrary) -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    if lib.source not in _loaded:
        handle = ctypes.CDLL(str(build_all([lib])[lib.source]))
        for name, argtypes in lib.functions.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _loaded[lib.source] = handle
    return _loaded[lib.source]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {err}")
