"""The hardware-PRNG draws: four CUDA kernels and their plain versions.

Counterpart of tempest_tpu/ops/pallas_prng.py: `hw_mutation_draws`,
`hw_normal`, `hw_uniform` and `hw_gamma`. The kernels are in
`csrc/prng_draws.cu` (design note at the top of that file), built with
nvcc for sm_90a at first use and bound with ctypes; the plain versions are
in `ops/philox.py`, with the same Philox4x32-10 counter layout, so a
kernel and its plain version give the same words.

A public call takes the run's key (two 32-bit words) and a call index
`counter` (host integers, so no launch syncs the host) and draws what JAX
would draw from a fresh key. `hw_gamma` is one launch of the gamma kernel,
where the JAX function composes 13 Pallas calls with elementwise XLA ops
(pallas_prng.py:293-306); it draws the words of call indices counter ..
counter + 12 in the layout of `philox.gamma`, its plain version, so a run
that resumes from a file written before keeps its stream.

`hw_uniform` is one launch of the bits kernel in its uniform mode
(`tempest_uniform`), which maps the words to (0, 1] in registers.

Each draw also comes in float64, JAX's threefry draws in double, from a
kernel of its own (`tempest_normal_f64`, `tempest_uniform_f64`,
`tempest_gamma_f64`, `tempest_mutation_draws_f64`; plain versions
`philox.normal_f64` and the rest, the float64 layout in its docstring):
the dtype comes from `alpha` for the gamma and mutation draws, and from
`dtype=` for the normals and uniforms. A float64 gamma draw takes
`philox.GAMMA_CALLS_F64` call indices.

`PhiloxCounter` is the call counter of a draws object's MCMC steps
(`draws.Draws` on its keyed route, `draws.HardwareDraws`): its key and call
index live in two 64-bit words on the device, which the normal, uniform,
gamma and mutation-draws kernels read. A step launches on the words and
then adds its calls to them on the stream, times the step's 0-d `active`
flag where it has one, so no launch takes a host integer that a CUDA graph
would freeze, a replayed graph draws the next calls, and a step past the
stop of its chain draws nothing new. The host mirror `counter` is read from
the word when asked for (a checkpoint, a test), never by a launch.
What is constant per counter (the checked key words, the device index, the
words' address) is resolved once; a launch checks only its tensors (and,
on the CPU, where the mirror costs nothing, the 2^64 bound of its call
indices). The C entries switch to the tensors' device themselves.

Dispatch is by device only, as in `ops/cuda_reweight.py`: a CPU tensor
takes the plain version (given the mirror, for a counter), a CUDA float32
or float64 tensor the kernel of its dtype, anything else raises; nothing
falls back to a generator. `LAUNCHES` counts each kernel's launches in
this process, the float64 entries under their own names ("normal_f64",
"uniform_f64", "gamma_f64", "mutation_draws_f64").
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch

from . import _build, philox
from .philox import Key

_P, _I64, _U32, _U64, _INT = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint64,
                              ctypes.c_int)
LIBRARY = _build.CudaLibrary(
    "prng_draws.cu",
    {
        # (out, total, k0, k1, counter, state, device, stream)
        "tempest_normal": [_P, _I64, _U32, _U32, _U64, _P, _INT, _P],
        # (out, total, k0, k1, counter, device, stream)
        "tempest_bits": [_P, _I64, _U32, _U32, _U64, _INT, _P],
        # (out, total, k0, k1, counter, state, device, stream)
        "tempest_uniform": [_P, _I64, _U32, _U32, _U64, _P, _INT, _P],
        # (alpha, out, n_z, n_walkers, k0, k1, counter, state, device, stream)
        "tempest_mutation_draws": [_P, _P, _I64, _I64, _U32, _U32, _U64, _P, _INT, _P],
        # (alpha, out, n, k0, k1, counter, state, device, stream)
        "tempest_gamma": [_P, _P, _I64, _U32, _U32, _U64, _P, _INT, _P],
        # The float64 entries, with the arguments of their float32 ones.
        "tempest_normal_f64": [_P, _I64, _U32, _U32, _U64, _P, _INT, _P],
        "tempest_uniform_f64": [_P, _I64, _U32, _U32, _U64, _P, _INT, _P],
        "tempest_mutation_draws_f64": [_P, _P, _I64, _I64, _U32, _U32, _U64, _P, _INT, _P],
        "tempest_gamma_f64": [_P, _P, _I64, _U32, _U32, _U64, _P, _INT, _P],
    },
    # No FMA contraction: the plain version's separate elementwise ops round
    # every product, and the kernel must round the same way.
    extra_flags=("-fmad=false",),
)

# Kernel launches made in this process, by kernel ("bits" counts the bits
# kernel in both modes, raw words and uniforms; "uniform_f64" the float64
# uniforms).
LAUNCHES = {"mutation_draws": 0, "normal": 0, "bits": 0, "gamma": 0,
            "mutation_draws_f64": 0, "normal_f64": 0, "uniform_f64": 0, "gamma_f64": 0}
# The dtypes the kernels draw, and the outputs of one Philox block in each.
DTYPES = (torch.float32, torch.float64)
_PER_BLOCK = {torch.float32: 4, torch.float64: 2}

_MAX_BLOCKS = 1 << 32  # the block index is one 32-bit counter word
_functions = {}  # C entry points by name, looked up once


def _route(device: torch.device, what: str) -> bool:
    """True for the kernel, False for the plain version; raises otherwise."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {device}")
    return True


def _check_key(key: Key) -> Tuple[int, int]:
    k0, k1 = (int(k) for k in key)
    if not (0 <= k0 <= philox.MASK32 and 0 <= k1 <= philox.MASK32):
        raise ValueError(f"key words must be 32-bit unsigned, got {key}")
    return k0, k1


def _check_calls(counter: int, calls: int, what: str) -> None:
    """Call indices counter .. counter + calls - 1 must fit 64 bits."""
    if not 0 <= counter or counter + calls > 1 << 64:
        raise ValueError(f"{what} uses call indices {counter} .. {counter + calls - 1}: a call "
                         "index is a 64-bit unsigned integer")


def _check_dtype(dtype) -> None:
    if dtype not in DTYPES:
        raise ValueError(f"the draws are float32 or float64, not {dtype}")


def _check_total(total: int, dtype=torch.float32) -> None:
    per = _PER_BLOCK[dtype]
    if total > per * _MAX_BLOCKS:
        raise ValueError(f"{total} draws exceed one call's 2^32 blocks of {per}")


def _check_alpha(alpha: torch.Tensor) -> None:
    if alpha.dtype not in DTYPES or not alpha.is_contiguous():
        raise ValueError(
            f"alpha must be a contiguous float32 or float64 tensor (got {alpha.dtype}, "
            f"contiguous={alpha.is_contiguous()})"
        )


def _suffix(dtype) -> str:
    """The float64 entries', counts' and plain versions' suffix."""
    return "_f64" if dtype == torch.float64 else ""


def _plain(name: str, dtype):
    """The plain version (`philox`) of draw `name` in `dtype`."""
    return getattr(philox, name + _suffix(dtype))


def _function(name: str):
    fn = _functions.get(name)
    if fn is None:
        fn = _functions[name] = getattr(_build.load(LIBRARY), name)
    return fn


def _stream(index: int) -> int:
    """The current stream of CUDA device `index` (a capture's stream inside
    a capture)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


# ---------------------------------------------------------------------------
# Launches: k0, k1 and counter from the host, or from `state` (its address,
# 0 for none) on the device.
# ---------------------------------------------------------------------------
def _normal(shape, device: torch.device, index: int, k0, k1, counter, state,
            dtype=torch.float32) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=device)
    total = out.numel()
    if total:
        name = "normal" + _suffix(dtype)
        _build.check(_function("tempest_" + name)(
            out.data_ptr(), total, k0, k1, counter, state, index, _stream(index)), name)
        LAUNCHES[name] += 1
    return out


def _uniform(shape, device: torch.device, index: int, k0, k1, counter, state,
             dtype=torch.float32) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=device)
    total = out.numel()
    if total:
        name = "uniform" + _suffix(dtype)
        _build.check(_function("tempest_" + name)(
            out.data_ptr(), total, k0, k1, counter, state, index, _stream(index)), name)
        LAUNCHES["bits" if dtype == torch.float32 else name] += 1
    return out


def _gamma(alpha: torch.Tensor, index: int, k0, k1, counter, state) -> torch.Tensor:
    _check_alpha(alpha)
    out = torch.empty(alpha.shape, dtype=alpha.dtype, device=alpha.device)
    n = alpha.numel()
    if n:
        name = "gamma" + _suffix(alpha.dtype)
        _build.check(_function("tempest_" + name)(
            alpha.data_ptr(), out.data_ptr(), n, k0, k1, counter, state, index, _stream(index)),
            name)
        LAUNCHES[name] += 1
    return out


def _mutation_draws(alpha: torch.Tensor, z_shape, index: int, k0, k1, counter, state):
    _check_alpha(alpha)
    R, N, d = z_shape
    n_z = R * N * d
    out = torch.empty(n_z + 2 * N, dtype=alpha.dtype, device=alpha.device)
    z, g, u = out.split((n_z, N, N))
    if N:
        name = "mutation_draws" + _suffix(alpha.dtype)
        _build.check(_function("tempest_" + name)(
            alpha.data_ptr(), out.data_ptr(), n_z, N, k0, k1, counter, state, index,
            _stream(index)), name)
        LAUNCHES[name] += 1
    return z.view(z_shape), g, u


def _check_mutation_shapes(alpha: torch.Tensor, z_shape) -> None:
    R, N, d = z_shape
    if alpha.dim() != 1 or alpha.shape[0] != N:
        raise ValueError(f"alpha must have shape ({N},), got {tuple(alpha.shape)}")
    _check_dtype(alpha.dtype)
    _check_total(R * N * d, alpha.dtype)
    if N > _MAX_BLOCKS:  # the walker index is one 32-bit counter word
        raise ValueError(f"{N} walkers exceed the 2^32 a call can index")


# ---------------------------------------------------------------------------
# The public functions: a host key and call index
# ---------------------------------------------------------------------------
def hw_normal(key: Key, counter: int, shape, device, dtype=torch.float32) -> torch.Tensor:
    """Standard normals of `shape` and `dtype` (float32 or float64), by
    paired Box-Muller."""
    device = torch.device(device)
    total = int(torch.Size(shape).numel())
    k0, k1 = _check_key(key)
    _check_calls(int(counter), 1, "hw_normal")
    _check_dtype(dtype)
    _check_total(total, dtype)
    if not _route(device, "hw_normal"):
        return _plain("normal", dtype)(key, counter, total, device).reshape(shape)
    return _normal(shape, device, _index(device), k0, k1, counter, None, dtype)


def hw_bits(key: Key, counter: int, shape, device) -> torch.Tensor:
    """Raw 32-bit words of `shape` as int32 bit patterns."""
    device = torch.device(device)
    total = int(torch.Size(shape).numel())
    k0, k1 = _check_key(key)
    _check_calls(int(counter), 1, "hw_bits")
    _check_total(total)
    if not _route(device, "hw_bits"):
        return philox.bits(key, counter, total, device).reshape(shape)
    out = torch.empty(shape, dtype=torch.int32, device=device)
    if total:
        index = _index(device)
        _build.check(_function("tempest_bits")(
            out.data_ptr(), total, k0, k1, counter, index, _stream(index)), "bits")
        LAUNCHES["bits"] += 1
    return out


def hw_uniform(key: Key, counter: int, shape, device, dtype=torch.float32) -> torch.Tensor:
    """Uniforms in (0, 1] of `shape`, in one launch: float32, the bits
    kernel's words mapped as `philox.unit_open_closed` maps them; float64,
    53 bits from two words (`philox.uniform_f64`)."""
    device = torch.device(device)
    total = int(torch.Size(shape).numel())
    k0, k1 = _check_key(key)
    _check_calls(int(counter), 1, "hw_uniform")
    _check_dtype(dtype)
    _check_total(total, dtype)
    if not _route(device, "hw_uniform"):
        return _plain("uniform", dtype)(key, counter, total, device).reshape(shape)
    return _uniform(shape, device, _index(device), k0, k1, counter, None, dtype)


def hw_gamma(key: Key, counter: int, alpha: torch.Tensor) -> torch.Tensor:
    """gamma(alpha, 1) draws of alpha's shape and dtype by Marsaglia-Tsang
    in one launch: float32 on the words of call indices counter ..
    counter + 12, float64 on counter .. counter + 32."""
    k0, k1 = _check_key(key)
    _check_dtype(alpha.dtype)
    _check_calls(int(counter), philox.gamma_calls(alpha.dtype), "hw_gamma")
    _check_total(alpha.numel(), alpha.dtype)
    if not _route(alpha.device, "hw_gamma"):
        return _plain("gamma", alpha.dtype)(key, counter, alpha)
    return _gamma(alpha, _index(alpha.device), k0, k1, counter, None)


def hw_mutation_draws(
    key: Key, counter: int, alpha: torch.Tensor, z_shape: Tuple[int, int, int]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(z (R, N, d), g (N,), acceptance uniforms (N,)) for one tpCN step in
    one launch, in alpha's dtype; alpha (N,) are the gamma shapes."""
    _check_mutation_shapes(alpha, z_shape)
    k0, k1 = _check_key(key)
    _check_calls(int(counter), 1, "hw_mutation_draws")
    if not _route(alpha.device, "hw_mutation_draws"):
        return _plain("mutation_draws", alpha.dtype)(key, counter, alpha, z_shape)
    return _mutation_draws(alpha, z_shape, _index(alpha.device), k0, k1, counter, None)


# ---------------------------------------------------------------------------
# The call counter of a draws object
# ---------------------------------------------------------------------------
def _as_int64(word: int) -> int:
    """A 64-bit unsigned word as the int64 with the same bits."""
    return word - (1 << 64) if word >= 1 << 63 else word


class PhiloxCounter:
    """A key and a 64-bit call counter on `device`.

    `state` holds two int64 words, the call counter and the key (k0 | k1 <<
    32); `key` is the key's host mirror and `counter` the counter's, read
    from the word when asked for. `normal`, `uniform`, `gamma` and
    `mutation_draws` draw calls counter + offset on, as the public functions
    with that call index would (in the dtype of `alpha`, or of `dtype` for
    the normals and uniforms); on a CUDA device the kernels read the index
    and key from `state`, on the CPU the plain versions are given the word's
    value. `advance(calls, active)` adds a step's calls to the word on the
    stream, times the 0-d `active` flag where one is given. `seek` and
    `set_key` write the words outside any capture. `issued` counts the draw
    calls made through this object (a host count: a captured body that
    draws shows in it). `guards` holds the 0-d bools of the conditional
    bodies being warmed up around a draw (`loops.Loops.when`): `advance`
    counts the calls times each, so a body that would not run draws nothing.
    """

    def __init__(self, key: Key, device, counter: int = 0):
        self.device = torch.device(device)
        self.state = torch.zeros(2, dtype=torch.int64, device=self.device)
        self._word = self.state[:1]
        self._cuda = _route(self.device, "PhiloxCounter")
        self._index = self.state.device.index if self._cuda else -1
        self._state_ptr = self.state.data_ptr() if self._cuda else None
        self.issued = 0
        self.guards: List[torch.Tensor] = []
        self.set_key(key)
        self.seek(counter)

    def set_key(self, key: Key) -> None:
        k0, k1 = _check_key(key)
        self.key = (k0, k1)
        self.state[1:].fill_(_as_int64(k0 | k1 << 32))

    def seek(self, counter: int) -> None:
        """Set the call counter (the device word) to `counter`."""
        counter = int(counter)
        _check_calls(counter, 0, "PhiloxCounter")
        self._word.fill_(_as_int64(counter))

    @property
    def counter(self) -> int:
        """The call counter, read from the device word (a host read on CUDA)."""
        return int(self._word.item()) & (2**64 - 1)

    def advance(self, calls: int, active: Optional[torch.Tensor] = None) -> None:
        """Count `calls` more call indices as used, times `active` (a 0-d
        bool) where given and times each of `guards`, on the device word."""
        if not calls:
            return
        for guard in self.guards:
            active = guard if active is None else active & guard
        self._word.add_(calls if active is None else active.to(torch.int64) * calls)

    def _first(self, offset: int, calls: int, what: str) -> int:
        """The first call index of a draw by the plain versions (on the
        CPU, where reading the word costs no device sync), checked to fit
        64 bits with its `calls`."""
        first = self.counter + offset
        _check_calls(first, calls, what)
        return first

    def _check_device(self, alpha: torch.Tensor) -> None:
        if alpha.device != self.state.device:
            raise ValueError(f"alpha on {alpha.device}, the call counter on {self.state.device}")

    def normal(self, offset: int, shape, dtype=torch.float32) -> torch.Tensor:
        total = math.prod(shape)
        _check_dtype(dtype)
        _check_total(total, dtype)
        self.issued += 1
        if not self._cuda:
            return _plain("normal", dtype)(self.key, self._first(offset, 1, "normal"), total,
                                           self.device).reshape(shape)
        return _normal(shape, self.device, self._index, 0, 0, offset, self._state_ptr, dtype)

    def uniform(self, offset: int, shape, dtype=torch.float32) -> torch.Tensor:
        total = math.prod(shape)
        _check_dtype(dtype)
        _check_total(total, dtype)
        self.issued += 1
        if not self._cuda:
            return _plain("uniform", dtype)(self.key, self._first(offset, 1, "uniform"), total,
                                            self.device).reshape(shape)
        return _uniform(shape, self.device, self._index, 0, 0, offset, self._state_ptr, dtype)

    def gamma(self, offset: int, alpha: torch.Tensor) -> torch.Tensor:
        self._check_device(alpha)
        _check_dtype(alpha.dtype)
        _check_total(alpha.numel(), alpha.dtype)
        self.issued += 1
        if not self._cuda:
            calls = philox.gamma_calls(alpha.dtype)
            return _plain("gamma", alpha.dtype)(self.key, self._first(offset, calls, "gamma"),
                                                alpha)
        return _gamma(alpha, self._index, 0, 0, offset, self._state_ptr)

    def mutation_draws(self, offset: int, alpha: torch.Tensor, z_shape):
        _check_mutation_shapes(alpha, z_shape)
        self._check_device(alpha)
        self.issued += 1
        if not self._cuda:
            return _plain("mutation_draws", alpha.dtype)(
                self.key, self._first(offset, 1, "mutation_draws"), alpha, z_shape)
        return _mutation_draws(alpha, z_shape, self._index, 0, 0, offset, self._state_ptr)

    def read(self) -> Tuple[int, Key]:
        """(call counter, key) as `state` holds them: a host read, for checks."""
        c, k = (int(v) & (2**64 - 1) for v in self.state.tolist())
        return c, (k & philox.MASK32, k >> 32)
