"""Likelihood and prior-transform wrapping.

Counterpart of tempest_tpu/utils/wrappers.py. Three forms of model
function, as there:

- default (`vectorize=False`): per-point torch functions of one (d,)
  point, mapped over the particle axis with `torch.func.vmap` as JAX maps
  them with `jax.vmap` (:40, :155, :166);
- `vectorize=True`: torch functions that already take (N, d) batches;
- `host_likelihood=True`: any Python function of one numpy point (of the
  run's dtype, shape (d,)), called on the host through `pool_map` once a
  sweep, with the result moved back to the particles' device: the host
  crossing `HostLikelihood`, the port's `jax.pure_callback` and, for object
  blobs, `io_callback` (:88-131). On a CPU tensor one counted blocking read
  (`Loops.fetch("likelihood", ...)`) of the points and the step's `active`
  flag, and no call where the step is inactive; on a CUDA tensor the
  host-call kernel (`ops.cuda_host`, `csrc/host_call.cu`), which hands the
  points to the host through mapped pinned memory: inside a CUDA graph
  served by the thread that replays it (`loops._Graph.replay`), outside one
  (eagerly, and a run's first iteration) at once. Either way one `pool_map`
  call an active sweep and no other: none in a capture's warm-up or trial
  capture (where it returns the walkers' logl and blob rows as they are)
  and none for a chunk's step past the stop. That is `io_callback`'s
  guarantee, which object blobs need (`BlobSchema.pack` appends to the
  host store).

Every batched likelihood takes `(x, active=None, logl=None, blobs=None)`:
an MCMC step hands it its `active` flag and the walkers' own logl and blob
rows, which only the host crossing uses (the torch ones ignore them).

A per-point function under `torch.func.vmap` has the limits of one under
`jax.vmap`: it cannot call `.item()`, convert to Python numbers or numpy,
or branch on the values of its input. Use `torch.where` for branches, or
`host_likelihood=True` for code that must see numbers.

The batched log-likelihood returns (logl (N,), blobs (N, B) or None): the
blob of a point is its likelihood's trailing return values, flattened and
laid out in order (:141-161), described by a `BlobSchema`.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops import cuda_host
from .blobs import BlobSchema, infer_np_dtype_from_result


class FunctionWrapper:
    """Picklable closure binding extra args/kwargs."""

    def __init__(self, f: Callable, args: Optional[List[Any]], kwargs: Optional[Dict[str, Any]]):
        self.f = f
        self.args = [] if args is None else args
        self.kwargs = {} if kwargs is None else kwargs

    def __call__(self, x):
        return self.f(x, *self.args, **self.kwargs)


def build_prior_transform(prior_transform: Callable, vectorize: bool) -> Callable:
    """Batched u (N, d) -> x (N, d)."""
    if vectorize:
        return prior_transform
    return torch.func.vmap(prior_transform)


class SpawnPoolMap:
    """`map` over a pool of `size` spawned processes, made at the first call.

    Spawn, not fork: forking a process that holds a CUDA context or
    threads can deadlock. Spawned workers import the likelihood by name, so
    it must be picklable (a module-level function). `close()` ends the
    workers.
    """

    def __init__(self, size: int):
        self.size = size
        self.pool = None

    def __call__(self, f: Callable, xs: list) -> list:
        if self.pool is None:
            import multiprocessing

            self.pool = multiprocessing.get_context("spawn").Pool(self.size)
        return self.pool.map(f, xs)

    def close(self) -> None:
        if self.pool is not None:
            self.pool.close()
            self.pool.join()
            self.pool = None


def make_pool_map(pool) -> Callable:
    """The host map of `pool` (tempest_tpu/utils/wrappers.py:43-69): None ->
    a list comprehension; an int -> a `SpawnPoolMap` of that size; an object
    with `.map` (an MPI pool, say) -> its map."""
    if pool is None:
        return lambda f, xs: [f(x) for x in xs]
    if isinstance(pool, int):
        return SpawnPoolMap(pool)
    if hasattr(pool, "map"):
        return lambda f, xs: list(pool.map(f, xs))
    raise ValueError(f"pool must be None, an int, or expose .map; got {type(pool)}")


def build_log_likelihood(
    log_likelihood: Callable,
    vectorize: bool,
    have_blobs: bool,
    host_likelihood: bool,
    dtype=torch.float32,
    schema: Optional[BlobSchema] = None,
    pool_map: Optional[Callable] = None,
) -> Callable:
    """Batched `(x (N, d), active=None, logl=None, blobs=None) -> (logl (N,)
    of `dtype`, blobs (N, B) or None)`; only the host crossing uses the
    step's `active` flag and the walkers' rows.

    `schema` describes the blob rows when `have_blobs`; `pool_map` is the
    host map of `host_likelihood=True` (default: a list comprehension).
    """
    if host_likelihood:
        return HostLikelihood(log_likelihood, pool_map or make_pool_map(None), dtype,
                              schema if have_blobs else None)

    if vectorize:
        # Already batched; blobs need per-point calls (the config checks).
        def batched_vec(x, active=None, logl=None, blobs=None):
            return torch.as_tensor(log_likelihood(x)).to(dtype), None

        return batched_vec

    if have_blobs:

        def per_point(x):
            out = log_likelihood(x)
            logl, elems = out[0], out[1:]
            flat = [torch.atleast_1d(torch.as_tensor(e, device=x.device)).reshape(-1)
                    for e in elems]
            blob = torch.cat(flat) if len(flat) > 1 else flat[0]
            return torch.as_tensor(logl).to(dtype), blob.to(schema.device_dtype)

        vmapped_blobs = torch.func.vmap(per_point)

        def batched_blobs(x, active=None, logl=None, blobs=None):
            return vmapped_blobs(x)

        return batched_blobs

    def per_point_plain(x):
        return torch.as_tensor(log_likelihood(x)).to(dtype)

    vmapped = torch.func.vmap(per_point_plain)

    def batched(x, active=None, logl=None, blobs=None):
        return vmapped(x), None

    return batched


# The numpy types of the points a host likelihood takes.
_NUMPY = {torch.float32: np.float32, torch.float64: np.float64}


class HostLikelihood:
    """The host crossing of `host_likelihood=True`: `crossing(x, active=None,
    logl=None, blobs=None) -> (logl (N,) of `dtype`, blobs (N, B) or None)`
    for points x (N, d), the likelihood evaluated on the host through
    `pool_map` (one call a sweep). `active` is an MCMC step's 0-d bool (None:
    always, as in the warm-up); where it is false, `logl` and `blobs`, the
    walkers' own, come back as they are and nothing is called.

    The route follows the points' device alone: a CPU tensor takes `plain`,
    a CUDA tensor the host-call kernel. On the card inside a stretch's
    capture it is `kernel`, recorded in the graph, whose replays serve it;
    in the capture's warm-up or trial nothing is called (the walkers' rows
    come back, zeros where there are none: the warm-up's results are
    dropped); everywhere else (eagerly, a run's first iteration) it is
    `kernel_call`, served here. `bind(loops)` ties it to an iteration's
    loops (`iteration.make_iteration` binds it): their counted reads, the
    stretch they are in and, on a CUDA device, their `halt` word, which is
    `failed`, the word the kernel sets where the likelihood raised, and
    which the predicates of the loops around the call AND in. Unbound it
    reads uncounted and is never inside a stretch."""

    def __init__(self, log_likelihood: Callable, pool_map: Callable, dtype,
                 schema: Optional[BlobSchema] = None):
        self.log_likelihood, self.pool_map = log_likelihood, pool_map
        self.dtype, self.schema = dtype, schema
        self.loops = None  # a loops.Loops, once bound
        self.failed: Optional[torch.Tensor] = None
        self._boxes: Dict[tuple, cuda_host.Mailbox] = {}

    def bind(self, loops) -> None:
        """Run through `loops` (a `loops.Loops`): its reads, stretches and
        `halt` word."""
        self.loops = loops
        if loops.device.type == "cuda":
            loops.halt = self._failed(loops.device)

    def _failed(self, device) -> torch.Tensor:
        if self.failed is None:
            self.failed = torch.zeros(1, dtype=torch.int32, device=device)
        return self.failed

    def evaluate(self, points: np.ndarray):
        """The likelihood of each row of `points` (n, d, read-only) on the
        host, one `pool_map` call: (logl (n,) float32, blob rows (n, B) or
        None)."""
        out = self.pool_map(self.log_likelihood, list(points))
        if self.schema is None:
            return np.array([float(v) for v in out], dtype=np.float32), None
        logl = np.array([float(o[0]) for o in out], dtype=np.float32)
        return logl, self.schema.pack([tuple(o[1:]) for o in out])

    def __call__(self, x: torch.Tensor, active: Optional[torch.Tensor] = None,
                 logl: Optional[torch.Tensor] = None, blobs: Optional[torch.Tensor] = None):
        if x.device.type != "cuda":
            return self.plain(x, active, logl, blobs)
        loops = self.loops
        if loops is not None and loops.capturing:
            return self.kernel(x, active, logl, blobs)
        if loops is not None and loops.inside:  # a capture's warm-up or trial: no call
            self.mailbox(x)  # made here, before the capture
            return self._unchanged(x, logl, blobs)
        return self.kernel_call(x, active, logl, blobs)

    def plain(self, x: torch.Tensor, active: Optional[torch.Tensor] = None,
              logl: Optional[torch.Tensor] = None, blobs: Optional[torch.Tensor] = None):
        """The plain crossing, the host-call kernel's plain version (the
        route of CPU tensors): one read of `x` and the step's `active` flag
        (with the predicates of the conditional bodies a stretch's warm-up
        is in, `Loops.guards`), counted as the loop "likelihood"'s where
        bound; the call where they all hold."""
        n, d = x.shape
        flags = [] if active is None else [active]
        if self.loops is None:
            values = torch.cat([t.detach().reshape(-1).to(torch.float64)
                                for t in (x, *flags)]).cpu().numpy()
        else:
            values = self.loops.fetch("likelihood", x, *flags, *self.loops.guards)
        if not np.all(values[n * d:]):
            return self._unchanged(x, logl, blobs)
        points = values[:n * d].astype(_NUMPY[x.dtype]).reshape(n, d)
        points.flags.writeable = False  # as the kernel's, and JAX's callback's
        out, rows = self.evaluate(points)
        new = torch.from_numpy(out).to(device=x.device, dtype=self.dtype)
        return new, None if rows is None else torch.from_numpy(rows).to(x.device)

    def kernel(self, x: torch.Tensor, active: Optional[torch.Tensor] = None,
               logl: Optional[torch.Tensor] = None, blobs: Optional[torch.Tensor] = None):
        """The host-call kernel on the current stream (inside a capture of
        the bound loops, recorded in the graph, whose replays serve it): the
        results where `active` holds, else `logl` and `blobs`. Outside a
        graph the caller serves it (`kernel_call`)."""
        box = self.mailbox(x)
        if self.loops is not None and self.loops.capturing:
            self.loops.note_host(box)
        # Every tensor is made, and an inactive step's rows copied, before
        # the launch, and nothing after it: outside a graph a CUDA allocation
        # or a kernel's first load after it would wait for the device, which
        # waits for the host.
        n = x.shape[0]
        x = x.contiguous()
        if active is None:
            new = torch.empty(n, dtype=self.dtype, device=x.device)
            rows = None if self.schema is None else torch.empty(
                (n, self.schema.width), dtype=self.schema.device_dtype, device=x.device)
        else:
            new = logl.to(self.dtype, copy=True)
            rows = None if self.schema is None else blobs.clone()
        box.launch(x, None if active is None else active.reshape(1), new, rows)
        return new, rows

    def kernel_call(self, x: torch.Tensor, active: Optional[torch.Tensor] = None,
                    logl: Optional[torch.Tensor] = None, blobs: Optional[torch.Tensor] = None):
        """`kernel` outside any graph, served on this thread until it ends."""
        result = []
        cuda_host.served(lambda: result.append(self.kernel(x, active, logl, blobs)),
                         [self.mailbox(x)])
        return result[0]

    def mailbox(self, x: torch.Tensor) -> cuda_host.Mailbox:
        """The mailbox of points shaped and typed as `x`, made on first use
        (outside any capture), kept for this crossing's life."""
        key = (tuple(x.shape), x.dtype, x.device)
        if key not in self._boxes:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a host call met a capture before its warm-up: its mailbox "
                                   "is made outside any capture")
            width = 0 if self.schema is None else self.schema.width
            blob_dtype = np.float32 if self.schema is None else self.schema.row_dtype
            self._boxes[key] = cuda_host.Mailbox(
                x.shape[0], x.shape[1], _NUMPY[x.dtype], width, blob_dtype, x.device,
                self.evaluate, self._failed(x.device))
        return self._boxes[key]

    def _unchanged(self, x: torch.Tensor, logl, blobs):
        """The walkers' own rows (zeros where none are given)."""
        n = x.shape[0]
        if logl is None:
            logl = torch.zeros(n, dtype=self.dtype, device=x.device)
        if self.schema is None:
            return logl, None
        if blobs is None:
            blobs = torch.zeros((n, self.schema.width), dtype=self.schema.device_dtype,
                                device=x.device)
        return logl, blobs


def _np_dtype(value) -> np.dtype:
    """The numpy dtype of a returned value's torch dtype."""
    return torch.empty(0, dtype=torch.as_tensor(value).dtype).numpy().dtype


def _probe_returns(log_likelihood: Callable, n_dim: int):
    """The per-point function's return on a (n_dim,) tensor on the meta
    device, which has shapes and dtypes but no values: nothing is computed.
    None when the function raises there (it converts to numbers, builds CPU
    tensors, ...), as a failing `jax.eval_shape` is taken in JAX."""
    try:
        return log_likelihood(torch.empty(n_dim, device="meta"))
    except Exception:  # any failure of the user's code on meta means: no blobs
        return None


def _width(elems) -> int:
    """The flattened width of the trailing values (a scalar counts 1)."""
    return sum(max(torch.as_tensor(e).numel(), 1) for e in elems)


def build_blob_schema(
    log_likelihood: Callable,
    n_dim: int,
    have_blobs: bool,
    host_likelihood: bool,
    blobs_dtype=None,
    declared_size: Optional[int] = None,
    prior_transform: Optional[Callable] = None,
    vectorize: bool = False,
) -> Optional[BlobSchema]:
    """The blob layout, or None (tempest_tpu/utils/wrappers.py:174-252).

    - A structured, object or string `blobs_dtype` fixes the layout.
    - A simple numeric `blobs_dtype`: the width is `blob_size`, else read
      from the meta-device probe (torch functions), else from ONE host
      evaluation at the prior midpoint, with a warning (host likelihoods).
    - No `blobs_dtype`: a per-point torch likelihood is probed on the meta
      device; a tuple of two or more values means blobs, of the trailing
      values' dtype. Host and vectorized likelihoods have no blobs unless
      declared. Apart from the one host evaluation above, no likelihood is
      evaluated on real data at construction.
    """
    if blobs_dtype is None and not have_blobs:
        if host_likelihood or vectorize:
            return None
        out = _probe_returns(log_likelihood, n_dim)
        if not isinstance(out, (tuple, list)) or len(out) < 2:
            return None
        elems = out[1:]
        np_dtype = np.result_type(*[_np_dtype(e) for e in elems])
        return BlobSchema(np_dtype, blob_size=_width(elems))

    if not have_blobs:
        return None

    dt = np.dtype(blobs_dtype) if blobs_dtype is not None else np.dtype(np.float32)
    if dt.fields is not None or dt.kind in "USO":
        return BlobSchema(dt)  # the dtype fixes the width

    if declared_size is not None:
        return BlobSchema(dt, blob_size=int(declared_size))
    if host_likelihood:
        warnings.warn(
            "host_likelihood=True with blobs and no blob_size: inferring the "
            "blob width requires ONE likelihood evaluation at construction "
            "(at the prior midpoint). Pass blob_size=<int> (or a structured "
            "blobs_dtype) to avoid it for expensive or stateful likelihoods.",
            UserWarning,
            stacklevel=3,
        )
        mid = torch.full((n_dim,), 0.5)
        x_mid = prior_transform(mid) if prior_transform is not None else mid
        out = log_likelihood(np.asarray(torch.as_tensor(x_mid).detach().cpu().numpy()))
        width = int(sum(np.atleast_1d(e).size for e in out[1:]))
        if blobs_dtype is None:
            dt = infer_np_dtype_from_result(out[1] if len(out) == 2 else tuple(out[1:]))
            if dt.fields is not None or dt.kind in "USO":
                return BlobSchema(dt)
        return BlobSchema(dt, blob_size=width)
    out = log_likelihood(torch.empty(n_dim, device="meta"))
    return BlobSchema(dt, blob_size=_width(out[1:]))
