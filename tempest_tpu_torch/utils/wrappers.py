"""Likelihood and prior-transform wrapping.

Counterpart of tempest_tpu/utils/wrappers.py. Three forms of model
function, as there:

- default (`vectorize=False`): per-point torch functions of one (d,)
  point, mapped over the particle axis with `torch.func.vmap` as JAX maps
  them with `jax.vmap` (:40, :155, :166);
- `vectorize=True`: torch functions that already take (N, d) batches;
- `host_likelihood=True`: any Python function of one numpy point (float32,
  shape (d,)), called on the host through `pool_map`, with the result
  moved back to the particles' device. This is the port's
  `jax.pure_callback` (:88-131): the run crosses to the host by design.

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
    """Batched x (N, d) -> (logl (N,) of `dtype`, blobs (N, B) or None).

    `schema` describes the blob rows when `have_blobs`; `pool_map` is the
    host map of `host_likelihood=True` (default: a list comprehension).
    """
    if host_likelihood:
        pool_map = pool_map or make_pool_map(None)

        def batched_host(x):
            out = pool_map(log_likelihood, list(x.detach().cpu().numpy()))
            if have_blobs:
                logl = np.array([float(o[0]) for o in out], dtype=np.float32)
                rows = schema.pack([tuple(o[1:]) for o in out])
                blobs = torch.from_numpy(rows).to(x.device)
            else:
                logl = np.array([float(v) for v in out], dtype=np.float32)
                blobs = None
            return torch.from_numpy(logl).to(device=x.device, dtype=dtype), blobs

        return batched_host

    if vectorize:
        # Already batched; blobs need per-point calls (the config checks).
        def batched_vec(x):
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

        return torch.func.vmap(per_point)

    def per_point_plain(x):
        return torch.as_tensor(log_likelihood(x)).to(dtype)

    vmapped = torch.func.vmap(per_point_plain)

    def batched(x):
        return vmapped(x), None

    return batched


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
