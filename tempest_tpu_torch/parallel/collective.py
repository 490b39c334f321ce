"""Explicit collectives of the two stages that read the whole sharded history
(tempest_tpu/parallel/collective.py).

1. Resampling draws the new active set from the global weight CDF and
   gathers the chosen rows from the sharded history. Each rank builds its
   slice of the canonical-order CDF from an all-gather of the (W, T) row
   masses, claims the positions that fall in its intervals, and one
   reduce-scatter hands each rank its block of the new set: O(N d) bytes,
   never the history.
2. Fit-point selection (the heaviest samples, for the geometry fits) takes
   a local top-k on each rank and merges the candidates with one
   all-gather: O(W m d) bytes. The merged set is replicated, which is what
   the clustering and Student-t fits want: they run alike on every rank.

The canonical sample order is t-major, s = t N + r N/W + n, as on one
device, so a sharded run selects what an unsharded one does, up to the
rounding of sums taken in another order.

One departure from JAX, which only makes the claim exact: here the block
edges of the CDF come from one scan of the (T, W) block masses, and each
block's intervals are clamped to end exactly at its edge. The intervals
then tile (0, total] without gap or overlap, so every position is claimed
by exactly one rank and the reduce-scatter always adds one row to zeros.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import TRIM_BINS, TRIM_ESS
from ..ops.tools import cumsum, trim_weights_mask
from ..state import History
from .mesh import all_gather


def positions(uniforms: torch.Tensor, n: int, method: str) -> torch.Tensor:
    """The resampler's CDF positions in [0, 1) from its draws
    (collective.py:42-54): (u0 + i) / n for "syst", the n uniforms for
    "mult"."""
    if method == "syst":
        return (uniforms.reshape(()) + torch.arange(n, dtype=uniforms.dtype,
                                                    device=uniforms.device)) / n
    if method == "mult":
        return uniforms
    raise ValueError(f"Unknown resample method {method}")


def _local_cdf(w_loc: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This rank's CDF intervals (collective.py:57-81): flat (T N_loc,)
    `cdf` and `prev`, where local sample (t, j) owns the global interval
    (prev, cdf], and the global total weight."""
    world, me = dist.get_world_size(group), dist.get_rank(group)
    T = w_loc.shape[0]
    within = cumsum(w_loc)  # (T, N_loc)
    masses = all_gather(within[:, -1:].T.contiguous(), group, 0)  # (W, T)
    edges = cumsum(masses.T.reshape(-1))  # block ends in canonical order
    ends = edges.reshape(T, world)[:, me]
    starts = torch.cat([torch.zeros_like(edges[:1]), edges[:-1]]).reshape(T, world)[:, me]
    cdf = torch.minimum(within + starts[:, None], ends[:, None])
    cdf[:, -1] = ends
    prev = torch.cat([starts[:, None], cdf[:, :-1]], dim=1)
    return cdf.reshape(-1), prev.reshape(-1), edges[-1]


def _claim(cdf, prev, total, pos) -> Tuple[torch.Tensor, torch.Tensor]:
    """Which positions this rank serves, and with which local flat index
    (collective.py:84-98). Positions are clamped into (0, total], the
    counterpart of the unsharded guard cdf[-1] = 1."""
    size = cdf.shape[0]
    # The upper clamp is a tensor op: clamp(max=<0-d tensor>) reads it on the host.
    p = torch.minimum(torch.clamp(pos.to(cdf.dtype), min=torch.finfo(cdf.dtype).tiny), total)
    li = torch.searchsorted(cdf, p, right=False)
    li_c = torch.clamp(li, 0, size - 1)
    claimed = (li < size) & (prev[li_c] < p) & (cdf[li_c] >= p)
    return claimed, li_c


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    world = dist.get_world_size(group)
    out = torch.empty((x.shape[0] // world,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM, group=group)
    return out


def gather_rows(pos: torch.Tensor, w_loc: torch.Tensor, arrays: Sequence[torch.Tensor],
                group) -> List[torch.Tensor]:
    """The rows that the global positions `pos` pick from the sharded
    weights `w_loc` (T, N_loc), as this rank's block: for each (B, T, N_loc)
    array, (len(pos) / W, B) rows. Arrays of one dtype share one
    reduce-scatter."""
    cdf, prev, total = _local_cdf(w_loc, group)
    claimed, li = _claim(cdf, prev, total, pos)
    parts = []
    for arr in arrays:
        rows = arr.reshape(arr.shape[0], -1)[:, li].T
        parts.append(torch.where(claimed[:, None], rows, torch.zeros_like(rows)))
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for dtype in dict.fromkeys(p.dtype for p in parts):
        idx = [i for i, p in enumerate(parts) if p.dtype == dtype]
        summed = _reduce_scatter(torch.cat([parts[i] for i in idx], dim=1), group)
        for i, piece in zip(idx, torch.split(summed, [parts[i].shape[1] for i in idx], dim=1)):
            out[i] = piece
    return out


def sharded_resample(
    pos: torch.Tensor, hist: History, weights: torch.Tensor, group
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(u, x, logl, blobs) of this rank's block of the new active set
    (collective.py:101-163); `pos` are the global positions (`positions`),
    `weights` this rank's (T, N_loc) block of the normalized weights."""
    arrays = [hist.u, hist.x, hist.logl[None]]
    if hist.blobs is not None:
        arrays.append(hist.blobs)
    out = gather_rows(pos, weights, arrays, group)
    return out[0], out[1], out[2][:, 0], (out[3] if hist.blobs is not None else None)


def sharded_select_fit_points(
    u: torch.Tensor, weights: torch.Tensor, t: int, m: int, group
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(u_fit (m, d), w_fit (m,), keep (m,)): the trimmed global top-m
    samples by weight, replicated on every rank (collective.py:166-252).

    When each rank's candidates cover its whole block (m >= S_loc, with
    S_loc = capacity N_loc), the gathered set is the whole weight vector and
    the 0.99-ESS trim runs on it as on one device; the top-m are then taken
    by weight, ties by canonical index, as `jax.lax.top_k` orders them on
    one device. Otherwise the trim is skipped, as in JAX: every sample that
    could survive it and the top-m is among the candidates, whose weights
    are renormalized instead."""
    world, me = dist.get_world_size(group), dist.get_rank(group)
    d = u.shape[0]
    T, n_loc = weights.shape
    N = n_loc * world
    w_flat = weights.reshape(-1)
    k_loc = min(m, T * n_loc)
    full = k_loc == T * n_loc

    li = torch.argsort(-w_flat, stable=True)[:k_loc]  # weight down, index up
    gidx = (li // n_loc) * N + me * n_loc + li % n_loc  # canonical sample index
    all_vals = all_gather(w_flat[li], group, 0)
    all_idx = all_gather(gidx, group, 0)
    all_rows = all_gather(u.reshape(d, -1)[:, li].T, group, 0)

    if full:
        keep, w_cand = trim_weights_mask(all_vals, mask=(all_idx // N) < t, ess=TRIM_ESS,
                                         bins=TRIM_BINS)
    else:
        keep = all_vals > 0
        w_cand = all_vals / torch.clamp(torch.sum(all_vals), min=torch.finfo(all_vals.dtype).tiny)

    by_index = torch.argsort(all_idx)
    if m >= T * N:  # the whole history, in canonical order
        perm = by_index
    else:
        perm = by_index[torch.argsort(-w_cand[by_index], stable=True)]
    sel = perm[:m]
    return all_rows[sel], w_cand[sel], keep[sel]


def broadcast_from_first(obj, group):
    """The dataclass `obj` as the group's first rank holds it, on every rank:
    its tensor fields go out in one broadcast per dtype."""
    if dist.get_world_size(group) == 1:
        return obj
    fields = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
              if isinstance(getattr(obj, f.name), torch.Tensor)}
    src = dist.get_global_rank(group, 0)
    new = {}
    for dtype in dict.fromkeys(t.dtype for t in fields.values()):
        names = [k for k, t in fields.items() if t.dtype == dtype]
        wire = torch.uint8 if dtype == torch.bool else dtype
        flat = torch.cat([fields[k].reshape(-1).to(wire) for k in names])
        dist.broadcast(flat, src=src, group=group)
        for k, piece in zip(names, torch.split(flat, [fields[k].numel() for k in names])):
            new[k] = piece.reshape(fields[k].shape).to(dtype)
    return dataclasses.replace(obj, **new)
