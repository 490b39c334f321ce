"""Checkpoint and resume: the sampler state as one npz file.

Counterpart of tempest_tpu/utils/checkpoint.py `save_checkpoint` /
`load_checkpoint` (:42-187), in the same file format, so each package
reads the other's files:

- `np.savez` of the history and current-state leaves under `hist.<field>`
  and `cur.<field>`, blob rows included (History (d, T, N) layout), plus a
  `__meta__` JSON: format version 2, the caller's `meta`, `has_blobs`,
  `calls_units` ("sweeps") and `has_blob_store`; object-blob payloads as
  the pickled object array `blob_store`, loaded with pickle allowed only
  when the file declares it;
- the write goes to `<path>.temp`, is flushed and fsynced, then renamed
  over `path`, so a reader never sees half a file.

Draw state. The port cannot continue JAX's threefry key, nor JAX the
port's generator, so each package keeps its own under names of its own.
The port writes `"rng": "torch"` into the meta and its whole draw state
(`Draws.get_state`: the generator state, and where the draws are keyed
the Philox key and call counter, `step_key` and `step_counter` (a
float64 run's on the card, either flag), or `philox_key` and
`philox_counter` for `HardwareDraws`) under `draws.<name>`, and the carried cluster
model under `model.<field>`. It also writes `rng_key`, the run's seed as
a threefry key (`Draws.key_words`), so the JAX package loads a port file
and continues from that key; the port itself reads its own draw state. A generator's state belongs to its device
type (a CUDA generator's is its seed and offset), so a file resumes on the
device type it was written on; loading it elsewhere raises from PyTorch.
A file the JAX package wrote has `rng_key`
instead: the port then re-seeds its draws with `seed_from_key_words` of
those words (documented in `draws.py`) and refits the cluster model, and
the resumed run agrees with JAX statistically, as every whole run does.

Files of format 1 load too: their (T, N, d) coordinate buffers are moved
to (d, T, N), a missing `mis_c` accumulator is rebuilt, and raw call
counts become sweeps. Every tensor is loaded onto the given device.

Float dtypes. A file holds the state in the dtype of the run that wrote it,
and the port and JAX write the same arrays, so a JAX x64 file loads into a
float64 sampler as it is, and a float64 port file into JAX with x64. The
state of a file in another float dtype than the sampler's (not the blob
rows, whose dtype is the schema's) is cast to the sampler's: JAX without
x64 casts a float64 file down to float32 the same way (`jnp.asarray`).
JAX with x64 keeps a float32 file's arrays in float32 and runs on at mixed
precision; the port casts them up, so a run stays in one dtype.

Sharded checkpoints (:189-407), for a run over a particle mesh of more than
one rank, in JAX's layout: a directory with `shard_{rank}/<leaf>.npy`, each
rank's block of every particle-indexed leaf, beside that rank's
`ranges.json` (the [start, stop) it holds); `replicated.npz`, the
replicated leaves with `rng_key`, the port's `draws.*` and `model.*`; and
`meta.json` (`kind: "sharded"`, the leaves' global shapes, dtypes and
particle axes, every rank's ranges), written last by rank 0 as the commit
marker. Every rank writes only its own block, to a temporary directory
renamed into place; two barriers order the shards, the manifest and the
return. Loading reads, from whichever shards cover it, only this rank's
block, so a file loads whatever the number of ranks that wrote it: one
JAX process over eight devices writes one shard, which two ranks split.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..cluster import ClusterModel
from ..interop import CLUSTER_FIELDS, CURRENT_COUNTERS, CURRENT_FIELDS, HISTORY_FIELDS
from ..parallel.mesh import block, current_sharding, history_sharding
from ..state import Current, History, rebuild_mis_c
from .host import fetch, sync

FORMAT_VERSION = 2  # v2: coordinates (d, T, N), blobs (B, T, N); v1: (T, N, d)


@dataclasses.dataclass
class Checkpoint:
    """What a checkpoint file holds, loaded onto a device."""

    hist: History
    cur: Current
    meta: dict
    blob_store: Optional[list]  # object-blob payloads, or None
    draws: Optional[Dict[str, np.ndarray]]  # the port's draw state, or None
    rng_key: Optional[np.ndarray]  # a JAX file's threefry key words, or None
    model: Optional[ClusterModel]  # the carried cluster model, or None


def _state_arrays(hist: History, cur: Current) -> Dict[str, np.ndarray]:
    """The state leaves under JAX's names (hist.<field>, cur.<field>)."""
    arrays = {f"hist.{k}": fetch(getattr(hist, k)) for k in HISTORY_FIELDS}
    arrays["hist.t"] = np.asarray(hist.count(), dtype=np.int32)
    arrays.update({f"cur.{k}": fetch(getattr(cur, k)) for k in CURRENT_FIELDS})
    arrays.update({f"cur.{k}": np.asarray(int(getattr(cur, k)), dtype=np.int32)
                   for k in CURRENT_COUNTERS})
    if hist.blobs is not None:
        arrays["hist.blobs"] = fetch(hist.blobs)
        arrays["cur.blobs"] = fetch(cur.blobs)
    return arrays


def _run_arrays(draw_state: Dict[str, np.ndarray], rng_key, model) -> Dict[str, np.ndarray]:
    """The draw state, the key for the JAX package and the carried model."""
    arrays = {f"draws.{k}": np.asarray(v) for k, v in draw_state.items()}
    if rng_key is not None:
        arrays["rng_key"] = np.asarray(rng_key, dtype=np.uint32)
    if model is not None:
        arrays.update({f"model.{k}": fetch(getattr(model, k)) for k in CLUSTER_FIELDS})
        arrays["model.normalize"] = np.asarray(model.normalize)
        arrays["model.fitted"] = np.asarray(bool(model.fitted))
    return arrays


def _payload(meta, hist: History, has_blob_store: bool) -> dict:
    return {
        "format_version": FORMAT_VERSION,
        "meta": meta or {},
        "has_blobs": hist.blobs is not None,
        "calls_units": "sweeps",  # 1 sweep = n_particles likelihood calls
        "has_blob_store": has_blob_store,
        "rng": "torch",
    }


def _write_atomic(path: Path, write: Callable) -> None:
    """`write(f)` into `<path>.temp`, flushed and fsynced, then renamed over
    `path`, so a reader never sees half a file."""
    tmp = path.with_name(path.name + ".temp")
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)


def save_checkpoint(
    path: Union[str, Path],
    hist: History,
    cur: Current,
    draw_state: Dict[str, np.ndarray],
    meta: Optional[dict] = None,
    blob_store: Optional[list] = None,
    model: Optional[ClusterModel] = None,
    rng_key: Optional[np.ndarray] = None,
) -> None:
    """Write the sampler state to `path`, atomically; `rng_key` (two
    uint32 words) is the key the JAX package continues from."""
    path = Path(path)
    arrays = {**_state_arrays(hist, cur), **_run_arrays(draw_state, rng_key, model)}
    payload = _payload(meta, hist, blob_store is not None)
    if blob_store is not None:
        store = np.empty((len(blob_store),), dtype=object)
        store[:] = blob_store
        arrays["blob_store"] = store
    path.parent.mkdir(parents=True, exist_ok=True)
    _write_atomic(path, lambda f: np.savez(f, __meta__=json.dumps(payload), **arrays))


def _particle_axes() -> Dict[str, Optional[int]]:
    """The particle axis of every state leaf, by its name in the file."""
    return {**{f"hist.{k}": d for k, d in history_sharding().items()},
            **{f"cur.{k}": d for k, d in current_sharding().items()}}


def save_checkpoint_sharded(
    path: Union[str, Path],
    hist: History,
    cur: Current,
    draw_state: Dict[str, np.ndarray],
    group,
    meta: Optional[dict] = None,
    model: Optional[ClusterModel] = None,
    rng_key: Optional[np.ndarray] = None,
) -> None:
    """Write this rank's block of the state into the directory `path`
    (utils/checkpoint.py:213-333); every rank of `group` calls it. No rank
    gathers the history: each writes only its own block."""
    path = Path(path)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    path.mkdir(parents=True, exist_ok=True)
    axes = _particle_axes()
    leaves, replicated, my_ranges = {}, {}, {}
    tmp_dir = path / f".shard_{rank}.tmp"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    for name, arr in _state_arrays(hist, cur).items():
        ax = axes[name]
        shape = list(arr.shape)
        if ax is None:
            replicated[name] = arr
        else:
            np.save(tmp_dir / f"{name}.npy", arr)
            my_ranges[name] = [rank * shape[ax], (rank + 1) * shape[ax]]
            shape[ax] *= world
        leaves[name] = {"shape": shape, "dtype": str(arr.dtype), "axis": ax}
    with open(tmp_dir / "ranges.json", "w") as f:
        json.dump(my_ranges, f)
    final_dir = path / f"shard_{rank}"
    if final_dir.exists():
        shutil.rmtree(final_dir)
    os.rename(tmp_dir, final_dir)
    sync(group)

    if rank == 0:
        replicated.update(_run_arrays(draw_state, rng_key, model))
        _write_atomic(path / "replicated.npz", lambda f: np.savez(f, **replicated))
        ranges = {}
        for p in range(world):
            with open(path / f"shard_{p}" / "ranges.json") as f:
                ranges[str(p)] = json.load(f)
        manifest = {**_payload(meta, hist, False), "kind": "sharded", "n_processes": world,
                    "leaves": leaves, "ranges": ranges}
        _write_atomic(path / "meta.json", lambda f: f.write(json.dumps(manifest).encode()))
    sync(group)


def _checkpoint(read: Callable[[str], np.ndarray], names, payload: dict, device, dtype,
                legacy_layout: bool = False, store=None) -> Checkpoint:
    """The Checkpoint of a file's arrays: `read(name)` gives the array of a
    leaf as this process holds it, `names` the leaves the file has."""

    def get(name, cast=True):
        arr = torch.from_numpy(np.array(read(name), copy=True)).to(device)
        if cast and dtype is not None and arr.is_floating_point():
            arr = arr.to(dtype)
        return arr

    def get_tdn(name, cast=True):
        """A history coordinate buffer, moved from v1's (T, N, B)."""
        arr = get(name, cast)
        return torch.movedim(arr, -1, 0).contiguous() if legacy_layout else arr

    has_blobs = bool(payload["has_blobs"])
    fields = {k: get(f"hist.{k}") for k in HISTORY_FIELDS if k not in ("u", "x", "mis_c")}
    fields["u"], fields["x"] = get_tdn("hist.u"), get_tdn("hist.x")
    rebuild = "hist.mis_c" not in names  # the accumulator came after format 1
    fields["mis_c"] = (torch.full_like(fields["logl"], float("-inf")) if rebuild
                       else get("hist.mis_c"))
    hist = History(**fields, t=int(read("hist.t")),
                   blobs=get_tdn("hist.blobs", cast=False) if has_blobs else None)
    cur = Current(
        **{k: get(f"cur.{k}") for k in CURRENT_FIELDS},
        **{k: int(read(f"cur.{k}")) for k in CURRENT_COUNTERS},
        blobs=get("cur.blobs", cast=False) if has_blobs else None,
    )
    if rebuild:
        hist = rebuild_mis_c(hist)
    if payload.get("calls_units") != "sweeps":  # raw call counts
        n = cur.u.shape[0]
        hist.calls = hist.calls // n
        cur.calls = cur.calls // n

    draws = {k[len("draws."):]: np.array(read(k)) for k in names
             if k.startswith("draws.")} or None
    rng_key = np.array(read("rng_key")) if "rng_key" in names else None
    model = None
    if "model.centers" in names:
        model = ClusterModel(**{k: get(f"model.{k}") for k in CLUSTER_FIELDS},
                             normalize=bool(read("model.normalize")),
                             fitted=bool(read("model.fitted")))
    return Checkpoint(hist=hist, cur=cur, meta=payload["meta"], blob_store=store,
                      draws=draws, rng_key=rng_key, model=model)


def load_checkpoint(path: Union[str, Path], device, dtype=None) -> Checkpoint:
    """Read a checkpoint of either package onto `device`, its float state
    in `dtype` (default: the file's)."""
    path = Path(path)
    with np.load(path, allow_pickle=False) as probe:
        payload = json.loads(str(probe["__meta__"]))
    allow_pickle = bool(payload.get("has_blob_store", False))
    with np.load(path, allow_pickle=allow_pickle) as data:
        store = list(data["blob_store"]) if allow_pickle and "blob_store" in data else None
        return _checkpoint(lambda name: data[name], set(data.files), payload, device, dtype,
                           legacy_layout=payload.get("format_version", 1) < 2, store=store)


def load_checkpoint_sharded(path: Union[str, Path], device, dtype, group) -> Checkpoint:
    """This rank's block of a sharded checkpoint of either package
    (utils/checkpoint.py:336-407): each particle-indexed leaf is read, by
    memory map, from the shards whose ranges cover this rank's block."""
    path = Path(path)
    with open(path / "meta.json") as f:
        manifest = json.load(f)
    slabs: Dict[str, list] = {}
    for p, ranges in manifest["ranges"].items():
        for name, (start, stop) in ranges.items():
            slabs.setdefault(name, []).append((start, stop, path / f"shard_{p}" / f"{name}.npy"))
    with np.load(path / "replicated.npz") as rep:
        replicated = {k: rep[k] for k in rep.files}

    def read(name):
        info = manifest["leaves"].get(name)
        if info is None or info["axis"] is None:
            return replicated[name]
        ax = info["axis"]
        lo, hi = block(info["shape"][ax], group)
        parts = []
        for start, stop, file in sorted(slabs[name]):
            a, b = max(lo, start), min(hi, stop)
            if a < b:
                arr = np.load(file, mmap_mode="r")
                index = [slice(None)] * arr.ndim
                index[ax] = slice(a - start, b - start)
                parts.append(np.array(arr[tuple(index)]))
        return np.concatenate(parts, axis=ax)

    return _checkpoint(read, set(manifest["leaves"]) | set(replicated), manifest, device, dtype)
