"""Blob schema: user-facing blob values to and from the device's numeric rows.

Counterpart of tempest_tpu/utils/blobs.py (`BlobSchema` :43-157,
`infer_np_dtype_from_result` :159-171), which it copies: the package keeps
its own copy and imports nothing of `tempest_tpu`. The trailing return
values of a per-point likelihood form that point's blob. The history holds
blobs as a flat numeric (B, T, N) tensor (`state.History.blobs`), and this
module translates:

- simple numeric dtypes: fields flattened to B numeric slots; unpack
  restores the dtype and squeezes a width-1 blob to shape (n,);
- structured dtypes (``[("f", float), ("v", float, (2,))]``): each field
  occupies a slice of the B slots in the fields' common numeric dtype;
  unpack reassembles the structured array with the field dtypes;
- object and string dtypes (host likelihoods only): the payloads stay in a
  host-side store and the device rows carry int32 ids, which resampling
  and the MCMC accept move like any other numeric lane; unpack maps the ids
  back to payloads.

One difference from the JAX module: `device_dtype` is a torch dtype, and
64-bit types stay 64-bit (JAX narrows them to 32 bits unless x64 is on).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch


def _as_np_dtype(blobs_dtype) -> np.dtype:
    """The user's blobs_dtype as a numpy dtype, strings promoted to object."""
    dt = np.dtype(blobs_dtype)
    if dt.kind in "US":
        dt = np.dtype("object")
    return dt


def _torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype of a numeric numpy dtype (raises for others)."""
    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


class BlobSchema:
    """Layout of one point's blob in the device rows."""

    def __init__(self, np_dtype, blob_size: Optional[int] = None):
        self.np_dtype = _as_np_dtype(np_dtype)
        self.is_object = self.np_dtype == np.dtype("object")
        self.is_struct = self.np_dtype.fields is not None
        self.store: List[Any] = []  # host payloads of object blobs

        if self.is_object:
            self.width = 1
            self.row_dtype = np.dtype(np.int32)
            self.fields = None
        elif self.is_struct:
            fields = []
            offset = 0
            for name in self.np_dtype.names:
                fdt = self.np_dtype.fields[name][0]
                base, shape = fdt.base, fdt.shape
                n = int(np.prod(shape)) if shape else 1
                fields.append((name, base, shape, offset, n))
                offset += n
            self.fields = fields
            self.width = offset
            common = np.result_type(*[f[1] for f in fields])
            if common.kind not in "fiub":
                raise ValueError(
                    f"structured blobs_dtype with non-numeric field(s): {self.np_dtype}"
                )
            self.row_dtype = common
        else:
            if blob_size is None:
                raise ValueError("blob_size required for simple numeric blobs_dtype")
            self.width = int(blob_size)
            self.fields = None
            self.row_dtype = self.np_dtype
        self.device_dtype = _torch_dtype(self.row_dtype)

    # ------------------------------------------------------------------
    def pack(self, blob_items: Sequence[Any]) -> np.ndarray:
        """Per-point blob payloads -> (n, width) numeric rows.

        `blob_items[i]` is the tuple of trailing return values of point i,
        or a single array or scalar.
        """
        n = len(blob_items)
        if self.is_object:
            base = len(self.store)
            for item in blob_items:
                # a single trailing value unwraps
                self.store.append(item[0] if isinstance(item, tuple) and len(item) == 1 else item)
            return np.arange(base, base + n, dtype=np.int32).reshape(n, 1)
        if self.is_struct:
            out = np.empty((n, self.width), dtype=self.row_dtype)
            rec = np.array(
                [it if isinstance(it, tuple) else tuple(np.atleast_1d(it)) for it in blob_items],
                dtype=self.np_dtype,
            )
            for name, _base, _shape, off, cnt in self.fields:
                out[:, off : off + cnt] = rec[name].reshape(n, cnt)
            return out
        arr = np.array(
            [np.atleast_1d(np.asarray(it, dtype=self.np_dtype)).reshape(-1) for it in blob_items],
            dtype=self.np_dtype,
        )
        return arr.reshape(n, self.width)

    # ------------------------------------------------------------------
    def unpack(self, flat: np.ndarray) -> np.ndarray:
        """(n, width) rows -> the user-facing blob array: (n,) for a width-1
        simple blob, a (n,) structured array, or a (n,) object array."""
        flat = np.asarray(flat)
        n = flat.shape[0]
        if self.is_object:
            ids = flat.reshape(n).astype(np.int64)
            out = np.empty((n,), dtype=object)
            for i, j in enumerate(ids):
                out[i] = self.store[j] if 0 <= j < len(self.store) else None
            return out
        if self.is_struct:
            rec = np.zeros((n,), dtype=self.np_dtype)
            for name, base, shape, off, cnt in self.fields:
                vals = flat[:, off : off + cnt].astype(base)
                rec[name] = vals.reshape((n,) + shape) if shape else vals.reshape(n)
            return rec
        out = flat.astype(self.np_dtype)
        if self.width == 1:
            return out.reshape(n)
        return out

    # ------------------------------------------------------------------
    def prune_store(self, live_ids: np.ndarray) -> None:
        """Drop object payloads no id refers to (rejected MCMC proposals).
        Ids stay stable: a dead entry becomes None, nothing is renumbered."""
        if not self.is_object or not self.store:
            return
        live = set(int(i) for i in np.asarray(live_ids).reshape(-1) if i >= 0)
        for i in range(len(self.store)):
            if i not in live:
                self.store[i] = None


def infer_np_dtype_from_result(blob_item) -> np.dtype:
    """The blob dtype of one result's trailing values: np.atleast_1d's,
    with strings and ragged payloads promoted to object."""
    try:
        dt = np.atleast_1d(blob_item).dtype
    except ValueError:
        return np.dtype("object")
    if dt.kind in "US" or dt == np.dtype("object"):
        return np.dtype("object")
    return dt
