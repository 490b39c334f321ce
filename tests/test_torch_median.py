"""The weighted median of the port (`ops.cuda_median`) against tempest_tpu.

Every weighted Student-t fit starts from the per-column weighted median of
its points, given their stable column sort. The port's wrapper,
`cuda_median.weighted_median_presorted`, takes the plain version for CPU
tensors (the kernel, csrc/weighted_median.cu, runs only on a GPU:
tests/test_torch_cuda.py holds it to the plain version bit for bit). Here,
with inputs made by numpy from a seed:

- the plain route against JAX's `_weighted_median_presorted`
  (tempest_tpu/student.py:220-231), row by row, at K = 3, n = 257, d = 4,
  in float32 and float64: the same medians exactly (both take the first
  point whose cumulative weight reaches 0.5 - 1e-7);
- a row of weights that is all zero gives d_sorted[0], as argmax of
  all-False gives index 0;
- one-hot rows, as the mode fits make them (each point's weight in its
  mode's row only, zeros of both signs), in that comparison too;
- the exactness the CUDA kernel rests on: the plain version's medians are
  those of the same rows with their zero weights dropped (NaN kept) and
  the crossing's index mapped back, none giving index 0;
- tied data values;
- a row whose cumulative weight lands exactly on the threshold rounded to
  the working type, and one just below it;
- the routing: a CPU tensor goes to the plain version and launches
  nothing; a tensor on another device (`meta`) raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempest_tpu import student as js
from tempest_tpu_torch import student as ts
from tempest_tpu_torch.ops import cuda_median

torch.set_num_threads(1)

K, N, D = 3, 257, 4


def _inputs(seed, dtype, ties=False, zero_rows=(), onehot=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D))
    if ties:
        x = np.round(2.0 * x)  # a few distinct values a column
    w = rng.exponential(size=(K, N))
    w[rng.random((K, N)) < 0.1] = 0.0
    if onehot:  # modes.py: each point's weight in the row of its mode only
        w = np.where(rng.integers(0, K, size=N)[None, :] == np.arange(K)[:, None], w[0], 0.0)
    w[list(zero_rows)] = 0.0
    total = w.sum(axis=1, keepdims=True)
    wbar = w / np.where(total > 0, total, 1.0)
    if onehot:  # half of the zeros negative
        wbar = np.where((wbar == 0) & (rng.random((K, N)) < 0.5), -0.0, wbar)
    np_type = np.float64 if dtype == torch.float64 else np.float32
    x, wbar = x.astype(np_type), wbar.astype(np_type)
    d_sorted, order = ts.sort_columns(torch.from_numpy(x))
    return x, d_sorted, order, torch.from_numpy(wbar)


def _jax_rows(d_sorted, order, wbar):
    """JAX's median of each row of weights, on the same sort."""
    with jax.enable_x64(wbar.dtype == torch.float64):
        return np.stack([np.asarray(js._weighted_median_presorted(
            jnp.asarray(d_sorted.numpy()), jnp.asarray(order.numpy()), jnp.asarray(row)))
            for row in wbar.numpy()])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed,ties,zero_rows,onehot", [
    (0, False, (), False), (1, True, (), False), (2, False, (1,), False),
    (3, True, (0, 2), False), (10, False, (), True), (11, True, (2,), True)])
def test_plain_route_equals_jax_row_by_row(seed, ties, zero_rows, onehot, dtype):
    _, d_sorted, order, wbar = _inputs(seed, dtype, ties, zero_rows, onehot)
    got = cuda_median.weighted_median_presorted(d_sorted, order, wbar)
    assert got.dtype == dtype and got.shape == (K, D)
    np.testing.assert_array_equal(got.numpy(), _jax_rows(d_sorted, order, wbar))
    for k in zero_rows:  # an all-zero row: no crossing, index 0
        np.testing.assert_array_equal(got[k].numpy(), d_sorted[0].numpy())


def _median_of_nonzero(d_sorted, order, wbar):
    """The median from each column's nonzero weights alone (NaN counts as
    nonzero), in order: their running sum's first crossing, mapped back to
    its index in the column, else index 0."""
    thr = torch.tensor(cuda_median.THRESHOLD, dtype=wbar.dtype)
    out = torch.empty((wbar.shape[0], d_sorted.shape[1]), dtype=d_sorted.dtype)
    for k in range(wbar.shape[0]):
        for j in range(d_sorted.shape[1]):
            gathered = wbar[k, order[:, j]]
            kept = torch.nonzero(~(gathered == 0)).flatten()
            crossed = torch.nonzero(torch.cumsum(gathered[kept], 0) >= thr).flatten()
            out[k, j] = d_sorted[kept[crossed[0]] if len(crossed) else 0, j]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed,onehot,nans", [(20, False, 0), (21, True, 0), (22, True, 3),
                                              (23, False, 5)])
def test_zero_weights_drop_out_exactly(seed, onehot, nans, dtype):
    """The plain version's medians are, bit for bit, those of the same rows
    with their zero weights (+0.0 and -0.0) dropped and the crossing mapped
    back: a zero leaves the running sum as it was and cannot be the first
    crossing. NaN weights stay (a sum that meets one is NaN from there on,
    and crosses no more). Rows all zero and a sum landing on the threshold
    included."""
    _, d_sorted, order, wbar = _inputs(seed, dtype, zero_rows=(0,), onehot=onehot)
    rng = np.random.default_rng(seed)
    for _ in range(nans):
        wbar[rng.integers(1, K), rng.integers(0, N)] = float("nan")
    thr = torch.tensor(cuda_median.THRESHOLD, dtype=dtype)
    exact = torch.zeros(N, dtype=dtype)
    exact[order[40, 1]] = thr  # column 1's running sum lands on thr at its 41st point
    exact[order[90, 1]] = 1.0 - thr
    wbar = torch.cat([wbar, exact[None]])
    got = cuda_median.weighted_median_presorted_reference(d_sorted, order, wbar)
    want = _median_of_nonzero(d_sorted, order, wbar)
    view = torch.int64 if dtype == torch.float64 else torch.int32
    assert torch.equal(got.view(view), want.view(view))
    assert got[-1, 1] == d_sorted[40, 1] and torch.equal(got[0], d_sorted[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_one_row_of_weights(dtype):
    """Weights (n,) give the (d,) median of the (1, n) row."""
    _, d_sorted, order, wbar = _inputs(4, dtype)
    got = cuda_median.weighted_median_presorted(d_sorted, order, wbar[1])
    assert got.shape == (D,)
    np.testing.assert_array_equal(got.numpy(),
                                  cuda_median.weighted_median_presorted(d_sorted, order, wbar)[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("below", [False, True])
def test_sum_on_the_threshold(dtype, below):
    """The running sum reaches the threshold rounded to the type exactly at
    the 8th point of column 0 (its median there), or stops one step below
    it there, so the crossing moves to the 10th point."""
    _, d_sorted, order, _ = _inputs(5, dtype)
    thr = torch.tensor(cuda_median.THRESHOLD, dtype=dtype)
    first = torch.nextafter(thr, torch.zeros((), dtype=dtype)) if below else thr
    w = torch.zeros(N, dtype=dtype)
    w[order[7, 0]] = first
    w[order[9, 0]] = 1.0 - first
    assert torch.cumsum(w[order[:, 0]], 0)[7] == first
    got = cuda_median.weighted_median_presorted(d_sorted, order, w[None])
    assert got[0, 0] == d_sorted[9 if below else 7, 0]
    np.testing.assert_array_equal(got.numpy(), _jax_rows(d_sorted, order, w[None]))


def test_student_takes_the_wrapper():
    """The fit's median (student._weighted_median_presorted) is the
    wrapper's."""
    _, d_sorted, order, wbar = _inputs(6, torch.float32, ties=True)
    np.testing.assert_array_equal(
        ts._weighted_median_presorted(d_sorted, order, wbar).numpy(),
        cuda_median.weighted_median_presorted_reference(d_sorted, order, wbar).numpy())


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    _, d_sorted, order, wbar = _inputs(7, torch.float32)
    calls = []
    plain = cuda_median.weighted_median_presorted_reference
    monkeypatch.setattr(cuda_median, "weighted_median_presorted_reference",
                        lambda *a: calls.append(1) or plain(*a))
    monkeypatch.setattr(cuda_median, "_launch", lambda *a: pytest.fail("launched on the CPU"))
    before = cuda_median.LAUNCHES
    cuda_median.weighted_median_presorted(d_sorted, order, wbar)
    assert calls == [1] and cuda_median.LAUNCHES == before


def test_other_devices_raise():
    _, d_sorted, order, wbar = _inputs(8, torch.float32)
    with pytest.raises(ValueError):
        cuda_median.weighted_median_presorted(d_sorted.to("meta"), order.to("meta"),
                                              wbar.to("meta"))
    with pytest.raises(ValueError):  # two devices
        cuda_median.weighted_median_presorted(d_sorted, order.to("meta"), wbar)


def test_sort_columns_is_contiguous():
    """The kernel takes contiguous tensors only: the sort of a transposed
    view (as the fits' points are) comes back contiguous, unchanged."""
    x, _, _, _ = _inputs(9, torch.float32)
    view = torch.from_numpy(np.ascontiguousarray(x.T)).T
    d_sorted, order = ts.sort_columns(view)
    assert d_sorted.is_contiguous() and order.is_contiguous()
    want_d, want_o = ts.sort_columns(torch.from_numpy(x))
    assert torch.equal(d_sorted, want_d) and torch.equal(order, want_o)
