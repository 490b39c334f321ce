"""The port's ESS reweighting against tempest_tpu.

Histories are committed in the JAX package (as tests/test_pallas.py builds
them) and carried into the port through `interop`. The port's beta must be
within 2e-3 of both the Pallas kernel (interpret mode) and the XLA path:
that is the documented drift between those two from summation order
(tests/test_pallas.py:53-54). Stay and jump are exact.

The CUDA kernel itself is held against its plain version on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempest_tpu.ops.pallas_reweight import ess_bisect_beta as jax_kernel
from tempest_tpu.state import commit, make_current, make_history, mis_denominator
from tempest_tpu.steps.reweight import reweight as jax_reweight
from tempest_tpu_torch import interop
from tempest_tpu_torch.ops import cuda_reweight
from tempest_tpu_torch.state import mis_denominator as t_mis_denominator
from tempest_tpu_torch.steps.reweight import reweight

torch.set_num_threads(1)


def build_history(n_iters, N=64, D=2, seed=0, spread=2.0, beta_step=0.2, logz_step=-0.5):
    rng = np.random.default_rng(seed)
    hist = make_history(8, N, D)
    cur = make_current(N, D)
    for t in range(n_iters):
        u = jnp.asarray(rng.uniform(0, 1, (N, D)), jnp.float32)
        logl = jnp.asarray(rng.normal(-10.0, spread, N), jnp.float32)
        cur = cur.replace(
            u=u, x=u, logl=logl,
            beta=jnp.asarray(beta_step * t, jnp.float32),
            logz=jnp.asarray(logz_step * t, jnp.float32),
        )
        hist = commit(hist, cur)
    return hist


def to_port(hist):
    fields = {k: np.array(getattr(hist, k)) for k in interop.HISTORY_FIELDS + ("t",)}
    return interop.history_from_numpy(fields, "cpu")


def jax_pallas_beta(hist, beta_prev, target):
    bm = jnp.where(hist.sample_mask(), mis_denominator(hist), jnp.inf)
    return float(jax_kernel(hist.flat_logl(), bm.reshape(-1), beta_prev, target, interpret=True))


def port_kernel_inputs(th, beta_prev, target):
    bm = torch.where(th.sample_mask(), t_mis_denominator(th), torch.tensor(float("inf")))
    scal = torch.tensor([beta_prev, target], dtype=torch.float32)
    return th.logl.reshape(-1), bm.reshape(-1), scal


@pytest.mark.parametrize("seed,spread,beta_prev", [
    (0, 2.0, 0.1), (1, 8.0, 0.3), (2, 0.5, 0.0), (3, 4.0, 0.9),
])
def test_beta_matches_pallas_and_xla(seed, spread, beta_prev):
    hist = build_history(4, seed=seed, spread=spread)
    target = 128.0
    beta_t = float(reweight(to_port(hist), torch.tensor(beta_prev), target).beta)
    beta_k = jax_pallas_beta(hist, beta_prev, target)
    beta_x = float(jax_reweight(hist, jnp.asarray(beta_prev, jnp.float32), target,
                                use_pallas=False).beta)
    assert abs(beta_t - beta_k) < 2e-3, (beta_t, beta_k)
    assert abs(beta_t - beta_x) < 2e-3, (beta_t, beta_x)


def test_stay():
    """ESS already at/below target -> stay at beta_prev, exactly."""
    hist = build_history(4, seed=5, spread=12.0)
    beta, probes = cuda_reweight.ess_bisect_beta(*port_kernel_inputs(to_port(hist), 0.5, 1e9))
    assert beta.item() == 0.5 == jax_pallas_beta(hist, 0.5, 1e9)
    assert probes.item() == 2


def test_jump():
    """ESS(1) still above target -> jump to 1, exactly."""
    hist = build_history(4, seed=6, spread=0.01)
    beta, _ = cuda_reweight.ess_bisect_beta(*port_kernel_inputs(to_port(hist), 0.1, 4.0))
    assert beta.item() == 1.0 == jax_pallas_beta(hist, 0.1, 4.0)


def test_ragged_size():
    """S = 80 is not a multiple of the TPU's 128 lanes."""
    hist = build_history(3, N=10, D=2, seed=7)
    beta_t = float(reweight(to_port(hist), torch.tensor(0.0), 15.0).beta)
    beta_k = jax_pallas_beta(hist, 0.0, 15.0)
    beta_x = float(jax_reweight(hist, jnp.asarray(0.0, jnp.float32), 15.0, use_pallas=False).beta)
    assert abs(beta_t - beta_k) < 2e-3 and abs(beta_t - beta_x) < 2e-3


@pytest.mark.parametrize("n_iters", [1, 2, 3])
def test_beta_prev_zero_with_unfilled_slots(n_iters):
    """The warm-up ladder: iterations committed at beta = 0, slots unfilled.

    With two committed iterations ESS(0) = 2N equals the target. The XLA
    path stays at 0; the Pallas kernel computes 0 * -inf = NaN on the
    unfilled slots, reads ESS(0) as NaN and bisects instead. The port
    follows the XLA path.
    """
    N = 64
    hist = build_history(n_iters, N=N, seed=11, beta_step=0.0, logz_step=0.0)
    target = 2.0 * N
    beta_x = float(jax_reweight(hist, jnp.asarray(0.0, jnp.float32), target,
                                use_pallas=False).beta)
    beta_t = float(reweight(to_port(hist), torch.tensor(0.0), target).beta)
    if n_iters < 3:
        assert beta_x == 0.0
        assert beta_t == beta_x
    else:
        assert abs(beta_t - beta_x) < 2e-3
    if n_iters == 2:
        assert jax_pallas_beta(hist, 0.0, target) > 0.0  # the reference's fault


@pytest.mark.parametrize("seed,beta_prev", [(0, 0.1), (1, 0.3)])
def test_reweight_outputs_match_jax(seed, beta_prev):
    hist = build_history(5, seed=seed, spread=3.0)
    rw_j = jax_reweight(hist, jnp.asarray(beta_prev, jnp.float32), 128.0, use_pallas=False)
    rw_t = reweight(to_port(hist), torch.tensor(beta_prev), 128.0)
    assert abs(float(rw_t.beta) - float(rw_j.beta)) < 1e-6
    np.testing.assert_allclose(rw_t.weights.numpy(), np.asarray(rw_j.weights), atol=1e-6,
                               rtol=1e-4)
    np.testing.assert_allclose(float(rw_t.ess), float(rw_j.ess), rtol=1e-4)
    np.testing.assert_allclose(float(rw_t.logz), float(rw_j.logz), atol=1e-5)
    np.testing.assert_allclose(float(rw_t.cv), float(rw_j.cv), rtol=1e-3)


def test_dispatch_by_device():
    """CPU tensors take the plain version (no launch); other devices raise."""
    logl, bm, scal = port_kernel_inputs(to_port(build_history(3, seed=2)), 0.1, 100.0)
    before = cuda_reweight.LAUNCHES
    got = cuda_reweight.ess_bisect_beta(logl, bm, scal)
    want = cuda_reweight.ess_bisect_beta_reference(logl, bm, scal)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert cuda_reweight.LAUNCHES == before
    with pytest.raises(ValueError):
        cuda_reweight.ess_bisect_beta(logl.to("meta"), bm.to("meta"), scal.to("meta"))
    with pytest.raises(ValueError):
        cuda_reweight.ess_bisect_beta(logl, bm.to("meta"), scal)


def test_build_name_carries_source_hash():
    from tempest_tpu_torch.ops import _build

    path = cuda_reweight.LIBRARY.path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libess_bisect_") and path.suffix == ".so"
