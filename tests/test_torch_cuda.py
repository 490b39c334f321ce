"""tempest_tpu_torch on an NVIDIA GPU: the CUDA kernel and the sampler.

Every test here is marked `cuda` and skips on a host without a GPU. The
file imports neither jax nor tempest_tpu, so it also runs where JAX is not
installed; there, skip tests/conftest.py (which configures JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernel's beta must be within 2e-3 of its plain version's, the
documented drift between two bisections that sum in different orders
(tests/test_pallas.py:53-54); stay and jump are exact.
"""

import math

import pytest
import torch

from tempest_tpu_torch import Sampler
from tempest_tpu_torch.ops import cuda_reweight
from tempest_tpu_torch.state import commit, make_current, make_history, mis_denominator


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _synthetic(device, cap, N, t_fill, seed):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    h = make_history(cap, N, 2, device=device)
    c = make_current(N, 2, device=device)
    for t in range(t_fill):
        c.logl = -torch.exp(1.0 + 2.0 * torch.randn(N, generator=g, device=device))
        c.beta = torch.tensor(0.0 if t < 2 else 0.01 * t, device=device)
        c.logz = torch.tensor(-0.2 * t, device=device)
        commit(h, c)
    bm = torch.where(h.sample_mask(), mis_denominator(h), torch.tensor(float("inf"), device=device))
    return h.logl.reshape(-1).contiguous(), bm.reshape(-1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("cap,N,t_fill", [(64, 1024, 40), (7, 1000, 5), (8, 64, 2)])
def test_kernel_matches_plain_version(cuda_device, cap, N, t_fill):
    logl, bm = _synthetic(cuda_device, cap, N, t_fill, seed=cap)
    before = cuda_reweight.LAUNCHES
    for beta_prev, target in [(0.0, 2.0 * N), (0.02, 1.5 * N), (0.5, 1e9), (0.1, 0.5)]:
        scal = torch.tensor([beta_prev, target], device=cuda_device)
        beta_k, probes_k = cuda_reweight.ess_bisect_beta(logl, bm, scal)
        beta_r, probes_r = cuda_reweight.ess_bisect_beta_reference(logl, bm, scal)
        torch.cuda.synchronize()
        assert probes_k.item() >= 2
        if probes_r.item() == 2:  # stay or jump
            assert beta_k.item() == beta_r.item()
        else:
            assert abs(beta_k.item() - beta_r.item()) < 2e-3
    assert cuda_reweight.LAUNCHES == before + 4


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    logl, bm = _synthetic(cuda_device, 4, 32, 3, seed=1)
    scal = torch.tensor([0.0, 64.0], device=cuda_device)
    with pytest.raises(ValueError):
        cuda_reweight.ess_bisect_beta(logl.double(), bm.double(), scal.double())
    with pytest.raises(ValueError):
        cuda_reweight.ess_bisect_beta(logl[::2], bm[::2], scal)
    with pytest.raises(ValueError):
        cuda_reweight.ess_bisect_beta(logl, bm.cpu(), scal)


@pytest.mark.cuda
def test_sampler_runs_through_the_kernel(cuda_device):
    def loglike(x):
        return -0.5 * torch.sum(x * x, dim=-1)

    s = Sampler(lambda u: 20.0 * u - 10.0, loglike, n_dim=4, n_particles=256, vectorize=True,
                clustering=False, random_state=1, history_capacity=32, device=cuda_device)
    before = cuda_reweight.LAUNCHES
    s.run(n_total=1024)
    assert s.state.hist.logl.is_cuda
    assert cuda_reweight.LAUNCHES - before == s.state.hist.t - 1
    assert s.beta >= 1.0 - 1e-4
    assert abs(s.evidence()[0] - (-4 * math.log(20.0) + 2 * math.log(2 * math.pi))) < 0.5
