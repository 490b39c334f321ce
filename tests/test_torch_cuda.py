"""tempest_tpu_torch on an NVIDIA GPU: the CUDA kernels and the sampler.

Every test here is marked `cuda` and skips on a host without a GPU. The
file imports neither jax nor tempest_tpu, so it also runs where JAX is not
installed; there, skip tests/conftest.py (which configures JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The ESS kernel's beta must be within 2e-3 of its plain version's, the
documented drift between two bisections that sum in different orders
(tests/test_pallas.py:53-54); stay and jump are exact. The PRNG kernels
and their plain versions (ops/philox.py) on the card and on one key and
call index, at the tolerances of chip_smoke.py's kernel phase: bits
exactly equal, normals and uniforms within 1e-5 absolute, gamma draws
within 1e-5 relative except at most 1e-4 of them (a Marsaglia-Tsang test
that falls within float rounding of its bound may go the other way when
a math function's last bit differs).
"""

import math

import pytest
import torch

from tempest_tpu_torch import Sampler
from tempest_tpu_torch.ops import cuda_prng, cuda_reweight, philox
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
@pytest.mark.parametrize(
    "cap,N,t_fill", [(64, 1024, 40), (7, 1000, 5), (8, 64, 2), (8, 131072, 8)]
)
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


KEY = philox.key_from_seed(42)


def _gamma_mismatches(got, want):
    return int(torch.sum(torch.abs(got - want) > 1e-5 * torch.abs(want)))


@pytest.mark.cuda
# 8 x 131072 x 10 is the large-ensemble path's R*N*d: several grid-stride
# passes per thread.
@pytest.mark.parametrize("total", [1 << 20, 1001, 8 * 131072 * 10])
def test_normal_and_bits_kernels_match_plain(cuda_device, total):
    before = dict(cuda_prng.LAUNCHES)
    z = cuda_prng.hw_normal(KEY, 3, (total,), cuda_device)
    b = cuda_prng.hw_bits(KEY, 4, (total,), cuda_device)
    torch.cuda.synchronize()
    assert torch.equal(b, philox.bits(KEY, 4, total, cuda_device))
    assert float(torch.max(torch.abs(z - philox.normal(KEY, 3, total, cuda_device)))) <= 1e-5
    u = cuda_prng.hw_uniform(KEY, 4, (total,), cuda_device)
    assert float(u.min()) > 0.0 and float(u.max()) <= 1.0
    assert cuda_prng.LAUNCHES["normal"] == before["normal"] + 1
    assert cuda_prng.LAUNCHES["bits"] == before["bits"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("a", [0.5, 1.5, 7.5, 50.0])
def test_gamma_matches_plain(cuda_device, a):
    n = 1 << 18
    alpha = torch.full((n,), a, device=cuda_device)
    before = dict(cuda_prng.LAUNCHES)
    g = cuda_prng.hw_gamma(KEY, 10, alpha)
    want = philox.gamma(KEY, 10, alpha)
    torch.cuda.synchronize()
    assert cuda_prng.LAUNCHES["normal"] - before["normal"] == philox.MT_ROUNDS
    assert cuda_prng.LAUNCHES["bits"] - before["bits"] == philox.MT_ROUNDS + 1
    assert _gamma_mismatches(g, want) <= 1e-4 * n
    assert float(g.min()) > 0.0 and abs(float(g.mean()) - a) < 5 * (a / n) ** 0.5 + 0.01


@pytest.mark.cuda
def test_mutation_draws_kernel_matches_plain(cuda_device):
    R, N, d = 8, 1024, 10
    alpha = torch.cat([torch.full((N // 2,), 7.5), torch.full((N // 2,), 0.7)]).to(cuda_device)
    before = cuda_prng.LAUNCHES["mutation_draws"]
    z, g, u = cuda_prng.hw_mutation_draws(KEY, 5, alpha, (R, N, d))
    wz, wg, wu = philox.mutation_draws(KEY, 5, alpha, (R, N, d))
    torch.cuda.synchronize()
    assert cuda_prng.LAUNCHES["mutation_draws"] == before + 1
    assert float(torch.max(torch.abs(z - wz))) <= 1e-5
    assert float(torch.max(torch.abs(u - wu))) <= 1e-5
    assert _gamma_mismatches(g, wg) <= max(1, 1e-4 * N)
    with pytest.raises(ValueError):
        cuda_prng.hw_mutation_draws(KEY, 5, alpha.double(), (R, N, d))


@pytest.mark.cuda
def test_sampler_runs_hardware_prng_through_the_kernel(cuda_device):
    def loglike(x):
        return -0.5 * torch.sum(x * x, dim=-1)

    s = Sampler(lambda u: 20.0 * u - 10.0, loglike, n_dim=4, n_particles=256, vectorize=True,
                hardware_prng=True, random_state=1, history_capacity=32, device=cuda_device)
    before = dict(cuda_prng.LAUNCHES)
    s.run(n_total=1024)
    res = s.results()
    steps = int(res["steps"][res["beta"] > 0].sum())
    assert cuda_prng.LAUNCHES["mutation_draws"] - before["mutation_draws"] == steps
    assert cuda_prng.LAUNCHES["normal"] == before["normal"]
    assert s.beta >= 1.0 - 1e-4
    assert abs(s.evidence()[0] - (-4 * math.log(20.0) + 2 * math.log(2 * math.pi))) < 0.5
