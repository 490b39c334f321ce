"""The PyTorch port: every submodule imports, no JAX, and the config
refuses by name what is not ported.

The config checks mirror tests/test_config.py against tempest_tpu's
messages; the device checks hold the port to "no quiet fallback".
"""

import importlib
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tempest_tpu.config import SamplerConfig as JaxConfig
from tempest_tpu_torch.config import SamplerConfig

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

SUBMODULES = [
    "tempest_tpu_torch",
    "tempest_tpu_torch.cluster",
    "tempest_tpu_torch.config",
    "tempest_tpu_torch.core",
    "tempest_tpu_torch.draws",
    "tempest_tpu_torch.fused",
    "tempest_tpu_torch.interop",
    "tempest_tpu_torch.iteration",
    "tempest_tpu_torch.loops",
    "tempest_tpu_torch.mcmc",
    "tempest_tpu_torch.modes",
    "tempest_tpu_torch.ops._build",
    "tempest_tpu_torch.ops.boundary",
    "tempest_tpu_torch.ops.cuda_linalg",
    "tempest_tpu_torch.ops.cuda_prng",
    "tempest_tpu_torch.ops.cuda_reweight",
    "tempest_tpu_torch.ops.philox",
    "tempest_tpu_torch.ops.tools",
    "tempest_tpu_torch.parallel",
    "tempest_tpu_torch.parallel.collective",
    "tempest_tpu_torch.parallel.distributed",
    "tempest_tpu_torch.parallel.mesh",
    "tempest_tpu_torch.sampler",
    "tempest_tpu_torch.state",
    "tempest_tpu_torch.steps.mutate",
    "tempest_tpu_torch.steps.resample",
    "tempest_tpu_torch.steps.reweight",
    "tempest_tpu_torch.student",
    "tempest_tpu_torch.utils.blobs",
    "tempest_tpu_torch.utils.checkpoint",
    "tempest_tpu_torch.utils.host",
    "tempest_tpu_torch.utils.profiling",
    "tempest_tpu_torch.utils.progress",
    "tempest_tpu_torch.utils.threefry",
    "tempest_tpu_torch.utils.wrappers",
]


def prior(u):
    return 20.0 * u - 10.0


def loglike(x):
    return -0.5 * torch.sum(x * x, dim=-1)


@pytest.mark.parametrize("name", SUBMODULES)
def test_importable(name):
    importlib.import_module(name)


def test_public_api():
    import tempest_tpu_torch

    assert tempest_tpu_torch.__all__ == ["Sampler"]
    assert callable(tempest_tpu_torch.Sampler)


def test_port_imports_no_jax():
    """Every submodule, and chip_smoke.py, imports neither jax nor tempest_tpu."""
    code = (
        "import importlib, sys; "
        f"[importlib.import_module(m) for m in {SUBMODULES!r} + ['chip_smoke']]; "
        "bad = [m for m in sys.modules if m in ('jax', 'tempest_tpu') "
        "or m.startswith(('jax.', 'tempest_tpu.'))]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_constants_match_jax():
    import tempest_tpu.config as jc
    import tempest_tpu_torch.config as tc

    for name in (
        "BETA_TOLERANCE", "BETA_RTOL", "ESS_TOLERANCE", "METRIC_ATOL", "METRIC_ATOL_CV",
        "DOF_FALLBACK", "TRIM_ESS", "TRIM_BINS", "MAX_BISECTION_ITERATIONS",
        "N_PROPOSAL_CANDIDATES", "DEFAULT_HISTORY_CAPACITY", "DEFAULT_K_MAX",
    ):
        assert getattr(tc, name) == getattr(jc, name), name


def _config(cls, **kw):
    base = dict(prior_transform=prior, log_likelihood=loglike, n_dim=3, vectorize=True,
                clustering=False)
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("bad", [
    dict(n_particles=0),
    dict(ess_ratio=-1.0),
    dict(sample="bogus"),
    dict(resample="bogus"),
    dict(periodic=[0], reflective=[0]),
    dict(periodic=[7]),
    dict(n_particles=0, sample="bogus", resample="nope"),
])
def test_validation_messages_match_jax(bad):
    with pytest.raises(ValueError) as jax_err:
        _config(JaxConfig, **bad)
    with pytest.raises(ValueError) as port_err:
        _config(SamplerConfig, device="cpu", **bad)
    assert str(port_err.value) == str(jax_err.value)


def test_defaults_match_jax():
    j = _config(JaxConfig)
    p = _config(SamplerConfig, device="cpu")
    for name in ("n_particles", "n_steps", "n_max_steps", "train_max_points",
                 "leaf_fit_points", "output_dir", "output_label", "k_max", "n_candidates"):
        assert getattr(p, name) == getattr(j, name), name
    assert p.get_target_metric() == j.get_target_metric()


# The options refused. Explicit ids keep each case's name stable as options
# leave this list: the mesh is ported, and `kw4` now holds that a mesh that
# is no DeviceMesh raises a TypeError naming make_particle_mesh.
@pytest.mark.parametrize("kw,error,match", [
    pytest.param(dict(mesh=object()), TypeError, "make_particle_mesh",
                 id="kw4-queue 1, item 11"),
    pytest.param(dict(dtype=torch.float16), NotImplementedError, "queue 1, item 11",
                 id="kw5-queue 1, item 11"),
])
def test_unported_options_raise(kw, error, match):
    with pytest.raises(error, match=match):
        _config(SamplerConfig, device="cpu", **kw)


def test_float64_is_accepted():
    """float64 runs (tempest_tpu with x64); other dtypes than float32 and
    float64 raise."""
    assert _config(SamplerConfig, device="cpu", dtype=torch.float64).dtype == torch.float64


@pytest.mark.parametrize("kw", [dict(), dict(hardware_prng=True), dict(n_max_clusters=3)])
def test_clustered_and_hardware_prng_configs_are_accepted(kw):
    """The reference defaults (clustering=True) and hardware_prng=True run."""
    from tempest_tpu_torch import Sampler
    from tempest_tpu_torch.draws import HardwareDraws

    s = Sampler(prior, loglike, n_dim=3, vectorize=True, device="cpu", **kw)
    assert s.clustering
    assert isinstance(s.state.draws, HardwareDraws) == bool(kw.get("hardware_prng"))
    assert s.state.cluster_model.k_max == s.state.config.k_max
    assert int(s.state.cluster_model.n_clusters()) == 1


def test_cuda_device_raises_without_gpu():
    """The default device is the GPU, and nothing moves to the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    from tempest_tpu_torch import Sampler

    with pytest.raises((RuntimeError, AssertionError)):
        Sampler(prior, loglike, n_dim=3, vectorize=True, clustering=False)


def test_sampler_properties_and_single_iterations():
    from tempest_tpu_torch import Sampler

    s = Sampler(prior, loglike, n_dim=3, n_particles=16, vectorize=True, clustering=False,
                random_state=3, history_capacity=4, device="cpu")
    assert (s.n_dim, s.n_particles, s.ess_ratio, s.resample) == (3, 16, 2.0, "mult")
    assert s.device == torch.device("cpu") and not s.clustering
    first = s.sample()
    assert first["beta"] == 0.0 and first["iter"] == 1 and first["calls"] == 16
    for _ in range(5):
        out = s.sample()  # grows the history past capacity 4
    assert s.state.hist.capacity == 8 and s.state.hist.t == 6
    assert math.isfinite(out["logz"]) and 0.0 <= out["beta"] <= 1.0
    res = s.results()
    assert res["beta"].shape == (6,) and res["u"].shape == (6, 16, 3)
    s.reset(random_state=3)
    assert s.state.hist.t == 0 and s.state.cur.iteration == 0
    for _ in range(3):
        s.sample()
    logz, err = s.evidence(n_bootstrap=8)
    assert math.isfinite(logz) and math.isfinite(err) and err >= 0.0


def test_profiling_trace_and_annotate(tmp_path):
    """utils.profiling: `trace` writes a Chrome trace of the block, and the
    iteration's stage ranges, made by `annotate`, appear in it."""
    from tempest_tpu_torch import Sampler
    from tempest_tpu_torch.utils import profiling

    with profiling.maybe_trace(None) as nothing:
        assert nothing is None
    s = Sampler(prior, loglike, n_dim=3, n_particles=16, vectorize=True, clustering=False,
                random_state=3, device="cpu")
    with profiling.maybe_trace(str(tmp_path)) as prof:
        with profiling.annotate("user/block"):
            s.sample()
    keys = {e.key for e in prof.key_averages()}
    assert {"user/block", "ps/warmup", "ps/commit"} <= keys
    assert "ps/warmup" in (tmp_path / "trace.json").read_text()
