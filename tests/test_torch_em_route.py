"""The routes of the fits' two EM loops on the CPU.

`cluster._gmm_em` ("gmm_em") and `student._mode_em` ("mode_em") pick their
route by device: CPU tensors run the plain device loop (`loops.run_loop`
with its body, as before the kernels), CUDA tensors one launch of a kernel
(`ops.cuda_em`, csrc/gmm_em.cu and csrc/mvstud_em.cu), and any other device
raises. The kernels' wrappers raise on a wrong type, shape, layout or
device before they build anything. The kernels themselves run only on a
GPU: tests/test_torch_cuda.py holds them to the plain loops there. Here:

- on CPU tensors the routed loops give the plain loops' results bit for
  bit, read the host once a chunk and launch no kernel;
- a wrong dtype, shape, layout or device raises;
- the C entry points the wrappers declare exist in the sources with as
  many parameters as their ctypes signatures;
- a library's build name changes with the header its source includes;
- the new modules import neither jax nor tempest_tpu.
"""

import functools
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tempest_tpu_torch import cluster as tc
from tempest_tpu_torch import student as ts
from tempest_tpu_torch.loops import Loops, launch_counts, run_loop
from tempest_tpu_torch.ops import _build, cuda_em

ROOT = Path(__file__).resolve().parents[1]


def _gmm_start(cov, dtype=torch.float32, B=3, n=120, d=3, K=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, n, d))
    X[:, : n // 2] += 3.0
    w = rng.uniform(0.1, 1.0, size=(B, n))
    u = rng.uniform(size=(B, K))
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    return tc._gmm_start(t(X), t(w), K, t(u), 1000, cov)


def _mode_points(dtype=torch.float32, K=3, n=200, d=3, seed=1):
    rng = np.random.default_rng(seed)
    data = rng.standard_t(4.0, size=(n, d))
    labels = rng.integers(0, K, size=n)
    w = rng.uniform(0.1, 1.0, size=(K, n)) * (labels[None] == np.arange(K)[:, None])
    return torch.tensor(data, dtype=dtype), torch.tensor(w, dtype=dtype)


def _mode_start(dtype=torch.float32, max_iter=100):
    return ts._mode_start(*_mode_points(dtype), 1e-6, max_iter)


def _equal(a, b, keys):
    for k in keys:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cov", tc.COVARIANCE_TYPES)
def test_cpu_gmm_em_takes_the_plain_loop(cov, dtype):
    Xb, sw, carry = _gmm_start(cov, dtype)
    before = dict(cuda_em.LAUNCHES)
    routed = Loops("cpu", {"gmm_em": 4})
    got = tc._gmm_em(Xb, sw, carry, 1000, 1e-3, 1e-6, cov, routed)
    consts = dict(X=Xb, sw=sw, tol=torch.full((), 1e-3, dtype=dtype),
                  max_iter=torch.full((), 1000, dtype=torch.int32))
    body = functools.partial(tc._gmm_em_body, covariance_type=cov, reg_covar=1e-6)
    plain = Loops("cpu", {"gmm_em": 4})
    want = run_loop(plain, "gmm_em", body, carry, consts)
    _equal(got, want, ("pi", "means", "covs", "lb", "n_iter", "done", "go"))
    assert cuda_em.LAUNCHES == before
    assert routed.stats["gmm_em"] == plain.stats["gmm_em"]
    assert routed.stats["gmm_em"]["reads"] >= 1 and "replays" not in routed.stats["gmm_em"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("max_iter", [100, 3])
def test_cpu_mode_em_takes_the_plain_loop(dtype, max_iter):
    carry, consts = _mode_start(dtype, max_iter=max_iter)
    before = dict(cuda_em.LAUNCHES)
    routed = Loops("cpu", {"mode_em": 4})
    got = ts._mode_em(carry, consts, routed)
    plain = Loops("cpu", {"mode_em": 4})
    want = run_loop(plain, "mode_em", ts._em_body, carry, consts)
    _equal(got, want, ("mu", "Sigma", "nu", "last_nu", "i", "hit_inf", "active", "go"))
    assert cuda_em.LAUNCHES == before
    assert routed.stats["mode_em"] == plain.stats["mode_em"] and routed.stats["mode_em"]["reads"]


def test_cpu_fits_keep_their_results():
    """The public fits on CPU tensors: the plain loops, read after every EM
    iteration without a `loops` (as before the kernels)."""
    data, weights = _mode_points(torch.float64)
    carry, consts = ts._mode_start(data, weights, 1e-6, 100)
    mu, Sigma, nu = ts.fit_mvstud_weighted_modes(data, weights)
    out = run_loop(None, "mode_em", ts._em_body, carry, consts)
    assert torch.equal(mu, out["mu"]) and torch.equal(nu, out["nu"])
    assert torch.equal(Sigma, ts.regularized_cholesky(out["Sigma"])[0])
    X = torch.tensor(np.random.default_rng(2).normal(size=(150, 2)))
    params = tc.gmm_fit((0, 42), X, torch.ones(150, dtype=X.dtype), 2)
    assert params.means.shape == (2, 2) and int(params.n_iter) >= 1


def test_kernel_route_by_device():
    x = torch.zeros(3)
    assert cuda_em.kernel_route(x, x) is False
    with pytest.raises(ValueError, match="cpu or cuda"):
        cuda_em.kernel_route(torch.zeros(3, device="meta"))
    with pytest.raises(ValueError, match="share one device"):
        cuda_em.kernel_route(x, torch.zeros(3, device="meta"))


def test_routed_loops_raise_on_another_device():
    Xb, sw, carry = _gmm_start("full")
    meta = {k: v.to("meta") for k, v in carry.items()}
    with pytest.raises(ValueError, match="cpu or cuda"):
        tc._gmm_em(Xb.to("meta"), sw.to("meta"), meta, 1000, 1e-3, 1e-6, "full", None)
    carry, consts = _mode_start()
    with pytest.raises(ValueError, match="cpu or cuda"):
        ts._mode_em({k: v.to("meta") for k, v in carry.items()},
                    {k: v.to("meta") for k, v in consts.items()}, None)


def _gmm_args(dtype=torch.float32, **change):
    Xb, sw, carry = _gmm_start("full", dtype)
    args = dict(X=Xb, sw=sw, carry=dict(carry), tol=torch.full((), 1e-3, dtype=dtype),
                max_iter=torch.full((), 1000, dtype=torch.int32), reg_covar=1e-6,
                covariance_type="full")
    for k, v in change.items():
        if k in args:
            args[k] = v(args[k])
        else:
            args["carry"][k] = v(args["carry"][k])
    return args


@pytest.mark.parametrize("change,match", [
    ({}, "CUDA tensors"),
    (dict(X=lambda t: t.half(), sw=lambda t: t.half()), "float32 or float64"),
    (dict(sw=lambda t: t.double()), "sw must be torch.float32"),
    (dict(n_iter=lambda t: t.long()), "n_iter must be torch.int32"),
    (dict(done=lambda t: t.to(torch.uint8)), "done must be torch.bool"),
    (dict(tol=lambda t: t.double()), "tol must be torch.float32"),
    (dict(X=lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)), "X must be contiguous"),
    (dict(covs=lambda t: t.transpose(-1, -2)), "covs must be contiguous"),
    (dict(sw=lambda t: t[:, :-1]), "sw must have shape"),
    (dict(means=lambda t: t[:1]), "means must have shape"),
    (dict(covariance_type=lambda t: "banded"), "Unknown covariance_type"),
])
def test_gmm_em_kernel_refuses(change, match):
    with pytest.raises(ValueError, match=match):
        cuda_em.gmm_em(**_gmm_args(**change))


def _mvstud_args(**change):
    carry, consts = _mode_start()
    args = dict(data=consts["data"], wbar=consts["wbar"],
                carry={k: v for k, v in carry.items() if k != "go"}, tol=consts["tolerance"],
                max_iter=consts["max_iter"])
    for k, v in change.items():
        if k in args:
            args[k] = v(args[k])
        else:
            args["carry"][k] = v(args["carry"][k])
    return args


@pytest.mark.parametrize("change,match", [
    ({}, "CUDA tensors"),
    (dict(data=lambda t: t.bfloat16()), "float32 or float64"),
    (dict(wbar=lambda t: t.double()), "wbar must be torch.float32"),
    (dict(i=lambda t: t.long()), "i must be torch.int32"),
    (dict(active=lambda t: t.int()), "active must be torch.bool"),
    (dict(max_iter=lambda t: t.long()), "max_iter must be torch.int32"),
    (dict(data=lambda t: t.T.contiguous().T), "data must be contiguous"),
    (dict(Sigma=lambda t: t.transpose(-1, -2)), "Sigma must be contiguous"),
    (dict(wbar=lambda t: t[:, 1:]), "mvstud_em needs|wbar must have shape"),
    (dict(nu=lambda t: t[:-1]), "nu must have shape"),
])
def test_mvstud_em_kernel_refuses(change, match):
    with pytest.raises(ValueError, match=match):
        cuda_em.mvstud_em(**_mvstud_args(**change))


def _c_parameters(source: str, name: str) -> int:
    text = (_build.CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert m, name
    return len([p for p in m.group(1).split(",") if p.strip()])


@pytest.mark.parametrize("library", [cuda_em.GMM_LIBRARY, cuda_em.MVSTUD_LIBRARY])
def test_c_entries_match_their_signatures(library):
    for name, argtypes in library.functions.items():
        assert _c_parameters(library.source, name) == len(argtypes), name
    for header in library.headers:
        assert f'#include "{header}"' in (_build.CSRC / library.source).read_text()


def test_build_name_follows_the_header(tmp_path, monkeypatch):
    for name in ("gmm_em.cu", "em_common.cuh"):
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = cuda_em.GMM_LIBRARY.path()
    (tmp_path / "em_common.cuh").write_text((tmp_path / "em_common.cuh").read_text() + "\n")
    assert cuda_em.GMM_LIBRARY.path() != first


def test_launch_counts_cover_the_em_kernels():
    counts = launch_counts()
    assert counts["gmm_em"] == cuda_em.LAUNCHES["gmm_em"]
    assert counts["mvstud_em"] == cuda_em.LAUNCHES["mvstud_em"]


@pytest.mark.parametrize("module", ["tempest_tpu_torch.ops.cuda_em", "tempest_tpu_torch.cluster",
                                    "tempest_tpu_torch.student"])
def test_em_modules_import_no_jax(module):
    code = ("import sys, importlib; importlib.import_module(sys.argv[1]); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tempest_tpu')];"
            " print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code, module], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
