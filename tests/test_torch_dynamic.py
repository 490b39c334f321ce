"""Dynamic (CV) mode of the port against tempest_tpu.

1. The reweight, value for value: histories committed in the JAX package
   (numpy-made iterations, as tests/test_torch_reweight.py builds them) go
   through `interop` into the port; the port's `reweight(dynamic=True)` is
   held against the JAX `reweight(dynamic=True, use_pallas=False)` at
   several fill levels, ESS targets and CV targets, covering every
   boundary case: no ESS crossing (stay, and jump to 1), the CV target at
   or above CV(beta_high) (take beta_high), at or below CV(beta_prev)
   (stay), and the bisection between. Tolerances: beta 1e-5 relative, ESS
   1e-5 relative, logZ 1e-5 absolute, CV 1e-4 relative; the largest
   differences found were 0 for beta (the same float32 decisions) and
   below 1e-6 for ESS, logZ and CV.
2. The ESS bracket alone: the plain route of the ESS kernel's bracket
   mode (`ops.cuda_reweight.ess_bracket` on CPU tensors) equals the
   "ess_bracket" loop bit for bit, probes included, and JAX's
   `_find_ess_bracket` within 1e-5 (relative), on the same histories.
3. The loop form with the decisions on the device, as the body of the
   device run loop takes them: each case inside a stretch (`Loops.stretch`:
   the CV step a `loops.when` on the device bool `crossing`, the bisections
   `Loops.repeat`, run to their end on the CPU): JAX's values at the
   tolerances of 1, bits equal to the chunked form's (beta, weights, ESS,
   CV, logZ), the same `PROBES`, no chunk run and no decision read.
4. Whole runs on the CPU: the checks of tests/test_dynamic.py on the
   port, with per-point likelihoods (the default call form).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempest_tpu.state import commit, make_current, make_history
from tempest_tpu.state import mis_denominator as jax_mis_denominator
from tempest_tpu.steps.reweight import _find_ess_bracket, _make_metric_fns
from tempest_tpu.steps.reweight import reweight as jax_reweight
from tempest_tpu_torch import Sampler, interop
from tempest_tpu_torch.loops import Loops
from tempest_tpu_torch.ops.cuda_reweight import ess_bracket
from tempest_tpu_torch.ops.tools import ess_from_logw
from tempest_tpu_torch.state import logw_from_denominator, mis_denominator
from tempest_tpu_torch.steps import reweight as rw_mod
from tempest_tpu_torch.steps.reweight import reweight

torch.set_num_threads(1)

N, D, CAP = 64, 3, 8


def build_history(n_iters, seed, contract=True):
    """Iterations of a narrow Gaussian under a uniform prior. With
    `contract` the particles narrow as beta rises and CV falls with beta
    across the bracket; without, every iteration is a prior draw and CV
    rises with beta, so the bisection is reached."""
    rng = np.random.default_rng(seed)
    hist, cur = make_history(CAP, N, D), make_current(N, D)
    for t in range(n_iters):
        width = 1.0 / (1.0 + t) if contract else 4.0
        u = np.clip(0.5 + width * rng.normal(0, 0.25, (N, D)), 0.0, 1.0).astype(np.float32)
        logl = (-0.5 * np.sum(((u - 0.5) / 0.05) ** 2, axis=1)).astype(np.float32)
        cur = cur.replace(u=jnp.asarray(u), x=jnp.asarray(u), logl=jnp.asarray(logl),
                          beta=jnp.asarray(0.002 * t * t, jnp.float32),
                          logz=jnp.asarray(-0.3 * t, jnp.float32))
        hist = commit(hist, cur)
    return hist


def to_port(hist):
    return interop.history_from_numpy(
        {k: np.array(getattr(hist, k)) for k in interop.HISTORY_FIELDS + ("t",)}, "cpu")


def port_ess(th, beta):
    return float(ess_from_logw(logw_from_denominator(th, mis_denominator(th), beta)[0]))


# (fill, seed, contract, ESS target as a multiple of ESS(beta_prev) or
# "jump", CV target)
CASES = [
    (3, 0, True, 0.6, 0.05), (3, 0, True, 0.6, 0.5), (3, 0, True, 0.6, 1e-4),
    (5, 1, True, 0.5, 0.1), (5, 1, True, 0.5, 100.0), (5, 1, True, 1.5, 0.5),
    (7, 2, True, 0.3, 0.2), (7, 2, True, 0.8, 0.02), (7, 2, True, "jump", 0.5),
    (2, 3, True, 0.7, 0.3),
    (3, 0, False, 0.6, 0.05), (5, 1, False, 0.5, 0.09), (5, 1, False, 0.5, 0.01),
    (5, 1, False, 0.5, 1.0), (7, 2, False, 0.3, 0.26), (2, 3, False, 0.7, 0.05),
]


def _run_case(fill, seed, contract, ess_mult, cv_target):
    hist = build_history(fill, seed, contract)
    th = to_port(hist)
    beta_prev = float(hist.beta[fill - 1])
    ess_cur, ess_one = port_ess(th, beta_prev), port_ess(th, 1.0)
    target = 0.5 * ess_one if ess_mult == "jump" else ess_mult * ess_cur
    want = jax_reweight(hist, jnp.asarray(beta_prev, jnp.float32), target, cv_target=cv_target,
                        dynamic=True, use_pallas=False)
    got = reweight(th, torch.tensor(beta_prev), target, cv_target=cv_target, dynamic=True)
    return hist, th, beta_prev, target, want, got


@pytest.mark.parametrize("fill,seed,contract,ess_mult,cv_target", CASES)
def test_dynamic_reweight_equals_jax(fill, seed, contract, ess_mult, cv_target):
    _, _, _, _, want, got = _run_case(fill, seed, contract, ess_mult, cv_target)
    bj = float(want.beta)
    assert abs(float(got.beta) - bj) <= 1e-5 * max(abs(bj), 1e-30)
    np.testing.assert_allclose(float(got.ess), float(want.ess), rtol=1e-5)
    np.testing.assert_allclose(float(got.logz), float(want.logz), atol=1e-5)
    np.testing.assert_allclose(float(got.cv), float(want.cv), rtol=1e-4)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights), atol=1e-6)


def _outcome(th, beta_prev, target, beta):
    lo, hi, _ = rw_mod._find_ess_bracket(th, mis_denominator(th), torch.tensor(beta_prev), target)
    if float(lo) == float(hi):
        return "jump" if float(lo) == 1.0 else "no crossing"
    if beta == float(hi):
        return "beta_high"
    if beta == beta_prev:
        return "stay"
    return "bisect"


def test_cases_cover_every_boundary_rule():
    seen = set()
    for case in CASES:
        _, th, beta_prev, target, _, got = _run_case(*case)
        seen.add(_outcome(th, beta_prev, target, float(got.beta)))
    assert seen == {"jump", "no crossing", "beta_high", "stay", "bisect"}, seen


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("fill,seed,contract,ess_mult,cv_target", CASES)
def test_loop_bisections_equal_jax(fill, seed, contract, ess_mult, cv_target, chunk):
    """The bracket and the CV bisection as device loops in chunks of 1, 3
    and 8 bodies: JAX's values at test_dynamic_reweight_equals_jax's
    tolerances, the per-probe loop's beta bit for bit, and one read a
    chunk (the CV loop reads its boundary rules once first)."""
    hist, th, beta_prev, target, want, _ = _run_case(fill, seed, contract, ess_mult, cv_target)
    loops = Loops("cpu", {"ess_bracket": chunk, "cv_bisect": chunk})
    got = reweight(th, torch.tensor(beta_prev), target, cv_target=cv_target, dynamic=True,
                   loops=loops)
    per_probe = reweight(th, torch.tensor(beta_prev), target, cv_target=cv_target, dynamic=True)
    bj = float(want.beta)
    assert abs(float(got.beta) - bj) <= 1e-5 * max(abs(bj), 1e-30)
    assert torch.equal(got.beta, per_probe.beta)
    np.testing.assert_allclose(float(got.ess), float(want.ess), rtol=1e-5)
    np.testing.assert_allclose(float(got.logz), float(want.logz), atol=1e-5)
    np.testing.assert_allclose(float(got.cv), float(want.cv), rtol=1e-4)
    bracket, cv = loops.stats["ess_bracket"], loops.stats["cv_bisect"]
    assert bracket["reads"] >= 1 and bracket["bodies"] == chunk * bracket["reads"]
    if cv["reads"]:  # one read of the boundary rules, then one a chunk
        assert cv["bodies"] == chunk * (cv["reads"] - 1)


@pytest.mark.parametrize("fill,seed,contract,ess_mult,cv_target", CASES)
def test_bracket_plain_route_equals_loop_and_jax(fill, seed, contract, ess_mult, cv_target):
    """The plain route of the ESS kernel's bracket mode (`ess_bracket` on
    CPU tensors) against the "ess_bracket" loop of `_find_ess_bracket`, bit
    for bit with its probes, and against JAX's `_find_ess_bracket` within
    1e-5 (relative)."""
    hist, th, beta_prev, target, _, _ = _run_case(fill, seed, contract, ess_mult, cv_target)
    denom = mis_denominator(th)
    bm = torch.where(th.sample_mask(), denom, torch.full_like(denom, float("inf")))
    scal = torch.tensor([beta_prev, target], dtype=torch.float32)
    got, probes = ess_bracket(th.logl.reshape(-1), bm.reshape(-1), scal)
    before = rw_mod.PROBES["ess_bracket"]
    lo, hi, crossing = rw_mod._find_ess_bracket(th, denom, torch.tensor(beta_prev), target)
    assert torch.equal(got, torch.stack([lo, hi])) and got.dtype == torch.float32
    assert int(probes) == rw_mod.PROBES["ess_bracket"] - before
    assert crossing == (float(lo) != float(hi))
    ess_at = _make_metric_fns(hist, False, jax_mis_denominator(hist))[0]
    want = np.array(_find_ess_bracket(ess_at, jnp.asarray(beta_prev, jnp.float32),
                                      jnp.asarray(target, jnp.float32), jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


def test_probes_are_counted():
    before = dict(rw_mod.PROBES)
    _run_case(5, 1, False, 0.5, 0.09)
    after = rw_mod.PROBES
    assert after["reweights"] == before["reweights"] + 1
    assert after["ess_bracket"] - before["ess_bracket"] >= 3  # ESS(beta_prev), ESS(1), a probe
    assert after["cv"] - before["cv"] >= 1


def _probes_of(fn):
    """`fn()` and the `PROBES` it added."""
    before = dict(rw_mod.PROBES)
    out = fn()
    return out, {k: rw_mod.PROBES[k] - before[k] for k in before}


@pytest.mark.parametrize("fill,seed,contract,ess_mult,cv_target", CASES)
def test_loop_form_with_device_decisions(fill, seed, contract, ess_mult, cv_target):
    """The reweight inside a stretch, as the device run loop's body runs
    it: `crossing` a device bool, the CV step a `loops.when` on it, the
    bracket and the CV bisection `Loops.repeat` (no chunk, no read of a
    decision): JAX's values, the chunked form's bits and probes."""
    hist, th, beta_prev, target, want, _ = _run_case(fill, seed, contract, ess_mult, cv_target)
    chunks, p_chunks = _probes_of(lambda: reweight(
        th, torch.tensor(beta_prev), target, cv_target=cv_target, dynamic=True,
        loops=Loops("cpu", {"ess_bracket": 8, "cv_bisect": 8})))
    loops = Loops("cpu")

    def device_form():
        with loops.stretch():
            return reweight(th, torch.tensor(beta_prev), target, cv_target=cv_target,
                            dynamic=True, loops=loops)

    got, p_loop = _probes_of(device_form)
    bj = float(want.beta)
    assert abs(float(got.beta) - bj) <= 1e-5 * max(abs(bj), 1e-30)
    np.testing.assert_allclose(float(got.ess), float(want.ess), rtol=1e-5)
    np.testing.assert_allclose(float(got.logz), float(want.logz), atol=1e-5)
    np.testing.assert_allclose(float(got.cv), float(want.cv), rtol=1e-4)
    for name in ("beta", "weights", "ess", "cv", "logz"):
        assert torch.equal(getattr(got, name), getattr(chunks, name)), name
    assert p_loop == p_chunks and p_loop["reweights"] == 1 and p_loop["ess_bracket"] >= 2
    assert all(not v.get("chunks") for v in loops.stats.values()), dict(loops.stats)
    assert not loops.stats["cv_step"].get("reads"), dict(loops.stats)
    assert {"ess_bracket", "cv_step"} <= set(loops._names)  # the bracket's loop, the CV's IF


# ---------------------------------------------------------------------------
# Whole runs (tests/test_dynamic.py)
# ---------------------------------------------------------------------------
N_DIM = 2
TRUE_LOGZ = -N_DIM * math.log(10.0)


def prior_transform(u):
    return -5.0 + 10.0 * u


def log_likelihood(x):
    return -0.5 * torch.sum(x**2) - 0.5 * N_DIM * math.log(2 * math.pi)


def run_dynamic(cv, seed=0, n_particles=64, n_total=256, **kw):
    kw.setdefault("clustering", False)
    s = Sampler(prior_transform, log_likelihood, n_dim=N_DIM, n_particles=n_particles,
                volume_variation=cv, random_state=seed, device="cpu", **kw)
    s.run(n_total=n_total, progress=False)
    return s


@pytest.mark.parametrize("cv", [0.2, 1.0])
def test_reaches_posterior(cv):
    s = run_dynamic(cv)
    assert s.beta == 1.0 and abs(s.evidence()[0] - TRUE_LOGZ) < 1.0


def test_larger_cv_target_fewer_iterations():
    assert run_dynamic(1.5).state.hist.t <= run_dynamic(0.2).state.hist.t


def test_cv_history_and_ladder():
    s = run_dynamic(0.5)
    res = s.results()
    assert np.all(np.isfinite(res["cv"])) and np.all(res["cv"] >= 0.0)
    assert np.all(np.diff(res["beta"]) >= -1e-7)
    assert isinstance(s.cv, float) and s.volume_variation == 0.5


def test_posterior_moments_dynamic():
    s = run_dynamic(0.5, seed=3)
    x, w, _ = s.posterior()
    mean = np.average(x, axis=0, weights=w)
    var = np.average((x - mean) ** 2, axis=0, weights=w)
    np.testing.assert_allclose(mean, 0.0, atol=0.3)
    np.testing.assert_allclose(var, 1.0, atol=0.5)


def test_dynamic_with_clustering():
    s = run_dynamic(0.5, seed=1, clustering=True)
    assert s.beta == 1.0 and abs(s.evidence()[0] - TRUE_LOGZ) < 1.0


def test_very_small_target_converges():
    s = run_dynamic(0.02, n_total=128)
    assert s.beta == 1.0 and s.state.hist.t >= 5
