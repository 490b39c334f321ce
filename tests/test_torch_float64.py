"""The port in float64 against tempest_tpu with x64.

JAX's x64 flag is process-global, so the JAX side runs once, in a
subprocess with `jax_enable_x64` (as tests/test_float64.py does), and
writes what it computed to an npz that a module-scoped fixture reads:

1. `jax.random.uniform` of 16 keys in float64 and float32, and the
   k-means++ uniforms of the fixed fit key: the port's `utils.threefry`
   must give them bit for bit.
2. A float64 clustered run (the 4-D bimodal mixture of
   tests/test_torch_clustered_slice.py) until its clusterer has split; its
   state, a state file, and the next iteration. The port runs that
   iteration on the iteration's own JAX draws (float64 resample uniforms,
   normals, gamma draws and acceptance uniforms), inside the subprocess,
   which needs x64 to make them; beta, logZ, the cluster model, the labels
   and the particles must agree to rtol 1e-8 (two float64 programs that
   sum in other orders).
3. XLA's float64 bisection (`use_pallas=False`; JAX runs no Pallas kernel
   in float64) on that history for stay, jump and two bisections, its
   probes counted under `jax.disable_jit()`: the port's bisection must give
   beta to a relative 1e-12 and the same probe count.
4. State files both ways: the JAX x64 file loads into a float64 port
   sampler value for value and runs on; a float64 port file loads into the
   JAX x64 sampler value for value, and JAX runs an iteration from it.
5. Dynamic (CV) mode in float64: XLA's `reweight(dynamic=True,
   use_pallas=False)` on the histories of tests/test_torch_dynamic.py's
   CASES, made in float64; the port's float64 reweight must reach the
   same beta, bit for bit, with its bisections as device loops in chunks
   of 1, 3 and 8 bodies too; and XLA's `_find_ess_bracket` alone: the
   plain route of the ESS kernel's bracket mode must reach it within 1e-12
   (relative) and equal the port's "ess_bracket" loop bit for bit.

7. The port's float64 draws (the plain versions of the `_f64` PRNG
   kernels, `ops/philox.py`) against threefry's in float64
   (`jax.random.normal`, `uniform`, `gamma` at alpha 0.02, 1.0 and 7.5),
   2^16 of each from fixed keys: a two-sample Kolmogorov-Smirnov test with
   p above KS_P_FLOOR (fixed seeds, so each p-value is one number), and
   the means within 5 standard errors of each other's.

In the test process (port only): the 4-D Gaussian of tests/test_float64.py
with its bars (|logZ + 4 log 20| < 0.35, the MIS accumulator within 1e-9 of
its exact rebuild), and `hardware_prng=True` giving the ladder of
`hardware_prng=False` (the flag does not apply to float64, as in JAX):
a float64 sampler takes `Draws` with either flag, keyed or not alike, so
on the card the flags give the same bits.
"""

import math
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from tempest_tpu_torch import Sampler, interop
from tempest_tpu_torch.cluster import fit_uniforms
from tempest_tpu_torch.draws import Draws
from tempest_tpu_torch.loops import Loops
from tempest_tpu_torch.ops import philox
from tempest_tpu_torch.ops.cuda_reweight import (
    ess_bisect_beta,
    ess_bisect_beta_reference,
    ess_bracket,
)
from tempest_tpu_torch.state import mis_denominator, mis_denominator_exact
from tempest_tpu_torch.steps import reweight as rw_mod
from tempest_tpu_torch.steps.reweight import reweight
from tempest_tpu_torch.utils import threefry
from test_torch_dynamic import CASES as DYNAMIC_CASES

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
D, N = 4, 128
RTOL = 1e-8

_SCRIPT = textwrap.dedent(
    """
    import math
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    import numpy as np
    import torch

    from tempest_tpu import Sampler as JaxSampler
    from tempest_tpu.state import mis_denominator
    from tempest_tpu.steps.reweight import _find_beta_bisection, _find_ess_bracket, _make_metric_fns
    from tempest_tpu.steps.reweight import reweight as jax_reweight
    from tempest_tpu_torch import Sampler, interop
    from tempest_tpu_torch.cluster import single_cluster_model
    from tempest_tpu_torch.config import SamplerConfig
    from tempest_tpu_torch.iteration import make_iteration

    torch.set_num_threads(1)
    out_path, jax_file, port_file = sys.argv[1:4]
    D, N, SEP, SIGMA = 4, 128, 3.0, 0.5
    NORM = -0.5 * D * math.log(2 * math.pi * SIGMA**2)
    out = {}

    def prior(u):
        return 20.0 * u - 10.0

    def bimodal_j(x):
        a = NORM - 0.5 * jnp.sum((x - SEP) ** 2, axis=-1) / SIGMA**2
        b = NORM - 0.5 * jnp.sum((x + SEP) ** 2, axis=-1) / SIGMA**2
        return jnp.logaddexp(a, b) - jnp.log(2.0)

    def bimodal_t(x):
        a = NORM - 0.5 * torch.sum((x - SEP) ** 2, dim=-1) / SIGMA**2
        b = NORM - 0.5 * torch.sum((x + SEP) ** 2, dim=-1) / SIGMA**2
        return torch.logaddexp(a, b) - math.log(2.0)

    class Draws64:
        # The float64 draws of one tempest_tpu mutate branch (fused.py:89).
        def __init__(self, it_key):
            _k_train, self.k_res, self.k_mut = jax.random.split(it_key, 3)

        def resample(self, n, method):
            return torch.from_numpy(np.array(jax.random.uniform(self.k_res, (n,),
                                                                dtype=jnp.float64)))

        def mcmc_step(self, n_candidates, n, d, gamma_shape):
            self.k_mut, k_g, k_p, k_a = jax.random.split(self.k_mut, 4)
            g = jax.random.gamma(k_g, jnp.asarray(gamma_shape.numpy()), dtype=jnp.float64)
            z = jax.random.normal(k_p, (n_candidates, n, d), dtype=jnp.float64)
            acc = jax.random.uniform(k_a, (n,), dtype=jnp.float64)
            return (torch.from_numpy(np.array(z)), torch.from_numpy(np.array(g)),
                    torch.from_numpy(np.array(acc)))

    # 1. uniforms
    keys = jax.random.split(jax.random.PRNGKey(42), 16)
    out["keys"] = np.asarray(keys)
    out["u64"] = np.array([float(jax.random.uniform(k, ())) for k in keys])
    out["u32"] = np.array([float(jax.random.uniform(k, (), dtype=jnp.float32)) for k in keys])
    leaves = jax.random.split(jax.random.PRNGKey(42), 4)
    out["fit_uniforms_3"] = np.array([[[float(jax.random.uniform(k, ())) for k in
                                        jax.random.split(s, 2)] for s in jax.random.split(leaf, 3)]
                                      for leaf in leaves])

    # 2. a float64 clustered run until the split, and the next iteration
    js = JaxSampler(prior, bimodal_j, n_dim=D, n_particles=N, vectorize=True, clustering=True,
                    k_max=4, random_state=0, history_capacity=16, dtype=jnp.float64)
    core = js.state
    while int(core._fused_model.n_clusters()) < 2 or int(core.hist.t) < 9:
        js.sample()
    fields_h = {k: np.array(getattr(core.hist, k)) for k in interop.HISTORY_FIELDS + ("t",)}
    fields_c = {k: np.array(getattr(core.cur, k))
                for k in interop.CURRENT_FIELDS + interop.CURRENT_COUNTERS}
    out.update({f"h.{k}": v for k, v in fields_h.items()})
    js.save_state(jax_file)

    # 3. XLA's float64 bisection on this history, probes counted eagerly
    hist = core.hist
    denom = mis_denominator(hist)
    ess_at, metric_at = _make_metric_fns(hist, False, denom)
    bp = float(core.cur.beta)
    e_cur, e_one = float(ess_at(jnp.asarray(bp))), float(ess_at(jnp.asarray(1.0)))
    cases = [(bp, 1.5 * e_cur), (bp, 0.5 * e_one), (bp, math.sqrt(e_cur * e_one)), (0.0, 2.0 * N)]
    betas, probes = [], []
    for beta_prev, target in cases:
        betas.append(float(jax_reweight(hist, beta_prev, target, use_pallas=False).beta))
        calls = [0]

        def counting(beta):
            calls[0] += 1
            return metric_at(beta)

        with jax.disable_jit():
            _find_beta_bisection(counting, jnp.asarray(beta_prev), jnp.asarray(1.0),
                                 jnp.asarray(target), dynamic=False)
        stay_or_jump = (float(ess_at(jnp.asarray(beta_prev))) <= target) or e_one >= target
        probes.append(2 if stay_or_jump else 2 + calls[0])
    out["bis.cases"], out["bis.beta"], out["bis.probes"] = (np.array(cases), np.array(betas),
                                                            np.array(probes))

    it_key = jax.random.split(core.key)[1]  # what core._next_key() hands the iteration
    out_j = js.sample()
    for k in ("beta", "logz", "steps", "calls", "iter", "acceptance", "u", "logl",
              "assignments"):
        out[f"j.{k}"] = np.asarray(out_j[k])
    for k in ("centers", "covariances", "weights", "k_mask"):
        out[f"jm.{k}"] = np.array(getattr(core._fused_model, k))

    cfg = SamplerConfig(prior_transform=prior, log_likelihood=bimodal_t, n_dim=D, n_particles=N,
                        vectorize=True, clustering=True, k_max=4, dtype=torch.float64,
                        device="cpu")
    iteration = make_iteration(cfg, lambda x, *_: (bimodal_t(x), None), prior)
    th = interop.history_from_numpy(fields_h, "cpu")
    tc = interop.current_from_numpy(fields_c, "cpu")
    placeholder = single_cluster_model(D, 4, dtype=torch.float64, normalize=True)
    th, tc, model_t = iteration(Draws64(it_key), th, tc, placeholder)
    out.update({"p.beta": float(tc.beta), "p.logz": float(tc.logz), "p.steps": tc.steps,
                "p.calls": tc.calls, "p.iter": tc.iteration, "p.acceptance": float(tc.acceptance),
                "p.u": tc.u.numpy(), "p.logl": tc.logl.numpy(),
                "p.assignments": tc.assignments.numpy(), "p.t": th.t})
    for k in ("centers", "covariances", "weights", "k_mask"):
        out[f"pm.{k}"] = getattr(model_t, k).numpy()

    # 4. a float64 port file into the JAX x64 sampler, which runs on from it
    s = Sampler(prior, bimodal_t, n_dim=D, n_particles=N, vectorize=True, k_max=4,
                random_state=3, history_capacity=16, dtype=torch.float64, device="cpu")
    for _ in range(8):
        s.sample()
    s.save_state(port_file)
    js.load_state(port_file)
    loaded = js.state
    out["pl.dtype"] = str(loaded.hist.u.dtype)
    out["pl.max_diff"] = max(
        float(np.max(np.abs(np.nan_to_num(np.asarray(getattr(loaded.hist, k)))
                            - np.nan_to_num(getattr(s.state.hist, k).numpy()))))
        for k in ("u", "x", "logl", "mis_c", "beta", "logz"))
    out["pl.t"] = int(loaded.hist.t)
    nxt = js.sample()
    out["pl.next_beta"], out["pl.next_logz"] = nxt["beta"], nxt["logz"]
    out["pl.next_dtype"] = str(js.state.hist.logl.dtype)

    # 5. dynamic mode in float64 on the histories of test_torch_dynamic.py
    from tempest_tpu.state import commit, make_current, make_history
    from tempest_tpu.ops.tools import ess_from_logw
    from tempest_tpu.state import logw_from_denominator
    sys.path.insert(0, "tests")
    from test_torch_dynamic import CASES, CAP, D as DD, N as DN

    for i, (fill, seed, contract, ess_mult, cv_target) in enumerate(CASES):
        rng = np.random.default_rng(seed)
        hist = make_history(CAP, DN, DD, dtype=jnp.float64)
        cur = make_current(DN, DD, dtype=jnp.float64)
        for t in range(fill):
            width = 1.0 / (1.0 + t) if contract else 4.0
            u = np.clip(0.5 + width * rng.normal(0, 0.25, (DN, DD)), 0.0, 1.0)
            logl = -0.5 * np.sum(((u - 0.5) / 0.05) ** 2, axis=1)
            cur = cur.replace(u=jnp.asarray(u), x=jnp.asarray(u), logl=jnp.asarray(logl),
                              beta=jnp.asarray(0.002 * t * t, jnp.float64),
                              logz=jnp.asarray(-0.3 * t, jnp.float64))
            hist = commit(hist, cur)
        beta_prev = float(hist.beta[fill - 1])
        denom = mis_denominator(hist)
        ess_at = lambda b: float(ess_from_logw(logw_from_denominator(hist, denom, b)[0]))
        target = (0.5 * ess_at(1.0) if ess_mult == "jump" else ess_mult * ess_at(beta_prev))
        rw = jax_reweight(hist, jnp.asarray(beta_prev, jnp.float64), target,
                          cv_target=cv_target, dynamic=True, use_pallas=False)
        out.update({f"dyn{i}.{k}": np.array(getattr(hist, k))
                    for k in interop.HISTORY_FIELDS + ("t",)})
        out[f"dyn{i}.args"] = np.array([beta_prev, target, cv_target])
        out[f"dyn{i}.want"] = np.array(rw.beta)
        out[f"dyn{i}.bracket"] = np.array(_find_ess_bracket(
            _make_metric_fns(hist, False, denom)[0], jnp.asarray(beta_prev, jnp.float64),
            jnp.asarray(target, jnp.float64), jnp.float64))

    # 6. the CV at d = 100 (tests/test_torch_tools.py's inputs)
    from tempest_tpu.ops.tools import volume_variation_dtn
    from test_torch_tools import cv100_inputs

    u, w, mask = cv100_inputs()
    out["cv100"] = np.array(volume_variation_dtn(jnp.asarray(u), jnp.asarray(w),
                                                 mask=jnp.asarray(mask)))

    # 7. threefry's float64 draws, 2^16 each, for the distribution tests
    ks = jax.random.split(jax.random.PRNGKey(2026), 5)
    out["ks.normal"] = np.array(jax.random.normal(ks[0], (1 << 16,), dtype=jnp.float64))
    out["ks.uniform"] = np.array(jax.random.uniform(ks[1], (1 << 16,), dtype=jnp.float64))
    for k, a in zip(ks[2:], (0.02, 1.0, 7.5)):
        out[f"ks.gamma{a}"] = np.array(jax.random.gamma(k, jnp.full((1 << 16,), a, jnp.float64),
                                                        dtype=jnp.float64))
    np.savez(out_path, **out)
    """
)


@pytest.fixture(scope="module")
def jax_x64(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("x64")
    paths = [tmp / "jax_x64.npz", tmp / "jax_x64.state", tmp / "port_f64.state"]
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, *map(str, paths)], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(paths[0]) as data:
        out = {k: data[k] for k in data.files}
    out["jax_file"] = paths[1]
    return out


def test_volume_variation_dtn_at_d100_float64(jax_x64):
    """The CV at d = 100 in float64 against JAX's under x64: rtol 1e-12."""
    from tempest_tpu_torch.ops.tools import volume_variation_dtn
    from test_torch_tools import cv100_inputs

    u, w, mask = (torch.from_numpy(a) for a in cv100_inputs())
    got = volume_variation_dtn(u, w, mask=mask)
    want = float(jax_x64["cv100"])
    assert got.dtype == torch.float64 and want < 1e10
    assert abs(float(got) - want) <= 1e-12 * want


@pytest.mark.parametrize("bits", [32, 64])
def test_threefry_uniform_bit_for_bit(jax_x64, bits):
    want = jax_x64[f"u{bits}"]
    got = [threefry.uniform(tuple(int(w) for w in k), bits) for k in jax_x64["keys"]]
    assert got == want.tolist()


def test_fit_uniforms_float64_with_restarts(jax_x64):
    got = fit_uniforms(4, dtype=torch.float64, n_init=3)
    assert got.dtype == torch.float64 and got.shape == (4, 3, 2)
    assert got.tolist() == jax_x64["fit_uniforms_3"].tolist()


def _history(jax_x64):
    fields = {k[2:]: jax_x64[k] for k in jax_x64 if k.startswith("h.")}
    return interop.history_from_numpy(fields, "cpu")


@pytest.mark.parametrize("case", range(4), ids=["stay", "jump", "bisect", "bisect_from_0"])
def test_bisection_against_xla_float64(jax_x64, case):
    hist = _history(jax_x64)
    assert hist.logl.dtype == torch.float64
    bm = torch.where(hist.sample_mask(), mis_denominator(hist), torch.tensor(float("inf"),
                                                                             dtype=torch.float64))
    scal = torch.tensor(jax_x64["bis.cases"][case], dtype=torch.float64)
    beta, probes = ess_bisect_beta(hist.logl.reshape(-1), bm.reshape(-1), scal)
    want_beta, want_probes = float(jax_x64["bis.beta"][case]), int(jax_x64["bis.probes"][case])
    assert beta.dtype == torch.float64
    assert int(probes) == want_probes
    assert (want_probes > 2) == (case >= 2)
    assert abs(float(beta) - want_beta) <= 1e-12 * abs(want_beta)
    again = ess_bisect_beta_reference(hist.logl.reshape(-1), bm.reshape(-1), scal)
    assert float(again[0]) == float(beta)


@pytest.mark.parametrize("case", range(len(DYNAMIC_CASES)))
def test_dynamic_reweight_against_xla_float64(jax_x64, case):
    fields = {k.split(".", 1)[1]: v for k, v in jax_x64.items()
              if k.startswith(f"dyn{case}.")}
    beta_prev, target, cv_target = fields.pop("args").tolist()
    want = float(fields.pop("want"))
    hist = interop.history_from_numpy(fields, "cpu")
    assert hist.logl.dtype == torch.float64
    got = reweight(hist, torch.tensor(beta_prev, dtype=torch.float64), target,
                   cv_target=cv_target, dynamic=True)
    assert got.beta.dtype == torch.float64
    assert float(got.beta) == want


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("case", range(len(DYNAMIC_CASES)))
def test_dynamic_loop_bisections_against_xla_float64(jax_x64, case, chunk):
    """The bracket and the CV bisection as device loops in chunks of 1, 3
    and 8 bodies reach XLA's float64 beta bit for bit."""
    fields = {k.split(".", 1)[1]: v for k, v in jax_x64.items()
              if k.startswith(f"dyn{case}.")}
    beta_prev, target, cv_target = fields.pop("args").tolist()
    want = float(fields.pop("want"))
    hist = interop.history_from_numpy(fields, "cpu")
    loops = Loops("cpu", {"ess_bracket": chunk, "cv_bisect": chunk})
    got = reweight(hist, torch.tensor(beta_prev, dtype=torch.float64), target,
                   cv_target=cv_target, dynamic=True, loops=loops)
    assert got.beta.dtype == torch.float64
    assert float(got.beta) == want
    assert loops.stats["ess_bracket"]["reads"] >= 1


@pytest.mark.parametrize("case", range(len(DYNAMIC_CASES)))
def test_bracket_plain_route_against_xla_float64(jax_x64, case):
    """The plain route of the ESS kernel's bracket mode in float64: the
    "ess_bracket" loop's bracket and probes bit for bit, and XLA's float64
    `_find_ess_bracket` within 1e-12 (relative)."""
    fields = {k.split(".", 1)[1]: v for k, v in jax_x64.items()
              if k.startswith(f"dyn{case}.")}
    beta_prev, target, _ = fields.pop("args").tolist()
    want = fields.pop("bracket")
    fields.pop("want")
    hist = interop.history_from_numpy(fields, "cpu")
    denom = mis_denominator(hist)
    bm = torch.where(hist.sample_mask(), denom, torch.full_like(denom, float("inf")))
    got, probes = ess_bracket(hist.logl.reshape(-1), bm.reshape(-1),
                              torch.tensor([beta_prev, target], dtype=torch.float64))
    before = rw_mod.PROBES["ess_bracket"]
    lo, hi, _ = rw_mod._find_ess_bracket(hist, denom, torch.tensor(beta_prev, dtype=torch.float64),
                                         target)
    assert got.dtype == torch.float64 and torch.equal(got, torch.stack([lo, hi]))
    assert int(probes) == rw_mod.PROBES["ess_bracket"] - before
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * max(np.abs(want).max(), 1.0),
                               err_msg=what)


def test_one_clustered_iteration_value_for_value(jax_x64):
    r = jax_x64
    assert r["pm.centers"].dtype == np.float64 and r["p.u"].dtype == np.float64
    assert r["pm.k_mask"].tolist() == r["jm.k_mask"].tolist() and r["pm.k_mask"].sum() >= 2
    for name in ("centers", "covariances", "weights"):
        _close(r[f"pm.{name}"], r[f"jm.{name}"], name)
    np.testing.assert_array_equal(r["p.assignments"], r["j.assignments"])
    assert int(r["p.iter"]) == int(r["j.iter"]) and int(r["p.steps"]) == int(r["j.steps"])
    assert int(r["p.calls"]) * N == int(r["j.calls"])
    for name in ("beta", "logz", "acceptance", "u", "logl"):
        _close(r[f"p.{name}"], r[f"j.{name}"], name)


def _bimodal_t(x):
    norm = -0.5 * D * math.log(2 * math.pi * 0.25)
    a = norm - 0.5 * torch.sum((x - 3.0) ** 2, dim=-1) / 0.25
    b = norm - 0.5 * torch.sum((x + 3.0) ** 2, dim=-1) / 0.25
    return torch.logaddexp(a, b) - math.log(2.0)


def _prior(u):
    return 20.0 * u - 10.0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_jax_x64_file_loads_into_the_port(jax_x64, dtype):
    """Into a float64 sampler as it is; into a float32 one cast down, as JAX
    without x64 loads it."""
    s = Sampler(_prior, _bimodal_t, n_dim=D, n_particles=N, vectorize=True, k_max=4,
                history_capacity=16, dtype=dtype, device="cpu")
    s.load_state(jax_x64["jax_file"])
    hist = s.state.hist
    assert hist.u.dtype == dtype and s.state.cur.logl.dtype == dtype
    assert hist.t == int(jax_x64["h.t"])
    for k in ("u", "logl", "mis_c", "beta", "logz"):
        np.testing.assert_array_equal(getattr(hist, k).numpy(), jax_x64[f"h.{k}"].astype(
            np.float64 if dtype == torch.float64 else np.float32))
    for _ in range(2):
        out = s.sample()
    assert math.isfinite(out["logz"]) and out["beta"] > float(jax_x64["h.beta"][hist.t - 3])


def test_port_float64_file_loads_into_jax_x64(jax_x64):
    r = jax_x64
    assert str(r["pl.dtype"]) == "float64" and str(r["pl.next_dtype"]) == "float64"
    assert float(r["pl.max_diff"]) == 0.0 and int(r["pl.t"]) == 8
    assert math.isfinite(float(r["pl.next_logz"])) and 0.0 < float(r["pl.next_beta"]) <= 1.0


N_DIM = 4


def _gauss(x):
    return -0.5 * torch.sum(x**2, dim=-1) - 0.5 * N_DIM * math.log(2 * math.pi)


def _gauss_sampler(hardware_prng, n_particles=256):
    return Sampler(_prior, _gauss, n_dim=N_DIM, n_particles=n_particles, vectorize=True,
                   clustering=False, random_state=1, dtype=torch.float64,
                   hardware_prng=hardware_prng, device="cpu")


def _gauss_run(hardware_prng):
    s = _gauss_sampler(hardware_prng)
    s.run(n_total=1024, progress=False)
    return s


def test_float64_gaussian_end_to_end():
    """tests/test_float64.py's run and bars, on the port."""
    s = _gauss_run(False)
    hist = s.state.hist
    assert hist.u.dtype == torch.float64 and hist.logl.dtype == torch.float64
    assert s.beta > 0.99
    assert abs(s.evidence()[0] + N_DIM * math.log(20.0)) < 0.35
    valid = hist.sample_mask()
    mis_err = float(torch.max(torch.abs(mis_denominator(hist) - mis_denominator_exact(hist))[valid]))
    assert mis_err < 1e-9


def test_hardware_prng_does_not_apply_to_float64():
    off, on = _gauss_run(False), _gauss_run(True)
    assert on.state.draws.counter == 0  # no Philox call
    assert off.results()["beta"].tobytes() == on.results()["beta"].tobytes()
    assert off.evidence()[0] == on.evidence()[0]


# ---------------------------------------------------------------------------
# 7. The float64 draws against threefry's
# ---------------------------------------------------------------------------
KS_P_FLOOR = 1e-3


def _port_draws(what: str, n: int = 1 << 16) -> np.ndarray:
    key = philox.key_from_seed(2026)
    if what == "normal":
        return philox.normal_f64(key, 1, n, "cpu").numpy()
    if what == "uniform":
        return philox.uniform_f64(key, 2, n, "cpu").numpy()
    a = float(what[len("gamma"):])
    return philox.gamma_f64(key, 3, torch.full((n,), a, dtype=torch.float64)).numpy()


@pytest.mark.parametrize("what", ["normal", "uniform", "gamma0.02", "gamma1.0", "gamma7.5"])
def test_float64_draws_match_threefry_in_distribution(jax_x64, what):
    from scipy.stats import ks_2samp

    want = jax_x64[f"ks.{what}"]
    got = _port_draws(what)
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
    assert np.all(np.isfinite(got))
    if what != "normal":
        assert got.min() > 0.0
    p = ks_2samp(got, want).pvalue
    assert p > KS_P_FLOOR, (what, p)
    se = math.sqrt(got.var() / got.size + want.var() / want.size)
    assert abs(got.mean() - want.mean()) < 5 * se, (what, got.mean(), want.mean())


class _KeyedDraws(Draws):
    KEYED_ON_CPU = True


def test_hardware_prng_in_float64_takes_draws(monkeypatch):
    """A float64 sampler takes `Draws` with either flag (the flag does not
    apply); keyed (forced here, as on the card) the two flags draw the same
    key and give the same bits, iteration by iteration, with the same draw
    state under `Draws`' checkpoint names."""
    from tempest_tpu_torch import core as core_mod

    assert type(_gauss_sampler(True).state.draws) is Draws
    monkeypatch.setattr(core_mod, "Draws", _KeyedDraws)
    runs = []
    for hardware_prng in (False, True):
        s = _gauss_sampler(hardware_prng, n_particles=64)
        assert type(s.state.draws) is _KeyedDraws and s.state.draws.keyed
        assert s.state.draws.key == philox.draws_key(1)
        rows = [s.sample() for _ in range(6)]
        assert rows[-1]["beta"] > 0.0 and s.state.draws.counter > 0
        runs.append((rows, s.results(), s.state.draws.get_state()))
    (rows_off, res_off, st_off), (rows_on, res_on, st_on) = runs
    assert all(set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
               for a, b in zip(rows_off, rows_on))
    assert all(res_off[k].tobytes() == res_on[k].tobytes() for k in ("beta", "logz", "u", "logl"))
    assert set(st_off) == set(st_on) == {"generator", "step_key", "step_counter"}
    assert all(np.array_equal(st_off[k], st_on[k]) for k in st_off)
