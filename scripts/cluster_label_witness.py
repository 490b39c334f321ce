"""Witness: one walker's cluster label differs from JAX's after one fused
iteration of the clustered bimodal 4-D problem, on the CPU, and where the
difference comes from.

    JAX_PLATFORMS=cpu python3 scripts/cluster_label_witness.py [--seed 0]

tests/test_torch_clustered_slice.py's problem (D = 4, N = 128, k_max = 4)
with its likelihood as a per-point numpy function and host_likelihood=True:
JAX's sampler runs until its model has two clusters and t >= 9, then one
more `sample()`; the port's fused iteration runs from the same state on
JAX's draws (`test_torch_slice.JaxIterationDraws`), once with the torch
likelihood (vectorized) and once through the host crossing. JAX's
`tempest_tpu.steps.resample.multinomial_resample` is wrapped (the module
attribute, patched before the sampler traces anything) with a
`jax.debug.callback` that records the indices it returns inside JAX's
whole-iteration program.

For each walker whose label differs, the script prints the history index
JAX's fused program picked, the index JAX's `reweight` and
`multinomial_resample` pick when each is jitted apart (on the iteration's
resampling key), the port's pick, the position, the port's CDF at its pick
and the index before it (and JAX's cumsum of the same weights there), and
the scores of both points under the port's and JAX's fitted models. Each
route's line also counts, over the filled history slots, the unnormalized
log-weights beta * logl - B that differ between JAX (`logw_from_denominator`
jitted, normalize=False) and the port (`state.masked_logw`), how many of
JAX's equal the once-rounded fma(beta, logl, -B) and how many of the
port's the twice-rounded product and difference, and whether beta and the
denominators agree bit for bit. One JSON line a route.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from test_torch_clustered_slice import D, N, _bimodal_t, _prior
    from test_torch_host_route import _bimodal_np
    from test_torch_slice import JaxIterationDraws

    from tempest_tpu import Sampler as JaxSampler
    from tempest_tpu import cluster as jax_cluster
    from tempest_tpu import state as jax_state
    from tempest_tpu.ops.tools import multinomial_resample as jax_multinomial
    from tempest_tpu.steps import resample as jax_resample_mod
    from tempest_tpu.steps.reweight import reweight as jax_reweight
    from tempest_tpu_torch import interop
    from tempest_tpu_torch import state as port_state
    from tempest_tpu_torch.cluster import _predict_scores, single_cluster_model
    from tempest_tpu_torch.config import SamplerConfig
    from tempest_tpu_torch.fused import make_fused_iteration
    from tempest_tpu_torch.steps import resample as resample_mod
    from tempest_tpu_torch.utils.wrappers import HostLikelihood, make_pool_map

    torch.set_num_threads(1)
    fused_picks = []

    def jax_spy(key, size, weights):
        idx = jax_multinomial(key, size, weights)
        jax.debug.callback(lambda i: fused_picks.append(np.asarray(i).copy()), idx)
        return idx

    jax_resample_mod.multinomial_resample = jax_spy  # before anything is traced
    js = JaxSampler(_prior, _bimodal_np, n_dim=D, n_particles=N, host_likelihood=True,
                    clustering=True, k_max=4, random_state=args.seed, history_capacity=16)
    core = js.state
    while int(core._fused_model.n_clusters()) < 2 or int(core.hist.t) < 9:
        js.sample()
    # copies: the next sample() donates the state's buffers
    hist_j = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), core.hist)
    beta_prev = np.asarray(core.cur.beta).copy()
    fields_h = {k: np.array(getattr(core.hist, k)) for k in interop.HISTORY_FIELDS + ("t",)}
    fields_c = {k: np.array(getattr(core.cur, k))
                for k in interop.CURRENT_FIELDS + interop.CURRENT_COUNTERS}
    key = jax.random.split(core.key)[1]  # what core._next_key() hands the iteration
    out_j = js.sample()
    jax.effects_barrier()
    fused_pick = fused_picks[-1]
    model_j = core._fused_model

    # JAX's pieces jitted apart: the reweight, then the resampling on the
    # mutate branch's key (tempest_tpu/fused.py: split(key, 3)[1])
    rw = jax_reweight(hist_j, beta_prev, js.state.config.ess_ratio * N, cv_target=0.0,
                      dynamic=False, use_pallas=True)
    k_res = jax.random.split(key, 3)[1]
    apart_pick = np.asarray(jax.jit(jax_multinomial, static_argnums=1)(
        k_res, N, rw.weights.reshape(-1)))
    beta_j = np.float32(out_j["beta"])
    denom_j = np.asarray(jax_state.mis_denominator(hist_j))
    logw_j = np.asarray(jax.jit(lambda h, dn, b: jax_state.logw_from_denominator(
        h, dn, b, normalize=False)[0])(hist_j, jnp.asarray(denom_j), beta_j))

    seen = {}
    plain_invert = resample_mod.multinomial_resample

    def spy(uniforms, w):
        idx = plain_invert(uniforms, w)
        seen.update(uniforms=uniforms.clone(), w=w.clone(), idx=idx.clone())
        return idx

    resample_mod.multinomial_resample = spy
    for route in ("vectorized", "host"):
        cfg = SamplerConfig(prior_transform=_prior, log_likelihood=_bimodal_t, n_dim=D,
                            n_particles=N, vectorize=True, clustering=True, k_max=4,
                            device="cpu", host_likelihood=route == "host")
        ll = (HostLikelihood(_bimodal_np, make_pool_map(None), torch.float32)
              if route == "host" else (lambda x, *_: (_bimodal_t(x), None)))
        iteration = make_fused_iteration(cfg, ll, _prior)
        hist = interop.history_from_numpy(fields_h, "cpu")
        cur = interop.current_from_numpy(fields_c, "cpu")
        u_all = hist.u.reshape(D, -1)
        denom_t = port_state.mis_denominator(hist)
        hist_out, cur, model = iteration(JaxIterationDraws(key), hist, cur,
                                         single_cluster_model(D, 4, normalize=True))
        beta_t = cur.beta.to(torch.float32)
        logw_t = port_state.masked_logw(hist, denom_t, beta_t).numpy()
        filled = np.isfinite(logw_j) & np.isfinite(logw_t)
        logl = fields_h["logl"].astype(np.float64)
        exact = beta_j.astype(np.float64) * logl - denom_j.astype(np.float64)
        fma = exact.astype(np.float32)  # one rounding (beta * logl is exact in float64)
        twice = (beta_j * fields_h["logl"]).astype(np.float32) - denom_j
        weights = {
            "filled": int(filled.sum()),
            "beta_equal": bool(np.float32(beta_t) == beta_j),
            "denominators_differ": int((denom_t.numpy() != denom_j)[filled].sum()),
            "logw_differ": int((logw_t != logw_j)[filled].sum()),
            "jax_equals_fma": int((logw_j == fma)[filled].sum()),
            "port_equals_twice_rounded": int((logw_t == twice)[filled].sum()),
        }
        labels = cur.assignments.numpy()
        differ = np.nonzero(labels != out_j["assignments"])[0].tolist()
        w = seen["w"] / seen["w"].sum()
        cdf = torch.cumsum(w, 0)
        cdf_j = np.asarray(jnp.cumsum(jnp.asarray(w.numpy())))
        walkers = []
        for i in differ:
            pick = int(seen["idx"][i])
            points = u_all[:, [pick - 1, pick]].T
            walkers.append({
                "walker": i, "port_label": int(labels[i]),
                "jax_label": int(out_j["assignments"][i]),
                "jax_fused_pick": int(fused_pick[i]), "jax_apart_pick": int(apart_pick[i]),
                "port_pick": pick,
                "position": float(seen["uniforms"][i]),
                "cdf_before_picked": [float(cdf[pick - 1]), float(cdf[pick])],
                "jax_cumsum_before_picked": [float(cdf_j[pick - 1]), float(cdf_j[pick])],
                "rel_eps_above_edge": float((seen["uniforms"][i] - cdf[pick - 1])
                                            / torch.finfo(torch.float32).eps
                                            / cdf[pick - 1]),
                "scores_port": _predict_scores(model, points)[0].T.tolist(),
                "scores_jax": np.asarray(jax_cluster._predict_scores(
                    model_j, jnp.asarray(points.numpy()))[0]).T.tolist(),
            })
        picks = {"fused_equal_port": int((fused_pick == seen["idx"].numpy()).sum()),
                 "apart_equal_port": int((apart_pick == seen["idx"].numpy()).sum())}
        print(json.dumps({"seed": args.seed, "route": route, "t": int(hist_out.t) - 1,
                          "clusters": int(model.n_clusters()), "weights": weights,
                          "picks_of_128": picks, "differ": walkers}), flush=True)
    resample_mod.multinomial_resample = plain_invert


if __name__ == "__main__":
    main()
