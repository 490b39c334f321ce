"""Witness: one walker's cluster label differs from JAX's after one fused
iteration of the clustered bimodal 4-D problem, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/cluster_label_witness.py [--seed 0]

tests/test_torch_clustered_slice.py's problem (D = 4, N = 128, k_max = 4)
with its likelihood as a per-point numpy function and host_likelihood=True:
JAX's sampler runs until its model has two clusters and t >= 9, then one
more `sample()`; the port's fused iteration runs from the same state on
JAX's draws (`test_torch_slice.JaxIterationDraws`), once with the torch
likelihood (vectorized) and once through the host crossing. For each
walker whose label differs, the script prints the history index the port's
resampling picked, the position, the port's CDF at that index and the one
before it (and JAX's cumsum of the same weights there), and the scores of
the picked point and of the one before it under the port's and JAX's
fitted models. One JSON line a route.
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
    from tempest_tpu_torch import interop
    from tempest_tpu_torch.cluster import _predict_scores, single_cluster_model
    from tempest_tpu_torch.config import SamplerConfig
    from tempest_tpu_torch.fused import make_fused_iteration
    from tempest_tpu_torch.steps import resample as resample_mod
    from tempest_tpu_torch.utils.wrappers import HostLikelihood, make_pool_map

    torch.set_num_threads(1)
    js = JaxSampler(_prior, _bimodal_np, n_dim=D, n_particles=N, host_likelihood=True,
                    clustering=True, k_max=4, random_state=args.seed, history_capacity=16)
    core = js.state
    while int(core._fused_model.n_clusters()) < 2 or int(core.hist.t) < 9:
        js.sample()
    fields_h = {k: np.array(getattr(core.hist, k)) for k in interop.HISTORY_FIELDS + ("t",)}
    fields_c = {k: np.array(getattr(core.cur, k))
                for k in interop.CURRENT_FIELDS + interop.CURRENT_COUNTERS}
    key = jax.random.split(core.key)[1]  # what core._next_key() hands the iteration
    out_j = js.sample()
    model_j = core._fused_model

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
        hist, cur, model = iteration(JaxIterationDraws(key), hist, cur,
                                     single_cluster_model(D, 4, normalize=True))
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
                "jax_label": int(out_j["assignments"][i]), "picked": pick,
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
        print(json.dumps({"seed": args.seed, "route": route, "t": int(core.hist.t) - 1,
                          "clusters": int(model.n_clusters()), "differ": walkers}), flush=True)
    resample_mod.multinomial_resample = plain_invert


if __name__ == "__main__":
    main()
