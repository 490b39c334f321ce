"""A's MCMC steps in the JAX package, on the CPU: the yardstick of draws_witness.py.

    python scripts/draws_witness_jax.py [--seeds 42 43 44]

Runs A (the paired 10-D Rosenbrock, n_particles=1024, n_total=8192,
clustered, history_capacity=64, float32, threefry draws) with
`tempest_tpu` on the CPU, once a seed, and prints each seed's MCMC steps,
iterations and logZ; the last line is one JSON object with the same
numbers. About 2 min a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def prior(u):
    return 20.0 * u - 10.0


def rosenbrock(x):
    # Paired Rosenbrock, as bench.py:71-77.
    return -jnp.sum(100.0 * (x[..., 1::2] - x[..., ::2] ** 2) ** 2
                    + (1.0 - x[..., ::2]) ** 2, axis=-1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[42, 43, 44])
    args = ap.parse_args()
    from tempest_tpu import Sampler

    runs = []
    for seed in args.seeds:
        s = Sampler(prior, rosenbrock, n_dim=10, n_particles=1024, vectorize=True,
                    clustering=True, history_capacity=64, random_state=seed)
        t0 = time.perf_counter()
        s.run(n_total=8192, progress=False)
        wall = time.perf_counter() - t0
        res = s.results()
        steps = np.asarray(res["steps"])[np.asarray(res["beta"]) > 0]
        run = dict(seed=seed, steps=int(steps.sum()), iters=int(s.state.hist.t),
                   logz=float(s.logz), steps_per_mutation=float(steps.mean()), cpu_wall_s=wall)
        runs.append(run)
        print(json.dumps(run), flush=True)
    print(json.dumps(dict(jax=jax.__version__, backend=jax.default_backend(), runs=runs,
                          steps=[r["steps"] for r in runs])), flush=True)


if __name__ == "__main__":
    main()
