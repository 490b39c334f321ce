"""The logZ anchor of the 100-D Rosenbrock, taken from the JAX package.

    python scripts/rosenbrock100_anchor.py [--seeds 42 43 44 45 46]

Runs `tempest_tpu` on the CPU on `benchmarks/suite.py`'s `rosenbrock100`
configuration (suite.py:183-196: chained 100-D Rosenbrock of
suite.py:37-41, U(-10, 10) prior, n_particles=2048, n_total=4096,
history_capacity=256, clustering=False, on_device=True) once per seed,
and prints each seed's logZ, iterations, beta and posterior ESS, then the
band mean +/- max(3 sigma, 1.0) that `chip_smoke.py`'s rosenbrock100 phase
holds the port to. sigma is the standard deviation over the seeds
(ddof = 1). The last line is one JSON object with the same numbers.
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

N_DIM, N_PARTICLES, N_TOTAL, CAPACITY = 100, 2048, 4096, 256


def prior(u):
    return -10.0 + 20.0 * u


def rosenbrock_chained(x):
    # benchmarks/suite.py:37-41
    return -jnp.sum(
        100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2 + (1.0 - x[..., :-1]) ** 2, axis=-1
    )


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[42, 43, 44, 45, 46])
    args = parser.parse_args()

    from tempest_tpu import Sampler
    from tempest_tpu.ops.tools import ess_from_logw
    from tempest_tpu.state import compute_logw_and_logz

    runs = []
    for seed in args.seeds:
        s = Sampler(prior, rosenbrock_chained, n_dim=N_DIM, n_particles=N_PARTICLES,
                    vectorize=True, clustering=False, random_state=seed,
                    history_capacity=CAPACITY)
        t0 = time.perf_counter()
        s.run(n_total=N_TOTAL, progress=False, on_device=True)
        wall = time.perf_counter() - t0
        ess = float(ess_from_logw(compute_logw_and_logz(s.state.hist, 1.0)[0]))
        run = dict(seed=seed, logz=float(s.logz), iterations=int(s.state.hist.t),
                   beta=float(s.beta), ess=ess, cpu_wall_s=wall)
        runs.append(run)
        print(json.dumps(run), flush=True)
    logz = np.array([r["logz"] for r in runs])
    sigma = float(logz.std(ddof=1)) if len(logz) > 1 else 0.0
    half = max(3.0 * sigma, 1.0)
    out = dict(config="rosenbrock100", jax=jax.__version__, backend=jax.default_backend(),
               seeds=args.seeds, logz=logz.tolist(), mean=float(logz.mean()), sigma=sigma,
               band=[float(logz.mean()), half])
    print(f"band: {out['mean']:.4f} +/- {half:.4f} (sigma {sigma:.4f} over {len(logz)} seeds)")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
