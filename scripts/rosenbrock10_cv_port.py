"""Dynamic (CV) mode of tempest_tpu_torch on one GPU: logZ over seeds.

    python scripts/rosenbrock10_cv_port.py [--seeds 42 43 ...] [--repeats 2]

Runs the port on `benchmarks/suite.py`'s `rosenbrock10_cv` configuration
(the one of `chip_smoke.py` phase 12: chained 10-D Rosenbrock, U(-10, 10)
prior, n_particles=1024, n_total=8192, history_capacity=192,
clustering=False, volume_variation=1.0) once per seed, the first seed
`--repeats` times, and prints each run's logZ, iterations, posterior ESS
and wall, then the mean and standard deviation (ddof = 1) over the seeds,
to set beside `scripts/rosenbrock10_cv_anchor.py`'s values of the JAX
package. Before that it counts the distinct results of 200 calls of
`torch.cumsum` and of the port's row-scan `ops.tools.cumsum` on one
vector of each size the resampling CDF takes on the canonical problem
(64 x 1024), here (192 x 1024) and on B (1,048,576). The last line is one
JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tempest_tpu_torch import Sampler  # noqa: E402
from tempest_tpu_torch.ops import tools  # noqa: E402


def prior(u):
    return 20.0 * u - 10.0


def rosenbrock_chained(x):
    # benchmarks/suite.py:37-41
    return -torch.sum(
        100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2 + (1.0 - x[..., :-1]) ** 2, dim=-1
    )


def distinct(fn, x, calls: int = 200) -> int:
    return len({hashlib.md5(fn(x).cpu().numpy().tobytes()).digest() for _ in range(calls)})


def run(seed: int, device) -> dict:
    s = Sampler(prior, rosenbrock_chained, n_dim=10, n_particles=1024, vectorize=True,
                clustering=False, history_capacity=192, volume_variation=1.0,
                random_state=seed, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(n_total=8192, progress=False)
    torch.cuda.synchronize()
    out = dict(seed=seed, logz=s.evidence()[0], iterations=int(s.state.hist.t),
               ess=s.state.posterior_ess(), wall_s=time.perf_counter() - t0)
    print(json.dumps(out), flush=True)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=list(range(42, 55)))
    parser.add_argument("--repeats", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script measures the port on an NVIDIA GPU")
    device = torch.device("cuda")

    scans = {}
    gen = torch.Generator(device=device).manual_seed(0)
    for n in (64 * 1024, 192 * 1024, 1 << 20):
        x = torch.rand(n, generator=gen, device=device)
        x = x / x.sum()
        scans[n] = dict(torch_cumsum=distinct(lambda v: torch.cumsum(v, 0), x),
                        row_scan=distinct(tools.cumsum, x))
        print(f"cumsum n={n}: distinct results of 200 calls: torch.cumsum "
              f"{scans[n]['torch_cumsum']}, ops.tools.cumsum {scans[n]['row_scan']}", flush=True)

    first = [run(args.seeds[0], device) for _ in range(args.repeats)]
    runs = first[:1] + [run(seed, device) for seed in args.seeds[1:]]
    logz = np.array([r["logz"] for r in runs])
    sigma = float(logz.std(ddof=1)) if len(logz) > 1 else 0.0
    print(f"seeds {args.seeds[0]}-{args.seeds[-1]}: logZ mean {logz.mean():.4f} sigma "
          f"{sigma:.4f}; seed {args.seeds[0]} repeated {args.repeats}x: "
          f"{[r['logz'] for r in first]}", flush=True)
    print(json.dumps(dict(config="rosenbrock10_cv", device=torch.cuda.get_device_name(0),
                          torch=torch.__version__, cumsum_distinct=scans,
                          seeds=args.seeds, logz=logz.tolist(), mean=float(logz.mean()),
                          sigma=sigma, repeats=[r["logz"] for r in first])), flush=True)


if __name__ == "__main__":
    main()
