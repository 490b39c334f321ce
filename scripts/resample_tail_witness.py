"""Witness: the resampler's zero-weight tail on benchmarks/large_scale.py's path.

    python3 scripts/resample_tail_witness.py [--n 1048576] [--d 100] [--iters 5]
                                             [--device cuda]

Runs the port on large_scale.py's configuration (the chained Rosenbrock,
U(-10, 10), unclustered, random_state=5, history_capacity=8,
n_candidates=1, n_max_steps=20) for `--iters` sample() calls and watches
every CDF inversion of the resampling (`ops.tools._invert_cdf`). The
history's unfilled rows weigh 0 at the end of the flat weights; where the
float sum of the CDF stops short of 1 before them, JAX's rule
(tempest_tpu/ops/tools.py:89-94: cdf[-1] = 1, searchsorted, clip) gives the
positions past the shortfall the last index, a slot of zero weight whose
logl is -inf. For each inversion the script prints the weights' length,
the last index of nonzero weight, the CDF there, the positions past it, and
how many picks of zero weight JAX's rule and the port's make on the same
CDF; after each call, the active set's walkers whose logl is not finite.
One JSON line a call, then a summary line. On the card at N = 2^20 the
last call before the repair held a walker of logl -inf.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from tempest_tpu_torch import Sampler  # noqa: E402
from tempest_tpu_torch.ops import tools  # noqa: E402


def rosenbrock_chained(x):
    # benchmarks/large_scale.py:53-57
    return -torch.sum(
        100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2 + (1.0 - x[..., :-1]) ** 2, dim=-1
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=1 << 20)
    parser.add_argument("--d", type=int, default=100)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    seen = []
    invert = tools._invert_cdf

    def watched(w, positions):
        n = w.shape[0]
        cdf = tools.cumsum(w)
        nonzero = torch.nonzero(w > 0).flatten()
        last = int(nonzero[-1]) if nonzero.numel() else 0
        guard = cdf.clone()
        guard[-1] = 1.0
        jax_rule = torch.clamp(torch.searchsorted(guard, positions, right=False), 0, n - 1)
        port = invert(w, positions)
        seen.append({"n": n, "last_nonzero": last, "cdf_at_last": float(cdf[last]),
                     "positions_past_it": int((positions > cdf[last]).sum()),
                     "zero_weight_picks_jax_rule": int((w[jax_rule] == 0).sum()),
                     "zero_weight_picks_port": int((w[port] == 0).sum())})
        return port

    tools._invert_cdf = watched
    s = Sampler(lambda u: 20.0 * u - 10.0, rosenbrock_chained, n_dim=args.d, n_particles=args.n,
                vectorize=True, clustering=False, random_state=5, history_capacity=8,
                n_candidates=1, n_max_steps=20, device=args.device)
    rows = []
    for call in range(1, args.iters + 1):
        before = len(seen)
        t0 = time.perf_counter()
        out = s.sample()
        logl = s.state.cur.logl
        row = {"call": call, "wall_s": time.perf_counter() - t0, "beta": out["beta"],
               "logz": out["logz"], "inversions": seen[before:],
               "active_logl_not_finite": int((~torch.isfinite(logl)).sum())}
        rows.append(row)
        print(json.dumps(row), flush=True)
    device = torch.cuda.get_device_name(0) if args.device == "cuda" else args.device
    print(json.dumps({"device": device, "n": args.n, "d": args.d,
                      "zero_weight_picks_jax_rule": sum(i["zero_weight_picks_jax_rule"]
                                                        for r in rows for i in r["inversions"]),
                      "zero_weight_picks_port": sum(i["zero_weight_picks_port"]
                                                    for r in rows for i in r["inversions"]),
                      "active_logl_not_finite": sum(r["active_logl_not_finite"] for r in rows)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
