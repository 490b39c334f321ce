"""A's MCMC steps by draw source: the keyed step draws against the generator's.

    python3 scripts/draws_witness.py [--device cuda] [--seeds 42 43 44] [--out FILE]

Runs A (the paired 10-D Rosenbrock of `chip_smoke.py`, n_particles=1024,
n_total=8192, clustered, float32, `on_device=False`) once a seed with each
source of the MCMC step draws, the rest of the run alike:

- "keyed": the Philox kernels on the call counter's device words under
  `philox.draws_key(seed)` (`draws.Draws` on a CUDA device; on the CPU the
  kernels' plain versions, bit for bit the kernels' draws);
- "generator": `torch.randn`, `torch._standard_gamma` and `torch.rand` on
  the run's seeded generator (`draws.Draws` on the CPU; on a CUDA device the
  same object with its keyed steps turned off);
- "hardware_prng": `draws.HardwareDraws`, the same kernels under
  `philox.key_from_seed(seed)`.

For each run it prints the MCMC steps, iterations, logZ, the mode fits
whose Student-t dof sits at the floor of its multisection (below 1e-20;
the floor is 1e-30), and the steps of the iterations that fitted such a
mode. It then draws 2^20 values of each kind from the mutation-draws
kernel (the plain version on the CPU) and from the generator at the gamma
shapes of A's fits ((d + dof) / 2: 5.0 at the dof floor, 5.5, 7.5, 55) and
prints their means, variances and two-sample Kolmogorov-Smirnov distances.
The last line is one JSON object with every number; `--out` (default
chiprun_out/draws_witness.json) keeps it too. About 2 min on the card,
10 min on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tempest_tpu_torch import Sampler  # noqa: E402
from tempest_tpu_torch import core as core_mod  # noqa: E402
from tempest_tpu_torch import iteration as it  # noqa: E402
from tempest_tpu_torch.draws import Draws  # noqa: E402
from tempest_tpu_torch.ops import cuda_prng, philox  # noqa: E402

N_DIM, N_PARTICLES, N_TOTAL, CAPACITY = 10, 1024, 8192, 64
NU_FLOOR = 1e-20
ALPHAS = (5.0, 5.5, 7.5, 55.0)
N_MOMENTS = 1 << 20


def prior_transform(u):
    return 20.0 * u - 10.0


def rosenbrock(x):
    return -torch.sum(100.0 * (x[..., 1::2] - x[..., ::2] ** 2) ** 2
                      + (1.0 - x[..., ::2]) ** 2, dim=-1)


class KeyedDraws(Draws):
    """`Draws` with its keyed steps on the CPU too (the plain versions)."""

    KEYED_ON_CPU = True


def generator_draws(seed, device, dtype=torch.float32):
    """`Draws` whose MCMC steps draw from the generator on any device."""
    draws = Draws(seed, device, dtype)
    draws.keyed, draws.calls = False, None
    return draws


def run_a(device: str, seed: int, source: str) -> dict:
    """A's seed `seed` with the step draws of `source`."""
    rows, floor = [], [0]  # (modes at the floor in the iteration's fit, its steps)
    inner = {name: getattr(it, name) for name in ("fit_mode_statistics", "commit")}

    def fit_mode_statistics(*args, **kwargs):
        modes = inner["fit_mode_statistics"](*args, **kwargs)
        floor[0] = int((modes.degrees_of_freedom[modes.k_mask] < NU_FLOOR).sum())
        return modes

    def commit(hist, cur):
        rows.append((floor[0], int(cur.steps)))
        floor[0] = 0
        return inner["commit"](hist, cur)

    make = {"keyed": Draws if device != "cpu" else KeyedDraws,
            "generator": generator_draws, "hardware_prng": None}[source]
    saved = core_mod.Draws
    it.fit_mode_statistics, it.commit = fit_mode_statistics, commit
    try:
        if make is not None:
            core_mod.Draws = make
        s = Sampler(prior_transform, rosenbrock, n_dim=N_DIM, n_particles=N_PARTICLES,
                    vectorize=True, clustering=True, hardware_prng=source == "hardware_prng",
                    history_capacity=CAPACITY, random_state=seed, device=device)
        keyed = bool(s.state.draws.keyed)
        t0 = time.perf_counter()
        s.run(n_total=N_TOTAL, progress=False)
        wall = time.perf_counter() - t0
    finally:
        core_mod.Draws = saved
        it.fit_mode_statistics, it.commit = inner["fit_mode_statistics"], inner["commit"]
    res = s.results()
    steps = res["steps"][res["beta"] > 0]
    at_floor = [(n, k) for n, k in rows if n > 0]
    return dict(source=source, seed=seed, keyed=keyed, steps=int(steps.sum()),
                iters=int(s.state.hist.t), logz=float(s.evidence()[0]), wall_s=wall,
                steps_per_mutation=float(steps.mean()), fits_at_floor=len(at_floor),
                modes_at_floor=sum(n for n, _ in at_floor),
                steps_after_floor_fits=sum(k for _, k in at_floor),
                steps_by_iteration=[k for _, k in rows])


def ks_distance(a: torch.Tensor, b: torch.Tensor) -> float:
    """The two-sample Kolmogorov-Smirnov distance of two 1-D samples."""
    a, b = np.sort(a.double().cpu().numpy()), np.sort(b.double().cpu().numpy())
    grid = np.concatenate([a, b])
    fa = np.searchsorted(a, grid, side="right") / a.size
    fb = np.searchsorted(b, grid, side="right") / b.size
    return float(np.max(np.abs(fa - fb)))


def moments(device: str) -> dict:
    """The mutation-draws kernel's z, g and u against the generator's."""
    out = {}
    key = philox.draws_key(42)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    for a in ALPHAS:
        alpha = torch.full((N_MOMENTS // 8,), a, device=device)
        z_shape = (8, N_MOMENTS // 8, 1)
        if device == "cpu":
            z, g, u = philox.mutation_draws(key, 3, alpha, z_shape)
        else:
            z, g, u = cuda_prng.hw_mutation_draws(key, 3, alpha, z_shape)
        z = z.reshape(-1)
        g2 = torch._standard_gamma(alpha, generator=gen)
        z2 = torch.randn(z.numel(), generator=gen, device=device)
        u2 = torch.rand(alpha.numel(), generator=gen, device=device)
        row = {}
        for name, k, t in (("z", z, z2), ("g", g, g2), ("u", u, u2), ("1/g", 1 / g, 1 / g2)):
            row[name] = dict(kernel_mean=float(k.double().mean()),
                             generator_mean=float(t.double().mean()),
                             kernel_var=float(k.double().var()),
                             generator_var=float(t.double().var()),
                             ks=ks_distance(k, t), n=[k.numel(), t.numel()])
        out[str(a)] = row
        print(f"alpha {a}: " + "; ".join(
            f"{n} mean {r['kernel_mean']:.5f} / {r['generator_mean']:.5f} var "
            f"{r['kernel_var']:.5f} / {r['generator_var']:.5f} KS {r['ks']:.5f}"
            for n, r in row.items()) + " (kernel / generator)", flush=True)
    return out


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+", default=[42, 43, 44])
    ap.add_argument("--sources", nargs="+", default=["keyed", "generator", "hardware_prng"])
    ap.add_argument("--out", default="chiprun_out/draws_witness.json")
    args = ap.parse_args()
    if args.device == "cpu":
        torch.set_num_threads(min(4, os.cpu_count() or 1))
    device_name = card() if args.device != "cpu" else "cpu"
    print(f"device: {device_name}", flush=True)
    runs = []
    for seed in args.seeds:
        for source in args.sources:
            row = run_a(args.device, seed, source)
            runs.append(row)
            print(json.dumps(row), flush=True)
    summary = {src: [r["steps"] for r in runs if r["source"] == src] for src in args.sources}
    print(f"MCMC steps by source over seeds {args.seeds}: {json.dumps(summary)}", flush=True)
    out = dict(device=device_name, seeds=args.seeds, runs=runs, steps=summary,
               moments=moments(args.device))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
