"""How often a gloo rank that still holds a DeviceMesh aborts at exit.

    python scripts/mesh_teardown_stress.py [--pairs 300] [--parallel 5] [--free]

Starts pairs of ranks on the CPU, each its own process of one thread
joined over gloo through a file store: each builds the particle mesh's
1-D `DeviceMesh` (`init_device_mesh`, as
`tempest_tpu_torch.parallel.make_particle_mesh` does), runs 300 rounds of
the port's collectives (all-gather, all-reduce, reduce-scatter) on the
mesh's group, calls `destroy_process_group()` and exits, its mesh still
held by a module global, as a sampler left in a reference cycle holds it,
so that the interpreter's teardown frees it. With `--free` each rank
first drops its mesh and collects garbage, so that nothing holding the
group outlives it, as `tests/test_torch_parallel.py`'s `worker_main`
does. `--parallel` pairs run at once (the load of a test
run). Prints the count of each exit code: -6 is PyTorch aborting in the
interpreter's teardown ("terminate called without an active exception")
after the rank's work is done. Imports no JAX and nothing of the port.
"""

from __future__ import annotations

import argparse
import collections
import gc
import os
import subprocess
import sys
import tempfile
from datetime import timedelta

KEPT = []  # meshes left to the interpreter's teardown


def rank_main(store: str, rank: int, free: bool) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2, rank=rank,
                            timeout=timedelta(seconds=60))
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("particles",))
    group = mesh.get_group("particles")
    x = torch.ones(64)
    for _ in range(300):
        dist.all_gather_into_tensor(torch.empty(128), x, group=group)
        dist.all_reduce(x, group=group)
        x = x / 2
        dist.reduce_scatter_tensor(torch.empty(32), torch.ones(64), group=group)
    if free:
        del mesh, group
        gc.collect()
    else:
        KEPT.append(mesh)
    dist.destroy_process_group()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pairs", type=int, default=300)
    parser.add_argument("--parallel", type=int, default=5)
    parser.add_argument("--free", action="store_true")
    parser.add_argument("--rank", nargs=2, metavar=("STORE", "RANK"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.rank:
        rank_main(args.rank[0], int(args.rank[1]), args.free)
        return
    codes = collections.Counter()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    with tempfile.TemporaryDirectory() as tmp:
        for first in range(0, args.pairs, args.parallel):
            procs = []
            for pair in range(first, min(first + args.parallel, args.pairs)):
                store = os.path.join(tmp, f"store_{pair}")
                procs += [subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--rank", store, str(rank)]
                    + (["--free"] if args.free else []),
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=env)
                    for rank in range(2)]
            for p in procs:
                codes[p.wait()] += 1
    print(f"{'--free' if args.free else 'mesh kept'}: {2 * args.pairs} ranks, exit codes "
          f"{dict(sorted(codes.items()))}", flush=True)


if __name__ == "__main__":
    main()
