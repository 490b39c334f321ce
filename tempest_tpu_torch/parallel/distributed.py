"""Joining the ranks of a multi-GPU run (tempest_tpu/parallel/distributed.py).

JAX runs one controller over every device of a host; the PyTorch idiom is
one process per device, all joined into one `torch.distributed` process
group. `initialize` joins that group, with NCCL for CUDA devices and gloo
for the CPU, and pins a CUDA rank to its own card; `global_mesh` is the
1-D particle mesh over every rank of the job.

Start the ranks with `torchrun --nproc-per-node=<cards> script.py` (the
arguments of `initialize` then come from the environment), or start them
yourself and pass each its address, count and rank.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    timeout: Optional[float] = None,
) -> None:
    """Join the job's process group (one call per rank); a no-op when it is
    already up.

    `coordinator_address` is "host:port" of rank 0 (or a full init URL such
    as "file:///path/to/store"); with the three arguments None they come
    from the environment (`env://`, as `torchrun` sets it). `device` picks
    the backend: NCCL for "cuda", gloo for "cpu". A CUDA rank then runs on
    card LOCAL_RANK (from the environment, else its rank modulo the cards
    of the host). `timeout` bounds, in seconds, how long a collective may
    wait for the other ranks."""
    if dist.is_initialized():
        return
    cuda = torch.device(device).type == "cuda"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        init_method=init_method,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id),
        **kwargs,
    )
    if cuda:
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(
            int(local) if local is not None else dist.get_rank() % torch.cuda.device_count())


def global_mesh(axis_name: str = "particles", device="cuda"):
    """1-D particle mesh over every rank of the job."""
    from .mesh import make_particle_mesh

    return make_particle_mesh(axis_name=axis_name, device=device)


def is_primary() -> bool:
    """True on the rank that writes shared files and logs (rank 0), and in a
    process that joined no group."""
    return not dist.is_initialized() or dist.get_rank() == 0
