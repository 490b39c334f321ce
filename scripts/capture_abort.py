"""A conditional body that synchronizes past PyTorch's sync check must fail
its capture with `CaptureError`, and the process must live on.

    python3 scripts/capture_abort.py while|if

Needs one NVIDIA GPU; run it in a process of its own, as
tests/test_torch_cuda.py and chip_smoke.py do (a failed capture leaves the
captures of that process ended, not its CUDA context broken, but the check
is whether the process survives). The synchronizing call is the CUDA
runtime's cudaStreamSynchronize on the current stream, called through
ctypes on the runtime PyTorch loaded: PyTorch's sync check does not see it,
and inside a capture CUDA refuses it and invalidates the capture.

- `while`: a Sampler whose likelihood makes that call runs with
  `run(on_device=True)`: the MCMC chain's WHILE body (loops.Loops.repeat)
  captures the likelihood;
- `if`: a stretch (loops.Loops.once) whose conditional IF body
  (loops.Loops.when) makes that call.

Each prints `CAPTURE_ERROR <first line of the error>`. The same process
then runs a small clustered Sampler, whose cluster fit holds IF nodes and
whose MCMC chain is a WHILE node, with `run(on_device=False)` and then
`run(on_device=True)`, and prints `REPLAY_EQUAL <bool> <its loop stats>`:
the ladder, logZ and steps of the two runs equal bit for bit. Exits 0 when
the capture failed with CaptureError and the runs agree, 1 otherwise.
"""

from __future__ import annotations

import ctypes
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from tempest_tpu_torch import Sampler  # noqa: E402
from tempest_tpu_torch.loops import CaptureError, Loops  # noqa: E402


def _cudart() -> ctypes.CDLL:
    """The CUDA runtime this process loaded with PyTorch."""
    with open("/proc/self/maps") as maps:
        for line in maps:
            if "libcudart.so" in line:
                return ctypes.CDLL(line.split()[-1])
    return ctypes.CDLL("libcudart.so.12")


_RT = _cudart()
_RT.cudaStreamSynchronize.argtypes = [ctypes.c_void_p]


def sync_past_the_check() -> None:
    """cudaStreamSynchronize on the current stream, unseen by PyTorch."""
    _RT.cudaStreamSynchronize(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))


def prior(u):
    return 20.0 * u - 10.0


def loglike(x):
    return -0.5 * torch.sum(x * x, dim=-1)


def syncing_loglike(x):
    if x.is_cuda:
        sync_past_the_check()
    return loglike(x)


def while_body() -> str:
    s = Sampler(prior, syncing_loglike, n_dim=2, n_particles=128, vectorize=True,
                clustering=False, random_state=1, history_capacity=32, device="cuda")
    s.run(n_total=256, progress=False, on_device=True)
    return ""


def if_body() -> str:
    loops = Loops("cuda", graphs=True)

    def stretch(inputs):
        def body(state):
            sync_past_the_check()
            return {"x": state["x"] + 1.0}

        return loops.when(inputs["p"], body, {"x": inputs["x"]})

    loops.once("probe_if", stretch, {"x": torch.zeros(4, device="cuda"),
                                     "p": torch.ones((), dtype=torch.bool, device="cuda")})
    return ""


def clean_runs():
    out = []
    for on_device in (False, True):
        s = Sampler(prior, loglike, n_dim=2, n_particles=128, vectorize=True, clustering=True,
                    k_max=4, random_state=3, history_capacity=32, device="cuda")
        s.run(n_total=256, progress=False, on_device=on_device)
        r = s.results()
        out.append(([r[k].tobytes() for k in ("beta", "logz", "steps")],
                    dict(s.state._iteration.loops.stats)))
    return out


def main() -> int:
    if len(sys.argv) != 2 or sys.argv[1] not in ("while", "if"):
        sys.exit(__doc__.splitlines()[2].strip())
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    failed = False
    try:
        (while_body if sys.argv[1] == "while" else if_body)()
        print("NO_ERROR", flush=True)
    except CaptureError as exc:
        failed = True
        print("CAPTURE_ERROR", " ".join(str(exc).split("\n")[:1]), "|",
              "on_device=False" if "on_device=False" in str(exc) else "", flush=True)
    (eager, _), (graphed, stats) = clean_runs()
    torch.cuda.synchronize()
    same = eager == graphed
    print("REPLAY_EQUAL", same, {k: dict(v) for k, v in stats.items()
                                 if k in ("mcmc", "hgm_fit")}, flush=True)
    return 0 if failed and same and stats["mcmc"]["replays"] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
