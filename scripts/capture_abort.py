"""A conditional body that synchronizes or allocates past PyTorch's sync
check must fail its capture with `CaptureError`, and the process must live
on.

    python3 scripts/capture_abort.py while|if|nested|dynamic [sync|malloc|devsync]

Needs one NVIDIA GPU; run it in a process of its own, as
tests/test_torch_cuda.py and chip_smoke.py do (a failed capture leaves the
captures of that process ended, not its CUDA context broken, but the check
is whether the process survives). The faulting call is one of the CUDA
runtime's, called through ctypes on the runtime PyTorch loaded, which
PyTorch's sync check does not see and which CUDA refuses inside a capture,
invalidating it: `sync` (the default) cudaStreamSynchronize on the current
stream, `malloc` a raw cudaMalloc (freed again where it succeeds, eagerly),
`devsync` cudaDeviceSynchronize. The last two invalidate every capture of
the thread, so inside bodies captured straight into their nodes they would
kill the process: `loops.Loops` captures such a body alone first.

- `while`: a Sampler whose likelihood makes that call runs with
  `run(on_device=True)`: the device run loop's WHILE body (fused.py)
  captures the likelihood in the warm-up branch's IF body and the MCMC
  chain's WHILE body (loops.Loops.repeat), nested in it;
- `if`: a stretch (loops.Loops.once) whose conditional IF body
  (loops.Loops.when) makes that call;
- `nested`: a stretch whose WHILE body holds an IF body holding another,
  the innermost making that call (the bodies that hold nodes are captured
  straight into their nodes, the innermost as a graph of its own);
- `dynamic`: a dynamic-mode Sampler with `run(on_device=True)` whose CV
  bisection body (`steps.reweight._metric_body`, wrapped here) makes that
  call: the "cv_bisect" WHILE body, in the CV step's IF body, in the device
  run loop's WHILE body.

Each prints `CAPTURE_ERROR <first line of the error>`. The same process
then runs a small clustered Sampler, whose cluster fit holds IF nodes and
whose MCMC chain is a WHILE node, with `run(on_device=False)` and then
`run(on_device=True)`, and prints `REPLAY_EQUAL <bool> <its loop stats>`:
the ladder, logZ and steps of the two runs equal bit for bit. Exits 0 when
the capture failed with CaptureError and the runs agree (the graphed one
one replay of the run loop), 1 otherwise.
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
_RT.cudaMalloc.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t]
_RT.cudaFree.argtypes = [ctypes.c_void_p]
FAULTS = ("sync", "malloc", "devsync")
FAULT = "sync"


def call_past_the_check() -> None:
    """The faulting call FAULT, unseen by PyTorch."""
    if FAULT == "sync":
        _RT.cudaStreamSynchronize(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    elif FAULT == "malloc":
        ptr = ctypes.c_void_p()
        if _RT.cudaMalloc(ctypes.byref(ptr), 256) == 0:
            _RT.cudaFree(ptr)
    else:
        _RT.cudaDeviceSynchronize()


def prior(u):
    return 20.0 * u - 10.0


def loglike(x):
    return -0.5 * torch.sum(x * x, dim=-1)


def syncing_loglike(x):
    if x.is_cuda:
        call_past_the_check()
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
            call_past_the_check()
            return {"x": state["x"] + 1.0}

        return loops.when(inputs["p"], body, {"x": inputs["x"]})

    loops.once("probe_if", stretch, {"x": torch.zeros(4, device="cuda"),
                                     "p": torch.ones((), dtype=torch.bool, device="cuda")})
    return ""


def nested_body() -> str:
    loops = Loops("cuda", graphs=True)

    def stretch(inputs):
        def inner(state):
            call_past_the_check()
            return {"x": state["x"] + 2.0}

        def outer(state):
            return loops.when(inputs["p"], inner, {"x": state["x"] + 1.0}, "probe_inner")

        def body(c, k):
            x = loops.when(inputs["p"], outer, {"x": c["x"]}, "probe_outer")["x"]
            return {"n": c["n"] - 1, "x": x}

        return loops.repeat("probe_nested", lambda c: c["n"] > 0, body,
                            {"n": torch.full((), 3, device="cuda"), "x": inputs["x"]}, {})

    loops.once("probe_nested", stretch, {"x": torch.zeros(4, device="cuda"),
                                         "p": torch.ones((), dtype=torch.bool, device="cuda")})
    return ""


def dynamic_body() -> str:
    from tempest_tpu_torch.steps import reweight

    metric_body = reweight._metric_body

    def faulting(*args, **kw):
        body = metric_body(*args, **kw)

        def run(c, k):
            call_past_the_check()
            return body(c, k)

        return run

    reweight._metric_body = faulting
    try:
        s = Sampler(prior, loglike, n_dim=2, n_particles=128, vectorize=True,
                    clustering=False, volume_variation=0.05, random_state=1,
                    history_capacity=32, device="cuda")
        s.run(n_total=256, progress=False, on_device=True)
    finally:
        reweight._metric_body = metric_body
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
    global FAULT
    if (len(sys.argv) not in (2, 3) or sys.argv[1] not in ("while", "if", "nested", "dynamic")
            or sys.argv[2:] and sys.argv[2] not in FAULTS):
        sys.exit(__doc__.splitlines()[4].strip())
    FAULT = sys.argv[2] if len(sys.argv) == 3 else "sync"
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    failed = False
    try:
        {"while": while_body, "if": if_body, "nested": nested_body,
         "dynamic": dynamic_body}[sys.argv[1]]()
        print("NO_ERROR", flush=True)
    except CaptureError as exc:
        failed = True
        print("CAPTURE_ERROR", " ".join(str(exc).split("\n")[:1]), "|",
              "on_device=False" if "on_device=False" in str(exc) else "", flush=True)
    (eager, _), (graphed, stats) = clean_runs()
    torch.cuda.synchronize()
    same = eager == graphed
    print("REPLAY_EQUAL", same, {k: dict(v) for k, v in stats.items()
                                 if k in ("run", "mcmc", "hgm_fit")}, flush=True)
    return 0 if failed and same and stats["run"]["replays"] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
