"""Smoke test of tempest_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR] [--parent DIR]
    python3 chip_smoke.py --kernels-only [--package-root DIR]
    python3 chip_smoke.py --a-only [--package-root DIR]

Builds every CUDA kernel of the port from the sources in this checkout
(one nvcc per source, started together), holds each against its plain
PyTorch version on the card, then drives the port through
`Sampler(...).run(...)` / `.sample()`. Phases, in order; each prints its
lines and a failure exits non-zero:

 1. the card: `nvidia-smi` name and power limit;
 2. build every kernel (the ESS bisection and its bracket mode, the PRNG
    kernels, the eigenvalue kernel, the weighted median and the two EM
    kernels); each
    library's ptxas report (`-Xptxas -v`):
    every kernel's registers and spill bytes, and a spill in any kernel
    fails;
 3. the ESS-bisection kernel against its plain version on both routes of
    its launch plan (slices in shared memory: S = 65,536, a ragged S and the
    last S held on chip, 393,216; slices streamed from L2: 393,217 and
    B's 1,048,576), two launches giving the same bits, and its times; at
    S = 65,536 and 393,216 both routes through the C entry, giving the same
    bits, their device times in turns (one pass and a bisection); then its
    float64 instantiation at S = 65,536, a ragged S, 196,608 (the last held
    on chip), 196,609 (the first streamed) and 1,048,576: beta within 1e-12
    (relative) of the plain version's with the same probes, stay and jump
    exact, two launches giving the same bits, and its times in turns with
    the float32 instantiation on the same histories; the bounds count the
    instructions of exp from the SASS of a probe compiled in phase 2;
 3b. the ESS kernel's bracket mode (dynamic mode's ESS bracket) against
    its plain version, the "ess_bracket" loop on the same CUDA tensors, at
    S = 196,608 (dynamic mode's, held on chip: its 1024 x 192 history with
    48 rows filled and the rest masked, and a history all filled), 524,288
    and 1,048,576 (streamed), float32 and float64, on stay, jump and three
    bisections each: the same probes, stay and jump exact, in float64 each
    end within 1e-12 (relative), in float32 the same ends or else the
    plain ESS at the first midpoint decided the other way within 1e-5 of
    the target, the ends within 2e-3; two launches the same bits; its
    times on the 1024 x 192 history;
 4. the four PRNG kernels against their plain versions on one key and call
    index (mutation draws at (8, 1024, 10), a ragged (8, 1000, 10) and the
    largest fused shape (8, 6553, 10); normal and bits at 2^20 and at B's
    shapes, the bits through the public `hw_uniform`, whose launches the
    bits row gives as `hw_uniform_launches`; the gamma draws at n = 1, 3,
    5, 1000, 131,072, 131,075 and 262,144 for alpha 0.02, 0.5, 0.7, 1.5,
    7.5, 50 and all six in turn, one gamma launch and no other a call, on
    call indices that cross 2^32; flips and draws not equal bit for bit),
    their moments, their device and host-timed call times beside their
    plain versions' and the PyTorch generator's (the gamma kernel's bound
    counts the Marsaglia-Tsang rounds these draws need), the launch floor,
    and one synchronized call of each kernel split into wrapper, launch,
    device and sync time, through the public functions and, for the three
    kernels a draws object launches, through its call counter's words
    (`cuda_prng.PhiloxCounter`);
 4b. the eigenvalue kernel (csrc/sym_eigvals.cu, which replaces XLA's
    eigvalsh of the CV, not a Pallas kernel) against torch.linalg.eigvalsh
    of the float64 copy on SPD, indefinite, rank-deficient and diagonal
    matrices at d = 1, 3, 10, 100 and 240 (past shared memory) in float32
    and float64, within 16 d eps max|lambda|, two launches the same bits;
    its call and device times at d = 10, 50 and 100 (one matrix) beside
    torch.linalg.eigvalsh's, and its bound (4/3 d^3 flops and the matrix
    read once) over the card and over one SM;
 4c. the weighted-median kernel (csrc/weighted_median.cu, which replaces
    torch.cumsum, argmax and gather, not a Pallas kernel): first that
    torch.cumsum along the points adds serially in float32 on this card
    (against numpy); then the kernel against its plain version bit for bit
    at A's (16, 4096, 10), B's (1, 524,288, 10) and rosenbrock100's
    (1, 8192, 100) (K, n, d) and ragged shapes with all-zero rows, in
    float32 and float64; its call and device times at the three shapes in
    turns with the plain version and the library call (torch.cumsum and
    argmax of the gathered weights), beside its chain bound (the longest
    column's adds at 4 cycles) and its byte bound;
 4d. the EM kernels (csrc/gmm_em.cu and csrc/mvstud_em.cu, which replace
    the port's "gmm_em" and "mode_em" device loops where JAX runs XLA's
    while_loops, not Pallas kernels): each against its plain loop on the
    same CUDA tensors, by the rules of tests/test_torch_cuda.py (float64:
    the same iteration counts and every parameter within 1e-9; float32:
    the counts of the plain loop's float32 or float64 fit and parameters
    within 4x the plain float32 fit's distance from the float64 one plus
    1e-5, except fits whose plain loop took a decision within 1e-4 of its
    scale), two launches the same bits, one launch a loop: the
    GMM EM at A's leaf fits (16, 2048, 10, K = 2), every covariance type,
    K = 1 and 16; the Student-t EM at A's (16, 4096, 10), the unclustered
    (1, 4096, 10), B's (1, 524,288, 10) and rosenbrock100's (1, 8192, 100)
    (K, n, d); then on the fit inputs of A's own iteration 21 (seed 42);
    a cluster reduction's latency by cluster size from a probe compiled
    here; each kernel's call and device times in float32 in turns with its
    plain loop (chunks of 4, as the fused route runs it), beside its bound
    (bytes at 3.35 TB/s, instructions at the issue rate) and its reduction
    chain (the longest fit's iterations times its cluster reductions an
    iteration times the probe's latency);
 5. the canonical problem unclustered (paired 10-D Rosenbrock, U(-10, 10)
    prior, n_particles=1024, n_total=8192, history_capacity=64), seed 42,
    with `run(on_device=True)`: its loops replayed as CUDA graphs;
 6. A: the canonical problem at the reference defaults, clustered
    (k_max=16), hardware_prng=False, seed 42 after a warm-up, with
    `run(on_device=False)`: the fused iteration without graphs (seeds 43
    and 44 are left out, to keep the whole script near half its time
    limit); one mvstud_em launch a mode fit, one gmm_em launch a GMM EM
    loop and no "mode_em" or "gmm_em" chunk read (every path holds this);
 6b. A fused: A's seed 42 with `run(on_device=True)`, which captures the
    graphs, then seed 42 again on them: the beta ladder, logZ, steps and
    calls of each equal bit for bit to phase 6's run, logZ in the clustered band, the ESS
    kernel's launches equal to phase 6's; the wall per iteration of both,
    and the graph captures and replays per loop; then iterations 21-23 of
    seed 42 in each mode under torch.profiler: the device idle share and
    the blocking host reads per iteration, counted from the CUDA runtime
    calls that block the host (cudaStreamSynchronize, cudaEventSynchronize,
    cudaDeviceSynchronize, a synchronous cudaMemcpy), at most one a loop
    chunk plus two an iteration (beta and the termination test), fewer
    than 150, no torch.linalg.eigvalsh operator (the CV's eigenvalues
    are the kernel's) and no EM chunk read; then iterations 24-26 traced on
    the device only (no host ops recorded): wall and idle share;
 7. A again with hardware_prng=True, seed 42, with run(on_device=False) and
    then run(on_device=True) on a sampler whose seed-43 run captured the
    graphs: every MCMC step body draws through the mutation-draws kernel
    (by graph replays with on_device=True); the ladder, logZ, steps,
    calls, launches and the draws' final state (call counter, host mirror
    and device words) equal bit for bit; the wall per iteration of both;
    then iterations 21-23 in each mode under torch.profiler, held to 6b's
    rule on blocking host reads;
 8. B: the large-ensemble hardware_prng configuration of
    benchmarks/results/hw_prng_e2e.json (10-D Gaussian, n_particles=131072,
    history_capacity=8, unclustered) through its first four mutation
    iterations, eagerly and with the loops' CUDA graphs (one pass captures
    them, a second is timed): the same values, launches and call counter
    in each iteration bit for bit, one normal and one gamma launch per
    MCMC step body (by replays when graphed), no bits launch, and seconds
    per mutation iteration of each; then the normal kernel at its R*N*d
    and the ESS kernel at the S reached, each against its plain version;
 9. C: the 10-D bimodal mixture of tests/test_multimodal.py, clustered;
10. the 10-D Gaussian of tests/test_end_to_end.py;
11. the reference surface on A's problem, seed 42: the reference's default
    call form (per-point torch functions, `vectorize` left False) with a
    likelihood returning (logl, |x|^2, x0), so blobs are detected;
    `run(save_every=10)` into a temporary directory, the blobs of
    `posterior(return_blobs=True)` against the function evaluated again,
    `evidence(n_bootstrap=256)`; a new sampler resumed from the
    iteration-20 file, and a pickle taken one iteration after the last
    numbered file, each run to the end; the draw state through a
    checkpoint, with hardware_prng off and on: the two iterations after
    iteration 20, from the sampler that ran on and from one that loaded
    the iteration-20 file, must agree;
12. dynamic (CV) mode: benchmarks/suite.py's `rosenbrock10_cv` (chained
    10-D Rosenbrock, n_particles=1024, n_total=8192, history_capacity=192,
    unclustered, volume_variation=1.0), seed 42, on the fused route with
    run(on_device=False) and with run(on_device=True) on a sampler whose
    seed-43 run captured the graphs of its CV bisection and MCMC steps:
    bit for bit, logZ inside the anchor taken from the JAX package, one
    launch of the ESS kernel's bracket mode a reweight (no "ess_bracket"
    loop body on the card), no ESS-mode launch; walls, probes and loop
    reads per reweight; then iterations 21-23 in each mode under the
    profiler, held to 6b's rule;
13. the refit cadence, C with cluster_every=3, and a host likelihood: the
    10-D Gaussian as a numpy per-point function with host_likelihood=True;
14. float64: A at dtype=torch.float64 with hardware_prng=True, seed 42, with
    `run(on_device=True)`, its MCMC chunks replayed as graphs (one
    float64 ESS launch per reweight and no PRNG launch: the flag does not
    apply to float64, as in JAX), its wall beside phases 6 and 6b's seed 42; B at
    float64 through its first four mutation iterations (no launch of any of
    the four PRNG kernels), and the float64 ESS kernel at its S = 1,048,576
    against the plain version; the 4-D Gaussian
    of tests/test_float64.py with its bars; the mixture facades on the card
    (GaussianMixture of each covariance type on two blobs,
    HierarchicalGaussianMixture splitting them, predict_proba summing to 1);
15. the particle mesh at world size 1 over NCCL (`parallel.distributed.
    initialize` on a free local port): `sharded_resample` on A's history
    shape against the unsharded resampler ("mult" and "syst", the same
    rows), `sharded_select_fit_points` against the unsharded selection on
    the whole history (the same rows and keep mask) and its candidate
    branch at m = 4096 (the heaviest samples, renormalized); A with
    `mesh=make_particle_mesh()` and `save_every=10`, seed 42 (checkpoints
    keep on_device=False): logZ in the band, beta = 1, one eigenvalue
    launch a reweight and no ESS-kernel launch, since a mesh bisects by
    reductions as JAX bypasses its kernel under one; its wall beside phase
    6's seed 42; a mesh sampler resumed from the iteration-20 file runs the
    two iterations after it as the run that went on did; `posterior()` and
    `evidence(n_bootstrap=256)` through the gathers; A under the mesh with
    run(on_device=True) on a sampler whose seed-43 run captured the graphs
    (the sharded ESS bisection and the MCMC steps with their NCCL
    collectives inside): bit for bit with the save_every run, and its
    steady windows in each mode held to 6b's rule; then A under the mesh
    with hardware_prng=True, on_device=False and True: bit for bit, one
    mutation-draws launch a step body, the call counter's device words
    equal to its host mirror. The process group is destroyed at the end
    of the phase, whatever happens in it, after its mesh and samplers;
16. rosenbrock100: benchmarks/suite.py's 100-D configuration (chained
    Rosenbrock, U(-10, 10), n_particles=2048, n_total=4096,
    history_capacity=256, unclustered) at full width, seed 42, with
    run(on_device=True) on a sampler whose seed-43 run captured the
    graphs: beta 1, posterior ESS >= 4096, logZ inside the anchor of
    scripts/rosenbrock100_anchor.py (the JAX package on the CPU, seeds
    42-46), one eigenvalue launch (d = 100) and one ESS launch a reweight,
    each ESS launch on the streamed route at S = 524,288; the first 30
    iterations equal bit for bit to a fresh seed-42 sampler's sample()
    calls; wall, ms and MCMC steps an iteration; iterations 21-23 graphed
    under the profiler, held to 6b's rule, with the device busy share and
    the device ms an iteration of the eigenvalue kernel, the ESS kernel
    and the top five other kernels.

Every path phase sets the kernels' launch counts to 0 just before it
drives the path and reads them just after. Each run of A (phases 5, 6,
6b's reference, 14) and each B iteration launches the weighted-median
kernel once a mode fit (fits counted by wrapping modes.py's). A kernel's `launches` in the
table is its count on one path (`launches_on`), and must be above 0; the
bits kernel is on no Sampler path (its one caller there, hw_gamma, is the
gamma kernel now), so its `launches` is B's 0, every path must count 0 for
it, and its row says why (`off_path`). The last three lines are the
total wall, the kernel table and {"ok": true, "device": {...}}.

Without a GPU, or without the rest of the repository beside it, the
script exits non-zero before printing any result. `--profile DIR` also
profiles five mid-ladder iterations (21-25) of the clustered canonical
problem, of phase 11's per-point configuration and of phase 12's dynamic
mode under torch.profiler, prints each stage's share and writes the tables
(by stage range and by kernel) to DIR. `--kernels-only` runs phases 1-4
and prints their table without driving the paths; with `--package-root
DIR` it imports `tempest_tpu_torch` from DIR (for instance a `git archive`
of another commit whose ESS kernel has its float64 entry), so two versions
of the kernels can be timed on one card in turns, each in its own process.
`--a-only [--package-root DIR]` runs phases 1-2 and A's seed 42
(on_device=False) and prints its logZ, iterations, steps and ladder
digest; `--parent DIR` makes the full run start that in a process of its
own on DIR's package after phase 6 and print it beside phase 6's seed 42
(not held equal: the EM kernels sum in another order than a parent's
plain loops, which moves the ladder by rounding).
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import pickle
import re
import socket
import subprocess
import sys
import tempfile
import time



def _package_root() -> str:
    """The directory to import tempest_tpu_torch from: --package-root, else
    this script's own."""
    argv = sys.argv[1:]
    for i, arg in enumerate(argv):
        if arg == "--package-root" and i + 1 < len(argv):
            return os.path.abspath(argv[i + 1])
        if arg.startswith("--package-root="):
            return os.path.abspath(arg.split("=", 1)[1])
    return os.path.dirname(os.path.abspath(__file__))


sys.path.insert(0, _package_root())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tempest_tpu_torch import Sampler  # noqa: E402
from tempest_tpu_torch.cluster import (  # noqa: E402
    GaussianMixture,
    HierarchicalGaussianMixture,
)
from tempest_tpu_torch.config import (  # noqa: E402
    ESS_TOLERANCE,
    METRIC_ATOL,
    N_PROPOSAL_CANDIDATES,
)
from tempest_tpu_torch.iteration import select_fit_points  # noqa: E402
from tempest_tpu_torch.ops import _build, cuda_prng, cuda_reweight, philox  # noqa: E402

try:  # the eigenvalue kernel; absent from a package older than it (--package-root)
    from tempest_tpu_torch.ops import cuda_linalg  # noqa: E402
except ImportError:
    cuda_linalg = None
try:  # the weighted-median kernel and the ESS bracket mode; likewise
    from tempest_tpu_torch.ops import cuda_median  # noqa: E402
except ImportError:
    cuda_median = None
try:  # the EM kernels; likewise
    from tempest_tpu_torch.ops import cuda_em  # noqa: E402
except ImportError:
    cuda_em = None
from tempest_tpu_torch import cluster as cluster_module  # noqa: E402
from tempest_tpu_torch import student as student_module  # noqa: E402
from tempest_tpu_torch.loops import Loops  # noqa: E402
from tempest_tpu_torch import modes as modes_module  # noqa: E402
from tempest_tpu_torch.ops.tools import ess_from_logw  # noqa: E402
from tempest_tpu_torch.parallel import make_particle_mesh  # noqa: E402
from tempest_tpu_torch.parallel.collective import (  # noqa: E402
    positions,
    sharded_resample,
    sharded_select_fit_points,
)
from tempest_tpu_torch.parallel.distributed import initialize  # noqa: E402
from tempest_tpu_torch.parallel.mesh import particle_group  # noqa: E402
from tempest_tpu_torch.steps.resample import resample as resample_step  # noqa: E402
from tempest_tpu_torch.steps import reweight as reweight_step  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from tempest_tpu_torch.state import (  # noqa: E402
    commit,
    logw_from_denominator,
    make_current,
    make_history,
    mis_denominator,
    mis_denominator_exact,
)

N_DIM, N_PARTICLES, N_TOTAL, CAPACITY = 10, 1024, 8192, 64
SEEDS = (42, 43, 44)
# tempest_tpu on the same problem with clustering=False: -35.53 +/- 0.12 over
# 5 seeds (benchmarks/results/flagship_tpu.json, secondary_unimodal).
UNCLUSTERED_LOGZ = (-35.53, 0.75)
# The reference's clustered 5-seed mean, +/- 3x its std of 0.334
# (benchmarks/results/reference_cpu.json); it holds JAX's clustered -35.11
# (benchmarks/results/flagship_tpu.json).
CLUSTERED_LOGZ = (-34.98, 1.0)
# Dynamic mode, rosenbrock10_cv: tempest_tpu on the CPU, seeds 42-44, logZ
# -51.0069 / -51.5353 / -51.4085, mean -51.3169 +/- max(3 sigma, 1.0) with
# sigma 0.2759 (scripts/rosenbrock10_cv_anchor.py; PERF.md section 2).
CV_LOGZ = (-51.3169, 1.0)
# rosenbrock100 (benchmarks/suite.py:183-196): the chained 100-D Rosenbrock,
# N = 2048, n_total = 4096, history_capacity = 256, unclustered. Its band:
# tempest_tpu on the CPU, seeds 42-46, logZ -559.5646 / -558.8826 / -559.3115 /
# -559.2223 / -558.2244, mean -559.0411 +/- max(3 sigma, 1.0) with sigma
# 0.5177 (scripts/rosenbrock100_anchor.py; PERF.md section 2).
R100_DIM, R100_PARTICLES, R100_TOTAL, R100_CAPACITY = 100, 2048, 4096, 256
R100_LOGZ = (-559.0411, 1.5532)
R100_EAGER = 30  # iterations compared with sample(): a whole eager run costs the time limit
GAUSSIAN_LOGZ = (-N_DIM * math.log(20.0), 0.5)  # analytic; tests/test_end_to_end.py
# tests/test_float64.py: the 4-D Gaussian, logZ within 0.35 of -4 log 20 and
# the MIS accumulator within 1e-9 of its exact rebuild.
GAUSSIAN4_LOGZ, MIS_F64_TOL = (-4 * math.log(20.0), 0.35), 1e-9
BETA_F64_RTOL = 1e-12  # the float64 kernel against its plain version
BETA_TOL = 2e-3  # the Pallas-vs-XLA drift from summation order (tests/test_pallas.py)
# A bisection's beta matches the plain version's when both took the same
# probes and end this close (relative), or when the kernel's beta meets the
# stop rule on the plain ESS; and always within BETA_TOL.
BETA_MATCH_RTOL = 1e-6
TIMED_CALLS = 50
DRAW_TOL = 1e-5  # normals and uniforms, absolute; gamma draws, relative
MAX_FLIP_SHARE = 1e-4  # gamma draws whose accept test may fall the other way
# B: benchmarks/results/hw_prng_e2e.json
B_PARTICLES, B_CAPACITY, B_MUTATIONS = 131072, 8, 4
# One H100 SXM at 700 W (NVIDIA's data sheet): HBM at 3.35 TB/s, 132 SMs at
# a 1.98 GHz boost clock. An SM issues at most 128 thread-instructions a
# clock (4 schedulers x 32 lanes; with an FMA as two flops, the data sheet's
# 67 TFLOP/s float32), of which at most 64 can be 32-bit integer ones.
HBM_BYTES_PER_S = 3.35e12
N_SMS = 132
SM_CLOCKS_PER_S = N_SMS * 1.98e9
ISSUE_PER_SM_CLOCK, INT32_PER_SM_CLOCK = 128, 64
# FP64 outside the tensor cores: 34 TFLOP/s (the data sheet), 64 lanes an SM
# and clock, half the float32 rate.
FP64_PER_SM_CLOCK = 64
# Instruction counts for the bounds, as (32-bit integer, float32), estimated
# low. A Philox4x32-10 block: 10 rounds of 2 wide 32x32 products and 2
# three-input xors, 2 key additions in 9 of them. A word to (0, 1]: a shift
# and an or, then one subtraction. CUDA's precise float32 functions as
# sequences of about this many instructions:
PHILOX_INT, UNIT = 58, (2, 1)
LOGF, SQRTF, SINCOSF, COSF, POWF, DIVF = 18, 7, 28, 20, 40, 8
# 4 normals from one block: 4 unit maps, 2 x (log, sqrt, sincos, 4 products).
NORMAL_BLOCK = (PHILOX_INT + 4 * UNIT[0], 4 * UNIT[1] + 2 * (LOGF + SQRTF + SINCOSF + 4))
# One Marsaglia-Tsang round: its block, 3 unit maps, a cos-only normal, the
# cube, two logs and about 14 products, sums, compares and selects.
MT_ROUND = (PHILOX_INT + 3 * UNIT[0], 3 * UNIT[1] + 3 * LOGF + SQRTF + COSF + 17)
# Per walker besides its rounds: the boost/accept block and 2 unit maps, the
# set-up (sqrt, a division), the boost (a division, a power) and 6 more ops.
WALKER_EXTRA = (PHILOX_INT + 2 * UNIT[0], 2 * UNIT[1] + SQRTF + 2 * DIVF + POWF + 6)
# The gamma kernel (hw_gamma), counted on the rounds the draws need: a Philox
# block; a Box-Muller pair (2 unit maps, log, sqrt, sincos, 4 products); a
# walker's test in one round (its uniform's map, two logs, the cube and about
# 12 sums, products, compares and selects); a walker's set-up (a sqrt, a
# division, 4 ops); the boost of alpha < 1 (a map, a division, a power).
GAMMA_PAIR = (2 * UNIT[0], 2 * UNIT[1] + LOGF + SQRTF + SINCOSF + 4)
GAMMA_TEST = (UNIT[0], UNIT[1] + 2 * LOGF + 14)
GAMMA_SETUP = (0, SQRTF + DIVF + 4)
GAMMA_BOOST = (UNIT[0], UNIT[1] + DIVF + POWF + 2)
# The ESS kernel, per sample and probe: the finite tests, beta * logl - Bm,
# one exp, the running max and the two sums; the loop's index. The exp's own
# instructions are counted from the SASS of a probe built in phase 2
# (`sass_exp_counts`) for float32 and float64; ESS_SAMPLE_PROBE then holds
# (32-bit integer, float32, float64) instructions for each.
ESS_SAMPLE_OTHER = (2, 6)
ESS_SAMPLE_PROBE = {}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def prior_transform(u):
    return 20.0 * u - 10.0


def rosenbrock(x):
    # Paired Rosenbrock, as bench.py:71-77.
    return -torch.sum(
        100.0 * (x[..., 1::2] - x[..., ::2] ** 2) ** 2 + (1.0 - x[..., ::2]) ** 2, dim=-1
    )


def gaussian(x):
    return -0.5 * torch.sum(x * x, dim=-1) - 0.5 * N_DIM * math.log(2 * math.pi)


def rosenbrock_blobs(x):
    # Per point: the log-likelihood and two blobs, |x|^2 and x0.
    return rosenbrock(x), torch.sum(x * x), x[0]


def rosenbrock_chained(x):
    # benchmarks/suite.py:37-41
    return -torch.sum(
        100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2 + (1.0 - x[..., :-1]) ** 2, dim=-1
    )


def gaussian_numpy(x):
    # A host likelihood of one numpy point.
    return float(-0.5 * np.sum(x * x) - 0.5 * N_DIM * math.log(2 * math.pi))


def half_square(x):
    # hw_prng_e2e.json's likelihood: -0.5 |x|^2
    return -0.5 * torch.sum(x * x, dim=-1)


SEP, SIGMA = 3.0, 0.5  # tests/test_multimodal.py


def bimodal(x):
    norm = -0.5 * N_DIM * math.log(2 * math.pi * SIGMA**2)
    a = norm - 0.5 * torch.sum((x - SEP) ** 2, dim=-1) / SIGMA**2
    b = norm - 0.5 * torch.sum((x + SEP) ** 2, dim=-1) / SIGMA**2
    return torch.logaddexp(a, b) - math.log(2.0)


# ---------------------------------------------------------------------------
# Launch counts and timing
# ---------------------------------------------------------------------------
def reset_counts() -> None:
    cuda_reweight.LAUNCHES = 0
    cuda_reweight.LAUNCHES_F64 = 0
    if cuda_linalg is not None:
        cuda_linalg.LAUNCHES = 0
    if cuda_median is not None:
        cuda_median.LAUNCHES = 0
        cuda_reweight.BRACKET_LAUNCHES = 0
    for name in cuda_prng.LAUNCHES:
        cuda_prng.LAUNCHES[name] = 0
    for name in (cuda_em.LAUNCHES if cuda_em is not None else ()):
        cuda_em.LAUNCHES[name] = 0


def counts() -> dict:
    eig = {} if cuda_linalg is None else {"sym_eigvals": cuda_linalg.LAUNCHES}
    median = {} if cuda_median is None else {"weighted_median": cuda_median.LAUNCHES,
                                             "ess_bracket": cuda_reweight.BRACKET_LAUNCHES}
    em = {} if cuda_em is None else dict(cuda_em.LAUNCHES)
    return {"ess_bisect": cuda_reweight.LAUNCHES, "ess_bisect_f64": cuda_reweight.LAUNCHES_F64,
            **eig, **median, **em, **cuda_prng.LAUNCHES}


# Weighted Student-t fits (`student.fit_mvstud_weighted_modes`, each of K
# weightings at once) run by the Sampler paths in this process: each starts
# from one weighted-median launch and, on the card, runs its EM loop as one
# mvstud_em launch. GMM EM loops (`cluster._gmm_em`, a batch of leaf fits):
# one gmm_em launch each on the card.
MODE_FITS = 0
GMM_FITS = 0


def _count_mode_fits() -> None:
    """Wrap the mode fit the Sampler paths call (modes.py) with MODE_FITS and
    the GMM EM loop of the split rounds (cluster.py) with GMM_FITS."""
    fit, gmm_em = modes_module.fit_mvstud_weighted_modes, cluster_module._gmm_em

    def counted(*args, **kwargs):
        global MODE_FITS
        MODE_FITS += 1
        return fit(*args, **kwargs)

    def counted_gmm(*args, **kwargs):
        global GMM_FITS
        GMM_FITS += 1
        return gmm_em(*args, **kwargs)

    modes_module.fit_mvstud_weighted_modes = counted
    cluster_module._gmm_em = counted_gmm


def check_em_launches(what: str, launched: dict, mode_fits: int, gmm_fits: int,
                      loops: dict) -> None:
    """On the card every EM loop is one kernel launch and reads nothing: one
    mvstud_em launch a mode fit, one gmm_em launch a GMM EM loop, and no
    "mode_em" or "gmm_em" chunk read."""
    if cuda_em is None:
        return
    check(launched["mvstud_em"] == mode_fits and launched["gmm_em"] == gmm_fits,
          f"{what}: {launched['mvstud_em']} mvstud_em launches for {mode_fits} mode fits, "
          f"{launched['gmm_em']} gmm_em launches for {gmm_fits} GMM EM loops")
    reads = {k: loops.get(k, {}).get("reads", 0) for k in ("mode_em", "gmm_em")}
    check(not any(reads.values()), f"{what}: EM chunk reads on the card {reads}")




def diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def time_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def timed_in_turns(fns: dict, calls: int = TIMED_CALLS) -> dict:
    """Median of `calls` synchronized calls of each function, in turns.
    The phases time a plain version (hundreds of launches and host syncs
    a call) apart: the call timed just after it comes out slower."""
    for fn in fns.values():
        fn()  # warm-up
    times = {k: [] for k in fns}
    for _ in range(calls):
        for k, fn in fns.items():
            times[k].append(time_ms(fn))
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def _self_device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


# Each profile opens with PROFILE_WARMUP_LAUNCHES tiny device sleeps and
# one of PROFILE_WARMUP_CYCLES (about 50 ms of an H100 SM's clock).
PROFILE_WARMUP_LAUNCHES, PROFILE_WARMUP_CYCLES = 256, 100_000_000


def device_ms(fn, kernel=None, calls: int = 20) -> float:
    """Device time per call of fn, from torch.profiler's device records (no
    host overhead): the kernels whose name contains `kernel`, each call
    launching one at least, or every device record of the calls when
    `kernel` is None (a library call). Once the process has run a while, a
    profile loses its first device records, the more the longer the process
    has run (up to every launch of a short window), so each profile opens
    with PROFILE_WARMUP_LAUNCHES tiny device sleeps and a long one, and
    counts only the records of the calls after them. After three profiles that keep fewer launches than calls:
    NaN, and the CUDA events' time, host gaps included, printed beside it
    with the warm-up records the profiles lost."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    lost = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_WARMUP_LAUNCHES):
                torch.cuda._sleep(100)
            torch.cuda._sleep(PROFILE_WARMUP_CYCLES)
            torch.cuda.synchronize()
            with record_function("device_ms calls"):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        start = min(e.time_range.start for e in events if e.name == "device_ms calls")
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        # The sleeps ran before `start`; the calls' records follow it.
        rows = [e for e in device if e.time_range.start >= start - 1000.0
                and (kernel is None or kernel in e.name)]
        lost.append(PROFILE_WARMUP_LAUNCHES + 1 - sum(e.time_range.start < start - 1000.0
                                                      for e in device))
        us = sum(e.time_range.elapsed_us() for e in rows)
        if us > 0.0 and (kernel is None or len(rows) >= calls):
            return us / 1e3 / calls
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    torch.cuda.synchronize()
    print(f"device_ms: 3 profiles recorded {kernel or 'the library call'} incompletely (warm-up "
          f"records lost {lost} of {PROFILE_WARMUP_LAUNCHES + 1}): no device time; CUDA events "
          f"over {calls} calls, host gaps included: {a.elapsed_time(b) / calls:.4f} ms a call",
          flush=True)
    return float("nan")


def json_line(obj) -> str:
    """json.dumps with NaN (a time not measured) written as null."""
    def clean(x):
        if isinstance(x, float) and math.isnan(x):
            return None
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [clean(v) for v in x]
        return x
    return json.dumps(clean(obj))


class _TimedFn:
    """A C entry point that adds up the host time spent inside its calls."""

    def __init__(self, fn):
        self.fn, self.seconds, self.calls = fn, 0.0, 0

    def __call__(self, *args):
        t0 = time.perf_counter()
        err = self.fn(*args)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return err


def call_split(name: str, fn, library, entry: str, kernel: str, rounds: int = 5,
               calls: int = 200) -> dict:
    """One synchronized call of fn split into wrapper, launch, device and
    sync time (ms), each timed in its own loop, the loops in turns:
    synchronized calls (median); `calls` calls with no sync between them,
    with the C entry point timed inside (host time per call = wrapper +
    launch); torch.cuda.synchronize() with nothing in flight; the device
    time from the profiler. sync = synchronized call - (wrapper + launch)."""
    handle = _build.load(library)
    inner = _TimedFn(getattr(handle, entry))
    setattr(handle, entry, inner)
    for mod in (cuda_prng, cuda_reweight):  # entry points cached by a wrapper
        getattr(mod, "_functions", {}).clear()
    try:
        sync_call, enqueue, launch, idle = [], [], [], []
        fn()
        torch.cuda.synchronize()
        for _ in range(rounds):
            sync_call.append(timed_in_turns({"c": fn}, calls=21)["c"])
            inner.seconds, inner.calls = 0.0, 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            enqueue.append(1e3 * (time.perf_counter() - t0) / calls)
            check(inner.calls == calls, f"{name}: {inner.calls} entry calls for {calls} calls")
            launch.append(1e3 * inner.seconds / calls)
            torch.cuda.synchronize()
            idle.append(timed_in_turns({"s": lambda: None}, calls=21)["s"])
    finally:
        setattr(handle, entry, inner.fn)
        for mod in (cuda_prng, cuda_reweight):
            getattr(mod, "_functions", {}).clear()

    def med(v):
        return sorted(v)[len(v) // 2]

    out = {"call_ms": med(sync_call), "wrapper_ms": med(enqueue) - med(launch),
           "launch_ms": med(launch), "device_ms": device_ms(fn, kernel),
           "idle_sync_ms": med(idle)}
    out["sync_ms"] = out["call_ms"] - med(enqueue)
    print(f"call split {name}: synchronized call {out['call_ms']:.4f} ms = wrapper "
          f"{out['wrapper_ms']:.4f} + launch (C entry) {out['launch_ms']:.4f} + until sync returns "
          f"{out['sync_ms']:.4f} (device {out['device_ms']:.4f}, idle synchronize "
          f"{out['idle_sync_ms']:.4f}); medians of {rounds} rounds in turns", flush=True)
    return out


def bound(n_bytes: float, n_int: float, n_f32: float, n_f64: float = 0.0):
    """(least ms, what bounds it) for the bytes moved and the 32-bit integer,
    float32 and float64 instructions issued, over the whole card."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    sm_clocks = max(n_int / INT32_PER_SM_CLOCK, n_f64 / FP64_PER_SM_CLOCK,
                    (n_int + n_f32 + n_f64) / ISSUE_PER_SM_CLOCK)
    t_ops = 1e3 * sm_clocks / SM_CLOCKS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work(*terms):
    """(integer, float32, float64) instruction totals of (count, (int, f32[,
    f64])) terms."""
    return tuple(sum(n * (tuple(per) + (0, 0))[i] for n, per in terms) for i in (0, 1, 2))


# ---------------------------------------------------------------------------
# The instructions of exp, from the SASS
# ---------------------------------------------------------------------------
SASS_PROBE = r'''
#define I (blockIdx.x * blockDim.x + threadIdx.x)
extern "C" __global__ void copy_f32(const float* x, float* y) { y[I] = x[I]; }
extern "C" __global__ void exp_f32(const float* x, float* y) { y[I] = expf(x[I]); }
extern "C" __global__ void copy_f64(const double* x, double* y) { y[I] = x[I]; }
extern "C" __global__ void exp_f64(const double* x, double* y) { y[I] = exp(x[I]); }
'''
# Moves of constants (hoisted out of a loop), uniform-datapath, control and
# memory instructions: not counted as a sample's arithmetic.
_SASS_SKIP = ("MOV", "IMAD.MOV", "UMOV", "HFMA2.MMA", "S2R", "S2UR", "LDC", "ULDC", "LDG", "STG",
              "EXIT", "BRA", "NOP", "BSSY", "BSYNC")


def _sass_class(op: str) -> int:
    """0: 32-bit integer, 1: float32 (with MUFU), 2: float64 pipe."""
    if op[0] == "D" or op.startswith(("F2F.F64", "I2F.F64", "F2I.F64", "MUFU.RCP64", "MUFU.RSQ64")):
        return 2
    if op.startswith(("F", "MUFU", "HFMA", "HADD", "HMUL")):
        return 1
    return 0


def _sass_functions(text: str) -> dict:
    """name -> opcodes of each function of a `cuobjdump -sass` listing,
    predicated instructions kept with their guard."""
    out, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            out[name] = []
        elif name and line.strip().startswith("/*") and "*/" in line:
            body = line.split("*/", 1)[1].split(";")[0].strip()
            if body:
                out[name].append(body)
    return out


def _fast_path(instrs: list) -> list:
    """The straight-line path of a probe: up to its first branch, then on
    from where the branches join (BSYNC); the rarely taken block between
    them (exp's overflow and underflow scaling) is left out."""
    for i, ins in enumerate(instrs):
        if " BRA" in f" {ins}" and ins.startswith("@"):
            join = next(j for j in range(i, len(instrs)) if instrs[j].startswith("BSYNC"))
            return instrs[:i] + instrs[join:]
    return instrs


def _counts(instrs: list) -> list:
    c = [0, 0, 0]
    for ins in _fast_path(instrs):
        op = ins.split()[0]
        if op.startswith("@"):
            continue
        if op.startswith(_SASS_SKIP) or op.startswith("U"):
            continue
        c[_sass_class(op)] += 1
    return c


def sass_exp_counts(sass: str) -> dict:
    """(int, f32, f64) instructions of one exp in float32 and float64: the
    exp probe's arithmetic less the copy probe's, from their SASS."""
    fns = _sass_functions(sass)
    out = {}
    for t in ("f32", "f64"):
        e, c = _counts(fns[f"exp_{t}"]), _counts(fns[f"copy_{t}"])
        out[t] = tuple(max(a - b, 0) for a, b in zip(e, c))
    return out


# ---------------------------------------------------------------------------
# Phases 1-4: the card, the build, the kernels against their plain versions
# ---------------------------------------------------------------------------
def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)  # name, power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)
    return torch.cuda.get_device_name(0)


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_PROPS = re.compile(r"Function properties for (\S+)")
_PTXAS_FRAME = re.compile(
    r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(text: str) -> dict:
    """function -> {registers, stack, spill_stores, spill_loads} from the
    `-Xptxas -v` lines of one compile (a function nvcc did not inline has
    a frame and no register count)."""
    out, entry, props = {}, None, None
    for line in text.splitlines():
        if m := _PTXAS_ENTRY.search(line):
            entry = m.group(1)
            out.setdefault(entry, {})
        elif m := _PTXAS_PROPS.search(line):
            props = m.group(1)
            out.setdefault(props, {})
        elif (m := _PTXAS_FRAME.search(line)) and props:
            out[props].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        elif (m := _PTXAS_REGS.search(line)) and entry:
            out[entry]["registers"] = int(m.group(1))
    return out


def _short_names(nvcc: str, names: list) -> dict:
    """mangled -> `kernel<args>`, by cu++filt where the toolkit has it."""
    def short(d):
        d = re.sub(r"^void ", "", d.replace("(bool)1", "true").replace("(bool)0", "false"))
        return re.sub(r"(<unnamed>|\(anonymous namespace\))::", "", d).split("(")[0]

    filt = os.path.join(os.path.dirname(nvcc), "cu++filt")
    if not names or not os.path.exists(filt):
        return {n: n for n in names}
    out = subprocess.run([filt, *names], capture_output=True, text=True, timeout=60)
    lines = out.stdout.splitlines() if out.returncode == 0 else []
    if len(lines) != len(names):
        return {n: n for n in names}
    shorts = {n: short(d) for n, d in zip(names, lines)}
    return shorts if len(set(shorts.values())) == len(shorts) else {n: n for n in names}


def phase_build() -> dict:
    """Every kernel library; beside them each one's ptxas report (a spill
    in any kernel fails) and the SASS probe whose exp counts set
    ESS_SAMPLE_PROBE. Returns the reports."""
    t0 = time.perf_counter()
    nvcc = _build._nvcc()
    tmp = tempfile.mkdtemp(prefix="sass_probe_")
    src, cubin = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "probe.cubin")
    with open(src, "w") as f:
        f.write(SASS_PROBE)
    probe = subprocess.Popen([nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                              "-o", cubin, src], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    libs = (cuda_reweight.LIBRARY, cuda_prng.LIBRARY) + (
        () if cuda_linalg is None else (cuda_linalg.LIBRARY,)) + (
        () if cuda_median is None else (cuda_median.LIBRARY,)) + (
        () if cuda_em is None else (cuda_em.GMM_LIBRARY, cuda_em.MVSTUD_LIBRARY))
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    ptxas = []
    for i, lib in enumerate(libs):  # the same compiles as the libraries', to cubins, verbose
        cmd = [nvcc, *flags, *lib.extra_flags, "-Xptxas", "-v", "-cubin",
               "-o", os.path.join(tmp, f"ptxas_{i}.cubin"), str(_build.CSRC / lib.source)]
        ptxas.append((lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True)))
    paths = _build.build_all(libs)
    for lib in libs:
        _build.load(lib)
    _, err = probe.communicate()
    check(probe.returncode == 0, f"SASS probe build failed: {err}")
    dump = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin],
                          capture_output=True, text=True, timeout=120)
    check(dump.returncode == 0, f"cuobjdump failed: {dump.stderr}")
    exp = sass_exp_counts(dump.stdout)
    for t, (i, f, d) in exp.items():
        ESS_SAMPLE_PROBE[t] = (ESS_SAMPLE_OTHER[0] + i, f + (ESS_SAMPLE_OTHER[1] if t == "f32" else 0),
                               d + (ESS_SAMPLE_OTHER[1] if t == "f64" else 0))
    names = " ".join(p.name for p in paths.values())
    print(f"build: {names} in {time.perf_counter() - t0:.3f} s (one nvcc per source, in parallel)",
          flush=True)
    print(f"SASS of exp (32-bit integer, float32, float64 instructions of its straight-line path, "
          f"sm_90a): float32 {exp['f32']}, float64 {exp['f64']}; the ESS kernel per sample and "
          f"probe: {ESS_SAMPLE_PROBE}", flush=True)
    reports, spilled = {}, []
    for lib, proc in ptxas:
        out, err = proc.communicate()
        check(proc.returncode == 0, f"ptxas report of {lib.source} failed: {err}")
        report = ptxas_report(out + err)
        check(len(report) > 0, f"no ptxas report for {lib.source}")
        short = _short_names(nvcc, list(report))
        label = lib.source
        reports[label] = {short[k]: v for k, v in report.items()}
        for name, r in reports[label].items():
            print(f"ptxas {label}: {name}: {r.get('registers', '-')} registers, stack "
                  f"{r.get('stack', 0)} bytes, spill stores {r.get('spill_stores', 0)} bytes, "
                  f"spill loads {r.get('spill_loads', 0)} bytes", flush=True)
            if r.get("spill_stores", 0) or r.get("spill_loads", 0):
                spilled.append(f"{label}: {name}")
    check(not spilled, f"register spills in {spilled}")
    return reports


def synthetic_history(device, n_particles, capacity, t_fill, seed, dtype=torch.float32):
    """A mid-run history: t_fill of `capacity` slots filled along the ESS
    ladder (target 2N) of a narrow 10-D Gaussian (sd 0.05) under the
    U(-10, 10) prior. Each iteration's particles are exact draws from the
    tempered target, its beta is what the plain bisection picks and its
    logZ the estimate at that beta, as the sampler commits them."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    hist = make_history(capacity, n_particles, N_DIM, dtype=dtype, device=device)
    cur = make_current(n_particles, N_DIM, dtype=dtype, device=device)
    sd = 0.05
    for t in range(t_fill):
        if t > 0:
            denom = mis_denominator(hist)
            bm = torch.where(hist.sample_mask(), denom, torch.full_like(denom, float("inf")))
            scal = torch.stack([cur.beta, torch.tensor(2.0 * n_particles, dtype=dtype,
                                                       device=device)])
            beta, _ = cuda_reweight.ess_bisect_beta_reference(
                hist.logl.reshape(-1), bm.reshape(-1), scal)
            cur.beta = beta[0]
            cur.logz = logw_from_denominator(hist, denom, cur.beta)[1]
        beta = float(cur.beta)
        shape = (n_particles, N_DIM)
        if beta == 0.0:
            x = 20.0 * torch.rand(shape, generator=g, dtype=dtype, device=device) - 10.0
        else:
            x = sd / math.sqrt(beta) * torch.randn(shape, generator=g, dtype=dtype, device=device)
            x = x.clamp(-10.0, 10.0)
        cur.logl = -0.5 * torch.sum(x * x, dim=-1) / sd**2
        commit(hist, cur)
    return hist


def ess_of(logl, bm, beta) -> float:
    """ESS at beta of the kernel's inputs, dropped samples masked."""
    keep = torch.isfinite(logl) & (bm != float("inf"))
    logw = torch.where(keep, beta * logl - bm, torch.full_like(logl, float("-inf")))
    return float(ess_from_logw(logw - torch.logsumexp(logw, dim=0)))


def kernel_inputs(hist):
    denom = mis_denominator(hist)
    bm = torch.where(hist.sample_mask(), denom, torch.full_like(denom, float("inf")))
    return denom, hist.logl.reshape(-1).contiguous(), bm.reshape(-1).contiguous()


def check_beta(what: str, logl, bm, bp: float, target: float, bk: float, pk: int, br: float,
               pr: int) -> None:
    """The kernel's (beta, probes) against the plain version's on one input:
    stay and jump exact with 2 probes; a bisection with the same probes,
    within BETA_TOL, and within BETA_MATCH_RTOL of the plain beta or at a
    beta whose plain ESS meets the stop rule."""
    if pr == 2:
        check(bk == br and pk == 2, f"{what}: kernel {bk} ({pk} probes) vs plain {br} (2 probes)")
        return
    close = abs(bk - br) <= BETA_MATCH_RTOL * max(abs(br), 1e-30)
    stops = abs(ess_of(logl, bm, bk) - target) < max(ESS_TOLERANCE * abs(target), METRIC_ATOL)
    check(pk == pr and abs(bk - br) < BETA_TOL and bp < bk <= 1.0 and (close or stops),
          f"{what}: kernel {bk} ({pk} probes) vs plain {br} ({pr} probes), beta_prev {bp}")


def _route(S: int, dtype=torch.float32) -> str:
    plan = cuda_reweight.plan_launch(S, dtype)
    where = "shared memory" if plan.resident else "streamed from L2"
    return f"cluster {plan.cluster} x {plan.threads} threads x slice {plan.slice}, {where}"


def forced_route(logl, bm, scal, resident: bool):
    """A launch of the ESS kernel on the given route through its C entry,
    outside the wrapper and its count: the streamed route also takes an S
    that the plan holds on chip."""
    entry = _build.load(cuda_reweight.LIBRARY).tempest_ess_bisect
    plan = cuda_reweight.plan_launch(logl.numel())
    beta = torch.empty(1, device=logl.device)
    probes = torch.empty(1, dtype=torch.int32, device=logl.device)

    def launch():
        err = entry(logl.data_ptr(), bm.data_ptr(), scal.data_ptr(), beta.data_ptr(),
                    probes.data_ptr(), logl.numel(), plan.slice, int(resident),
                    torch.cuda.current_stream().cuda_stream)
        _build.check(err, "ess_bisect")
        return beta, probes

    return launch


def compare_routes(S: int, logl, bm, scals: dict) -> dict:
    """Both routes at an S the plan holds on chip: the same bits, and the
    device time per launch (torch.profiler) of a one-pass launch ("stay")
    and of a bisection, in turns (resident, streamed, streamed, resident).
    A pass costs (bisection - stay) / (passes - 1), a bisection of P probes
    making P - 2 passes; what the resident route's one-time load of the
    slice costs is at most its one-pass launch less the streamed one's plus
    the streamed route's extra time a pass."""
    fns = {(route, case): forced_route(logl, bm, scal, route == "resident")
           for route in ("resident", "streamed") for case, scal in scals.items()}
    probes = {}
    for case in scals:
        got = [tuple(t.clone() for t in fns[(route, case)]()) for route in ("resident", "streamed")]
        torch.cuda.synchronize()
        check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for a, b in zip(*got)), f"S={S} {case}: the two routes differ")
        probes[case] = int(got[0][1].item())
    times = {k: [] for k in fns}
    for route in ("resident", "streamed", "streamed", "resident"):
        for case in scals:
            times[(route, case)].append(device_ms(fns[(route, case)], "ess_bisect"))
    out = {"probes": probes}
    for route in ("resident", "streamed"):
        stay, bisect = (min(times[(route, c)]) for c in ("stay", "bisect"))
        per_pass = (bisect - stay) / (probes["bisect"] - 3)
        out[route] = {"stay_ms": times[(route, "stay")], "bisect_ms": times[(route, "bisect")],
                      "pass_ms": per_pass}
    out["load_ms_at_most"] = (min(out["resident"]["stay_ms"]) - min(out["streamed"]["stay_ms"])
                              + out["streamed"]["pass_ms"] - out["resident"]["pass_ms"])
    res, st = out["resident"], out["streamed"]
    print(f"ess routes S={S} (device ms per launch, resident / streamed, each twice in turns): "
          f"one pass {res['stay_ms'][0]:.4f} {res['stay_ms'][1]:.4f} / {st['stay_ms'][0]:.4f} "
          f"{st['stay_ms'][1]:.4f}; bisection ({probes['bisect']} probes) "
          f"{res['bisect_ms'][0]:.4f} {res['bisect_ms'][1]:.4f} / {st['bisect_ms'][0]:.4f} "
          f"{st['bisect_ms'][1]:.4f}; a pass {res['pass_ms']:.5f} / {st['pass_ms']:.5f}; the "
          f"slice's one-time load at most {out['load_ms_at_most']:.5f}", flush=True)
    return out


ROUTES_COMPARED = (65536, 393216)  # the canonical S and the largest held on chip

# (label, n_particles, capacity, t_fill, the S prefixes checked, the S timed)
ESS_SHAPES = (
    ("canonical", 1024, 64, 40, (65536,), 65536),
    ("ragged", 1000, 61, 33, (61000,), None),
    ("on-chip boundary", 49153, 8, 8, (393216, 393217), 393217),
    ("B", 131072, 8, 8, (1048576,), 1048576),
)


def phase_ess_kernel(device) -> dict:
    """Kernel against its plain version on both routes; two launches give
    the same bits; times at three S."""
    max_err = 0.0
    row, shapes, routes = None, {}, {}
    for label, n_particles, capacity, t_fill, prefixes, timed in ESS_SHAPES:
        hist = synthetic_history(device, n_particles, capacity, t_fill, seed=capacity)
        _, logl_all, bm_all = kernel_inputs(hist)
        beta_prev = float(hist.beta[t_fill // 2])
        for S in prefixes:
            logl, bm = logl_all[:S], bm_all[:S]
            ess_cur, ess_one = ess_of(logl, bm, beta_prev), ess_of(logl, bm, 1.0)
            check(ess_cur > ess_one, f"S={S}: synthetic ladder gives ESS {ess_cur} <= {ess_one}")
            cases = [
                ("stay", beta_prev, 1.5 * ess_cur),
                ("jump", beta_prev, 0.5 * ess_one),
                ("bisect", beta_prev, math.sqrt(ess_cur * ess_one)),
                ("bisect", 0.0, 2.0 * n_particles),
                ("bisect", beta_prev, 0.9 * ess_cur),
            ]
            for kind, bp, target in cases:
                scal = torch.tensor([bp, target], dtype=torch.float32, device=device)
                beta_k, probes_k = cuda_reweight.ess_bisect_beta(logl, bm, scal)
                again, _ = cuda_reweight.ess_bisect_beta(logl, bm, scal)
                beta_r, probes_r = cuda_reweight.ess_bisect_beta_reference(logl, bm, scal)
                torch.cuda.synchronize()
                bk, br, pk, pr = beta_k.item(), beta_r.item(), probes_k.item(), probes_r.item()
                check(torch.equal(beta_k.view(torch.int32), again.view(torch.int32)),
                      f"S={S} {kind}: two launches differ")
                max_err = max(max_err, abs(bk - br))
                check((pr > 2) == (kind == "bisect"), f"S={S} {kind}: the plain version took {pr} "
                      "probes")
                check_beta(f"S={S} {kind}", logl, bm, bp, float(scal[1]), bk, pk, br, pr)
                print(f"ess kernel S={S} [{_route(S)}] {kind}: beta_prev={bp:.6g} "
                      f"target={target:.6g} kernel={bk:.7f} ({pk} probes) plain={br:.7f} "
                      f"({pr} probes)", flush=True)
            if S in ROUTES_COMPARED:
                routes[S] = compare_routes(S, logl, bm, {
                    "stay": torch.tensor([beta_prev, 1.5 * ess_cur], device=device),
                    "bisect": torch.tensor([beta_prev, math.sqrt(ess_cur * ess_one)],
                                           device=device)})
            if S != timed:
                continue
            scal = torch.tensor([beta_prev, math.sqrt(ess_cur * ess_one)], device=device)
            probes = int(cuda_reweight.ess_bisect_beta_reference(logl, bm, scal)[1].item())
            kernel = lambda: cuda_reweight.ess_bisect_beta(logl, bm, scal)  # noqa: E731
            t = timed_in_turns({"kernel": kernel})
            t.update(timed_in_turns({"plain": lambda: cuda_reweight.ess_bisect_beta_reference(
                logl, bm, scal)}, calls=TIMED_CALLS if S <= 65536 else 10))
            dev = device_ms(kernel, "ess_bisect")
            # logl and Bm read once, scal read, beta and the probe count written.
            b_ms, b_by = bound(8 * S + 16, *work((S * probes, ESS_SAMPLE_PROBE["f32"])))
            shapes[S] = dict(probes=probes, route=_route(S), ms=t["kernel"], device_ms=dev,
                             plain_ms=t["plain"], bound_ms=b_ms, bound_by=b_by)
            print(f"ess kernel timing S={S} ({label}, {probes} probes, {_route(S)}): kernel call "
                  f"{t['kernel']:.4f} ms device {dev:.4f} ms; plain {t['plain']:.4f} ms; bound "
                  f"{b_ms:.5f} ms ({b_by}) (calls: median of {TIMED_CALLS} synchronized calls, "
                  "the plain version's timed apart; device: torch.profiler)", flush=True)
            if S == CAPACITY * N_PARTICLES:
                row = dict(shapes[S], library_ms=None)
    check(row is not None, "no timing at S = 65,536")
    row["max_abs_err"] = max_err
    row["shapes"] = shapes
    row["routes"] = routes
    return row


# (label, n_particles, capacity, t_fill, the S prefixes checked, the S timed)
ESS_SHAPES_F64 = (
    ("canonical", 1024, 64, 40, (65536,), 65536),
    ("ragged", 1000, 61, 33, (61000,), None),
    ("float64 on-chip boundary", 24577, 8, 8, (196608, 196609), 196609),
    ("B", 131072, 8, 8, (1048576,), 1048576),
)


def check_beta_f64(what: str, bk: float, pk: int, br: float, pr: int) -> None:
    """The float64 kernel's (beta, probes) against the plain version's: the
    same probes; stay and jump exact, a bisection within BETA_F64_RTOL."""
    ok = bk == br if pr == 2 else abs(bk - br) <= BETA_F64_RTOL * abs(br)
    check(pk == pr and ok, f"{what}: float64 kernel {bk!r} ({pk} probes) vs plain {br!r} "
          f"({pr} probes)")


def phase_ess_kernel_f64(device) -> dict:
    """The float64 instantiation against its plain version on both routes,
    the same bits on a second launch, and its times in turns with the
    float32 instantiation on the same history cast to float32."""
    f64 = torch.float64
    max_err, row, shapes = 0.0, None, {}
    for label, n_particles, capacity, t_fill, prefixes, timed in ESS_SHAPES_F64:
        hist = synthetic_history(device, n_particles, capacity, t_fill, seed=capacity, dtype=f64)
        _, logl_all, bm_all = kernel_inputs(hist)
        beta_prev = float(hist.beta[t_fill // 2])
        for S in prefixes:
            logl, bm = logl_all[:S], bm_all[:S]
            route = _route(S, f64)
            ess_cur, ess_one = ess_of(logl, bm, beta_prev), ess_of(logl, bm, 1.0)
            check(ess_cur > ess_one, f"float64 S={S}: synthetic ladder gives ESS {ess_cur} <= "
                  f"{ess_one}")
            cases = [("stay", beta_prev, 1.5 * ess_cur), ("jump", beta_prev, 0.5 * ess_one),
                     ("bisect", beta_prev, math.sqrt(ess_cur * ess_one)),
                     ("bisect", 0.0, 2.0 * n_particles), ("bisect", beta_prev, 0.9 * ess_cur)]
            for kind, bp, target in cases:
                scal = torch.tensor([bp, target], dtype=f64, device=device)
                beta_k, probes_k = cuda_reweight.ess_bisect_beta(logl, bm, scal)
                again, _ = cuda_reweight.ess_bisect_beta(logl, bm, scal)
                beta_r, probes_r = cuda_reweight.ess_bisect_beta_reference(logl, bm, scal)
                torch.cuda.synchronize()
                bk, br, pk, pr = beta_k.item(), beta_r.item(), probes_k.item(), probes_r.item()
                check(beta_k.dtype == f64 and torch.equal(beta_k.view(torch.int64),
                                                          again.view(torch.int64)),
                      f"float64 S={S} {kind}: two launches differ")
                check((pr > 2) == (kind == "bisect"), f"float64 S={S} {kind}: the plain version "
                      f"took {pr} probes")
                check_beta_f64(f"float64 S={S} {kind}", bk, pk, br, pr)
                max_err = max(max_err, abs(bk - br))
                print(f"ess kernel float64 S={S} [{route}] {kind}: beta_prev={bp:.6g} "
                      f"target={target:.6g} kernel={bk:.15f} ({pk} probes) plain={br:.15f} "
                      f"({pr} probes)", flush=True)
            if S != timed:
                continue
            scal = torch.tensor([beta_prev, math.sqrt(ess_cur * ess_one)], dtype=f64,
                                device=device)
            l32, b32, s32 = logl.float(), bm.float(), scal.float()
            probes = int(cuda_reweight.ess_bisect_beta_reference(logl, bm, scal)[1].item())
            probes32 = int(cuda_reweight.ess_bisect_beta(l32, b32, s32)[1].item())
            fns = {"f64": lambda: cuda_reweight.ess_bisect_beta(logl, bm, scal),
                   "f32": lambda: cuda_reweight.ess_bisect_beta(l32, b32, s32)}
            t = timed_in_turns(fns)
            t.update(timed_in_turns({"plain": lambda: cuda_reweight.ess_bisect_beta_reference(
                logl, bm, scal)}, calls=TIMED_CALLS if S <= 65536 else 10))
            dev = {"f64": [], "f32": []}
            for k in ("f64", "f32", "f32", "f64"):
                dev[k].append(device_ms(fns[k], "ess_bisect"))
            # logl and Bm read once, scal read, beta and the probe count written.
            b_ms, b_by = bound(16 * S + 28, *work((S * probes, ESS_SAMPLE_PROBE["f64"])))
            shapes[S] = dict(probes=probes, route=route, ms=t["f64"], device_ms=min(dev["f64"]),
                             device_ms_turns=dev["f64"], plain_ms=t["plain"], bound_ms=b_ms,
                             bound_by=b_by, f32_probes=probes32, f32_ms=t["f32"],
                             f32_device_ms=min(dev["f32"]), f32_device_ms_turns=dev["f32"])
            print(f"ess kernel float64 timing S={S} ({label}, {probes} probes, {route}): call "
                  f"{t['f64']:.4f} ms, device {dev['f64'][0]:.4f} / {dev['f64'][1]:.4f} ms; "
                  f"float32 instantiation on the same history cast ({probes32} probes): call "
                  f"{t['f32']:.4f} ms, device {dev['f32'][0]:.4f} / {dev['f32'][1]:.4f} ms "
                  f"(device in turns f64, f32, f32, f64); plain {t['plain']:.4f} ms; bound "
                  f"{b_ms:.5f} ms ({b_by})", flush=True)
            if S == CAPACITY * N_PARTICLES:
                row = dict(shapes[S], library_ms=None)
    check(row is not None, "no float64 timing at S = 65,536")
    row["max_abs_err"] = max_err
    row["shapes"] = shapes
    return row


def _moments(z: torch.Tensor):
    z = z.double()
    m, v = float(z.mean()), float(z.var(unbiased=False))
    kurt = float(((z - m) ** 4).mean()) / v**2
    return m, v, kurt


def _gamma_flips(got: torch.Tensor, want: torch.Tensor) -> int:
    return int(torch.sum(torch.abs(got - want) > DRAW_TOL * torch.abs(want)))


def _later_rounds_decide(key, counter, alpha) -> int:
    """Walkers whose first Marsaglia-Tsang round rejects and a later one
    accepts: their draw differs from the one-round draw."""
    n, dev = alpha.numel(), alpha.device
    w0, w1, w2, _ = philox._blocks(n, philox.STREAM_GAMMA_ROUND0, counter, key, dev)
    z0 = torch.sqrt(-2.0 * torch.log(philox.unit_open_closed(w0))) * torch.cos(
        philox.TWO_PI * philox.unit_open_closed(w1))
    boost = philox.unit_open_closed(
        philox._blocks(n, philox.STREAM_BOOST_ACCEPT, counter, key, dev)[0])
    one = philox.marsaglia_tsang(alpha, [z0], [philox.unit_open_closed(w2)], boost)
    return int(torch.sum(one != philox.mutation_draws(key, counter, alpha, (1, n, 1))[1]))


# (8, 1024, 10): A's shape; (8, 1000, 10): ragged; (8, 6553, 10): the largest
# the fused route takes (R N d <= 2^19, tempest_tpu_torch/draws.py).
MUTATION_SHAPES = ((8, 1024, 10), (8, 1000, 10), (8, 6553, 10))
B_NORMALS = N_PROPOSAL_CANDIDATES * B_PARTICLES * N_DIM  # B's hw_normal: 10,485,760
B_GAMMA = B_PARTICLES  # B's hw_gamma: one gamma launch of 131,072 walkers
# The gamma draws' checks: sizes (ragged blocks, B's N, B's N + 3 and 2^18),
# shapes, and a call index whose 13 calls cross 2^32 (the counter's high word).
GAMMA_SIZES = (1, 3, 5, 1000, B_GAMMA, B_GAMMA + 3, 1 << 18)
GAMMA_ALPHAS = (0.02, 0.5, 0.7, 1.5, 7.5, 50.0)
GAMMA_COUNTER = (1 << 32) - 5
GAMMA_TIMED = (B_GAMMA, 1 << 18)
# The shape the gamma row is timed at: a tpCN walker's (d + nu) / 2 for
# d = 10 and nu = 5; every tpCN shape is >= d / 2, so B never boosts.
GAMMA_TIMED_ALPHA = 7.5


def phase_prng_kernels(device) -> dict:
    """Each PRNG kernel against its plain version on one key and call index,
    the moments of tests/test_tpu_smoke.py:181-243 on the kernel outputs,
    and the times of kernel, plain version and PyTorch generator."""
    key = philox.key_from_seed(2024)
    rows = {}

    # --- mutation draws at three shapes; alpha above 1, below 1, and small
    # enough that later Marsaglia-Tsang rounds decide -------------------------
    max_err, max_flips, shapes = 0.0, 0, {}
    for R, N, d in MUTATION_SHAPES:
        third = N // 3
        alpha = torch.cat([torch.full((third,), 7.5), torch.full((third,), 0.7),
                           torch.full((N - 2 * third,), 0.02)]).to(device)
        later = _later_rounds_decide(key, 1, alpha)
        z, g, u = cuda_prng.hw_mutation_draws(key, 1, alpha, (R, N, d))
        wz, wg, wu = philox.mutation_draws(key, 1, alpha, (R, N, d))
        torch.cuda.synchronize()
        err_z = float(torch.max(torch.abs(z - wz)))
        err_u = float(torch.max(torch.abs(u - wu)))
        flips = _gamma_flips(g, wg)
        agree = torch.abs(g - wg) <= DRAW_TOL * torch.abs(wg)
        err_g = float(torch.max(torch.abs(g - wg)[agree]))
        print(f"mutation draws R={R} N={N} d={d}: max|dz|={err_z:.3g} max|du|={err_u:.3g} "
              f"gamma flips={flips} of {N}, max|dg| elsewhere={err_g:.3g}; {later} walkers "
              "decided by a later round", flush=True)
        check(later > 0, f"mutation draws N={N}: no walker decided by a later round")
        check(z.shape == (R, N, d) and g.shape == u.shape == (N,), "mutation draws: shapes")
        check(err_z <= DRAW_TOL and err_u <= DRAW_TOL, "mutation draws: z or u differ from plain")
        check(flips <= max(1, MAX_FLIP_SHARE * N), f"mutation draws: {flips} gamma flips")
        max_err, max_flips = max(max_err, err_z, err_u, err_g), max(max_flips, flips)
        fns = {
            "kernel": lambda: cuda_prng.hw_mutation_draws(key, 1, alpha, (R, N, d)),
            "library": lambda: (torch.randn((R, N, d), device=device),
                                torch._standard_gamma(alpha), torch.rand(N, device=device)),
        }
        t = timed_in_turns(fns)
        t.update(timed_in_turns(
            {"plain": lambda: philox.mutation_draws(key, 1, alpha, (R, N, d))}, calls=10))
        dev = {"kernel": device_ms(fns["kernel"], "mutation_draws_kernel"),
               "library": device_ms(fns["library"])}
        n_z = R * N * d
        ops = work((-(-n_z // 4), NORMAL_BLOCK), (N * philox.MT_ROUNDS, MT_ROUND),
                   (N, WALKER_EXTRA))
        b_ms, b_by = bound(4 * N + 4 * n_z + 8 * N, *ops)
        shapes[f"{R}x{N}x{d}"] = dict(
            ms=t["kernel"], device_ms=dev["kernel"], plain_ms=t["plain"],
            library_ms=t["library"], library_device_ms=dev["library"], bound_ms=b_ms,
            bound_by=b_by)
        print(f"mutation draws timing R={R} N={N} d={d}: kernel call {t['kernel']:.4f} ms device "
              f"{dev['kernel']:.4f} ms; library (randn + _standard_gamma + rand) call "
              f"{t['library']:.4f} ms device {dev['library']:.4f} ms; plain {t['plain']:.4f} ms; "
              f"bound {b_ms:.6f} ms ({b_by})", flush=True)
    first = shapes["8x1024x10"]
    rows["mutation_draws"] = dict(
        max_abs_err=max_err, gamma_flips=max_flips, ms=first["ms"], plain_ms=first["plain_ms"],
        bound_ms=first["bound_ms"], bound_by=first["bound_by"], library_ms=first["library_ms"],
        device_ms=first["device_ms"], library_device_ms=first["library_device_ms"],
        shapes=shapes)

    R, N, d = MUTATION_SHAPES[0]
    alpha = torch.cat([torch.full((N // 2,), 7.5), torch.full((N // 2,), 0.7)]).to(device)
    zs, gs, us = [], [], []
    for c in range(32):
        z, g, u = cuda_prng.hw_mutation_draws(key, 100 + c, alpha, (R, N, d))
        zs.append(z.reshape(-1)), gs.append(g), us.append(u)
    z, g, u = torch.cat(zs), torch.stack(gs), torch.cat(us)
    zm, zv, zk = _moments(z)
    g_hi, g_lo = g[:, : N // 2].double(), g[:, N // 2:].double()
    print(f"mutation draws moments (32 calls): z mean={zm:.5f} var={zv:.5f} kurt={zk:.4f}; "
          f"u min={float(u.min()):.3g} mean={float(u.mean()):.5f}; "
          f"g(7.5) mean={float(g_hi.mean()):.4f} var={float(g_hi.var()):.4f}; "
          f"g(0.7) mean={float(g_lo.mean()):.4f} var={float(g_lo.var()):.4f}", flush=True)
    check(abs(zm) < 0.005 and abs(zv - 1.0) < 0.01 and abs(zk - 3.0) < 0.05, "mutation z moments")
    check(0.0 < float(u.min()) and float(u.max()) <= 1.0 and abs(float(u.mean()) - 0.5) < 0.01,
          "mutation u moments")
    check(float(g_lo.min()) > 0.0, "mutation g(0.7) not positive")
    check(abs(float(g_hi.mean()) - 7.5) < 0.1 and abs(float(g_hi.var()) - 7.5) < 0.3,
          "mutation g(7.5) moments")
    check(abs(float(g_lo.mean()) - 0.7) < 0.03 and abs(float(g_lo.var()) - 0.7) < 0.05,
          "mutation g(0.7) moments")

    # --- normal and bits at 2^20 (moments) and at B's shapes (times) ------------
    n = 1 << 20
    z = cuda_prng.hw_normal(key, 2, (n,), device)
    err_n = float(torch.max(torch.abs(z - philox.normal(key, 2, n, device))))
    # The bits kernel's path: the public hw_uniform, which no Sampler path
    # calls now that hw_gamma is one kernel; its launches label the bits row.
    before = counts()
    u = cuda_prng.hw_uniform(key, 3, (n,), device)
    uniform_launches = diff(counts(), before)
    b = cuda_prng.hw_bits(key, 3, (n,), device)
    bits_equal = bool(torch.equal(b, philox.bits(key, 3, n, device)))
    check(torch.equal(u, philox.unit_open_closed(b)) and uniform_launches["bits"] == 1
          and sum(uniform_launches.values()) == 1, f"hw_uniform: launches {uniform_launches}")
    zm, zv, zk = _moments(z)
    tail = float((z.abs() > 3).double().mean())
    um, uv, _ = _moments(u)
    print(f"normal n={n}: max|dz|={err_n:.3g} mean={zm:.5f} var={zv:.5f} kurt={zk:.4f} "
          f"P(|z|>3)={tail:.5f}; bits n={n}: equal={bits_equal}, hw_uniform launches "
          f"{uniform_launches}, uniform min={float(u.min()):.3g} max={float(u.max())} "
          f"mean={um:.5f} var={uv:.5f}", flush=True)
    check(err_n <= DRAW_TOL, f"normal kernel differs from plain by {err_n}")
    check(bits_equal, "bits kernel differs from plain")
    check(abs(zm) < 0.005 and abs(zv - 1.0) < 0.01 and abs(zk - 3.0) < 0.05
          and abs(tail - 0.0027) < 0.0005, "normal moments")
    check(0.0 < float(u.min()) and float(u.max()) <= 1.0 and abs(um - 0.5) < 0.002
          and abs(uv - 1.0 / 12.0) < 0.001, "uniform moments")
    for name, kernel_name, sizes in (("normal", "normal_kernel", (n, B_NORMALS, B_GAMMA)),
                                     ("bits", "bits_kernel", (n, B_GAMMA))):
        shapes = {}
        for m in sizes:
            if name == "normal":
                fns = {"kernel": lambda m=m: cuda_prng.hw_normal(key, 2, (m,), device),
                       "library": lambda m=m: torch.randn(m, device=device),
                       "plain": lambda m=m: philox.normal(key, 2, m, device)}
                b_ms, b_by = bound(4 * m, *work((-(-m // 4), NORMAL_BLOCK)))
            else:
                fns = {"kernel": lambda m=m: cuda_prng.hw_bits(key, 3, (m,), device),
                       "library": lambda m=m: torch.empty(
                           m, dtype=torch.int32, device=device).random_(),
                       "plain": lambda m=m: philox.bits(key, 3, m, device)}
                b_ms, b_by = bound(4 * m, *work((-(-m // 4), (PHILOX_INT, 0))))
            if m != n:
                got = fns["kernel"]().reshape(-1)
                want = fns["plain"]()
                err = (float(torch.max(torch.abs(got - want))) if name == "normal"
                       else (0.0 if torch.equal(got, want) else float("nan")))
                check(err <= DRAW_TOL, f"{name} kernel differs from plain at n={m}: {err}")
            plain = fns.pop("plain")
            t = timed_in_turns(fns)
            t.update(timed_in_turns({"plain": plain}, calls=10))
            dev = {"kernel": device_ms(fns["kernel"], kernel_name),
                   "library": device_ms(fns["library"])}
            shapes[m] = dict(ms=t["kernel"], device_ms=dev["kernel"], plain_ms=t["plain"],
                             library_ms=t["library"], library_device_ms=dev["library"],
                             bound_ms=b_ms, bound_by=b_by)
            print(f"{name} timing n={m}: kernel call {t['kernel']:.4f} ms device "
                  f"{dev['kernel']:.4f} ms; library call {t['library']:.4f} ms device "
                  f"{dev['library']:.4f} ms; plain {t['plain']:.4f} ms; bound {b_ms:.6f} ms "
                  f"({b_by})", flush=True)
        main = shapes[B_NORMALS if name == "normal" else B_GAMMA]  # the shape on B's path
        rows[name] = dict(max_abs_err=err_n if name == "normal" else (
            0.0 if bits_equal else float("nan")), **{
                k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                     "device_ms", "library_device_ms")},
            shapes={str(k): v for k, v in shapes.items()})
    rows["bits"]["hw_uniform_launches"] = uniform_launches["bits"]
    rows["gamma"] = phase_gamma_kernel(device, key)
    return rows


def mixed_alpha(device, n: int) -> torch.Tensor:
    """n walkers' shapes, the six of GAMMA_ALPHAS in turn."""
    return torch.tensor(GAMMA_ALPHAS, device=device).repeat(-(-n // 6))[:n].contiguous()


def gamma_cases(device, n: int):
    """(label, alpha) of n walkers: each of GAMMA_ALPHAS, then all six in turn."""
    for a in GAMMA_ALPHAS:
        yield f"alpha={a}", torch.full((n,), a, device=device)
    yield "mixed", mixed_alpha(device, n)


def gamma_rounds(key, counter: int, alpha: torch.Tensor) -> torch.Tensor:
    """The Marsaglia-Tsang rounds each walker of hw_gamma needs on these
    draws (from the plain version's words): its first accepted round + 1,
    or all six."""
    n, dev = alpha.numel(), alpha.device
    zc, uc, _ = philox.gamma_counters(counter)
    _, d, c = philox.mt_setup(alpha.reshape(-1))
    need = torch.full((n,), philox.MT_ROUNDS, dtype=torch.int64, device=dev)
    undecided = torch.ones(n, dtype=torch.bool, device=dev)
    for r in range(philox.MT_ROUNDS):
        z = philox.normal(key, zc[r], n, dev)
        u = philox.unit_open_closed(philox.bits(key, uc[r], n, dev))
        ok, _ = philox.mt_accept(z, u, d, c)
        need = torch.where(undecided & ok, r + 1, need)
        undecided &= ~ok
    return need


def gamma_bound(key, counter: int, alpha: torch.Tensor):
    """((least ms, what bounds it), mean rounds a walker) of hw_gamma on
    these draws: alpha read and g written once; per block of 4 walkers two
    Philox blocks a round it runs (as long as one of its walkers is
    undecided), per pair of walkers a Box-Muller pair a round, per walker a
    test a round it needs, its set-up, and where alpha < 1 the boost (and
    one Philox block for each block with such a walker)."""
    n = alpha.numel()
    need = gamma_rounds(key, counter, alpha)
    pad = (-n) % 4
    flat = alpha.reshape(-1)
    blocks = torch.nn.functional.pad(need, (0, pad)).reshape(-1, 4)
    boosted = torch.nn.functional.pad(flat < 1.0, (0, pad)).reshape(-1, 4)
    philox_blocks = 2 * int(blocks.amax(dim=1).sum()) + int(boosted.any(dim=1).sum())
    pairs = int(blocks.reshape(-1, 2).amax(dim=1).sum())
    ops = work((philox_blocks, (PHILOX_INT, 0)), (pairs, GAMMA_PAIR), (int(need.sum()), GAMMA_TEST),
               (n, GAMMA_SETUP), (int(boosted.sum()), GAMMA_BOOST))
    return bound(8 * n, *ops), float(need.double().mean())


def phase_gamma_kernel(device, key) -> dict:
    """tempest_gamma against philox.gamma at GAMMA_SIZES for every case of
    gamma_cases, one gamma launch and no other PRNG launch a call; moments
    at 2^18; times at B's N and 2^18 beside the plain version and
    torch._standard_gamma."""
    max_err, max_flips, unequal = 0.0, 0, 0
    for n in GAMMA_SIZES:
        summary = []
        for label, alpha in gamma_cases(device, n):
            before = counts()
            g = cuda_prng.hw_gamma(key, GAMMA_COUNTER, alpha)
            launched = diff(counts(), before)
            want = philox.gamma(key, GAMMA_COUNTER, alpha)
            torch.cuda.synchronize()
            check(launched["gamma"] == 1 and sum(launched.values()) == 1,
                  f"hw_gamma n={n} {label}: launches {launched}, want one gamma launch")
            check(g.shape == alpha.shape and bool(torch.all(torch.isfinite(g) & (g >= 0))),
                  f"hw_gamma n={n} {label}: shape {tuple(g.shape)} or values")
            flips = _gamma_flips(g, want)
            agree = torch.abs(g - want) <= DRAW_TOL * torch.abs(want)
            err = float(torch.max(torch.abs(g - want)[agree])) if bool(agree.any()) else 0.0
            check(flips <= max(1, MAX_FLIP_SHARE * n), f"hw_gamma n={n} {label}: {flips} flips")
            bits = int(torch.sum(g != want))  # draws whose float32 bits differ at all
            max_err, max_flips, unequal = max(max_err, err), max(max_flips, flips), unequal + bits
            summary.append(f"{label} {flips}/{err:.3g}/{bits}")
        print(f"gamma kernel n={n} against philox.gamma (counter {GAMMA_COUNTER}; flips / "
              f"max|dg| elsewhere / draws not equal bit for bit): {', '.join(summary)}",
              flush=True)

    n = 1 << 18
    for a in (0.5, 1.5, 7.5, 50.0):
        g = cuda_prng.hw_gamma(key, 10, torch.full((n,), a, device=device))
        gm, gv = float(g.double().mean()), float(g.double().var())
        print(f"gamma kernel moments alpha={a} n={n}: mean={gm:.4f} var={gv:.4f}", flush=True)
        check(float(g.min()) > 0.0 and abs(gm - a) < 5 * math.sqrt(a / n) + 0.01
              and abs(gv - a) < 0.05 * a + 0.02, f"hw_gamma alpha={a} moments")

    shapes = {}
    for n in GAMMA_TIMED:
        alpha = torch.full((n,), GAMMA_TIMED_ALPHA, device=device)
        fns = {"kernel": lambda: cuda_prng.hw_gamma(key, 10, alpha),
               "library": lambda: torch._standard_gamma(alpha)}
        t = timed_in_turns(fns)
        t.update(timed_in_turns({"plain": lambda: philox.gamma(key, 10, alpha)}, calls=10))
        dev = {"kernel": device_ms(fns["kernel"], "gamma_"),
               "library": device_ms(fns["library"])}
        (b_ms, b_by), mean_rounds = gamma_bound(key, 10, alpha)
        shapes[n] = dict(ms=t["kernel"], device_ms=dev["kernel"], plain_ms=t["plain"],
                         library_ms=t["library"], library_device_ms=dev["library"],
                         bound_ms=b_ms, bound_by=b_by, mean_rounds=mean_rounds)
        print(f"gamma timing n={n} alpha={GAMMA_TIMED_ALPHA}: kernel call {t['kernel']:.4f} ms "
              f"device {dev['kernel']:.4f} ms; torch._standard_gamma call {t['library']:.4f} ms "
              f"device {dev['library']:.4f} ms; plain {t['plain']:.4f} ms; bound {b_ms:.6f} ms "
              f"({b_by}; {mean_rounds:.4f} rounds a walker)", flush=True)
    row = dict(shapes[B_GAMMA], max_abs_err=max_err, gamma_flips=max_flips,
               gamma_bits_unequal=unequal, shapes={str(k): v for k, v in shapes.items()})
    return row


# ---------------------------------------------------------------------------
# Phase 4b: the eigenvalue kernel (no Pallas counterpart: XLA's eigvalsh)
# ---------------------------------------------------------------------------
EIG_KINDS = ("spd", "indefinite", "rank_deficient", "diagonal")
# d = 10 is the CV's covariance on the 10-D paths (one matrix a call), 100
# the rosenbrock100 path's (phase 16), 50 between; 240 is past what shared
# memory holds (global workspace).
EIG_CHECKED, EIG_TIMED = (1, 3, 10, 100, 240), (10, 50, 100)


def symmetric_batch(device, batch: int, d: int, kind: str, dtype, seed: int = 0):
    """(batch, d, d) symmetric matrices: SPD, indefinite, rank-deficient
    (rank d // 2) or diagonal."""
    g = torch.Generator(device="cpu")
    g.manual_seed(seed + d)
    x = torch.randn(batch, d, d, generator=g, dtype=torch.float64)
    if kind == "spd":
        a = x @ x.transpose(1, 2) / d + 0.1 * torch.eye(d, dtype=torch.float64)
    elif kind == "indefinite":
        a = x + x.transpose(1, 2)
    elif kind == "rank_deficient":
        y = x[:, :, : max(d // 2, 1)]
        a = y @ y.transpose(1, 2)
    else:
        a = torch.diag_embed(torch.randn(batch, d, generator=g, dtype=torch.float64))
    return a.to(device=device, dtype=dtype)


def eig_bound(d: int, batch: int, dtype, one_sm: bool = False):
    """(least ms, what bounds it) of the eigenvalues of `batch` (d, d)
    matrices, from the least work of the computation, whatever the
    algorithm: the reduction to tridiagonal form, 4/3 d^3 flops (2/3 d^3
    fused multiply-adds), each matrix read once and its eigenvalues written
    once. Over the whole card, or with `one_sm` at one SM's issue rate (one
    matrix runs on one SM; the bytes still at the card's rate)."""
    fma = batch * 2.0 * d ** 3 / 3.0 * (N_SMS if one_sm else 1)
    size = torch.tensor([], dtype=dtype).element_size()
    n_bytes = batch * (d * d + d) * size
    return bound(n_bytes, 0, fma if dtype == torch.float32 else 0,
                 fma if dtype == torch.float64 else 0)


def phase_eig_kernel(device) -> dict:
    """tempest_sym_eigvals against its plain version (torch.linalg.eigvalsh
    of the float64 copy, the CPU route's function) on SPD, indefinite,
    rank-deficient and diagonal matrices at EIG_CHECKED in float32 and
    float64: |dlambda| <= 16 d eps max|lambda| (the kernel's backward error
    against LAPACK's), ascending, two launches the same bits; then at
    EIG_TIMED, one matrix a call, its synchronized call and device time
    beside torch.linalg.eigvalsh on the card in float64 (the plain version
    the kernel is held to) and in float32 (the library call), and its bound
    over the card and over one SM. The kernel's second output is the
    multisection rounds of each matrix's slowest eigenvalue (the sweeps of
    an older, Jacobi kernel under --package-root)."""
    max_err, shapes = 0.0, {}
    cap = getattr(cuda_linalg, "MAX_ROUNDS", 30)
    for dtype in (torch.float32, torch.float64):
        eps = torch.finfo(dtype).eps
        for d in EIG_CHECKED:
            worst = 0.0
            for kind in EIG_KINDS:
                a = symmetric_batch(device, 4, d, kind, dtype)
                got, rounds = cuda_linalg._launch(a, True)
                again = cuda_linalg.eigvalsh(a)
                want = torch.linalg.eigvalsh(a.double())
                torch.cuda.synchronize()
                scale = want.abs().amax(dim=1, keepdim=True)
                err = (got.double() - want).abs()
                ratio = float((err / (d * eps * torch.clamp(scale, min=1e-300))).max())
                worst = max(worst, ratio)
                if dtype == torch.float32:
                    max_err = max(max_err, float(err.max()))
                check(torch.equal(got, again), f"sym_eigvals d={d} {kind} {dtype}: two launches "
                      "differ")
                check(bool(torch.all(torch.diff(got, dim=1) >= 0)),
                      f"sym_eigvals d={d} {kind} {dtype}: not ascending")
                check(ratio <= 16.0, f"sym_eigvals d={d} {kind} {dtype}: |dlambda| = {ratio:.3g} "
                      "d eps max|lambda|, above 16")
                check(int(rounds.max()) < cap, f"sym_eigvals d={d} {kind}: {int(rounds.max())} "
                      f"rounds (the cap, {cap})")
            route = "shared" if cuda_linalg.plan_launch(d, dtype).resident else "global"
            print(f"sym_eigvals {str(dtype)[6:]} d={d} [{route}]: max |dlambda| = {worst:.3f} "
                  f"d eps max|lambda| over {len(EIG_KINDS)} kinds x 4 matrices (bar 16)",
                  flush=True)
    for d in EIG_TIMED:
        a = symmetric_batch(device, 1, d, "spd", torch.float32, seed=7)
        a64 = a.double()
        _, rounds = cuda_linalg._launch(a, True)
        rounds = int(rounds.item())
        kernel = lambda: cuda_linalg.eigvalsh(a)  # noqa: E731
        t = timed_in_turns({"kernel": kernel, "plain": lambda: torch.linalg.eigvalsh(a64),
                            "library": lambda: torch.linalg.eigvalsh(a)})
        dev = device_ms(kernel, "sym_eigvals")
        lib_dev = device_ms(lambda: torch.linalg.eigvalsh(a))
        b_ms, b_by = eig_bound(d, 1, torch.float32)
        sm_ms, sm_by = eig_bound(d, 1, torch.float32, one_sm=True)
        shapes[d] = dict(rounds=rounds, ms=t["kernel"], device_ms=dev, plain_ms=t["plain"],
                         library_ms=t["library"], library_device_ms=lib_dev, bound_ms=b_ms,
                         bound_by=b_by, bound_sm_ms=sm_ms, bound_sm_by=sm_by)
        print(f"sym_eigvals timing d={d} (one float32 matrix, {rounds} rounds): kernel call "
              f"{t['kernel']:.4f} ms device {dev:.4f} ms; plain (torch.linalg.eigvalsh, "
              f"float64 copy) {t['plain']:.4f} ms; library (torch.linalg.eigvalsh, float32) call "
              f"{t['library']:.4f} ms device {lib_dev:.4f} ms; bound {b_ms:.6f} ms ({b_by}) over "
              f"the card, {sm_ms:.6f} ms ({sm_by}) on one SM (calls: median of {TIMED_CALLS} "
              f"synchronized calls in turns)", flush=True)
    # The row: d = 100, the rosenbrock100 path's matrix (phase 16).
    return dict(shapes[EIG_TIMED[-1]], max_abs_err=max_err, shapes=shapes)


# ---------------------------------------------------------------------------
# Phase 4c: the weighted-median kernel (no Pallas counterpart: XLA's cumsum)
# ---------------------------------------------------------------------------
# (K, n, d) of the mode fits on the paths: A's clustered fit, B's
# fit_global_mode (n = train_max_points = 4 N), rosenbrock100's.
MEDIAN_SHAPES = {"A": (16, 4096, 10), "B": (1, 524288, 10), "rosenbrock100": (1, 8192, 100)}
# Further shapes checked: ragged tiles, one point, rows all zero.
MEDIAN_EXTRA = ((3, 257, 4, (1,)), (5, 4097, 3, (0, 4)), (2, 1, 1, ()), (4, 10000, 7, (0, 1, 2, 3)))
# The latency of a dependent add (cycles), for the chain's bound: FADD about
# 4 on Hopper; DADD taken as 8 (estimated).
ADD_LATENCY = {torch.float32: 4, torch.float64: 8}


def median_inputs(device, K, n, d, dtype, seed, zero_rows=()):
    """(d_sorted, order, wbar) as a fit makes them: the stable column sort of
    the points (sort_columns), exponential weights with a tenth of them
    zero, each row normalized; the rows in `zero_rows` all zero."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g, dtype=torch.float64)
    w = torch.empty(K, n, dtype=torch.float64).exponential_(generator=g)
    w[torch.rand(K, n, generator=g) < 0.1] = 0.0
    for k in zero_rows:
        w[k] = 0.0
    x, w = x.to(device=device, dtype=dtype), w.to(device=device, dtype=dtype)
    total = w.sum(dim=1, keepdim=True)
    wbar = w / torch.where(total > 0, total, torch.ones_like(total))
    order = torch.argsort(x, dim=0, stable=True).contiguous()
    return torch.gather(x, 0, order).contiguous(), order, wbar


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def cumsum_accumulation(device) -> dict:
    """How torch.cumsum along the points (dim -2 of (K, n, d)) adds on this
    card, the plain version's scan: each column against numpy's serial
    float32 sum and its float64-accumulated sum rounded to float32."""
    out = {}
    for label in ("A", "B"):
        K, n, d = MEDIAN_SHAPES[label]
        g = torch.Generator().manual_seed(11)
        x = torch.rand((K, n, d), generator=g) * (2.0 / n)
        card = torch.cumsum(x.to(device), dim=-2).cpu().numpy()
        xn = x.numpy()
        serial = np.cumsum(xn, axis=1, dtype=np.float32)
        wide = np.cumsum(xn.astype(np.float64), axis=1).astype(np.float32)
        out[label] = {"unequal_to_float32_serial": int((card != serial).sum()),
                      "unequal_to_float64_accumulated": int((card != wide).sum())}
    print(f"torch.cumsum(dim=-2) on the card, float32, entries unequal to numpy's serial float32 "
          f"sum / its float64-accumulated sum: {json.dumps(out)}", flush=True)
    check(all(v["unequal_to_float32_serial"] == 0 for v in out.values()),
          f"torch.cumsum on the card is not the serial float32 sum: {out}")
    return out


def median_bound(K, n, d, dtype, crossings) -> dict:
    """The least time of the median at these inputs: the bytes (order read
    once, the K n d gathered weights, the K d medians read and written) at
    3.35 TB/s, and the chain: the longest column's adds up to its crossing
    (all n for a column that does not cross), each waiting for the last,
    at one dependent add per ADD_LATENCY cycles of the boost clock."""
    size = torch.tensor([], dtype=dtype).element_size()
    n_bytes = 8 * n * d + size * (K * n * d + 2 * K * d)
    bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    chain_ms = 1e3 * crossings * ADD_LATENCY[dtype] / (SM_CLOCKS_PER_S / N_SMS)
    return {"bytes_bound_ms": bytes_ms, "chain_bound_ms": chain_ms,
            "bound_ms": max(bytes_ms, chain_ms),
            "bound_by": "operations" if chain_ms >= bytes_ms else "bytes"}


def phase_median_kernel(device) -> dict:
    """tempest_weighted_median (_f64) against its plain version, bit for bit,
    at MEDIAN_SHAPES and MEDIAN_EXTRA in float32 and float64, two launches
    the same bits; at MEDIAN_SHAPES in float32, its call and device time in
    turns with the plain version and the library call (torch.cumsum and
    argmax of the gathered weights, the gather done before), beside its
    bounds."""
    accumulation = cumsum_accumulation(device)
    cases = [(label, *shape, ()) for label, shape in MEDIAN_SHAPES.items()] + [
        ("extra", *shape) for shape in MEDIAN_EXTRA]
    for dtype in (torch.float32, torch.float64):
        for label, K, n, d, zero_rows in cases:
            ds, order, wbar = median_inputs(device, K, n, d, dtype, seed=n + d,
                                            zero_rows=zero_rows)
            got = cuda_median.weighted_median_presorted(ds, order, wbar)
            again = cuda_median.weighted_median_presorted(ds, order, wbar)
            want = cuda_median.weighted_median_presorted_reference(ds, order, wbar)
            torch.cuda.synchronize()
            check(torch.equal(_bits(got), _bits(want)) and torch.equal(_bits(got), _bits(again)),
                  f"weighted_median {label} {(K, n, d)} {dtype}: the kernel's medians are not the "
                  "plain version's bits")
            check(all(torch.equal(got[k], ds[0]) for k in zero_rows),
                  f"weighted_median {(K, n, d)}: an all-zero row is not d_sorted[0]")
    print("weighted_median: the kernel equals its plain version bit for bit (max|dmu| = 0) at "
          f"{[c[1:4] for c in cases]} in float32 and float64 (rows all zero: d_sorted[0]); two "
          "launches the same bits", flush=True)
    shapes = {}
    thr = torch.tensor(cuda_median.THRESHOLD, dtype=torch.float32).item()
    for label, (K, n, d) in MEDIAN_SHAPES.items():
        ds, order, wbar = median_inputs(device, K, n, d, torch.float32, seed=n + d)
        gathered = wbar[..., order]
        crossed = torch.cumsum(gathered, dim=-2) >= thr
        # The adds a column runs: up to its crossing, or all n where none.
        adds = torch.where(crossed.any(dim=-2), torch.argmax(crossed.to(torch.int8), dim=-2) + 1,
                           torch.full_like(crossed[..., 0, :], n, dtype=torch.int64))
        longest = int(adds.max())
        kernel = lambda: cuda_median.weighted_median_presorted(ds, order, wbar)  # noqa: E731
        t = timed_in_turns({
            "kernel": kernel,
            "plain": lambda: cuda_median.weighted_median_presorted_reference(ds, order, wbar),
            "library": lambda: torch.argmax(
                (torch.cumsum(gathered, dim=-2) >= thr).to(torch.int8), dim=-2)},
            calls=TIMED_CALLS if n <= 8192 else 5)
        dev = []
        for _ in range(2):  # in turns with the library call's device time
            dev.append(device_ms(kernel, "weighted_median", calls=10))
            lib = device_ms(lambda: torch.cumsum(gathered, dim=-2), calls=3)
        b = median_bound(K, n, d, torch.float32, longest)
        shapes[label] = dict(K=K, n=n, d=d, longest_chain=longest, ms=t["kernel"],
                             device_ms=min(dev), device_ms_turns=dev, plain_ms=t["plain"],
                             library_ms=t["library"], library_device_ms=lib, **b)
        print(f"weighted_median timing {label} (K, n, d) = {(K, n, d)}, longest chain {longest} "
              f"adds: kernel call {t['kernel']:.4f} ms device {dev[0]:.4f} / {dev[1]:.4f} ms; "
              f"plain {t['plain']:.4f} ms; library (torch.cumsum + argmax) call "
              f"{t['library']:.4f} ms, its cumsum's device time {lib:.4f} ms; bound "
              f"{b['bound_ms']:.5f} ms ({b['bound_by']}: chain {b['chain_bound_ms']:.5f}, bytes "
              f"{b['bytes_bound_ms']:.5f}) (calls: medians of synchronized calls in turns)",
              flush=True)
    # The row: B's fit, the path the kernel was written for.
    return dict(shapes["B"], max_abs_err=0.0, shapes=shapes, cumsum_accumulation=accumulation)


# ---------------------------------------------------------------------------
# Phase 4d: the EM kernels (no Pallas counterpart: XLA's while_loops)
# ---------------------------------------------------------------------------
# The GMM EM's fits (B, n, d, K): A's leaf fits (16 leaf slots,
# leaf_fit_points, K = 2), then the other covariance types, K = 1 and 16.
EM_GMM_SHAPES = {"A": (16, 2048, 10, 2, "full")}
EM_GMM_EXTRA = ((4, 2048, 10, 2, "tied"), (4, 2048, 10, 2, "diag"), (4, 2048, 10, 2, "spherical"),
                (2, 2048, 10, 1, "full"), (2, 4096, 10, 16, "full"))
# The Student-t EM's (K, n, d): A's clustered fit (k_max modes of 4 N fit
# points), the unclustered and dynamic paths' global fit, B's, rosenbrock100's.
EM_MODE_SHAPES = {"A": (16, 4096, 10), "unclustered": (1, 4096, 10), "B": (1, 524288, 10),
                  "rosenbrock100": (1, 8192, 100)}
# The loops' settings on the paths (cluster.py, student.py).
EM_MAX_ITER, EM_TOL, EM_REG = 1000, 1e-3, 1e-6
EM_GMM_CARRY = ("pi", "means", "covs", "lb", "n_iter", "done")
EM_GMM_PARAMS = ("pi", "means", "covs", "lb")
EM_MODE_CARRY = ("mu", "Sigma", "nu", "last_nu", "i", "hit_inf", "active")
EM_MODE_PARAMS = ("mu", "Sigma", "nu", "last_nu")
# How a kernel is held to its plain loop, in both types (phase 4d and
# tests/test_torch_cuda.py; normwise: max|got - want| / max|want| per fit):
#  1. Step by step. The kernel is launched with max_iter = 1, 2, ..., so
#     its state after each of its own iterations is seen, and each is held
#     to one plain body run on the card from its state before it. The plain
#     body's other routes from that state measure how well the step is
#     conditioned: the same body on the CPU, and on the card from the state
#     moved by up to EM_PERTURB_ULPS ulps (about the backward error of the
#     d x d Cholesky factorization and triangular solve the kernel does its
#     own way; a mode collapsed onto one point makes its distances, and so
#     its step, that sensitive).
#     - A decision taken the other way (the GMM's exit; the Student-t's
#       Gaussian-limit test, its nu cell, its exit test) only where another
#       plain route takes it apart from the card's too, or where the plain
#       margin lies within EM_DECISION_ULPS ulps of the magnitudes the
#       decision's sum adds before they cancel (|lb| and |new lb|; |a| + |b|
#       + sum w (|log1p e| + |e|); each exit test's bound), or, in the
#       Student-t, where the mode's Sigma is one a Cholesky factorization
#       is not sure to take (`_em_cholesky_near_tie`: a mode whose points
#       repeat, as resampled particles do, has a singular Sigma, and the
#       regularized Cholesky's floor then goes either way).
#     - Where the step's decisions agree, each parameter within
#       EM_STEP_RTOL, or EM_SPREAD times the other routes' distance (not
#       held at a Cholesky near-tie).
#     - A fit that stops keeps its bits, and the full launch equals the
#       launch cut at its last iteration.
#  2. The whole fit against the plain loop on the card: the same counts
#     and flags and each parameter within EM_WHOLE_RTOL. A fit that parts
#     is allowed only where the plain loop parts from itself by that rule
#     when only the order of its sums changes (on the CPU, or on the points
#     in reverse order), or, in the GMM, where the plain loop's exit at the
#     iteration the counts part lies within EM_DECISION_ULPS, or, in the
#     Student-t, where the mode met a Cholesky near-tie in rule 1. Every
#     fit that parts is printed with both values.
# The limits, from this phase's readings on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md §6): one float32 step moved a parameter 8.6e-6 at most on
# the synthetic fits and 9.3e-5 on A's own; whole float32 fits that agree
# 5.0e-4 at most (K = 16 after 34-40 iterations; 3.6e-6 elsewhere); whole
# float64 fits 5.1e-13 on the synthetic ones, 8.3e-10 on A's own; the
# decisions taken the other way with no other excuse lay within 6.5 ulps.
EM_STEP_RTOL = {torch.float32: 1e-4, torch.float64: 1e-9}
EM_WHOLE_RTOL = {torch.float32: 2e-3, torch.float64: 1e-9}
EM_SPREAD = 4.0
EM_DECISION_ULPS = 16
EM_PERTURB_ULPS = 16
# Cluster reductions an EM iteration: the GMM's E-step sums and scatter; the
# Student-t's bound test, five multisection passes and M-step.
EM_REDUCTIONS = {"gmm_em": 2, "mvstud_em": 7}
# Instructions (float32, estimated low) of CUDA's precise functions.
EM_EXP, EM_LOG, EM_LOG1P, EM_DIV = 10, 15, 20, 10
# A cluster reduction as the kernels make it (em_common.cuh cluster_sum):
# each CTA stores its partial to L2, fences, the cluster syncs, every CTA
# reads the partials back; timed over `rounds` rounds at a cluster size.
EM_BARRIER_PROBE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
__global__ void __launch_bounds__(256) reduction_rounds(float* rows, int rounds) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = static_cast<int>(cluster.num_blocks());
  float s = 0.0f;
  for (int r = 0; r < rounds; ++r) {
    float* b = rows + (r & 1) * 32;
    if (threadIdx.x == 0) __stcg(b + rank, s + 1.0f);
    __threadfence();
    cluster.sync();
    float t = 0.0f;
    for (int i = 0; i < c; ++i) t += __ldcg(b + i);
    s = t;
    __syncthreads();
  }
  if (threadIdx.x == 0 && rank == 0) rows[64] = s;
}
extern "C" int reduction_rounds_launch(void* rows, int cluster, int rounds, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(reduction_rounds,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(256);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, reduction_rounds, static_cast<float*>(rows), rounds);
  return err != cudaSuccess ? err : cudaGetLastError();
}
"""


def em_reduction_us(device) -> dict:
    """Microseconds of one cluster reduction at cluster sizes 1-16: the
    probe's time at 1,001 rounds less its time at 1, over 1,000."""
    import ctypes

    tmp = tempfile.mkdtemp(prefix="em_probe_")
    src, lib = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "libprobe.so")
    with open(src, "w") as f:
        f.write(EM_BARRIER_PROBE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src], check=True,
                   capture_output=True, timeout=300)
    fn = ctypes.CDLL(lib).reduction_rounds_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    rows = torch.zeros(128, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    out = {}
    for c in (1, 2, 4, 8, 16):
        def run(rounds):
            check(fn(rows.data_ptr(), c, rounds, stream) == 0, f"reduction probe at C = {c}")
        times = {}
        for rounds in (1, 1001):
            run(rounds)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(5):
                run(rounds)
            b.record()
            torch.cuda.synchronize()
            times[rounds] = a.elapsed_time(b) / 5
        out[c] = 1e3 * (times[1001] - times[1]) / 1000
    print(f"cluster reduction (store, fence, cluster barrier, load), us a round by cluster size: "
          f"{json.dumps({k: round(v, 4) for k, v in out.items()})}", flush=True)
    return out


def _em_mixture(rng, n, d, k):
    centers = 4.0 * rng.normal(size=(k, d))
    labels = rng.integers(0, k, size=n)
    return centers[labels] + rng.normal(size=(n, d)) / np.sqrt(rng.uniform(size=(n, 1)) + 0.2)


def em_gmm_inputs(device, B, n, d, K, cov, dtype, seed):
    """(Xb, sw, carry) of B fits at the k-means++ start (cluster._gmm_start)
    on mixture points of 3 clusters with heavy tails."""
    rng = np.random.default_rng(seed)
    X = np.stack([_em_mixture(rng, n, d, 3) for _ in range(B)])
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    return cluster_module._gmm_start(t(X), t(rng.uniform(0.1, 1.0, size=(B, n))), K,
                                     t(rng.uniform(size=(B, K))), 1000, cov)


def em_mode_inputs(device, K, n, d, dtype, seed):
    """(carry, consts) of K weightings at the Student-t EM's start
    (student._mode_start): correlated heavy-tailed points, each point
    weighted by one mode."""
    rng = np.random.default_rng(seed)
    data = rng.standard_t(4.0, size=(n, d)) * rng.uniform(0.5, 2.0, size=d)
    data[:, 1:] += 0.3 * data[:, :-1]
    labels = rng.integers(0, K, size=n)
    w = rng.uniform(0.05, 1.0, size=(K, n)) * (labels[None] == np.arange(K)[:, None])
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    return student_module._mode_start(t(data), t(w), 1e-6, 100)


def _em_normwise(a, b):
    """max|a - b| / max|b| over each leading index; inf where the finite
    entries differ in place."""
    a, b = a.double().reshape(a.shape[0], -1), b.double().reshape(b.shape[0], -1)
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    same = (fa == fb).all(dim=1) & ((a == b) | fa).all(dim=1)
    d = torch.where(fa & fb, (a - b).abs(), torch.zeros_like(a)).amax(dim=1)
    s = torch.where(fb, b.abs(), torch.zeros_like(b)).amax(dim=1)
    out = torch.where(s > 0, d / torch.where(s > 0, s, torch.ones_like(s)), d)
    return torch.where(same, out, torch.full_like(out, float("inf")))


def _em_on(tensors: dict, device) -> dict:
    return {k: v.to(device) for k, v in tensors.items()}


def _em_fail_if(bad, what: str, detail) -> None:
    """Fail naming the fits where `bad` (a bool per fit) holds."""
    if bool(bad.any()):
        fits = torch.nonzero(bad).flatten().tolist()
        fail(f"{what}: fits {fits}: {detail() if callable(detail) else detail}")


def _em_hold_params(what, got, want, params, rtol, spread, live) -> float:
    """Each parameter of the fits in `live` within `rtol` (normwise) or
    EM_SPREAD x the plain routes' own distance (`spread()`, computed only
    when needed); returns the largest normwise error of those fits."""
    worst, errs = 0.0, {p: _em_normwise(got[p], want[p]) for p in params}
    for p, e in errs.items():
        over = live & (e > rtol)
        if bool(over.any()):
            s = spread()[p]
            _em_fail_if(over & (e > EM_SPREAD * s), f"{what}: {p} beyond {rtol:g} and "
                        f"{EM_SPREAD}x the plain routes' distance",
                        lambda: f"errors {e[over].tolist()}, plain routes {s[over].tolist()}")
        if bool(live.any()):
            worst = max(worst, float(torch.where(live, e, torch.zeros_like(e)).max()))
    return worst


def _em_cut(gmm: bool, k: dict, carry: dict, j: int) -> dict:
    """The kernel's state after its first j iterations: the same launch with
    max_iter = j."""
    m = torch.tensor(j, dtype=torch.int32, device=carry["nu" if not gmm else "lb"].device)
    if gmm:
        return cuda_em.gmm_em(k["X"], k["sw"], {e: carry[e].contiguous() for e in EM_GMM_CARRY},
                              k["tol"], m, EM_REG, k["cov"])
    return cuda_em.mvstud_em(k["data"], k["wbar"],
                             {e: carry[e].contiguous() for e in EM_MODE_CARRY}, k["tolerance"], m)


def _em_gmm_margin(X, sw, c):
    """The plain exit test's margin at carry c: |new_lb - lb - tol| in ulps
    of max(|new_lb|, |lb|) per fit (inf on the first iteration)."""
    _, new_lb = cluster_module._e_step(X, c["pi"], c["means"], c["covs"], EM_REG, sw)
    scale = torch.finfo(X.dtype).eps * torch.maximum(new_lb.abs(), c["lb"].abs())
    m = ((new_lb - c["lb"] - EM_TOL).abs() / scale).double()
    return torch.nan_to_num(m, nan=float("inf"))


def _em_mode_terms(c, k):
    """(f, scale) of the stationarity function at log nu (K, M) from carry c,
    with the distances the plain body computes: scale = |a| + |b| + sum w
    (|log1p e| + |e|), the magnitudes its sum adds before they cancel."""
    sm = student_module
    data, wbar, d = k["data"], k["wbar"], k["data"].shape[1]
    _, L = sm.regularized_cholesky(c["Sigma"])
    L_inv = torch.linalg.solve_triangular(L, k["eye"].expand_as(L), upper=False)
    sol = (data - c["mu"][:, None, :]) @ L_inv.transpose(-1, -2)
    delta = torch.sum(sol * sol, dim=-1)

    def at(log_nu):
        nu = torch.exp(log_nu)[..., None]
        e = (d - delta[:, None, :]) / (nu + delta[:, None, :])
        l1 = torch.log1p(e)
        nu = nu[..., 0]
        a, b = sm._log_minus_digamma(nu / 2.0), sm._log_minus_digamma((nu + d) / 2.0)
        f = a - b + torch.sum(wbar[:, None, :] * (l1 - e), dim=-1)
        s = a.abs() + b.abs() + torch.sum(wbar[:, None, :] * (l1.abs() + e.abs()), dim=-1)
        return f, s, sm._nu_objective(log_nu, delta, d, wbar)

    return at


def _em_mode_margin(c, k, nu_k, hit_k):
    """The plain body's margin (ulps of its sum's scale) at the first of its
    dof decisions from carry c that the outcome (nu_k, hit_k) took the
    other way: the Gaussian-limit test, else the cells of the five
    multisection passes (every mid between the two cells must have gone
    the other way: the largest of their margins). 0 where no decision
    parted."""
    sm = student_module
    eps = torch.finfo(k["data"].dtype).eps
    at = _em_mode_terms(c, k)
    hi = torch.full_like(c["nu"], sm._NU_LOG_HI)
    f, s, obj = at(hi[:, None])
    hit_p = obj[:, 0] >= 0.0
    margin = torch.where(hit_p != hit_k, (f[:, 0].abs() / (eps * s[:, 0])).double(),
                         torch.zeros_like(hi, dtype=torch.float64))
    settled = (hit_p != hit_k) | hit_p
    log_k = torch.log(nu_k.double())
    lo = torch.full_like(hi, sm._NU_LOG_LO)
    fracs = torch.arange(1, sm._NU_SPLIT, dtype=hi.dtype, device=hi.device) / sm._NU_SPLIT
    cells = torch.arange(sm._NU_SPLIT - 1, device=hi.device)
    for _ in range(sm._NU_PASSES):
        mids = lo[:, None] + (hi - lo)[:, None] * fracs
        f, s, obj = at(mids)
        count = torch.sum(obj > 0.0, dim=-1)
        width = (hi - lo).double() / sm._NU_SPLIT
        cell_k = torch.floor((log_k - lo.double()) / width).long()
        apart = ~settled & (cell_k != count)
        low, high = torch.minimum(cell_k, count), torch.maximum(cell_k, count)
        between = (cells[None] >= low[:, None]) & (cells[None] < high[:, None])
        m = torch.where(between, (f.abs() / (eps * s)).double(), torch.zeros_like(f).double())
        inside = (cell_k >= 0) & (cell_k < sm._NU_SPLIT)
        m = torch.where(inside, m.amax(dim=-1), torch.full_like(margin, float("inf")))
        margin = torch.where(apart, m, margin)
        settled = settled | apart
        grid = torch.cat([lo[:, None], mids, hi[:, None]], dim=-1)
        lo = torch.gather(grid, -1, count[:, None])[:, 0]
        hi = torch.gather(grid, -1, count[:, None] + 1)[:, 0]
    return margin


def _em_cholesky_near_tie(Sigma):
    """Per matrix: whether its smallest eigenvalue lies below 20 d^1.5 eps
    times its largest, where a Cholesky factorization in the type is not
    sure to succeed (Higham, Accuracy and Stability of Numerical
    Algorithms, 2nd ed., Theorem 10.7), so whether the regularized
    Cholesky adds its floor depends on the factorization's rounding."""
    d = Sigma.shape[-1]
    ev = torch.linalg.eigvalsh(Sigma.double())
    bound = 20.0 * d ** 1.5 * torch.finfo(Sigma.dtype).eps * ev[..., -1].abs()
    return ev[..., 0] <= bound


def _em_converged_margin(c, tolerance):
    """The plain exit test's margin at carry c (ulps of each test's
    threshold): the largest margin of the tests that hold where the fit
    converged, else the smallest."""
    nu, last = c["nu"].double(), c["last_nu"].double()
    eps = torch.finfo(c["nu"].dtype).eps
    tol = tolerance * torch.clamp(nu.abs(), min=1.0)
    inv_last = torch.where(last == 0.0, torch.zeros_like(last), 1.0 / last)
    g1 = ((last - nu).abs() - tol) / (eps * tol)
    g2 = ((inv_last - 1.0 / nu).abs() - 1000 * eps) / (eps * 1000 * eps)
    conv = (g1 <= 0) | (g2 <= 0)
    held = torch.stack([torch.where(g <= 0, -g, torch.zeros_like(g)) for g in (g1, g2)]).amax(0)
    return torch.nan_to_num(torch.where(conv, held, torch.minimum(g1, g2)), nan=float("inf"))


def _em_perturbed(c: dict, keys, j: int) -> dict:
    """Carry c with each entry of `keys` moved by up to EM_PERTURB_ULPS ulps
    (seeded by the step j)."""
    out = dict(c)
    gen = torch.Generator(device=c[keys[0]].device).manual_seed(j)
    for e in keys:
        t = c[e]
        u = torch.rand(t.shape, generator=gen, device=t.device, dtype=t.dtype) * 2.0 - 1.0
        out[e] = t * (1.0 + EM_PERTURB_ULPS * torch.finfo(t.dtype).eps * u)
    return out


class _EmRoutes:
    """The plain body's other routes from one state, computed at most once
    and only when asked: on the CPU, and on the card from the state moved
    by a few ulps (`_em_perturbed`), each on the card's device."""

    def __init__(self, body, c, consts, perturb):
        self.body, self.c, self.consts, self.perturb, self.out = body, c, consts, perturb, None

    def __call__(self) -> dict:
        if self.out is None:
            device = self.consts["X" if "X" in self.consts else "data"].device
            cpu = self.body(_em_on(self.c, "cpu"), _em_on(self.consts, "cpu"))
            self.out = {"cpu": _em_on(cpu, device),
                        "perturbed": self.body(self.perturb(self.c), self.consts)}
        return self.out

    def spread(self, want, params) -> dict:
        """The largest normwise distance of a route from `want`, per fit."""
        routes = self()
        return {p: torch.stack([_em_normwise(r[p], want[p]) for r in routes.values()]).amax(0)
                for p in params}


def em_gmm_steps(what, k, carry, got) -> dict:
    """Rule 1 for the GMM kernel: its state after each of its iterations
    against one plain body from its state before it."""
    X, sw, cov, dtype = k["X"], k["sw"], k["cov"], k["X"].dtype
    rtol, J = EM_STEP_RTOL[dtype], int(got["n_iter"].max())
    prev, worst, flips = carry, 0.0, []
    body = functools.partial(cluster_module._gmm_em_body, covariance_type=cov, reg_covar=EM_REG)
    for j in range(1, J + 1):
        kj = _em_cut(True, k, carry, j)
        consts = cluster_module._gmm_consts(X, j, EM_TOL, sw=sw)
        pj = body(prev, consts)
        routes = _EmRoutes(body, prev, consts,
                           lambda c: _em_perturbed(c, ("pi", "means", "covs"), j))
        active = ~prev["done"] & (prev["n_iter"] < j)
        _em_fail_if(kj["n_iter"] != prev["n_iter"] + active.int(), f"{what} step {j}",
                    "iterated a fit the loop stops, or stopped one it runs")
        for e in EM_GMM_CARRY:
            _em_fail_if(~active & (_em_normwise(kj[e], prev[e]) != 0), f"{what} step {j}",
                        f"a stopped fit's {e} moved")
        flip = active & (kj["done"] != pj["done"])
        if bool(flip.any()):
            m = _em_gmm_margin(X, sw, prev)
            apart = torch.stack([r["done"] != pj["done"] for r in routes().values()]).any(0)
            _em_fail_if(flip & ~apart & (m > EM_DECISION_ULPS), f"{what} step {j}",
                        lambda: f"exit taken the other way, plain margins {m[flip].tolist()} ulps")
            flips += [dict(step=j, fit=i, margin_ulps=float(m[i]),
                           plain_routes_apart=bool(apart[i]))
                      for i in torch.nonzero(flip).flatten().tolist()]
        worst = max(worst, _em_hold_params(f"{what} step {j}", kj, pj, EM_GMM_PARAMS, rtol,
                                           lambda: routes.spread(pj, EM_GMM_PARAMS),
                                           active & ~flip))
        prev = kj
    _em_fail_if(torch.stack([_em_normwise(prev[e], got[e]) != 0 for e in EM_GMM_CARRY]).any(0),
                what, "the full launch differs from the launch cut at its last iteration")
    return dict(steps=J, step_err=worst, step_flips=flips)


def em_mode_steps(what, k, carry, got) -> dict:
    """Rule 1 for the Student-t kernel: its state after each of its
    iterations against one plain body from its state before it."""
    sm, dtype = student_module, k["data"].dtype
    rtol, J = EM_STEP_RTOL[dtype], int(got["i"].max())
    prev, worst, flips = carry, 0.0, []
    tied = torch.zeros_like(carry["active"])
    for j in range(1, J + 1):
        kj = _em_cut(False, k, carry, j)
        c = dict(prev)
        if j > 1:  # the plain body's own exit test on the kernel's state
            c["active"] = (~sm._nu_converged(prev["nu"], prev["last_nu"], k["tolerance"])
                           & ~prev["hit_inf"] & (prev["i"] < j))
        consts = dict(k, max_iter=torch.tensor(j, dtype=torch.int32, device=k["data"].device))
        pj = sm._em_body(c, consts)
        routes = _EmRoutes(sm._em_body, c, consts, lambda c: _em_perturbed(c, ("mu", "Sigma"), j))
        went = kj["i"] > prev["i"]
        turned = went != c["active"]
        if bool(turned.any()):
            m = _em_converged_margin(prev, float(k["tolerance"]))
            _em_fail_if(turned & (m > EM_DECISION_ULPS), f"{what} step {j}",
                        lambda: f"exit test taken the other way, margins {m[turned].tolist()} ulps")
            flips += [dict(step=j, mode=i, exit=True, margin_ulps=float(m[i]))
                      for i in torch.nonzero(turned).flatten().tolist()]
        for e in EM_MODE_CARRY:
            if e != "active":
                _em_fail_if(~went & ~c["active"] & (_em_normwise(kj[e], prev[e]) != 0),
                            f"{what} step {j}", f"a stopped mode's {e} moved")
        both = went & c["active"]
        # A mode whose Sigma a Cholesky factorization is not sure to take:
        # the kernel's own factorization may regularize it the other way.
        near = _em_cholesky_near_tie(c["Sigma"]) & both
        tied |= near

        def dof(r):
            return (r["hit_inf"] != pj["hit_inf"]) | (_em_cell(r["nu"]) != _em_cell(pj["nu"]))

        parted = both & dof(kj)
        if bool(parted.any()):
            m = _em_mode_margin(c, k, kj["nu"], kj["hit_inf"])
            apart = torch.stack([dof(r) for r in routes().values()]).any(0)
            _em_fail_if(parted & ~apart & ~near & (m > EM_DECISION_ULPS), f"{what} step {j}",
                        lambda: f"dof decision taken the other way: kernel nu "
                                f"{kj['nu'][parted].tolist()}, plain {pj['nu'][parted].tolist()}, "
                                f"plain margins {m[parted].tolist()} ulps")
            flips += [dict(step=j, mode=i, nu=[float(kj["nu"][i]), float(pj["nu"][i])],
                           margin_ulps=float(m[i]), plain_routes_apart=bool(apart[i]),
                           cholesky_near_tie=bool(near[i]))
                      for i in torch.nonzero(parted).flatten().tolist()]
        worst = max(worst, _em_hold_params(f"{what} step {j}", kj, pj, EM_MODE_PARAMS, rtol,
                                           lambda: routes.spread(pj, EM_MODE_PARAMS),
                                           both & ~parted & ~near))
        prev = kj
    _em_fail_if(torch.stack([_em_normwise(prev[e], got[e]) != 0 for e in EM_MODE_CARRY
                             if e != "active"]).any(0),
                what, "the full launch differs from the launch cut at its last iteration")
    return dict(steps=J, step_err=worst, step_flips=flips, cholesky_near_tie=tied)


def _em_cell(nu):
    """The final multisection cell of each nu (inf: the Gaussian limit)."""
    sm = student_module
    width = (sm._NU_LOG_HI - sm._NU_LOG_LO) / sm._NU_SPLIT ** sm._NU_PASSES
    return torch.floor((torch.log(nu.double()) - sm._NU_LOG_LO) / width).nan_to_num(
        nan=-1.0, posinf=-2.0)


def em_whole(what, got, want, alternatives, counts, params, dtype, exit_margin=None,
             near_tie=None) -> dict:
    """Rule 2: the kernel's final fit against the plain loop's on the card.
    A fit that parts must part in the plain loop too when only the order of
    its sums changes (`alternatives()`: the plain loop on the CPU and on the
    points in reverse order), or (`exit_margin`) at an exit within
    EM_DECISION_ULPS of the plain loop's, or have met a Cholesky near-tie
    on the way (`near_tie`, a mask from rule 1). Returns the fits that
    part, each with both values."""
    rtol = EM_WHOLE_RTOL[dtype]

    def apart(a, b):
        out = torch.zeros_like(b[counts[0]], dtype=torch.bool)
        for e in counts:
            out |= a[e] != b[e]
        for p in params:
            out |= _em_normwise(a[p], b[p]) > rtol
        return out

    parted = apart(got, want)
    out = []
    if bool(parted.any()):
        alts = alternatives()
        routes = torch.stack([apart(a, want) for a in alts.values()]).any(0)
        m = exit_margin(got, want) if exit_margin is not None else torch.full_like(
            routes, float("inf"), dtype=torch.float64)
        tie = near_tie if near_tie is not None else torch.zeros_like(parted)
        _em_fail_if(parted & ~routes & ~tie & (m > EM_DECISION_ULPS),
                    f"{what}: parts from the plain loop beyond {rtol:g}, where the plain "
                    f"loop does not part from itself",
                    lambda: {e: (got[e][parted].tolist(), want[e][parted].tolist())
                             for e in (*counts, *params) if got[e].dim() == 1})
        for i in torch.nonzero(parted).flatten().tolist():
            row = {e: [got[e][i].tolist(), want[e][i].tolist()] for e in counts}
            row.update({f"{p}_normwise": float(_em_normwise(got[p], want[p])[i]) for p in params})
            if "nu" in got:
                row["nu"] = [float(got["nu"][i]), float(want["nu"][i])]
            row.update(fit=i, exit_margin_ulps=float(m[i]), cholesky_near_tie=bool(tie[i]),
                       plain_routes_apart={n: bool(apart(a, want)[i]) for n, a in alts.items()})
            out.append(row)
    errs = {p: float(_em_normwise(got[p], want[p])[~parted].max()) if bool((~parted).any()) else 0.0
            for p in params}
    return dict(parted=out, normwise=errs)


def em_gmm_case(what, Xb, sw, carry, cov, max_iter: int = EM_MAX_ITER) -> dict:
    """The GMM kernel against its plain loop (rules 1 and 2), two launches
    the same bits."""
    dtype = Xb.dtype
    before = cuda_em.LAUNCHES["gmm_em"]
    got = cluster_module._gmm_em(Xb, sw, carry, max_iter, EM_TOL, EM_REG, cov, None)
    again = cluster_module._gmm_em(Xb, sw, carry, max_iter, EM_TOL, EM_REG, cov, None)
    check(cuda_em.LAUNCHES["gmm_em"] == before + 2, f"{what}: not one launch a loop")
    check(all(torch.equal(got[e], again[e]) for e in EM_GMM_CARRY), f"{what}: two launches differ")
    want = cluster_module._gmm_em_plain(Xb, sw, carry, max_iter, EM_TOL, EM_REG, cov, None)
    k = dict(X=Xb.contiguous(), sw=sw.contiguous(), cov=cov,
             tol=torch.full((), EM_TOL, dtype=dtype, device=Xb.device))
    steps = em_gmm_steps(what, k, carry, got)

    def alternatives():
        cpu = cluster_module._gmm_em_plain(Xb.cpu(), sw.cpu(), _em_on(carry, "cpu"), max_iter,
                                           EM_TOL, EM_REG, cov, None)
        rev = cluster_module._gmm_em_plain(Xb.flip(1), sw.flip(1), carry, max_iter, EM_TOL,
                                           EM_REG, cov, None)
        return {"cpu": _em_on(cpu, Xb.device), "reversed": rev}

    def exit_margin(got, want):
        """The plain loop's exit margin at the iteration where the counts part."""
        t = torch.minimum(got["n_iter"], want["n_iter"])
        c, consts = dict(carry), cluster_module._gmm_consts(Xb, max_iter, EM_TOL, sw=sw)
        m = torch.full(t.shape, float("inf"), dtype=torch.float64, device=Xb.device)
        for j in range(1, int(t.max()) + 1):
            m = torch.where((t == j) & (got["n_iter"] != want["n_iter"]),
                            _em_gmm_margin(Xb, sw, c), m)
            c = cluster_module._gmm_em_body(c, consts, cov, EM_REG)
        return m

    whole = em_whole(what, got, want, alternatives, ("n_iter", "done"), EM_GMM_PARAMS, dtype,
                     exit_margin)
    gap = max(float(torch.nan_to_num((got[p].double() - want[p].double()).abs(), nan=0.0,
                                     posinf=0.0).max()) for p in EM_GMM_PARAMS)
    return dict(whole, **steps, max_abs_err=gap, n_iter=got["n_iter"].tolist())


def em_mode_case(what, carry, consts) -> dict:
    """The Student-t kernel against its plain loop (rules 1 and 2), two
    launches the same bits."""
    dtype = consts["data"].dtype
    before = cuda_em.LAUNCHES["mvstud_em"]
    got = student_module._mode_em(carry, consts, None)
    again = student_module._mode_em(carry, consts, None)
    check(cuda_em.LAUNCHES["mvstud_em"] == before + 2, f"{what}: not one launch a loop")
    check(all(torch.equal(got[e], again[e]) for e in EM_MODE_CARRY), f"{what}: two launches differ")
    want = student_module._mode_em_plain(carry, consts, None)
    k = dict(consts, data=consts["data"].contiguous(), wbar=consts["wbar"].contiguous())
    steps = em_mode_steps(what, k, carry, got)

    def alternatives():
        cpu = student_module._mode_em_plain(_em_on(carry, "cpu"), _em_on(consts, "cpu"), None)
        rev = dict(consts, data=consts["data"].flip(0), wbar=consts["wbar"].flip(1))
        return {"cpu": _em_on(cpu, consts["data"].device),
                "reversed": student_module._mode_em_plain(carry, rev, None)}

    near_tie = steps.pop("cholesky_near_tie")
    whole = em_whole(what, got, want, alternatives, ("i", "hit_inf"), EM_MODE_PARAMS, dtype,
                     near_tie=near_tie)
    gap = max(float(torch.nan_to_num((got[p].double() - want[p].double()).abs(), nan=0.0,
                                     posinf=0.0).max()) for p in EM_MODE_PARAMS)
    return dict(whole, **steps, max_abs_err=gap, iterations=got["i"].tolist(),
                gaussian_limit=int(got["hit_inf"].sum()))


def a_fit_inputs(device, iteration: int = 21) -> dict:
    """The inputs of every GMM EM loop and of the Student-t EM loop of A's
    seed 42 (on_device=False) at `iteration`, on the card."""
    s = canonical_sampler(device, SEEDS[0], clustering=True)
    s.reset(random_state=SEEDS[0])
    core = s.state
    core.n_total = N_TOTAL
    core._pregrow_capacity()
    got = {"gmm": [], "mode": []}
    gmm_em, mode_em = cluster_module._gmm_em, student_module._mode_em
    copy = lambda c: {k: v.clone() for k, v in c.items()}  # noqa: E731

    def gmm(X, sw, carry, max_iter, tol, reg, cov, loops):
        got["gmm"].append((X.clone(), sw.clone(), copy(carry), cov))
        return gmm_em(X, sw, carry, max_iter, tol, reg, cov, loops)

    def mode(carry, consts, loops):
        got["mode"].append((copy(carry), copy(consts)))
        return mode_em(carry, consts, loops)

    for _ in range(iteration - 1):
        core._step(None, 0)
    cluster_module._gmm_em, student_module._mode_em = gmm, mode
    try:
        core._step(None, 0)
    finally:
        cluster_module._gmm_em, student_module._mode_em = gmm_em, mode_em
    return got


def em_gmm_work(B, n, d, K, iters_total, elem=4):
    """(bytes, instructions) of the GMM EM at these fits, in elements of
    `elem` bytes: X and sw read once, the carry read and written once; per
    point and EM iteration the E-step (K Mahalanobis forms, two exps, a
    log), the first sums and the scatter, counted on the iterations each
    fit ran."""
    n_bytes = elem * (B * n * d + B * n + 2 * B * (K + K * d + K * d * d + 3))
    per_point = (K * (d * (d + 1) / 2 + 3 * d + 2 * EM_EXP + EM_DIV + 6) + EM_LOG
                 + 2 * K * (d + 1) + K * (d * (d + 1) + d))
    return n_bytes, per_point * n * iters_total


def em_mode_work(K, n, d, iters_total, elem=4):
    """(bytes, instructions) of the Student-t EM, in elements of `elem`
    bytes: data and wbar read once, the carry read and written once; per
    point and EM iteration the distance, 76 evaluations of the stationarity
    terms and the M-step's sums, counted on the iterations each mode ran."""
    n_bytes = elem * (n * d + K * n + 2 * K * (d + d * d + 5))
    per_point = (d * (d + 1) / 2 + 2 * d + 76 * (EM_DIV + EM_LOG1P + 4) + EM_DIV
                 + 2 * (1 + d + d * (d + 1) / 2) + 2 * d)
    return n_bytes, per_point * n * iters_total


def em_timing(name, kernel, plain, n_bytes, n_ops, chain_ms, calls, f64=False) -> dict:
    """A kernel's call and device ms in turns with its plain loop, and its
    bounds (its instructions float64 ones if `f64`)."""
    t = timed_in_turns({"kernel": kernel, "plain": plain}, calls=calls)
    dev = [device_ms(kernel, f"{name}_kernel", calls=5) for _ in range(2)]
    b_ms, b_by = bound(n_bytes, 0, 0.0 if f64 else n_ops, n_ops if f64 else 0.0)
    return dict(ms=t["kernel"], device_ms=min(dev), device_ms_turns=dev, plain_ms=t["plain"],
                bound_ms=b_ms, bound_by=b_by, chain_bound_ms=chain_ms,
                bound_with_chain_ms=max(b_ms, chain_ms), library_ms=None)


def phase_em_kernels(device) -> dict:
    """tempest_gmm_em and tempest_mvstud_em (_f64) against their plain loops
    (the "gmm_em" and "mode_em" device loops on the same CUDA tensors) at
    the paths' shapes in float32 and float64, on synthetic fits and on A's
    own fit inputs (seed 42, iteration 21), two launches the same bits; in
    float32 (and at A's and B's shapes in float64) their call and device
    times in turns with the plain loops (chunks of 4, as the fused route
    runs them), beside their bounds."""
    red_us = em_reduction_us(device)
    report = {"gmm_em": {}, "mvstud_em": {}}
    for dtype in (torch.float32, torch.float64):
        tag = "f32" if dtype == torch.float32 else "f64"
        for i, (B, n, d, K, cov) in enumerate(list(EM_GMM_SHAPES.values()) + list(EM_GMM_EXTRA)):
            Xb, sw, carry = em_gmm_inputs(device, B, n, d, K, cov, dtype, seed=i)
            report["gmm_em"][f"{(B, n, d, K, cov)} {tag}"] = em_gmm_case(
                f"gmm_em {(B, n, d, K, cov)} {tag}", Xb, sw, carry, cov)
        for label, (K, n, d) in EM_MODE_SHAPES.items():
            carry, consts = em_mode_inputs(device, K, n, d, dtype, seed=K + d)
            report["mvstud_em"][f"{label} {(K, n, d)} {tag}"] = em_mode_case(
                f"mvstud_em {label} {(K, n, d)} {tag}", carry, consts)
    a_inputs = a_fit_inputs(device)
    check(len(a_inputs["gmm"]) >= 1 and len(a_inputs["mode"]) == 1,
          f"A's iteration 21 ran {len(a_inputs['gmm'])} GMM and {len(a_inputs['mode'])} mode fits")
    up = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731
    for tag, cast in (("f32", lambda t: t), ("f64", up)):  # A's own inputs, in both types
        for j, (Xb, sw, carry, cov) in enumerate(a_inputs["gmm"]):
            report["gmm_em"][f"A run, round {j}, {tuple(Xb.shape)} {tag}"] = em_gmm_case(
                f"gmm_em A run round {j} {tag}", cast(Xb), cast(sw),
                {e: cast(v) for e, v in carry.items()}, cov)
        carry, consts = a_inputs["mode"][0]
        report["mvstud_em"][f"A run {tag}"] = em_mode_case(
            f"mvstud_em A run {tag}", {e: cast(v) for e, v in carry.items()},
            {e: cast(v) for e, v in consts.items()})
    for kind, cases in report.items():
        for label, r in cases.items():
            print(f"{kind} {label}: {json.dumps(r)}", flush=True)

    rows = {}
    # Times in float32: A's own fits (the rows), then the synthetic shapes;
    # then A's and B's shapes in float64 (the float64 paths').
    timings = {}
    Xb, sw, carry, cov = max(a_inputs["gmm"], key=lambda g: g[0].shape[0])
    gmm_inputs = {"A run": (Xb, sw, carry, cov)}
    for label, (B, n, d, K, cov_s) in EM_GMM_SHAPES.items():
        for dtype, tag in ((torch.float32, ""), (torch.float64, " f64")):
            gmm_inputs[label + tag] = (*em_gmm_inputs(device, B, n, d, K, cov_s, dtype, 0), cov_s)
    for label, (Xb, sw, carry, cov) in gmm_inputs.items():
        B, n, d = Xb.shape
        K, elem = carry["means"].shape[1], Xb.element_size()
        out = cluster_module._gmm_em(Xb, sw, carry, 1000, 1e-3, 1e-6, cov, None)
        iters = out["n_iter"]
        n_bytes, n_ops = em_gmm_work(B, n, d, K, int(iters.sum()), elem)
        C = cuda_em.plan(cuda_em.GMM_LIBRARY, B, n, d, K, cuda_em.COVARIANCE_CODES[cov], elem)
        chain = int(iters.max()) * EM_REDUCTIONS["gmm_em"] * red_us[C["cluster"]] / 1e3
        t = em_timing("gmm_em",
                      lambda: cluster_module._gmm_em(Xb, sw, carry, 1000, 1e-3, 1e-6, cov, None),
                      lambda: cluster_module._gmm_em_plain(Xb, sw, carry, 1000, 1e-3, 1e-6, cov,
                                                           Loops(device, {"gmm_em": 4})),
                      n_bytes, n_ops, chain, calls=11, f64=elem == 8)
        timings[f"gmm_em {label}"] = dict(t, B=B, n=n, d=d, K=K, cluster=C["cluster"],
                                          n_iter_max=int(iters.max()), n_iter_sum=int(iters.sum()))
    mode_inputs = {"A run": a_inputs["mode"][0]}
    for label, (K, n, d) in EM_MODE_SHAPES.items():
        mode_inputs[label] = em_mode_inputs(device, K, n, d, torch.float32, seed=K + d)
    for label in ("A", "B"):
        K, n, d = EM_MODE_SHAPES[label]
        mode_inputs[f"{label} f64"] = em_mode_inputs(device, K, n, d, torch.float64, seed=K + d)
    for label, (carry, consts) in mode_inputs.items():
        (n, d), K = consts["data"].shape, consts["wbar"].shape[0]
        elem = consts["data"].element_size()
        out = student_module._mode_em(carry, consts, None)
        iters = out["i"]
        n_bytes, n_ops = em_mode_work(K, n, d, int(iters.sum()), elem)
        C = cuda_em.plan(cuda_em.MVSTUD_LIBRARY, K, n, d, elem)
        chain = int(iters.max()) * EM_REDUCTIONS["mvstud_em"] * red_us[C["cluster"]] / 1e3
        t = em_timing("mvstud_em", lambda: student_module._mode_em(carry, consts, None),
                      lambda: student_module._mode_em_plain(carry, consts,
                                                            Loops(device, {"mode_em": 4})),
                      n_bytes, n_ops, chain, calls=5 if n > 100000 else 11, f64=elem == 8)
        timings[f"mvstud_em {label}"] = dict(t, K=K, n=n, d=d, cluster=C["cluster"],
                                             iterations_max=int(iters.max()),
                                             iterations_sum=int(iters.sum()))
    for label, t in timings.items():
        print(f"{label}: kernel call {t['ms']:.4f} ms, device {t['device_ms_turns'][0]:.4f} / "
              f"{t['device_ms_turns'][1]:.4f} ms; plain loop (chunks of 4) {t['plain_ms']:.4f} "
              f"ms; bound {t['bound_ms']:.5f} ms ({t['bound_by']}), reduction chain "
              f"{t['chain_bound_ms']:.4f} ms; {json.dumps({k: v for k, v in t.items() if k in ('B', 'K', 'n', 'd', 'cluster', 'n_iter_max', 'n_iter_sum', 'iterations_max', 'iterations_sum')})}",
              flush=True)
    for kind in ("gmm_em", "mvstud_em"):
        row = timings[f"{kind} A run"]
        rows[kind] = dict(row, max_abs_err=max(r["max_abs_err"] for r in report[kind].values()),
                          shapes={k[len(kind) + 1:]: v for k, v in timings.items()
                                  if k.startswith(kind)},
                          checks=report[kind], reduction_us=red_us)
    return rows


# ---------------------------------------------------------------------------
# Phase 3b: the ESS kernel's bracket mode (dynamic mode's ESS bracket)
# ---------------------------------------------------------------------------
# (label, n_particles, capacity, t_fill): dynamic mode's history as its
# path has it, 1024 x 192 with most rows masked (Bm = inf), timed; 48 rows
# filled, where the path fills up to 56, since at 48 this ladder's beta is
# 0.71 and ESS(1) still lies below the targets of a bisection; the same
# S = 196,608 all filled (both held on chip in both types); then streamed
# sizes in both types.
BRACKET_SHAPES = (("dynamic", 1024, 192, 48), ("dynamic full", 24576, 8, 8),
                  ("streamed", 65536, 8, 8), ("B", 131072, 8, 8))
BRACKET_TIMED = "dynamic"
BRACKET_ESS_RTOL = 1e-5  # a decision that differs: the plain ESS this close to the target


def check_bracket(what: str, logl, bm, scal, got, want) -> float:
    """The bracket mode's ((lo, hi), probes) against the plain version's:
    the same probes; stay and jump exact; in float64 each end within
    BETA_F64_RTOL; in float32 the same ends, or else the plain ESS at the
    first midpoint decided the other way within BETA_ESS_RTOL of the
    target, and the ends always within BETA_TOL. Returns max|d end|."""
    (bk, pk), (br, pr) = got, want
    pk, pr = int(pk.item()), int(pr.item())
    (lo_k, hi_k), (lo_r, hi_r) = bk.tolist(), br.tolist()
    err = max(abs(lo_k - lo_r), abs(hi_k - hi_r))
    msg = f"{what}: kernel ({lo_k!r}, {hi_k!r}) {pk} probes, plain ({lo_r!r}, {hi_r!r}) {pr}"
    check(pk == pr, msg)
    if pr == 2 or err == 0.0:
        check(err == 0.0, msg)
        return err
    if bk.dtype == torch.float64:
        check(abs(lo_k - lo_r) <= BETA_F64_RTOL * abs(lo_r)
              and abs(hi_k - hi_r) <= BETA_F64_RTOL * abs(hi_r), msg)
        return err
    check(err < BETA_TOL, msg)
    target = float(scal[1])
    lo, hi = scal[0].cpu(), torch.ones((), dtype=bk.dtype)
    for _ in range(pr - 2):
        mid = 0.5 * (lo + hi)
        up_k, up_r = lo_k >= float(mid), lo_r >= float(mid)
        if up_k != up_r:
            off = abs(ess_of(logl, bm, float(mid)) - target)
            check(off <= BRACKET_ESS_RTOL * abs(target), f"{msg}; decided the other way at "
                  f"{float(mid)!r}, whose plain ESS is {off:.3g} from the target")
            return err
        lo, hi = (mid, hi) if up_r else (lo, mid)
    fail(f"{msg}: the brackets differ with no decision taken the other way")


def phase_bracket_kernel(device) -> dict:
    """tempest_ess_bracket (_f64) against its plain version, the
    "ess_bracket" loop on the same CUDA tensors, at BRACKET_SHAPES in
    float32 and float64 (stay, jump and three bisections each), two launches
    the same bits; its times on dynamic mode's history in float32."""
    plain = reweight_step.ess_bracket_loop
    max_err, row = 0.0, None
    for dtype in (torch.float32, torch.float64):
        for label, n_particles, capacity, t_fill in BRACKET_SHAPES:
            hist = synthetic_history(device, n_particles, capacity, t_fill, seed=capacity,
                                     dtype=dtype)
            _, logl, bm = kernel_inputs(hist)
            S = logl.numel()
            beta_prev = float(hist.beta[t_fill // 2])
            ess_cur, ess_one = ess_of(logl, bm, beta_prev), ess_of(logl, bm, 1.0)
            cases = [("stay", beta_prev, 1.5 * ess_cur), ("jump", beta_prev, 0.5 * ess_one),
                     ("bisect", beta_prev, math.sqrt(ess_cur * ess_one)),
                     ("bisect", 0.0, 2.0 * n_particles), ("bisect", beta_prev, 0.9 * ess_cur)]
            for kind, bp, target in cases:
                scal = torch.tensor([bp, target], dtype=dtype, device=device)
                got = cuda_reweight.ess_bracket(logl, bm, scal)
                again = cuda_reweight.ess_bracket(logl, bm, scal)
                want = plain(logl, bm, scal)
                torch.cuda.synchronize()
                check(torch.equal(_bits(got[0]), _bits(again[0])),
                      f"ess_bracket S={S} {kind}: two launches differ")
                check((int(want[1].item()) > 2) == (kind == "bisect"),
                      f"ess_bracket S={S} {kind}: the plain version took {int(want[1].item())} "
                      "probes")
                err = check_bracket(f"ess_bracket {str(dtype)[6:]} S={S} {kind}", logl, bm, scal,
                                    got, want)
                if dtype == torch.float32:
                    max_err = max(max_err, err)
                print(f"ess bracket {str(dtype)[6:]} S={S} [{_route(S, dtype)}] {kind}: "
                      f"beta_prev={bp:.6g} target={target:.6g} kernel={got[0].tolist()} "
                      f"({int(got[1].item())} probes) plain={want[0].tolist()} "
                      f"({int(want[1].item())} probes)", flush=True)
            if label != BRACKET_TIMED or dtype != torch.float32:
                continue
            scal = torch.tensor([beta_prev, math.sqrt(ess_cur * ess_one)], device=device)
            probes = int(plain(logl, bm, scal)[1].item())
            kernel = lambda: cuda_reweight.ess_bracket(logl, bm, scal)  # noqa: E731
            t = timed_in_turns({"kernel": kernel})
            t.update(timed_in_turns({"plain": lambda: plain(logl, bm, scal)}, calls=10))
            dev = device_ms(kernel, "ess_bracket_kernel")
            # logl and Bm read once, scal read, (lo, hi) and the probe count written.
            b_ms, b_by = bound(8 * S + 20, *work((S * probes, ESS_SAMPLE_PROBE["f32"])))
            row = dict(S=S, filled=f"{t_fill} of {capacity} rows", probes=probes,
                       launch_plan=_route(S), ms=t["kernel"], device_ms=dev,
                       plain_ms=t["plain"], bound_ms=b_ms, bound_by=b_by, library_ms=None)
            print(f"ess bracket timing S={S} ({label}, {probes} probes, {_route(S)}): kernel call "
                  f"{t['kernel']:.4f} ms device {dev:.4f} ms; plain {t['plain']:.4f} ms; bound "
                  f"{b_ms:.5f} ms ({b_by})", flush=True)
    check(row is not None, f"no bracket timing on the {BRACKET_TIMED!r} history")
    row["max_abs_err"] = max_err
    return row


def phase_call_split(device) -> dict:
    """One synchronized call of each kernel split into its parts."""
    key = philox.key_from_seed(2024)
    hist = synthetic_history(device, N_PARTICLES, CAPACITY, 40, seed=CAPACITY)
    _, logl, bm = kernel_inputs(hist)
    scal = torch.tensor([float(hist.beta[20]), 1.1 * N_PARTICLES], device=device)
    R, N, d = MUTATION_SHAPES[0]
    alpha = torch.full((N,), 2.5, device=device)
    alpha_b = torch.full((B_GAMMA,), GAMMA_TIMED_ALPHA, device=device)
    split = {}
    if hasattr(cuda_prng, "PhiloxCounter"):  # a draws object's launches: the call counter's words
        words = cuda_prng.PhiloxCounter(key, device)
        split.update({
            "mutation_draws_counter": call_split(
                "mutation_draws 8x1024x10 (call counter)",
                lambda: words.mutation_draws(0, alpha, (R, N, d)), cuda_prng.LIBRARY,
                "tempest_mutation_draws", "mutation_draws_kernel"),
            "normal_counter": call_split(
                f"normal n={B_GAMMA} (call counter)",
                lambda: words.normal(13, (B_GAMMA,)), cuda_prng.LIBRARY,
                "tempest_normal", "normal_kernel"),
            "gamma_counter": call_split(
                f"gamma n={B_GAMMA} (call counter)", lambda: words.gamma(0, alpha_b),
                cuda_prng.LIBRARY, "tempest_gamma", "gamma_"),
        })
    return {**split,
        "ess_bisect": call_split(
            "ess_bisect S=65536", lambda: cuda_reweight.ess_bisect_beta(logl, bm, scal),
            cuda_reweight.LIBRARY, "tempest_ess_bisect", "ess_bisect"),
        "mutation_draws": call_split(
            "mutation_draws 8x1024x10",
            lambda: cuda_prng.hw_mutation_draws(key, 1, alpha, (R, N, d)),
            cuda_prng.LIBRARY, "tempest_mutation_draws", "mutation_draws_kernel"),
        "normal": call_split(
            f"normal n={B_GAMMA}", lambda: cuda_prng.hw_normal(key, 2, (B_GAMMA,), device),
            cuda_prng.LIBRARY, "tempest_normal", "normal_kernel"),
        "bits": call_split(
            f"bits n={B_GAMMA}", lambda: cuda_prng.hw_bits(key, 3, (B_GAMMA,), device),
            cuda_prng.LIBRARY, "tempest_bits", "bits_kernel"),
        "gamma": call_split(
            f"gamma n={B_GAMMA}", lambda: cuda_prng.hw_gamma(key, 10, alpha_b),
            cuda_prng.LIBRARY, "tempest_gamma", "gamma_"),
    }


def launch_floor(device) -> dict:
    """The least a launch costs: a bits kernel on 4 words, as a synchronized
    host-timed call and as device time per launch."""
    key = philox.key_from_seed(2024)
    fn = lambda: cuda_prng.hw_bits(key, 0, (4,), device)  # noqa: E731
    floor = {"call_ms": timed_in_turns({"bits4": fn})["bits4"],
             "device_ms": device_ms(fn, "bits_kernel")}
    print(f"launch floor (bits kernel, 4 words): call {floor['call_ms']:.4f} ms, device "
          f"{floor['device_ms']:.4f} ms per launch", flush=True)
    return floor


# ---------------------------------------------------------------------------
# Phases 5-10: the paths
# ---------------------------------------------------------------------------
def canonical_sampler(device, seed, clustering, hardware_prng=False, dtype=torch.float32):
    return Sampler(prior_transform, rosenbrock, n_dim=N_DIM, n_particles=N_PARTICLES,
                   vectorize=True, clustering=clustering, hardware_prng=hardware_prng,
                   history_capacity=CAPACITY, random_state=seed, dtype=dtype, device=device)


def mcmc_steps(s) -> int:
    """MCMC steps over the run's mutation iterations (beta > 0)."""
    res = s.results()
    return int(res["steps"][res["beta"] > 0].sum())


def mcmc_bodies(s) -> int:
    """MCMC step bodies run in the sampler's life: its steps, and on the
    fused route the steps a chunk ran past the stop (whose draws are put
    back); a draws kernel launches once a body."""
    return int(s.state._iteration.loops.stats["mcmc"]["bodies"])


def run_canonical(device, name, seeds, clustering, hardware_prng, logz_band,
                  dtype=torch.float32, on_device=False, runs=None) -> dict:
    """Seeds of A (or the unclustered problem) after a warm-up: each in the
    band, one launch of the ESS kernel of its dtype per reweight, and the
    mutation-draws kernel once per MCMC step where it applies
    (hardware_prng with float32); no other kernel. `runs`, if given,
    receives each seed's results, wall and launches."""
    s = canonical_sampler(device, 7, clustering, hardware_prng, dtype)
    ess_key, other = ("ess_bisect_f64", "ess_bisect") if dtype == torch.float64 else (
        "ess_bisect", "ess_bisect_f64")
    draws_kernel = hardware_prng and dtype == torch.float32
    for _ in range(8):  # warm-up: allocator, libraries, kernels, a clustered fit
        s.sample()
    reset_counts()
    walls, effs = [], []
    for seed in seeds:
        s.reset(random_state=seed)
        before, fits, gmm_fits = counts(), MODE_FITS, GMM_FITS
        loops_before = loop_stats(s)
        bodies = mcmc_bodies(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run(n_total=N_TOTAL, progress=False, on_device=on_device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched, fits, gmm_fits = diff(counts(), before), MODE_FITS - fits, GMM_FITS - gmm_fits
        loops_run = {k: {c: v.get(c, 0) - loops_before.get(k, {}).get(c, 0) for c in v}
                     for k, v in loop_stats(s).items()}
        bodies = mcmc_bodies(s) - bodies
        if runs is not None:
            runs[seed] = dict(results=s.results(), logz=s.evidence()[0], wall=wall,
                              launches=launched, iters=s.state.hist.t, bodies=bodies,
                              draws=s.state.draws.get_state())
        ess = s.state.posterior_ess()
        logz, _ = s.evidence()
        iters = s.state.hist.t
        steps = mcmc_steps(s)
        k = int(s.state.cluster_model.n_clusters())
        walls.append(wall)
        effs.append(ess / wall)
        print(f"{name} seed {seed}: wall={wall:.3f} s ess={ess:.1f} eff/s={ess / wall:.1f} "
              f"iters={iters} clusters={k} logz={logz:.4f} beta={s.beta:.6f} calls={s.calls} "
              f"mcmc_steps={steps} mcmc_bodies={bodies} mode_fits={fits} gmm_em_loops={gmm_fits} "
              f"launches={launched}", flush=True)
        check_em_launches(f"{name} seed {seed}", launched, fits, gmm_fits, loops_run)
        check(cuda_median is None or launched["weighted_median"] == fits > 0,
              f"{name} seed {seed}: {launched.get('weighted_median')} weighted-median launches "
              f"for {fits} mode fits")
        check(s.beta >= 1.0 - 1e-4, f"{name} seed {seed}: beta {s.beta} < 1 - 1e-4")
        check(ess >= N_TOTAL, f"{name} seed {seed}: posterior ESS {ess} < {N_TOTAL}")
        check(abs(logz - logz_band[0]) <= logz_band[1],
              f"{name} seed {seed}: logZ {logz} outside {logz_band[0]} +/- {logz_band[1]}")
        check(launched[ess_key] == iters - 1 and launched[other] == 0,
              f"{name} seed {seed}: {launched[ess_key]} {ess_key} launches for {iters - 1} "
              f"reweights at t >= 1, {launched[other]} {other}")
        if draws_kernel:  # a launch a step run (a chunk runs past the stop)
            check(launched["mutation_draws"] == bodies >= steps,
                  f"{name} seed {seed}: {launched['mutation_draws']} mutation-draws launches "
                  f"for {bodies} MCMC bodies ({steps} steps)")
        check(launched["normal"] == 0 and launched["bits"] == 0 and launched["gamma"] == 0
              and (draws_kernel or launched["mutation_draws"] == 0),
              f"{name} seed {seed}: unexpected PRNG launches {launched}")
        check(cuda_linalg is None or launched["sym_eigvals"] == iters - 1,
              f"{name} seed {seed}: {launched.get('sym_eigvals')} eigenvalue launches for "
              f"{iters - 1} reweights (one CV each)")
    total = counts()
    print(f"{name}: mean wall {sum(walls) / len(walls):.3f} s, mean eff/s "
          f"{sum(effs) / len(effs):.1f}, launches {total}", flush=True)
    return total, dict(zip(seeds, walls))


# CUDA runtime calls that block the host until the device has caught up.
BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
                  "cudaMemcpy", "cudaMemcpy2D")
# A steady fused iteration: at most one read a loop chunk plus this many (beta
# and the termination test; the CV's eigenvalues are the kernel's, which reads
# nothing, where torch.linalg.eigvalsh made two reads: cuSOLVER's own sync and
# its error check), and fewer than MAX_READS in all.
READS_BESIDE_CHUNKS, MAX_READS = 2, 150
# The kernels a window reports, (device ms, launches) an iteration: the
# TOP_KERNELS by time, and the ESS and eigenvalue kernels.
TOP_KERNELS = 8
# torch.linalg.eigvalsh's operators: none may run in a fused iteration.
EIGH_OPS = ("aten::linalg_eigh", "aten::_linalg_eigh", "aten::linalg_eigvalsh")


def loop_stats(s) -> dict:
    """The fused loops' counters of sampler `s`, by loop."""
    return {k: dict(v) for k, v in sorted(s.state._iteration.loops.stats.items())}


def _under(event, name: str) -> bool:
    """Whether a profiler event ran inside the range `name`."""
    parent = event.cpu_parent
    while parent is not None:
        if parent.name == name:
            return True
        parent = parent.cpu_parent
    return False


def steady_window(s, graphs: bool, first: int = 21, n: int = 5,
                  device_only: bool = True, n_total: int = N_TOTAL) -> dict:
    """Iterations first..first+n-1 of sampler `s` (A, reset to seed 42) in
    one mode, under torch.profiler with host and device activities: wall
    per iteration, device busy time and idle share, blocking host reads
    (BLOCKING_CALLS) per iteration, the loops' chunk reads in the window,
    and the device ms an iteration of each kernel; then, if `device_only`,
    the next n iterations traced on the device only (no host ops
    recorded). A sampler whose graphs were captured replays them."""
    from torch.profiler import ProfilerActivity, profile, record_function

    s.reset(random_state=SEEDS[0])
    core = s.state
    core.n_total = n_total
    core._pregrow_capacity()
    loops = core._iteration.loops
    loops.graphs = graphs
    try:
        for _ in range(first - 1):
            core._step(None, 0)
        torch.cuda.synchronize()
        before = {k: dict(v) for k, v in loops.stats.items()}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function("steady"):
                for _ in range(n):
                    core._step(None, 0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        reads = {k: v.get("reads", 0) - before.get(k, {}).get("reads", 0)
                 for k, v in loops.stats.items()}
        if device_only:
            with profile(activities=[ProfilerActivity.CUDA]) as prof_device:
                t0 = time.perf_counter()
                for _ in range(n):
                    core._step(None, 0)
                torch.cuda.synchronize()
                wall_device = time.perf_counter() - t0
    finally:
        loops.graphs = False
    # The blocking calls the iterations made: those inside the "steady" range
    # (not the window's closing synchronize, nor the profiler's own).
    blocking, eigh = {}, 0
    for e in prof.events():
        if e.name in BLOCKING_CALLS and _under(e, "steady"):
            blocking[e.name] = blocking.get(e.name, 0) + 1
        eigh += e.name in EIGH_OPS and _under(e, "steady")
    events = prof.key_averages()
    device_ms = sum(_self_device_us(e) for e in events
                    if e.device_type == DeviceType.CUDA and not e.key.startswith("ps/")) / 1e3
    stages = {}  # host ms an iteration in each stage range (its reads included)
    for e in events:
        if e.key.startswith("ps/"):
            stages[e.key] = max(stages.get(e.key, 0.0), e.cpu_time_total / 1e3 / n)
    chunk_reads = sum(v for k, v in reads.items() if k != "beta")
    kernels = {e.key: (_self_device_us(e) / 1e3 / n, e.count / n) for e in events
               if e.device_type == DeviceType.CUDA and not e.key.startswith("ps/")
               and _self_device_us(e) > 0}
    out = dict(graphs=graphs, first=first, n=n, wall_per_iter=wall / n,
               device_ms_per_iter=device_ms / n, idle=1.0 - device_ms / (1e3 * wall),
               blocking_per_iter=sum(blocking.values()) / n, blocking=blocking,
               chunk_reads_per_iter=chunk_reads / n, reads=reads, eigh_ops=eigh,
               stages_ms=stages, kernels={
                   k: v for i, (k, v) in enumerate(sorted(kernels.items(), key=lambda kv: -kv[1][0]))
                   if i < TOP_KERNELS or any(p in k for p in ("sym_eigvals", "ess_bisect",
                                                              "ess_bracket"))})
    if device_only:
        device_only_ms = sum(_self_device_us(e) for e in prof_device.key_averages()
                             if e.device_type == DeviceType.CUDA) / 1e3
        out["device_only"] = dict(wall_per_iter=wall_device / n,
                                  device_ms_per_iter=device_only_ms / n,
                                  idle=1.0 - device_only_ms / (1e3 * wall_device))
    return out


def phase_fused(device, ref: dict) -> dict:
    """6b: A's seed 42 with run(on_device=True) against phase 6's seed 42,
    then both modes' steady iterations under the profiler."""
    s = canonical_sampler(device, SEEDS[0], clustering=True)
    s.run(n_total=N_TOTAL, progress=False, on_device=True)  # warm-up: captures the graphs
    warm = loop_stats(s)
    # The run that captured its graphs repeats phase 6's seed 42 too.
    for name in ("beta", "logz", "steps", "calls"):
        check(s.results()[name].tobytes() == ref[SEEDS[0]]["results"][name].tobytes(),
              f"A fused seed {SEEDS[0]} (capturing): {name} differs from on_device=False")
    s.reset(random_state=SEEDS[0])
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(n_total=N_TOTAL, progress=False, on_device=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    res, logz, iters = s.results(), s.evidence()[0], s.state.hist.t
    eager = ref[SEEDS[0]]
    stats = loop_stats(s)
    timed = {k: {c: v.get(c, 0) - warm.get(k, {}).get(c, 0) for c in v} for k, v in stats.items()}
    print(f"A fused seed {SEEDS[0]}: wall={wall:.3f} s iters={iters} "
          f"({1e3 * wall / iters:.1f} ms an iteration; on_device=False "
          f"{eager['wall']:.3f} s, {1e3 * eager['wall'] / eager['iters']:.1f} ms) logz={logz!r} "
          f"(on_device=False {eager['logz']!r}) beta={s.beta} launches={launched}", flush=True)
    print(f"A fused loops in the timed run (captures, replays, reads): {json.dumps(timed)}; "
          f"in the warm-up run: {json.dumps(warm)}", flush=True)
    for name in ("beta", "logz", "steps", "calls"):
        check(res[name].tobytes() == eager["results"][name].tobytes(),
              f"A fused: {name} differs from on_device=False: {res[name].tolist()} against "
              f"{eager['results'][name].tolist()}")
    check(logz == eager["logz"], f"A fused: logZ {logz!r} against {eager['logz']!r}")
    check(abs(logz - CLUSTERED_LOGZ[0]) <= CLUSTERED_LOGZ[1],
          f"A fused: logZ {logz} outside {CLUSTERED_LOGZ[0]} +/- {CLUSTERED_LOGZ[1]}")
    check(launched == eager["launches"],
          f"A fused: launches {launched} against on_device=False {eager['launches']}")
    check(all(v.get("captures", 0) == 0 for v in timed.values()),
          f"A fused: the timed run recaptured: {timed}")
    check(timed["mcmc"]["replays"] > 0 and timed["mode_em"]["replays"] > 0,
          f"A fused: no replays {timed}")

    return dict(launches=launched, wall=wall, iters=iters, loops=timed,
                windows=steady_windows(s, "A"))


def steady_windows(s, name: str, n: int = 3, device_only: bool = True) -> dict:
    """Iterations 21 to 20 + n of A's seed 42 on sampler `s` in each mode
    under the profiler; at most one blocking host read a loop chunk plus
    READS_BESIDE_CHUNKS an iteration, and fewer than MAX_READS."""
    windows = {}
    for graphs in (False, True):
        w = windows["on_device=True" if graphs else "on_device=False"] = steady_window(
            s, graphs, n=n, device_only=device_only)
        trace = ""
        if device_only:
            trace = (f"; iterations {21 + n}-{20 + 2 * n} with device activities only: "
                     f"{1e3 * w['device_only']['wall_per_iter']:.1f} ms an iteration, device "
                     f"{w['device_only']['device_ms_per_iter']:.1f} ms (idle "
                     f"{100 * w['device_only']['idle']:.1f} %)")
        print(f"{name} seed {SEEDS[0]} iterations 21-{20 + n} under the profiler, "
              f"{'graphs' if graphs else 'no graphs'}: {1e3 * w['wall_per_iter']:.1f} ms an "
              f"iteration, device {w['device_ms_per_iter']:.1f} ms (idle "
              f"{100 * w['idle']:.1f} %), blocking host reads {w['blocking_per_iter']:.1f} an "
              f"iteration {w['blocking']}, loop chunk reads {w['chunk_reads_per_iter']:.1f} an "
              f"iteration {w['reads']}, eigvalsh operators {w['eigh_ops']}; stage ms an "
              f"iteration {json.dumps({k: round(v, 3) for k, v in w['stages_ms'].items()})}"
              f"{trace}", flush=True)
        check_window(f"{name} {'graphs' if graphs else 'no graphs'}", w)
    return windows


def check_window(name: str, w: dict) -> None:
    """6b's rule: at most one blocking host read a loop chunk plus
    READS_BESIDE_CHUNKS an iteration, fewer than MAX_READS, and no
    torch.linalg.eigvalsh operator."""
    check(w["blocking_per_iter"] <= w["chunk_reads_per_iter"] + READS_BESIDE_CHUNKS
          and w["blocking_per_iter"] < MAX_READS,
          f"{name}: {w['blocking_per_iter']} blocking reads an iteration for "
          f"{w['chunk_reads_per_iter']} chunk reads")
    check(cuda_linalg is None or w["eigh_ops"] == 0,
          f"{name}: {w['eigh_ops']} torch.linalg.eigvalsh operators in the window")
    em_reads = {k: w["reads"].get(k, 0) for k in ("mode_em", "gmm_em")}
    check(cuda_em is None or not any(em_reads.values()),
          f"{name}: EM chunk reads in the window {em_reads}")


def phase_hardware_prng(device) -> dict:
    """7: A with hardware_prng=True, seed 42, with run(on_device=False), then
    with run(on_device=True) on a sampler whose seed-43 run captured the
    graphs: the ladder, logZ, steps, calls, launches and the draws' final
    state (generator, Philox key and call counter, host mirror and device
    words) equal bit for bit; one mutation-draws launch a step body in
    both; then the steady windows of both modes."""
    eager = {}
    launches, walls = run_canonical(device, "A clustered hardware_prng", SEEDS[:1], True, True,
                                    CLUSTERED_LOGZ, runs=eager)
    eager = eager[SEEDS[0]]
    s = canonical_sampler(device, SEEDS[1], clustering=True, hardware_prng=True)
    s.run(n_total=N_TOTAL, progress=False, on_device=True)  # warm-up: captures the graphs
    warm = loop_stats(s)
    s.reset(random_state=SEEDS[0])
    reset_counts()
    bodies = mcmc_bodies(s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(n_total=N_TOTAL, progress=False, on_device=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched, bodies = counts(), mcmc_bodies(s) - bodies
    res, logz, iters = s.results(), s.evidence()[0], s.state.hist.t
    stats = loop_stats(s)
    timed = {k: {c: v.get(c, 0) - warm.get(k, {}).get(c, 0) for c in v} for k, v in stats.items()}
    draws = s.state.draws
    words = draws.calls.read()
    print(f"A hardware_prng fused seed {SEEDS[0]}: wall={wall:.3f} s iters={iters} "
          f"({1e3 * wall / iters:.1f} ms an iteration; on_device=False {eager['wall']:.3f} s, "
          f"{1e3 * eager['wall'] / eager['iters']:.1f} ms) logz={logz!r} (on_device=False "
          f"{eager['logz']!r}) mcmc_bodies={bodies} (on_device=False {eager['bodies']}) "
          f"launches={launched}; call counter {draws.counter}, device words {words}", flush=True)
    print(f"A hardware_prng fused loops in the timed run: {json.dumps(timed)}", flush=True)
    for name in ("beta", "logz", "steps", "calls"):
        check(res[name].tobytes() == eager["results"][name].tobytes(),
              f"A hardware_prng fused: {name} differs from on_device=False")
    check(logz == eager["logz"] and abs(logz - CLUSTERED_LOGZ[0]) <= CLUSTERED_LOGZ[1],
          f"A hardware_prng fused: logZ {logz!r} against {eager['logz']!r}")
    check(launched == eager["launches"] and bodies == eager["bodies"]
          and launched["mutation_draws"] == bodies,
          f"A hardware_prng fused: launches {launched} ({bodies} bodies) against "
          f"on_device=False {eager['launches']} ({eager['bodies']} bodies)")
    state = draws.get_state()
    check(all(state[k].tobytes() == eager["draws"][k].tobytes() for k in eager["draws"])
          and words == (draws.counter, draws.key),
          f"A hardware_prng fused: final draw state {state['philox_counter']} / words {words} "
          f"against on_device=False {eager['draws']['philox_counter']}")
    check(timed["mcmc"].get("replays", 0) > 0 and all(
        v.get("captures", 0) == 0 for v in timed.values()),
          f"A hardware_prng fused: replays and captures {timed}")
    # Three iterations, host and device traced, on this sampler's graphs:
    # the profiler's own cost keeps the window short.
    windows = steady_windows(s, "A hardware_prng", n=3, device_only=False)
    return dict(launches=launches, launches_fused=launched, wall=wall, wall_eager=eager["wall"],
                iters=iters, iters_eager=eager["iters"], loops=timed, windows=windows)


def run_b(device, dtype, name: str, graphs: bool = False, s=None):
    """B's iterations up to its B_MUTATIONS-th mutation, from a fresh sampler
    (or `s`, reset to seed 42), with the loops' CUDA graphs on if `graphs`
    (what run(on_device=True) turns on, core.py:225): per iteration its
    number, wall, beta, logZ, MCMC steps and step bodies, acceptance, kernel
    launches and the call counter after it; the counts are set to 0 first.
    Returns (sampler, rows)."""
    if s is None:
        s = Sampler(prior_transform, half_square, n_dim=N_DIM, n_particles=B_PARTICLES,
                    vectorize=True, clustering=False, hardware_prng=True,
                    history_capacity=B_CAPACITY, random_state=42, dtype=dtype, device=device)
    else:
        s.reset(random_state=42)
    loops = s.state._iteration.loops
    reset_counts()
    rows, mutations = [], 0
    loops.graphs = graphs
    try:
        while mutations < B_MUTATIONS:
            check(len(rows) < B_CAPACITY, f"{name}: {len(rows)} iterations and only {mutations} "
                  "mutations")
            before, bodies, fits = counts(), mcmc_bodies(s), MODE_FITS
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = s.sample()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched, bodies = diff(counts(), before), mcmc_bodies(s) - bodies
            fits = MODE_FITS - fits
            print(f"{name} iteration {out['iter']}: {wall:.3f} s beta={out['beta']:.6g} "
                  f"steps={out['steps']} bodies={bodies} acceptance={out['acceptance']:.4f} "
                  f"mode_fits={fits} launches={launched}", flush=True)
            rows.append(dict(iter=int(out["iter"]), wall=wall, beta=out["beta"], logz=out["logz"],
                             steps=int(out["steps"]), bodies=bodies,
                             acceptance=out["acceptance"], launches=launched, fits=fits,
                             counter=getattr(s.state.draws, "counter", None)))
            mutations += out["beta"] > 0.0
    finally:
        loops.graphs = False
    return s, rows


def profile_b(s, n_before: int) -> None:
    """B's last mutation iteration, graphed, under torch.profiler after the
    ones before it: wall, device time and idle share, and the host ops and
    device kernels that take the most time."""
    from torch.profiler import ProfilerActivity, profile

    s.reset(random_state=42)
    loops = s.state._iteration.loops
    loops.graphs = True
    try:
        for _ in range(n_before):
            s.sample()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = s.sample()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        loops.graphs = False
    events = prof.key_averages()
    dev = [(e.key, _self_device_us(e) / 1e3) for e in events
           if e.device_type == DeviceType.CUDA and not e.key.startswith("ps/")]
    device_ms = sum(ms for _, ms in dev)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3) for e in events
                   if e.device_type == DeviceType.CPU and not e.key.startswith("ps/")),
                  key=lambda kv: -kv[1])[:8]
    stages = sorted(((e.key, e.cpu_time_total / 1e3) for e in events if e.key.startswith("ps/")),
                    key=lambda kv: -kv[1])
    top = sorted(dev, key=lambda kv: -kv[1])[:6]
    median_ms = sum(ms for k, ms in dev if "weighted_median" in k)
    scan_ms = sum(ms for k, ms in dev if "scan_outer_dim" in k)
    print(f"B graphed iteration {out['iter']} under the profiler: {1e3 * wall:.1f} ms, device "
          f"{device_ms:.1f} ms (idle {100 * (1 - device_ms / (1e3 * wall)):.1f} %); stages "
          f"{', '.join(f'{k} {v:.1f} ms' for k, v in stages)}; host self time "
          f"{', '.join(f'{k} {v:.1f} ms' for k, v in host)}; device "
          f"{', '.join(f'{k[:60]} {v:.2f} ms' for k, v in top)}; weighted_median kernel "
          f"{median_ms:.4f} ms, torch.cumsum's outer-dimension scan {scan_ms:.4f} ms", flush=True)
    return {"wall_ms": 1e3 * wall, "device_ms": device_ms, "weighted_median_ms": median_ms,
            "scan_outer_dim_ms": scan_ms}


def phase_large_ensemble(device, dtype=torch.float32) -> dict:
    """B: the first four mutation iterations at N = 131,072; in float32
    eagerly and with the loops' CUDA graphs (a first pass captures them, a
    second is timed), the same values and launches bit for bit, one normal
    and one gamma launch a step body; in float64 no PRNG kernel runs
    (hardware_prng does not apply) and the ESS kernel is the float64 one."""
    f64 = dtype == torch.float64
    name = "B float64" if f64 else "B"
    s, rows = run_b(device, dtype, name)
    total = counts()  # the eager run's: run_b set the counts to 0 before it
    graphed = None
    if not f64:
        g, _ = run_b(device, dtype, "B graphed (capturing)", graphs=True)
        g, graphed = run_b(device, dtype, "B graphed", graphs=True, s=g)
        for a, b in zip(rows, graphed):
            for k in ("iter", "beta", "logz", "steps", "bodies", "acceptance", "launches",
                      "fits", "counter"):
                check(a[k] == b[k], f"B graphed iteration {a['iter']}: {k} {b[k]!r} against "
                      f"eager {a[k]!r}")
        check(len(rows) == len(graphed), f"B graphed: {len(graphed)} iterations, {len(rows)} eager")
        check(g.state.draws.calls.read() == (g.state.draws.counter, g.state.draws.key),
              "B graphed: the call counter's device words and host mirror differ")
        profiled = profile_b(g, len(graphed) - 1)
        mut = [(a["wall"], b["wall"]) for a, b in zip(rows, graphed) if a["beta"] > 0.0]
        print(f"B seconds a mutation iteration, eager / graphed: "
              f"{', '.join(f'{a:.4f} / {b:.4f}' for a, b in mut)}; mean "
              f"{sum(a for a, _ in mut) / len(mut):.4f} / {sum(b for _, b in mut) / len(mut):.4f}",
              flush=True)
    betas = []
    for row in rows:
        if row["beta"] == 0.0:
            continue
        launched, bodies = row["launches"], row["bodies"]
        if f64:
            check(all(launched[k] == 0 for k in cuda_prng.LAUNCHES),
                  f"{name}: PRNG launches {launched} (hardware_prng does not apply)")
        else:
            check(launched["normal"] == bodies and launched["gamma"] == bodies
                  and bodies >= row["steps"] and launched["bits"] == 0
                  and launched["mutation_draws"] == 0,
                  f"B: launches {launched} for {bodies} MCMC step bodies (want 1 normal + 1 "
                  "gamma a body)")
        check(cuda_median is None or row["launches"]["weighted_median"] == row["fits"],
              f"{name} iteration {row['iter']}: {row['launches'].get('weighted_median')} "
              f"weighted-median launches for {row['fits']} mode fits")
        check(row["acceptance"] > 0.1, f"{name}: acceptance {row['acceptance']}")
        check(not betas or row["beta"] > betas[-1], f"{name}: beta did not rise: {betas}")
        betas.append(row["beta"])
    errs = {}

    if not f64:
        # The normal kernel at this path's R*N*d (several grid-stride passes
        # per thread) against its plain version.
        z_shape = (N_PROPOSAL_CANDIDATES, B_PARTICLES, N_DIM)
        n_z = math.prod(z_shape)
        key = philox.key_from_seed(2024)
        z = cuda_prng.hw_normal(key, 20, z_shape, device).reshape(-1)
        err_n = float(torch.max(torch.abs(z - philox.normal(key, 20, n_z, device))))
        print(f"B: normal kernel at n={n_z}: max|dz|={err_n:.3g} against its plain version",
              flush=True)
        check(err_n <= DRAW_TOL, f"B: normal kernel differs from plain by {err_n} at n={n_z}")
        errs["normal"] = err_n

    # The ESS kernel at the S this history reached, against its plain version.
    hist = s.state.hist
    _, logl, bm = kernel_inputs(hist)
    S = logl.numel()
    beta_prev = float(s.state.cur.beta)
    scal = torch.tensor([beta_prev, 2.0 * B_PARTICLES], dtype=dtype, device=device)
    beta_k, probes_k = cuda_reweight.ess_bisect_beta(logl, bm, scal)
    beta_r, probes_r = cuda_reweight.ess_bisect_beta_reference(logl, bm, scal)
    bk, br, probes = beta_k.item(), beta_r.item(), int(probes_k.item())
    print(f"{name}: ESS kernel at S={S} [{_route(S, dtype)}]: beta_prev={beta_prev:.6g} "
          f"kernel={bk!r} ({probes} probes) plain={br!r} ({probes_r.item()} probes)", flush=True)
    if f64:
        check_beta_f64(f"{name}: ESS kernel at S={S}", bk, probes, br, int(probes_r.item()))
    else:
        check_beta(f"B: ESS kernel at S={S}", logl, bm, beta_prev, 2.0 * B_PARTICLES, bk, probes,
                   br, int(probes_r.item()))
    errs["ess_bisect_f64" if f64 else "ess_bisect"] = abs(bk - br)
    t = timed_in_turns({
        "kernel": lambda: cuda_reweight.ess_bisect_beta(logl, bm, scal),
        "plain": lambda: cuda_reweight.ess_bisect_beta_reference(logl, bm, scal),
    }, calls=10)
    print(f"{name}: ESS kernel at S={S} (t={hist.t}, {probes} probes): kernel {t['kernel']:.4f} ms, "
          f"plain {t['plain']:.4f} ms (median of 10); launches {total}", flush=True)
    return total, errs, dict(eager=rows, graphed=graphed, profiled=None if f64 else profiled)


def phase_bimodal(device) -> dict:
    """C: tests/test_multimodal.py's 10-D mixture, clustered, on the card."""
    s = Sampler(prior_transform, bimodal, n_dim=N_DIM, n_particles=256, vectorize=True,
                clustering=True, k_max=8, history_capacity=64, random_state=4, device=device)
    reset_counts()
    t0 = time.perf_counter()
    s.run(n_total=512, progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k = int(s.state.cluster_model.n_clusters())
    x, w, _ = s.posterior()
    mass = float(np.sum(w[x[:, 0] > 0]))
    logz, _ = s.evidence()
    analytic = -N_DIM * math.log(20.0)
    print(f"bimodal 10-D: wall={wall:.3f} s clusters={k} mass(x0>0)={mass:.4f} logz={logz:.4f} "
          f"(analytic {analytic:.4f}) beta={s.beta:.6f} launches={counts()}", flush=True)
    check(k >= 2, f"bimodal: {k} cluster(s)")
    check(0.3 < mass < 0.7, f"bimodal: mass {mass}")
    check(abs(logz - analytic) < 0.5, f"bimodal: logZ {logz} vs {analytic}")
    check(cuda_reweight.LAUNCHES > 0, "bimodal: no ESS kernel launch")
    return counts()


def phase_gaussian(device) -> dict:
    s = Sampler(prior_transform, gaussian, n_dim=N_DIM, n_particles=512, vectorize=True,
                clustering=False, random_state=0, history_capacity=64, device=device)
    reset_counts()
    s.run(n_total=2048, progress=False, on_device=True)
    logz, _ = s.evidence()
    x, w, _ = s.posterior()
    mean = np.average(x, axis=0, weights=w)
    var = np.average((x - mean) ** 2, axis=0, weights=w)
    acc = float(s.state.cur.acceptance)
    analytic = -N_DIM * math.log(20.0)
    print(f"gaussian 10-D: logz={logz:.4f} (analytic {analytic:.4f}) beta={s.beta:.6f} "
          f"max|mean|={np.abs(mean).max():.4f} max|var-1|={np.abs(var - 1).max():.4f} "
          f"acceptance={acc:.4f} launches={counts()}", flush=True)
    check(s.beta > 0.99, f"gaussian: beta {s.beta}")
    check(abs(logz - analytic) < 0.5, f"gaussian: logZ {logz} vs {analytic}")
    check(bool(np.all(np.abs(mean) <= 0.25)), f"gaussian: mean {mean}")
    check(bool(np.all(np.abs(var - 1.0) <= 0.5)), f"gaussian: var {var}")
    check(acc > 0.1, f"gaussian: acceptance {acc}")
    check(cuda_reweight.LAUNCHES > 0, "gaussian: no ESS kernel launch")
    return counts()


# ---------------------------------------------------------------------------
# Phases 11-13: the reference surface, dynamic mode, cadence and host calls
# ---------------------------------------------------------------------------
def per_point_sampler(device, hardware_prng=False, output_dir=None):
    """A's problem in the reference's default call form: per-point torch
    functions, `vectorize` left at False, blobs detected from the returns."""
    return Sampler(prior_transform, rosenbrock_blobs, n_dim=N_DIM, n_particles=N_PARTICLES,
                   k_max=16, history_capacity=CAPACITY, random_state=SEEDS[0],
                   hardware_prng=hardware_prng, output_dir=output_dir, device=device)


def check_run(name, s, band, launched) -> float:
    """beta = 1, posterior ESS >= n_total, logZ in the band, one ESS launch
    per reweight; returns the posterior ESS."""
    ess = s.state.posterior_ess()
    logz = s.evidence()[0]
    iters = s.state.hist.t
    print(f"{name}: iters={iters} ess={ess:.1f} logz={logz:.4f} beta={s.beta:.6f} "
          f"launches={launched}", flush=True)
    check(s.beta >= 1.0 - 1e-4, f"{name}: beta {s.beta} < 1 - 1e-4")
    check(ess >= N_TOTAL, f"{name}: posterior ESS {ess} < {N_TOTAL}")
    check(abs(logz - band[0]) <= band[1], f"{name}: logZ {logz} outside {band[0]} +/- {band[1]}")
    return ess


def iteration_rows(s, first: int, n: int = 2) -> list:
    """(iteration, beta, logZ) of the n iterations after iteration `first`."""
    res = s.results()
    return [(int(res["iter"][i]), float(res["beta"][i]), float(res["logz"][i]))
            for i in range(first, first + n)]


def check_same_stream(what: str, rows_a: list, rows_b: list) -> None:
    """The same iterations from a sampler that ran on and from one that
    loaded its state file: beta to 1e-6 (relative) and logZ to 1e-5. A
    re-seeded stream would part at the first MCMC step."""
    check(len(rows_a) == len(rows_b) > 0, f"{what}: no iterations to compare")
    for (it_a, beta_a, logz_a), (it_b, beta_b, logz_b) in zip(rows_a, rows_b):
        print(f"{what} iteration {it_a}: beta {beta_a:.9g} / {beta_b:.9g}, logz "
              f"{logz_a:.7f} / {logz_b:.7f}", flush=True)
        check(it_a == it_b and beta_a > 0.0, f"{what}: iterations {it_a} / {it_b}, beta {beta_a}")
        check(abs(beta_a - beta_b) <= 1e-6 * abs(beta_a), f"{what}: beta {beta_a} vs {beta_b}")
        check(abs(logz_a - logz_b) <= 1e-5, f"{what}: logZ {logz_a} vs {logz_b}")


def hardware_prng_draw_state(device, tmp: str) -> dict:
    """With hardware_prng=True: a sampler at iteration 20 saves its state
    and runs two iterations; a new sampler loads the file and runs the
    same two. Returns the launches of the four iterations."""
    s = per_point_sampler(device, hardware_prng=True)
    for _ in range(20):
        s.sample()
    path = os.path.join(tmp, "hardware_prng_20.state")
    s.save_state(path)
    reset_counts()
    for _ in range(2):
        s.sample()
    resumed = per_point_sampler(device, hardware_prng=True)
    resumed.load_state(path)
    for _ in range(2):
        resumed.sample()
    launched = counts()
    check_same_stream("draw state hardware_prng=True", iteration_rows(s, 20),
                      iteration_rows(resumed, 20))
    check(launched["mutation_draws"] > 0, "draw state: no mutation-draws launch")
    return launched


def phase_reference_surface(device, vectorized_wall: float) -> dict:
    """11: the reference's default Sampler surface at A's full width."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        s = per_point_sampler(device, output_dir=tmp)
        schema = s.state.blob_schema
        check(not s.vectorize and schema is not None and schema.width == 2,
              f"reference surface: vectorize={s.vectorize}, blob schema {schema}")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run(n_total=N_TOTAL, progress=False, save_every=10)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        ess = check_run("reference surface run", s, CLUSTERED_LOGZ, launched)
        check(launched["ess_bisect"] == s.state.hist.t - 1,
              f"reference surface: {launched['ess_bisect']} ESS launches for "
              f"{s.state.hist.t - 1} reweights")
        out["run"] = launched
        print(f"reference surface (per-point, blobs, save_every=10): wall={wall:.3f} s "
              f"eff/s={ess / wall:.1f}; phase 6 vectorized seed {SEEDS[0]}: "
              f"{vectorized_wall:.3f} s", flush=True)
        files = sorted(os.listdir(tmp))
        want = [f"ps_{i}.state" for i in range(10, s.state.cur.iteration, 10)]
        want.append("ps_final.state")
        check(all(f in files for f in want), f"reference surface: files {files}, want {want}")

        x, _, logl, blobs = s.posterior(return_blobs=True)
        logl_again, r2, x0 = torch.func.vmap(rosenbrock_blobs)(torch.from_numpy(x).to(device))
        want_blobs = torch.stack([r2, x0], dim=1).cpu().numpy()
        err = float(np.max(np.abs(blobs - want_blobs) / np.maximum(np.abs(want_blobs), 1e-30)))
        err_l = float(np.max(np.abs(logl - logl_again.cpu().numpy())
                             / np.maximum(np.abs(logl), 1e-30)))
        print(f"reference surface posterior: {len(x)} samples, blobs {blobs.shape} max rel err "
              f"{err:.3g}, logl max rel err {err_l:.3g}", flush=True)
        check(blobs.shape == (len(x), 2) and err <= 1e-6 and err_l <= 1e-6,
              "reference surface: posterior blobs differ from the function at x")
        logz, logz_err = s.evidence(n_bootstrap=256)
        print(f"reference surface evidence: logz={logz:.4f} bootstrap error={logz_err:.5f}",
              flush=True)
        check(math.isfinite(logz_err) and logz_err > 0.0, f"bootstrap error {logz_err}")

        # Resume from the iteration-20 file: the run must go on as the
        # first did (the draw state with hardware_prng=False) and end in the band.
        reset_counts()
        resumed = per_point_sampler(device)
        resumed.run(n_total=N_TOTAL, progress=False,
                    resume_state_path=os.path.join(tmp, "ps_20.state"))
        out["resume"] = counts()
        check_run("reference surface resumed from ps_20.state", resumed, CLUSTERED_LOGZ,
                  out["resume"])
        check_same_stream("draw state hardware_prng=False", iteration_rows(s, 20),
                          iteration_rows(resumed, 20))
        out["draw_state_hardware_prng"] = hardware_prng_draw_state(device, tmp)

        # A pickle taken mid-run, one iteration after the last numbered file.
        reset_counts()
        live = per_point_sampler(device)
        live.load_state(os.path.join(tmp, want[-2]))
        live.sample()
        unpickled = pickle.loads(pickle.dumps(live))
        check(unpickled.state.hist.t == live.state.hist.t, "pickle: another iteration")
        unpickled.run(n_total=N_TOTAL, progress=False)
        out["pickle"] = counts()
        check_run(f"reference surface from a pickle at iteration {live.state.hist.t}", unpickled,
                  CLUSTERED_LOGZ, out["pickle"])
    return out


def dynamic_sampler(device, seed):
    return Sampler(prior_transform, rosenbrock_chained, n_dim=N_DIM, n_particles=N_PARTICLES,
                   vectorize=True, clustering=False, history_capacity=192, volume_variation=1.0,
                   random_state=seed, device=device)


def phase_dynamic(device) -> dict:
    """12: dynamic (CV) mode on rosenbrock10_cv, seed 42, with
    run(on_device=False) and then run(on_device=True) on a sampler whose
    seed-43 run captured the graphs: bit for bit, logZ in the anchor, no
    ESS-mode launch, one bracket-mode launch a reweight and no
    "ess_bracket" loop body, the eigenvalue kernel's launches equal; walls,
    probes and reads per reweight; then iterations 21-23 in each mode
    under the profiler, held to at most one blocking read a loop chunk
    plus READS_BESIDE_CHUNKS an iteration."""
    runs = {}
    for on_device in (False, True):
        s = dynamic_sampler(device, SEEDS[1] if on_device else SEEDS[0])
        check(s.state.fused, "dynamic: not on the fused route")
        if on_device:
            s.run(n_total=N_TOTAL, progress=False, on_device=True)  # captures the graphs
            s.reset(random_state=SEEDS[0])
        warm = loop_stats(s)
        reset_counts()
        before = dict(reweight_step.PROBES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run(n_total=N_TOTAL, progress=False, on_device=on_device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        probes = {k: reweight_step.PROBES[k] - before[k] for k in before}
        launched = counts()
        stats = loop_stats(s)
        timed = {k: {c: v.get(c, 0) - warm.get(k, {}).get(c, 0) for c in v}
                 for k, v in stats.items()}
        name = f"dynamic rosenbrock10_cv on_device={on_device}"
        ess = check_run(name, s, CV_LOGZ, launched)
        iters = s.state.hist.t
        n = max(probes["reweights"], 1)
        reads = {k: v.get("reads", 0) / n for k, v in timed.items() if k in (
            "ess_bracket", "cv_bisect")}  # the bracket: one read of the kernel's words
        print(f"{name}: wall={wall:.3f} s ({1e3 * wall / iters:.1f} ms an iteration) "
              f"eff/s={ess / wall:.1f}; {iters} iterations, {probes['reweights']} dynamic "
              f"reweights, {probes['ess_bracket'] / n:.2f} ESS-bracket and {probes['cv'] / n:.2f} "
              f"CV probes per reweight, loop reads per reweight {reads}; loops {json.dumps(timed)}",
              flush=True)
        check(probes["reweights"] == iters - 1,
              f"dynamic: {probes['reweights']} dynamic reweights for {iters - 1}")
        check(launched["ess_bisect"] == 0, "dynamic: the ESS-mode kernel ran in dynamic mode")
        check(cuda_median is None or launched["ess_bracket"] == probes["reweights"],
              f"dynamic: {launched.get('ess_bracket')} bracket launches for "
              f"{probes['reweights']} dynamic reweights")
        check(cuda_median is None or timed.get("ess_bracket", {}).get("bodies", 0) == 0,
              f"dynamic: the 'ess_bracket' loop ran bodies on the card: {timed.get('ess_bracket')}")
        check(launched["sym_eigvals"] >= probes["cv"] + iters - 1,
              f"dynamic: {launched['sym_eigvals']} eigenvalue launches for {probes['cv']} CV "
              f"probes and {iters - 1} final CVs")
        runs[on_device] = dict(results=s.results(), logz=s.evidence()[0], wall=wall,
                               launches=launched, probes=probes, loops=timed, iters=iters,
                               sampler=s)
    eager, fused = runs[False], runs[True]
    for name in ("beta", "logz", "ess", "cv", "steps", "calls"):
        check(fused["results"][name].tobytes() == eager["results"][name].tobytes(),
              f"dynamic: {name} with on_device=True differs from on_device=False")
    check(fused["logz"] == eager["logz"] and fused["launches"] == eager["launches"]
          and fused["probes"] == eager["probes"],
          f"dynamic: logZ {fused['logz']!r} / {eager['logz']!r}, launches "
          f"{fused['launches']} / {eager['launches']}, probes {fused['probes']} / "
          f"{eager['probes']}")
    check(fused["loops"]["mcmc"].get("replays", 0) > 0
          and all(v.get("captures", 0) == 0 for v in fused["loops"].values()),
          f"dynamic on_device=True: replays and captures {fused['loops']}")
    windows = steady_windows(fused["sampler"], "dynamic", n=3, device_only=False)
    return {"launches": eager["launches"], "probes": eager["probes"],
            "wall_s": {"on_device=False": eager["wall"], "on_device=True": fused["wall"]},
            "iters": eager["iters"], "loops": {"on_device=False": eager["loops"],
                                               "on_device=True": fused["loops"]},
            "windows": windows}


def phase_cadence_and_host(device) -> dict:
    """13: C with cluster_every=3, and the 10-D Gaussian as a host likelihood."""
    s = Sampler(prior_transform, bimodal, n_dim=N_DIM, n_particles=256, vectorize=True,
                clustering=True, k_max=8, cluster_every=3, history_capacity=64, random_state=4,
                device=device)
    reset_counts()
    s.run(n_total=512, progress=False)
    cadence = counts()
    k = int(s.state.cluster_model.n_clusters())
    x, w, _ = s.posterior()
    mass = float(np.sum(w[x[:, 0] > 0]))
    print(f"cadence (C, cluster_every=3): clusters={k} mass(x0>0)={mass:.4f} "
          f"logz={s.evidence()[0]:.4f} beta={s.beta:.6f} launches={cadence}", flush=True)
    check(k >= 2 and 0.15 < mass < 0.85, f"cadence: {k} cluster(s), mass {mass}")
    check(cadence["ess_bisect"] > 0, "cadence: no ESS kernel launch")

    s = Sampler(prior_transform, gaussian_numpy, n_dim=N_DIM, n_particles=512,
                host_likelihood=True, clustering=False, random_state=0, history_capacity=64,
                device=device)
    reset_counts()
    t0 = time.perf_counter()
    s.run(n_total=2048, progress=False)
    wall = time.perf_counter() - t0
    host = counts()
    logz = s.evidence()[0]
    acc = float(s.state.cur.acceptance)
    print(f"host likelihood (numpy, pool=None): logz={logz:.4f} (analytic "
          f"{GAUSSIAN_LOGZ[0]:.4f}) beta={s.beta:.6f} acceptance={acc:.4f} calls={s.calls} "
          f"wall={wall:.3f} s launches={host}", flush=True)
    check(s.beta > 0.99 and abs(logz - GAUSSIAN_LOGZ[0]) < GAUSSIAN_LOGZ[1] and acc > 0.1,
          f"host likelihood: beta {s.beta}, logZ {logz}, acceptance {acc}")
    check(host["ess_bisect"] > 0, "host likelihood: no ESS kernel launch")
    return {"cadence": cadence, "host": host}


# ---------------------------------------------------------------------------
# Phase 14: float64 and the mixture facades
# ---------------------------------------------------------------------------
def gaussian4(x):
    return -0.5 * torch.sum(x * x, dim=-1) - 0.5 * 4 * math.log(2 * math.pi)


def phase_float64_gaussian(device) -> dict:
    """tests/test_float64.py's run on the card: the 4-D Gaussian in float64."""
    s = Sampler(prior_transform, gaussian4, n_dim=4, n_particles=256, vectorize=True,
                clustering=False, random_state=1, dtype=torch.float64, device=device)
    reset_counts()
    s.run(n_total=1024, progress=False)
    launched = counts()
    hist = s.state.hist
    valid = hist.sample_mask()
    mis_err = float(torch.max(torch.abs(mis_denominator(hist) - mis_denominator_exact(hist))[valid]))
    logz = s.evidence()[0]
    print(f"float64 4-D Gaussian: logz={logz:.6f} (analytic {GAUSSIAN4_LOGZ[0]:.6f}) "
          f"beta={s.beta:.6f} iters={hist.t} MIS accumulator max error {mis_err:.3g} "
          f"dtype={hist.logl.dtype} launches={launched}", flush=True)
    check(hist.logl.dtype == torch.float64 and s.beta > 0.99, "float64 Gaussian: dtype or beta")
    check(abs(logz - GAUSSIAN4_LOGZ[0]) < GAUSSIAN4_LOGZ[1], f"float64 Gaussian: logZ {logz}")
    check(mis_err < MIS_F64_TOL, f"float64 Gaussian: MIS accumulator error {mis_err}")
    check(launched["ess_bisect_f64"] == hist.t - 1 and launched["ess_bisect"] == 0,
          f"float64 Gaussian: launches {launched} for {hist.t - 1} reweights")
    return launched


def two_blobs(n=200, sep=4.0, seed=0, d=2):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.standard_normal((n, d)) * 0.3,
                           rng.standard_normal((n, d)) * 0.3 + sep])


def phase_facades(device) -> dict:
    """GaussianMixture of each covariance type on two blobs (n_init 1 and 4),
    one in float64, and HierarchicalGaussianMixture splitting them, on the
    card; the facades are plain PyTorch (no kernel, as JAX runs them in XLA)."""
    reset_counts()
    X = two_blobs(seed=11)
    t0 = time.perf_counter()
    for ctype in ("full", "tied", "diag", "spherical"):
        for n_init in (1, 4):
            g = GaussianMixture(n_components=2, covariance_type=ctype, n_init=n_init,
                                random_state=1, device=device).fit(X)
            labels = g.predict(X)
            means = np.sort(g.means_[:, 0])
            print(f"GaussianMixture {ctype} n_init={n_init}: means {means.round(4).tolist()} "
                  f"weights {g.weights_.round(4).tolist()} n_iter={g.n_iter_} bic={g.bic(X):.4f}",
                  flush=True)
            check(isinstance(g.covariances_, np.ndarray) and g.covariances_.shape == (2, 2, 2),
                  f"GaussianMixture {ctype}: covariances {type(g.covariances_)}")
            check(np.allclose(means, [0.0, 4.0], atol=0.3) and g.converged_,
                  f"GaussianMixture {ctype}: means {means}")
            check(len(set(labels[:200])) == 1 and len(set(labels[200:])) == 1
                  and labels[0] != labels[-1], f"GaussianMixture {ctype}: labels do not separate")
    g = GaussianMixture(n_components=2, random_state=1, device=device, dtype=torch.float64).fit(X)
    check(g.means_.dtype == np.float64 and np.allclose(np.sort(g.means_[:, 0]), [0.0, 4.0],
                                                       atol=0.3), "GaussianMixture float64")
    Xh = two_blobs(seed=12, sep=8.0)
    h = HierarchicalGaussianMixture(k_max=8, device=device).fit(Xh)
    proba = h.predict_proba(Xh)
    err = float(np.max(np.abs(proba.sum(axis=1) - 1.0)))
    wall = time.perf_counter() - t0
    print(f"HierarchicalGaussianMixture: K={h.n_clusters_} predict_proba {proba.shape}, max "
          f"|sum - 1| {err:.3g}; facades wall {wall:.3f} s, launches {counts()}", flush=True)
    check(h.n_clusters_ == 2 and proba.shape == (400, 2) and err < 1e-4,
          f"HierarchicalGaussianMixture: K={h.n_clusters_}, proba {proba.shape}, err {err}")
    check(abs(h.labels_[:200].mean() - h.labels_[200:].mean()) > 0.9, "HGM labels")
    return counts()


def phase_float64(device, walls32: dict, fused_wall: float) -> dict:
    """14: A and B in float64, the 4-D Gaussian, the facades; `fused_wall`
    is phase 6b's float32 seed 42 with on_device=True."""
    paths = {}
    paths["A_float64"], walls = run_canonical(
        device, "A float64 hardware_prng", SEEDS[:1], True, True, CLUSTERED_LOGZ, torch.float64,
        on_device=True)
    print(f"A seed {SEEDS[0]}: float64 wall {walls[SEEDS[0]]:.3f} s (on_device=True) against "
          f"float32 {fused_wall:.3f} s (phase 6b, on_device=True) and {walls32[SEEDS[0]]:.3f} s "
          f"(phase 6, on_device=False) in this run", flush=True)
    paths["B_float64"], errs, _ = phase_large_ensemble(device, torch.float64)
    paths["gaussian4_float64"] = phase_float64_gaussian(device)
    paths["facades"] = phase_facades(device)
    return paths, errs


# ---------------------------------------------------------------------------
# Phase 15: the particle mesh
# ---------------------------------------------------------------------------
def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_collectives(device, group) -> None:
    """The two collectives at world size 1 on a history of A's shape (N =
    1024, 64 slots, 30 filled), against the unsharded routes."""
    hist = synthetic_history(device, N_PARTICLES, CAPACITY, 30, seed=15)
    g = torch.Generator(device=device)
    g.manual_seed(15)
    hist.u.copy_(torch.rand(hist.u.shape, generator=g, device=device))
    hist.x.copy_(20.0 * hist.u - 10.0)
    logw, _ = logw_from_denominator(hist, mis_denominator(hist), 1.0)
    weights = torch.exp(logw)
    for method in ("mult", "syst"):
        uniforms = torch.rand((N_PARTICLES,) if method == "mult" else (), generator=g,
                              device=device)
        got = sharded_resample(positions(uniforms, N_PARTICLES, method), hist, weights, group)
        want = resample_step(uniforms, hist, weights, N_PARTICLES, method=method)
        rows = int(torch.sum(torch.all(got[0] == want[0], dim=1)))
        same = all(bool(torch.equal(a, b)) for a, b in zip(got[:3], want[:3]))
        print(f"mesh sharded_resample {method}: {rows} of {N_PARTICLES} rows equal to the "
              f"unsharded resampler's", flush=True)
        check(same, f"mesh sharded_resample {method}: {N_PARTICLES - rows} rows differ")
    S = CAPACITY * N_PARTICLES
    u_fit, w_fit, keep = sharded_select_fit_points(hist.u, weights, hist.t, S, group)
    u_want, w_want, keep_want = select_fit_points(hist, weights, S)
    w_err = float(torch.max(torch.abs(w_fit - w_want)))
    print(f"mesh sharded_select_fit_points m = S = {S}: rows equal "
          f"{bool(torch.equal(u_fit, u_want))}, keep equal {bool(torch.equal(keep, keep_want))}, "
          f"max |w - w_unsharded| {w_err:.3g}", flush=True)
    check(torch.equal(u_fit, u_want) and torch.equal(keep, keep_want) and w_err <= 1e-6,
          "mesh sharded_select_fit_points: not the unsharded selection")
    m = 4096
    u_fit, w_fit, keep = sharded_select_fit_points(hist.u, weights, hist.t, m, group)
    top = torch.topk(weights.reshape(-1), m).values
    err = float(torch.max(torch.abs(w_fit * torch.sum(top) - top)))
    print(f"mesh sharded_select_fit_points m = {m} (candidate branch): weights sum "
          f"{float(torch.sum(w_fit)):.7f}, max |w - top-m| {err:.3g}", flush=True)
    check(u_fit.shape == (m, N_DIM) and abs(float(torch.sum(w_fit)) - 1.0) < 1e-5
          and err <= 1e-6 * float(top[0]), "mesh sharded_select_fit_points: candidate branch")


def mesh_sampler(device, mesh, seed, hardware_prng=False, **kw):
    return Sampler(prior_transform, rosenbrock, n_dim=N_DIM, n_particles=N_PARTICLES,
                   vectorize=True, history_capacity=CAPACITY, random_state=seed, device=device,
                   mesh=mesh, hardware_prng=hardware_prng, **kw)


def mesh_run(s, name: str, **run_kw) -> dict:
    """One timed run of mesh sampler `s`: its results, wall, launches, MCMC
    bodies and draw state; logZ in the clustered band, no ESS-kernel
    launch (a mesh bisects by reductions, as JAX bypasses its kernel under
    one) and one eigenvalue launch a reweight."""
    warm, bodies = loop_stats(s), mcmc_bodies(s)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(n_total=N_TOTAL, progress=False, **run_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    iters = s.state.hist.t
    check_run(name, s, CLUSTERED_LOGZ, launched)
    check(launched["ess_bisect"] == 0 and launched["ess_bisect_f64"] == 0
          and launched["sym_eigvals"] == iters - 1,
          f"{name}: launches {launched}; a mesh runs no ESS kernel, and one CV a reweight")
    timed = {k: {c: v.get(c, 0) - warm.get(k, {}).get(c, 0) for c in v}
             for k, v in loop_stats(s).items()}
    return dict(results=s.results(), logz=s.evidence()[0], wall=wall, launches=launched,
                bodies=mcmc_bodies(s) - bodies, iters=iters, loops=timed,
                draws=s.state.draws.get_state())


def check_mesh_pair(name: str, eager: dict, fused: dict, hardware_prng: bool) -> None:
    """on_device=True against on_device=False, bit for bit."""
    for key in ("beta", "logz", "steps", "calls"):
        check(fused["results"][key].tobytes() == eager["results"][key].tobytes(),
              f"{name}: {key} with on_device=True differs from on_device=False")
    check(fused["logz"] == eager["logz"] and fused["launches"] == eager["launches"]
          and fused["bodies"] == eager["bodies"],
          f"{name}: logZ {fused['logz']!r} / {eager['logz']!r}, launches {fused['launches']} / "
          f"{eager['launches']}, bodies {fused['bodies']} / {eager['bodies']}")
    check(all(fused["draws"][k].tobytes() == eager["draws"][k].tobytes() for k in eager["draws"]),
          f"{name}: the final draw state differs")
    check(fused["loops"]["ess_sharded"].get("replays", 0) > 0
          and fused["loops"]["mcmc"].get("replays", 0) > 0,
          f"{name}: no replays {fused['loops']}")
    if hardware_prng:
        check(eager["launches"]["mutation_draws"] == eager["bodies"] > 0,
              f"{name}: {eager['launches']['mutation_draws']} mutation-draws launches for "
              f"{eager['bodies']} MCMC bodies")
    print(f"{name} seed {SEEDS[0]}: on_device=False {eager['wall']:.3f} s "
          f"({1e3 * eager['wall'] / eager['iters']:.1f} ms an iteration), on_device=True "
          f"{fused['wall']:.3f} s ({1e3 * fused['wall'] / fused['iters']:.1f} ms), bit for bit; "
          f"logz={fused['logz']!r} iters={fused['iters']} launches={fused['launches']} "
          f"mcmc_bodies={fused['bodies']}; loops with graphs {json.dumps(fused['loops'])}",
          flush=True)


def phase_mesh(device, walls32: dict) -> dict:
    """15: A on a particle mesh of one rank, over NCCL: the collectives; A
    with save_every=10 (on_device=False: checkpoints keep the host loop)
    and with on_device=True on a sampler whose seed-43 run captured the
    graphs, bit for bit; the resume and the gathers; the steady windows;
    then A with hardware_prng both ways."""
    import gc

    import torch.distributed as dist

    initialize(f"127.0.0.1:{free_port()}", 1, 0, device=device.type, timeout=300)
    try:
        return _mesh_runs(device, walls32)
    finally:
        gc.collect()  # the mesh and its samplers go while the group is up
        dist.destroy_process_group()


def _mesh_runs(device, walls32: dict) -> dict:
    """phase_mesh's runs, inside the process group."""
    mesh = make_particle_mesh(device=device.type)
    mesh_collectives(device, particle_group(mesh))
    with tempfile.TemporaryDirectory() as tmp:
        s = mesh_sampler(device, mesh, SEEDS[0], output_dir=tmp)
        check(s.state.fused, "A mesh: not on the fused route")
        eager = mesh_run(s, f"A mesh (world size 1, seed {SEEDS[0]}, save_every=10)",
                         save_every=10)
        print(f"A mesh seed {SEEDS[0]}: phase 6 seed {SEEDS[0]} without a mesh: "
              f"{walls32[SEEDS[0]]:.3f} s", flush=True)
        resumed = mesh_sampler(device, mesh, SEEDS[1])
        resumed.load_state(os.path.join(tmp, "ps_20.state"))
        for _ in range(2):
            resumed.sample()
        check_same_stream("mesh resume from ps_20.state", iteration_rows(s, 20),
                          iteration_rows(resumed, 20))

    x, w, logl = s.posterior()
    logz, logz_err = s.evidence(n_bootstrap=256)
    mean = np.average(x, axis=0, weights=w)
    print(f"A mesh posterior: {len(x)} samples of {s.state.hist.t * N_PARTICLES}, weights "
          f"sum {w.sum():.6f}, mean[:3] {mean[:3].round(4).tolist()}; evidence "
          f"{logz:.4f} +/- {logz_err:.5f} (bootstrap)", flush=True)
    check(x.shape[1] == N_DIM and np.all(np.isfinite(x)) and np.all(np.isfinite(logl))
          and abs(w.sum() - 1.0) < 1e-6, "A mesh posterior")
    check(logz == s.logz and math.isfinite(logz_err) and logz_err > 0.0,
          f"A mesh evidence {logz} +/- {logz_err}")

    g = mesh_sampler(device, mesh, SEEDS[1])
    g.run(n_total=N_TOTAL, progress=False, on_device=True)  # captures the graphs
    g.reset(random_state=SEEDS[0])
    fused = mesh_run(g, f"A mesh (world size 1, seed {SEEDS[0]}, on_device=True)",
                     on_device=True)
    check(all(v.get("captures", 0) == 0 for v in fused["loops"].values()),
          f"A mesh on_device=True recaptured: {fused['loops']}")
    check_mesh_pair("A mesh", eager, fused, False)
    windows = steady_windows(g, "A mesh", n=3, device_only=False)

    hw = {}
    for on_device in (False, True):
        h = mesh_sampler(device, mesh, SEEDS[0], hardware_prng=True)
        hw[on_device] = mesh_run(
            h, f"A mesh hardware_prng (seed {SEEDS[0]}, on_device={on_device})",
            on_device=on_device)
        if on_device:
            calls = h.state.draws.calls
            check(calls.read() == (calls.counter, calls.key),
                  f"A mesh hardware_prng: device words {calls.read()} against the host "
                  f"mirror {(calls.counter, calls.key)}")
    check_mesh_pair("A mesh hardware_prng", hw[False], hw[True], True)
    print(f"A mesh hardware_prng: call counter {int(hw[True]['draws']['philox_counter'])} "
          f"after {hw[True]['bodies']} MCMC bodies", flush=True)
    return {"launches": eager["launches"], "launches_hardware_prng": hw[False]["launches"],
            "walls": {"on_device=False": eager["wall"], "on_device=True": fused["wall"],
                      "hardware_prng on_device=False": hw[False]["wall"],
                      "hardware_prng on_device=True": hw[True]["wall"]},
            "iters": eager["iters"], "loops": fused["loops"], "windows": windows}


# ---------------------------------------------------------------------------
# Phase 16: rosenbrock100
# ---------------------------------------------------------------------------
def rosenbrock100_sampler(device, seed):
    """benchmarks/suite.py:183-196, every other default on."""
    return Sampler(prior_transform, rosenbrock_chained, n_dim=R100_DIM,
                   n_particles=R100_PARTICLES, vectorize=True, clustering=False,
                   history_capacity=R100_CAPACITY, random_state=seed, device=device)


def _kernel_ms(window: dict, part: str) -> tuple:
    """(device ms, launches) an iteration of the window's kernels whose name
    holds `part`."""
    rows = [v for k, v in window["kernels"].items() if part in k]
    return sum(r[0] for r in rows), sum(r[1] for r in rows)


def phase_rosenbrock100(device) -> dict:
    """16: the JAX suite's 100-D Rosenbrock at full width, seed 42, with
    run(on_device=True) on a sampler whose seed-43 run captured the graphs:
    beta 1, posterior ESS >= n_total, logZ in the anchor taken from the
    JAX package, one eigenvalue launch (d = 100) and one ESS launch
    (S = 524,288, the streamed route) a reweight; its first R100_EAGER
    iterations equal bit for bit to a fresh seed-42 sampler's sample()
    calls (on_device=False); then iterations 21-23 graphed under the
    profiler, held to 6b's rule, and the device ms an iteration of the
    eigenvalue kernel, the ESS kernel and the top other kernels."""
    s = rosenbrock100_sampler(device, SEEDS[1])
    check(s.state.fused, "rosenbrock100: not on the fused route")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(n_total=R100_TOTAL, progress=False, on_device=True)  # captures the graphs
    torch.cuda.synchronize()
    capture_wall = time.perf_counter() - t0
    warm = loop_stats(s)
    s.reset(random_state=SEEDS[0])
    sizes, plan = [], cuda_reweight.plan_launch

    def recording_plan(n, dtype=torch.float32):  # the S of every eager ESS launch
        sizes.append(n)
        return plan(n, dtype)

    reset_counts()
    cuda_reweight.plan_launch = recording_plan
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run(n_total=R100_TOTAL, progress=False, on_device=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        cuda_reweight.plan_launch = plan
    launched = counts()
    res, logz, iters = s.results(), s.evidence()[0], s.state.hist.t
    ess, steps = s.state.posterior_ess(), mcmc_steps(s)
    stats = loop_stats(s)
    timed = {k: {c: v.get(c, 0) - warm.get(k, {}).get(c, 0) for c in v} for k, v in stats.items()}
    name = f"rosenbrock100 seed {SEEDS[0]} on_device=True"
    print(f"{name}: wall={wall:.3f} s ({1e3 * wall / iters:.1f} ms an iteration; the capturing "
          f"seed-{SEEDS[1]} run {capture_wall:.3f} s) iters={iters} logz={logz:.4f} "
          f"beta={s.beta} ess={ess:.1f} calls={s.calls} mcmc_steps={steps} "
          f"({steps / iters:.2f} an iteration) launches={launched}; ESS launch sizes "
          f"{sorted(set(sizes))}; loops {json.dumps(timed)}", flush=True)
    check(s.beta >= 1.0 - 1e-4, f"{name}: beta {s.beta} < 1 - 1e-4")
    check(ess >= R100_TOTAL, f"{name}: posterior ESS {ess} < {R100_TOTAL}")
    check(abs(logz - R100_LOGZ[0]) <= R100_LOGZ[1],
          f"{name}: logZ {logz} outside {R100_LOGZ[0]} +/- {R100_LOGZ[1]}")
    check(launched["sym_eigvals"] == iters - 1,
          f"{name}: {launched['sym_eigvals']} eigenvalue launches for {iters - 1} reweights")
    streamed = R100_CAPACITY * R100_PARTICLES
    check(launched["ess_bisect"] == iters - 1 > 0 and sizes and set(sizes) == {streamed}
          and not plan(streamed).resident,
          f"{name}: {launched['ess_bisect']} ESS launches for {iters - 1} reweights, sizes "
          f"{sorted(set(sizes))}: each must take the streamed route at S = {streamed}")
    check(all(launched[k] == 0 for k in ("ess_bisect_f64", "mutation_draws", "normal", "bits",
                                         "gamma")), f"{name}: unexpected launches {launched}")
    check(all(v.get("captures", 0) == 0 for v in timed.values())
          and timed["mcmc"].get("replays", 0) > 0, f"{name}: captures and replays {timed}")

    # The first R100_EAGER iterations, eagerly: the same bits.
    e = rosenbrock100_sampler(device, SEEDS[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(R100_EAGER):
        e.sample()
    torch.cuda.synchronize()
    eager_wall = time.perf_counter() - t0
    eres = e.results()
    for key in ("beta", "logz", "steps", "calls"):
        check(res[key][:R100_EAGER].tobytes() == eres[key][:R100_EAGER].tobytes(),
              f"rosenbrock100: {key} of the first {R100_EAGER} iterations differs between "
              f"on_device=True and sample(): {res[key][:R100_EAGER].tolist()} against "
              f"{eres[key][:R100_EAGER].tolist()}")
    print(f"rosenbrock100: the first {R100_EAGER} iterations of sample() (on_device=False, "
          f"{eager_wall:.3f} s, {1e3 * eager_wall / R100_EAGER:.1f} ms an iteration) equal the "
          f"graphed run's bit for bit (beta, logZ, steps, calls)", flush=True)

    w = steady_window(s, True, n=3, device_only=False, n_total=R100_TOTAL)
    check_window("rosenbrock100 graphs", w)
    eig_ms, eig_n = _kernel_ms(w, "sym_eigvals")
    ess_ms, ess_n = _kernel_ms(w, "ess_bisect")
    others = {k: v for k, v in w["kernels"].items()
              if "sym_eigvals" not in k and "ess_bisect" not in k}
    top = dict(list(others.items())[:5])
    print(f"rosenbrock100 seed {SEEDS[0]} iterations 21-23 under the profiler, graphs: "
          f"{1e3 * w['wall_per_iter']:.1f} ms an iteration, device {w['device_ms_per_iter']:.3f} ms "
          f"(busy {100 * (1 - w['idle']):.1f} %, idle {100 * w['idle']:.1f} %), blocking host "
          f"reads {w['blocking_per_iter']:.1f} an iteration {w['blocking']}, loop chunk reads "
          f"{w['chunk_reads_per_iter']:.1f} {w['reads']}, eigvalsh operators {w['eigh_ops']}; "
          f"device ms an iteration: sym_eigvals {eig_ms:.4f} ({eig_n:.2f} launches), ess_bisect "
          f"{ess_ms:.4f} ({ess_n:.2f} launches), top five others "
          f"{json.dumps({k[:90]: [round(v[0], 4), v[1]] for k, v in top.items()})}; stage ms an "
          f"iteration {json.dumps({k: round(v, 3) for k, v in w['stages_ms'].items()})}",
          flush=True)
    return {"launches": launched, "wall": wall, "capture_wall": capture_wall, "iters": iters,
            "logz": logz, "ess": ess, "steps_per_iter": steps / iters, "eager_wall": eager_wall,
            "window": {k: w[k] for k in ("wall_per_iter", "device_ms_per_iter", "idle",
                                         "blocking_per_iter", "chunk_reads_per_iter")},
            "sym_eigvals_ms": eig_ms, "ess_bisect_ms": ess_ms, "ess_launch_sizes": sorted(set(sizes)),
            "top_kernels": top}


def profile_iterations(s, name: str, out_dir: str) -> None:
    """Profile iterations 21-25 of sampler `s`: each stage's host time and
    share of the wall, the device's self time and idle share; the tables
    (by stage range and by kernel) go to DIR/<name>_profile.txt."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(20):
        s.sample()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            s.sample()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}_profile.txt")
    events = prof.key_averages()
    with open(path, "w") as f:
        f.write(events.table(sort_by="cpu_time_total", row_limit=60))
        f.write("\n")
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=30))
    stages = {}
    for e in events:  # a range appears once on the host and once on the device
        if e.key.startswith("ps/"):
            stages[e.key] = max(stages.get(e.key, 0.0), e.cpu_time_total / 1e3)
    device_ms = sum(_self_device_us(e) for e in events  # kernels; not the stage ranges
                    if e.device_type == DeviceType.CUDA and not e.key.startswith("ps/")) / 1e3
    shares = ", ".join(f"{k} {v:.1f} ms ({100 * v / (1e3 * wall):.1f} %)"
                       for k, v in sorted(stages.items(), key=lambda kv: -kv[1]))
    print(f"profile {name}: iterations 21-25 in {wall:.3f} s under the profiler; device self "
          f"time {device_ms:.1f} ms (idle {100 * (1 - device_ms / (1e3 * wall)):.1f} %); "
          f"stages: {shares} -> {path}", flush=True)


def phase_profile(device, out_dir: str) -> None:
    """Profile the clustered canonical seed 42, phase 11's per-point
    configuration and phase 12's dynamic mode."""
    profile_iterations(canonical_sampler(device, SEEDS[0], clustering=True),
                       "canonical_clustered", out_dir)
    profile_iterations(per_point_sampler(device), "reference_surface", out_dir)
    profile_iterations(dynamic_sampler(device, SEEDS[0]), "dynamic_rosenbrock10_cv", out_dir)


SOURCES = {"ess_bisect": "tempest_tpu_torch/csrc/ess_bisect.cu",
           "ess_bisect_f64": "tempest_tpu_torch/csrc/ess_bisect.cu",
           "ess_bracket": "tempest_tpu_torch/csrc/ess_bisect.cu",
           "sym_eigvals": "tempest_tpu_torch/csrc/sym_eigvals.cu",
           "weighted_median": "tempest_tpu_torch/csrc/weighted_median.cu",
           "gmm_em": "tempest_tpu_torch/csrc/gmm_em.cu",
           "mvstud_em": "tempest_tpu_torch/csrc/mvstud_em.cu"}
KERNELS = ("ess_bisect", "ess_bisect_f64", "ess_bracket", "mutation_draws", "normal", "bits",
           "gamma", "sym_eigvals", "weighted_median", "gmm_em", "mvstud_em")
# Kernels of the port that replace no Pallas kernel, and what they replace.
NO_PALLAS = {
    "sym_eigvals": "XLA's jnp.linalg.eigvalsh of volume_variation_dtn (tools.py:214; also :274); "
                   "torch.linalg.eigvalsh reads the host, so the CV loop could not be captured",
    "ess_bracket": "XLA's _find_ess_bracket (tempest_tpu/steps/reweight.py:73-119), dynamic "
                   "mode's ESS bracket: the bracket mode of the ported Pallas ESS kernel "
                   "(pallas_reweight.py:55), whose plain version is a device loop of about ten "
                   "small kernels a probe",
    "weighted_median": "XLA's cumsum, argmax and gather of _weighted_median_presorted "
                       "(tempest_tpu/student.py:220-231); CUDA's torch.cumsum scans each column "
                       "in one thread that waits for every gathered load",
    "gmm_em": "the GMM EM lax.while_loop (tempest_tpu/cluster.py:256), which XLA runs on the "
              "device without a host read; its plain version is the \"gmm_em\" device loop, "
              "a few dozen small launches a body and a read a chunk",
    "mvstud_em": "the weighted Student-t EM lax.while_loop (tempest_tpu/student.py:323, "
                 "vmapped by modes.py:145), which XLA runs on the device without a host read; "
                 "its plain version is the \"mode_em\" device loop",
}
REPLACES = {
    "ess_bisect": "tempest_tpu/ops/pallas_reweight.py:55",
    # JAX gates its Pallas kernel to float32 (pallas_reweight.py:42-44) and
    # runs XLA's float64 bisection; the port's float64 kernel stands for both.
    "ess_bisect_f64": "tempest_tpu/ops/pallas_reweight.py:55",
    "mutation_draws": "tempest_tpu/ops/pallas_prng.py:159",
    "normal": "tempest_tpu/ops/pallas_prng.py:83",
    "bits": "tempest_tpu/ops/pallas_prng.py:108",
    # hw_gamma reaches pallas_call (:126) through 13 normal and bits calls.
    "gamma": "tempest_tpu/ops/pallas_prng.py:275",
    "sym_eigvals": "tempest_tpu/ops/tools.py:214",
    "ess_bracket": "tempest_tpu/steps/reweight.py:73",
    "weighted_median": "tempest_tpu/student.py:220",
    "gmm_em": "tempest_tpu/cluster.py:256",
    "mvstud_em": "tempest_tpu/student.py:323",
}
# Where each kernel's `launches` were counted.
LAUNCHES_ON = {
    "ess_bisect": "A (phase 6, seed 42; phase 6b's seed 42 with its loops replayed as graphs "
                  "launches it as often)",
    "ess_bisect_f64": "A in float64 (phase 14)",
    "mutation_draws": "A with hardware_prng (phase 7, on_device=False; its on_device=True run "
                      "launches it as often, by graph replays)",
    "normal": "B (phase 8, its eager run, the counts set to 0 just before it; its graphed run "
              "launches it as often, by replays)",
    "bits": "B (phase 8, its eager run)",
    "gamma": "B (phase 8, its eager run, the counts set to 0 just before it; its graphed run "
             "launches it as often, by replays)",
    "sym_eigvals": "rosenbrock100 (phase 16, seed 42: the CV of each reweight at d = 100); "
                   "A (phase 6) launches it once a reweight at d = 10, dynamic mode (phase 12) "
                   "for every CV probe as well",
    "ess_bracket": "dynamic mode (phase 12, seed 42, on_device=False: one a reweight; its "
                   "on_device=True run launches it as often)",
    "weighted_median": "B (phase 8, its eager run, the counts set to 0 just before it: one a "
                       "mode fit, fit_global_mode at n = 524,288; its graphed run launches it as "
                       "often); A (phase 6) once a clustered fit",
    "gmm_em": "A (phase 6, seed 42, on_device=False: one a split round's GMM EM loop; phase "
              "6b's run launches it as often, by graph replays)",
    "mvstud_em": "A (phase 6, seed 42: one a mode fit, the 16 modes at once; phase 6b's run "
                 "launches it as often, by graph replays); every other path once a mode fit",
}
# Kernels that no Sampler path launches, and why: each must count 0 on every
# path, and phase 4 still holds it against its plain version.
OFF_PATH = {
    "bits": "hw_gamma, the only Sampler caller of _bits_kernel (through hw_uniform), is one "
            "tempest_gamma launch here; tempest_bits serves the public hw_uniform/hw_bits, "
            "whose phase-4 launches are hw_uniform_launches",
}


def kernel_table(rows: dict, launches: dict, floor: dict, split: dict, paths=None) -> list:
    table = []
    for name in KERNELS:
        if name not in rows:  # a package older than the kernel (--package-root)
            continue
        row = rows[name]
        table.append({
            "name": name, "route": "cuda",
            "source": SOURCES.get(name, "tempest_tpu_torch/csrc/prng_draws.cu"),
            "replaces": REPLACES[name], "launches": launches.get(name),
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
            "launches_on": LAUNCHES_ON[name] if launches else None,
            **({"off_path": OFF_PATH[name]} if name in OFF_PATH else {}),
            **({"no_pallas_counterpart": NO_PALLAS[name]} if name in NO_PALLAS else {}),
            **{k: row[k] for k in ("device_ms", "library_device_ms", "gamma_flips", "rounds",
                                   "bound_sm_ms", "bound_sm_by", "chain_bound_ms",
                                   "bytes_bound_ms", "longest_chain", "device_ms_turns",
                                   "cumsum_accumulation", "S", "filled", "probes", "launch_plan",
                                   "gamma_bits_unequal", "hw_uniform_launches", "shapes",
                                   "routes", "on_rosenbrock100", "on_path", "chain_bound_ms",
                                   "bound_with_chain_ms", "cluster", "n_iter_max",
                                   "iterations_max", "checks", "reduction_us") if k in row},
            "launch_floor_ms": floor["device_ms"], "call_split": split.get(name),
            **({"call_split_counter": split[f"{name}_counter"]}
               if f"{name}_counter" in split else {}),
            "launches_by_path": {p: n.get(name, 0) for p, n in (paths or {}).items()},
        })
    return table


def a_summary(run: dict) -> dict:
    """A run's logZ, iterations, MCMC steps and ladder digest."""
    import hashlib

    res = run["results"]
    return {"logz": run["logz"], "iters": run["iters"], "steps": int(res["steps"].sum()),
            "beta_sha256": hashlib.sha256(res["beta"].tobytes()).hexdigest()}


def parent_a(parent: str, ours: dict) -> None:
    """A's seed 42 in the package of checkout `parent` (this script with
    --a-only --package-root, in a process of its own), printed beside phase
    6's."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--a-only",
                           "--package-root", parent], capture_output=True, text=True,
                          timeout=900)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("A_SEED42 ")]
    check(proc.returncode == 0 and len(lines) == 1,
          f"parent A run failed ({proc.returncode}): {proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    theirs, mine = json.loads(lines[0][len("A_SEED42 "):]), a_summary(ours)
    # Not held equal: the EM kernels sum in another order than the plain
    # loops the parent runs on the card, so the ladder moves by rounding; the
    # run's own checks hold it to the band.
    print(f"A seed {SEEDS[0]} in the parent's package ({parent}): {json.dumps(theirs)}; here: "
          f"{json.dumps(mine)}; equal: {theirs == mine}", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="profile five clustered canonical iterations into DIR")
    parser.add_argument("--kernels-only", action="store_true",
                        help="run phases 1-4 only and print their table (no result line)")
    parser.add_argument("--package-root", metavar="DIR",
                        help="import tempest_tpu_torch from DIR (with --kernels-only or --a-only)")
    parser.add_argument("--a-only", action="store_true",
                        help="run phases 1-2 and A's seed 42 only; print its ladder (no result "
                             "line)")
    parser.add_argument("--parent", metavar="DIR",
                        help="a checkout of another commit: its package's A seed 42 (--a-only, "
                             "in a process of its own) must give phase 6's logZ and iterations")
    args = parser.parse_args()
    if args.package_root and not (args.kernels_only or args.a_only):
        fail("--package-root runs another version's package: use it with --kernels-only or "
             "--a-only")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on an NVIDIA GPU")
    device = torch.device("cuda")
    t_start = time.perf_counter()

    def stamp(what: str) -> None:
        print(f"[{time.perf_counter() - t_start:.1f} s] {what}", flush=True)

    kind = phase_device()
    print(f"package: {os.path.dirname(os.path.dirname(os.path.abspath(cuda_reweight.__file__)))}",
          flush=True)
    _count_mode_fits()
    ptxas = phase_build()
    if args.a_only:
        runs = {}
        run_canonical(device, "A clustered", SEEDS[:1], True, False, CLUSTERED_LOGZ, runs=runs)
        print("A_SEED42 " + json.dumps(a_summary(runs[SEEDS[0]])), flush=True)
        return
    stamp("phase 3: the ESS kernel")
    rows = {"ess_bisect": phase_ess_kernel(device), "ess_bisect_f64": phase_ess_kernel_f64(device)}
    if cuda_median is not None:
        stamp("phase 3b: the ESS kernel's bracket mode")
        rows["ess_bracket"] = phase_bracket_kernel(device)
    stamp("phase 4: the PRNG kernels")
    rows.update(phase_prng_kernels(device))
    stamp("phase 4b: the eigenvalue kernel")
    if cuda_linalg is not None:
        rows["sym_eigvals"] = phase_eig_kernel(device)
    if cuda_median is not None:
        stamp("phase 4c: the weighted-median kernel")
        rows["weighted_median"] = phase_median_kernel(device)
    if cuda_em is not None:
        stamp("phase 4d: the EM kernels")
        rows.update(phase_em_kernels(device))
    floor = launch_floor(device)
    split = phase_call_split(device)
    if args.kernels_only:
        print(f"total wall: {time.perf_counter() - t_start:.1f} s", flush=True)
        print(f"ptxas: {json.dumps(ptxas)}", flush=True)
        print(json_line({"kernels": kernel_table(rows, {}, floor, split)}), flush=True)
        return
    paths = {}
    stamp("phase 5: canonical unclustered")
    paths["unclustered_fused"], _ = run_canonical(device, "canonical unclustered fused",
                                                  SEEDS[:1], False, False, UNCLUSTERED_LOGZ,
                                                  on_device=True)
    eager = {}
    stamp("phase 6: A")
    paths["A"], walls = run_canonical(device, "A clustered", SEEDS[:1], True, False,
                                      CLUSTERED_LOGZ, runs=eager)
    if args.parent:
        parent_a(args.parent, eager[SEEDS[0]])
    stamp("phase 6b: A fused")
    fused = phase_fused(device, eager)
    paths["A_fused"] = fused["launches"]
    stamp("phase 7: A with hardware_prng")
    hw = phase_hardware_prng(device)
    paths["A_hardware_prng"], paths["A_hardware_prng_fused"] = hw["launches"], hw["launches_fused"]
    stamp("phase 8: B")
    paths["B"], large_errs, b_rows = phase_large_ensemble(device)
    for name, err in large_errs.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    if "weighted_median" in rows:
        rows["weighted_median"]["on_path"] = {"B graphed iteration": b_rows["profiled"]}
    stamp("phases 9-10: C, the Gaussian")
    paths["C"] = phase_bimodal(device)
    paths["gaussian"] = phase_gaussian(device)
    stamp("phase 11: the reference surface")
    for name, n in phase_reference_surface(device, walls[SEEDS[0]]).items():
        paths[f"reference_surface_{name}"] = n
    stamp("phase 12: dynamic mode")
    dynamic = phase_dynamic(device)
    paths["dynamic"] = dynamic["launches"]
    if "ess_bracket" in rows:
        graphed = dynamic["windows"]["on_device=True"]
        on_path = _kernel_ms(graphed, "ess_bracket_kernel")
        check(on_path[1] > 0, f"dynamic graphed window: no bracket kernel recorded {on_path}")
        rows["ess_bracket"]["on_path"] = {
            "dynamic graphed window, device ms and launches an iteration": on_path,
            "ps/reweight host ms an iteration": graphed["stages_ms"].get("ps/reweight")}
    stamp("phase 13: cadence and a host likelihood")
    for name, n in phase_cadence_and_host(device).items():
        paths[name] = n
    stamp("phase 14: float64")
    f64_paths, f64_errs = phase_float64(device, walls, fused["wall"])
    paths.update(f64_paths)
    for name, err in f64_errs.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    stamp("phase 15: the mesh")
    mesh = phase_mesh(device, walls)
    paths["A_mesh"], paths["A_mesh_hardware_prng"] = mesh["launches"], mesh[
        "launches_hardware_prng"]
    stamp("phase 16: rosenbrock100")
    r100 = phase_rosenbrock100(device)
    paths["rosenbrock100"] = r100["launches"]
    rows["ess_bisect"]["on_rosenbrock100"] = {
        "S": r100["ess_launch_sizes"], "launches": r100["launches"]["ess_bisect"],
        "device_ms": r100["ess_bisect_ms"]}
    rows["sym_eigvals"]["on_rosenbrock100"] = {
        "d": R100_DIM, "launches": r100["launches"]["sym_eigvals"],
        "device_ms": r100["sym_eigvals_ms"]}
    stamp("phase 16 done")
    if args.profile:
        phase_profile(device, args.profile)

    launches = {"ess_bisect": paths["A"]["ess_bisect"],
                "ess_bisect_f64": paths["A_float64"]["ess_bisect_f64"],
                "ess_bracket": paths["dynamic"]["ess_bracket"],
                "mutation_draws": paths["A_hardware_prng"]["mutation_draws"],
                "normal": paths["B"]["normal"], "bits": paths["B"]["bits"],
                "gamma": paths["B"]["gamma"], "sym_eigvals": paths["rosenbrock100"]["sym_eigvals"],
                "weighted_median": paths["B"]["weighted_median"],
                "gmm_em": paths["A"]["gmm_em"], "mvstud_em": paths["A"]["mvstud_em"]}
    for name, n in launches.items():
        if name in OFF_PATH:
            on = {p: c[name] for p, c in paths.items() if c[name]}
            check(not on, f"kernel {name} has no Sampler path but was launched on {on}")
        else:
            check(n > 0, f"kernel {name} was not launched on its path")
    print(f"launches by path: {json.dumps(paths)}", flush=True)
    keys = ("probes", "wall_s", "iters", "loops", "windows")
    print(f"dynamic: {json.dumps({k: dynamic[k] for k in keys})}", flush=True)
    print(f"A mesh: {json.dumps({k: mesh[k] for k in ('walls', 'iters', 'loops', 'windows')})}",
          flush=True)
    print(f"A fused: {json.dumps({k: fused[k] for k in ('wall', 'iters', 'loops', 'windows')})}",
          flush=True)
    print(f"rosenbrock100: {json.dumps(r100)}", flush=True)
    print("A hardware_prng: " + json.dumps({k: hw[k] for k in (
        "wall", "wall_eager", "iters", "iters_eager", "loops", "windows")}), flush=True)
    print("B walls by iteration (s), eager / graphed: " + json.dumps(
        {r["iter"]: [r["wall"], g["wall"]] for r, g in zip(b_rows["eager"], b_rows["graphed"])}),
        flush=True)
    print(f"total wall: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"ptxas: {json.dumps(ptxas)}", flush=True)
    print(json_line({"kernels": kernel_table(rows, launches, floor, split, paths)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
