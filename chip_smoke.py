"""Smoke test of tempest_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR] [--parent DIR]
    python3 chip_smoke.py --kernels-only [--package-root DIR]
    python3 chip_smoke.py --a-only [--package-root DIR]
    python3 chip_smoke.py --large-scale-only
    python3 chip_smoke.py --host-only [--parent DIR]
    python3 chip_smoke.py --handshakes-only [--package-root DIR]

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
    times on the 1024 x 192 history, beside its bound (the bytes read once
    against each probe's exps on the live samples; the bound counting every
    sample's is printed too); with --parent DIR, its device time in turns
    with DIR's kernel (parent, this, this, parent) at every size; and the
    clock64 split of a probe round by phase from a build with
    BRACKET_STAMPS (each CTA's load, pass, warp and CTA combines, pushes,
    wait for the cluster's partials, their combine and the decision);
 4. the four PRNG kernels against their plain versions on one key and call
    index (mutation draws at (8, 1024, 10), a ragged (8, 1000, 10) and the
    largest fused shape (8, 6553, 10); normal and bits at 2^20 and at B's
    shapes, and the bits kernel's uniform mode through the public
    `hw_uniform` (one launch, the words of `hw_bits` mapped to (0, 1]) at
    2^20 and bit for bit against `philox.uniform` at the path's shapes, B's
    131,072 walkers and rosenbrock100's 2,048, and through `Draws` and its
    call counter's device word as the keyed iterations draw them (the
    warm-up's prior draw and patch, two calls; a multinomial and a
    systematic resampling's, one call each) at A's, B's, rosenbrock100's
    and the 2^20 path's walkers and dimensions, from call 2^32 - 1 (the
    counter advanced 2, 1 and 1, and not at all under a false guard); the
    bits row is timed in that mode, the one on the path, beside
    `torch.rand`, with the raw
    words' times (`hw_bits`, `random_`) under `raw_words`; the gamma
    draws at n = 1, 3,
    5, 1000, 131,072, 131,075 and 262,144 for alpha 0.02, 0.5, 0.7, 1.5,
    7.5, 50 and all six in turn, one gamma launch and no other a call, on
    call indices that cross 2^32; flips and draws not equal bit for bit),
    their moments, their device and host-timed call times beside their
    plain versions' and the PyTorch generator's (the gamma kernel's bound
    counts the Marsaglia-Tsang rounds these draws need), the launch floor,
    and one synchronized call of each kernel split into wrapper, launch,
    device and sync time, through the public functions and, for the three
    kernels a draws object launches, through its call counter's words
    (`cuda_prng.PhiloxCounter`); then the four float64 kernels
    (`tempest_uniform_f64`, `tempest_normal_f64`, `tempest_gamma_f64`,
    `tempest_mutation_draws_f64`, which replace XLA's threefry draws in
    double) through a `PhiloxCounter`'s device words from a call index
    whose gamma draws' 33 calls cross 2^32, at the paths' shapes (A's
    mutation draws (8, 1024, 10) and a ragged (8, 1000, 10), the warm-up's
    (1024, 10) and (1024,) and B's (131,072) uniforms, B's 10,485,760
    normals, gamma draws at 131,072 and 1,001 for every alpha of the
    float32 checks): the uniforms bit for bit, the normals and gamma draws
    within DRAW_TOL_F64, at most MAX_FLIPS_F64 gamma flips a call, one
    launch a call; their moments; their device and call times beside
    their plain versions', `randn`, `rand` and `_standard_gamma` in
    float64, and their bounds (the double functions' instructions counted
    from the SASS probe of phase 2);
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
    (1, 8192, 100) (K, n, d), ragged shapes with all-zero rows and A's own
    fit rows (seed 42, iteration 21: one-hot, most weights zero), in
    float32 and float64; its call and device times at A's fit rows and the
    three shapes in turns with the plain version and the library call
    (torch.cumsum and argmax of the gathered weights), beside its bound
    (the longest column's nonzero adds up to its crossing at 4 cycles,
    against the order entries and weights up to the crossings read once);
    with --parent DIR, its device time in turns with DIR's kernel (parent,
    this, this, parent); and the clock64 split of a column (the first stage
    ready, the waits, the adds) from a build with MEDIAN_STAMPS at A's fit
    rows and B's;
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
 4e. the kernel that sets a CUDA-graph conditional node's flag
    (csrc/graph_cond.cu, which stands for XLA's lax.cond and while_loop of
    the cluster fit's rounds, not a Pallas kernel): a graph of A's 15 IF
    nodes on go & (n_leaves < 16) runs its bodies exactly where the host's
    read of go and the leaf count (its plain version, the eager fit's
    decision) decides to, at every (go, n_leaves) tried; its device time a
    launch, a replay's call time a node untaken and taken, against one
    plain decision's call time, beside its bound;
 4f. what a conditional node costs the device, by CUDA events: a WHILE
    node (the MCMC chain's) whose body adds one to a counter runs it 0, 1,
    5 and 1,000 times as asked, and a run of that empty body against the
    same kernels in a straight graph; A's step body (N = 1024, d = 10,
    keyed draws) run to its stop by a WHILE node against the same steps in
    a straight graph; and an untaken IF node (A's 15 in one replay against
    none);
 4g. a conditional body that synchronizes or allocates past PyTorch's
    sync check (scripts/capture_abort.py, in a process of its own; a stream
    sync, and for the nested bodies also a raw cudaMalloc and
    cudaDeviceSynchronize): the device run loop's bodies through its
    likelihood, an IF body, an IF body inside an IF body inside a WHILE
    body and dynamic mode's CV bisection body (a WHILE body in the CV
    step's IF body in the run loop's WHILE body) each fail their capture with
    CaptureError naming the loop and on_device=False, the process exits 0
    (not by a signal) after a clean clustered run graphed bit for bit with
    its eager run;
 4h. conditional nodes inside conditional bodies through `Loops`: a WHILE
    node holding an IF node holding two more (the run loop > the mutation >
    the cadence > a split round) and a WHILE node holding an IF node
    holding a WHILE node (the run loop > the mutation > the MCMC chain),
    each body counting its runs: one replay runs every body as often as
    the host's loop, each node's flag kernel once a run of its parent; the
    graph's nodes, depth and capture seconds;
 4i. NCCL collectives inside conditional bodies (scripts/capture_probe.py
    --nccl, each case in a process of its own): an all-reduce over a
    one-rank NCCL group in a WHILE body, an IF body, WHILE > IF, IF > WHILE
    and WHILE > IF > WHILE, graphed bit for bit with the host's loop;
 4j. the host-call kernel (csrc/host_call.cu, which stands for JAX's host
    callback of a host likelihood, not a Pallas kernel) against its plain
    version, the plain crossing (`HostLikelihood.plain`), bit for bit at
    one point, A's (1024, 10) with two blob values a point and B's
    (131,072, 10), active and not (an inactive step's rows back, no
    call), one pool map call a call; a raising host function re-raised
    with its `failed` word set, the next call clean; each handshake split
    into its parts by the device's %globaltimer and the host's
    perf_counter_ns stamps; its device ms a handshake with an empty host
    function (twice, or with `--parent DIR` in turns with DIR's package:
    parent, this, this, parent, the parent's in processes of their own),
    its call ms and the plain crossing's, against its bound (the points
    out and logl in at the host link's rated 64 GB/s each way, the pinned
    copy rates measured here printed beside it, plus the link's round
    trip, `cuda_host.round_trip_ms`: a kernel's exchanges with a host C
    thread, no Python);
 5. the canonical problem unclustered (paired 10-D Rosenbrock, U(-10, 10)
    prior, n_particles=1024, n_total=8192, history_capacity=64), seed 42,
    with `run(on_device=True)`: the device run loop, one graph replay;
 6. A: the canonical problem at the reference defaults, clustered
    (k_max=16), hardware_prng=False, seeds 42-44 after a warm-up, with
    `run(on_device=False)`: the fused iteration without graphs, its MCMC
    chain in the loop form (a read a step) on keyed draws, one
    mutation-draws launch a step and no chunk of steps; one mvstud_em
    launch a mode fit, one gmm_em launch a GMM EM loop and no "mode_em" or
    "gmm_em" chunk read (every path holds this);
 6b. A fused: A's seed 42 with `run(on_device=True)`, the device run loop
    (fused.make_fused_run), which captures its graph (its nodes, nesting
    depth and capture seconds printed), then seeds 42-44 on it: the beta
    ladder, logZ, steps, calls and launches of each equal bit for bit to
    phase 6's run of the seed, logZ in the clustered band, beta 1; one
    replay and one read (t) a run and no other read, no capture; the run
    loop's WHILE node a body run an iteration after the first, the MCMC
    chain's a run a step; the flag kernel's launches as the nodes say; the
    wall per iteration of both; then iterations 21-23 of seed 42 with
    on_device=False under torch.profiler: the device idle share and the
    blocking host reads per iteration, counted from the CUDA runtime calls
    that block the host (cudaStreamSynchronize, cudaEventSynchronize,
    cudaDeviceSynchronize, a synchronous cudaMemcpy), at most one a loop
    chunk plus two an iteration (beta and the termination test), fewer
    than 150, no torch.linalg.eigvalsh operator (the CV's eigenvalues are
    the kernel's) and no EM chunk read, each window's `ps/cluster` host
    ms, then iterations 24-26 traced on the device only (no host ops
    recorded): wall and idle share; and a whole graphed run of seed 42
    under the profiler (`run_window`): wall, device ms and idle share an
    iteration, one blocking read in the run, the top kernels; with
    `--parent DIR`, A's graphed seed 42 in DIR's package before and after
    (parent, this, this, parent);
 7. A again with hardware_prng=True, seed 42, with run(on_device=False) and
    then run(on_device=True), the device run loop, on a sampler whose
    seed-43 run captured its graph: every MCMC step draws through the
    mutation-draws kernel (in the chain's WHILE node with on_device=True);
    the ladder, logZ, steps, calls, launches and the draws' final state
    (call counter, host mirror and device words) equal bit for bit; one
    replay and one read; the wall per iteration of both; then iterations
    21-23 eagerly under torch.profiler, held to 6b's rule on blocking host
    reads, and a whole graphed run, as 6b's;
 8. B: the large-ensemble hardware_prng configuration of
    benchmarks/results/hw_prng_e2e.json (10-D Gaussian, n_particles=131072,
    history_capacity=8, unclustered) through its first four mutation
    iterations, eagerly and with the loops' CUDA graphs (one pass captures
    them, a second is timed): the same values, launches and call counter
    in each iteration bit for bit, one normal, one gamma and one uniform
    (the bits kernel) launch per MCMC step (in the WHILE node's body when
    graphed), and seconds per mutation iteration of each; the profiled
    graphed iteration reads no MCMC chunk and runs one WHILE iteration a
    step; then the normal kernel at its R*N*d
    and the ESS kernel at the S reached, each against its plain version;
 9. C: the 10-D bimodal mixture of tests/test_multimodal.py, clustered,
    with run(on_device=False) and then True: bit for bit, launches
    included, its fits replayed as the "hgm_fit" stretch;
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
    seed-43 run captured the graph of its device run loop (its CV step an
    IF node holding the CV bisection's WHILE node; nodes and depth
    printed): bit for bit, logZ inside the anchor taken from the JAX
    package, the probes equal, one launch of the ESS kernel's bracket mode
    a reweight (no "ess_bracket" loop body on the card), no ESS-mode
    launch; one replay and one read a run; walls, probes and loop reads
    per reweight; then iterations 21-23 on the per-iteration route in each
    mode under the profiler, held to 6b's rule, and a whole run on the run
    loop (`run_window`); then a 2-D narrow Gaussian at volume_variation=0.03
    whose CV steps reach the bisection, on the run loop bit for bit with
    on_device=False, CV-bisection WHILE bodies run; then rosenbrock10_cv in
    float64 (`float64_on_loop`), eagerly and on the run loop, bit for bit,
    one replay and one read, logZ inside the anchor;
13. the refit cadence, C with cluster_every=3 (on_device=False and True,
    bit for bit, as C), and a host likelihood: the 10-D Gaussian as a
    numpy per-point function with host_likelihood=True, with pool=None
    and with pool=2 (spawned workers that import this script by name),
    eagerly and on the run loop, the same bits, map calls = handshakes =
    sweeps, the pool's seconds and the rest, a worker raising at a later
    sweep ending the run there and a clean run after reset(); A with its
    likelihood on the host (`rosenbrock_numpy`), seed 42 with
    run(on_device=False) and, on a sampler whose seed-43 run captured the
    graph, run(on_device=True): bit for bit, logZ in the clustered band,
    one replay and one read a run, the host-call kernel's handshakes and
    the pool's map calls equal to the sweeps on both routes (eagerly the
    kernel served at once, on the run loop by the replay), the launches the
    eager run's less its chunks' steps past the stop; the wall, the pool's
    seconds and the rest; then
    tests/test_blobs.py's object payloads on the run loop (each following
    its particle, the store pruned), and a likelihood that raises in a
    later iteration of a run on the run loop (its exception, no call and
    no handshake after it, then after reset() a clean run's bits);
14. float64, every draw keyed on the `_f64` kernels: A at
    dtype=torch.float64, seed 42, with `run(on_device=False)` and, with
    each hardware_prng on a sampler whose seed-43 run captured the graph,
    `run(on_device=True)`, the device run loop (`float64_on_loop`), each
    bit for bit with the eager run (ladder, logZ, steps, calls, launches less the eager
    chunks' steps past the stop, the final draw state), one replay and one
    read a run, the MCMC chain a WHILE node with no read, one float64 ESS
    launch a reweight, one mutation_draws_f64 launch a step body, logZ in
    the clustered band; the two flags the same bits (the flag does not
    apply to float64, as in JAX); walls beside phases 6 and 6b's seed 42;
    B in float64 through its first four mutation iterations, eagerly and
    graphed, bit for bit, one normal_f64, gamma_f64 and uniform_f64 launch
    a step body and no generator draw (its offset unmoved), the
    normal_f64 kernel at B's R*N*d and the float64 ESS kernel at its
    S = 1,048,576 against their plain versions; the 4-D Gaussian of
    tests/test_float64.py with its bars, eagerly and on the run loop; the
    mixture facades on the card (GaussianMixture of each covariance type
    on two blobs, HierarchicalGaussianMixture splitting them,
    predict_proba summing to 1);
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
    run(on_device=True), the device run loop, on a sampler whose seed-43
    run captured its graph (the sharded ESS bisection and the MCMC steps
    WHILE nodes with their NCCL collectives inside; nodes and depth
    printed): bit for bit with the save_every run, one replay and one read
    a run, its steady windows on the per-iteration route in each mode held
    to 6b's rule and a whole run on the run loop; then A under the mesh
    with hardware_prng=True, on_device=False and True: bit for bit, one
    mutation-draws launch a step body, the call counter's device words
    equal to its host mirror; then A under the mesh in float64 eagerly and
    on the run loop (`float64_on_loop`), bit for bit, one replay and one
    read. The process group is destroyed at the end
    of the phase, whatever happens in it, after its mesh and samplers;
16. rosenbrock100: benchmarks/suite.py's 100-D configuration (chained
    Rosenbrock, U(-10, 10), n_particles=2048, n_total=4096,
    history_capacity=256, unclustered) at full width, seed 42, with
    run(on_device=True), the device run loop (one replay, one read), on a
    sampler whose seed-43 run captured its graph: beta 1, posterior ESS >=
    4096, logZ inside the anchor of scripts/rosenbrock100_anchor.py (the
    JAX package on the CPU, seeds 42-46), one eigenvalue launch (d = 100)
    and one ESS launch a reweight, each ESS launch on the streamed route at
    S = 524,288; the first 30 iterations equal bit for bit to a fresh
    seed-42 sampler's sample() calls; one gamma, normal and uniform launch
    an MCMC step; wall, ms and MCMC steps an iteration; iterations 21-23 on
    the per-iteration graphed route
    under the profiler, held to 6b's rule, with the device busy share and
    the device ms an iteration of the eigenvalue kernel, the ESS kernel
    and the top five other kernels;
17. the mutation's two forms (mcmc.py: past N d^2 = 2^21, N the walkers
    over every rank, JAX's K-loop form, one dense matmul a mode, instead of
    per-walker (N, d, d) matrices): 17a, the K-loop form's quadratic and
    proposal step against the gathered form's at B's (R, N, d) =
    (8, 131,072, 10) with one mode and with 16 (the last empty), float32
    and float64, within FORMS_TOL d eps of the product of absolute values;
    their device times in turns at K = 1 and the K-loop's at (1, 2^20,
    100), beside its bound; one tpCN step's device ms at B's,
    rosenbrock100's and the 2^20 path's walkers (a graph of
    MCMCKernel.step replayed between CUDA events); 17b,
    benchmarks/large_scale.py's configuration on one card, unsharded (the
    chained 100-D Rosenbrock, U(-10, 10), N = 2^20, unclustered,
    random_state=5, history_capacity=8, n_candidates=1, n_max_steps=20):
    five sample() calls, each with logZ and the active set's logl finite,
    beta > 0 from the fourth on and the ladder monotone, as the script
    holds them; every mutation in the K-loop form; the path's own peak
    memory (printed beside the gathered form's 83.9 GB) under one gathered
    set; one normal, gamma and uniform launch a step body, one ESS launch
    a reweight, one weighted-median and one mvstud_em launch a mode fit;
    then a sixth call that keeps copies of its mode fit's inputs, and the
    ESS kernel at the S reached (8,388,608), the normal kernel at this
    path's R N d and the bits kernel's uniform mode at its warm-up's
    (N, d) (104,857,600 each), and the weighted-median and Student-t EM
    kernels on that fit's inputs ((1, 4,194,304, 100)), each against its
    plain version (the gamma kernel's 2^20 walkers, and the keyed warm-up
    and resampling uniforms at this path's shapes, are held in phase 4).
    Every mutation of the run took the form JAX's
    switch gives it: A's paths (phases 5-7, 12, 14, 15) gather, B's
    (phases 8 and 14) and rosenbrock100's (16) take the K-loop form, as
    phase 17b does; TF32 stays off.

Every path phase sets the kernels' launch counts to 0 just before it
drives the path and reads them just after. Each run of A (phases 5, 6,
6b's reference, 14) and each B iteration launches the weighted-median
kernel once a mode fit (fits counted by wrapping modes.py's). A kernel's `launches` in the
table is its count on one path (`launches_on`), and must be above 0 (the
bits kernel's is B's uniform mode, one an MCMC step; the float64 kernels'
are A's and B's in float64, phase 14). The last three lines
are the total wall, the kernel table and {"ok": true, "device": {...}}.

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
`--large-scale-only` runs phases 1-2 and 17 and prints no result line;
`--host-only` runs phases 1-2, 4j and 13's host likelihoods and prints
none either; `--handshakes-only [--package-root DIR]` prints 4j's device ms
a handshake at its three shapes, `HANDSHAKES {json}`, and nothing else
(4j's `--parent` turns run it).
`--a-only [--package-root DIR]` runs phases 1-2 and A's seed 42
(on_device=False) and prints its logZ, iterations, steps and ladder
digest; `--parent DIR` makes the full run start that in a process of its
own on DIR's package after phase 6 and print it beside phase 6's seed 42
(not held equal: the EM kernels sum in another order than a parent's
plain loops, which moves the ladder by rounding).
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import gc
import json
import math
import os
import pickle
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path



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
try:  # the conditional nodes of the graphed cluster fit; likewise
    from tempest_tpu_torch.ops import cuda_graphs  # noqa: E402
except ImportError:
    cuda_graphs = None
try:  # the host-call kernel of a host likelihood; likewise
    from tempest_tpu_torch.ops import cuda_host  # noqa: E402
except ImportError:
    cuda_host = None
from tempest_tpu_torch import cluster as cluster_module  # noqa: E402
from tempest_tpu_torch import iteration as iteration_module  # noqa: E402
from tempest_tpu_torch import loops as loops_module  # noqa: E402
from tempest_tpu_torch import mcmc as mcmc_module  # noqa: E402
from tempest_tpu_torch.draws import Draws  # noqa: E402
from tempest_tpu_torch.fused import CHUNKS  # noqa: E402
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
# A host's seed-42 logZ on the card, the same on both routes and on every
# card since its likelihood first crossed to the host (PERF.md section 6):
# a change of the crossing keeps these bits.
A_HOST_LOGZ = -34.861183166503906
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
# The float64 draw kernels against their plain versions on the card: the
# uniforms bit for bit (exact integer arithmetic); the normals (absolute) and
# the gamma draws (relative) within DRAW_TOL_F64, the same double operations
# rounded alike but for the last bits of log, sqrt, sincos, cos and pow; at
# most MAX_FLIPS_F64 gamma draws in a call whose accept test falls the other
# way.
DRAW_TOL_F64 = 1e-12
MAX_FLIPS_F64 = 1
# B: benchmarks/results/hw_prng_e2e.json
B_PARTICLES, B_CAPACITY, B_MUTATIONS = 131072, 8, 4
# The 2^20 path (phase 17b): benchmarks/large_scale.py's N, d and
# history_capacity, and n_max_steps as its help gives for hardware.
LS_PARTICLES, LS_DIM, LS_CAPACITY, LS_MAX_STEPS = 1 << 20, 100, 8, 20
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


def rosenbrock_numpy(x):
    # A's paired Rosenbrock (bench.py:71-77) as a host likelihood of one numpy point.
    return float(-np.sum(100.0 * (x[1::2] - x[::2] ** 2) ** 2 + (1.0 - x[::2]) ** 2))


class TimedPool:
    """A host pool (`Sampler(pool=...)`) that maps in this thread, or a
    sampler's host map `inner` wrapped (`timed_map`), counting its map
    calls and the seconds spent in them; from call `raise_at` on it maps
    `raising_gaussian` in place of the likelihood (None: never)."""

    def __init__(self, inner=None):
        self.inner, self.calls, self.seconds, self.raise_at = inner, 0, 0.0, None

    def map(self, f, xs):
        self.calls += 1
        if self.raise_at is not None and self.calls >= self.raise_at:
            f = raising_gaussian
        t0 = time.perf_counter()
        try:
            return [f(x) for x in xs] if self.inner is None else self.inner(f, xs)
        finally:
            self.seconds += time.perf_counter() - t0

    __call__ = map


def raising_gaussian(x):
    # Raised inside a pool's worker: a built-in type, which the parent unpickles.
    raise RuntimeError(f"likelihood raised in worker {os.getpid()}")


def host_a_sampler(device, seed, pool=None, **kw):
    """A (the canonical clustered problem) with its likelihood on the host:
    `rosenbrock_numpy` with host_likelihood=True."""
    return Sampler(prior_transform, rosenbrock_numpy, n_dim=N_DIM, n_particles=N_PARTICLES,
                   vectorize=True, host_likelihood=True, clustering=True,
                   history_capacity=CAPACITY, random_state=seed, pool=pool, device=device, **kw)


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
def cond_launches() -> int:
    """The conditional nodes' flag-kernel launches since the counts were
    set to 0 (kept apart from counts(), which the on_device=False runs
    must equal: they decide on the host)."""
    return 0 if cuda_graphs is None else cuda_graphs.LAUNCHES


def settle() -> None:
    """Count the launches of the graphs' conditional bodies (a package
    older than them has none)."""
    getattr(loops_module, "settle_launches", lambda: None)()


def reset_counts() -> None:
    settle()
    if cuda_graphs is not None:
        cuda_graphs.LAUNCHES = 0
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
    if cuda_host is not None:
        cuda_host.LAUNCHES = 0


def counts() -> dict:
    settle()
    eig = {} if cuda_linalg is None else {"sym_eigvals": cuda_linalg.LAUNCHES}
    median = {} if cuda_median is None else {"weighted_median": cuda_median.LAUNCHES,
                                             "ess_bracket": cuda_reweight.BRACKET_LAUNCHES}
    em = {} if cuda_em is None else dict(cuda_em.LAUNCHES)
    host = {} if cuda_host is None else {"host_call": cuda_host.LAUNCHES}
    return {"ess_bisect": cuda_reweight.LAUNCHES, "ess_bisect_f64": cuda_reweight.LAUNCHES_F64,
            **eig, **median, **em, **host, **cuda_prng.LAUNCHES}


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


# The form of every mutation prepared in this process (mcmc.py, `Walkers.form`):
# (walkers over every rank, d, form). A package older than the K-loop form
# always gathers.
GATHERED, K_LOOP = "gathered", "k_loop"
FORMS = []


def _record_forms() -> None:
    """Wrap `MCMCKernel.prepare` to append each mutation's form to FORMS."""
    prepare = mcmc_module.MCMCKernel.prepare

    def recording(self, assignments, *args, **kwargs):
        w = prepare(self, assignments, *args, **kwargs)
        FORMS.append((int(assignments.shape[0]) * self.world, self.n_dim,
                      getattr(w, "form", GATHERED)))
        return w

    mcmc_module.MCMCKernel.prepare = recording


def check_switch() -> None:
    """Every mutation of this process took the form JAX's switch gives its
    walkers over every rank (mcmc.py:250): gathered at N d^2 <= 2^21."""
    limit = mcmc_module._GATHER_ELEMS_LIMIT
    wrong = sorted({(n, d, f) for n, d, f in FORMS
                    if f != (GATHERED if n * d * d <= limit else K_LOOP)})
    check(limit == 1 << 21 and not wrong, f"mutation forms against the switch at {limit}: {wrong}")
    taken = {f"{n} {d} {f}": FORMS.count((n, d, f)) for n, d, f in sorted(set(FORMS))}
    print(f"mutation forms, (walkers, d, form) and mutations: {json.dumps(taken)}", flush=True)


def check_forms(what: str, since: int, form: str) -> None:
    """Every mutation prepared since FORMS[since] took `form`, and one did."""
    taken = FORMS[since:]
    check(taken and all(f == form for _, _, f in taken),
          f"{what}: mutation forms {sorted(set(taken))} (want {form} in every mutation)")


def check_em_launches(what: str, launched: dict, mode_fits: int, gmm_fits: int,
                      loops: dict) -> None:
    """On the card every EM loop is one kernel launch and reads nothing: one
    mvstud_em launch a mode fit, one gmm_em launch a GMM EM loop (`gmm_fits`,
    None where they are not counted), and no "mode_em" or "gmm_em" chunk
    read."""
    if cuda_em is None:
        return
    check(launched["mvstud_em"] == mode_fits and gmm_fits in (None, launched["gmm_em"]),
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


def profile_warmup() -> None:
    """The warm-up a profile opens with (device_ms's): its sleeps take the
    device records a profile loses first."""
    for _ in range(PROFILE_WARMUP_LAUNCHES):
        torch.cuda._sleep(100)
    torch.cuda._sleep(PROFILE_WARMUP_CYCLES)
    torch.cuda.synchronize()


_SLEEP_KERNEL = []


def sleep_kernel() -> str:
    """The name of torch.cuda._sleep's device record (read once, early in
    the process, when a profile loses nothing)."""
    if not _SLEEP_KERNEL:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        names = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
        check(len(names) == 1, f"torch.cuda._sleep's device records: {names}")
        _SLEEP_KERNEL.append(names.pop())
    return _SLEEP_KERNEL[0]


def device_rows(prof) -> dict:
    """(device ms, records) by name of a profile that opened with
    profile_warmup: its kernels, copies and fills, not the warm-up's sleeps
    nor the ranges (record_function)."""
    skip = sleep_kernel()
    rows = {}
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA or e.name == skip or e.name.startswith("ps/")
                or getattr(e, "is_user_annotation", False)):
            continue
        ms, c = rows.get(e.name, (0.0, 0))
        rows[e.name] = (ms + e.time_range.elapsed_us() / 1e3, c + 1)
    return rows


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
extern "C" __global__ void log_f64(const double* x, double* y) { y[I] = log(x[I]); }
extern "C" __global__ void sqrt_f64(const double* x, double* y) { y[I] = sqrt(x[I]); }
extern "C" __global__ void cos_f64(const double* x, double* y) { y[I] = cos(x[I]); }
extern "C" __global__ void sincos_f64(const double* x, double* y) {
  double s, c;
  sincos(x[I], &s, &c);
  y[I] = s + c;
}
extern "C" __global__ void pow_f64(const double* x, double* y) { y[I] = pow(x[I], x[I + 1]); }
extern "C" __global__ void div_f64(const double* x, double* y) { y[I] = 1.0 / x[I]; }
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


# The float64 functions of the float64 draw kernels, counted from the SASS
# as exp is: (32-bit integer, float32, float64) instructions of each, set
# and printed in phase 2. The bounds take F64_EST instead, CUDA's double
# functions as sequences of about this many instructions, estimated low:
# the probes' straight-line counts of sqrt, the division and pow lie above
# them (on an NVIDIA H100 80GB HBM3: (11, 2, 24), (8, 1, 25), (42, 6, 91)),
# while log, cos and sincos branch before their main path, so `_fast_path`
# cuts log's body out and keeps sincos's wide-argument reduction in.
F64_FUNCTIONS = ("log", "sqrt", "cos", "sincos", "pow", "div")
F64_FN = {}
F64_EST = {"log": (2, 0, 20), "sqrt": (2, 1, 8), "cos": (4, 0, 14), "sincos": (6, 0, 24),
           "pow": (6, 0, 40), "div": (2, 1, 8)}


def sass_f64_counts(sass: str) -> dict:
    """(int, f32, f64) instructions of each of F64_FUNCTIONS in float64:
    its probe's straight-line arithmetic less the copy probe's."""
    fns = _sass_functions(sass)
    c = _counts(fns["copy_f64"])
    return {name: tuple(max(a - b, 0) for a, b in zip(_counts(fns[f"{name}_f64"]), c))
            for name in F64_FUNCTIONS}


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


# Libraries built beside the package's, one nvcc each, started with phase 2's
# builds: the median and ESS sources with their clock64 stamps compiled in
# (MEDIAN_STAMPS, BRACKET_STAMPS), and, with --parent DIR, DIR's sources of
# those two kernels, timed in turns with this tree's (their C entries are
# the same).
EXTRA_DIR = _build.BUILD_DIR.parent / "chip_smoke"
_EXTRA: dict = {}
MEDIAN_FUNCTIONS = dict(cuda_median.LIBRARY.functions) if cuda_median is not None else {}
ESS_FUNCTIONS = dict(cuda_reweight.LIBRARY.functions)


def start_extra_builds(parent) -> None:
    """Start the builds of the stamped sources and, with `parent` (a
    checkout), of its median and ESS sources, into build/chip_smoke/."""
    jobs = {"median_stamped": (_build.CSRC, "weighted_median.cu", ("-DMEDIAN_STAMPS",)),
            "ess_stamped": (_build.CSRC, "ess_bisect.cu", ("-DBRACKET_STAMPS",))}
    if parent:
        csrc = Path(parent) / "tempest_tpu_torch" / "csrc"
        jobs.update({"median_parent": (csrc, "weighted_median.cu", ()),
                     "ess_parent": (csrc, "ess_bisect.cu", ())})
    EXTRA_DIR.mkdir(parents=True, exist_ok=True)
    for name, (csrc, source, flags) in jobs.items():
        out = EXTRA_DIR / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(out), str(csrc / source)]
        _EXTRA[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                         text=True), out)


def extra_library(name: str, functions: dict):
    """The library `start_extra_builds` built as `name`, loaded with these C
    signatures; None where it was not started."""
    if name not in _EXTRA:
        return None
    handle, out = _EXTRA[name]
    if isinstance(handle, subprocess.Popen):
        _, err = handle.communicate()
        check(handle.returncode == 0, f"nvcc failed for {name}: {err[-3000:]}")
        handle = ctypes.CDLL(str(out))
        _EXTRA[name] = (handle, out)
    for fn, argtypes in functions.items():
        getattr(handle, fn).argtypes = list(argtypes)
        getattr(handle, fn).restype = ctypes.c_int
    return handle


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
        () if cuda_em is None else (cuda_em.GMM_LIBRARY, cuda_em.MVSTUD_LIBRARY)) + (
        () if cuda_graphs is None else (cuda_graphs.LIBRARY,)) + (
        () if cuda_host is None else (cuda_host.LIBRARY,))
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    ptxas = []
    for i, lib in enumerate(libs):  # the same compiles as the libraries', to cubins, verbose
        source = getattr(lib, "directory", _build.CSRC) / lib.source
        cmd = [nvcc, *flags, *lib.extra_flags, "-Xptxas", "-v", "-cubin",
               "-o", os.path.join(tmp, f"ptxas_{i}.cubin"), str(source)]
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
    F64_FN.update(sass_f64_counts(dump.stdout))
    for t, (i, f, d) in exp.items():
        ESS_SAMPLE_PROBE[t] = (ESS_SAMPLE_OTHER[0] + i, f + (ESS_SAMPLE_OTHER[1] if t == "f32" else 0),
                               d + (ESS_SAMPLE_OTHER[1] if t == "f64" else 0))
    names = " ".join(p.name for p in paths.values())
    print(f"build: {names} in {time.perf_counter() - t0:.3f} s (one nvcc per source, in parallel)",
          flush=True)
    print(f"SASS of exp (32-bit integer, float32, float64 instructions of its straight-line path, "
          f"sm_90a): float32 {exp['f32']}, float64 {exp['f64']}; the ESS kernel per sample and "
          f"probe: {ESS_SAMPLE_PROBE}", flush=True)
    print(f"SASS of the float64 draw kernels' functions (the same counts; their bounds take "
          f"the low estimates {json.dumps(F64_EST)}): {json.dumps(F64_FN)}", flush=True)
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


def _route(S: int, dtype=torch.float32, bracket: bool = False) -> str:
    plan = cuda_reweight.plan_launch(S, dtype)
    where = "shared memory" if plan.resident else "streamed from L2"
    threads = cuda_reweight.BRACKET_THREADS if bracket and plan.resident else plan.threads
    return f"cluster {plan.cluster} x {threads} threads x slice {plan.slice}, {where}"


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
GAMMA_SIZES = (1, 3, 5, 1000, B_GAMMA, B_GAMMA + 3, 1 << 18, 1 << 20)  # 2^20: phase 17b's N
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
    # The bits kernel's uniform mode (hw_uniform, one launch): the keyed
    # steps' acceptance uniforms past the mutation-draws kernel's size.
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
    # The uniform mode at the shapes of the path: B's walkers (131,072) and
    # rosenbrock100's (2,048), bit for bit against philox.uniform.
    uniform_equal = {}
    for m in (B_GAMMA, R100_PARTICLES):
        uniform_equal[m] = bool(torch.equal(cuda_prng.hw_uniform(key, 3 + m, (m,), device),
                                            philox.uniform(key, 3 + m, m, device)))
        check(uniform_equal[m], f"the bits kernel's uniform mode differs from "
              f"philox.uniform at n={m}")
    print(f"bits kernel, uniform mode, against philox.uniform at the path's shapes: "
          f"{json.dumps(uniform_equal)}", flush=True)
    keyed = keyed_iteration_uniforms(device)
    for name, kernel_name, sizes in (("normal", "normal_kernel", (n, B_NORMALS, B_GAMMA)),
                                     ("bits", "bits_kernel", (n, B_GAMMA)),
                                     ("uniform", "bits_kernel", (B_GAMMA, R100_PARTICLES))):
        shapes = {}
        for m in sizes:
            if name == "normal":
                fns = {"kernel": lambda m=m: cuda_prng.hw_normal(key, 2, (m,), device),
                       "library": lambda m=m: torch.randn(m, device=device),
                       "plain": lambda m=m: philox.normal(key, 2, m, device)}
                b_ms, b_by = bound(4 * m, *work((-(-m // 4), NORMAL_BLOCK)))
            elif name == "bits":
                fns = {"kernel": lambda m=m: cuda_prng.hw_bits(key, 3, (m,), device),
                       "library": lambda m=m: torch.empty(
                           m, dtype=torch.int32, device=device).random_(),
                       "plain": lambda m=m: philox.bits(key, 3, m, device)}
                b_ms, b_by = bound(4 * m, *work((-(-m // 4), (PHILOX_INT, 0))))
            else:
                fns = {"kernel": lambda m=m: cuda_prng.hw_uniform(key, 3, (m,), device),
                       "library": lambda m=m: torch.rand(m, device=device),
                       "plain": lambda m=m: philox.uniform(key, 3, m, device)}
                b_ms, b_by = bound(4 * m, *work((-(-m // 4), (PHILOX_INT + 4 * UNIT[0],
                                                              4 * UNIT[1]))))
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
            0.0 if bits_equal and all(uniform_equal.values()) and all(keyed.values())
            else float("nan")), **{
                k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                     "device_ms", "library_device_ms")},
            shapes={str(k): v for k, v in shapes.items()})
    # The bits row is the uniform mode's, the mode on the path (B,
    # rosenbrock100), its library call torch.rand; the raw words' mode
    # (hw_bits, library random_) beside it.
    raw = rows.pop("bits")
    rows["bits"] = dict(rows.pop("uniform"), mode="uniform (tempest_uniform, hw_uniform)",
                        hw_uniform_launches=uniform_launches["bits"],
                        uniform_equal={str(k): v for k, v in uniform_equal.items()},
                        keyed_iteration_uniforms=keyed,
                        raw_words={k: raw[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                       "library_ms", "device_ms",
                                                       "library_device_ms", "shapes")})
    rows["gamma"] = phase_gamma_kernel(device, key)
    return rows


# (label, walkers, dimensions) of the keyed iterations' uniforms: A's, B's,
# rosenbrock100's and the 2^20 path's warm-up and resampling draws.
KEYED_UNIFORM_SHAPES = (("A", N_PARTICLES, N_DIM), ("B", B_PARTICLES, N_DIM),
                        ("rosenbrock100", R100_PARTICLES, R100_DIM),
                        ("large_scale", LS_PARTICLES, LS_DIM))


def keyed_iteration_uniforms(device) -> dict:
    """The keyed iterations' uniforms as the main path draws them, through
    `Draws` and its call counter's device word (the bits kernel's uniform
    mode reading key and counter from `PhiloxCounter.state`): the warm-up's
    prior draw (n, d) and patch (n,), two calls; the multinomial
    resampling's (n,) and a systematic resampling's one uniform, one call
    each; from a counter at 2^32 - 1, so the calls cross 2^32. Each draw
    bit for bit against `philox.uniform` at the same call index, the
    counter advanced 2, 1 and 1, one bits launch a draw and no other
    launch, and a draw under a false guard (an untaken IF body) leaving the
    counter where it was. Returns, by shape label, whether all held."""
    draws = Draws(2024, device)
    calls, key, first = draws.calls, draws.calls.key, 2**32 - 1
    out = {}
    for label, n, d in KEYED_UNIFORM_SHAPES:
        calls.seek(first)
        before = counts()
        u_draw, patch = draws.warmup(n, d)
        c1 = calls.counter
        mult = draws.resample(n, "mult")
        c2 = calls.counter
        syst = draws.resample(n, "syst")
        c3 = calls.counter
        launched = diff(counts(), before)
        calls.guards.append(torch.zeros((), dtype=torch.bool, device=device))
        try:
            draws.warmup(n, d)
            draws.resample(n, "mult")
        finally:
            calls.guards.pop()
        c4 = calls.counter
        want = [philox.uniform(key, first, n * d, device).reshape(n, d),
                philox.uniform(key, first + 1, n, device),
                philox.uniform(key, first + 2, n, device),
                philox.uniform(key, first + 3, 1, device).reshape(())]
        equal = [bool(torch.equal(got, w)) for got, w in zip((u_draw, patch, mult, syst), want)]
        steps = (c1 - first, c2 - c1, c3 - c2, c4 - c3)
        out[label] = all(equal) and steps == (2, 1, 1, 0) and launched.get("bits") == 4 \
            and sum(launched.values()) == 4
        print(f"keyed iteration uniforms, {label} (n={n}, d={d}) from call {first}: warm-up, "
              f"patch, mult, syst equal to philox.uniform {equal}; counter steps {steps} "
              f"(2, 1, 1, and 0 under a false guard); launches {launched}", flush=True)
        check(out[label], f"keyed iteration uniforms at {label}'s shapes: equal {equal}, "
              f"counter steps {steps}, launches {launched}")
    return out


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
# Phase 4, float64: the four float64 draw kernels
# ---------------------------------------------------------------------------
# The float64 draws at the main paths' shapes: A's mutation draws and a
# ragged shape; A's warm-up (1024, 10) and (1024,) and resampling (1024,)
# uniforms, and B's (131,072); B's normals (10,485,760) and gamma draws
# (131,072). Drawn through a `PhiloxCounter`'s device words from a call
# index whose gamma draws' 33 calls cross 2^32.
F64_MUTATION_SHAPES = MUTATION_SHAPES[:2]
F64_UNIFORM_SHAPES = ((N_PARTICLES, N_DIM), (N_PARTICLES,), (B_PARTICLES,))
F64_COUNTER = (1 << 32) - 3
# A 53-bit uniform from two words: shifts, an or, a 64-bit add (32-bit
# integer instructions), the conversion and a product (float64 pipe).
UNIT53 = (5, 0, 2)


def _f64(*names_or_tuples):
    """(int, f32, f64) of the sum of F64_EST entries and explicit tuples."""
    parts = [F64_EST[t] if isinstance(t, str) else t for t in names_or_tuples]
    return tuple(sum(p[i] for p in parts) for i in range(3))


def f64_pair_uniform():
    """One Philox block to two float64 uniforms."""
    return _f64((PHILOX_INT, 0, 0), UNIT53, UNIT53)


def f64_pair_normal():
    """One Philox block to two float64 normals: two uniforms, a log, a sqrt,
    a sincos and four products."""
    return _f64(f64_pair_uniform(), "log", "sqrt", "sincos", (0, 0, 4))


def f64_mt_test():
    """A walker's Marsaglia-Tsang test in double: two logs, the cube and
    about 12 sums, products, compares and selects."""
    return _f64("log", "log", (0, 0, 12))


def f64_mt_setup():
    return _f64("sqrt", "div", (0, 0, 4))


def f64_mt_boost():
    return _f64(UNIT53, "div", "pow", (0, 0, 2))


def f64_rounds(counter: int, key, alpha: torch.Tensor, mutation: bool) -> torch.Tensor:
    """The Marsaglia-Tsang rounds each walker's float64 draw needs (its
    first accepted round + 1, or all 16), from the plain version's draws:
    the gamma kernel's layout, or the mutation draws' (`mutation`)."""
    n, dev = alpha.numel(), alpha.device
    _, d, c = philox.mt_setup(alpha.reshape(-1))
    need = torch.full((n,), philox.MT_ROUNDS_F64, dtype=torch.int64, device=dev)
    undecided = torch.ones(n, dtype=torch.bool, device=dev)
    zc, uc, _ = philox.gamma_counters(counter, philox.MT_ROUNDS_F64)
    for r in range(philox.MT_ROUNDS_F64):
        if mutation:
            w0, w1, w2, w3 = philox._blocks(n, philox.STREAM_GAMMA_ROUND0 + 2 * r, counter, key,
                                            dev)
            z = torch.sqrt(-2.0 * torch.log(philox.unit53(w0, w1))) * torch.cos(
                philox.TWO_PI * philox.unit53(w2, w3))
            a0, a1, _, _ = philox._blocks(n, philox.STREAM_GAMMA_ROUND0 + 2 * r + 1, counter, key,
                                          dev)
            u = philox.unit53(a0, a1)
        else:
            z = philox.normal_f64(key, zc[r], n, dev)
            u = philox.uniform_f64(key, uc[r], n, dev)
        ok, _ = philox.mt_accept(z, u, d, c)
        need = torch.where(undecided & ok, r + 1, need)
        undecided &= ~ok
        if not bool(undecided.any()):
            break
    return need


def f64_gamma_bound(key, counter: int, alpha: torch.Tensor):
    """((least ms, what bounds it), mean rounds a walker) of the float64
    gamma kernel on these draws: alpha read and g written once (16 bytes a
    walker); per pair of walkers two Philox blocks, four uniforms and a
    Box-Muller pair a round it runs (as long as one of the two is
    undecided), per walker a test a round it needs, its set-up, and where
    alpha < 1 the boost (and a Philox block a pair with such a walker)."""
    n = alpha.numel()
    need = f64_rounds(counter, key, alpha, mutation=False)
    pad = n % 2
    pairs = torch.nn.functional.pad(need, (0, pad)).reshape(-1, 2).amax(dim=1)
    boosted = torch.nn.functional.pad(alpha.reshape(-1) < 1.0, (0, pad)).reshape(-1, 2)
    pair_round = _f64((2 * PHILOX_INT, 0, 0), UNIT53, UNIT53, f64_pair_normal())
    ops = work((int(pairs.sum()), pair_round), (int(need.sum()), f64_mt_test()),
               (n, f64_mt_setup()), (int(boosted.any(dim=1).sum()), (PHILOX_INT, 0, 0)),
               (int(boosted.sum()), f64_mt_boost()))
    return bound(16 * n, *ops), float(need.double().mean())


def f64_mutation_bound(key, counter: int, alpha: torch.Tensor, z_shape):
    """((least ms, what bounds it), mean rounds a walker) of the float64
    mutation draws: alpha read, z, g and u written once; the proposal
    normals a Philox block a pair; per walker the rounds it needs (two
    Philox blocks, three uniforms, a cos-only normal and a test each), its
    set-up, its boost and acceptance block and, where alpha < 1, its boost."""
    R, N, d = z_shape
    n_z = R * N * d
    need = f64_rounds(counter, key, alpha, mutation=True)
    mt_round = _f64((2 * PHILOX_INT, 0, 0), UNIT53, UNIT53, UNIT53, "log", "sqrt", "cos",
                    (0, 0, 3), f64_mt_test())
    ops = work((-(-n_z // 2), f64_pair_normal()), (int(need.sum()), mt_round),
               (N, f64_mt_setup()), (N, f64_pair_uniform()),
               (int((alpha < 1.0).sum()), f64_mt_boost()))
    return bound(8 * N + 8 * n_z + 16 * N, *ops), float(need.double().mean())


def phase_prng_kernels_f64(device) -> dict:
    """The float64 draw kernels (`tempest_*_f64`) against their plain
    versions (`philox.*_f64`) on the card, through a `PhiloxCounter`'s
    device words at the main paths' shapes: the uniforms bit for bit, the
    normals and gamma draws within DRAW_TOL_F64, at most MAX_FLIPS_F64 gamma
    flips a call, one launch of the right kernel and no other a call; their
    moments; then each kernel's device and call times at its path's shape
    beside its plain version's, the PyTorch call's (`randn`, `rand`,
    `_standard_gamma` in float64) and its bound (bytes at 3.35 TB/s, the
    instructions at Hopper's rates, the double functions counted from the
    SASS in phase 2, the rounds these draws need)."""
    f64 = torch.float64
    key = philox.key_from_seed(2024)
    calls = cuda_prng.PhiloxCounter(key, device)

    def drawn(name, draw):
        """A draw through the counter's words at F64_COUNTER: its values and
        its launches, one of `name` and no other; the words left alone."""
        calls.seek(F64_COUNTER)
        before = counts()
        out = draw()
        launched = diff(counts(), before)
        check(launched.get(name) == 1 and sum(launched.values()) == 1
              and calls.counter == F64_COUNTER,
              f"{name} through the counter's words: launches {launched}, counter "
              f"{calls.counter}")
        return out

    errs = {k: 0.0 for k in ("uniform_f64", "normal_f64", "gamma_f64", "mutation_draws_f64")}
    flips_max = {"gamma_f64": 0, "mutation_draws_f64": 0}
    equal = {}
    for shape in F64_UNIFORM_SHAPES:
        got = drawn("uniform_f64", lambda: calls.uniform(0, shape, f64))
        want = philox.uniform_f64(key, F64_COUNTER, math.prod(shape), device).reshape(shape)
        equal[str(shape)] = bool(torch.equal(got, want)) and got.dtype == f64
        check(equal[str(shape)], f"uniform_f64 at {shape} differs from philox.uniform_f64")
    print(f"uniform_f64 through the counter's words, bit for bit with philox.uniform_f64: "
          f"{json.dumps(equal)}", flush=True)
    for total in (B_NORMALS, 7):
        got = drawn("normal_f64", lambda: calls.normal(0, (total,), f64))
        err = float(torch.max(torch.abs(got - philox.normal_f64(key, F64_COUNTER, total,
                                                                 device))))
        print(f"normal_f64 n={total}: max|dz| = {err:.3g} against philox.normal_f64", flush=True)
        check(got.dtype == f64 and err <= DRAW_TOL_F64, f"normal_f64 n={total}: {err}")
        errs["normal_f64"] = max(errs["normal_f64"], err)

    def gamma_err(got, want, name, label):
        flips = int(torch.sum(torch.abs(got - want) > DRAW_TOL_F64 * torch.abs(want)))
        agree = torch.abs(got - want) <= DRAW_TOL_F64 * torch.abs(want)
        rel = torch.abs(got - want) / torch.clamp(torch.abs(want), min=1e-300)
        err = float(torch.max(rel[agree])) if bool(agree.any()) else 0.0
        check(flips <= MAX_FLIPS_F64 and bool(torch.all(torch.isfinite(got) & (got >= 0))),
              f"{name} {label}: {flips} flips")
        errs[name] = max(errs[name], err)
        flips_max[name] = max(flips_max[name], flips)
        return f"{label} {flips}/{err:.3g}"

    summary = []
    for n in (B_GAMMA, 1001):
        for label, alpha in gamma_cases(device, n):
            alpha = alpha.to(f64)
            got = drawn("gamma_f64", lambda: calls.gamma(0, alpha))
            summary.append(gamma_err(got, philox.gamma_f64(key, F64_COUNTER, alpha), "gamma_f64",
                                     f"n={n} {label}"))
    print(f"gamma_f64 against philox.gamma_f64 from call {F64_COUNTER} (flips / max relative "
          f"|dg| elsewhere): {', '.join(summary)}", flush=True)
    for R, N, d in F64_MUTATION_SHAPES:
        third = N // 3
        alpha = torch.cat([torch.full((third,), 7.5), torch.full((third,), 0.7),
                           torch.full((N - 2 * third,), 0.02)]).to(device, f64)
        z, g, u = drawn("mutation_draws_f64", lambda: calls.mutation_draws(0, alpha, (R, N, d)))
        wz, wg, wu = philox.mutation_draws_f64(key, F64_COUNTER, alpha, (R, N, d))
        err_z = float(torch.max(torch.abs(z - wz)))
        later = int((f64_rounds(F64_COUNTER, key, alpha, mutation=True) > 1).sum())
        line = gamma_err(g, wg, "mutation_draws_f64", f"{R}x{N}x{d}")
        print(f"mutation_draws_f64 {R}x{N}x{d}: max|dz| = {err_z:.3g}, u bit for bit "
              f"{bool(torch.equal(u, wu))}, g flips / error {line}; {later} walkers decided "
              "by a later round", flush=True)
        check(z.dtype == g.dtype == u.dtype == f64 and err_z <= DRAW_TOL_F64
              and torch.equal(u, wu) and later > 0,
              f"mutation_draws_f64 {R}x{N}x{d}: z {err_z}, u equal {torch.equal(u, wu)}, "
              f"later rounds {later}")
        errs["mutation_draws_f64"] = max(errs["mutation_draws_f64"], err_z)

    # moments at B's sizes
    z = cuda_prng.hw_normal(key, 5, (B_NORMALS,), device, f64)
    zm, zv, zk = _moments(z)
    u = cuda_prng.hw_uniform(key, 6, (B_GAMMA,), device, f64)
    g = cuda_prng.hw_gamma(key, 7, torch.full((B_GAMMA,), 7.5, dtype=f64, device=device))
    gm, gv = float(g.mean()), float(g.var())
    print(f"float64 moments: normal n={B_NORMALS} mean={zm:.6f} var={zv:.6f} kurt={zk:.5f}; "
          f"uniform n={B_GAMMA} min={float(u.min()):.3g} max={float(u.max())} "
          f"mean={float(u.mean()):.5f}; gamma(7.5) n={B_GAMMA} mean={gm:.4f} var={gv:.4f}",
          flush=True)
    check(abs(zm) < 0.002 and abs(zv - 1.0) < 0.005 and abs(zk - 3.0) < 0.02, "normal_f64 moments")
    check(0.0 < float(u.min()) and float(u.max()) <= 1.0 and abs(float(u.mean()) - 0.5) < 0.005,
          "uniform_f64 moments")
    check(abs(gm - 7.5) < 5 * math.sqrt(7.5 / B_GAMMA) + 0.01 and abs(gv - 7.5) < 0.4,
          "gamma_f64 moments")

    # times at the paths' shapes
    rows = {}
    R, N, d = MUTATION_SHAPES[0]
    alpha_a = torch.cat([torch.full((N // 2,), 7.5), torch.full((N // 2,), 0.7)]).to(device, f64)
    alpha_b = torch.full((B_GAMMA,), GAMMA_TIMED_ALPHA, dtype=f64, device=device)
    cases = {
        "mutation_draws_f64": dict(
            shape=f"{R}x{N}x{d}", kernel="mutation_draws_f64_kernel",
            fn=lambda: cuda_prng.hw_mutation_draws(key, 1, alpha_a, (R, N, d)),
            library=lambda: (torch.randn((R, N, d), dtype=f64, device=device),
                             torch._standard_gamma(alpha_a),
                             torch.rand(N, dtype=f64, device=device)),
            plain=lambda: philox.mutation_draws_f64(key, 1, alpha_a, (R, N, d)),
            bound=lambda: f64_mutation_bound(key, 1, alpha_a, (R, N, d))),
        "normal_f64": dict(
            shape=B_NORMALS, kernel="normal_f64_kernel",
            fn=lambda: cuda_prng.hw_normal(key, 2, (B_NORMALS,), device, f64),
            library=lambda: torch.randn(B_NORMALS, dtype=f64, device=device),
            plain=lambda: philox.normal_f64(key, 2, B_NORMALS, device),
            bound=lambda: (bound(8 * B_NORMALS, *work((B_NORMALS // 2, f64_pair_normal()))),
                           None)),
        "uniform_f64": dict(
            shape=B_GAMMA, kernel="uniform_f64_kernel",
            fn=lambda: cuda_prng.hw_uniform(key, 3, (B_GAMMA,), device, f64),
            library=lambda: torch.rand(B_GAMMA, dtype=f64, device=device),
            plain=lambda: philox.uniform_f64(key, 3, B_GAMMA, device),
            bound=lambda: (bound(8 * B_GAMMA, *work((B_GAMMA // 2, f64_pair_uniform()))), None)),
        "uniform_f64 A": dict(
            shape=N_PARTICLES * N_DIM, kernel="uniform_f64_kernel",
            fn=lambda: cuda_prng.hw_uniform(key, 3, (N_PARTICLES, N_DIM), device, f64),
            library=lambda: torch.rand((N_PARTICLES, N_DIM), dtype=f64, device=device),
            plain=lambda: philox.uniform_f64(key, 3, N_PARTICLES * N_DIM, device),
            bound=lambda: (bound(8 * N_PARTICLES * N_DIM, *work(
                (N_PARTICLES * N_DIM // 2, f64_pair_uniform()))), None)),
        "gamma_f64": dict(
            shape=B_GAMMA, kernel="gamma_f64_kernel",
            fn=lambda: cuda_prng.hw_gamma(key, 10, alpha_b),
            library=lambda: torch._standard_gamma(alpha_b),
            plain=lambda: philox.gamma_f64(key, 10, alpha_b),
            bound=lambda: f64_gamma_bound(key, 10, alpha_b)),
    }
    for name, c in cases.items():
        t = timed_in_turns({"kernel": c["fn"], "library": c["library"]})
        t.update(timed_in_turns({"plain": c["plain"]}, calls=10))
        dev = {"kernel": device_ms(c["fn"], c["kernel"]), "library": device_ms(c["library"])}
        (b_ms, b_by), rounds = c["bound"]()
        row = dict(ms=t["kernel"], device_ms=dev["kernel"], plain_ms=t["plain"],
                   library_ms=t["library"], library_device_ms=dev["library"], bound_ms=b_ms,
                   bound_by=b_by, shape=c["shape"])
        if rounds is not None:
            row["mean_rounds"] = rounds
        print(f"{name} timing at {c['shape']}: kernel call {t['kernel']:.4f} ms device "
              f"{dev['kernel']:.4f} ms; library call {t['library']:.4f} ms device "
              f"{dev['library']:.4f} ms; plain {t['plain']:.4f} ms; bound {b_ms:.6f} ms ({b_by}"
              f"{'' if rounds is None else f'; {rounds:.4f} rounds a walker'})", flush=True)
        base = name.split()[0]
        if base in rows:
            rows[base]["shapes"][str(c["shape"])] = row
        else:
            rows[base] = dict(row, max_abs_err=errs[base], shapes={str(c["shape"]): dict(row)})
    for name in ("gamma_f64", "mutation_draws_f64"):
        rows[name]["gamma_flips"] = flips_max[name]
    rows["uniform_f64"]["uniform_equal"] = equal
    return rows


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
# 4 on Hopper; DADD taken as 8 (estimated). Phase 4c also measures it
# (`add_latency_cycles`) and prints the bound at the measured latency.
ADD_LATENCY = {torch.float32: 4, torch.float64: 8}
# One thread adding a value to a sum 64 times a round, clock64 around the
# rounds: the cycles of a dependent add in each type.
ADD_LATENCY_PROBE = r"""
#include <cuda_runtime.h>
template <typename T>
__global__ void add_chain(const T* in, T* out, long long* cycles, int reps) {
  T s = in[0];
  const T v = in[1];
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int k = 0; k < 64; ++k) s = s + v;
  }
  const long long t1 = clock64();
  out[0] = s;
  cycles[0] = t1 - t0;
}
extern "C" int add_chain_launch(const void* in, void* out, void* cycles, int reps, int f64,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64) {
    add_chain<double><<<1, 1, 0, st>>>(static_cast<const double*>(in), static_cast<double*>(out),
                                       static_cast<long long*>(cycles), reps);
  } else {
    add_chain<float><<<1, 1, 0, st>>>(static_cast<const float*>(in), static_cast<float*>(out),
                                      static_cast<long long*>(cycles), reps);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def add_latency_cycles(device) -> dict:
    """Cycles of one dependent add on this card, float32 and float64: the
    probe's clock64 cycles at 1,001 rounds of 64 adds less those at 1, over
    64,000."""
    tmp = tempfile.mkdtemp(prefix="add_probe_")
    src, lib = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "libprobe.so")
    with open(src, "w") as f:
        f.write(ADD_LATENCY_PROBE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src], check=True,
                   capture_output=True, timeout=300)
    fn = ctypes.CDLL(lib).add_chain_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = {}
    for dtype in (torch.float32, torch.float64):
        x = torch.tensor([0.0, 1e-3], dtype=dtype, device=device)
        y = torch.empty(1, dtype=dtype, device=device)
        cycles = torch.empty(1, dtype=torch.int64, device=device)
        spent = {}
        for reps in (1, 1001):
            best = None
            for _ in range(3):
                check(fn(x.data_ptr(), y.data_ptr(), cycles.data_ptr(), reps,
                         int(dtype == torch.float64),
                         torch.cuda.current_stream(device).cuda_stream) == 0, "add probe")
                torch.cuda.synchronize()
                best = int(cycles.item()) if best is None else min(best, int(cycles.item()))
            spent[reps] = best
        out[dtype] = (spent[1001] - spent[1]) / (1000 * 64)
    print(f"dependent add latency on this card (one thread, clock64): float32 "
          f"{out[torch.float32]:.2f} cycles, float64 {out[torch.float64]:.2f} cycles", flush=True)
    return out


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


def median_work(d_sorted, order, wbar) -> dict:
    """What the median must do on these inputs, from the plain version's
    running sums (torch.cumsum of the gathered weights, as on the path):
    each column's crossing (its last point added: the first sum >= thr, or
    the last point where none), its nonzero weights up to the crossing (the
    chain the kernel adds: a zero leaves the sum as it is), the order
    entries up to the crossing of each column (read once for the K rows)
    and the distinct weights they gather."""
    K, (n, d) = wbar.shape[0], d_sorted.shape
    thr = torch.tensor(cuda_median.THRESHOLD, dtype=wbar.dtype).item()
    gathered = wbar[..., order]  # (K, n, d)
    crossed = torch.cumsum(gathered, dim=-2) >= thr
    last = torch.where(crossed.any(dim=-2), torch.argmax(crossed.to(torch.int8), dim=-2),
                       torch.full_like(crossed[..., 0, :], n - 1, dtype=torch.int64))  # (K, d)
    nonzero = torch.cumsum((gathered != 0).to(torch.int64), dim=-2)  # NaN counts
    chain = torch.gather(nonzero, -2, last.unsqueeze(-2)).squeeze(-2)  # (K, d)
    upto = torch.arange(n, device=order.device)[:, None] <= last[:, None, :]  # (K, n, d)
    need = torch.zeros(K, n, dtype=torch.bool, device=order.device)
    for k in range(K):
        need[k, order[upto[k]]] = True
    return {"longest_chain": int(chain.max()), "chain_adds": int(chain.sum()),
            "order_entries": int((last.max(dim=0).values + 1).sum()),
            "weights": int(need.sum()), "longest_crossing": int(last.max()) + 1}


def median_bound(K, d, dtype, work: dict, latency=None) -> dict:
    """The least time of the median at these inputs (`median_work`): the
    chain, the longest column's nonzero weights up to its crossing each
    waiting for the last, at one dependent add per ADD_LATENCY cycles of the
    boost clock, against the bytes, the order entries and weights up to the
    crossings read once and the K d medians gathered and written, at 3.35
    TB/s. Zero weights cost the chain nothing (a zero add leaves the sum
    bit for bit), so they count as bytes only. `latency`: the measured
    cycles of a dependent add (`add_latency_cycles`), which the bound takes
    where given; the chain at ADD_LATENCY is reported beside it."""
    size = torch.tensor([], dtype=dtype).element_size()
    n_bytes = 8 * work["order_entries"] + size * (work["weights"] + 2 * K * d)
    bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    per_add_ms = 1e3 / (SM_CLOCKS_PER_S / N_SMS)
    nominal_ms = work["longest_chain"] * ADD_LATENCY[dtype] * per_add_ms
    chain_ms = work["longest_chain"] * (latency or ADD_LATENCY[dtype]) * per_add_ms
    return {"bytes_bound_ms": bytes_ms, "chain_bound_ms": chain_ms,
            "chain_at_nominal_latency_ms": nominal_ms, "add_latency_cycles": latency,
            "bound_ms": max(bytes_ms, chain_ms),
            "bound_by": "operations" if chain_ms >= bytes_ms else "bytes"}


# The weighted median's stamps (csrc/weighted_median.cu, MEDIAN_STAMPS): a
# column's fields, in order.
MEDIAN_STAMP_FIELDS = ("start", "first_ready", "wait", "add", "end", "stages", "values",
                       "gather_enter", "gather_order", "gather_weights", "gather_arrive")
MEDIAN_STAMP_COLUMNS = 1024


def median_split(label: str, lib, ds, order, wbar, rate: float) -> dict:
    """One launch of the stamped median on these inputs: each column's
    clock64 marks (the first stage ready, the cycles waiting for stages and
    adding them, its whole span, the stages and values added; when stage
    0's gathering warp entered, had its order entries and its weights, and
    arrived, from the chain thread's start), as the median and the largest
    over the columns, in microseconds at the SM clock `rate` (cycles a
    us)."""
    K, (n, d) = wbar.shape[0], ds.shape
    mu = torch.empty(K, d, dtype=ds.dtype, device=ds.device)
    entry = lib.tempest_weighted_median if ds.dtype == torch.float32 else \
        lib.tempest_weighted_median_f64
    _build.check(entry(ds.data_ptr(), order.data_ptr(), wbar.data_ptr(), mu.data_ptr(), n, d, K,
                       cuda_median._THRESHOLDS[ds.dtype], torch.cuda.current_stream().cuda_stream),
                 "stamped weighted_median")
    torch.cuda.synchronize()
    want = cuda_median.weighted_median_presorted_reference(ds, order, wbar)
    check(torch.equal(_bits(mu), _bits(want)), f"stamped weighted_median {label}: not the plain "
          "version's bits")
    out = (ctypes.c_int64 * (MEDIAN_STAMP_COLUMNS * len(MEDIAN_STAMP_FIELDS)))()
    _build.check(lib.tempest_median_stamps(ctypes.addressof(out)), "tempest_median_stamps")
    rows = np.array(out, dtype=np.int64).reshape(MEDIAN_STAMP_COLUMNS, -1)[:K * d]
    f = {name: rows[:, i] for i, name in enumerate(MEDIAN_STAMP_FIELDS)}
    us = {"first_ready": (f["first_ready"] - f["start"]) / rate, "wait": f["wait"] / rate,
          "add": f["add"] / rate, "span": (f["end"] - f["start"]) / rate,
          # stage 0's gathering warp, from the chain thread's start
          "gather_enter": (f["gather_enter"] - f["start"]) / rate,
          "gather_order": (f["gather_order"] - f["start"]) / rate,
          "gather_weights": (f["gather_weights"] - f["start"]) / rate,
          "gather_arrive": (f["gather_arrive"] - f["start"]) / rate}
    cycles_a_value = f["add"] / np.maximum(f["values"], 1)
    slowest = int(np.argmax(f["end"] - f["start"]))
    split = {"columns": K * d,
             "median_us": {k: float(np.median(v)) for k, v in us.items()},
             "max_us": {k: float(v.max()) for k, v in us.items()},
             "slowest_column": {**{k: float(v[slowest]) for k, v in us.items()},
                                "stages": int(f["stages"][slowest]),
                                "values": int(f["values"][slowest])},
             "values_median": float(np.median(f["values"])), "values_max": int(f["values"].max()),
             "add_cycles_a_value_median": float(np.median(cycles_a_value[f["values"] > 0]))
             if (f["values"] > 0).any() else None,
             "sm_cycles_per_us": rate}
    print(f"weighted_median stamps {label} (K, n, d) = {(K, n, d)}: {json.dumps(split)}",
          flush=True)
    return split


def median_parent_fn(lib, ds, order, wbar):
    """A launch of the parent's median kernel (--parent) on these inputs,
    through its C entry (the same signature), into a new output."""
    K, (n, d) = wbar.shape[0], ds.shape
    entry = lib.tempest_weighted_median if ds.dtype == torch.float32 else \
        lib.tempest_weighted_median_f64

    def run():
        mu = torch.empty(K, d, dtype=ds.dtype, device=ds.device)
        _build.check(entry(ds.data_ptr(), order.data_ptr(), wbar.data_ptr(), mu.data_ptr(), n, d,
                           K, cuda_median._THRESHOLDS[ds.dtype],
                           torch.cuda.current_stream().cuda_stream), "parent weighted_median")
        return mu
    return run


def device_in_turns(fns: dict, kernel: str, calls: int) -> dict:
    """Device ms a call of each function (torch.profiler, `device_ms`), in
    turns: in the order given, then back (parent, this, this, parent)."""
    out = {k: [] for k in fns}
    for k in [*fns, *reversed(fns)]:
        out[k].append(device_ms(fns[k], kernel, calls=calls))
    return out


def phase_median_kernel(device, a_rows) -> dict:
    """tempest_weighted_median (_f64) against its plain version, bit for bit,
    at MEDIAN_SHAPES, MEDIAN_EXTRA and A's own fit rows (`a_rows`: the
    (d_sorted, order, wbar) of A's seed 42 mode fit at iteration 21) in
    float32 and float64, two launches the same bits; in float32 at A's fit
    rows, MEDIAN_SHAPES, its call and device time in turns with the plain
    version and the library call (torch.cumsum and argmax of the gathered
    weights, the gather done before), beside its bound (`median_bound`);
    with --parent, its device time in turns with the parent's kernel
    (parent, this, this, parent); the clock64 split of a column on A's fit
    rows and B's (the stamped build)."""
    accumulation = cumsum_accumulation(device)
    cases = [(label, *shape, ()) for label, shape in MEDIAN_SHAPES.items()] + [
        ("extra", *shape) for shape in MEDIAN_EXTRA]
    up = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731
    for dtype in (torch.float32, torch.float64):
        inputs = [(label, (K, n, d), zero_rows, median_inputs(
            device, K, n, d, dtype, seed=n + d, zero_rows=zero_rows))
            for label, K, n, d, zero_rows in cases]
        rows = a_rows if dtype == torch.float32 else tuple(up(t) for t in a_rows)
        inputs.append(("A fit rows", (rows[2].shape[0], *rows[0].shape), (), rows))
        for label, shape, zero_rows, (ds, order, wbar) in inputs:
            got = cuda_median.weighted_median_presorted(ds, order, wbar)
            again = cuda_median.weighted_median_presorted(ds, order, wbar)
            want = cuda_median.weighted_median_presorted_reference(ds, order, wbar)
            torch.cuda.synchronize()
            check(torch.equal(_bits(got), _bits(want)) and torch.equal(_bits(got), _bits(again)),
                  f"weighted_median {label} {shape} {dtype}: the kernel's medians are not the "
                  "plain version's bits")
            check(all(torch.equal(got[k], ds[0]) for k in zero_rows),
                  f"weighted_median {shape}: an all-zero row is not d_sorted[0]")
    ds, order, wbar = a_rows
    live = int((wbar != 0).any(dim=1).sum())
    print("weighted_median: the kernel equals its plain version bit for bit (max|dmu| = 0) at "
          f"{[c[1:4] for c in cases]} and A's fit rows {(wbar.shape[0], *ds.shape)} ({live} rows "
          f"with a nonzero weight, {int((wbar != 0).sum())} nonzero weights) in float32 and "
          "float64 (rows all zero: d_sorted[0]); two launches the same bits", flush=True)
    timed = {"A": a_rows}
    timed.update({"A synthetic" if label == "A" else label: median_inputs(
        device, K, n, d, torch.float32, seed=n + d) for label, (K, n, d) in MEDIAN_SHAPES.items()})
    parent = extra_library("median_parent", MEDIAN_FUNCTIONS)
    latency = add_latency_cycles(device)
    shapes = {}
    for label, (ds, order, wbar) in timed.items():
        (n, d), K = ds.shape, wbar.shape[0]
        gathered = wbar[..., order]
        thr = torch.tensor(cuda_median.THRESHOLD, dtype=torch.float32).item()
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
        work = median_work(ds, order, wbar)
        b = median_bound(K, d, torch.float32, work, latency[torch.float32])
        row = dict(K=K, n=n, d=d, **work, ms=t["kernel"], device_ms=min(dev),
                   device_ms_turns=dev, plain_ms=t["plain"], library_ms=t["library"],
                   library_device_ms=lib, **b)
        turns = ""
        if parent is not None:
            theirs = median_parent_fn(parent, ds, order, wbar)
            check(torch.equal(_bits(theirs()), _bits(kernel())), f"weighted_median {label}: the "
                  "parent's kernel and this one differ")
            row["in_turns_with_parent"] = device_in_turns(
                {"parent": theirs, "this": kernel}, "weighted_median", calls=10)
            turns = f"; in turns (parent, this, this, parent): {row['in_turns_with_parent']}"
        shapes[label] = row
        print(f"weighted_median timing {label} (K, n, d) = {(K, n, d)}, longest chain "
              f"{work['longest_chain']} nonzero adds (crossing at {work['longest_crossing']} "
              f"points): kernel call {t['kernel']:.4f} ms device {dev[0]:.4f} / {dev[1]:.4f} ms; "
              f"plain {t['plain']:.4f} ms; library (torch.cumsum + argmax) call "
              f"{t['library']:.4f} ms, its cumsum's device time {lib:.4f} ms; bound "
              f"{b['bound_ms']:.5f} ms ({b['bound_by']}: chain {b['chain_bound_ms']:.5f} at the "
              f"measured {latency[torch.float32]:.2f} cycles an add, "
              f"{b['chain_at_nominal_latency_ms']:.5f} at {ADD_LATENCY[torch.float32]}; bytes "
              f"{b['bytes_bound_ms']:.5f}){turns} (calls: medians of synchronized calls in turns)",
              flush=True)
    stamped = extra_library("median_stamped", {**MEDIAN_FUNCTIONS,
                                               "tempest_median_stamps": [ctypes.c_void_p]})
    split = {}
    if stamped is not None:
        rate = sm_cycles_per_us()
        for label in ("A", "B"):
            split[label] = median_split(label, stamped, *timed[label], rate)
    # The row: B's fit, the path the kernel was written for.
    return dict(shapes["B"], max_abs_err=0.0, shapes=shapes, cumsum_accumulation=accumulation,
                stamps=split)


# ---------------------------------------------------------------------------
# Phase 4e: the conditional nodes' flag kernel (no Pallas counterpart)
# ---------------------------------------------------------------------------
# A's cluster fit: k_max = 16 leaves, min(max_rounds, k_max - 1) = 15
# possible split rounds, an IF node each.
COND_K_MAX, COND_NODES = 16, 15


def cond_graph(device, go, n_leaves, ran) -> torch.cuda.CUDAGraph:
    """A graph of COND_NODES IF nodes, each on go & (n_leaves < COND_K_MAX)
    as the fit's rounds make them, each body adding one to `ran`."""
    side, body = torch.cuda.Stream(device), torch.cuda.Stream(device)
    pool = cuda_graphs.body_pool(body)
    graph = torch.cuda.CUDAGraph()
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        graph.capture_begin()
        for _ in range(COND_NODES):
            with cuda_graphs.if_body(go & (n_leaves < COND_K_MAX), pool, body):
                ran.add_(1)
        graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(side)
    return graph


def phase_cond_kernel(device) -> dict:
    """4e: the kernel that sets a conditional node's flag
    (csrc/graph_cond.cu, set_conditional, through ops/cuda_graphs.if_body)
    against its plain version, the host's read of go and the leaf count
    deciding each round as the fit's eager route does (Loops.read): a
    graph of A's 15 nodes replayed on every (go, n_leaves) the rounds meet
    must run its bodies exactly where the host decides to (max_abs_err:
    the largest difference in bodies run); its device time a launch (the
    profile's), a replay's call time a node with every node untaken and
    with every node taken, against one plain decision's call time, beside
    its bound (the predicate's 5 bytes read once)."""
    go = torch.zeros((), dtype=torch.bool, device=device)
    n_leaves = torch.zeros((), dtype=torch.int32, device=device)
    ran = torch.zeros((), dtype=torch.int64, device=device)
    graph = cond_graph(device, go, n_leaves, ran)
    loops, err = Loops(device), 0
    for g in (True, False):
        for n in (1, 2, 8, COND_K_MAX - 1, COND_K_MAX):
            go.fill_(g)
            n_leaves.fill_(n)
            ran.zero_()
            graph.replay()
            go_h, n_h = loops.read("plain", go, n_leaves)
            err = max(err, abs(int(ran.item()) - (COND_NODES if go_h and n_h < COND_K_MAX else 0)))
    check(err == 0, f"set_conditional: the nodes ran bodies where the host decided otherwise "
                    f"({err})")
    go.fill_(True)
    n_leaves.fill_(COND_K_MAX)  # every node untaken, as the fit's spare rounds
    untaken = timed_in_turns({"replay": graph.replay})["replay"] / COND_NODES
    dev = device_ms(graph.replay, "set_conditional", calls=10) / COND_NODES
    n_leaves.fill_(1)  # every node taken
    taken = timed_in_turns({"replay": graph.replay})["replay"] / COND_NODES
    plain = timed_in_turns({"read": lambda: loops.read("plain", go, n_leaves)})["read"]
    bound = 1e3 * 5 / HBM_BYTES_PER_S
    print(f"set_conditional: {COND_NODES} IF nodes on go & (n_leaves < {COND_K_MAX}) run their "
          f"bodies where the host's read decides to, at every (go, n_leaves) tried "
          f"(max_abs_err {err}); device {dev:.5f} ms a launch; a replay's call {untaken:.5f} ms "
          f"a node untaken, {taken:.5f} ms taken (a body of one add); the plain decision (one "
          f"blocking read) {plain:.5f} ms; bound {bound:.3g} ms (bytes)", flush=True)
    return dict(max_abs_err=float(err), ms=untaken, plain_ms=plain, bound_ms=bound,
                bound_by="bytes", library_ms=None, device_ms=dev, taken_ms=taken,
                nodes=COND_NODES)


# ---------------------------------------------------------------------------
# Phase 4f: what a conditional node costs the device
# ---------------------------------------------------------------------------
WHILE_ITERATIONS = 1000  # runs of the empty body timed in one replay


def event_ms(fn, calls: int = 20) -> float:
    """The median device time of `fn()` between two CUDA events on the
    current stream (the host enqueues a replay in one launch)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _captured(device, build) -> torch.cuda.CUDAGraph:
    """A graph of what `build()` enqueues, captured on a side stream."""
    side, current = torch.cuda.Stream(device), torch.cuda.current_stream(device)
    graph = torch.cuda.CUDAGraph()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        graph.capture_begin()
        build()
        graph.capture_end()
    current.wait_stream(side)
    return graph


def while_cost_empty(device) -> dict:
    """A WHILE node on i < n whose body adds one to i and sets its flag
    (two kernels and the flag kernel): device ms a body run, from one
    replay of WHILE_ITERATIONS runs against one of none, beside a straight
    graph of the same two kernels WHILE_ITERATIONS times."""
    i = torch.zeros((), dtype=torch.int32, device=device)
    n = torch.zeros((), dtype=torch.int32, device=device)
    flag = torch.zeros((), dtype=torch.bool, device=device)
    body = torch.cuda.Stream(device)
    pool = cuda_graphs.body_pool(body)
    nodes = []

    def build_while():
        torch.lt(i, n, out=flag)
        with cuda_graphs.while_body(flag, pool, body) as count:
            i.add_(1)
            torch.lt(i, n, out=flag)
        nodes.extend(count)

    def build_straight():
        for _ in range(WHILE_ITERATIONS):
            i.add_(1)
            torch.lt(i, n, out=flag)

    node, straight = _captured(device, build_while), _captured(device, build_straight)

    def run(graph, runs):
        i.zero_()
        n.fill_(runs)
        graph.replay()

    for runs in (0, 1, 5, WHILE_ITERATIONS):
        run(node, runs)
        check(int(i.item()) == runs, f"WHILE node: {int(i.item())} body runs for {runs}")
    none = event_ms(lambda: run(node, 0))
    many = event_ms(lambda: run(node, WHILE_ITERATIONS))
    flat = event_ms(lambda: run(straight, WHILE_ITERATIONS))
    cuda_graphs.release_pool(device, pool)
    return dict(body_nodes=nodes[0], empty_replay_ms=none,
                while_us=1e3 * (many - none) / WHILE_ITERATIONS,
                straight_us=1e3 * flat / WHILE_ITERATIONS)


def while_cost_a_step(device) -> dict:
    """A's step body (N = 1024, d = 10, R = 8, keyed draws, the MCMC
    kernel's own body) run to its stop by a WHILE node (`Loops.repeat`)
    against the same steps as a straight graph (`Loops.start`, one chunk of
    that many steps): device ms a step of each, from CUDA events around
    each call, whose carry copies in and out are the same."""
    n, d = N_PARTICLES, N_DIM
    g = torch.Generator(device=device)
    g.manual_seed(7)
    u = 0.5 + 0.02 * torch.randn(n, d, generator=g, device=device)
    modes = modes_module.make_mode_statistics(torch.full((d,), 0.5, device=device),
                                              1e-2 * torch.eye(d, device=device),
                                              torch.tensor(6.0, device=device))
    kernel = mcmc_module.MCMCKernel(lambda x, *_: (rosenbrock(x), None), prior_transform, d)
    x = prior_transform(u)
    w = kernel.prepare(torch.zeros(n, dtype=torch.int32, device=device),
                       torch.tensor(0.3, device=device), modes)
    carry = mcmc_module._tensors(kernel.initial_state(u, x, rosenbrock(x), modes.k_max))
    consts = mcmc_module._tensors(w)
    draws = Draws(5, device)

    def body(c, k):
        st = mcmc_module.ChainState(**dict(c, blobs=None))
        z, gm, ua = draws.mcmc_step(kernel.n_candidates, n, d, k["gamma_shape"],
                                    active=kernel.going(st.done, st.iteration))
        return mcmc_module._tensors(kernel.step(mcmc_module.Walkers(**k), st, z, gm, ua))

    def pred(c):
        return kernel.going(c["done"], c["iteration"])

    loops = Loops(device, graphs=True, counters=[draws.calls])

    def chain():  # each call from call index 0: the same draws, the same steps
        draws.calls.seek(0)
        return loops.repeat("probe", pred, body, carry, consts)

    def straight():
        draws.calls.seek(0)
        run = loops.start("straight", body, carry, consts)
        run.advance(steps)
        return run.result()

    steps = int(chain()["iteration"])
    check(steps > kernel.n_steps_min, f"A step body: {steps} steps")
    check(torch.equal(straight()["u"], chain()["u"]),
          "A step body: the straight graph and the WHILE node part")
    node, flat = event_ms(chain, calls=10), event_ms(straight, calls=10)
    graph = loops.graphs_of("probe")[0]
    settle()
    return dict(steps=steps, while_ms_per_step=node / steps, straight_ms_per_step=flat / steps,
                while_us=1e3 * (node - flat) / steps, body_nodes=graph.nodes)


def if_cost_untaken(device) -> dict:
    """A graph of A's COND_NODES IF nodes, every one untaken, against the
    same graph without them (the one add each node's body would run
    elsewhere): device us a node."""
    go = torch.zeros((), dtype=torch.bool, device=device)
    ran = torch.zeros((), dtype=torch.int64, device=device)
    body = torch.cuda.Stream(device)
    pool = cuda_graphs.body_pool(body)

    def build_nodes():
        ran.add_(1)
        for _ in range(COND_NODES):
            with cuda_graphs.if_body(go, pool, body):
                ran.add_(1)

    nodes, bare = _captured(device, build_nodes), _captured(device, lambda: ran.add_(1))
    with_nodes, without = event_ms(nodes.replay), event_ms(bare.replay)
    cuda_graphs.release_pool(device, pool)
    return dict(if_untaken_us=1e3 * (with_nodes - without) / COND_NODES,
                replay_ms=with_nodes, bare_ms=without)


def phase_node_costs(device) -> dict:
    """4f: the device time of a WHILE iteration, with an empty body and
    with A's step body, and of an untaken IF node (CUDA events)."""
    empty, step, untaken = (while_cost_empty(device), while_cost_a_step(device),
                            if_cost_untaken(device))
    print(f"conditional nodes: a WHILE iteration of an empty body ({empty['body_nodes']} nodes: "
          f"an add, a compare, the flag kernel) {empty['while_us']:.3f} us on the device "
          f"(the same two kernels in a straight graph {empty['straight_us']:.3f} us; a replay "
          f"of no iteration {empty['empty_replay_ms']:.4f} ms); A's step body (N = "
          f"{N_PARTICLES}, d = {N_DIM}, {step['steps']} steps, graph nodes "
          f"{step['body_nodes']}) {step['while_ms_per_step']:.4f} ms a step as a WHILE node, "
          f"{step['straight_ms_per_step']:.4f} ms in a straight graph: "
          f"{step['while_us']:.3f} us a step more; an untaken IF node "
          f"{untaken['if_untaken_us']:.3f} us ({COND_NODES} in a replay "
          f"{untaken['replay_ms']:.4f} ms, none {untaken['bare_ms']:.4f} ms)", flush=True)
    return dict(while_empty=empty, while_a_step=step, if_untaken=untaken)


# ---------------------------------------------------------------------------
# Phase 4h: conditional nodes inside conditional bodies
# ---------------------------------------------------------------------------
# WHILE > IF > IF > IF (the run loop > the mutation > the cadence > a split
# round) and WHILE > IF > WHILE (the run loop > the mutation > the MCMC
# chain): a WHILE node of 4 body runs (its counter 3, 2, 1, 0 after each),
# IF level j taken where the counter is at least j, the inner WHILE node 2
# runs; each body adds one to its word.
NESTED_SHAPES = {"while>if>if>if": ([4, 3, 2, 1], 14), "while>if>while": ([4, 3, 6, 0], 18)}


def nested_probe(device, shape: str, graphs: bool) -> dict:
    """One run of `shape` through `Loops` (`repeat`, `when`): graphed, one
    replay of a stretch whose conditional nodes nest; else the host's loop.
    The words, each loop's body runs (`node_bodies` graphed, else `bodies`
    and the reads), and the graph."""
    loops = Loops(device, graphs=graphs)
    eye = torch.eye(4, dtype=torch.int64, device=device)

    def level(left, j):
        def run(s):
            w = s["words"] + eye[j]
            if j < 3:
                w = loops.when(left >= j + 1, level(left, j + 1), {"words": w},
                               f"L{j + 1}")["words"]
            return {"words": w}
        return run

    def inner(s):
        out = loops.repeat("inner", lambda c: c["n"] > 0,
                           lambda c, k: {"n": c["n"] - 1, "w": c["w"] + eye[2]},
                           {"n": torch.full((), 2, dtype=torch.int64, device=device),
                            "w": s["words"] + eye[1]}, {})
        return {"words": out["w"]}

    def body(c, k):
        left = c["left"] - 1
        taken = level(left, 1) if shape == "while>if>if>if" else inner
        words = loops.when(left >= 1, taken, {"words": c["words"] + eye[0]}, "L1")["words"]
        return {"left": left, "words": words}

    def stretch(inputs):
        return loops.repeat("outer", lambda c: c["left"] > 0, body, dict(inputs), {})

    inputs = {"left": torch.full((), 4, dtype=torch.int64, device=device),
              "words": torch.zeros(4, dtype=torch.int64, device=device)}
    reset_counts()
    out = loops.once("nested", stretch, inputs) if graphs else stretch(inputs)
    torch.cuda.synchronize()
    settle()
    flags = cond_launches()
    stats = {k: dict(v) for k, v in loops.stats.items()}
    graph = loops.graphs_of("nested")[0] if graphs else None
    return dict(words=out["words"].tolist(), stats=stats, set_conditional=flags,
                nodes=None if graph is None else graph.nodes,
                depth=None if graph is None else graph.depth,
                capture_s=None if graph is None else graph.capture_s)


def phase_nested_nodes(device) -> dict:
    """4h: each NESTED_SHAPES shape graphed (one replay, the words and each
    body's runs counted on the device, the flag kernel's launches) against
    the host's loop, with the graph's nodes, depth and capture seconds."""
    out = {}
    for shape, (want, flags) in NESTED_SHAPES.items():
        eager, graphed = nested_probe(device, shape, False), nested_probe(device, shape, True)
        check(eager["words"] == graphed["words"] == want,
              f"nested nodes {shape}: words {graphed['words']} graphed, {eager['words']} "
              f"eagerly, want {want}")
        runs = {k: v.get("node_bodies", 0) for k, v in graphed["stats"].items()
                if v.get("node_bodies")}
        host = {k: v.get("bodies", 0) + v.get("reads", 0) for k, v in eager["stats"].items()}
        check(runs.get("outer") == want[0] and runs.get("L1") == want[1]
              and graphed["set_conditional"] == flags and graphed["stats"]["nested"].get(
                  "replays") == 1,
              f"nested nodes {shape}: body runs {runs}, {graphed['set_conditional']} flag "
              f"launches (want {flags}), {graphed['stats'].get('nested')}")
        out[shape] = dict(words=graphed["words"], body_runs=runs, host_reads_and_bodies=host,
                          set_conditional=graphed["set_conditional"], nodes=graphed["nodes"],
                          depth=graphed["depth"], capture_s=graphed["capture_s"])
        print(f"nested nodes {shape}: one replay ran the bodies {json.dumps(runs)} "
              f"(words {graphed['words']}, the host's loop the same), "
              f"{graphed['set_conditional']} flag launches, graph nodes (top level, in bodies) "
              f"{graphed['nodes']}, depth {graphed['depth']}, capture and instantiation "
              f"{graphed['capture_s']:.4f} s", flush=True)
    return out


def phase_nccl_probe() -> dict:
    """4i: scripts/capture_probe.py --nccl: an all-reduce over a one-rank
    NCCL group inside conditional bodies (WHILE, IF, WHILE > IF, IF > WHILE,
    WHILE > IF > WHILE), each case in a process of its own, graphed against
    the host's loop: every case NCCL_OK, bit for bit."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                          "capture_probe.py")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, script, "--nccl"], capture_output=True, text=True,
                          timeout=900)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    outcomes = json.loads(lines[-1])["nccl"] if lines else {}
    print(f"NCCL in conditional bodies (scripts/capture_probe.py --nccl, "
          f"{time.perf_counter() - t0:.1f} s): {json.dumps(outcomes)}", flush=True)
    check(proc.returncode == 0 and outcomes and all(
        v.startswith("NCCL_OK") for v in outcomes.values()),
          f"NCCL in conditional bodies: exit code {proc.returncode}, {outcomes}: "
          f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    return outcomes


# ---------------------------------------------------------------------------
# Phase 4g: a failed conditional body's capture raises, the process lives on
# ---------------------------------------------------------------------------
# (body, fault, the loop its CaptureError names) of scripts/capture_abort.py:
# the run loop's likelihood (its warm-up IF body and the MCMC WHILE body,
# nested in the run loop's WHILE body), a stretch's IF body, an IF body in
# an IF body in a WHILE body, and dynamic mode's CV bisection body (a WHILE
# body in the CV step's IF body in the run loop's WHILE body); a stream
# sync, a raw cudaMalloc, a cudaDeviceSynchronize, each unseen by
# PyTorch's sync check.
CAPTURE_ABORT_CASES = (("while", "sync", "run"), ("while", "malloc", "run"),
                       ("while", "devsync", "run"), ("if", "sync", "probe_if"),
                       ("nested", "sync", "probe_nested"), ("nested", "malloc", "probe_nested"),
                       ("nested", "devsync", "probe_nested"), ("dynamic", "sync", "run"))


def phase_capture_abort() -> dict:
    """scripts/capture_abort.py in a process of its own for each of
    CAPTURE_ABORT_CASES: each exits 0, not by a signal, having printed
    CaptureError naming its loop and on_device=False, then a clean
    clustered run graphed bit for bit with its eager run."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                          "capture_abort.py")
    out = {}
    for kind, fault, loop in CAPTURE_ABORT_CASES:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-X", "faulthandler", script, kind, fault],
                              capture_output=True, text=True, timeout=600)
        text = f"{proc.stdout}{proc.stderr[-3000:]}"
        case = f"{kind} body, {fault}"
        check(proc.returncode == 0, f"capture abort ({case}): exit code {proc.returncode}"
              f"{' (a signal)' if proc.returncode < 0 else ''}: {text[-4000:]}")
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith(("CAPTURE_ERROR", "REPLAY_EQUAL"))]
        check(any(f"capturing the {loop!r} loop" in ln and "on_device=False" in ln
                  for ln in lines) and any(ln.startswith("REPLAY_EQUAL True") for ln in lines),
              f"capture abort ({case}): {text[-4000:]}")
        out[f"{kind} {fault}"] = {"exit_code": proc.returncode, "lines": lines,
                                  "seconds": time.perf_counter() - t0}
        print(f"capture abort, {case} past the check: exit code {proc.returncode}; "
              + " / ".join(ln[:400] for ln in lines), flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 4j: the host-call kernel (no Pallas counterpart: JAX's host callback)
# ---------------------------------------------------------------------------
# (label, N, d, blob width): one point, A's points with two blob values a
# point, and B's walkers at A's width without blobs.
HOST_SHAPES = (("1", 1, 1, 0), ("A", N_PARTICLES, N_DIM, 2), ("B", B_PARTICLES, N_DIM, 0))
HOST_ROUNDS = 50  # handshakes timed in one served launch (at most cuda_host.STAMP_RING)
# The host link's rated rate each way, GB/s: PCIe Gen5 x16 (NVIDIA's H100
# data sheet: 128 GB/s both ways), the byte term of the host call's bound.
LINK_GB_S = 64.0


def rosenbrock_numpy_blobs(x):
    # A's host likelihood with two blob values, |x|^2 and x0.
    return rosenbrock_numpy(x), float(np.sum(x * x)), float(x[0])


def _bits_equal(a, b) -> bool:
    return a is None and b is None or (a is not None and b is not None and a.dtype == b.dtype
                                       and torch.equal(a.view(torch.uint8), b.view(torch.uint8)))


def _empty_host(n: int, width: int = 0):
    """A host function that returns at once: (n,) zeros and (n, width)
    float32 blob rows of zeros (none where the width is 0)."""
    logl = np.zeros(n, np.float32)
    rows = np.zeros((n, width), np.float32) if width else None
    return lambda points: (logl, rows)


def handshake_run(device, n: int, d: int, rounds: int = HOST_ROUNDS, stamps: bool = False):
    """Device ms a host call of (n, d) float32 points with an empty host
    function: `rounds` back to back in a CUDA graph, as the run loop
    replays them (launched one by one, the first requests would wait for
    the host to queue the rest), its replay between two CUDA events, served
    on this thread (the second of two served replays); and the mailbox,
    whose stamps hold that replay's marks where `stamps` (a package older
    than the stamps is timed without them)."""
    failed = torch.zeros(1, dtype=torch.int32, device=device)
    kw = {"stamps": True} if stamps else {}
    box = cuda_host.Mailbox(n, d, np.float32, 0, np.float32, device, _empty_host(n), failed,
                            **kw)
    x = torch.rand(n, d, device=device)
    out = torch.empty(n, device=device)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    graph = _captured(device, lambda: [box.launch(x, None, out, None) for _ in range(rounds)])

    def launch():
        a.record()
        graph.replay()
        b.record()

    for turn in range(2):
        if stamps:
            box.host_stamps.clear()
        cuda_host.served(launch, [box])
    torch.cuda.synchronize()
    return a.elapsed_time(b) / rounds, box


def handshakes(device) -> dict:
    """Device ms a handshake (`handshake_run`) at each of HOST_SHAPES."""
    return {label: handshake_run(device, n, d)[0] for label, n, d, _ in HOST_SHAPES}


def parent_handshakes(parent: str) -> dict:
    """`handshakes` in the package of checkout `parent` (this script with
    --handshakes-only --package-root, in a process of its own)."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--handshakes-only",
                           "--package-root", parent], capture_output=True, text=True,
                          timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("HANDSHAKES ")]
    check(proc.returncode == 0 and len(lines) == 1,
          f"parent handshakes failed ({proc.returncode}): {proc.stdout[-2000:]}"
          f"{proc.stderr[-3000:]}")
    return json.loads(lines[0][len("HANDSHAKES "):])


# The parts of a handshake (ns, the mean over a served launch's rounds):
# device marks (%globaltimer) and host marks (perf_counter_ns), each side
# against its own clock.
SPLIT_PARTS = {
    "device: posted -> request stored": ("d", 0, 1, 0),
    "device: request stored -> reply seen": ("d", 1, 2, 0),
    "device: reply seen -> fetch ended": ("d", 2, 3, 0),
    "device: fetch ended -> next post ended": ("d", 3, 0, 1),
    "host: request seen -> fn entered": ("h", 1, 2, 0),
    "host: fn entered -> fn returned": ("h", 2, 3, 0),
    "host: fn returned -> reply written": ("h", 3, 4, 0),
    "host: reply written -> next request seen": ("h", 4, 1, 1),
}


def handshake_split(box) -> dict:
    """The parts of a stamped mailbox's last served launch (SPLIT_PARTS),
    in us, and the link's share: the device's wait for the reply less the
    host's time from the request seen to the reply written (the link both
    ways and the host's detection of the request)."""
    host = np.array(box.host_stamps, dtype=np.int64)  # seq, seen, entered, returned, written
    seqs = host[:, 0]
    marks = box.stamps.view(-1, 4).cpu().numpy()[(seqs - 1) % cuda_host.STAMP_RING]
    sides = {"d": marks, "h": host}
    out = {}
    for name, (side, a, b, shift) in SPLIT_PARTS.items():
        v = sides[side]
        diff = v[shift:, b] - v[:len(v) - shift, a]
        out[name] = float(np.mean(diff)) / 1e3
    out["link and detection"] = (out["device: request stored -> reply seen"]
                                 - out["host: request seen -> fn entered"]
                                 - out["host: fn entered -> fn returned"]
                                 - out["host: fn returned -> reply written"])
    out["handshake (post ended to post ended)"] = float(np.mean(np.diff(marks[:, 0]))) / 1e3
    return out


def pinned_rates(device) -> dict:
    """GB/s of a 64 MB copy from the device to pinned host memory and back,
    by CUDA events (the host link's rate the bound takes)."""
    n = 16 << 20
    dev = torch.rand(n, device=device)
    host = torch.empty(n, pin_memory=True)
    d2h = event_ms(lambda: host.copy_(dev, non_blocking=True), calls=10)
    h2d = event_ms(lambda: dev.copy_(host, non_blocking=True), calls=10)
    return {"d2h_gb_s": 4 * n / d2h / 1e6, "h2d_gb_s": 4 * n / h2d / 1e6}


def host_checks(device, label: str, n: int, d: int, width: int) -> tuple:
    """The kernel against the plain crossing at (n, d) with `width` blob
    values a point: logl and the blob rows bit for bit, an inactive step's
    rows back as they were with no call, one map call an active call; a
    host function that raises: its exception, `failed` set, the next call
    clean. Returns the crossing (a counting pool's) and the points."""
    from tempest_tpu_torch.utils.blobs import BlobSchema
    from tempest_tpu_torch.utils.wrappers import HostLikelihood, make_pool_map

    gen = torch.Generator(device=device).manual_seed(7)
    x = 20.0 * torch.rand(n, d, device=device, generator=gen) - 10.0
    pool = TimedPool()
    schema = BlobSchema(np.float32, blob_size=width) if width else None
    fn = rosenbrock_numpy_blobs if width else rosenbrock_numpy
    h = HostLikelihood(fn, make_pool_map(pool), torch.float32, schema)
    logl0 = torch.randn(n, device=device, generator=gen)
    blobs0 = torch.randn(n, width, device=device, generator=gen) if width else None
    for go in (True, False):
        active = torch.full((), go, device=device)
        calls = pool.calls
        want = h.plain(x, active, logl0, blobs0)
        got = h.kernel_call(x, active, logl0, blobs0)
        check(_bits_equal(got[0], want[0]) and _bits_equal(got[1], want[1]),
              f"host call {label} active={go}: the kernel's rows differ from the plain "
              f"crossing's")
        check(pool.calls - calls == (2 if go else 0),
              f"host call {label} active={go}: {pool.calls - calls} map calls for 2 crossings")
        if not go:
            check(_bits_equal(got[0], logl0) and _bits_equal(got[1], blobs0),
                  f"host call {label}: an inactive step's rows changed")
    bad = HostLikelihood(lambda p: 1 / 0, make_pool_map(None), torch.float32)
    raised = None
    try:
        bad.kernel_call(x)
    except ZeroDivisionError as exc:
        raised = exc
    check(raised is not None and int(bad.failed[0]) == 1,
          f"host call {label}: a raising host function gave {raised!r}, failed "
          f"{bad.failed.tolist()}")
    bad.log_likelihood = rosenbrock_numpy
    check(_bits_equal(bad.kernel_call(x)[0], h.plain(x)[0]),
          f"host call {label}: the call after a failure differs")
    return h, x


def phase_host_kernel(device, parent: str = None) -> dict:
    """4j: the host-call kernel (csrc/host_call.cu) against its plain
    version, the plain crossing (`HostLikelihood.plain`), at one point,
    A's (1024, 10) with two blob values a point and B's (131,072, 10)
    (`host_checks`); each handshake split into its parts by the device's
    and the host's stamps (`handshake_split`); the device ms a handshake
    with an empty host function (the host's serving included, as the
    device waits for it), twice, or in turns with the package of checkout
    `parent` (parent, this, this, parent); its call ms and the plain
    crossing's, against its bound: the points out and logl in at the host
    link's rated rate (LINK_GB_S; the pinned copy rates measured here are
    printed beside it), plus the link's round trip, taken from a C
    ping-pong on mapped memory (`cuda_host.round_trip_ms`), not from the
    kernel under test."""
    rates = pinned_rates(device)
    cuda_host.round_trip_ms(device, 100)  # loads the kernel
    round_trip = cuda_host.round_trip_ms(device)
    turns = []
    for who in ("parent", "this", "this", "parent") if parent else ("this", "this"):
        turns.append((who, parent_handshakes(parent) if who == "parent" else handshakes(device)))
    shapes, launches0 = {}, cuda_host.LAUNCHES
    for label, n, d, width in HOST_SHAPES:
        h, x = host_checks(device, label, n, d, width)
        split = handshake_split(handshake_run(device, n, d, stamps=True)[1])
        by_package = {}
        for who, ms in turns:
            by_package.setdefault(who, []).append(ms[label])
        # times with the host function returning at once
        h.evaluate = _empty_host(n, width)
        h._boxes.clear()
        times = timed_in_turns({"kernel": lambda: h.kernel_call(x),
                                "plain": lambda: h.plain(x)}, calls=20)
        device_ms = float(np.mean(by_package["this"]))
        moved = {"out_bytes": 4 * n * d, "in_bytes": 4 * n}
        bytes_ms = (moved["out_bytes"] + moved["in_bytes"]) / (LINK_GB_S * 1e6)
        bound = bytes_ms + round_trip
        shapes[label] = {"n": n, "d": d, "blob_width": width, "device_ms": device_ms,
                         "device_ms_turns": by_package, "call_ms": times["kernel"],
                         "plain_ms": times["plain"], "bound_ms": bound, "bytes_ms": bytes_ms,
                         "split_us": split, **moved}
        print(f"host call {label} ({n}, {d}), blob width {width}: bit for bit the plain "
              f"crossing (active and not), one map call a call, a raising host function "
              f"re-raised with `failed` set; device ms a handshake (empty host function) "
              f"{device_ms:.4f}, bound {bound:.4f} ms, in turns "
              f"{json.dumps([(who, ms[label]) for who, ms in turns])}; call "
              f"{times['kernel']:.4f} ms, plain {times['plain']:.4f} ms", flush=True)
        print(f"host call {label} split (us): "
              + json.dumps({k: round(v, 3) for k, v in split.items()}), flush=True)
    a = shapes["A"]
    print(f"host link: rated {LINK_GB_S} GB/s each way, pinned copies here "
          f"{json.dumps(rates)}; its round trip (C ping-pong) {round_trip:.5f} ms", flush=True)
    # The work is moving bytes over the host link: the points out, logl in,
    # and the handshake's words each way, whose cost is the link's latency.
    return {"max_abs_err": 0.0, "ms": a["call_ms"], "plain_ms": a["plain_ms"],
            "device_ms": a["device_ms"], "bound_ms": a["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "shapes": shapes,
            "bounds": {"link_gb_s": LINK_GB_S, "pinned_copies": rates,
                       "round_trip_ms": round_trip},
            "checks": cuda_host.LAUNCHES - launches0}


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
    """Microseconds of one cluster reduction at each cluster size 1-16: the
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
    for c in range(1, 17):  # every cluster size a launch plan may take
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


def _em_bits_differ(a, b):
    """Per leading index: whether a and b differ in any bit (NaN equal to
    the same NaN)."""
    def bits(t):
        return t.view({8: torch.int64, 4: torch.int32}[t.element_size()]) \
            if t.is_floating_point() else t
    return (bits(a) != bits(b)).reshape(a.shape[0], -1).any(dim=1)


def _em_same_bits(a: dict, b: dict, keys) -> bool:
    """Whether two carries hold the same bits (NaN included)."""
    return not any(bool(_em_bits_differ(a[e], b[e]).any()) for e in keys)


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
            _em_fail_if(~active & _em_bits_differ(kj[e], prev[e]), f"{what} step {j}",
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
    _em_fail_if(torch.stack([_em_bits_differ(prev[e], got[e]) for e in EM_GMM_CARRY]).any(0),
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
                _em_fail_if(~went & ~c["active"] & _em_bits_differ(kj[e], prev[e]),
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
    _em_fail_if(torch.stack([_em_bits_differ(prev[e], got[e]) for e in EM_MODE_CARRY
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
    check(_em_same_bits(got, again, EM_GMM_CARRY), f"{what}: two launches differ")
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
    check(_em_same_bits(got, again, EM_MODE_CARRY), f"{what}: two launches differ")
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
    """The inputs of every GMM EM loop, of the Student-t EM loop, of the
    cluster fit ("hgm": x, w, mask and hgm_fit's other arguments) and of the
    weighted median ("median": d_sorted, order, wbar) of A's seed 42
    (on_device=False) at `iteration`, on the card."""
    s = canonical_sampler(device, SEEDS[0], clustering=True)
    s.reset(random_state=SEEDS[0])
    core = s.state
    core.n_total = N_TOTAL
    core._pregrow_capacity()
    got = {"gmm": [], "mode": [], "hgm": [], "median": []}
    gmm_em, mode_em = cluster_module._gmm_em, student_module._mode_em
    hgm_fit = iteration_module.hgm_fit
    median = student_module._weighted_median_presorted
    copy = lambda c: {k: v.clone() for k, v in c.items()}  # noqa: E731

    def hgm(x, w, mask, loops=None, **kwargs):
        got["hgm"].append((x.clone(), w.clone(), mask.clone(), kwargs))
        return hgm_fit(x, w, mask, loops=loops, **kwargs)

    def gmm(X, sw, carry, max_iter, tol, reg, cov, loops):
        got["gmm"].append((X.clone(), sw.clone(), copy(carry), cov))
        return gmm_em(X, sw, carry, max_iter, tol, reg, cov, loops)

    def mode(carry, consts, loops):
        got["mode"].append((copy(carry), copy(consts)))
        return mode_em(carry, consts, loops)

    def med(d_sorted, order, wbar):
        got["median"].append((d_sorted.clone(), order.clone(), wbar.clone()))
        return median(d_sorted, order, wbar)

    for _ in range(iteration - 1):
        core._step(None, 0)
    cluster_module._gmm_em, student_module._mode_em = gmm, mode
    iteration_module.hgm_fit, student_module._weighted_median_presorted = hgm, med
    try:
        core._step(None, 0)
    finally:
        cluster_module._gmm_em, student_module._mode_em = gmm_em, mode_em
        iteration_module.hgm_fit, student_module._weighted_median_presorted = hgm_fit, median
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


# The phases of an EM iteration the kernels' clock64 stamps split it into
# (csrc/em_stamps.cuh).
EM_PHASES = {"gmm_em": ("factorization", "E-step", "first sums", "first reduction",
                        "scatter sums", "second reduction", "rest"),
             "mvstud_em": ("factorization", "distances", "stationarity terms",
                           "their 6 reductions", "M-step sums", "M-step reduction", "rest")}


EM_STAMP_BLOCKS = 1024  # csrc/em_stamps.cuh kStampBlocks


def sm_cycles_per_us() -> float:
    """The SM clock under load: cycles of torch.cuda._sleep over its time."""
    torch.cuda._sleep(PROFILE_WARMUP_CYCLES)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(PROFILE_WARMUP_CYCLES)
    b.record()
    torch.cuda.synchronize()
    return PROFILE_WARMUP_CYCLES / (a.elapsed_time(b) * 1e3)


def em_stamped_csrc(out_dir: str) -> str:
    """A copy of this package's csrc/ that builds with EM_STAMPS defined."""
    out = os.path.join(out_dir, "csrc_stamped")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out)
    header = os.path.join(out, "em_common.cuh")
    with open(header) as f:
        text = f.read()
    with open(header, "w") as f:
        f.write("#define EM_STAMPS 1\n" + text)
    return out


def em_split(cases, csrc) -> dict:
    """The split of an EM iteration by the kernels' clock64 stamps: each case
    (label, kind, run) launched once on the sources in `csrc` (built with
    EM_STAMPS), the cycles the launch's first CTA spent in each phase
    (EM_PHASES) over its iterations, in microseconds at the SM clock
    (sm_cycles_per_us). The first CTA serves the first fit: its iterations,
    not the launch's slowest fit's."""
    import ctypes

    rate = sm_cycles_per_us()
    saved, loaded = _build.CSRC, dict(_build._loaded)
    _build.CSRC = Path(csrc)
    _build._loaded.clear()
    rows = {}
    try:
        for label, kind, run in cases:
            lib = _build.load(cuda_em.GMM_LIBRARY if kind == "gmm_em" else cuda_em.MVSTUD_LIBRARY)
            lib.tempest_em_stamps.argtypes = [ctypes.c_void_p]
            run()
            phases = len(EM_PHASES[kind])
            out = (ctypes.c_int64 * (phases + 1 + 2 * EM_STAMP_BLOCKS))()
            _build.check(lib.tempest_em_stamps(ctypes.addressof(out)), "tempest_em_stamps")
            iters = int(out[phases])
            us = {p: out[i] / max(iters, 1) / rate for i, p in enumerate(EM_PHASES[kind])}
            ns = np.array(out[phases + 1:], dtype=np.int64).reshape(-1, 2)
            ns = ns[(ns[:, 0] > 0) & (ns[:, 1] >= ns[:, 0])]
            ctas = {}
            if len(ns):
                start, span = (ns[:, 0] - ns[:, 0].min()) / 1e3, (ns[:, 1] - ns[:, 0]) / 1e3
                ctas = dict(ctas=len(ns), start_us_max=float(start.max()),
                            late=int((start > 5.0).sum()), loop_us_min=float(span.min()),
                            loop_us_median=float(np.median(span)), loop_us_max=float(span.max()),
                            end_us_max=float((start + span).max()))
            rows[label] = dict(iterations=iters, us_an_iteration=us,
                               us_total=sum(us.values()), sm_cycles_per_us=rate, ctas=ctas)
            print(f"split {label}: {iters} iterations of its first fit; us an iteration "
                  f"{json.dumps({k: round(v, 3) for k, v in us.items()})}, "
                  f"{sum(us.values()):.3f} in all (SM clock {rate:.1f} cycles a us); its CTAs' "
                  f"loops (us from the first start): {json.dumps(ctas)}", flush=True)
    finally:
        _build.CSRC = saved
        _build._loaded.clear()
        _build._loaded.update(loaded)
    return rows


def em_timing(name, kernel, plain, n_bytes, n_ops, chain_ms, calls, f64=False) -> dict:
    """A kernel's call and device ms in turns with its plain loop, and its
    bounds (its instructions float64 ones if `f64`)."""
    t = timed_in_turns({"kernel": kernel, "plain": plain}, calls=calls)
    dev = [device_ms(kernel, f"{name}_kernel", calls=5) for _ in range(2)]
    b_ms, b_by = bound(n_bytes, 0, 0.0 if f64 else n_ops, n_ops if f64 else 0.0)
    return dict(ms=t["kernel"], device_ms=min(dev), device_ms_turns=dev, plain_ms=t["plain"],
                bound_ms=b_ms, bound_by=b_by, chain_bound_ms=chain_ms,
                bound_with_chain_ms=max(b_ms, chain_ms), library_ms=None)


def phase_em_kernels(device, a_inputs: dict) -> dict:
    """tempest_gmm_em and tempest_mvstud_em (_f64) against their plain loops
    (the "gmm_em" and "mode_em" device loops on the same CUDA tensors) at
    the paths' shapes in float32 and float64, on synthetic fits and on A's
    own fit inputs (seed 42, iteration 21), two launches the same bits; in
    float32 (and at A's and B's shapes in float64) their call and device
    times in turns with the plain loops (chunks of 4, as the fused route
    runs them), beside their bounds. `a_inputs`: `a_fit_inputs`."""
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
        chain = int(iters.max()) * EM_REDUCTIONS["gmm_em"] * em_reduction(red_us, C) / 1e3
        t = em_timing("gmm_em",
                      lambda: cluster_module._gmm_em(Xb, sw, carry, 1000, 1e-3, 1e-6, cov, None),
                      lambda: cluster_module._gmm_em_plain(Xb, sw, carry, 1000, 1e-3, 1e-6, cov,
                                                           Loops(device, {"gmm_em": 4})),
                      n_bytes, n_ops, chain, calls=11, f64=elem == 8)
        timings[f"gmm_em {label}"] = dict(t, B=B, n=n, d=d, K=K, **em_occupancy(C, B),
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
        chain = int(iters.max()) * EM_REDUCTIONS["mvstud_em"] * em_reduction(red_us, C) / 1e3
        t = em_timing("mvstud_em", lambda: student_module._mode_em(carry, consts, None),
                      lambda: student_module._mode_em_plain(carry, consts,
                                                            Loops(device, {"mode_em": 4})),
                      n_bytes, n_ops, chain, calls=5 if n > 100000 else 11, f64=elem == 8)
        timings[f"mvstud_em {label}"] = dict(t, K=K, n=n, d=d, **em_occupancy(C, K),
                                             iterations_max=int(iters.max()),
                                             iterations_sum=int(iters.sum()))
    for label, t in timings.items():
        print(f"{label}: kernel call {t['ms']:.4f} ms, device {t['device_ms_turns'][0]:.4f} / "
              f"{t['device_ms_turns'][1]:.4f} ms; plain loop (chunks of 4) {t['plain_ms']:.4f} "
              f"ms; bound {t['bound_ms']:.5f} ms ({t['bound_by']}), reduction chain "
              f"{t['chain_bound_ms']:.4f} ms; "
              f"{json.dumps({k: v for k, v in t.items() if k in EM_SHOWN})}",
              flush=True)
    # The split of an EM iteration at A's and B's shapes (and the others').
    cases = [(f"gmm_em {label}", "gmm_em",
              lambda g=g: cluster_module._gmm_em(g[0], g[1], g[2], 1000, 1e-3, 1e-6, g[3], None))
             for label, g in gmm_inputs.items()]
    cases += [(f"mvstud_em {label}", "mvstud_em",
               lambda m=m: student_module._mode_em(m[0], m[1], None))
              for label, m in mode_inputs.items()]
    split = {}  # a package older than the stamps (--package-root) has no split
    if (Path(_build.CSRC) / "em_stamps.cuh").exists():
        split = em_split(cases, em_stamped_csrc(tempfile.mkdtemp(prefix="em_stamps_")))
    for kind in ("gmm_em", "mvstud_em"):
        row = timings[f"{kind} A run"]
        rows[kind] = dict(row, max_abs_err=max(r["max_abs_err"] for r in report[kind].values()),
                          shapes={k[len(kind) + 1:]: v for k, v in timings.items()
                                  if k.startswith(kind)},
                          checks=report[kind], reduction_us=red_us,
                          split={k: v for k, v in split.items() if k.startswith(kind)})
    return rows


# The plan and occupancy fields phase 4d prints beside each time.
EM_SHOWN = ("B", "K", "n", "d", "ctas", "grid", "threads", "sms", "n_iter_max", "n_iter_sum",
            "iterations_max", "iterations_sum")


def em_reduction(red_us: dict, plan: dict) -> float:
    """A fit reduction's latency (us) for the chain bound: the probed cluster
    reduction at the plan's cluster size; for a fit over the grid, whose
    barrier is one in global memory, the probed cluster of 16's, as no
    faster."""
    return red_us[16 if plan.get("grid") else plan["cluster"]]


def em_occupancy(plan: dict, fits: int) -> dict:
    """A launch's CTAs, route, threads a CTA and the SMs it occupies: all
    its CTAs' while they are fewer than the SMs (the block scheduler spreads
    them), else every SM."""
    ctas = plan.get("ctas", plan["cluster"]) * fits  # a package older than the grid route
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    return dict(ctas=ctas, grid=bool(plan.get("grid")), threads=plan["threads"],
                sms=min(ctas, sms))


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
                print(f"ess bracket {str(dtype)[6:]} S={S} [{_route(S, dtype, True)}] {kind}: "
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
            live = int((torch.isfinite(logl) & (bm != float("inf"))).sum())
            b_ms, b_by = bracket_bound(S, live, probes)
            row = dict(S=S, live=live, filled=f"{t_fill} of {capacity} rows", probes=probes,
                       launch_plan=_route(S, bracket=True), ms=t["kernel"], device_ms=dev,
                       plain_ms=t["plain"], bound_ms=b_ms, bound_by=b_by, library_ms=None,
                       bound_all_samples_ms=bound(8 * S + 20, *work(
                           (S * probes, ESS_SAMPLE_PROBE["f32"])))[0])
            print(f"ess bracket timing S={S} ({label}, {live} live, {probes} probes, "
                  f"{_route(S, bracket=True)}): kernel call {t['kernel']:.4f} ms device {dev:.4f} "
                  f"ms; plain "
                  f"{t['plain']:.4f} ms; bound {b_ms:.5f} ms ({b_by}; counting every sample's "
                  f"exp {row['bound_all_samples_ms']:.5f})", flush=True)
    check(row is not None, f"no bracket timing on the {BRACKET_TIMED!r} history")
    row["max_abs_err"] = max_err
    row["in_turns_with_parent"] = bracket_turns(device)
    row["stamps"] = bracket_split(device)
    row["bounds"] = bracket_bounds(device)
    return row


def bracket_bounds(device) -> dict:
    """The bracket's bound at every BRACKET_SHAPES size (float32, the
    bisection target of `bracket_inputs`): its live samples, probes and
    `bracket_bound`, beside the bound counting every sample's exps."""
    out = {}
    for label, *_ in BRACKET_SHAPES:
        logl, bm, scal = bracket_inputs(device, label)
        S = logl.numel()
        probes = int(reweight_step.ess_bracket_loop(logl, bm, scal)[1].item())
        live = int((torch.isfinite(logl) & (bm != float("inf"))).sum())
        b_ms, b_by = bracket_bound(S, live, probes)
        out[label] = dict(S=S, live=live, probes=probes, bound_ms=b_ms, bound_by=b_by,
                          bound_all_samples_ms=bound(8 * S + 20, *work(
                              (S * probes, ESS_SAMPLE_PROBE["f32"])))[0])
    print(f"ess bracket bounds by size (float32): {json.dumps(out)}", flush=True)
    return out


def bracket_bound(S: int, live: int, probes: int):
    """The least time of the bracket search: logl and Bm read once, scal
    read, (lo, hi) and the probe count written, against the instructions of
    each probe on the live samples (a masked sample adds nothing)."""
    return bound(8 * S + 20, *work((live * probes, ESS_SAMPLE_PROBE["f32"])))


def bracket_inputs(device, label: str, dtype=torch.float32):
    """(logl, bm, scal) of BRACKET_SHAPES' `label` at its bisection target."""
    _, n_particles, capacity, t_fill = next(c for c in BRACKET_SHAPES if c[0] == label)
    hist = synthetic_history(device, n_particles, capacity, t_fill, seed=capacity, dtype=dtype)
    _, logl, bm = kernel_inputs(hist)
    beta_prev = float(hist.beta[t_fill // 2])
    target = math.sqrt(ess_of(logl, bm, beta_prev) * ess_of(logl, bm, 1.0))
    return logl, bm, torch.tensor([beta_prev, target], dtype=dtype, device=device)


def bracket_raw(lib, logl, bm, scal):
    """A launch of a library's bracket entry (the parent's, or the stamped
    build) on these inputs, as `cuda_reweight.ess_bracket` launches it."""
    plan = cuda_reweight.plan_launch(logl.numel(), logl.dtype)
    entry = lib.tempest_ess_bracket if logl.dtype == torch.float32 else lib.tempest_ess_bracket_f64

    def run():
        out = torch.empty(2, dtype=logl.dtype, device=logl.device)
        probes = torch.empty(1, dtype=torch.int32, device=logl.device)
        _build.check(entry(logl.data_ptr(), bm.data_ptr(), scal.data_ptr(), out.data_ptr(),
                           probes.data_ptr(), logl.numel(), plan.slice, int(plan.resident),
                           torch.cuda.current_stream().cuda_stream), "ess_bracket")
        return out, probes
    return run


def bracket_turns(device) -> dict:
    """With --parent: the bracket's device time in turns with the parent's
    kernel (parent, this, this, parent) at every BRACKET_SHAPES size, float32,
    on the same inputs; both held to the plain version first."""
    parent = extra_library("ess_parent", ESS_FUNCTIONS)
    if parent is None:
        return {}
    out = {}
    for label, *_ in BRACKET_SHAPES:
        logl, bm, scal = bracket_inputs(device, label)
        want = reweight_step.ess_bracket_loop(logl, bm, scal)
        theirs = bracket_raw(parent, logl, bm, scal)
        mine = lambda: cuda_reweight.ess_bracket(logl, bm, scal)  # noqa: E731
        for who, fn in (("parent", theirs), ("this", mine)):
            check_bracket(f"ess_bracket {who} {label}", logl, bm, scal, fn(), want)
        out[label] = device_in_turns({"parent": theirs, "this": mine}, "ess_bracket_kernel",
                                     calls=20)
        print(f"ess bracket {label} S={logl.numel()} ({int(want[1].item())} probes): device ms "
              f"in turns (parent, this, this, parent): {json.dumps(out[label])}", flush=True)
    return out


# The bracket's stamps (csrc/ess_bisect.cu, BRACKET_STAMPS): a CTA's fields.
BRACKET_STAMP_FIELDS = ("load", "pass", "warp", "cta", "push", "wait", "combine_decide", "rounds")


def bracket_split(device) -> dict:
    """One launch of the stamped bracket at every BRACKET_SHAPES size: each
    CTA's thread 0 clock64 marks by phase (the load and compaction once;
    then, a round each, its pass, its warp's combine, the CTA's combine, the
    pushes, the wait for the cluster's partials, their combine and the
    decision), in microseconds a round at the SM clock, for CTA 0 and as the
    largest over the CTAs."""
    lib = extra_library("ess_stamped", {**ESS_FUNCTIONS,
                                        "tempest_bracket_stamps": [ctypes.c_void_p]})
    if lib is None:
        return {}
    rate = sm_cycles_per_us()
    out = {}
    for label, *_ in BRACKET_SHAPES:
        logl, bm, scal = bracket_inputs(device, label)
        got = bracket_raw(lib, logl, bm, scal)()
        torch.cuda.synchronize()
        check_bracket(f"ess_bracket stamped {label}", logl, bm, scal, got,
                      reweight_step.ess_bracket_loop(logl, bm, scal))
        raw = (ctypes.c_int64 * (16 * len(BRACKET_STAMP_FIELDS)))()
        _build.check(lib.tempest_bracket_stamps(ctypes.addressof(raw)), "tempest_bracket_stamps")
        rows = np.array(raw, dtype=np.int64).reshape(16, -1)
        rounds = int(rows[0, -1])
        per = rows[:, 1:-1] / max(rounds, 1) / rate  # us a round, by CTA
        out[label] = {"probes": int(got[1].item()), "rounds": rounds,
                      "load_us": {"cta0": float(rows[0, 0] / rate),
                                  "max": float(rows[:, 0].max() / rate)},
                      "us_a_round_cta0": dict(zip(BRACKET_STAMP_FIELDS[1:-1], per[0].tolist())),
                      "us_a_round_max": dict(zip(BRACKET_STAMP_FIELDS[1:-1],
                                                 per.max(axis=0).tolist())),
                      "sm_cycles_per_us": rate}
        print(f"ess bracket stamps {label} S={logl.numel()}: {json.dumps(out[label])}",
              flush=True)
    return out


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
    """MCMC step bodies run in the sampler's life: eagerly the chunks' (the
    steps, and the steps a chunk ran past the stop, which change nothing
    and on keyed draws draw nothing), graphed on keyed draws the runs of
    the WHILE node's body, counted on the device (settled first); a draws
    kernel launches once a body."""
    settle()
    stats = s.state._iteration.loops.stats["mcmc"]
    return int(stats["bodies"] + stats["node_bodies"])


def keyed_route(s) -> bool:
    """Whether sampler `s` runs its MCMC chain on keyed draws (float32 and
    float64 on the card): graphed one WHILE node, eagerly in chunks."""
    return bool(getattr(s.state.draws, "keyed", False))


# The PRNG kernels a keyed MCMC step launches, float32's and float64's; the
# uniform kernel of each (which also draws the warm-up's and the
# resampling's uniforms).
STEP_KERNELS = ("mutation_draws", "normal", "gamma", "bits",
                "mutation_draws_f64", "normal_f64", "gamma_f64", "uniform_f64")
UNIFORM_KERNELS = ("bits", "uniform_f64")


def prng_names(dtype) -> dict:
    """The PRNG kernels' launch names in `dtype`: the mutation draws, the
    normal, gamma and uniform kernels."""
    if dtype == torch.float64:
        return dict(mutation="mutation_draws_f64", normal="normal_f64", gamma="gamma_f64",
                    uniform="uniform_f64")
    return dict(mutation="mutation_draws", normal="normal", gamma="gamma", uniform="bits")


def run_loop(s) -> bool:
    """Whether sampler `s`'s run(on_device=True) takes the device run loop
    (`SamplerCore._run`, made for every configuration)."""
    return getattr(s.state, "_run", None) is not None


def fused_iteration(s) -> bool:
    """Whether sampler `s` runs the fused iteration (its loops in chunks)."""
    return s.state._iteration.loops.chunks == CHUNKS


def keyed_uniforms(s) -> bool:
    """Whether sampler `s` draws its warm-up and resampling uniforms from
    the uniform kernel of its dtype (keyed draws in a package with the
    device run loop)."""
    return keyed_route(s) and hasattr(s.state, "_run")


def iteration_uniforms(s, beta=None) -> int:
    """The uniform kernel's launches for the keyed warm-up and resampling
    uniforms of sampler `s`'s run (`beta` its iterations' betas, default
    the whole run's): two a warm-up iteration (beta 0), one a mutation."""
    if not keyed_uniforms(s):
        return 0
    beta = s.results()["beta"] if beta is None else np.asarray(beta)
    return int((beta > 0).sum()) + 2 * int((beta == 0).sum())


def without_past_stop(launched: dict, past: int, bodies: int, name: str,
                      uniforms: int = 0) -> dict:
    """An eager run's launches less those of the `past` MCMC steps its
    chunks ran past the stop (of its `bodies` step bodies), which a WHILE
    node does not run: each step kernel launches as often in every body,
    the uniform kernel of the run's dtype `uniforms` times more for the
    iterations' keyed warm-up and resampling uniforms."""
    out = dict(launched)
    for k in STEP_KERNELS:
        n = launched.get(k, 0)
        n -= uniforms if k in UNIFORM_KERNELS and n else 0
        if n:
            per = n // max(bodies, 1)
            check(per * bodies == n, f"{name}: {n} {k} launches for {bodies} MCMC bodies")
            out[k] -= past * per
    return out


def less_past_stop(s, launched: dict, name: str) -> dict:
    """`without_past_stop` of fresh sampler `s`'s one run (its loops'
    counts are the run's)."""
    stats = s.state._iteration.loops.stats["mcmc"]
    return without_past_stop(launched, stats["past_stop"], stats["bodies"], name,
                             iteration_uniforms(s))


def run_canonical(device, name, seeds, clustering, hardware_prng, logz_band,
                  dtype=torch.float32, on_device=False, runs=None) -> dict:
    """Seeds of A (or the unclustered problem) after a warm-up: each in the
    band, one launch of the ESS kernel of its dtype per reweight, and the
    mutation-draws kernel once per MCMC step body where it applies (float32,
    with either hardware_prng: the keyed steps; eagerly in chunks, whose
    steps past the stop are counted apart, graphed one WHILE node that
    runs the steps alone); no other PRNG kernel. `runs`, if given,
    receives each seed's results, wall, launches, and launches less those
    of the steps past the stop (`real_launches`)."""
    since = len(FORMS)
    s = canonical_sampler(device, 7, clustering, hardware_prng, dtype)
    ess_key, other = ("ess_bisect_f64", "ess_bisect") if dtype == torch.float64 else (
        "ess_bisect", "ess_bisect_f64")
    # keyed steps draw from the mutation-draws kernel of their dtype, either flag
    draws_kernel = keyed_route(s)
    prng = prng_names(dtype)
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
        if on_device and run_loop(s):
            # the device run loop fits the modes in its replays, once a
            # mutation, where the host counts none
            fits = int((s.results()["beta"] > 0).sum())
        loops_run = {k: {c: v.get(c, 0) - loops_before.get(k, {}).get(c, 0) for c in v}
                     for k, v in loop_stats(s).items()}
        bodies = mcmc_bodies(s) - bodies
        past = loops_run.get("mcmc", {}).get("past_stop", 0)
        uniforms = iteration_uniforms(s)
        real = without_past_stop(launched, past, bodies, f"{name} seed {seed}", uniforms)
        if runs is not None:
            runs[seed] = dict(results=s.results(), logz=s.evidence()[0], wall=wall,
                              launches=launched, real_launches=real, iters=int(s.state.hist.t),
                              bodies=bodies, past_stop=past, draws=s.state.draws.get_state(),
                              loops=loops_run)
        ess = s.state.posterior_ess()
        logz, _ = s.evidence()
        iters = int(s.state.hist.t)
        steps = mcmc_steps(s)
        k = int(s.state.cluster_model.n_clusters())
        walls.append(wall)
        effs.append(ess / wall)
        print(f"{name} seed {seed}: wall={wall:.3f} s ess={ess:.1f} eff/s={ess / wall:.1f} "
              f"iters={iters} clusters={k} logz={logz:.4f} beta={s.beta:.6f} calls={s.calls} "
              f"mcmc_steps={steps} mcmc_bodies={bodies} (past the stop {past}) "
              f"mcmc_reads={loops_run.get('mcmc', {}).get('reads', 0)} mode_fits={fits} "
              f"gmm_em_loops={gmm_fits} launches={launched}", flush=True)
        # graphed, the GMM EM loops run inside the fit's replays, uncounted
        check_em_launches(f"{name} seed {seed}", launched, fits,
                          None if on_device else gmm_fits, loops_run)
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
        if draws_kernel:  # a launch a step body; graphed the WHILE node runs the steps alone
            check(launched[prng["mutation"]] == bodies == steps + past
                  and (past == 0 or not on_device),
                  f"{name} seed {seed}: {launched[prng['mutation']]} mutation-draws launches "
                  f"for {bodies} MCMC bodies ({steps} steps, {past} past the stop)")
            check((loops_run.get("mcmc", {}).get("chunks", 0) == 0) == on_device,
                  f"{name} seed {seed}: the MCMC chain {'ran' if on_device else 'did not run'} "
                  f"in chunks {loops_run.get('mcmc')}")
        others = {k: launched.get(k, 0) for k in STEP_KERNELS
                  if k not in (prng["mutation"], prng["uniform"])}
        check(not any(others.values()) and launched.get(prng["uniform"], 0) == uniforms
              and (draws_kernel or launched.get(prng["mutation"], 0) == 0),
              f"{name} seed {seed}: unexpected PRNG launches {launched} (the uniform kernel "
              f"{uniforms} for the warm-up and resampling uniforms)")
        check(cuda_linalg is None or launched["sym_eigvals"] == iters - 1,
              f"{name} seed {seed}: {launched.get('sym_eigvals')} eigenvalue launches for "
              f"{iters - 1} reweights (one CV each)")
    check_forms(name, since, GATHERED)  # N d^2 = 102,400 <= 2^21
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
    """The fused loops' counters of sampler `s`, by loop (the conditional
    bodies' runs settled first)."""
    settle()
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
    em_iters, mode_em = [], student_module._mode_em
    try:
        for _ in range(first - 1):
            core._step(None, 0)
        torch.cuda.synchronize()
        settle()
        before = {k: dict(v) for k, v in loops.stats.items()}
        if cuda_em is not None:  # each mode EM launch's EM iterations, read after the window
            def counted(carry, consts, loops_):
                out = mode_em(carry, consts, loops_)
                em_iters.append((carry["i"].clone(), out["i"].clone()))
                return out

            student_module._mode_em = counted
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profile_warmup()
            t0 = time.perf_counter()
            with record_function("steady"):
                for _ in range(n):
                    core._step(None, 0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        student_module._mode_em = mode_em
        settle()  # the conditional bodies' runs in the window
        reads, replays, node_bodies = ({k: v.get(c, 0) - before.get(k, {}).get(c, 0)
                                        for k, v in loops.stats.items()}
                                       for c in ("reads", "replays", "node_bodies"))
        if device_only:
            with profile(activities=[ProfilerActivity.CUDA]) as prof_device:
                profile_warmup()
                t0 = time.perf_counter()
                for _ in range(n):
                    core._step(None, 0)
                torch.cuda.synchronize()
                wall_device = time.perf_counter() - t0
    finally:
        loops.graphs = False
        student_module._mode_em = mode_em
    # The blocking calls the iterations made: those inside the "steady" range
    # (not the window's closing synchronize, nor the profiler's own).
    blocking, eigh = {}, 0
    for e in prof.events():
        if e.name in BLOCKING_CALLS and _under(e, "steady"):
            blocking[e.name] = blocking.get(e.name, 0) + 1
        eigh += e.name in EIGH_OPS and _under(e, "steady")
    events = prof.key_averages()
    rows = device_rows(prof)
    device_ms = sum(ms for ms, _ in rows.values())
    stages = {}  # host ms an iteration in each stage range (its reads included)
    for e in events:
        if e.key.startswith("ps/"):
            stages[e.key] = max(stages.get(e.key, 0.0), e.cpu_time_total / 1e3 / n)
    chunk_reads = sum(v for k, v in reads.items() if k != "beta")
    kernels = {k: (ms / n, c / n) for k, (ms, c) in rows.items() if ms > 0}
    out = dict(graphs=graphs, first=first, n=n, wall_per_iter=wall / n,
               device_ms_per_iter=device_ms / n, idle=1.0 - device_ms / (1e3 * wall),
               blocking_per_iter=sum(blocking.values()) / n, blocking=blocking,
               chunk_reads_per_iter=chunk_reads / n, reads=reads, replays=replays,
               mcmc_route="while" if keyed_route(s) else "chunks",
               mcmc_reads_per_iter=reads.get("mcmc", 0) / n,
               while_iterations_per_iter=node_bodies.get("mcmc", 0) / n,
               clustered=core.config.clustering, eigh_ops=eigh, stages_ms=stages, kernels={
                   k: v for i, (k, v) in enumerate(sorted(kernels.items(), key=lambda kv: -kv[1][0]))
                   if i < TOP_KERNELS or any(p in k for p in ("sym_eigvals", "ess_bisect",
                                                              "ess_bracket"))},
               mode_em_iterations=[int((b - a).max()) for a, b in em_iters])
    if device_only:
        device_only_ms = sum(ms for ms, _ in device_rows(prof_device).values())
        out["device_only"] = dict(wall_per_iter=wall_device / n,
                                  device_ms_per_iter=device_only_ms / n,
                                  idle=1.0 - device_only_ms / (1e3 * wall_device))
    return out


def run_window(s, name: str, n_total: int = N_TOTAL) -> dict:
    """A whole run of sampler `s` (reset to seed 42) with run(on_device=True)
    on the device run loop, whose graph `s` has captured: the wall; by CUDA
    events the span of each dispatch of the loop on the device (its inputs
    copied in, one replay, its outputs copied out: the replay's kernels and
    the gaps between them, not the device's busy time), and that span an
    iteration of the loop; the share of the run's wall outside the
    dispatches' spans (the first iteration, which the host runs, and the
    read after the replay); the loops' reads (one a dispatch, "run") under
    PyTorch's sync check set to raise (no other host read); the run loop's
    WHILE iterations and the MCMC chain's. torch.profiler is kept off the
    replay: its CUDA tracing records no kernel inside a body captured
    straight into its node (0.39 ms of device time an iteration of A's run
    loop on an H100), and a profiled replay once ended in an illegal memory
    access (scripts/run_loop_repeat.py repeats that run); the kernels by
    name and their busy time come from the eager window, which launches the
    same ones."""
    s.reset(random_state=SEEDS[0])
    core = s.state
    loops = core._iteration.loops
    settle()
    before = {k: dict(v) for k, v in loops.stats.items()}
    run, spans = core._run, []

    def timed(*args, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = run(*args, **kw)
        e1.record()
        spans.append((e0, e1))
        return out

    core._run = timed
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        s.run(n_total=n_total, progress=False, on_device=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(mode)
        core._run = run
    settle()
    delta = {k: {c: v.get(c, 0) - before.get(k, {}).get(c, 0) for c in v}
             for k, v in loops.stats.items()}
    iters = int(s.state.hist.t)
    replay_ms = sum(e0.elapsed_time(e1) for e0, e1 in spans)
    in_loop = delta.get("run", {}).get("node_bodies", 0)
    out = dict(graphs=True, route="run loop", iters=iters, wall=wall, wall_per_iter=wall / iters,
               dispatches=len(spans), replay_ms=replay_ms,
               replay_ms_per_iter=replay_ms / max(in_loop, 1),
               outside_replay=1.0 - replay_ms / (1e3 * wall),
               run_replays=delta.get("run", {}).get("replays", 0),
               reads={k: v.get("reads", 0) for k, v in delta.items() if v.get("reads")},
               run_iterations=in_loop,
               mcmc_while_iterations=delta.get("mcmc", {}).get("node_bodies", 0))
    print(f"{name} seed {SEEDS[0]}, a whole run on the device run loop: {iters} iterations, "
          f"{1e3 * out['wall_per_iter']:.2f} ms an iteration of wall; {out['dispatches']} "
          f"dispatch spanning {replay_ms:.2f} ms on the device by CUDA events, "
          f"{out['replay_ms_per_iter']:.2f} ms an iteration of the loop ("
          f"{100 * out['outside_replay']:.1f} % of the run's wall outside the span); "
          f"{out['run_replays']} replay, loop "
          f"reads {out['reads']} (no other host read: PyTorch's sync check raised none), "
          f"run-loop iterations {in_loop}, MCMC WHILE iterations "
          f"{out['mcmc_while_iterations']}", flush=True)
    check(out["run_replays"] == 1 == out["dispatches"] and out["reads"] == {"run": 1},
          f"{name} run loop: {out['run_replays']} replays, loop reads {out['reads']}: one replay "
          f"and one read a dispatch, none between iterations")
    check(in_loop == iters - 1,
          f"{name} run loop: {in_loop} WHILE iterations for {iters} iterations (the first on "
          f"the per-iteration route)")
    return out


def phase_fused(device, ref: dict) -> dict:
    """6b: A's seeds 42-44 with run(on_device=True), the device run loop,
    against phase 6's runs of each seed, after a seed-42 run that captures
    its graph; then the eager steady window and a whole run under the
    profiler."""
    s = canonical_sampler(device, SEEDS[0], clustering=True)
    s.run(n_total=N_TOTAL, progress=False, on_device=True)  # warm-up: captures the graph
    warm = loop_stats(s)
    run_graphs = [dict(nodes=g.nodes, depth=g.depth, capture_s=g.capture_s)
                  for g in s.state._iteration.loops.graphs_of("run")]
    print(f"A fused: the run loop's graph (top-level nodes, nodes in the conditional bodies; "
          f"nesting depth; seconds of capture and instantiation): {json.dumps(run_graphs)}",
          flush=True)
    check(len(run_graphs) == 1 and run_graphs[0]["depth"] >= 3,
          f"A fused: the run loop's graphs {run_graphs}")
    # The run that captured its graph repeats phase 6's seed 42 too.
    for name in ("beta", "logz", "steps", "calls"):
        check(s.results()[name].tobytes() == ref[SEEDS[0]]["results"][name].tobytes(),
              f"A fused seed {SEEDS[0]} (capturing): {name} differs from on_device=False")
    seeds, launched, set_conditional, timed = {}, {}, {}, {}
    for seed in SEEDS:  # each on the same graph, against its eager run
        s.reset(random_state=seed)
        settle()
        before = loop_stats(s)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run(n_total=N_TOTAL, progress=False, on_device=True)
        torch.cuda.synchronize()
        seeds[seed] = time.perf_counter() - t0
        launched[seed], set_conditional[seed] = counts(), cond_launches()
        timed[seed] = {k: {c: v.get(c, 0) - before.get(k, {}).get(c, 0) for c in v}
                       for k, v in loop_stats(s).items()}
        res, logz, iters, want = s.results(), s.evidence()[0], int(s.state.hist.t), ref[seed]
        loops = timed[seed]
        mutations = int((res["beta"] > 0).sum())
        steps = int(res["steps"][res["beta"] > 0].sum())
        for name in ("beta", "logz", "steps", "calls"):
            check(res[name].tobytes() == want["results"][name].tobytes(),
                  f"A fused seed {seed}: {name} differs from on_device=False: "
                  f"{res[name].tolist()} against {want['results'][name].tolist()}")
        check(logz == want["logz"] and abs(logz - CLUSTERED_LOGZ[0]) <= CLUSTERED_LOGZ[1]
              and s.beta == 1.0,
              f"A fused seed {seed}: logZ {logz!r} against {want['logz']!r}, beta {s.beta}")
        check(launched[seed] == want["real_launches"],
              f"A fused seed {seed}: launches {launched[seed]} against on_device=False "
              f"{want['real_launches']} (less its {want['past_stop']} steps past the stop)")
        # one replay and one read a dispatch, no read between iterations, no capture
        check(loops["run"].get("replays") == 1 and loops["run"].get("reads") == 1
              and not any(v.get("reads", 0) for k, v in loops.items() if k != "run")
              and all(v.get("captures", 0) == 0 for v in loops.values()),
              f"A fused seed {seed}: loops {loops}")
        check_fit_replays(f"A fused seed {seed}", loops)
        # the run loop's WHILE node: a body run an iteration after the first;
        # the MCMC chain's, a run a step
        check(loops["run"].get("node_bodies") == iters - 1
              and loops["mcmc"].get("node_bodies") == steps and not loops["mcmc"].get("reads"),
              f"A fused seed {seed}: {loops['run']} run loop, {loops['mcmc']} MCMC loop for "
              f"{iters} iterations and {steps} steps")
        # flag launches: the run loop's two before it (the WHILE node's and
        # the termination test's IF node's); each body run its WHILE flag and
        # the warm-up, mutation and termination IF nodes'; each mutation the
        # fit's COND_NODES round IF nodes and the chain's WHILE flag before
        # it; each step one
        flags = 2 + 4 * (iters - 1) + (COND_NODES + 1) * mutations + steps
        check(set_conditional[seed] == flags,
              f"A fused seed {seed}: {set_conditional[seed]} set_conditional launches, "
              f"{flags} expected ({iters} iterations, {mutations} mutations, {steps} steps)")
        print(f"A fused seed {seed}: wall={seeds[seed]:.3f} s iters={iters} "
              f"({1e3 * seeds[seed] / iters:.1f} ms an iteration; on_device=False "
              f"{want['wall']:.3f} s, {1e3 * want['wall'] / want['iters']:.1f} ms) "
              f"logz={logz!r}, bit for bit on_device=False's (ladder, logZ, steps, calls, "
              f"launches); one replay and one read, {loops['run']['node_bodies']} run-loop and "
              f"{steps} MCMC WHILE iterations, {set_conditional[seed]} flag launches",
              flush=True)
    print(f"A fused seeds {list(SEEDS)}: walls {json.dumps(seeds)}; loops of seed "
          f"{SEEDS[0]}: {json.dumps(timed[SEEDS[0]])}; in the warm-up run: {json.dumps(warm)}",
          flush=True)
    windows = steady_windows(s, "A", modes=(False,))
    windows["on_device=True"] = run_window(s, "A")
    first = SEEDS[0]
    return dict(launches=launched[first], wall=seeds[first], iters=int(s.state.hist.t),
                loops=timed[first], run_graphs=run_graphs, set_conditional=set_conditional[first],
                seed_walls=seeds, windows=windows)


def check_fit_replays(name: str, loops: dict) -> None:
    """A graphed clustered run fits its clusters inside replays, of the
    "hgm_fit" stretch (the per-iteration route) or of the device run loop
    ("run", whose body holds the fit's IF nodes): no split-round read, no
    round head or tail replayed on its own."""
    split = {"split_round reads": loops.get("split_round", {}).get("reads", 0),
             **{f"{k} replays": loops.get(k, {}).get("replays", 0)
                for k in ("split_head", "split_tail")}}
    replays = sum(loops.get(k, {}).get("replays", 0) for k in ("hgm_fit", "run"))
    check(replays > 0 and not any(split.values()),
          f"{name}: {loops.get('hgm_fit')} hgm_fit stretch, {loops.get('run')} run loop, "
          f"{split}")


def check_graphed_pair(name: str, eager, graphed, eager_launches: dict,
                       graphed_launches: dict) -> None:
    """Sampler `graphed` (run(on_device=True)) against `eager` (False), each
    fresh and run once: the ladder, logZ, steps, calls and kernel launches
    (the eager ones less its chunks' steps past the stop) bit for bit, and
    its cluster fits replayed as one stretch each."""
    for key in ("beta", "logz", "steps", "calls"):
        check(graphed.results()[key].tobytes() == eager.results()[key].tobytes(),
              f"{name}: {key} with on_device=True differs from on_device=False")
    eager_launches = less_past_stop(eager, eager_launches, name)
    check(graphed_launches == eager_launches,
          f"{name}: launches {graphed_launches} with on_device=True, {eager_launches} False")
    check_fit_replays(f"{name} on_device=True", loop_stats(graphed))
    print(f"{name}: on_device=True equals on_device=False bit for bit (logz "
          f"{graphed.evidence()[0]!r}, {int(graphed.state.hist.t)} iterations); loops "
          f"{json.dumps(loop_stats(graphed))}", flush=True)


def window_reads(w: dict) -> str:
    """A window's MCMC reads, blocking reads and WHILE iterations, each an
    iteration, and the MCMC route by name."""
    route = ("one WHILE node" if w["graphs"] else "keyed draws in chunks") if (
        w["mcmc_route"] == "while") else "the chunked route"
    return (f"MCMC reads {w['mcmc_reads_per_iter']:.1f}, blocking reads "
            f"{w['blocking_per_iter']:.1f}, WHILE iterations {w['while_iterations_per_iter']:.1f} "
            f"an iteration (MCMC on {route})")


def steady_windows(s, name: str, n: int = 3, device_only: bool = True,
                   graphed_max_blocking=None, modes=(False, True)) -> dict:
    """Iterations 21 to 20 + n of A's seed 42 on sampler `s` in each of
    `modes` (graphs off, on: the per-iteration route) under the profiler;
    at most one blocking host read a loop chunk plus READS_BESIDE_CHUNKS an
    iteration, and fewer than MAX_READS; graphed, no MCMC read on the WHILE
    route, and at most `graphed_max_blocking` blocking reads an iteration
    where given."""
    windows = {}
    for graphs in modes:
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
              f"iteration {w['reads']}, eigvalsh operators {w['eigh_ops']}; ps/cluster "
              f"{w['stages_ms'].get('ps/cluster', 0.0):.3f} host ms and "
              f"{w['replays'].get('hgm_fit', 0) / w['n']:.1f} hgm_fit replays an iteration; "
              f"stage ms an iteration "
              f"{json.dumps({k: round(v, 3) for k, v in w['stages_ms'].items()})}"
              f"{trace}; {window_reads(w)}", flush=True)
        if cuda_em is not None:
            em_ms, em_n = _kernel_ms(w, "mvstud_em_kernel")
            print(f"{name} {'graphs' if graphs else 'no graphs'}: mode EM kernel {em_ms:.4f} ms "
                  f"and {em_n:.2f} launches an iteration in the window, EM iterations a launch "
                  f"{w['mode_em_iterations']}", flush=True)
        check_window(f"{name} {'graphs' if graphs else 'no graphs'}", w,
                     graphed_max_blocking if graphs else None)
    return windows


def check_window(name: str, w: dict, max_blocking=None) -> None:
    """6b's rule: at most one blocking host read a loop chunk plus
    READS_BESIDE_CHUNKS an iteration, fewer than MAX_READS, and no
    torch.linalg.eigvalsh operator; graphed on the WHILE route, no MCMC
    read and as many WHILE iterations as steps; at most `max_blocking`
    blocking reads an iteration where given."""
    if w["graphs"] and w["mcmc_route"] == "while":
        check(w["mcmc_reads_per_iter"] == 0 and w["while_iterations_per_iter"] > 0,
              f"{name}: {window_reads(w)}: a graphed chain reads nothing")
    if max_blocking is not None:
        check(w["blocking_per_iter"] <= max_blocking,
              f"{name}: {w['blocking_per_iter']} blocking reads an iteration, at most "
              f"{max_blocking} allowed ({w['blocking']})")
    check(w["blocking_per_iter"] <= w["chunk_reads_per_iter"] + READS_BESIDE_CHUNKS
          and w["blocking_per_iter"] < MAX_READS,
          f"{name}: {w['blocking_per_iter']} blocking reads an iteration for "
          f"{w['chunk_reads_per_iter']} chunk reads")
    check(cuda_linalg is None or w["eigh_ops"] == 0,
          f"{name}: {w['eigh_ops']} torch.linalg.eigvalsh operators in the window")
    em_reads = {k: w["reads"].get(k, 0) for k in ("mode_em", "gmm_em")}
    check(cuda_em is None or not any(em_reads.values()),
          f"{name}: EM chunk reads in the window {em_reads}")
    if w["graphs"] and hasattr(loops_module.Loops, "when"):
        # The graphed fit is one replay of the "hgm_fit" stretch an
        # iteration (A fits every iteration): no split-round read, and no
        # replay of a round's head or tail of its own.
        split = {"split_round reads": w["reads"].get("split_round", 0),
                 **{f"{k} replays": w["replays"].get(k, 0) for k in ("split_head", "split_tail")}}
        hgm = w["replays"].get("hgm_fit", 0)
        check(not any(split.values()) and hgm == (w["n"] if w["clustered"] else 0),
              f"{name}: {split}, {hgm} hgm_fit replays in {w['n']} graphed iterations")


def phase_hardware_prng(device) -> dict:
    """7: A with hardware_prng=True, seed 42, with run(on_device=False), then
    with run(on_device=True) on a sampler whose seed-43 run captured the
    graphs: the ladder, logZ, steps, calls, launches and the draws' final
    state (generator, Philox key and call counter, host mirror and device
    words) equal bit for bit, and the launches, the eager run's less its
    chunks' steps past the stop; one mutation-draws launch a step body in
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
    res, logz, iters = s.results(), s.evidence()[0], int(s.state.hist.t)
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
    check(launched == eager["real_launches"] and bodies == eager["bodies"] - eager["past_stop"]
          and launched["mutation_draws"] == bodies,
          f"A hardware_prng fused: launches {launched} ({bodies} bodies) against "
          f"on_device=False {eager['real_launches']} ({eager['bodies']} bodies, "
          f"{eager['past_stop']} past the stop)")
    state = draws.get_state()
    check(all(state[k].tobytes() == eager["draws"][k].tobytes() for k in eager["draws"])
          and words == (draws.counter, draws.key),
          f"A hardware_prng fused: final draw state {state['philox_counter']} / words {words} "
          f"against on_device=False {eager['draws']['philox_counter']}")
    check(timed["run"].get("replays", 0) == 1 and timed["run"].get("reads", 0) == 1 and all(
        v.get("captures", 0) == 0 for v in timed.values()) and not any(
        v.get("reads", 0) for k, v in timed.items() if k != "run"),
          f"A hardware_prng fused: one replay and one read of the run loop, no capture and "
          f"no other read: {timed}")
    # Three iterations eagerly, host and device traced (the profiler's own
    # cost keeps the window short), and a whole run on this sampler's graph.
    windows = steady_windows(s, "A hardware_prng", n=3, device_only=False, modes=(False,))
    windows["on_device=True"] = run_window(s, "A hardware_prng")
    return dict(launches=launches, launches_fused=launched, wall=wall, wall_eager=eager["wall"],
                iters=iters, iters_eager=eager["iters"], loops=timed, windows=windows)


def run_b(device, dtype, name: str, graphs: bool = False, s=None):
    """B's iterations up to its B_MUTATIONS-th mutation, from a fresh sampler
    (or `s`, reset to seed 42), with the loops' CUDA graphs on if `graphs`
    (what run(on_device=True) turns on, core.py:225): per iteration its
    number, wall, beta, logZ, MCMC steps and step bodies (those past the
    stop, and the rest: `real_bodies`), acceptance, kernel launches (and
    those of the real steps) and the call counter after it; the counts are
    set to 0 first.
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
            past = loops.stats["mcmc"]["past_stop"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = s.sample()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched, bodies = diff(counts(), before), mcmc_bodies(s) - bodies
            past = loops.stats["mcmc"]["past_stop"] - past
            fits = MODE_FITS - fits
            print(f"{name} iteration {out['iter']}: {wall:.3f} s beta={out['beta']:.6g} "
                  f"steps={out['steps']} bodies={bodies} (past the stop {past}) "
                  f"acceptance={out['acceptance']:.4f} mode_fits={fits} launches={launched}",
                  flush=True)
            rows.append(dict(iter=int(out["iter"]), wall=wall, beta=out["beta"], logz=out["logz"],
                             steps=int(out["steps"]), bodies=bodies, past=past,
                             real_bodies=bodies - past,
                             real_launches=without_past_stop(
                                 launched, past, bodies, name,
                                 iteration_uniforms(s, [out["beta"]])),
                             acceptance=out["acceptance"], launches=launched, fits=fits,
                             counter=getattr(s.state.draws, "counter", None),
                             generator_offset=s.state.draws.generator.get_offset()))
            mutations += out["beta"] > 0.0
    finally:
        loops.graphs = False
    return s, rows


def profile_b(s, n_before: int) -> None:
    """B's last mutation iteration, graphed, under torch.profiler after the
    ones before it: wall, device time and idle share, and the host ops and
    device kernels that take the most time. The mode EM's graph replays are
    also timed by CUDA events around `loops.once` (the replay with its
    carry's copies), beside the profile's record of the kernel, and the
    device time and idle share restated with the events' time in its
    place."""
    from torch.profiler import ProfilerActivity, profile

    s.reset(random_state=42)
    loops = s.state._iteration.loops
    loops.graphs = True
    replays = []  # (start, end) events around each mode EM replay
    once = loops.once

    def timed_once(name, fn, inputs, static=()):
        if name != "mode_em":
            return once(name, fn, inputs, static)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = once(name, fn, inputs, static)
        b.record()
        replays.append((a, b))
        return out

    try:
        for _ in range(n_before):
            s.sample()
        torch.cuda.synchronize()
        settle()
        before = {k: dict(v) for k, v in loops.stats.items()}
        loops.once = timed_once
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profile_warmup()
            t0 = time.perf_counter()
            out = s.sample()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        loops.graphs = False
        del loops.once  # the class's method again
    settle()
    mcmc = {c: loops.stats["mcmc"].get(c, 0) - before.get("mcmc", {}).get(c, 0)
            for c in ("reads", "node_bodies", "chunks")}
    blocking = sum(1 for e in prof.events() if e.name in BLOCKING_CALLS)
    events = prof.key_averages()
    dev = [(k, ms) for k, (ms, _) in device_rows(prof).items()]
    device_ms = sum(ms for _, ms in dev)
    mode_em_ms = sum(a.elapsed_time(b) for a, b in replays)
    profiled_mode_em_ms = sum(ms for k, ms in dev if "mvstud_em" in k)
    restated_ms = device_ms - profiled_mode_em_ms + mode_em_ms
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
          f"{median_ms:.4f} ms, torch.cumsum's outer-dimension scan {scan_ms:.4f} ms; MCMC "
          f"reads {mcmc['reads']}, blocking calls {blocking} (the profile's closing "
          f"synchronize included), WHILE iterations {mcmc['node_bodies']} for "
          f"{out['steps']} steps, MCMC chunks {mcmc['chunks']} (MCMC on "
          f"{'one WHILE node' if keyed_route(s) else 'the chunked route'})",
          flush=True)
    check(not keyed_route(s) or (mcmc["reads"] == 0 and mcmc["chunks"] == 0
                                 and mcmc["node_bodies"] == out["steps"]),
          f"B graphed iteration {out['iter']}: MCMC {mcmc} for {out['steps']} steps")
    print(f"B graphed iteration {out['iter']}: the mode EM's {len(replays)} graph replays "
          f"{mode_em_ms:.4f} ms by CUDA events (the profile recorded {profiled_mode_em_ms:.4f} ms "
          f"of mvstud_em); device time with the events' {restated_ms:.1f} ms (idle "
          f"{100 * (1 - restated_ms / (1e3 * wall)):.1f} %)", flush=True)
    return {"wall_ms": 1e3 * wall, "device_ms": device_ms, "weighted_median_ms": median_ms,
            "mcmc_reads": mcmc["reads"], "while_iterations": mcmc["node_bodies"],
            "blocking_calls": blocking, "steps": out["steps"],
            "scan_outer_dim_ms": scan_ms, "mode_em_replays": len(replays),
            "mode_em_ms": mode_em_ms, "profiled_mode_em_ms": profiled_mode_em_ms,
            "device_ms_with_mode_em_events": restated_ms}


def phase_large_ensemble(device, dtype=torch.float32) -> dict:
    """B: the first four mutation iterations at N = 131,072, eagerly and
    with the loops' CUDA graphs (a first pass captures them, a second is
    timed), the same values and launches (the eager chunks' less their
    steps past the stop) bit for bit, one normal, one gamma and one uniform
    launch a step body (float32: the bits kernel's uniform mode; float64:
    the `_f64` kernels, where hardware_prng does not apply and the draws
    are `Draws`' keyed ones), the chain one WHILE node graphed, and no draw
    from the generator (its offset unmoved); the ESS kernel of the dtype."""
    f64 = dtype == torch.float64
    name = "B float64" if f64 else "B"
    prng = prng_names(dtype)
    since = len(FORMS)
    s, rows = run_b(device, dtype, name)
    total = counts()  # the eager run's: run_b set the counts to 0 before it
    g, _ = run_b(device, dtype, f"{name} graphed (capturing)", graphs=True)
    g, graphed = run_b(device, dtype, f"{name} graphed", graphs=True, s=g)
    for a, b in zip(rows, graphed):
        for k in ("iter", "beta", "logz", "steps", "real_bodies", "acceptance",
                  "real_launches", "fits", "counter"):
            check(a[k] == b[k], f"{name} graphed iteration {a['iter']}: {k} {b[k]!r} against "
                  f"eager {a[k]!r}")
    check(len(rows) == len(graphed), f"{name} graphed: {len(graphed)} iterations, {len(rows)} "
          "eager")
    # N d^2 = 13.1 M > 2^21: JAX's K-loop form, eagerly and graphed (K = 1)
    check_forms(name, since, K_LOOP)
    check(g.state.draws.calls.read() == (g.state.draws.counter, g.state.draws.key),
          f"{name} graphed: the call counter's device words and host mirror differ")
    check(all(r["generator_offset"] == 0 for r in rows + graphed),
          f"{name}: the generator moved: offsets "
          f"{[r['generator_offset'] for r in rows + graphed]}")
    profiled = None if f64 else profile_b(g, len(graphed) - 1)
    mut = [(a["wall"], b["wall"]) for a, b in zip(rows, graphed) if a["beta"] > 0.0]
    print(f"{name} seconds a mutation iteration, eager / graphed: "
          f"{', '.join(f'{a:.4f} / {b:.4f}' for a, b in mut)}; mean "
          f"{sum(a for a, _ in mut) / len(mut):.4f} / {sum(b for _, b in mut) / len(mut):.4f}",
          flush=True)
    betas = []
    for row in rows:
        if row["beta"] == 0.0:
            continue
        launched, bodies = row["launches"], row["bodies"]
        uniforms = iteration_uniforms(s, [row["beta"]])
        others = {k: launched.get(k, 0) for k in STEP_KERNELS if k not in prng.values()}
        check(launched[prng["normal"]] == bodies and launched[prng["gamma"]] == bodies
              and launched[prng["uniform"]] == bodies + uniforms
              and bodies == row["steps"] + row["past"] and launched[prng["mutation"]] == 0
              and not any(others.values()),
              f"{name}: launches {launched} for {bodies} MCMC step bodies, {row['steps']} steps "
              f"(want 1 {prng['normal']} + 1 {prng['gamma']} + 1 {prng['uniform']} a step "
              f"body, and {uniforms} {prng['uniform']} for the resampling)")
        check(cuda_median is None or row["launches"]["weighted_median"] == row["fits"],
              f"{name} iteration {row['iter']}: {row['launches'].get('weighted_median')} "
              f"weighted-median launches for {row['fits']} mode fits")
        check(row["acceptance"] > 0.1, f"{name}: acceptance {row['acceptance']}")
        check(not betas or row["beta"] > betas[-1], f"{name}: beta did not rise: {betas}")
        betas.append(row["beta"])
    errs = {}

    # The normal kernel at this path's R*N*d (several grid-stride passes per
    # thread) against its plain version.
    z_shape = (N_PROPOSAL_CANDIDATES, B_PARTICLES, N_DIM)
    n_z = math.prod(z_shape)
    key = philox.key_from_seed(2024)
    z = cuda_prng.hw_normal(key, 20, z_shape, device, dtype).reshape(-1)
    plain = philox.normal_f64 if f64 else philox.normal
    err_n = float(torch.max(torch.abs(z - plain(key, 20, n_z, device))))
    tol = DRAW_TOL_F64 if f64 else DRAW_TOL
    print(f"{name}: {prng['normal']} kernel at n={n_z}: max|dz|={err_n:.3g} against its plain "
          "version", flush=True)
    check(err_n <= tol, f"{name}: normal kernel differs from plain by {err_n} at n={n_z}")
    errs[prng["normal"]] = err_n

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
    print(f"{name}: ESS kernel at S={S} (t={int(hist.t)}, {probes} probes): "
          f"kernel {t['kernel']:.4f} ms, "
          f"plain {t['plain']:.4f} ms (median of 10); launches {total}", flush=True)
    return total, errs, dict(eager=rows, graphed=graphed, profiled=profiled)


def c_sampler(device, **kw):
    return Sampler(prior_transform, bimodal, n_dim=N_DIM, n_particles=256, vectorize=True,
                   clustering=True, k_max=8, history_capacity=64, random_state=4,
                   device=device, **kw)


def phase_bimodal(device) -> dict:
    """C: tests/test_multimodal.py's 10-D mixture, clustered, on the card;
    then with run(on_device=True), bit for bit."""
    s = c_sampler(device)
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
    eager = counts()
    g = c_sampler(device)
    reset_counts()
    g.run(n_total=512, progress=False, on_device=True)
    check_graphed_pair("bimodal (C)", s, g, eager, counts())
    return eager


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
    iters = int(s.state.hist.t)
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
        check(launched["ess_bisect"] == int(s.state.hist.t) - 1,
              f"reference surface: {launched['ess_bisect']} ESS launches for "
              f"{int(s.state.hist.t) - 1} reweights")
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
        check(int(unpickled.state.hist.t) == int(live.state.hist.t), "pickle: another iteration")
        unpickled.run(n_total=N_TOTAL, progress=False)
        out["pickle"] = counts()
        check_run(f"reference surface from a pickle at iteration {int(live.state.hist.t)}",
                  unpickled, CLUSTERED_LOGZ, out["pickle"])
    return out


def dynamic_sampler(device, seed, dtype=torch.float32):
    return Sampler(prior_transform, rosenbrock_chained, n_dim=N_DIM, n_particles=N_PARTICLES,
                   vectorize=True, clustering=False, history_capacity=192, volume_variation=1.0,
                   random_state=seed, dtype=dtype, device=device)


def phase_dynamic(device) -> dict:
    """12: dynamic (CV) mode on rosenbrock10_cv, seed 42, with
    run(on_device=False) and then run(on_device=True), the device run loop,
    on a sampler whose seed-43 run captured its graph (its nodes and depth
    printed): bit for bit, logZ in the anchor, no ESS-mode launch, one
    bracket-mode launch a reweight and no "ess_bracket" loop body, the
    eigenvalue kernel's launches equal and at least the CV probes plus the
    final CVs, the probes (device words) equal; on the run loop one replay
    and one read a run, none between iterations, a WHILE body run an
    iteration after the first and CV-bisection WHILE bodies, no capture;
    walls, probes and reads per reweight; then iterations 21-23 on the
    per-iteration route in each mode under the profiler, held to at most
    one blocking read a loop chunk plus READS_BESIDE_CHUNKS an iteration,
    and a whole run on the run loop (`run_window`); last `dynamic_bisection`,
    a small case whose CV steps reach the bisection on the run loop."""
    runs, run_graphs = {}, []
    for on_device in (False, True):
        s = dynamic_sampler(device, SEEDS[1] if on_device else SEEDS[0])
        check(fused_iteration(s), "dynamic: not on the fused route")
        check(run_loop(s), "dynamic: not on the device run loop's route")
        if on_device:
            s.run(n_total=N_TOTAL, progress=False, on_device=True)  # captures the graph
            run_graphs = [dict(nodes=g.nodes, depth=g.depth, capture_s=g.capture_s)
                          for g in s.state._iteration.loops.graphs_of("run")]
            print(f"dynamic: the run loop's graph (top-level nodes, nodes in the conditional "
                  f"bodies; nesting depth; seconds of capture and instantiation): "
                  f"{json.dumps(run_graphs)}", flush=True)
            check(len(run_graphs) == 1 and run_graphs[0]["depth"] >= 3,
                  f"dynamic: the run loop's graphs {run_graphs}")
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
        iters = int(s.state.hist.t)
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
    real = less_cv_past_stop(less_past_stop(eager["sampler"], eager["launches"], "dynamic"),
                             eager["loops"],
                             fused["loops"].get("cv_bisect", {}).get("node_bodies", 0))
    check(fused["logz"] == eager["logz"] and fused["launches"] == real
          and fused["probes"] == eager["probes"],
          f"dynamic: logZ {fused['logz']!r} / {eager['logz']!r}, launches "
          f"{fused['launches']} / {real} (less the eager chunks' steps past the stop), probes "
          f"{fused['probes']} / {eager['probes']}")
    loops = fused["loops"]
    # the run loop: one replay and one read, no other read, no capture; a
    # WHILE body run an iteration after the first; the CV step's IF body
    # once a crossing (two boundary CVs each, as the eager run's one
    # boundary read a crossing), the CV bisection's WHILE body once a CV
    # probe past those
    crossings = loops.get("cv_step", {}).get("node_bodies", 0)
    bisection = loops.get("cv_bisect", {}).get("node_bodies", 0)
    check(loops["run"].get("replays") == 1 and loops["run"].get("reads") == 1
          and not any(v.get("reads", 0) for k, v in loops.items() if k != "run")
          and all(v.get("captures", 0) == 0 for v in loops.values())
          and loops["run"].get("node_bodies") == fused["iters"] - 1
          and crossings > 0 and bisection == fused["probes"]["cv"] - 2 * crossings
          and loops["mcmc"].get("node_bodies", 0) > 0,
          f"dynamic on_device=True, the run loop: {loops}, probes {fused['probes']}")
    print(f"dynamic seed {SEEDS[0]} on the device run loop: one replay and one read, "
          f"{loops['run']['node_bodies']} run-loop WHILE bodies, {crossings} CV-step IF "
          f"bodies (the eager run's boundary reads "
          f"{eager['loops'].get('cv_bisect', {}).get('reads', 0)}), {bisection} "
          f"CV-bisection WHILE bodies, {loops['mcmc']['node_bodies']} MCMC WHILE bodies",
          flush=True)
    windows = steady_windows(fused["sampler"], "dynamic", n=3, device_only=False)
    windows["run loop"] = run_window(fused["sampler"], "dynamic")
    return {"launches": eager["launches"], "probes": eager["probes"],
            "wall_s": {"on_device=False": eager["wall"], "on_device=True": fused["wall"]},
            "iters": eager["iters"], "loops": {"on_device=False": eager["loops"],
                                               "on_device=True": fused["loops"]},
            "run_graphs": run_graphs, "windows": windows,
            "bisection": dynamic_bisection(device), "float64": dynamic_float64(device)}


def dynamic_float64(device) -> dict:
    """12, float64: rosenbrock10_cv in float64 (seed 42), eagerly and on
    the run loop (`float64_on_loop`), bit for bit, the eager run's
    eigenvalue launches less its CV chunks' probes past the loop's end;
    logZ inside the anchor, one bracket launch a reweight."""
    out = float64_on_loop(
        "dynamic float64 (rosenbrock10_cv)",
        lambda seed: dynamic_sampler(device, seed, torch.float64), N_TOTAL,
        adjust=lambda real, eager_loops, loops: less_cv_past_stop(
            real, eager_loops, loops.get("cv_bisect", {}).get("node_bodies", 0)))
    logz, launched = out["fused"]["logz"], out["eager"]["launches"]
    check(abs(logz - CV_LOGZ[0]) <= CV_LOGZ[1], f"dynamic float64: logZ {logz} outside {CV_LOGZ}")
    check(cuda_median is None or launched["ess_bracket"] == out["iters"] - 1,
          f"dynamic float64: {launched.get('ess_bracket')} bracket launches for "
          f"{out['iters'] - 1} reweights")
    return {k: out[k] for k in ("walls", "ms_per_iter", "iters", "graphs", "steps")}


def less_cv_past_stop(launches: dict, eager_loops: dict, bisection: int) -> dict:
    """An eager dynamic run's launches less the eigenvalue launches of its
    "cv_bisect" chunks' bodies past the loop's end (a chunk of 8 bodies
    runs its CV probes after `done` too, changing nothing), which a WHILE
    node does not run: `bisection` is the bisection's real probes."""
    past = eager_loops.get("cv_bisect", {}).get("bodies", 0) - bisection
    return dict(launches, sym_eigvals=launches["sym_eigvals"] - past)


def narrow_gaussian(x):
    return -0.5 * torch.sum((x / 0.3) ** 2, dim=-1)


def dynamic_bisection(device) -> dict:
    """12, last: a small dynamic case whose CV steps reach the bisection
    (rosenbrock10_cv's seed 42 ends every CV step on a boundary rule): a
    2-D narrow Gaussian, N = 128, volume_variation=0.03, fresh samplers
    with run(on_device=False) and True (the run loop, captured in that run)
    for seeds 11, 4 and 5 until one runs CV-bisection bodies: bit for bit,
    the probes and the launches equal (the eager ones less the chunks'
    steps past the stop), on the run loop one replay and one read, the CV
    step's IF body once a crossing and the CV bisection's WHILE body once a
    bisection probe."""
    for seed in (11, 4, 5):
        runs = {}
        for on_device in (False, True):
            s = Sampler(lambda u: 8.0 * u - 4.0, narrow_gaussian, n_dim=2, n_particles=128,
                        vectorize=True, clustering=False, history_capacity=64,
                        volume_variation=0.03, random_state=seed, device=device)
            reset_counts()
            before = dict(reweight_step.PROBES)
            s.run(n_total=512, progress=False, on_device=on_device)
            launched = counts()
            runs[on_device] = dict(results=s.results(), launches=launched, sampler=s,
                                   probes={k: reweight_step.PROBES[k] - before[k] for k in before},
                                   loops=loop_stats(s))
        eager, fused = runs[False], runs[True]
        name = f"dynamic CV bisection (2-D narrow Gaussian, seed {seed})"
        for key in ("beta", "logz", "ess", "cv", "steps", "calls"):
            check(fused["results"][key].tobytes() == eager["results"][key].tobytes(),
                  f"{name}: {key} with on_device=True differs from on_device=False")
        loops, probes = fused["loops"], fused["probes"]
        crossings = loops.get("cv_step", {}).get("node_bodies", 0)
        bisection = loops.get("cv_bisect", {}).get("node_bodies", 0)
        real = less_cv_past_stop(less_past_stop(eager["sampler"], eager["launches"], name),
                                 eager["loops"], bisection)
        check(fused["launches"] == real and fused["probes"] == eager["probes"],
              f"{name}: launches {fused['launches']} / {real}, probes {fused['probes']} / "
              f"{eager['probes']}")
        check(loops["run"].get("replays") == 1 and loops["run"].get("reads") == 1
              and not any(v.get("reads", 0) for k, v in loops.items() if k != "run")
              and bisection == probes["cv"] - 2 * crossings,
              f"{name}: the run loop {loops}, probes {probes}")
        print(f"{name}: on the run loop bit for bit with on_device=False, "
              f"{int(fused['sampler'].state.hist.t)} iterations, {crossings} CV-step IF bodies, "
              f"{bisection} CV-bisection WHILE bodies, probes {json.dumps(probes)}, eigenvalue "
              f"launches {fused['launches']['sym_eigvals']}", flush=True)
        if bisection > 0:
            return dict(seed=seed, crossings=crossings, bisection_bodies=bisection, probes=probes,
                        launches=fused["launches"])
    fail("dynamic CV bisection: no CV-bisection body ran in seeds 11, 4 and 5")


def phase_cadence_and_host(device, cadence: bool = True) -> dict:
    """13: C with cluster_every=3 (with run(on_device=False) and True, bit
    for bit; not where `cadence` is False), the 10-D Gaussian as a host
    likelihood, with pool=None and with a spawned pool of two workers
    (`pooled_host`), and A with its likelihood on the host (`host_route`)."""
    out = {}
    if cadence:
        out["cadence"] = cadence_run(device)
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
    out["host"] = host
    if cuda_host is not None:
        out.update(pooled_host(device, s, wall))
        out.update(host_route(device))
    return out


def cadence_run(device) -> dict:
    """C with cluster_every=3, run(on_device=False) and True, bit for bit."""
    s = c_sampler(device, cluster_every=3)
    reset_counts()
    s.run(n_total=512, progress=False)
    cadence = counts()
    g = c_sampler(device, cluster_every=3)
    reset_counts()
    g.run(n_total=512, progress=False, on_device=True)
    check_graphed_pair("cadence (C, cluster_every=3)", s, g, cadence, counts())
    k = int(s.state.cluster_model.n_clusters())
    x, w, _ = s.posterior()
    mass = float(np.sum(w[x[:, 0] > 0]))
    print(f"cadence (C, cluster_every=3): clusters={k} mass(x0>0)={mass:.4f} "
          f"logz={s.evidence()[0]:.4f} beta={s.beta:.6f} launches={cadence}", flush=True)
    check(k >= 2 and 0.15 < mass < 0.85, f"cadence: {k} cluster(s), mass {mass}")
    check(cadence["ess_bisect"] > 0, "cadence: no ESS kernel launch")
    return cadence


POOL_WORKERS = 2


def timed_map(s) -> TimedPool:
    """Wrap sampler `s`'s host map (its crossing's) in a `TimedPool`."""
    crossing = s.state._loglike_batch
    if not isinstance(crossing.pool_map, TimedPool):
        crossing.pool_map = TimedPool(crossing.pool_map)
    return crossing.pool_map


def pooled_host(device, plain, plain_wall: float) -> dict:
    """13a: the 10-D Gaussian host likelihood with pool=POOL_WORKERS (spawned
    workers, which import this script by name and touch no CUDA), eagerly
    and on the run loop (after a capturing run), each bit for bit
    `plain`'s run (pool=None, eager): beta, logZ, ESS, steps and calls; map
    calls = handshakes = sweeps; the pool's seconds and the rest of the
    wall; then a likelihood raising inside a worker at a later sweep of a
    run on the run loop: its RuntimeError, no map call or handshake after
    the failing one, and after reset() the clean run's bits. Returns the
    launches of the pooled runs by route."""
    s = Sampler(prior_transform, gaussian_numpy, n_dim=N_DIM, n_particles=512,
                host_likelihood=True, clustering=False, random_state=0, history_capacity=64,
                pool=POOL_WORKERS, device=device)
    timed = timed_map(s)
    want = plain.results()
    runs, launches = {}, {}
    try:
        for on_device in (False, True):
            if on_device:
                s.reset(random_state=1)
                s.run(n_total=2048, progress=False, on_device=True)  # captures the graph
            s.reset(random_state=0)
            calls, seconds, served = timed.calls, timed.seconds, cuda_host.HANDSHAKES
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.run(n_total=2048, progress=False, on_device=on_device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[on_device] = counts()
            got = s.results()
            for key in ("beta", "logz", "ess", "steps", "calls"):
                check(got[key].tobytes() == want[key].tobytes(),
                      f"pool={POOL_WORKERS} on_device={on_device}: {key} differs from pool=None")
            sweeps = int(s.state.cur.calls)
            runs[f"on_device={on_device}"] = run = {
                "wall": wall, "pool_s": timed.seconds - seconds,
                "rest_s": wall - (timed.seconds - seconds), "map_calls": timed.calls - calls,
                "handshakes": cuda_host.HANDSHAKES - served, "sweeps": sweeps,
                "iters": int(s.state.hist.t), "logz": s.evidence()[0]}
            check(run["map_calls"] == run["handshakes"] == sweeps > 0,
                  f"pool={POOL_WORKERS} on_device={on_device}: {run['map_calls']} map calls, "
                  f"{run['handshakes']} handshakes, {sweeps} sweeps")
            if on_device:
                stats = loop_stats(s)["run"]
                check(stats.get("replays", 0) >= 1 and launches[True]["host_call"] == sweeps,
                      f"pool on the run loop: {stats}, {launches[True]['host_call']} launches")
        sweeps = runs["on_device=True"]["sweeps"]
        calls, served, raised = timed.calls, cuda_host.HANDSHAKES, None
        timed.raise_at = calls + sweeps // 2
        s.reset(random_state=0)
        try:
            s.run(n_total=2048, progress=False, on_device=True)
        except RuntimeError as exc:
            raised = exc
        made, handshakes = timed.calls - calls, cuda_host.HANDSHAKES - served
        check(raised is not None and "in worker" in str(raised) and made == sweeps // 2
              and handshakes == made,
              f"pool={POOL_WORKERS}: a raising worker gave {raised!r}, {made} map calls and "
              f"{handshakes} handshakes for a failure at map call {sweeps // 2}")
        timed.raise_at = None
        s.reset(random_state=0)
        s.run(n_total=2048, progress=False, on_device=True)
        for key in ("beta", "logz", "steps", "calls"):
            check(s.results()[key].tobytes() == want[key].tobytes(),
                  f"pool={POOL_WORKERS}: {key} after a raising worker and reset() differs")
    finally:
        s.close()
    print(f"host likelihood with pool={POOL_WORKERS}: bit for bit pool=None eagerly and on the "
          f"run loop; map calls = handshakes = sweeps; {json.dumps(runs)}; pool=None eagerly "
          f"{plain_wall:.3f} s; a worker raising at map call {sweeps // 2} ended the run there "
          f"({raised!r}), and after reset() the run repeats the clean bits", flush=True)
    return {"host_pool": launches[False], "host_pool_fused": launches[True],
            "pool_runs": runs}


def host_route(device) -> dict:
    """13b-d: A with its likelihood on the host (`host_a_sampler`) on both
    routes, object blobs on the run loop, and a likelihood that raises on
    it. Returns the launches of A's runs by route."""
    runs = {}
    for on_device in (False, True):
        pool = TimedPool()
        s = host_a_sampler(device, SEEDS[1] if on_device else SEEDS[0], pool=pool)
        graphs = None
        if on_device:
            s.run(n_total=N_TOTAL, progress=False, on_device=True)  # captures the graph
            graphs = [dict(nodes=g.nodes, depth=g.depth, capture_s=g.capture_s)
                      for g in s.state._iteration.loops.graphs_of("run")]
            check(len(graphs) == 1 and graphs[0]["depth"] >= 2, f"A host: graphs {graphs}")
            s.reset(random_state=SEEDS[0])
        warm = loop_stats(s)
        calls, seconds = pool.calls, pool.seconds
        reset_counts()
        served = cuda_host.HANDSHAKES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run(n_total=N_TOTAL, progress=False, on_device=on_device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        handshakes = cuda_host.HANDSHAKES - served
        loops = {k: {c: v.get(c, 0) - warm.get(k, {}).get(c, 0) for c in v}
                 for k, v in loop_stats(s).items()}
        host_s = pool.seconds - seconds
        runs[on_device] = dict(sampler=s, results=s.results(), logz=s.evidence()[0], wall=wall,
                               pool_s=host_s, rest_s=wall - host_s, map_calls=pool.calls - calls,
                               sweeps=int(s.state.cur.calls), iters=int(s.state.hist.t),
                               handshakes=handshakes, launches=launched, loops=loops,
                               graphs=graphs)
    eager, fused = runs[False], runs[True]
    for key in ("beta", "logz", "ess", "steps", "calls"):
        check(fused["results"][key].tobytes() == eager["results"][key].tobytes(),
              f"A host: {key} with on_device=True differs from on_device=False")
    lo, hi = CLUSTERED_LOGZ[0] - CLUSTERED_LOGZ[1], CLUSTERED_LOGZ[0] + CLUSTERED_LOGZ[1]
    check(fused["logz"] == eager["logz"] == A_HOST_LOGZ and lo <= fused["logz"] <= hi
          and fused["sampler"].beta == 1.0,
          f"A host: logZ {fused['logz']!r} / {eager['logz']!r}, not {A_HOST_LOGZ!r}")
    for name, run in runs.items():
        check(run["map_calls"] == run["sweeps"] == run["handshakes"] > 0,
              f"A host on_device={name}: {run['map_calls']} map calls and {run['handshakes']} "
              f"handshakes for {run['sweeps']} sweeps")
    loops = fused["loops"]
    reads = sum(v.get("reads", 0) for v in loops.values())
    check(loops["run"].get("replays") == 1 and loops["run"].get("reads") == 1 and reads == 1
          and all(v.get("captures", 0) == 0 for v in loops.values())
          and loops["run"].get("node_bodies") == fused["iters"] - 1,
          f"A host on the run loop: {loops} for {fused['iters']} iterations")
    # eagerly the kernel launches in every MCMC body, and a body past the
    # stop makes no handshake; the run loop runs the real steps alone
    past = eager["loops"]["mcmc"]["past_stop"]
    check(fused["launches"]["host_call"] == fused["sweeps"]
          and eager["launches"]["host_call"] - past == eager["sweeps"]
          and "likelihood" not in eager["loops"],
          f"A host: {fused['launches']['host_call']} host-call launches on the run loop, "
          f"{eager['launches']['host_call']} eagerly ({past} steps past the stop), for "
          f"{fused['sweeps']} sweeps; eager loops {eager['loops']}")
    real = less_past_stop(eager["sampler"], eager["launches"], "A host")
    real["host_call"] -= past
    check(fused["launches"] == real,
          f"A host: launches {fused['launches']} on the run loop, {real} eagerly less the "
          f"chunks' steps past the stop")
    shown = {f"on_device={k}": {f: r[f] for f in ("wall", "pool_s", "rest_s", "map_calls",
                                                  "handshakes", "sweeps", "iters", "logz")}
             for k, r in runs.items()}
    print(f"A host (rosenbrock_numpy, seed {SEEDS[0]}): bit for bit on both routes, logz "
          f"{fused['logz']!r}; the run loop one replay and one read a run; a handshake a "
          f"sweep on both routes ({fused['handshakes']}); eagerly "
          f"{eager['launches']['host_call']} host-call launches; {json.dumps(shown)}; "
          f"graph {json.dumps(fused['graphs'])}", flush=True)
    object_blobs_on_loop(device)
    raising_on_loop(device)
    return {"A_host": eager["launches"], "A_host_fused": fused["launches"], "host_runs": shown}


def ll_object(x):
    # tests/test_blobs.py:141-146: an arbitrary Python payload a point
    return -0.5 * float(np.sum(x * x)), {"tag": round(float(x[0]), 3)}


def object_blobs_on_loop(device) -> None:
    """tests/test_blobs.py:140-156's object-payload likelihood on the run
    loop: every payload follows its particle, the store is pruned."""
    s = Sampler(lambda u: 10.0 * u - 5.0, ll_object, n_dim=2, n_particles=16,
                host_likelihood=True, blobs_dtype="object", random_state=0, n_max_steps=3,
                device=device)
    s.run(n_total=32, progress=False, on_device=True)
    x, _, _, blobs = s.posterior(return_blobs=True)
    follow = all(b is not None and abs(b["tag"] - round(float(xi[0]), 3)) < 5e-3
                 for xi, b in zip(x, blobs))
    store = s.state.blob_schema.store
    live = set(s.state.hist.blobs.reshape(-1).tolist()) | set(s.state.cur.blobs.reshape(-1).tolist())
    pruned = all((p is not None) == (i in live) for i, p in enumerate(store))
    stats = loop_stats(s)
    check(len(blobs) > 0 and follow and pruned and stats["run"].get("replays") == 1
          and len(store) == 16 * int(s.state.cur.calls),
          f"object blobs on the run loop: follow {follow}, pruned {pruned}, store {len(store)} "
          f"for {int(s.state.cur.calls)} sweeps, loops {stats}")
    print(f"object blobs on the run loop: {len(blobs)} payloads follow their particles, "
          f"{sum(p is None for p in store)} of {len(store)} store entries pruned", flush=True)


class Boom(RuntimeError):
    """The exception of `Flaky`."""


class Flaky:
    """The 10-D Gaussian host likelihood, raising `Boom` at its `fail_at`-th
    call and after, until `fail_at` is None."""

    def __init__(self, fail_at):
        self.fail_at, self.calls = fail_at, 0

    def __call__(self, x):
        self.calls += 1
        if self.fail_at is not None and self.calls >= self.fail_at:
            raise Boom(f"likelihood call {self.calls}")
        return gaussian_numpy(x)


def raising_on_loop(device) -> None:
    """A likelihood that raises in a later iteration of a run on the run
    loop: its own exception, no call after it and no handshake after the
    one that failed (the loops end within that step), the process alive;
    then the same sampler, reset, repeats a clean sampler's run bit for
    bit."""
    def make(fn):
        return Sampler(prior_transform, fn, n_dim=N_DIM, n_particles=512, host_likelihood=True,
                       clustering=False, random_state=0, history_capacity=64, device=device)

    clean = make(gaussian_numpy)
    clean.run(n_total=2048, progress=False, on_device=True)
    sweeps = int(clean.state.cur.calls)
    fail_at = 512 * (sweeps // 2) + 7
    flaky = Flaky(fail_at)
    s = make(flaky)
    reset_counts()
    raised = None
    t0 = time.perf_counter()
    try:
        s.run(n_total=2048, progress=False, on_device=True)
    except Boom as exc:
        raised = exc
    seconds = time.perf_counter() - t0
    handshakes = counts()["host_call"]
    check(raised is not None and flaky.calls == flaky.fail_at
          and handshakes == -(-flaky.fail_at // 512),
          f"a raising likelihood: {raised!r}, {flaky.calls} calls for a failure at "
          f"{flaky.fail_at}, {handshakes} handshakes")
    flaky.fail_at = None
    s.reset(random_state=0)
    s.run(n_total=2048, progress=False, on_device=True)
    for key in ("beta", "logz", "steps", "calls"):
        check(s.results()[key].tobytes() == clean.results()[key].tobytes(),
              f"a raising likelihood: {key} of the run after reset() differs from a clean run")
    print(f"a raising likelihood on the run loop: {raised!r} raised after {seconds:.3f} s at "
          f"call {fail_at}, {handshakes} handshakes (the failing one last); "
          f"after reset() the run equals a clean run bit for bit ({sweeps} sweeps)", flush=True)


# ---------------------------------------------------------------------------
# Phase 14: float64 and the mixture facades
# ---------------------------------------------------------------------------
def gaussian4(x):
    return -0.5 * torch.sum(x * x, dim=-1) - 0.5 * 4 * math.log(2 * math.pi)


def float64_on_loop(name: str, make, n_total: int, seed: int = SEEDS[0],
                    capture_seed: int = SEEDS[1], adjust=None) -> dict:
    """A float64 configuration on the device run loop: a fresh sampler
    (`make(seed)`) with run(on_device=False), then run(on_device=True) on a
    sampler whose `capture_seed` run captured the run loop's graph (its
    nodes and depth printed), reset to `seed`. Held: beta 1, the ladder,
    logZ, ESS, CV, steps and calls bit for bit, the launches equal to the
    eager run's less its chunks' steps past the stop (and `adjust(eager
    launches, eager loops, graphed loops)` where given), the final draw
    state equal (the keyed words, the generator unmoved); on the run loop
    one replay and one read, no other read and no capture, a WHILE body
    run an iteration after the first and a MCMC WHILE body run a step, no
    MCMC read; only the float64 PRNG kernels, the ESS kernel's float64
    entry if any. Returns both runs' walls, launches and loops, and the
    graphed sampler."""
    runs = {}
    for on_device in (False, True):
        s = make(capture_seed if on_device else seed)
        check(run_loop(s) and keyed_route(s) and s.state.hist.u.dtype == torch.float64,
              f"{name}: not keyed float64 on the run route")
        fits = MODE_FITS
        graphs = None
        if on_device:
            s.run(n_total=n_total, progress=False, on_device=True)  # captures the graph
            graphs = [dict(nodes=g.nodes, depth=g.depth, capture_s=g.capture_s)
                      for g in s.state._iteration.loops.graphs_of("run")]
            check(len(graphs) == 1 and graphs[0]["depth"] >= 2, f"{name}: graphs {graphs}")
            s.reset(random_state=seed)
        warm, bodies = loop_stats(s), mcmc_bodies(s)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run(n_total=n_total, progress=False, on_device=on_device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        loops = {k: {c: v.get(c, 0) - warm.get(k, {}).get(c, 0) for c in v}
                 for k, v in loop_stats(s).items()}
        runs[on_device] = dict(sampler=s, results=s.results(), logz=s.evidence()[0], wall=wall,
                               launches=launched, loops=loops, iters=int(s.state.hist.t),
                               bodies=mcmc_bodies(s) - bodies, draws=s.state.draws.get_state(),
                               graphs=graphs, mode_fits=MODE_FITS - fits)
    eager, fused = runs[False], runs[True]
    for key in ("beta", "logz", "ess", "cv", "steps", "calls"):
        check(fused["results"][key].tobytes() == eager["results"][key].tobytes(),
              f"{name}: {key} with on_device=True differs from on_device=False")
    real = less_past_stop(eager["sampler"], eager["launches"], name)
    if adjust is not None:
        real = adjust(real, eager["loops"], fused["loops"])
    check(fused["logz"] == eager["logz"] and fused["launches"] == real
          and fused["sampler"].beta == 1.0,
          f"{name}: logZ {fused['logz']!r} / {eager['logz']!r}, launches {fused['launches']} / "
          f"{real} (less the eager chunks' steps past the stop)")
    check(set(fused["draws"]) == set(eager["draws"]) >= {"step_key", "step_counter"}
          and all(fused["draws"][k].tobytes() == eager["draws"][k].tobytes()
                  for k in eager["draws"]),
          f"{name}: the final draw state differs")
    loops, iters = fused["loops"], fused["iters"]
    res = fused["results"]
    steps = int(res["steps"][res["beta"] > 0].sum())
    check(loops["run"].get("replays") == 1 and loops["run"].get("reads") == 1
          and not any(v.get("reads", 0) for k, v in loops.items() if k != "run")
          and all(v.get("captures", 0) == 0 for v in loops.values())
          and loops["run"].get("node_bodies") == iters - 1
          and loops["mcmc"].get("node_bodies") == steps == fused["bodies"],
          f"{name} on the run loop: {loops} for {iters} iterations and {steps} steps")
    f32_prng = {k: fused["launches"].get(k, 0) for k in ("mutation_draws", "normal", "gamma",
                                                         "bits")}
    check(not any(f32_prng.values()) and fused["launches"]["ess_bisect"] == 0,
          f"{name}: float32 kernels launched {fused['launches']}")
    print(f"{name} seed {seed}: on_device=False {eager['wall']:.3f} s "
          f"({1e3 * eager['wall'] / eager['iters']:.1f} ms an iteration), on the run loop "
          f"{fused['wall']:.3f} s ({1e3 * fused['wall'] / iters:.1f} ms an iteration), bit for "
          f"bit; logz={fused['logz']!r} iters={iters} steps={steps}; one replay and one read, "
          f"{loops['run'].get('node_bodies')} run-loop and {loops['mcmc'].get('node_bodies')} MCMC "
          f"WHILE bodies; graph {json.dumps(fused['graphs'])}; launches {fused['launches']}",
          flush=True)
    return dict(eager=eager, fused=fused, steps=steps,
                walls={"on_device=False": eager["wall"], "on_device=True": fused["wall"]},
                ms_per_iter={"on_device=False": 1e3 * eager["wall"] / eager["iters"],
                             "on_device=True": 1e3 * fused["wall"] / iters},
                iters=iters, graphs=fused["graphs"], loops=loops)


def phase_float64_gaussian(device) -> dict:
    """tests/test_float64.py's run on the card: the 4-D Gaussian in float64
    (seed 1), eagerly and on the run loop (`float64_on_loop`): logZ within
    0.35 of -4 log 20, the MIS accumulator within 1e-9 of its exact
    rebuild, one float64 ESS launch a reweight."""
    def make(seed):
        return Sampler(prior_transform, gaussian4, n_dim=4, n_particles=256, vectorize=True,
                       clustering=False, random_state=seed, dtype=torch.float64, device=device)

    out = float64_on_loop("float64 4-D Gaussian", make, 1024, seed=1, capture_seed=2)
    s, launched = out["fused"]["sampler"], out["eager"]["launches"]
    hist = s.state.hist
    valid = hist.sample_mask()
    mis_err = float(torch.max(torch.abs(mis_denominator(hist) - mis_denominator_exact(hist))[valid]))
    logz = s.evidence()[0]
    print(f"float64 4-D Gaussian: logz={logz:.6f} (analytic {GAUSSIAN4_LOGZ[0]:.6f}) "
          f"beta={s.beta:.6f} iters={int(hist.t)} MIS accumulator max error {mis_err:.3g} "
          f"dtype={hist.logl.dtype} launches={launched}", flush=True)
    check(hist.logl.dtype == torch.float64 and s.beta > 0.99, "float64 Gaussian: dtype or beta")
    check(abs(logz - GAUSSIAN4_LOGZ[0]) < GAUSSIAN4_LOGZ[1], f"float64 Gaussian: logZ {logz}")
    check(mis_err < MIS_F64_TOL, f"float64 Gaussian: MIS accumulator error {mis_err}")
    check(launched["ess_bisect_f64"] == int(hist.t) - 1 and launched["ess_bisect"] == 0,
          f"float64 Gaussian: launches {launched} for {int(hist.t) - 1} reweights")
    return out


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
    """14: A in float64 eagerly and on the run loop with each hardware_prng,
    each held against the eager run (`float64_on_loop`): logZ in the
    clustered band, one float64 ESS launch
    a reweight, one mutation_draws_f64 launch a step body and the keyed
    warm-up and resampling uniforms (uniform_f64); the two flags the same
    bits (the flag does not apply to float64, as in JAX); B, the 4-D
    Gaussian, the facades. `fused_wall` is phase 6b's float32 seed 42 on
    the run loop."""
    f64 = torch.float64
    paths, runs = {}, {}
    for hw in (False, True):
        name = f"A float64 hardware_prng={hw}"
        out = float64_on_loop(name, lambda seed, hw=hw: canonical_sampler(
            device, seed, True, hw, f64), N_TOTAL)
        eager, fused = out["eager"], out["fused"]
        iters, launched = fused["iters"], eager["launches"]
        bodies, past = eager["bodies"], eager["loops"].get("mcmc", {}).get("past_stop", 0)
        uniforms = iteration_uniforms(eager["sampler"])
        check(abs(fused["logz"] - CLUSTERED_LOGZ[0]) <= CLUSTERED_LOGZ[1],
              f"{name}: logZ {fused['logz']} outside {CLUSTERED_LOGZ}")
        check(launched["ess_bisect_f64"] == iters - 1
              and launched["mutation_draws_f64"] == bodies == out["steps"] + past
              and fused["launches"]["mutation_draws_f64"] == out["steps"]
              and launched["uniform_f64"] == uniforms
              and launched["normal_f64"] == launched["gamma_f64"] == 0,
              f"{name}: launches {launched} for {iters} iterations, {bodies} MCMC bodies "
              f"({out['steps']} steps, {past} past the stop), {uniforms} keyed uniforms")
        check_fit_replays(f"{name} on_device=True", fused["loops"])
        check_em_launches(name, launched, eager["mode_fits"], None, eager["loops"])
        check(cuda_median is None or launched["weighted_median"] == eager["mode_fits"] > 0,
              f"{name}: {launched.get('weighted_median')} weighted-median launches for "
              f"{eager['mode_fits']} mode fits")
        paths["A_float64_hardware_prng" if hw else "A_float64"] = launched
        runs[hw] = out
    # the flag does not apply to float64: each run of hardware_prng=True
    # (eager and on the run loop) draws and launches what the flag off's does
    for run in ("eager", "fused"):
        on, off = runs[True][run], runs[False][run]
        for key in ("beta", "logz", "ess", "cv", "steps", "calls"):
            check(on["results"][key].tobytes() == off["results"][key].tobytes(),
                  f"A float64 {run}: {key} with hardware_prng=True differs from False")
        check(set(on["draws"]) == set(off["draws"])
              and all(on["draws"][k].tobytes() == off["draws"][k].tobytes() for k in off["draws"]),
              f"A float64 {run}: the draw states of the two flags differ")
        check(on["launches"] == off["launches"],
              f"A float64 {run}: launches {on['launches']} with hardware_prng=True, "
              f"{off['launches']} without")
    a = runs[False]
    print(f"A float64 seed {SEEDS[0]}: both flags the same bits; the run loop "
          f"{a['walls']['on_device=True']:.3f} s ({a['ms_per_iter']['on_device=True']:.1f} ms an "
          f"iteration; on_device=False {a['walls']['on_device=False']:.3f} s) against float32 "
          f"{fused_wall:.3f} s (phase 6b, the run loop) and {walls32[SEEDS[0]]:.3f} s (phase 6, "
          f"on_device=False) in this run", flush=True)
    paths["B_float64"], errs, b_rows = phase_large_ensemble(device, f64)
    gauss = phase_float64_gaussian(device)
    paths["gaussian4_float64"] = gauss["eager"]["launches"]
    paths["facades"] = phase_facades(device)
    summary = {"A": {hw: {k: runs[hw][k] for k in ("walls", "ms_per_iter", "iters", "graphs",
                                                   "steps")} for hw in (False, True)},
               "gaussian4": {k: gauss[k] for k in ("walls", "ms_per_iter", "iters", "graphs")},
               "B_mutation_s": [[r["wall"], g["wall"]] for r, g in zip(b_rows["eager"],
                                                                       b_rows["graphed"])
                                if r["beta"] > 0.0]}
    print(f"float64: {json.dumps(summary)}", flush=True)
    return paths, errs, summary


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
    """One timed run of mesh sampler `s`: its results, wall, launches (and
    those less the chunks' steps past the stop), MCMC bodies (and those
    past the stop) and draw state; logZ in the clustered band, no
    ESS-kernel launch (a mesh bisects by reductions, as JAX bypasses its
    kernel under one) and one eigenvalue launch a reweight."""
    warm, bodies = loop_stats(s), mcmc_bodies(s)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(n_total=N_TOTAL, progress=False, **run_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    iters = int(s.state.hist.t)
    check_run(name, s, CLUSTERED_LOGZ, launched)
    check(launched["ess_bisect"] == 0 and launched["ess_bisect_f64"] == 0
          and launched["sym_eigvals"] == iters - 1,
          f"{name}: launches {launched}; a mesh runs no ESS kernel, and one CV a reweight")
    timed = {k: {c: v.get(c, 0) - warm.get(k, {}).get(c, 0) for c in v}
             for k, v in loop_stats(s).items()}
    bodies = mcmc_bodies(s) - bodies
    past = timed.get("mcmc", {}).get("past_stop", 0)
    return dict(results=s.results(), logz=s.evidence()[0], wall=wall, launches=launched,
                real_launches=without_past_stop(launched, past, bodies, name,
                                                iteration_uniforms(s)),
                bodies=bodies, past_stop=past, iters=iters, loops=timed,
                draws=s.state.draws.get_state())


def check_mesh_pair(name: str, eager: dict, fused: dict) -> None:
    """on_device=True against on_device=False, bit for bit (the eager run's
    launches and bodies less its chunks' steps past the stop)."""
    for key in ("beta", "logz", "steps", "calls"):
        check(fused["results"][key].tobytes() == eager["results"][key].tobytes(),
              f"{name}: {key} with on_device=True differs from on_device=False")
    check(fused["logz"] == eager["logz"] and fused["launches"] == eager["real_launches"]
          and fused["bodies"] == eager["bodies"] - eager["past_stop"],
          f"{name}: logZ {fused['logz']!r} / {eager['logz']!r}, launches {fused['launches']} / "
          f"{eager['real_launches']}, bodies {fused['bodies']} / {eager['bodies']} "
          f"({eager['past_stop']} past the stop)")
    check(all(fused["draws"][k].tobytes() == eager["draws"][k].tobytes() for k in eager["draws"]),
          f"{name}: the final draw state differs")
    # the device run loop: a replay and a read (t) a dispatch, no other
    # read; the sharded ESS bisection and the MCMC chain WHILE nodes in it,
    # their collectives inside
    loops = fused["loops"]
    check(loops["run"].get("replays", 0) >= 1
          and loops["run"].get("reads") == loops["run"]["replays"]
          and not any(v.get("reads", 0) for k, v in loops.items() if k != "run")
          and loops["run"].get("node_bodies") == fused["iters"] - 1
          and loops["ess_sharded"].get("node_bodies", 0) > 0
          and loops["mcmc"].get("node_bodies", 0) > 0,
          f"{name}: the run loop {loops}")
    # float32, either flag: the keyed steps, one mutation-draws launch a step
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
        check(fused_iteration(s), "A mesh: not on the fused route")
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
    print(f"A mesh posterior: {len(x)} samples of {int(s.state.hist.t) * N_PARTICLES}, weights "
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
    check(all(v.get("captures", 0) == 0 for v in fused["loops"].values())
          and fused["loops"]["run"].get("replays") == 1,
          f"A mesh on_device=True recaptured: {fused['loops']}")
    run_graphs = [dict(nodes=gr.nodes, depth=gr.depth, capture_s=gr.capture_s)
                  for gr in g.state._iteration.loops.graphs_of("run")]
    print(f"A mesh: the run loop's graph (top-level nodes, nodes in the conditional bodies; "
          f"nesting depth; seconds of capture and instantiation): {json.dumps(run_graphs)}",
          flush=True)
    check(len(run_graphs) == 1 and run_graphs[0]["depth"] >= 3,
          f"A mesh: the run loop's graphs {run_graphs}")
    check_mesh_pair("A mesh", eager, fused)
    windows = steady_windows(g, "A mesh", n=3, device_only=False)
    windows["run loop"] = run_window(g, "A mesh")

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
    check_mesh_pair("A mesh hardware_prng", hw[False], hw[True])
    print(f"A mesh hardware_prng: call counter {int(hw[True]['draws']['philox_counter'])} "
          f"after {hw[True]['bodies']} MCMC bodies", flush=True)
    f64 = float64_on_loop("A mesh float64", lambda seed: mesh_sampler(
        device, mesh, seed, dtype=torch.float64), N_TOTAL)
    launched = f64["eager"]["launches"]
    check(abs(f64["fused"]["logz"] - CLUSTERED_LOGZ[0]) <= CLUSTERED_LOGZ[1]
          and launched["ess_bisect_f64"] == 0 and launched["sym_eigvals"] == f64["iters"] - 1
          and f64["loops"]["ess_sharded"].get("node_bodies", 0) > 0,
          f"A mesh float64: logZ {f64['fused']['logz']}, launches {launched}, loops "
          f"{f64['loops']}")
    return {"launches": eager["launches"], "launches_hardware_prng": hw[False]["launches"],
            "walls": {"on_device=False": eager["wall"], "on_device=True": fused["wall"],
                      "hardware_prng on_device=False": hw[False]["wall"],
                      "hardware_prng on_device=True": hw[True]["wall"]},
            "iters": eager["iters"], "loops": fused["loops"], "run_graphs": run_graphs,
            "windows": windows, "float64": {k: f64[k] for k in ("walls", "ms_per_iter", "iters",
                                                                "graphs", "steps")}}


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
    run(on_device=True), the device run loop, on a sampler whose seed-43 run
    captured its graph:
    beta 1, posterior ESS >= n_total, logZ in the anchor taken from the
    JAX package, one eigenvalue launch (d = 100) and one ESS launch
    (S = 524,288, the streamed route) a reweight; its first R100_EAGER
    iterations equal bit for bit to a fresh seed-42 sampler's sample()
    calls (on_device=False); then iterations 21-23 on the per-iteration
    graphed route under the profiler, held to 6b's rule, and the device ms
    an iteration of the eigenvalue kernel, the ESS kernel and the top other
    kernels."""
    since = len(FORMS)
    s = rosenbrock100_sampler(device, SEEDS[1])
    check(fused_iteration(s) and run_loop(s), "rosenbrock100: not on the device run loop")
    sizes, plan = [], cuda_reweight.plan_launch

    def recording_plan(n, dtype=torch.float32):  # the S of every ESS launch planned
        sizes.append(n)
        return plan(n, dtype)

    cuda_reweight.plan_launch = recording_plan
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run(n_total=R100_TOTAL, progress=False, on_device=True)  # captures the graph
        torch.cuda.synchronize()
        capture_wall = time.perf_counter() - t0
        warm = loop_stats(s)
        s.reset(random_state=SEEDS[0])
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run(n_total=R100_TOTAL, progress=False, on_device=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        cuda_reweight.plan_launch = plan
    launched = counts()
    res, logz, iters = s.results(), s.evidence()[0], int(s.state.hist.t)
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
          f"{sorted(set(sizes))} (planned at the run loop's capture): each must take the "
          f"streamed route at S = {streamed}")
    # R N d = 1,638,400 > 2^19: each step draws by the gamma, normal and
    # uniform kernels (the keyed route), a launch each, no step past the stop
    check(all(launched[k] == 0 for k in ("ess_bisect_f64", "mutation_draws"))
          and launched["gamma"] == launched["normal"] == launched["bits"] - iteration_uniforms(s)
          == steps,
          f"{name}: launches {launched} for {steps} MCMC steps")
    check(all(v.get("captures", 0) == 0 for v in timed.values())
          and timed["run"].get("replays", 0) == 1 and timed["run"].get("reads", 0) == 1,
          f"{name}: captures and replays {timed}")

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
    # N d^2 = 20.5 M > 2^21: the K-loop form (K = 1), captured into the run
    # loop and in sample()
    check_forms("rosenbrock100", since, K_LOOP)
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
          f"iteration {json.dumps({k: round(v, 3) for k, v in w['stages_ms'].items()})}; "
          f"{window_reads(w)}", flush=True)
    return {"launches": launched, "wall": wall, "capture_wall": capture_wall, "iters": iters,
            "logz": logz, "ess": ess, "steps_per_iter": steps / iters, "eager_wall": eager_wall,
            "window": {k: w[k] for k in ("wall_per_iter", "device_ms_per_iter", "idle",
                                         "blocking_per_iter", "chunk_reads_per_iter",
                                         "mcmc_reads_per_iter", "while_iterations_per_iter",
                                         "mcmc_route")},
            "sym_eigvals_ms": eig_ms, "ess_bisect_ms": ess_ms, "ess_launch_sizes": sorted(set(sizes)),
            "top_kernels": top}


# ---------------------------------------------------------------------------
# Phase 17: the mutation's two forms, and benchmarks/large_scale.py's path
# ---------------------------------------------------------------------------
# The mutation's products (mcmc.py) as cuBLAS GEMMs and batched products,
# not kernels of the port: their bound counts, per mode, the quadratic's
# diff (N, d) read and (N,) written with 2 N d^2 + 2 N d flops, and the
# proposal step's z (R, N, d) read and written with 2 R N d^2 flops; bytes
# at HBM_BYTES_PER_S, flops at the float32 FMA rate (float64: FP64's).
FP32_FLOPS_PER_S = 2 * ISSUE_PER_SM_CLOCK * SM_CLOCKS_PER_S  # 66.9 TFLOP/s
FP64_FLOPS_PER_S = 2 * FP64_PER_SM_CLOCK * SM_CLOCKS_PER_S  # 33.5 TFLOP/s
FORMS_SHAPE = (N_PROPOSAL_CANDIDATES, B_PARTICLES, N_DIM)  # B's (R, N, d)
FORMS_MODES = (1, 16)  # B's one mode; 16, the last one empty, to exercise the masks
# A product's two forms sum in other orders: each within 2 d eps of the
# exact value times the same product of absolute values (the forward error
# of a dot product of d terms), so within 4 d eps of each other.
FORMS_TOL = 4


def product_bound(K: int, R: int, N: int, d: int, dtype) -> dict:
    """(ms, by) of the quadratic and the proposal step over K modes."""
    elem = torch.finfo(dtype).bits // 8
    rate = FP64_FLOPS_PER_S if dtype == torch.float64 else FP32_FLOPS_PER_S
    out = {}
    for name, n_bytes, flops in (
            ("quadratic", K * elem * (N * d + N), K * (2 * N * d * d + 2 * N * d)),
            ("mode_step", K * elem * 2 * R * N * d, K * 2 * R * N * d * d)):
        b, f = 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * flops / rate
        out[name] = (max(b, f), "bytes" if b >= f else "operations")
    return out


def forms_walkers(device, K: int, N: int, d: int, dtype, seed: int = 0,
                  forms=(GATHERED, K_LOOP)) -> dict:
    """The same N walkers over K modes (the last one empty where K > 1) in
    `forms` of `mcmc.Walkers` ("gathered", "k_loop"); the modes' Cholesky
    factors and inverses from modes.make_mode_statistics in float64, then
    cast."""
    g = torch.Generator(device=device).manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=device)
    a = torch.randn(K, d, d, generator=g, **f64)
    cov = a @ a.transpose(1, 2) / d + 0.1 * torch.eye(d, **f64)
    m = modes_module.make_mode_statistics(torch.zeros(K, d, **f64), cov,
                                          torch.full((K,), 5.0, **f64))
    chol, inv = m.chol_covariances.to(dtype), m.inv_covariances.to(dtype)
    assignments = torch.randint(0, max(K - 1, 1), (N,), generator=g, device=device,
                                dtype=torch.int32)
    zero = torch.zeros((), dtype=dtype, device=device)
    fixed = dict(assignments=assignments, beta=zero, mu=zero, dof=zero, onehot=zero,
                 count_k=zero)
    make = {GATHERED: lambda: dict(chol=chol[assignments], inv=inv[assignments]),
            K_LOOP: lambda: dict(chol_covariances=chol, inv_covariances=inv)}
    return {f: mcmc_module.Walkers(**make[f](), **fixed) for f in forms}


def forms_apart(w: dict, diff, z) -> dict:
    """Each product's largest gap between the forms, over d eps times the
    product of absolute values (`FORMS_TOL` at most)."""
    k = w[K_LOOP]
    d, eps = diff.shape[1], torch.finfo(diff.dtype).eps
    scale_q = mcmc_module._mode_quadratic(diff.abs(), k.assignments, k.inv_covariances.abs())
    scale_z = mcmc_module._mode_matmul(z.abs(), k.assignments, k.chol_covariances.abs())
    out = {}
    for name, got, want, scale in (
            ("quadratic", k.quadratic(diff), w[GATHERED].quadratic(diff), scale_q),
            ("mode_step", k.mode_step(z), w[GATHERED].mode_step(z), scale_z)):
        gap = (got.double() - want.double()).abs() / (d * eps * scale.double())
        out[name] = float(gap.max())
    return out


def phase_forms(device) -> dict:
    """The K-loop form's products against the gathered form's at B's
    (R, N, d) with K = 1 and 16 modes, float32 and float64: each within
    FORMS_TOL d eps of the product of absolute values; then their device
    times by CUDA events in turns (gathered, K-loop, K-loop, gathered) at
    K = 1 in float32, beside the K-loop's bound; and the K-loop's at the
    2^20 path's (1, 2^20, 100), where the gathered sets would take 84 GB."""
    R, N, d = FORMS_SHAPE
    out = {"agree": {}, "times": {}}
    for dtype in (torch.float32, torch.float64):
        for K in FORMS_MODES:
            w = forms_walkers(device, K, N, d, dtype, seed=K)
            g = torch.Generator(device=device).manual_seed(100 + K)
            diff = torch.randn(N, d, generator=g, device=device, dtype=dtype)
            z = torch.randn(R, N, d, generator=g, device=device, dtype=dtype)
            gaps = forms_apart(w, diff, z)
            out["agree"][f"K={K} {dtype}"] = gaps
            check(all(v <= FORMS_TOL for v in gaps.values()),
                  f"the mutation's forms at (R, N, d) = {FORMS_SHAPE}, K = {K}, {dtype}: "
                  f"apart by {gaps} d eps of the absolute products (at most {FORMS_TOL})")
    print(f"mutation forms at B's (R, N, d) = {FORMS_SHAPE}: the K-loop form's products "
          f"against the gathered form's, largest gap over d eps x the product of absolute "
          f"values (at most {FORMS_TOL}): {json.dumps(out['agree'])}", flush=True)
    for label, (R, N, d), forms in (("B", FORMS_SHAPE, (GATHERED, K_LOOP)),
                                    ("large_scale", (1, LS_PARTICLES, LS_DIM), (K_LOOP,))):
        w = forms_walkers(device, 1, N, d, torch.float32, forms=forms)
        g = torch.Generator(device=device).manual_seed(7)
        diff = torch.randn(N, d, generator=g, device=device)
        z = torch.randn(R, N, d, generator=g, device=device)
        turns = {f: {"quadratic": [], "mode_step": []} for f in forms}
        for f in forms + tuple(reversed(forms)):
            turns[f]["quadratic"].append(event_ms(lambda: w[f].quadratic(diff)))
            turns[f]["mode_step"].append(event_ms(lambda: w[f].mode_step(z)))
        bound = product_bound(1, R, N, d, torch.float32)
        out["times"][label] = {"R_N_d": [R, N, d], "device_ms": turns, "bound_ms": bound}
        print(f"mutation products at (R, N, d) = {(R, N, d)}, K = 1, float32, device ms by CUDA "
              f"events in turns: {json.dumps(turns)}; the K-loop form's bound {bound}",
              flush=True)
        del w, diff, z
    out["step_ms"] = step_times(device)
    print(f"one tpCN step's device ms (a CUDA graph of MCMCKernel.step replayed, CUDA events): "
          f"{json.dumps(out['step_ms'])}", flush=True)
    return out


def mcmc_step_ms(device, loglike, u, n_candidates: int = N_PROPOSAL_CANDIDATES,
                 calls: int = 20) -> float:
    """Device ms of one tpCN step (`MCMCKernel.step` on fixed draws) of
    walkers `u` under one mode fitted to them, by CUDA events around
    replays of a CUDA graph of the step: no host gap between its kernels."""
    n, d = u.shape
    kernel = mcmc_module.MCMCKernel(lambda x, *_: (loglike(x), None), prior_transform, d,
                                    n_candidates=n_candidates, dtype=u.dtype)
    cov = torch.cov(u.T.double()) + 1e-6 * torch.eye(d, device=device, dtype=torch.float64)
    modes = modes_module.make_mode_statistics(
        u.double().mean(0)[None].to(u.dtype), cov[None].to(u.dtype),
        torch.full((1,), 5.0, dtype=u.dtype, device=device))
    w = kernel.prepare(torch.zeros(n, dtype=torch.int32, device=device), 0.5, modes)
    x = prior_transform(u)
    state = kernel.initial_state(u, x, loglike(x), 1)
    g = torch.Generator(device=device).manual_seed(3)
    z = torch.randn(n_candidates, n, d, generator=g, device=device, dtype=u.dtype)
    gam = torch.ones(n, device=device, dtype=u.dtype)
    acc = torch.rand(n, generator=g, device=device, dtype=u.dtype)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):  # the libraries' workspaces, before the capture
        kernel.step(w, state, z, gam, acc)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = _captured(device, lambda: kernel.step(w, state, z, gam, acc))
    return event_ms(graph.replay, calls)


def step_times(device, labels=("B", "rosenbrock100", "large_scale")) -> dict:
    """`mcmc_step_ms` at B's, rosenbrock100's and the 2^20 path's walkers
    and candidates (each likelihood its own; walkers near the middle of the
    unit cube, made from a seed), for those in `labels`."""
    out = {}
    for label, loglike, n, d, r in (("B", half_square, B_PARTICLES, N_DIM, N_PROPOSAL_CANDIDATES),
                                    ("rosenbrock100", rosenbrock_chained, R100_PARTICLES, R100_DIM,
                                     N_PROPOSAL_CANDIDATES),
                                    ("large_scale", rosenbrock_chained, LS_PARTICLES, LS_DIM, 1)):
        if label not in labels:
            continue
        g = torch.Generator(device=device).manual_seed(n)
        u = 0.5 + 0.01 * torch.randn(n, d, generator=g, device=device)
        out[label] = mcmc_step_ms(device, loglike, u, n_candidates=r)
        del u
    return out


LS_ITERS = 5  # sample() calls, warm-ups included (large_scale.py --iters 5)
LS_WARMUP = 3  # beta may stay 0 this many calls (benchmarks/large_scale.py:141-148)
LS_SHOWN = ("rows", "wall", "peak_gb", "errs", "device_ms", "bounds")
# One gathered (N, d, d) float32 set at this path's N and d: 41.9 GB.
LS_GATHERED_SET_BYTES = 4 * LS_PARTICLES * LS_DIM * LS_DIM


def large_scale_sampler(device):
    """benchmarks/large_scale.py's configuration on one card, unsharded:
    the chained 100-D Rosenbrock, U(-10, 10), N = 2^20, unclustered,
    random_state=5, history_capacity=8, one proposal candidate, and
    n_max_steps=20, the setting its help gives for hardware (:66-70)."""
    return Sampler(prior_transform, rosenbrock_chained, n_dim=LS_DIM, n_particles=LS_PARTICLES,
                   vectorize=True, clustering=False, random_state=5,
                   history_capacity=LS_CAPACITY, n_candidates=1, n_max_steps=LS_MAX_STEPS,
                   device=device)


def check_tf32_off(what: str) -> None:
    """The mutation's products run in true float32: TF32 is off."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          f"{what}: TF32 is on (allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"precision {torch.get_float32_matmul_precision()!r})")


def phase_large_scale(device) -> dict:
    """17b: benchmarks/large_scale.py's configuration (`large_scale_sampler`)
    on one card: LS_ITERS sample() calls, each held as the script holds
    them (logZ and the active set's logl finite, beta > 0 from call
    LS_WARMUP + 1 on) and the beta ladder monotone; every mutation in the
    K-loop form and the path's own peak memory under one gathered set; one
    gamma, normal and uniform launch a step body, one ESS launch a
    reweight. Then one more sample() call that keeps copies of its mode
    fit's inputs (after the peak and the launches are read), and the ESS
    kernel at the S reached, the normal kernel at this path's R N d, the
    uniform mode of the bits kernel at its warm-up's (N, d), and the
    weighted-median and Student-t EM kernels on that fit's own inputs, each
    against its plain version, timed beside its bound where the bound is
    counted. Prints each call's beta, logZ, steps, acceptance and wall, the
    peak memory beside the gathered form's 83.9 GB, the graphs captured,
    and the launches."""
    check_tf32_off("phase 17b")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    since = len(FORMS)
    t_phase = time.perf_counter()
    s = large_scale_sampler(device)
    loops = s.state._iteration.loops
    reset_counts()
    rows = []
    for it in range(LS_ITERS):
        before, bodies, fits = counts(), mcmc_bodies(s), MODE_FITS
        past = loops.stats["mcmc"]["past_stop"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = s.sample()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched, bodies = diff(counts(), before), mcmc_bodies(s) - bodies
        logl_finite = bool(torch.isfinite(s.state.cur.logl).all())
        row = dict(call=it + 1, iter=int(out["iter"]), wall=wall, beta=out["beta"],
                   logz=out["logz"], ess=out["ess"], steps=int(out["steps"]), bodies=bodies,
                   past=loops.stats["mcmc"]["past_stop"] - past,
                   acceptance=out["acceptance"], fits=MODE_FITS - fits, launches=launched,
                   memory_gb=torch.cuda.max_memory_allocated(device) / 1e9)
        rows.append(row)
        print(f"large_scale call {it + 1}: {wall:.3f} s beta={out['beta']:.6g} "
              f"logz={out['logz']:.4f} ess={out['ess']:.1f} steps={out['steps']} "
              f"bodies={bodies} (past the stop {row['past']}) "
              f"acceptance={out['acceptance']:.4f} mode_fits={row['fits']} peak so far "
              f"{row['memory_gb']:.2f} GB launches={launched}", flush=True)
        check(math.isfinite(out["logz"]), f"large_scale call {it + 1}: logZ {out['logz']}")
        check(logl_finite, f"large_scale call {it + 1}: non-finite logl in the active set")
        check(it < LS_WARMUP or out["beta"] > 0.0,
              f"large_scale call {it + 1}: beta {out['beta']}: the ladder is not progressing")
    torch.cuda.synchronize()
    phase_wall = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated(device)
    betas = [r["beta"] for r in rows]
    check(betas == sorted(betas), f"large_scale: the beta ladder is not monotone: {betas}")
    check(any(b > 0.0 for b in betas), f"large_scale: no iteration past the warm-up: {betas}")
    check_forms("large_scale", since, K_LOOP)
    check(peak < LS_GATHERED_SET_BYTES,
          f"large_scale: peak {peak / 1e9:.2f} GB, one gathered set's "
          f"{LS_GATHERED_SET_BYTES / 1e9:.1f} GB or more")
    total = counts()
    mutations = [r for r in rows if r["beta"] > 0.0]
    bodies = sum(r["bodies"] for r in mutations)
    uniforms = iteration_uniforms(s, betas)
    check(total["normal"] == total["gamma"] == bodies > 0
          and total["bits"] == bodies + uniforms and total["mutation_draws"] == 0,
          f"large_scale: launches {total} for {bodies} MCMC step bodies (want one normal, gamma "
          f"and uniform launch a body and {uniforms} uniform launches for the iterations' draws)")
    reweights = sum(1 for r in rows if r["iter"] > 1)
    check(total["ess_bisect"] == reweights and total["mvstud_em"] == total["weighted_median"]
          == sum(r["fits"] for r in rows) > 0,
          f"large_scale: launches {total} for {reweights} reweights and "
          f"{sum(r['fits'] for r in rows)} mode fits")
    captures = sum(v.get("captures", 0) for v in loops.stats.values())
    print(f"large_scale: {LS_ITERS} sample() calls in {phase_wall:.3f} s (the sampler's "
          f"construction included); walls {[round(r['wall'], 3) for r in rows]} s; peak memory "
          f"of the path {peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} GB above the phase's "
          f"start; the gathered form's two (N, d, d) float32 sets alone would take "
          f"{2 * LS_GATHERED_SET_BYTES / 1e9:.1f} GB); graph captures {captures} (sample() "
          f"runs its loops eagerly); forms {sorted(set(f for *_, f in FORMS[since:]))}; "
          f"launches {total}", flush=True)

    # One more call, after the peak is read: it keeps copies of its mode
    # fit's inputs for the kernels' checks below.
    mode_em, median = student_module._mode_em, student_module._weighted_median_presorted
    fit = {}

    def kept_mode_em(carry, consts, loops):
        fit["em"] = ({k: v.clone() for k, v in carry.items()},
                     {k: v.clone() if torch.is_tensor(v) else v for k, v in consts.items()})
        return mode_em(carry, consts, loops)

    def kept_median(d_sorted, order, wbar):
        fit["median"] = (d_sorted.clone(), order.clone(), wbar.clone())
        return median(d_sorted, order, wbar)

    student_module._mode_em, student_module._weighted_median_presorted = (kept_mode_em,
                                                                         kept_median)
    try:
        out = s.sample()
    finally:
        student_module._mode_em, student_module._weighted_median_presorted = mode_em, median
    check(set(fit) == {"em", "median"} and math.isfinite(out["logz"]),
          f"large_scale: the call that keeps a fit's inputs fitted {sorted(fit)}, logZ "
          f"{out['logz']}")
    print(f"large_scale: call {LS_ITERS + 1} (not in the rows, the walls or the peak) kept its "
          f"mode fit's inputs: beta={out['beta']:.6g} logz={out['logz']:.4f} "
          f"steps={out['steps']}", flush=True)

    # The kernels at this path's sizes, against their plain versions.
    errs = {}
    hist = s.state.hist
    _, logl, bm = kernel_inputs(hist)
    S = logl.numel()
    beta_prev = float(s.state.cur.beta)
    scal = torch.tensor([beta_prev, 2.0 * LS_PARTICLES], device=device)
    (bk, pk), (br, pr) = [(b.item(), int(p.item())) for b, p in (
        cuda_reweight.ess_bisect_beta(logl, bm, scal),
        cuda_reweight.ess_bisect_beta_reference(logl, bm, scal))]
    print(f"large_scale: ESS kernel at S={S} [{_route(S)}]: beta_prev={beta_prev:.6g} "
          f"kernel={bk!r} ({pk} probes) plain={br!r} ({pr} probes)", flush=True)
    check_beta(f"large_scale: ESS kernel at S={S}", logl, bm, beta_prev, 2.0 * LS_PARTICLES, bk,
               pk, br, pr)
    errs["ess_bisect"] = abs(bk - br)
    times = {"ess_bisect": device_ms(lambda: cuda_reweight.ess_bisect_beta(logl, bm, scal),
                                     "ess_bisect", calls=5)}
    bounds = {"ess_bisect": bound(8 * S + 16, *work((S * pk, ESS_SAMPLE_PROBE["f32"])))}
    del logl, bm, hist
    n_z = LS_PARTICLES * LS_DIM  # one candidate; the warm-up's prior draw has as many
    key = philox.key_from_seed(2024)
    z = cuda_prng.hw_normal(key, 20, (1, LS_PARTICLES, LS_DIM), device).reshape(-1)
    errs["normal"] = float(torch.max(torch.abs(z - philox.normal(key, 20, n_z, device))))
    times["normal"] = device_ms(lambda: cuda_prng.hw_normal(key, 20, (1, LS_PARTICLES, LS_DIM),
                                                            device), "normal_", calls=5)
    bounds["normal"] = bound(4 * n_z, *work((-(-n_z // 4), NORMAL_BLOCK)))
    del z
    print(f"large_scale: normal kernel at n={n_z}: max|dz|={errs['normal']:.3g} against its "
          "plain version", flush=True)
    check(errs["normal"] <= DRAW_TOL, f"large_scale: normal kernel differs by {errs['normal']}")
    u = cuda_prng.hw_uniform(key, 21, (LS_PARTICLES, LS_DIM), device)
    uniform_equal = bool(torch.equal(u.reshape(-1), philox.uniform(key, 21, n_z, device)))
    errs["bits"] = 0.0 if uniform_equal else float("nan")
    times["bits"] = device_ms(lambda: cuda_prng.hw_uniform(key, 21, (LS_PARTICLES, LS_DIM),
                                                           device), "bits_kernel", calls=5)
    bounds["bits"] = bound(4 * n_z, *work((-(-n_z // 4), (PHILOX_INT + 4 * UNIT[0],
                                                           4 * UNIT[1]))))
    del u
    print(f"large_scale: the bits kernel's uniform mode at the warm-up's (N, d) = "
          f"{(LS_PARTICLES, LS_DIM)}: bit for bit philox.uniform {uniform_equal}", flush=True)
    check(uniform_equal, f"large_scale: the uniform mode at {(LS_PARTICLES, LS_DIM)} differs "
          "from philox.uniform")
    ds, order, wbar = fit["median"]
    got = cuda_median.weighted_median_presorted(ds, order, wbar)
    want = cuda_median.weighted_median_presorted_reference(ds, order, wbar)
    check(torch.equal(_bits(got), _bits(want)),
          f"large_scale: the weighted-median kernel at {(wbar.shape[0], *ds.shape)} is not "
          "its plain version's bits")
    errs["weighted_median"] = 0.0
    times["weighted_median"] = time_ms(
        lambda: cuda_median.weighted_median_presorted(ds, order, wbar))
    print(f"large_scale: weighted-median kernel at the fit's (K, n, d) = "
          f"{(wbar.shape[0], *ds.shape)}: bit for bit its plain version", flush=True)
    del ds, order, wbar, got, want
    carry, consts = fit["em"]
    case = em_mode_case(f"large_scale mvstud_em {tuple(consts['data'].shape)}", carry, consts)
    errs["mvstud_em"] = case["max_abs_err"]
    times["mvstud_em"] = time_ms(lambda: student_module._mode_em(carry, consts, None))
    print(f"large_scale: ms a launch at this path's sizes (ESS, normal and uniform: device ms "
          f"by the profiler; median and EM: one synchronized call): {json.dumps(times)}; bounds "
          f"{json.dumps(bounds)}", flush=True)
    print(f"large_scale: Student-t EM kernel on the fit's inputs (n, d) = "
          f"{tuple(consts['data'].shape)}: {json.dumps(case)}", flush=True)
    del carry, consts, fit, s, loops
    gc.collect()
    torch.cuda.empty_cache()
    check_tf32_off("phase 17b")
    return {"rows": rows, "wall": phase_wall, "peak_gb": peak / 1e9, "launches": total,
            "errs": errs, "captures": captures, "device_ms": times, "bounds": bounds}


def phase_17(device, stamp) -> tuple:
    """17a and 17b, then every mutation of the process against JAX's
    switch; prints both phases' results, `stamp` marking each. Returns
    (17a's, 17b's)."""
    stamp("phase 17a: the mutation's two forms")
    forms = phase_forms(device)
    print(f"mutation forms: {json.dumps(forms)}", flush=True)
    stamp("phase 17b: benchmarks/large_scale.py's configuration")
    large = phase_large_scale(device)
    print(f"large_scale: {json.dumps({k: large[k] for k in LS_SHOWN})}", flush=True)
    check_switch()
    stamp("phase 17 done")
    return forms, large


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
           "mvstud_em": "tempest_tpu_torch/csrc/mvstud_em.cu",
           "set_conditional": "tempest_tpu_torch/csrc/graph_cond.cu",
           "host_call": "tempest_tpu_torch/csrc/host_call.cu"}
KERNELS = ("ess_bisect", "ess_bisect_f64", "ess_bracket", "mutation_draws", "normal", "bits",
           "gamma", "mutation_draws_f64", "normal_f64", "uniform_f64", "gamma_f64",
           "sym_eigvals", "weighted_median", "gmm_em", "mvstud_em", "set_conditional", "host_call")
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
    "set_conditional": "XLA's lax.cond and lax.while_loop of the cluster fit's split rounds "
                       "(tempest_tpu/cluster.py:928-950), the MCMC chain and the annealing "
                       "run (tempest_tpu/fused.py:411-433): the flag of a CUDA-graph "
                       "conditional node, set on the device at each replay; its plain version "
                       "is the host's read of the predicate",
    "host_call": "JAX's host callback of host_likelihood=True (jax.pure_callback, io_callback "
                 "with object blobs; tempest_tpu/utils/wrappers.py:88-131) inside its one "
                 "device program: a CUDA graph's conditional bodies take kernel nodes, not host "
                 "nodes, so a kernel hands the points to the host through mapped pinned memory "
                 "and waits for the replaying thread's reply; its plain version is the eager "
                 "crossing, a blocking read and a copy back",
    # JAX sends every dtype but float32 to threefry (hw_prng_supported,
    # pallas_prng.py:46-48): the float64 draws replace XLA's, in double.
    "mutation_draws_f64": "XLA's threefry draws of a float64 tpCN step: jax.random.normal, "
                          "gamma and uniform (tempest_tpu/mcmc.py:194, :315, :348); the "
                          "float64 entry of the ported _mutation_draws_kernel",
    "normal_f64": "XLA's threefry jax.random.normal in float64 (tempest_tpu/mcmc.py:194)",
    "uniform_f64": "XLA's threefry jax.random.uniform in float64 (tempest_tpu/mcmc.py:348, "
                   "steps/mutate.py:38, the resampling's)",
    "gamma_f64": "XLA's threefry jax.random.gamma in float64 (tempest_tpu/mcmc.py:315), an "
                 "exact rejection loop; Marsaglia-Tsang in double, 16 rounds",
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
    "set_conditional": "tempest_tpu/cluster.py:933",
    "host_call": "tempest_tpu/utils/wrappers.py:128",
    "mutation_draws_f64": "tempest_tpu/mcmc.py:194",
    "normal_f64": "tempest_tpu/mcmc.py:194",
    "uniform_f64": "tempest_tpu/mcmc.py:348",
    "gamma_f64": "tempest_tpu/mcmc.py:315",
}
# Where each kernel's `launches` were counted.
LAUNCHES_ON = {
    "ess_bisect": "A (phase 6, seeds 42-44; phase 6b's runs of the same seeds with their loops "
                  "replayed as graphs launch it as often)",
    "ess_bisect_f64": "A in float64 (phase 14)",
    "mutation_draws": "A (phase 6, seeds 42-44, on_device=False: one an MCMC step body, the "
                      "keyed step draws of float32 on the card, the chunks' steps past the stop "
                      "included; phase 6b's on_device=True runs launch it once a step, in the "
                      "WHILE node's body); A with hardware_prng (phase 7) as often under its "
                      "own key",
    "normal": "B (phase 8, its eager run, the counts set to 0 just before it: one an MCMC "
              "step body, the chunks' steps past the stop included; its graphed run once a "
              "step, in the WHILE node's body)",
    "bits": "B (phase 8, its eager run, the counts set to 0 just before it: the uniform mode, "
            "one an MCMC step body's acceptance uniforms, the chunks' steps past the stop "
            "included; its graphed run launches it once a step, in the WHILE node's body); "
            "rosenbrock100 (phase 16) one a step too",
    "gamma": "B (phase 8, its eager run, the counts set to 0 just before it: one an MCMC "
             "step body, the chunks' steps past the stop included; its graphed run once a "
             "step, in the WHILE node's body)",
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
    "set_conditional": "A fused (phase 6b's timed seed 42 on the device run loop: two before "
                       "the loop, four an iteration in it (its WHILE flag, the warm-up, "
                       "mutation and termination IF nodes), 16 a mutation (the cluster fit's "
                       "15 IF nodes, the MCMC chain's WHILE node) and one a step); the "
                       "on_device=False runs decide on the host and launch none",
    "host_call": "A with its likelihood on the host (phase 13, seed 42, on the run loop: one a "
                 "sweep, the first iteration's served outside the graph, the others in the "
                 "warm-up IF body and the MCMC WHILE body; its on_device=False run reads "
                 "instead, and launches none)",
    "mutation_draws_f64": "A in float64 (phase 14, seed 42, on_device=False: one an MCMC step "
                          "body, the chunks' steps past the stop included; on the run loop "
                          "once a step, in the MCMC WHILE node's body); with hardware_prng "
                          "as often, the same draws",
    "normal_f64": "B in float64 (phase 14, its eager run: one an MCMC step body; graphed once a "
                  "step, in the WHILE node's body)",
    "uniform_f64": "B in float64 (phase 14, its eager run: one an MCMC step body's acceptance "
                   "uniforms, and the keyed warm-up (two) and resampling (one) uniforms); A in "
                   "float64 those of its iterations",
    "gamma_f64": "B in float64 (phase 14, its eager run: one an MCMC step body; graphed once a "
                 "step, in the WHILE node's body)",
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
            **({"no_pallas_counterpart": NO_PALLAS[name]} if name in NO_PALLAS else {}),
            **{k: row[k] for k in ("device_ms", "library_device_ms", "gamma_flips", "rounds",
                                   "bound_sm_ms", "bound_sm_by", "chain_bound_ms",
                                   "bytes_bound_ms", "longest_chain", "device_ms_turns",
                                   "cumsum_accumulation", "S", "filled", "probes", "launch_plan",
                                   "gamma_bits_unequal", "hw_uniform_launches", "shapes",
                                   "mode", "uniform_equal", "raw_words", "shape", "mean_rounds",
                                   "routes", "on_rosenbrock100", "on_path", "chain_bound_ms",
                                   "bound_with_chain_ms", "cluster", "n_iter_max",
                                   "iterations_max", "checks", "reduction_us",
                                   "node_costs", "capture_abort", "stamps",
                                   "in_turns_with_parent", "live", "bound_all_samples_ms",
                                   "longest_crossing", "chain_adds", "bounds",
                                   "chain_at_nominal_latency_ms", "add_latency_cycles")
                   if k in row},
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


def a_graphed(device) -> dict:
    """A's seed 42 with run(on_device=True), timed after a run that
    captures its graphs (the device run loop, or a parent's per-iteration
    graphs): the wall, the iterations and the wall an iteration."""
    s = canonical_sampler(device, SEEDS[0], clustering=True)
    s.run(n_total=N_TOTAL, progress=False, on_device=True)
    s.reset(random_state=SEEDS[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(n_total=N_TOTAL, progress=False, on_device=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    iters = int(s.state.hist.t)
    return {"wall": wall, "iters": iters, "ms_per_iter": 1e3 * wall / iters,
            "logz": s.evidence()[0]}


def parent_a(parent: str, ours=None) -> dict:
    """A's seed 42 in the package of checkout `parent` (this script with
    --a-only --package-root, in a process of its own), printed beside
    phase 6's run (`ours`, where given), and its graphed wall, which
    returns."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--a-only",
                           "--package-root", parent], capture_output=True, text=True,
                          timeout=900)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("A_SEED42 ")]
    graphed = [ln for ln in proc.stdout.splitlines() if ln.startswith("A_SEED42_GRAPHED ")]
    check(proc.returncode == 0 and len(lines) == 1 and len(graphed) == 1,
          f"parent A run failed ({proc.returncode}): {proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    theirs = json.loads(lines[0][len("A_SEED42 "):])
    timed = json.loads(graphed[0][len("A_SEED42_GRAPHED "):])
    if ours is not None:
        mine = a_summary(ours)
        # Not held equal: a parent without keyed resampling and warm-up
        # draws, or with another EM summation order, takes another ladder;
        # the run's own checks hold it to the band.
        print(f"A seed {SEEDS[0]} in the parent's package ({parent}): {json.dumps(theirs)}; "
              f"here: {json.dumps(mine)}; equal: {theirs == mine}", flush=True)
    print(f"A seed {SEEDS[0]} graphed in the parent's package ({parent}): {json.dumps(timed)}",
          flush=True)
    return timed


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
    parser.add_argument("--large-scale-only", action="store_true",
                        help="run phases 1-2 and 17 only (no result line)")
    parser.add_argument("--host-only", action="store_true",
                        help="run phases 1-2, 4j and 13's host likelihoods only (no result "
                             "line)")
    parser.add_argument("--handshakes-only", action="store_true",
                        help="print phase 4j's device ms a handshake only (no result line)")
    parser.add_argument("--parent", metavar="DIR",
                        help="a checkout of another commit: its package's A seed 42 (--a-only, "
                             "in a process of its own) beside phase 6's, and its handshakes "
                             "(--handshakes-only) in turns with phase 4j's")
    args = parser.parse_args()
    if args.package_root and not (args.kernels_only or args.a_only or args.handshakes_only):
        fail("--package-root runs another version's package: use it with --kernels-only, "
             "--a-only or --handshakes-only")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on an NVIDIA GPU")
    device = torch.device("cuda")
    if args.handshakes_only:
        print("HANDSHAKES " + json.dumps(handshakes(device)), flush=True)
        return
    t_start = time.perf_counter()

    def stamp(what: str) -> None:
        print(f"[{time.perf_counter() - t_start:.1f} s] {what}", flush=True)

    kind = phase_device()
    print(f"package: {os.path.dirname(os.path.dirname(os.path.abspath(cuda_reweight.__file__)))}",
          flush=True)
    sleep_kernel()  # read while a profile loses nothing (the path windows' warm-up)
    _count_mode_fits()
    _record_forms()
    if cuda_median is not None and not (args.package_root or args.host_only):
        start_extra_builds(args.parent)
    ptxas = phase_build()
    if args.large_scale_only:
        phase_17(device, stamp)
        return
    if args.host_only:
        stamp("phase 4j: the host-call kernel")
        phase_host_kernel(device, args.parent)
        stamp("phase 13: host likelihoods")
        phase_cadence_and_host(device, cadence=False)
        stamp("host only: done")
        return
    if args.a_only:
        runs = {}
        run_canonical(device, "A clustered", SEEDS[:1], True, False, CLUSTERED_LOGZ, runs=runs)
        print("A_SEED42 " + json.dumps(a_summary(runs[SEEDS[0]])), flush=True)
        print("A_SEED42_GRAPHED " + json.dumps(a_graphed(device)), flush=True)
        return
    stamp("phase 3: the ESS kernel")
    rows = {"ess_bisect": phase_ess_kernel(device), "ess_bisect_f64": phase_ess_kernel_f64(device)}
    if cuda_median is not None:
        stamp("phase 3b: the ESS kernel's bracket mode")
        rows["ess_bracket"] = phase_bracket_kernel(device)
    stamp("phase 4: the PRNG kernels")
    rows.update(phase_prng_kernels(device))
    if "tempest_normal_f64" in cuda_prng.LIBRARY.functions:  # absent from an older package
        stamp("phase 4, float64: the float64 PRNG kernels")
        rows.update(phase_prng_kernels_f64(device))
    stamp("phase 4b: the eigenvalue kernel")
    if cuda_linalg is not None:
        rows["sym_eigvals"] = phase_eig_kernel(device)
    a_inputs = a_fit_inputs(device) if cuda_em is not None else None
    if cuda_median is not None:
        stamp("phase 4c: the weighted-median kernel")
        rows["weighted_median"] = phase_median_kernel(device, a_inputs["median"][0])
    if cuda_em is not None:
        stamp("phase 4d: the EM kernels")
        rows.update(phase_em_kernels(device, a_inputs))
    if cuda_graphs is not None:
        stamp("phase 4e: the conditional nodes' flag kernel")
        rows["set_conditional"] = phase_cond_kernel(device)
        if hasattr(cuda_graphs, "while_body"):
            stamp("phase 4f: what a conditional node costs the device")
            rows["set_conditional"]["node_costs"] = phase_node_costs(device)
        if not args.package_root:
            stamp("phase 4g: a failed conditional body's capture")
            rows["set_conditional"]["capture_abort"] = phase_capture_abort()
            stamp("phase 4h: conditional nodes inside conditional bodies")
            rows["set_conditional"]["nested"] = phase_nested_nodes(device)
            stamp("phase 4i: NCCL collectives inside conditional bodies")
            rows["set_conditional"]["nccl"] = phase_nccl_probe()
    if cuda_host is not None:
        stamp("phase 4j: the host-call kernel")
        rows["host_call"] = phase_host_kernel(device, args.parent)
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
    paths["A"], walls = run_canonical(device, "A clustered", SEEDS, True, False,
                                      CLUSTERED_LOGZ, runs=eager)
    turns = []  # A's graphed seed 42, the parent's and this one's, in turns
    if args.parent:
        turns.append(("parent", parent_a(args.parent, eager[SEEDS[0]])))
    stamp("phase 6b: A fused")
    fused = phase_fused(device, eager)
    if args.parent:
        run = fused["windows"]["on_device=True"]
        turns += [("this", {"wall": fused["wall"], "iters": fused["iters"],
                            "ms_per_iter": 1e3 * fused["wall"] / fused["iters"]}),
                  ("this (profiled)", {"wall": run["wall"], "iters": run["iters"],
                                       "ms_per_iter": 1e3 * run["wall_per_iter"]}),
                  ("parent", parent_a(args.parent))]
        print(f"A seed {SEEDS[0]} graphed in turns (parent, this, this, parent): "
              f"{json.dumps(turns)}", flush=True)
    paths["A_fused"] = dict(fused["launches"], set_conditional=fused["set_conditional"])
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
    cadence_host = phase_cadence_and_host(device)
    host_runs = cadence_host.pop("host_runs", None)
    pool_runs = cadence_host.pop("pool_runs", None)
    paths.update(cadence_host)
    stamp("phase 14: float64")
    f64_paths, f64_errs, f64_summary = phase_float64(device, walls, fused["wall"])
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
    _, large = phase_17(device, stamp)
    paths["large_scale"] = large["launches"]
    for name, err in large["errs"].items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
        rows[name].setdefault("on_path", {})["large_scale"] = {
            "launches": large["launches"][name], "max_abs_err": err,
            "device_ms": large["device_ms"][name], "bound_ms": large["bounds"].get(name)}
    if args.profile:
        phase_profile(device, args.profile)

    launches = {"ess_bisect": paths["A"]["ess_bisect"],
                "ess_bisect_f64": paths["A_float64"]["ess_bisect_f64"],
                "ess_bracket": paths["dynamic"]["ess_bracket"],
                "mutation_draws": paths["A"]["mutation_draws"],
                "normal": paths["B"]["normal"], "bits": paths["B"]["bits"],
                "gamma": paths["B"]["gamma"],
                "mutation_draws_f64": paths["A_float64"]["mutation_draws_f64"],
                "normal_f64": paths["B_float64"]["normal_f64"],
                "uniform_f64": paths["B_float64"]["uniform_f64"],
                "gamma_f64": paths["B_float64"]["gamma_f64"],
                "sym_eigvals": paths["rosenbrock100"]["sym_eigvals"],
                "weighted_median": paths["B"]["weighted_median"],
                "gmm_em": paths["A"]["gmm_em"], "mvstud_em": paths["A"]["mvstud_em"],
                "set_conditional": paths["A_fused"]["set_conditional"],
                "host_call": paths["A_host_fused"]["host_call"]}
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on its path")
    print(f"launches by path: {json.dumps(paths)}", flush=True)
    keys = ("probes", "wall_s", "iters", "loops", "run_graphs", "windows", "bisection",
            "float64")
    print(f"dynamic: {json.dumps({k: dynamic[k] for k in keys})}", flush=True)
    print(f"float64: {json.dumps(f64_summary)}", flush=True)
    print(f"A host: {json.dumps(host_runs)}", flush=True)
    print(f"host pool: {json.dumps(pool_runs)}", flush=True)
    keys = ("walls", "iters", "loops", "run_graphs", "windows", "float64")
    print(f"A mesh: {json.dumps({k: mesh[k] for k in keys})}", flush=True)
    keys = ("wall", "iters", "loops", "run_graphs", "windows")
    print(f"A fused: {json.dumps({k: fused[k] for k in keys})}", flush=True)
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
