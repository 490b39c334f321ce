"""The port's kernel launchers, checked where no GPU is needed.

- Each `CudaLibrary`'s ctypes signature table matches the `extern "C"`
  declarations of its source under tempest_tpu_torch/csrc/: the same
  names, and per argument the ctypes type of the C type.
- The conditional-node helper (`ops/cuda_graphs.if_body`) takes only a
  0-d CUDA bool.
- `cuda_reweight.plan_launch` picks the ESS kernel's route by S and the
  dtype: slices held in shared memory up to 16 x 24,576 = 393,216 float32
  samples, or 16 x 12,288 = 196,608 float64 ones, streamed from L2 past
  that, on CTAs of 1024 threads in float32 and 512 in float64; its
  constants are the kernel's, and each dtype names its C entry.
- The inputs of the GPU test of the mutation-draws kernel reach the later
  Marsaglia-Tsang rounds that the kernel spreads over lanes.
"""

import ctypes
import re

import pytest
import torch

from tempest_tpu_torch.ops import (_build, cuda_graphs, cuda_median, cuda_prng, cuda_reweight,
                                   philox)

C_TYPES = {
    "const void*": ctypes.c_void_p,
    "void*": ctypes.c_void_p,
    "int64_t": ctypes.c_int64,
    "int": ctypes.c_int,
    "uint32_t": ctypes.c_uint32,
    "uint64_t": ctypes.c_uint64,
    "double": ctypes.c_double,
}


def _declarations(source: str) -> dict:
    """name -> [C type of each argument] of the extern "C" functions."""
    text = (_build.CSRC / source).read_text()
    out = {}
    for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
        types = []
        for arg in args.split(","):
            words = " ".join(arg.split())
            types.append(re.sub(r"\s*\b\w+$", "", words).replace(" *", "*"))
        out[name] = types
    return out


@pytest.mark.parametrize("library", [cuda_reweight.LIBRARY, cuda_prng.LIBRARY,
                                     cuda_median.LIBRARY, cuda_graphs.LIBRARY],
                         ids=lambda lib: lib.source)
def test_signature_table_matches_the_source(library):
    declared = _declarations(library.source)
    assert set(declared) == set(library.functions)
    for name, argtypes in library.functions.items():
        assert [C_TYPES[t] for t in declared[name]] == list(argtypes), name


@pytest.mark.parametrize("pred", [torch.tensor(True), torch.ones((1,), dtype=torch.bool),
                                  torch.tensor(1)], ids=["cpu", "shape", "dtype"])
def test_conditional_node_takes_a_0d_cuda_bool(pred):
    """A conditional node is made only inside a capture on the card; a CPU
    run decides on the host, and anything but a 0-d CUDA bool raises."""
    with pytest.raises(ValueError, match="0-d CUDA bool"):
        with cuda_graphs.if_body(pred, None, None):
            pass


ON_CHIP = cuda_reweight.ESS_CLUSTER * cuda_reweight.ESS_SLICE_MAX


@pytest.mark.parametrize(
    "S,slice_,resident",
    [
        (1, 4, True),
        (7000, 440, True),  # ragged: ceil(7000 / 16) = 438, up to a multiple of 4
        (65536, 4096, True),  # the canonical history, 64 x 1024
        (ON_CHIP, 24576, True),  # the last S held on chip
        (ON_CHIP + 1, 24580, False),  # the first S streamed
        (1 << 20, 65536, False),  # B: 8 x 131,072
    ],
)
def test_ess_launch_plan(S, slice_, resident):
    plan = cuda_reweight.plan_launch(S)
    assert ON_CHIP == 393216
    assert plan.cluster == 16 and plan.threads == 1024
    assert (plan.slice, plan.resident) == (slice_, resident)
    assert plan.slice % 4 == 0 and plan.cluster * plan.slice >= S
    assert 8 * cuda_reweight.ESS_SLICE_MAX <= 227 * 1024 - 4096  # an SM's shared memory


@pytest.mark.parametrize("name,value", [
    ("kCluster", cuda_reweight.ESS_CLUSTER),
    ("kSliceMax", cuda_reweight.ESS_SLICE_MAX),
    ("kThreadsF32", cuda_reweight.ESS_THREADS[torch.float32]),
    ("kThreadsF64", cuda_reweight.ESS_THREADS[torch.float64]),
])
def test_ess_plan_constants_match_the_source(name, value):
    """The plan's cluster size, slice capacity and CTA widths are the
    kernel's: the C entry refuses a resident slice past kSliceMax, sizes its
    grid by kCluster and its CTAs by kThreadsF32 / kThreadsF64."""
    text = (_build.CSRC / cuda_reweight.LIBRARY.source).read_text()
    assert re.findall(rf"constexpr \w+ {name} = (\d+);", text) == [str(value)]


def test_ess_route_changes_once():
    """Held on chip up to the boundary, streamed past it, nowhere else."""
    sizes = range(ON_CHIP - 64, ON_CHIP + 65)
    assert [cuda_reweight.plan_launch(S).resident for S in sizes] == [S <= ON_CHIP for S in sizes]


ON_CHIP_F64 = cuda_reweight.ESS_CLUSTER * cuda_reweight.slice_max(torch.float64)


def test_each_dtype_names_its_entry():
    """Each dtype names its C entry in each mode: the ESS-mode bisection and
    the bracket mode of one source; the weighted median's."""
    assert cuda_reweight.ENTRIES == {torch.float32: "tempest_ess_bisect",
                                     torch.float64: "tempest_ess_bisect_f64"}
    assert cuda_reweight.BRACKET_ENTRIES == {torch.float32: "tempest_ess_bracket",
                                             torch.float64: "tempest_ess_bracket_f64"}
    assert (set(cuda_reweight.ENTRIES.values()) | set(cuda_reweight.BRACKET_ENTRIES.values())
            == set(cuda_reweight.LIBRARY.functions))
    assert set(cuda_median.ENTRIES.values()) == set(cuda_median.LIBRARY.functions)


@pytest.mark.parametrize(
    "S,slice_,resident",
    [
        (65536, 4096, True),  # A's history
        (ON_CHIP_F64, 12288, True),  # the last float64 S held on chip
        (ON_CHIP_F64 + 1, 12292, False),  # the first streamed
        (1 << 20, 65536, False),  # B
    ],
)
def test_ess_launch_plan_float64(S, slice_, resident):
    plan = cuda_reweight.plan_launch(S, torch.float64)
    assert ON_CHIP_F64 == 196608
    assert (plan.cluster, plan.slice, plan.resident, plan.threads) == (16, slice_, resident, 512)
    assert 16 * cuda_reweight.slice_max(torch.float64) == 8 * cuda_reweight.ESS_SLICE_MAX


def test_ess_route_changes_once_float64():
    sizes = range(ON_CHIP_F64 - 64, ON_CHIP_F64 + 65)
    assert ([cuda_reweight.plan_launch(S, torch.float64).resident for S in sizes]
            == [S <= ON_CHIP_F64 for S in sizes])


@pytest.mark.parametrize("N", [1024, 1000, 6553])
def test_small_alpha_reaches_later_rounds(N):
    """The draws of tests/test_torch_cuda.py's mutation-draws test (key 42,
    call 5, alpha 7.5 / 0.7 / 0.02 by thirds): at alpha = 0.02 (boosted to
    1.02) a first round rejects often enough that later rounds decide some
    walkers, so their draw differs from the one-round draw."""
    key, counter, third = philox.key_from_seed(42), 5, N // 3
    alpha = torch.cat([torch.full((third,), 7.5), torch.full((third,), 0.7),
                       torch.full((N - 2 * third,), 0.02)])
    w0, w1, w2, _ = philox._blocks(N, philox.STREAM_GAMMA_ROUND0, counter, key, "cpu")
    z0 = torch.sqrt(-2.0 * torch.log(philox.unit_open_closed(w0))) * torch.cos(
        philox.TWO_PI * philox.unit_open_closed(w1))
    boost = philox.unit_open_closed(philox._blocks(N, philox.STREAM_BOOST_ACCEPT, counter, key,
                                                   "cpu")[0])
    one = philox.marsaglia_tsang(alpha, [z0], [philox.unit_open_closed(w2)], boost)
    _, g, _ = philox.mutation_draws(key, counter, alpha, (1, N, 1))
    later = (one != g)[2 * third:]
    assert 0 < int(later.sum()) < N // 12
    assert torch.all(torch.isfinite(g) & (g >= 0))  # U^(1/0.02) may underflow to 0
