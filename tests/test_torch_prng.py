"""The plain versions of the hardware-PRNG kernels (ops/philox.py,
ops/cuda_prng.py, draws.HardwareDraws) against tempest_tpu.ops.pallas_prng.

- Philox4x32-10 on Random123's known-answer vectors, exactly.
- The (0, 1] word mapping against `_unit_open_closed`, bit for bit.
- Marsaglia-Tsang against JAX `hw_gamma` fed the same normals and
  uniforms (its `hw_normal`/`hw_uniform` replaced by tables), rtol 1e-6:
  the same float32 operations, so at most the last bit of log differs.
- The counter layout of the gamma draws, which the gamma kernel keeps word
  for word: walkers rebuilt one at a time from scalar Philox counters and a
  scalar first-accept-and-stop Marsaglia-Tsang in numpy float32 give
  `philox.gamma`'s values.
- Moments of the plain draws at CPU sizes with the tolerances of
  tests/test_tpu_smoke.py:181-243 (about 5 sigma).
- The routing of `HardwareDraws`, as tempest_tpu/mcmc.py routes, and the
  call indices each route takes; its call counter's device words (which
  the kernels read) and host mirror agree through steps, `tell`/`seek`,
  `get_state`/`set_state` and `reseed`, which keep the same words.
- Float64 (the plain versions of the `_f64` kernels): the 53-bit mapping
  on the Philox known-answer words, exactly, its ends (2^-53 and 1.0) and
  uniforms off float32's 2^-23 grid; normals from the known-answer words
  within 4 ulp of Box-Muller in numpy (the last bits of log, sqrt and
  sincos); the counter layout of the float64 gamma and mutation draws
  rebuilt walker by walker, exactly; moments at about 5 sigma; no gamma
  draw that no round accepts in 10^6 draws at the 16-round cap; the
  wrappers' and the counter's dtype routing, and the keyed float64 steps'
  call indices (33 + 2 on the large route).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempest_tpu.ops import pallas_prng
from tempest_tpu_torch import draws as draws_mod
from tempest_tpu_torch.ops import cuda_prng, philox

torch.set_num_threads(1)

KEY = philox.key_from_seed(42)


def words(*vals):
    return [torch.tensor([v], dtype=torch.int64) for v in vals]


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    got = philox.philox4x32(*words(*ctr), key)
    assert tuple(int(w) for w in got) == want


def test_unit_open_closed_bit_for_bit():
    rng = np.random.default_rng(0)
    w = np.concatenate([
        np.array([0, 1, 511, 512, 0x7FFFFFFF, 0x80000000, 0xFFFFFE00, 0xFFFFFFFF], np.uint32),
        rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32),
    ])
    want = np.asarray(pallas_prng._unit_open_closed(jnp.asarray(w))).view(np.uint32)
    from_int64 = philox.unit_open_closed(torch.from_numpy(w.astype(np.int64)))
    from_int32 = philox.unit_open_closed(torch.from_numpy(w.view(np.int32)))
    np.testing.assert_array_equal(from_int64.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(from_int32.numpy().view(np.uint32), want)
    assert from_int64.min() > 0.0 and from_int64.max() == 1.0


def test_bits_are_the_philox_words():
    b = philox.bits(KEY, 5, 10, "cpu")
    w = philox.philox4x32(*words(0, philox.STREAM_BITS, 5, 0), KEY)
    assert b.dtype == torch.int32
    assert [int(v) & 0xFFFFFFFF for v in b[:4]] == [int(x) for x in w]


def test_marsaglia_tsang_against_jax_hw_gamma(monkeypatch):
    n = 4096
    alpha_np = np.concatenate([np.full(n // 4, a, np.float32) for a in (0.3, 0.9, 2.5, 40.0)])
    alpha = torch.from_numpy(alpha_np)
    zc, uc, bc = philox.gamma_counters(7)
    normals = [philox.normal(KEY, c, n, "cpu") for c in zc]
    uniforms = [philox.unit_open_closed(philox.bits(KEY, c, n, "cpu")) for c in uc + (bc,)]
    normal_tables = [jnp.asarray(z.numpy()) for z in normals]
    uniform_tables = [jnp.asarray(u.numpy()) for u in uniforms]
    monkeypatch.setattr(pallas_prng, "hw_normal", lambda key, shape, dtype: normal_tables.pop(0))
    monkeypatch.setattr(pallas_prng, "hw_uniform", lambda key, shape, dtype: uniform_tables.pop(0))
    want = np.asarray(pallas_prng.hw_gamma(jax.random.key(0), jnp.asarray(alpha_np)))
    assert not normal_tables and not uniform_tables  # every table used, in call order
    got = philox.marsaglia_tsang(alpha, normals, uniforms[:-1], uniforms[-1])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(philox.gamma(KEY, 7, alpha).numpy(), want, rtol=1e-6)


F32 = np.float32


def _scalar_words(block, call):
    """The four words of one Philox block of stream 0 of call `call`."""
    t = [torch.tensor([v], dtype=torch.int64)
         for v in (block, 0, call & philox.MASK32, call >> 32)]
    return [int(w) for w in philox.philox4x32(*t, KEY)]


def _scalar_unit(w):
    return F32(2.0) - np.array([0x3F800000 | (w >> 9)], np.uint32).view(np.float32)[0]


def _scalar_gamma(a, j, counter):
    """Walker j's gamma draw, one scalar at a time: round r's normal is
    Box-Muller on words (0, 1) or (2, 3) of block j // 4 of call counter + 2r
    (cos for even j, sin for odd), its uniform word j % 4 of call
    counter + 2r + 1; the first accepted round ends the loop. Returns the
    draw before the boost, the round that decided it (None: no round did)
    and the boost factor (1 for alpha >= 1)."""
    a = F32(a)
    boost = a < F32(1.0)
    d = (a + F32(1.0) if boost else a) - F32(1.0 / 3.0)
    c = F32(1.0) / np.sqrt(F32(9.0) * d)
    res, decided = d, None
    for r in range(philox.MT_ROUNDS):
        w = _scalar_words(j // 4, counter + 2 * r)
        pair = (j % 4) // 2
        radius = np.sqrt(F32(-2.0) * np.log(_scalar_unit(w[2 * pair])))
        theta = F32(philox.TWO_PI) * _scalar_unit(w[2 * pair + 1])
        z = radius * (np.cos(theta) if j % 2 == 0 else np.sin(theta))
        u = _scalar_unit(_scalar_words(j // 4, counter + 2 * r + 1)[j % 4])
        one_cz = F32(1.0) + c * z
        v = one_cz * one_cz * one_cz
        if v > 0 and np.log(u) < F32(0.5) * z * z + d - d * v + d * np.log(max(v, F32(1e-30))):
            res, decided = d * v, r
            break
    scale = F32(1.0)
    if boost:
        u_boost = _scalar_unit(_scalar_words(j // 4, counter + 2 * philox.MT_ROUNDS)[j % 4])
        scale = np.power(u_boost, F32(1.0) / max(a, F32(1e-12)))
    return res, decided, scale


def test_gamma_counter_layout():
    """`philox.gamma` (every round evaluated, the first accepted one taken)
    against walkers rebuilt one at a time and stopped at their first
    accepted round: the first two blocks (j % 4 = 0..3), walkers that a
    later round decides, and the ragged last block. The call indices cross
    2^32, so the counter's high word changes within one call. A draw equals
    the scalar one exactly; with alpha < 1 the boost factor U^(1/alpha) is
    compared to 2 ulp, the last bits of numpy's powf and of PyTorch's
    vectorized pow, and the draw before it exactly, through alpha + 1."""
    n, counter = 1003, (1 << 32) - 5  # 250 whole blocks and one of 3
    alpha_np = np.array([0.02, 0.5, 0.7, 1.5, 7.5, 50.0] * (n // 6 + 1), np.float32)[:n]
    alpha = torch.from_numpy(alpha_np)
    want = philox.gamma(KEY, counter, alpha).numpy()
    unboosted = philox.gamma(KEY, counter, alpha + 1.0).numpy()  # alpha + 1 is a_eff
    # Walkers some later round decides, found on the whole vector.
    _, d, c = philox.mt_setup(alpha)
    zc, uc, _ = philox.gamma_counters(counter)
    z0 = philox.normal(KEY, zc[0], n, "cpu")
    u0 = philox.unit_open_closed(philox.bits(KEY, uc[0], n, "cpu"))
    later = torch.nonzero(~philox.mt_accept(z0, u0, d, c)[0]).reshape(-1).tolist()
    walkers = list(range(8)) + later[:6] + [n - 3, n - 2, n - 1]
    decided = set()
    for j in walkers:
        res, r, scale = _scalar_gamma(alpha_np[j], j, counter)
        decided.add(r)
        if alpha_np[j] >= 1.0:
            assert want[j] == res, (j, r)
        else:
            assert unboosted[j] == res, (j, r)
            assert abs(want[j] - res * scale) <= 2 * np.spacing(want[j]), (j, r)
    assert {0, 1} <= decided  # the early exit is exercised


def test_normal_and_uniform_moments():
    n = 1 << 20
    z = cuda_prng.hw_normal(KEY, 0, (n,), "cpu").double().numpy()
    assert abs(z.mean()) < 0.005 and abs(z.var() - 1.0) < 0.01
    kurt = ((z - z.mean()) ** 4).mean() / z.var() ** 2
    assert abs(kurt - 3.0) < 0.05
    assert abs((np.abs(z) > 3).mean() - 0.0027) < 0.0005

    u = cuda_prng.hw_uniform(KEY, 1, (n,), "cpu").double().numpy()
    assert 0.0 < u.min() and u.max() <= 1.0
    assert abs(u.mean() - 0.5) < 0.002 and abs(u.var() - 1.0 / 12.0) < 0.001


@pytest.mark.parametrize("a", [0.5, 1.5, 7.5, 50.0])
def test_gamma_moments(a):
    n = 1 << 16
    g = cuda_prng.hw_gamma(KEY, 100, torch.full((n,), a)).double().numpy()
    assert g.min() > 0.0
    assert abs(g.mean() - a) < 5 * np.sqrt(a / n) + 0.01
    assert abs(g.var() - a) < 0.05 * a + 0.02


def test_mutation_draws_moments_and_layout():
    R, N, d = 8, 1024, 10
    alpha = torch.cat([torch.full((N // 2,), 7.5), torch.full((N // 2,), 0.7)])
    zs, gs, us = [], [], []
    for c in range(32):  # aggregate draws for tight moments, as the TPU test does
        z, g, u = cuda_prng.hw_mutation_draws(KEY, c, alpha, (R, N, d))
        zs.append(z.reshape(-1)), gs.append(g), us.append(u)
    # The proposal normals are those of `normal` on the same call.
    assert torch.equal(zs[3], philox.normal(KEY, 3, R * N * d, "cpu"))
    z = torch.cat(zs).double().numpy()
    g = torch.stack(gs).double().numpy()
    u = torch.cat(us).double().numpy()
    assert abs(z.mean()) < 0.005 and abs(z.var() - 1.0) < 0.01
    assert abs(((z - z.mean()) ** 4).mean() / z.var() ** 2 - 3.0) < 0.05
    assert 0.0 < u.min() and u.max() <= 1.0 and abs(u.mean() - 0.5) < 0.01
    g_hi, g_lo = g[:, : N // 2].ravel(), g[:, N // 2:].ravel()
    assert g_lo.min() > 0.0
    assert abs(g_hi.mean() - 7.5) < 0.1 and abs(g_hi.var() - 7.5) < 0.3
    assert abs(g_lo.mean() - 0.7) < 0.03 and abs(g_lo.var() - 0.7) < 0.05


def test_wrappers_route_by_device():
    before = dict(cuda_prng.LAUNCHES)
    alpha = torch.full((16,), 3.0)
    z, g, u = cuda_prng.hw_mutation_draws(KEY, 0, alpha, (2, 16, 3))
    assert z.shape == (2, 16, 3) and g.shape == u.shape == (16,)
    assert cuda_prng.hw_bits(KEY, 0, (3, 5), "cpu").shape == (3, 5)
    assert cuda_prng.LAUNCHES == before  # the plain versions launch nothing
    with pytest.raises(ValueError):
        cuda_prng.hw_normal(KEY, 0, (8,), "meta")
    with pytest.raises(ValueError):
        cuda_prng.hw_mutation_draws(KEY, 0, alpha.to("meta"), (2, 16, 3))
    with pytest.raises(ValueError):
        cuda_prng.hw_normal((1 << 32, 0), 0, (8,), "cpu")
    with pytest.raises(ValueError):
        cuda_prng.hw_mutation_draws(KEY, 0, alpha, (2, 15, 3))


def test_hw_gamma_call_indices_fit_64_bits():
    """A call uses indices counter .. counter + 12: the last one must fit."""
    alpha = torch.full((8,), 2.5)
    with pytest.raises(ValueError):
        cuda_prng.hw_gamma(KEY, (1 << 64) - philox.GAMMA_CALLS + 1, alpha)
    with pytest.raises(ValueError):
        cuda_prng.hw_gamma(KEY, -1, alpha)
    last = (1 << 64) - philox.GAMMA_CALLS  # counter + 12 = 2^64 - 1
    assert torch.equal(cuda_prng.hw_gamma(KEY, last, alpha), philox.gamma(KEY, last, alpha))
    with pytest.raises(ValueError):  # neither a CPU nor a CUDA tensor
        cuda_prng.hw_gamma(KEY, 0, alpha.to("meta"))


def _step(hw, n, gamma_shape, R=2, d=3):
    return hw.mcmc_step(R, n, d, gamma_shape)


def test_hardware_draws_routes_as_jax():
    """tpCN at R N d <= 2^19 draws as JAX's fused route does, from the
    mutation-draws kernel (one call index a step); RWM has no such kernel
    and, keyed, takes the normal and the uniform kernels (two calls)."""
    n = 64
    alpha = torch.full((n,), 2.5)
    hw = draws_mod.HardwareDraws(7, "cpu")
    assert hw.key == philox.key_from_seed(7) and hw.keyed
    z, g, u = _step(hw, n, alpha)
    wz, wg, wu = philox.mutation_draws(hw.key, 0, alpha, (2, n, 3))
    assert torch.equal(z, wz) and torch.equal(g, wg) and torch.equal(u, wu)
    assert hw.counter == 1
    z, g, u = _step(hw, n, None)
    assert g is None and hw.counter == 3
    assert torch.equal(z.reshape(-1), philox.normal(hw.key, 1, 2 * n * 3, "cpu"))
    assert torch.equal(u, philox.uniform(hw.key, 2, n, "cpu"))


def test_hardware_draws_large_route(monkeypatch):
    """Past the mutation-draws kernel's size: g from hw_gamma (13 calls), z
    from hw_normal, the acceptance uniforms from hw_uniform (a shrunk
    threshold, same rule); the generator is not drawn from."""
    monkeypatch.setattr(draws_mod, "FUSED_DRAWS_MAX_ELEMS", 0)
    n = 64
    alpha = torch.full((n,), 2.5)
    hw = draws_mod.HardwareDraws(7, "cpu")
    position = hw.generator.get_state()
    z, g, u = _step(hw, n, alpha)
    assert torch.equal(g, philox.gamma(hw.key, 0, alpha))
    assert torch.equal(z.reshape(-1), philox.normal(hw.key, philox.GAMMA_CALLS, 2 * n * 3, "cpu"))
    assert torch.equal(u, philox.uniform(hw.key, philox.GAMMA_CALLS + 1, n, "cpu"))
    assert hw.counter == philox.GAMMA_CALLS + 2
    # Another walker count: the next calls, whatever n.
    z, g, u = _step(hw, n - 1, torch.full((n - 1,), 2.5))
    assert hw.counter == 2 * (philox.GAMMA_CALLS + 2) and g.shape == (n - 1,)
    assert torch.equal(g, philox.gamma(hw.key, philox.GAMMA_CALLS + 2, g.new_full((n - 1,), 2.5)))
    assert torch.equal(hw.generator.get_state(), position)


def test_hardware_draws_gamma_takes_gamma_calls(monkeypatch):
    """On the large route every MCMC step takes GAMMA_CALLS = 13 call indices
    for its gamma draws, one for its normals and one for its uniforms, as
    before the gamma draws became one kernel, so a checkpointed
    `philox_counter` resumes the same stream."""
    monkeypatch.setattr(draws_mod, "FUSED_DRAWS_MAX_ELEMS", 0)
    assert philox.GAMMA_CALLS == 2 * philox.MT_ROUNDS + 1 == 13
    n = 64
    per_step = philox.GAMMA_CALLS + 2
    alpha = torch.linspace(0.3, 9.0, n)
    hw = draws_mod.HardwareDraws(11, "cpu")
    for step in range(3):
        first = step * per_step
        assert hw.counter == first
        _, g, _ = _step(hw, n, alpha)
        assert torch.equal(g, philox.gamma(hw.key, first, alpha))
    state = hw.get_state()
    resumed = draws_mod.HardwareDraws(0, "cpu")
    resumed.set_state(state)
    z, g, _ = _step(resumed, n, alpha)
    assert resumed.counter == int(state["philox_counter"]) + per_step
    assert torch.equal(g, philox.gamma(hw.key, 3 * per_step, alpha))


def test_hardware_draws_mirror_and_device_words_agree(monkeypatch):
    monkeypatch.setattr(draws_mod, "FUSED_DRAWS_MAX_ELEMS", 0)
    n = 64
    per_step = philox.GAMMA_CALLS + 2
    alpha = torch.linspace(0.3, 9.0, n)
    hw = draws_mod.HardwareDraws(7, "cpu")
    words = hw.calls.state
    assert hw.calls.read() == (0, hw.key) == (0, philox.key_from_seed(7))
    _step(hw, n, alpha)
    position = hw.counter
    assert position == per_step and hw.calls.read() == (position, hw.key)
    z, g, _ = _step(hw, n, alpha)
    assert hw.calls.read() == (2 * per_step, hw.key)
    hw.calls.seek(position)
    assert hw.counter == position and hw.calls.read() == (position, hw.key)
    z2, g2, _ = _step(hw, n, alpha)  # the same draws again
    assert torch.equal(z, z2) and torch.equal(g, g2)
    # An inactive step draws and leaves the words.
    _, g3, _ = hw.mcmc_step(2, n, 3, alpha, active=torch.tensor(False))
    assert hw.counter == 2 * per_step
    assert torch.equal(g3, philox.gamma(hw.key, 2 * per_step, alpha))
    state = hw.get_state()
    assert int(state["philox_counter"]) == hw.counter
    other = draws_mod.HardwareDraws(0, "cpu")
    other.set_state(state)
    assert other.calls.read() == (hw.counter, hw.key) and other.key == hw.key
    # A key whose high word has its top bit set, and a counter past 2^63.
    big = draws_mod.HardwareDraws((1 << 63) + 5, "cpu")
    big.calls.seek((1 << 63) + 3)
    assert big.calls.read() == ((1 << 63) + 3, philox.key_from_seed((1 << 63) + 5))
    _, g_big, _ = _step(big, n, alpha)
    assert torch.equal(g_big, philox.gamma(big.key, (1 << 63) + 3, alpha))
    assert big.calls.read()[0] == (1 << 63) + 3 + per_step
    # reseed restarts the stream on the same words (CUDA graphs hold them).
    hw.reseed(11)
    assert hw.calls.state is words and hw.calls.read() == (0, philox.key_from_seed(11))
    with pytest.raises(ValueError):  # shapes on another device than the counter's words
        hw.calls.gamma(0, alpha.to("meta"))
    with pytest.raises(ValueError):  # every call index must fit 64 bits
        hw.calls.seek((1 << 64) - philox.GAMMA_CALLS)
        _step(hw, n, alpha)


# ---------------------------------------------------------------------------
# Float64
# ---------------------------------------------------------------------------
KAT_WORDS = (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)  # key (0, 0), counter 0


def _unit53(wa, wb):
    """The 53-bit mapping in exact integer arithmetic."""
    return float(((((wa >> 5) << 26) | (wb >> 6)) + 1)) * 2.0**-53


def test_float64_uniforms_on_the_known_answer_words():
    got = philox.uniform_f64((0, 0), 0, 2, "cpu")
    assert got.dtype == torch.float64
    assert got.tolist() == [_unit53(*KAT_WORDS[:2]), _unit53(*KAT_WORDS[2:])]
    ends = philox.unit53(torch.tensor([0, 0xFFFFFFFF]), torch.tensor([0, 0xFFFFFFFF]))
    assert ends.tolist() == [2.0**-53, 1.0]
    # Five elements: the ragged block's second double is left out.
    five = philox.uniform_f64(KEY, 9, 5, "cpu")
    assert torch.equal(five, philox.uniform_f64(KEY, 9, 6, "cpu")[:5])


def test_float64_uniforms_are_not_on_the_float32_grid():
    u = philox.uniform_f64(KEY, 3, 1 << 16, "cpu").numpy()
    assert 0.0 < u.min() and u.max() <= 1.0
    on_grid = np.mean(np.floor(u * 2.0**23) == u * 2.0**23)
    assert on_grid < 1e-3  # a 53-bit uniform lands on the 2^-23 grid with probability 2^-30
    assert np.mean(u.astype(np.float32).astype(np.float64) != u) > 0.999


def test_float64_normals_on_the_known_answer_words():
    got = philox.normal_f64((0, 0), 0, 2, "cpu").numpy()
    ua, ub = _unit53(*KAT_WORDS[:2]), _unit53(*KAT_WORDS[2:])
    r, theta = np.sqrt(-2.0 * np.log(ua)), philox.TWO_PI * ub
    want = np.array([r * np.cos(theta), r * np.sin(theta)])
    np.testing.assert_allclose(got, want, rtol=4 * np.finfo(np.float64).eps, atol=0)


def _t64(v):
    return torch.tensor([v], dtype=torch.float64)


def _scalar_words64(block, stream, call):
    t = [torch.tensor([v], dtype=torch.int64)
         for v in (block, stream, call & philox.MASK32, call >> 32)]
    return [int(w) for w in philox.philox4x32(*t, KEY)]


def test_float64_gamma_counter_layout():
    """`philox.gamma_f64` against walkers rebuilt from their own words:
    walker j's round r takes normal j % 2 of block j // 2 of call counter +
    2r and uniform j % 2 of block j // 2 of call counter + 2r + 1 (from
    `normal_f64` / `uniform_f64` of single blocks), its boost uniform j % 2
    of call counter + 32; the first accepted round wins. The calls cross
    2^32."""
    n, counter = 201, (1 << 32) - 7
    alpha = torch.tensor([0.02, 0.5, 1.0, 2.5, 7.5, 50.0] * 34, dtype=torch.float64)[:n]
    want = philox.gamma_f64(KEY, counter, alpha)
    assert want.dtype == torch.float64 and bool(torch.all(want > 0))
    zc, uc, bc = philox.gamma_counters(counter, philox.MT_ROUNDS_F64)
    assert len(zc) == philox.MT_ROUNDS_F64 == 16 and bc == counter + 32
    assert philox.GAMMA_CALLS_F64 == 33 == philox.gamma_calls(torch.float64)
    later = 0
    for j in list(range(12)) + [n - 2, n - 1]:
        a = alpha[j:j + 1]
        boost, d, c = philox.mt_setup(a)
        res = d
        for r in range(philox.MT_ROUNDS_F64):
            z = philox.normal_f64(KEY, zc[r], j + 1, "cpu")[j:j + 1]
            u = philox.uniform_f64(KEY, uc[r], j + 1, "cpu")[j:j + 1]
            ok, prop = philox.mt_accept(z, u, d, c)
            if bool(ok):
                res, later = prop, later + (r > 0)
                break
        if bool(boost):
            ub = philox.uniform_f64(KEY, bc, j + 1, "cpu")[j:j + 1]
            res = res * ub ** (1.0 / a)
        assert float(res) == float(want[j]), j
    # the block's words: walker 2 takes the first double of block 1
    w = _scalar_words64(1, 0, uc[0])
    assert philox.uniform_f64(KEY, uc[0], 4, "cpu")[2].item() == _unit53(w[0], w[1])


def test_float64_mutation_draws_layout():
    """Walker n's round r on streams 1 + 2r (normal, cos-only) and 2 + 2r
    (acceptance uniform), boost and Metropolis uniforms from stream 33; the
    proposal normals are `normal_f64` of the same call."""
    R, N, d, counter = 2, 10, 3, 5
    alpha = torch.linspace(0.3, 9.0, N, dtype=torch.float64)
    z, g, u = philox.mutation_draws_f64(KEY, counter, alpha, (R, N, d))
    assert z.dtype == g.dtype == u.dtype == torch.float64
    assert torch.equal(z.reshape(-1), philox.normal_f64(KEY, counter, R * N * d, "cpu"))
    assert philox.STREAM_BOOST_ACCEPT_F64 == 33
    for n in range(N):
        wb = _scalar_words64(n, 33, counter)
        assert u[n].item() == _unit53(wb[2], wb[3])
        boost, dd, c = philox.mt_setup(alpha[n:n + 1])
        res = dd
        for r in range(philox.MT_ROUNDS_F64):
            wn = _scalar_words64(n, 1 + 2 * r, counter)
            wa = _scalar_words64(n, 2 + 2 * r, counter)
            zn = torch.sqrt(-2.0 * torch.log(_t64(_unit53(wn[0], wn[1])))) * torch.cos(
                philox.TWO_PI * _t64(_unit53(wn[2], wn[3])))
            ok, prop = philox.mt_accept(zn, _t64(_unit53(wa[0], wa[1])), dd, c)
            if bool(ok):
                res = prop
                break
        if bool(boost):
            res = res * _t64(_unit53(wb[0], wb[1])) ** (1.0 / alpha[n:n + 1])
        assert float(res) == g[n].item(), n


def test_float64_moments():
    n = 1 << 20
    z = cuda_prng.hw_normal(KEY, 0, (n,), "cpu", dtype=torch.float64).numpy()
    assert z.dtype == np.float64
    assert abs(z.mean()) < 0.005 and abs(z.var() - 1.0) < 0.01
    assert abs(((z - z.mean()) ** 4).mean() / z.var() ** 2 - 3.0) < 0.05
    assert abs((np.abs(z) > 3).mean() - 0.0027) < 0.0005
    u = cuda_prng.hw_uniform(KEY, 1, (n,), "cpu", dtype=torch.float64).numpy()
    assert 0.0 < u.min() and u.max() <= 1.0
    assert abs(u.mean() - 0.5) < 0.002 and abs(u.var() - 1.0 / 12.0) < 0.001
    for a in (0.5, 1.5, 7.5, 50.0):
        m = 1 << 16
        g = cuda_prng.hw_gamma(KEY, 100, torch.full((m,), a, dtype=torch.float64)).numpy()
        assert g.dtype == np.float64 and g.min() > 0.0
        assert abs(g.mean() - a) < 5 * np.sqrt(a / m) + 0.01
        assert abs(g.var() - a) < 0.05 * a + 0.02


def test_float64_gamma_no_miss_in_a_million_draws():
    """At the 16-round cap, 10^6 draws at alpha 0.02, 1.0 and 7.5 (1.0 is
    where a round accepts least often): every draw accepted by some round
    (a miss has probability below 1.5e-21)."""
    n, counter = 1_000_000, 77
    alpha = torch.tensor([0.02, 1.0, 7.5], dtype=torch.float64).repeat(n // 3 + 1)[:n]
    _, d, c = philox.mt_setup(alpha)
    zc, uc, _ = philox.gamma_counters(counter, philox.MT_ROUNDS_F64)
    undecided = torch.ones(n, dtype=torch.bool)
    rounds = 0
    for r in range(philox.MT_ROUNDS_F64):
        ok, _ = philox.mt_accept(philox.normal_f64(KEY, zc[r], n, "cpu"),
                                 philox.uniform_f64(KEY, uc[r], n, "cpu"), d, c)
        undecided &= ~ok
        rounds += 1
        if not bool(undecided.any()):
            break
    assert not bool(undecided.any()) and rounds < philox.MT_ROUNDS_F64


def test_float64_wrappers_and_counter_route_by_dtype():
    before = dict(cuda_prng.LAUNCHES)
    alpha = torch.full((16,), 3.0, dtype=torch.float64)
    z, g, u = cuda_prng.hw_mutation_draws(KEY, 4, alpha, (2, 16, 3))
    assert z.dtype == g.dtype == u.dtype == torch.float64
    wz, wg, wu = philox.mutation_draws_f64(KEY, 4, alpha, (2, 16, 3))
    assert torch.equal(z, wz) and torch.equal(g, wg) and torch.equal(u, wu)
    assert torch.equal(cuda_prng.hw_gamma(KEY, 4, alpha), philox.gamma_f64(KEY, 4, alpha))
    assert torch.equal(cuda_prng.hw_normal(KEY, 4, (3, 5), "cpu", torch.float64).reshape(-1),
                       philox.normal_f64(KEY, 4, 15, "cpu"))
    assert cuda_prng.LAUNCHES == before  # the plain versions launch nothing
    with pytest.raises(ValueError):  # another dtype raises; nothing falls back
        cuda_prng.hw_normal(KEY, 0, (8,), "cpu", torch.float16)
    with pytest.raises(ValueError):
        cuda_prng.hw_gamma(KEY, 0, alpha.half())
    with pytest.raises(ValueError):
        cuda_prng.hw_uniform(KEY, 0, (8,), "meta", torch.float64)
    with pytest.raises(ValueError):  # the last of a float64 gamma's 33 calls must fit
        cuda_prng.hw_gamma(KEY, (1 << 64) - philox.GAMMA_CALLS_F64 + 1, alpha)
    calls = cuda_prng.PhiloxCounter(KEY, "cpu", counter=9)
    assert torch.equal(calls.uniform(1, (4, 2), torch.float64).reshape(-1),
                       philox.uniform_f64(KEY, 10, 8, "cpu"))
    assert torch.equal(calls.gamma(0, alpha), philox.gamma_f64(KEY, 9, alpha))
    assert torch.equal(calls.normal(2, (5,), torch.float64), philox.normal_f64(KEY, 11, 5, "cpu"))


@pytest.mark.parametrize("route", ["mutation", "large"])
def test_keyed_float64_steps_take_their_calls(monkeypatch, route):
    """A keyed float64 step draws in double from the counter: one call on
    the mutation-draws route; 33 (gamma) + 1 (normal) + 1 (uniform) past
    FUSED_DRAWS_MAX_ELEMS; the generator is not drawn from."""
    if route == "large":
        monkeypatch.setattr(draws_mod, "FUSED_DRAWS_MAX_ELEMS", 0)

    class Keyed(draws_mod.Draws):
        KEYED_ON_CPU = True

    n = 64
    alpha = torch.linspace(0.3, 9.0, n, dtype=torch.float64)
    dr = Keyed(7, "cpu", torch.float64)
    assert dr.keyed and dr.key == philox.draws_key(7)
    position = dr.generator.get_state()
    z, g, u = dr.mcmc_step(2, n, 3, alpha)
    assert z.dtype == g.dtype == u.dtype == torch.float64
    if route == "mutation":
        wz, wg, wu = philox.mutation_draws_f64(dr.key, 0, alpha, (2, n, 3))
        assert torch.equal(z, wz) and torch.equal(g, wg) and torch.equal(u, wu)
        assert dr.counter == 1
    else:
        assert torch.equal(g, philox.gamma_f64(dr.key, 0, alpha))
        assert torch.equal(z.reshape(-1), philox.normal_f64(dr.key, 33, 2 * n * 3, "cpu"))
        assert torch.equal(u, philox.uniform_f64(dr.key, 34, n, "cpu"))
        assert dr.counter == philox.GAMMA_CALLS_F64 + 2
    w, patch = dr.warmup(n, 3)
    assert w.dtype == patch.dtype == torch.float64
    assert torch.equal(patch, philox.uniform_f64(dr.key, dr.counter - 1, n, "cpu"))
    assert torch.equal(dr.generator.get_state(), position)
