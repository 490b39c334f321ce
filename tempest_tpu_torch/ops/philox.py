"""Counter-based draws in plain PyTorch: the plain versions of the PRNG kernels.

Counterpart of the draw kernels of tempest_tpu/ops/pallas_prng.py
(`_normal_kernel` :83, `_bits_kernel` :108, `_mutation_draws_kernel` :159)
and of `hw_gamma` (:275-307). The TPU kernels draw from the TPU's hardware
generator; Hopper has none, so the port draws from Philox4x32-10 (Salmon
et al. 2011, the Random123 generator), written out here and in
csrc/prng_draws.cu with one counter layout, so that each CUDA kernel and its
plain version give the same 32-bit words.

Counter layout. A draw call has a key (k0, k1), the run's seed, and a
64-bit call index `counter` that the caller never reuses under one key.
Block `i` of sub-stream `s` of that call encrypts the counter words
(i, s, counter mod 2^32, counter div 2^32) and yields four words:

- normals (stream 0): block i gives elements 4i..4i+3 by paired
  Box-Muller, (r cos t, r sin t) from words (0, 1) and from words (2, 3);
- bits (stream 0): block i gives elements 4i..4i+3, the words themselves
  (uniforms: those words mapped to (0, 1]);
- gamma draws (`gamma`, the plain version of the gamma kernel): walker
  4i + j's Marsaglia-Tsang round r takes normal j of block i of call
  counter + 2r and word j of block i of call counter + 2r + 1, its boost
  word j of block i of call counter + 12, all on stream 0; the first
  accepted round wins (`gamma_counters`);
- mutation draws: the (R, N, d) proposal normals as above on stream 0;
  walker n's Marsaglia-Tsang round r (0..5) on stream 1 + r from words
  (0, 1, 2) = (normal u1, normal u2, acceptance u), cos-only as in
  pallas_prng.py:194-214; its boost uniform and its Metropolis uniform
  from words 0 and 1 of stream 7.

All 32-bit word arithmetic runs in int64 and is masked to 32 bits: torch
has no unsigned 64-bit product, so the 32x32 high product is split into
16-bit halves. Words map to floats in (0, 1] as `_unit_open_closed`
(pallas_prng.py:67-74) does: the top 23 bits spliced into the mantissa of
[1, 2), subtracted from 2.

Float64 (`uniform_f64`, `normal_f64`, `gamma_f64`, `mutation_draws_f64`;
JAX draws float64 from threefry, `hw_prng_supported` at pallas_prng.py:46-48,
so these have no TPU counterpart). A double takes a pair of words: words
(0, 1) and (2, 3) of a block give two doubles in (0, 1],
u = (k + 1) 2^-53 with k = ((w0 >> 5) << 26) | (w1 >> 6), 53 bits, in
exact integer arithmetic (`unit53`): all-zero words give 2^-53, all-one
words 1.0. The counter layout, on the same key and call index as above:

- uniforms (stream 0): block i gives elements 2i, 2i + 1;
- normals (stream 0): block i gives elements 2i, 2i + 1 by paired
  Box-Muller in double, (r cos t, r sin t) of its two doubles;
- gamma draws (`gamma_f64`): walker 2i + j's round r (0..MT_ROUNDS_F64 - 1)
  takes normal j of block i of call counter + 2r and uniform j of block i
  of call counter + 2r + 1, its boost uniform j of block i of call
  counter + 2 MT_ROUNDS_F64, all on stream 0 (GAMMA_CALLS_F64 calls);
- mutation draws (`mutation_draws_f64`): the (R, N, d) proposal normals
  as above on stream 0; walker n's round r on stream 1 + 2r (its normal,
  cos-only, from the block's two doubles) and stream 2 + 2r (its
  acceptance uniform, the block's first double); its boost uniform and
  its Metropolis uniform the two doubles of stream 1 + 2 MT_ROUNDS_F64.

JAX's float64 gamma is an exact rejection loop with no round cap
(jax.random.gamma), so float64 takes MT_ROUNDS_F64 = 16 rounds, not
float32's 6: at alpha >= 1 (alpha < 1 is boosted to alpha + 1) a round
accepts with probability at least 0.95, so a draw no round accepts has
probability below 0.05^16 = 1.5e-21; it keeps d = a_eff - 1/3, as float32's
does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

MASK32 = 0xFFFFFFFF
# Random123 philox.h: the multipliers and the Weyl key increments.
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
PHILOX_ROUNDS = 10

TWO_PI = 6.283185307179586  # pallas_prng.py:42
MT_ROUNDS = 6  # pallas_prng.py:43: Marsaglia-Tsang rounds, unrolled
STREAM_NORMAL = 0
STREAM_BITS = 0
STREAM_GAMMA_ROUND0 = 1  # rounds use streams 1..6
STREAM_BOOST_ACCEPT = 1 + MT_ROUNDS
GAMMA_CALLS = 2 * MT_ROUNDS + 1  # call indices one `hw_gamma` uses
# Float64: the rounds of a gamma draw (no float32 cap; see above), the call
# indices one float64 `hw_gamma` uses, and the stream of a float64 mutation
# step's boost and Metropolis uniforms (its rounds on streams 1..32).
MT_ROUNDS_F64 = 16
GAMMA_CALLS_F64 = 2 * MT_ROUNDS_F64 + 1
STREAM_BOOST_ACCEPT_F64 = 1 + 2 * MT_ROUNDS_F64
TWO_POW_M53 = 2.0**-53

Key = Tuple[int, int]


def key_from_seed(seed: int) -> Key:
    """The two 32-bit key words of a non-negative integer seed."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return seed & MASK32, (seed >> 32) & MASK32


# The key of the step draws of `draws.Draws` (hardware_prng off): the seed's
# words encrypted under this key, so that seed s gives another key there than
# `key_from_seed(s)` gives `hardware_prng=True` ("DRAW" and "STEP" in ASCII).
DRAWS_KEY = (0x44524157, 0x53544550)


def draws_key(seed: int) -> Key:
    """The key of the keyed MCMC step draws of a run seeded `seed` with
    `hardware_prng` off: words 0 and 1 of the Philox block (seed_lo,
    seed_hi, 0, 0) under `DRAWS_KEY`."""
    lo, hi = key_from_seed(seed)
    words = philox4x32(*(torch.tensor([w], dtype=torch.int64) for w in (lo, hi, 0, 0)),
                       DRAWS_KEY)
    return int(words[0]), int(words[1])


def _mulhilo(m: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product m * b, for b in [0, 2^32)."""
    p_lo = m * (b & 0xFFFF)  # < 2^48
    p_hi = m * (b >> 16)  # < 2^48
    q = p_hi + (p_lo >> 16)  # m * b == q * 2^16 + (p_lo mod 2^16)
    return q >> 16, ((q & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32(
    c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor, c3: torch.Tensor, key: Key
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Philox4x32-10 of int64 counter words in [0, 2^32); four int64 words out."""
    k0, k1 = key
    for r in range(PHILOX_ROUNDS):
        if r > 0:
            k0, k1 = (k0 + PHILOX_W0) & MASK32, (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _blocks(n_blocks: int, stream: int, counter: int, key: Key, device):
    """The four words of blocks 0..n_blocks-1 of one stream of one call."""
    idx = torch.arange(n_blocks, dtype=torch.int64, device=device)

    def word(v):
        return torch.full_like(idx, v)

    hi, lo = (counter >> 32) & MASK32, counter & MASK32
    return philox4x32(idx, word(stream), word(lo), word(hi), key)


def unit_open_closed(words: torch.Tensor) -> torch.Tensor:
    """32-bit words (int64 in [0, 2^32), or int32 bit patterns) -> float32
    in (0, 1] (pallas_prng.py:67-74); `& 0x7FFFFF` makes `>> 9` logical."""
    mantissa = ((words >> 9) & 0x7FFFFF) | 0x3F800000
    return 2.0 - mantissa.to(torch.int32).view(torch.float32)


def as_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> the int32 tensor with the same bits."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def _box_muller(wa: torch.Tensor, wb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    r = torch.sqrt(-2.0 * torch.log(unit_open_closed(wa)))
    theta = TWO_PI * unit_open_closed(wb)
    return r * torch.cos(theta), r * torch.sin(theta)


def normal(key: Key, counter: int, total: int, device) -> torch.Tensor:
    """(total,) float32 standard normals by paired Box-Muller (kernel 3)."""
    w0, w1, w2, w3 = _blocks(-(-total // 4), STREAM_NORMAL, counter, key, device)
    z0, z1 = _box_muller(w0, w1)
    z2, z3 = _box_muller(w2, w3)
    return torch.stack([z0, z1, z2, z3], dim=1).reshape(-1)[:total]


def bits(key: Key, counter: int, total: int, device) -> torch.Tensor:
    """(total,) raw 32-bit words as int32 bit patterns (kernel 4)."""
    words = torch.stack(_blocks(-(-total // 4), STREAM_BITS, counter, key, device), dim=1)
    return as_int32_bits(words.reshape(-1)[:total])


def uniform(key: Key, counter: int, total: int, device) -> torch.Tensor:
    """(total,) float32 uniforms in (0, 1]: the words of `bits` mapped by
    `unit_open_closed` (the bits kernel's uniform mode)."""
    return unit_open_closed(bits(key, counter, total, device))


def gamma_calls(dtype) -> int:
    """The call indices one gamma draw of `dtype` uses."""
    return GAMMA_CALLS_F64 if dtype == torch.float64 else GAMMA_CALLS


def unit53(wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """Two 32-bit words (int64 in [0, 2^32)) -> float64 in (0, 1]:
    (k + 1) 2^-53 with k = ((wa >> 5) << 26) | (wb >> 6), exact."""
    k = ((wa >> 5) << 26) | (wb >> 6)
    return (k + 1).to(torch.float64) * TWO_POW_M53


def _box_muller_f64(ua: torch.Tensor, ub: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    r = torch.sqrt(-2.0 * torch.log(ua))
    theta = TWO_PI * ub
    return r * torch.cos(theta), r * torch.sin(theta)


def uniform_f64(key: Key, counter: int, total: int, device) -> torch.Tensor:
    """(total,) float64 uniforms in (0, 1], two a block (53 bits each)."""
    w0, w1, w2, w3 = _blocks(-(-total // 2), STREAM_BITS, counter, key, device)
    return torch.stack([unit53(w0, w1), unit53(w2, w3)], dim=1).reshape(-1)[:total]


def normal_f64(key: Key, counter: int, total: int, device) -> torch.Tensor:
    """(total,) float64 standard normals by paired Box-Muller, two a block."""
    w0, w1, w2, w3 = _blocks(-(-total // 2), STREAM_NORMAL, counter, key, device)
    z0, z1 = _box_muller_f64(unit53(w0, w1), unit53(w2, w3))
    return torch.stack([z0, z1], dim=1).reshape(-1)[:total]


def mt_setup(alpha: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(boost, d, c) of Marsaglia-Tsang for gamma(alpha, 1): alpha < 1 is
    boosted to alpha + 1, d = a_eff - 1/3 and c = 1 / sqrt(9 d)."""
    boost = alpha < 1.0
    a_eff = torch.where(boost, alpha + 1.0, alpha)
    d = a_eff - 1.0 / 3.0
    return boost, d, 1.0 / torch.sqrt(9.0 * d)


def mt_accept(
    z: torch.Tensor, u: torch.Tensor, d: torch.Tensor, c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Marsaglia-Tsang round on normals z and uniforms u: (accepted,
    the proposal d v)."""
    one_cz = 1.0 + c * z
    v = one_cz * one_cz * one_cz
    floor = 1e-300 if v.dtype == torch.float64 else 1e-30
    ok = (v > 0.0) & (
        torch.log(u) < 0.5 * z * z + d - d * v + d * torch.log(torch.clamp(v, min=floor))
    )
    return ok, d * v


def marsaglia_tsang(
    alpha: torch.Tensor,
    normals: Sequence[torch.Tensor],
    uniforms: Sequence[torch.Tensor],
    boost_uniform: torch.Tensor,
) -> torch.Tensor:
    """gamma(alpha, 1) from explicit draws, as `hw_gamma` (pallas_prng.py:284-307).

    normals, uniforms: one tensor of alpha's shape per round; the first
    accepted round wins, and a draw no round accepts keeps d = a_eff - 1/3.
    alpha < 1 is boosted: gamma(a) = gamma(a + 1) * U^(1/a).
    """
    boost, d, c = mt_setup(alpha)
    res = d
    accepted = torch.zeros_like(boost)
    for z, u in zip(normals, uniforms):
        ok, proposal = mt_accept(z, u, d, c)
        res = torch.where(ok & ~accepted, proposal, res)
        accepted = accepted | ok
    scale = boost_uniform ** (1.0 / torch.clamp(alpha, min=1e-12))
    return res * torch.where(boost, scale, torch.ones_like(scale))


def gamma_counters(counter: int, rounds: int = MT_ROUNDS
                   ) -> Tuple[Tuple[int, ...], Tuple[int, ...], int]:
    """The call indices `hw_gamma` uses from `counter` on: the normals of
    round r at counter + 2r, its uniforms at counter + 2r + 1, the boost
    uniforms at counter + 2 rounds (the fold_in pattern of
    pallas_prng.py:294-305). 2 rounds + 1 calls in all; float64 takes
    MT_ROUNDS_F64 rounds."""
    normals = tuple(counter + 2 * r for r in range(rounds))
    uniforms = tuple(counter + 2 * r + 1 for r in range(rounds))
    return normals, uniforms, counter + 2 * rounds


def gamma(key: Key, counter: int, alpha: torch.Tensor) -> torch.Tensor:
    """The plain version of the gamma kernel (`cuda_prng.hw_gamma`):
    Marsaglia-Tsang on `normal` and `bits` draws of calls counter ..
    counter + 12. It evaluates every round; the kernel stops a walker at its
    first accepted round, which gives the same value."""
    n, dev = alpha.numel(), alpha.device
    zc, uc, bc = gamma_counters(counter)
    normals = [normal(key, c, n, dev).reshape(alpha.shape) for c in zc]
    uniforms = [unit_open_closed(bits(key, c, n, dev)).reshape(alpha.shape) for c in uc]
    boost = unit_open_closed(bits(key, bc, n, dev)).reshape(alpha.shape)
    return marsaglia_tsang(alpha, normals, uniforms, boost)


def mutation_draws(
    key: Key, counter: int, alpha: torch.Tensor, z_shape: Tuple[int, int, int]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All draws of one tpCN step (kernel 2): z (R, N, d) proposal normals,
    g (N,) gamma(alpha) mixture draws and (N,) acceptance uniforms."""
    total = z_shape[0] * z_shape[1] * z_shape[2]
    n, dev = alpha.shape[0], alpha.device
    z = normal(key, counter, total, dev).reshape(z_shape)
    normals, uniforms = [], []
    for r in range(MT_ROUNDS):
        w0, w1, w2, _ = _blocks(n, STREAM_GAMMA_ROUND0 + r, counter, key, dev)
        u1, u2 = unit_open_closed(w0), unit_open_closed(w1)
        normals.append(torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI * u2))
        uniforms.append(unit_open_closed(w2))
    wb, wa, _, _ = _blocks(n, STREAM_BOOST_ACCEPT, counter, key, dev)
    g = marsaglia_tsang(alpha, normals, uniforms, unit_open_closed(wb))
    return z, g, unit_open_closed(wa)


def gamma_f64(key: Key, counter: int, alpha: torch.Tensor) -> torch.Tensor:
    """The plain version of the float64 gamma kernel: Marsaglia-Tsang in
    double on `normal_f64` and `uniform_f64` draws of calls counter ..
    counter + 32, MT_ROUNDS_F64 rounds (a draw no round accepts, below
    1.5e-21 of them, keeps d). It evaluates every round; the kernel stops
    a walker at its first accepted round, which gives the same value."""
    n, dev = alpha.numel(), alpha.device
    zc, uc, bc = gamma_counters(counter, MT_ROUNDS_F64)
    normals = [normal_f64(key, c, n, dev).reshape(alpha.shape) for c in zc]
    uniforms = [uniform_f64(key, c, n, dev).reshape(alpha.shape) for c in uc]
    boost = uniform_f64(key, bc, n, dev).reshape(alpha.shape)
    return marsaglia_tsang(alpha, normals, uniforms, boost)


def mutation_draws_f64(
    key: Key, counter: int, alpha: torch.Tensor, z_shape: Tuple[int, int, int]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`mutation_draws` in float64: z (R, N, d) proposal normals, g (N,)
    gamma(alpha) draws over MT_ROUNDS_F64 rounds and (N,) acceptance
    uniforms, in the float64 layout of the module docstring."""
    total = z_shape[0] * z_shape[1] * z_shape[2]
    n, dev = alpha.shape[0], alpha.device
    z = normal_f64(key, counter, total, dev).reshape(z_shape)
    normals, uniforms = [], []
    for r in range(MT_ROUNDS_F64):
        w0, w1, w2, w3 = _blocks(n, STREAM_GAMMA_ROUND0 + 2 * r, counter, key, dev)
        u1, u2 = unit53(w0, w1), unit53(w2, w3)
        normals.append(torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI * u2))
        a0, a1, _, _ = _blocks(n, STREAM_GAMMA_ROUND0 + 2 * r + 1, counter, key, dev)
        uniforms.append(unit53(a0, a1))
    w0, w1, w2, w3 = _blocks(n, STREAM_BOOST_ACCEPT_F64, counter, key, dev)
    g = marsaglia_tsang(alpha, normals, uniforms, unit53(w0, w1))
    return z, g, unit53(w2, w3)
