"""The few `jax.random` values the port needs bit for bit, in plain Python.

The JAX package seeds its hierarchical clustering with the fixed key
`PRNGKey(42)` (tempest_tpu/fused.py:133-134). With one EM start per leaf,
the only randomness of a fit is two k-means++ uniforms per leaf slot:
`uniform(split(split(PRNGKey(42), k_max)[i], 2)[j], ())`. This module
reproduces them with integer arithmetic, so the port's fit agrees with
JAX value for value: Threefry-2x32 with 20 rounds (Salmon et al. 2011, as
jax._src.prng.threefry2x32), `split` and `uniform` as JAX computes them
with `jax_threefry_partitionable` on (the default of JAX 0.5 and later).
"""

from __future__ import annotations

from typing import List, Tuple

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(key: Key, count: Tuple[int, int]) -> Tuple[int, int]:
    """Threefry-2x32, 20 rounds, of one 64-bit counter block."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0, x1 = (count[0] + ks[0]) & _MASK, (count[1] + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> Key:
    """`jax.random.PRNGKey(seed)` for a seed in [0, 2^64)."""
    return (seed >> 32) & _MASK, seed & _MASK


def split(key: Key, num: int) -> List[Key]:
    """`jax.random.split(key, num)`: key i encrypts the counter (0, i)."""
    return [threefry2x32(key, (i >> 32, i & _MASK)) for i in range(num)]


def uniform(key: Key) -> float:
    """`jax.random.uniform(key, ())` in float32: the mantissa of [1, 2) from
    the xor of the two words of block 0, minus 1."""
    import numpy as np

    b0, b1 = threefry2x32(key, (0, 0))
    bits = np.uint32(((b0 ^ b1) >> 9) | 0x3F800000)
    return float(bits.view(np.float32) - np.float32(1.0))
