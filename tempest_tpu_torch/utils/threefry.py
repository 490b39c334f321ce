"""The few `jax.random` values the port needs bit for bit, in plain Python.

The JAX package seeds its hierarchical clustering with the fixed key
`PRNGKey(42)` (tempest_tpu/fused.py:133-134), and the mixture facades with
`key(random_state)` (tempest_tpu/cluster.py:504, :1110). The only
randomness of a fit is one k-means++ uniform per component and EM start:
`uniform(split(start_key, K)[k], ())` (cluster.py:83-98), where a start's
key is the fit key itself with one start and `split(key, n_init)[i]` with
more (:272-274). This module reproduces them with integer arithmetic, so
the port's fits agree with JAX value for value: Threefry-2x32 with 20
rounds (Salmon et al. 2011, as jax._src.prng.threefry2x32), `split` and
`uniform` as JAX computes them with `jax_threefry_partitionable` on (the
default of JAX 0.5 and later). A float64 uniform (JAX with x64, whose
default float is float64) is made from 64 random bits, the float32 one
from 32.
"""

from __future__ import annotations

import struct
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


def uniform(key: Key, bits: int = 32) -> float:
    """`jax.random.uniform(key, ())` of a float of `bits` bits, 32 or 64: the
    mantissa of a float in [1, 2) from the random bits of block 0, minus 1
    (exact in that float). 32 bits are the xor of the block's two words; 64
    are the first word above the second (jax._src.prng, partitionable)."""
    b0, b1 = threefry2x32(key, (0, 0))
    if bits == 32:
        one_two = struct.unpack("<f", struct.pack("<I", ((b0 ^ b1) >> 9) | 0x3F800000))[0]
    elif bits == 64:
        word = (b0 << 32) | b1
        one_two = struct.unpack("<d", struct.pack("<Q", (word >> 12) | 0x3FF0000000000000))[0]
    else:
        raise ValueError(f"uniform takes 32 or 64 bits, not {bits}")
    return one_two - 1.0


def kmeanspp_uniforms(key: Key, n_init: int, n_components: int, bits: int = 32):
    """(n_init, n_components) k-means++ uniforms of one fit:
    `uniform(split(start_key_i, K)[k])` (cluster.py:83-98), where the start
    key is the fit key itself for one start and `split(key, n_init)[i]` for
    more (:272-274)."""
    starts = [key] if n_init <= 1 else split(key, n_init)
    return [[uniform(k, bits) for k in split(start, n_components)] for start in starts]
