"""Counter-based random bits with ``jax.random``'s semantics, in PyTorch.

A reproduction of the JAX package's loss patterns: ``models/errdo.py`` draws
them with ``jax.random`` (``PRNGKey``, ``split``, ``bernoulli``) under the
default ``threefry2x32`` implementation with ``jax_threefry_partitionable``
on.  The same key gives the same bits here as there, so a seeded channel
simulation loses the same macroblocks in both packages.

Keys are pairs of Python ints (the two uint32 words of a JAX raw key).  The
uint32 arithmetic of Threefry-2x32 (Salmon et al., SC'11; 20 rounds) runs in
int64 tensors masked to 32 bits, on any device.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 of the counter pairs (``x0``, ``x1``), int64 tensors of
    uint32 values, under ``key`` = (k0, k1); returns the two output words."""
    k0, k1 = (int(k) & _M32 for k in key)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` for a seed that fits in 32 bits: the
    high word is 0 and the low word the seed's two's-complement bits."""
    return (0, int(seed) & _M32)


def _counters(n: int, device):
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & _M32


def split(key, num: int = 2) -> list:
    """``jax.random.split(key, num)``: ``num`` new keys."""
    hi, lo = _counters(num, "cpu")
    b0, b1 = threefry2x32(key, hi, lo)
    return [(int(a), int(b)) for a, b in zip(b0.tolist(), b1.tolist())]


def random_bits(key, shape, device) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as an int64 tensor."""
    n = int(np.prod(shape))
    b0, b1 = threefry2x32(key, *_counters(n, device))
    return (b0 ^ b1).reshape(tuple(shape))


def uniform(key, shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1) from the top 23
    bits of each word."""
    bits = random_bits(key, shape, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def bernoulli(key, p: float, shape, device) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: uniform < float32(p)."""
    p32 = torch.tensor(float(np.float32(p)), dtype=torch.float32,
                       device=device)
    return uniform(key, shape, device) < p32
