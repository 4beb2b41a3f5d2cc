"""JAX's default PRNG, threefry2x32, bit for bit in plain PyTorch.

The serving sampler, rank mode 'random' in the forward and in the segment
decision draw their randomness through ``jax.random`` in the reference
(``PRNGKey``, ``fold_in``, ``split``, ``uniform``, ``gumbel``,
``randint``). This module gives the same bits, so a seeded stream of the
port is the reference's stream. It follows JAX with
``jax_threefry_partitionable`` on (the default since JAX 0.5): a key's
draws of shape ``shape`` hash the counters ``(i >> 32, i & 0xFFFFFFFF)`` of
the row-major index ``i`` and xor the two output words; ``split`` keeps
both output words as the new key; ``fold_in`` hashes the counter pair
``(0, data)``.

A key is an integer tensor of shape (..., 2) holding two uint32 words; the
leading dimensions batch independent keys (one per serving slot). uint32
words live in ``int64`` tensors masked with 0xFFFFFFFF, since PyTorch has
no unsigned 32-bit arithmetic. Everything is integer code except the last
float steps of ``uniform`` (exact) and ``gumbel`` (two ``log``s, which may
differ from XLA's by an ulp), so the card gives the CPU's bits.

Only what the port's sampler and rank modes draw is here: no normal,
categorical or permutation draws.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1)
    under the key words (k1, k2); all int64 tensors of uint32 values,
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _words(key: torch.Tensor):
    key = key.long()
    return key[..., 0], key[..., 1]


def key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**32): the word
    pair (0, seed). ``seed`` may be an integer tensor of seeds (one key
    each, stacked on the last axis)."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device) & MASK  # inv-ok-torch[R1]: the serving step's device seeds pass through uncopied; the segment decision's key(17) is built on the host
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    (0, data as uint32). ``data`` broadcasts against the key's batch."""
    k1, k2 = _words(key)
    d = torch.as_tensor(data, dtype=torch.int64, device=k1.device) & MASK  # inv-ok-torch[R1]: the serving step's device output positions pass through uncopied; the segment decision folds host ints into a host key
    x0, x1 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack([x0, x1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (..., num, 2), key j the hash of
    the counter pair (0, j)."""
    k1, k2 = _words(key)
    j = torch.arange(num, dtype=torch.int64, device=k1.device)
    x0, x1 = threefry2x32(k1[..., None], k2[..., None], torch.zeros_like(j), j)
    return torch.stack([x0, x1], dim=-1)


def bits32(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (int64 values in [0, 2**32)), shape
    (*key batch, *shape): ``jax.random.bits(key, shape, uint32)``."""
    shape = tuple(int(s) for s in shape)
    k1, k2 = _words(key)
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=k1.device)
    x0, x1 = threefry2x32(k1[..., None], k2[..., None], i >> 32, i & MASK)
    return (x0 ^ x1).reshape((*k1.shape, *shape))


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 uniform draws in [minval, maxval): the top 23 bits as the
    mantissa of a float in [1, 2), minus 1, scaled, floored at minval
    (``jax.random.uniform``). XLA fuses the scaling ``f * (hi - lo) + lo``
    into one f32 FMA; here the product is exact in f64 and the sum rounds
    once there before the f32 rounding, which matches the FMA except at a
    double-rounding tie (the default [0, 1) and gumbel's [tiny, 1) scale
    by exactly 1 and are always exact)."""
    b = bits32(key, shape)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # fills on the device, not host tensors copied over (a copy would
    # sync inside the serving step); both round the bound to f32 once
    lo = torch.full((), minval, dtype=torch.float32, device=f.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=f.device)
    scaled = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Standard Gumbel draws, f32: -log(-log(u)) with u uniform in
    [tiny, 1) (``jax.random.gumbel``, mode 'low')."""
    return -torch.log(-torch.log(uniform(key, shape, F32_TINY, 1.0)))


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """int32 draws in [minval, maxval) (``jax.random.randint``): two
    32-bit draws through ``split``, combined modulo the span as
    ``(hi % span) * (2**32 % span) + lo % span``, in uint32 arithmetic."""
    k = split(key)
    hi, lo = bits32(k[..., 0, :], shape), bits32(k[..., 1, :], shape)
    span = maxval - minval if maxval > minval else 1
    mult = ((2 ** 16 % span) ** 2) % span
    off = (((hi % span) * mult) & MASK) + lo % span
    off = (off & MASK) % span
    return (minval + off).to(torch.int32)
