"""The estimator's random streams, written out again from their definition.

Two families, both pure functions of their inputs:

* the per-wave and per-render key words: ``jax.random``'s threefry2x32
  ``PRNGKey`` / ``fold_in`` (20 rounds, partitionable split), in numpy;
* the per-lane draws: the murmur3 finalizer over (key words, lane id) or
  over a two-word counter, whose top 24 bits make a uniform in [0, 1).

Tensors hold uint32 values in int64 and are masked after every step, so
the arithmetic is the same on the CPU and on the card.  Nothing here is
taken from the program under test.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
GOLD = 0x9E3779B9
C1 = 0x85EBCA6B
C2 = 0xC2B2AE35


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """20-round threefry2x32 of counter words (x0, x1) under key (k0, k1)."""
    with np.errstate(over="ignore"):
        k0 = np.asarray(k0, np.uint32)
        k1 = np.asarray(k1, np.uint32)
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        rots = ((13, 15, 26, 6), (17, 29, 16, 24))
        for i in range(5):
            for r in rots[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``PRNGKey(seed)`` of the low 32 bits of ``seed``: words (0, seed)."""
    return np.array([0, int(seed) & M32], np.uint32)


def fold_in(key, data) -> np.ndarray:
    """``fold_in(key, data)``, vectorised over ``data``: (..., 2) uint32."""
    key = np.asarray(key, np.uint32)
    data = np.asarray(data, np.uint32)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], np.zeros_like(data), data)
    return np.stack([y0, y1], axis=-1)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), in 16-bit halves of c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def fmix(x: torch.Tensor) -> torch.Tensor:
    """The murmur3 32-bit finalizer."""
    x = x ^ (x >> 16)
    x = mul32(x, C1)
    x = x ^ (x >> 13)
    x = mul32(x, C2)
    return x ^ (x >> 16)


def u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor as int64 holding its low 32 bits, unsigned."""
    return x.to(torch.int64) & M32


def col(base: torch.Tensor, i: int, dt=torch.float32) -> torch.Tensor:
    """Uniform number ``i`` of the stream with base word ``base``."""
    salt = (GOLD * (i + 1)) & M32
    bits = fmix(fmix((base + salt) & M32) ^ salt)
    return (bits >> 8).to(dt) * (1.0 / (1 << 24))


def pair_base(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Base word of the stream of the two-word counter (a, b)."""
    return fmix((u32(a) + GOLD) & M32) ^ mul32(u32(b), C1)


def lane_base(kd, ids: torch.Tensor) -> torch.Tensor:
    """Base word of the stream of key words ``kd`` and lane id ``ids``."""
    return fmix((u32(ids) + int(kd[0])) & M32) ^ int(kd[1])
