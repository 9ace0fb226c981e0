"""Counter-based RNG: the murmur3 lane streams and a numpy threefry2x32.

Port of ``tpu_ray/core/rng.py``.  Every pool draw is a pure function of
(key words, slot id, column), so the streams here are bit-equal to the JAX
package's on the same inputs.

torch has only partial ``uint32`` arithmetic (``>>`` and ``+`` raise on the
CPU), so the tensor streams compute in int64 holding values in [0, 2^32)
and mask after every step.  32x32-bit products are split into 16-bit
halves so no intermediate leaves int64's range.  The CUDA kernels use
native ``uint32_t`` and agree bit for bit.

The per-iteration key words come from ``jax.random``'s threefry2x32
``PRNGKey`` / ``fold_in`` / ``key_data``, re-implemented in numpy below:
the renderer precomputes each wave's (iter_cap, 2) key-word tables on the
host (the same trick as the JAX megakernel's key table).
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
GOLD = 0x9E3779B9
C1 = 0x85EBCA6B
C2 = 0xC2B2AE35
TWO_PI = float(np.float32(2.0 * np.pi))


# --- numpy threefry2x32 (jax.random's default PRNG) --------------------------

def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """20-round threefry2x32 of counter words (x0, x1) under key (k0, k1);
    all arguments broadcast as uint32 arrays."""
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
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: words (0, seed)."""
    return np.array([0, int(seed) & M32], np.uint32)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in``: key (..., 2) with data broadcast -> (..., 2).

    Vectorised over ``data`` so a wave's whole per-iteration chain is one
    call."""
    key = np.asarray(key, np.uint32)
    data = np.asarray(data, np.uint32)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], np.zeros_like(data),
                          data)
    return np.stack([y0, y1], axis=-1)


def key_data(key: np.ndarray) -> np.ndarray:
    """``jax.random.key_data`` of a raw uint32 key: the two words."""
    return np.asarray(key, np.uint32)


def split(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.split(key, n)`` (partitionable threefry, JAX's default):
    key i is the cipher of the 64-bit counter i, so it equals
    ``fold_in(key, i)``.  Returns (n, 2) uint32."""
    return fold_in(key, np.arange(n, dtype=np.uint32))


def pool_key_tables(k_loop: np.ndarray, n_iters: int):
    """Per-iteration key words of the pool loop: (isect, scatter), each
    (n_iters, 2) uint32 = key_data(fold_in(fold_in(k_loop, it), 0 / 1))."""
    kb = fold_in(k_loop, np.arange(n_iters, dtype=np.uint32))
    return fold_in(kb, 0), fold_in(kb, 1)


# --- murmur3 lane streams on tensors (int64 holding uint32) ------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def fmix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer (``_murmur3_fmix``): full-avalanche 32-bit mix."""
    x = x ^ (x >> 16)
    x = _mul32(x, C1)
    x = x ^ (x >> 13)
    x = _mul32(x, C2)
    return x ^ (x >> 16)


def _rotl_t(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def uniform(key: np.ndarray, shape, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32, bit-equal: element i
    (row-major) takes the 20-round threefry2x32 of the 64-bit counter i
    under ``key``, xors the two output words and keeps the top 23 bits as
    the mantissa.  Runs on ``device`` in int64 holding uint32 words."""
    n = int(np.prod(shape))
    if n >= 1 << 32:
        raise ValueError("uniform: more than 2^32 draws under one key")
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = torch.full((n,), ks[0], dtype=torch.int64, device=device)
    x1 = (torch.arange(n, dtype=torch.int64, device=device) + ks[1]) & M32
    rots = ((13, 15, 26, 6), (17, 29, 16, 24))
    for i in range(5):
        for r in rots[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl_t(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    bits = x0 ^ x1
    return ((bits >> 9).to(torch.float32) * (1.0 / (1 << 23))).reshape(shape)


def as_u32(x) -> torch.Tensor:
    """An int tensor (int32 bit patterns or int64 values) as int64 in
    [0, 2^32)."""
    return x.to(torch.int64) & M32


def hash_col(base: torch.Tensor, i: int) -> torch.Tensor:
    """Column ``i`` of :func:`hash_uniforms`: one U[0,1) float32 per lane."""
    salt = (GOLD * (i + 1)) & M32
    bits = fmix(fmix((base + salt) & M32) ^ salt)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def hash_uniforms(seed: torch.Tensor, n: int) -> torch.Tensor:
    """n decorrelated U[0,1) floats per uint32 seed: (R,) -> (R, n)."""
    seed = as_u32(seed)
    return torch.stack([hash_col(seed, i) for i in range(n)], dim=-1)


def hash2_base(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Base word of :func:`hash_uniforms2`'s 2-word counter (a, b)."""
    return fmix((as_u32(a) + GOLD) & M32) ^ _mul32(as_u32(b), C1)


def hash_uniforms2(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """n U[0,1) floats keyed by a 2-word counter: ((R,), (R,)) -> (R, n)."""
    return hash_uniforms(hash2_base(a, b), n)


def lane_base(kd, lane_ids: torch.Tensor) -> torch.Tensor:
    """Stream base of :func:`lane_uniforms` for key words ``kd`` (2,)."""
    k0, k1 = int(kd[0]), int(kd[1])
    return fmix((as_u32(lane_ids) + k0) & M32) ^ k1


def lane_uniforms(kd, lane_ids: torch.Tensor, n: int) -> torch.Tensor:
    """n U[0,1) floats per lane keyed by (key words, lane id): (R,) -> (R, n)."""
    return hash_uniforms(lane_base(kd, lane_ids), n)


def lane_uniform_col(kd, lane_ids: torch.Tensor, i: int) -> torch.Tensor:
    """Column ``i`` of :func:`lane_uniforms` alone."""
    return hash_col(lane_base(kd, lane_ids), i)


def path_ids(work: torch.Tensor, bounce: torch.Tensor) -> torch.Tensor:
    """Schedule-independent draw ids for (work item, bounce), as int64."""
    return hash2_base(work, bounce)
