"""Owen-scrambled Sobol' sampling for the 5D camera sample.

Port of ``tpu_ray/core/qmc.py``: the same direction numbers, the same
hash-based Owen scrambles (Burley, JCGT 2020) and the same 24-bit
quantisation, so every draw is bit-equal to the JAX package's on the same
(slot, sample index, salt).  ``Camera.sampler`` selects it: ``"sobol"``
draws the pixel jitter from dims 1-2 and the lens disk and shutter time
from dims 3-5 of one scrambled Sobol' point per (slot, sample);
``"sobol-b0"`` does the same and, on the work queue, also takes the
first bounce's light and cosine scatter draws from dims 7-10
(:func:`bounce0_uniforms`).

The sequence index is the PLAIN global sample index: XORing the salt into
it (as the hash path does) would permute the sample order and break the
stratification of each pixel's prefix; the salt goes into the scrambles.

These are the plain twins of the device functions in ``csrc/qmc.cuh``.  As
in :mod:`tpu_ray_torch.core.rng`, torch's CPU ``uint32`` lacks ``>>`` and
``+``, so the tensors here are int64 holding values in [0, 2^32), masked
after every step; the kernels use native ``uint32_t``.
"""
from __future__ import annotations

import numpy as np
import torch

from .rng import C1 as _MIX1
from .rng import C2 as _MIX2
from .rng import GOLD, M32, _mul32, as_u32
from .rng import fmix as _fmix

__all__ = ["bitrev32", "sobol_bits", "sobol2_bits", "owen_scramble",
           "pixel_uniforms", "lens_time_uniforms", "bounce0_uniforms"]


def _sobol2_dirs() -> list[int]:
    """Sobol' dimension 2 (primitive polynomial x + 1, m_k = 1):
    v_0 = 2^31, v_{k+1} = v_k ^ (v_k >> 1)."""
    v, out = 1 << 31, []
    for _ in range(32):
        out.append(v)
        v ^= v >> 1
    return out


def _sobol_dirs(s: int, a: int, m_init: list[int]) -> list[int]:
    """32 direction numbers from a degree-``s`` primitive polynomial
    (Joe & Kuo 2008, eq. 1; ``a`` packs the middle coefficients, bit s-2
    is a_1; ``m_init`` the first ``s`` odd initial values)."""
    m = list(m_init)
    for k in range(s, 32):
        mk = (1 << s) * m[k - s] ^ m[k - s]
        for j in range(1, s):
            if (a >> (s - 1 - j)) & 1:
                mk ^= (1 << j) * m[k - j]
        m.append(mk)
    for k, mk in enumerate(m):
        if not (mk % 2 == 1 and mk < (1 << (k + 1))):
            raise ValueError(f"bad Sobol' initial values at {k}: {mk}")
    return [(mk << (31 - k)) & M32 for k, mk in enumerate(m)]


# dims 2-5: the pixel's second axis, lens radius and angle, shutter time
# (Joe & Kuo new-joe-kuo-6.21201 for dims 3-5); dims 6-10: the first-bounce
# scatter draws of the sobol-b0 probe sampler
_SOBOL2_V = _sobol2_dirs()
_SOBOL3_V = _sobol_dirs(2, 1, [1, 3])
_SOBOL4_V = _sobol_dirs(3, 1, [1, 3, 1])
_SOBOL5_V = _sobol_dirs(3, 2, [1, 1, 1])
_SOBOL6_V = _sobol_dirs(4, 1, [1, 1, 3, 3])
_SOBOL7_V = _sobol_dirs(4, 4, [1, 3, 5, 13])
_SOBOL8_V = _sobol_dirs(5, 2, [1, 1, 5, 5, 17])
_SOBOL9_V = _sobol_dirs(5, 4, [1, 1, 5, 5, 5])
_SOBOL10_V = _sobol_dirs(5, 7, [1, 1, 7, 11, 19])
# the direction tables the kernels hold (csrc/qmc.cuh SOBOL_V and
# SOBOL_B0_V, in order)
DEVICE_DIRS = (_SOBOL2_V, _SOBOL3_V, _SOBOL4_V, _SOBOL5_V)
DEVICE_B0_DIRS = (_SOBOL6_V, _SOBOL7_V, _SOBOL8_V, _SOBOL9_V, _SOBOL10_V)
_SCALE = float(np.float32(1.0 / (1 << 24)))


def _u32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return as_u32(x)
    return torch.as_tensor(int(x) & M32, dtype=torch.int64)


def bitrev32(x: torch.Tensor) -> torch.Tensor:
    """Reverse the bits of each uint32: the base-2 radical inverse (van der
    Corput) of the index as a 0.32 fixed-point fraction."""
    x = _u32(x)
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & M32


def sobol_bits(i: torch.Tensor, dirs) -> torch.Tensor:
    """Sobol' value of index ``i`` in one dimension, as 0.32 fixed point:
    the XOR of the direction numbers chosen by the set bits of ``i``."""
    i = _u32(i)
    r = torch.zeros_like(i)
    for k, v in enumerate(dirs):
        r = r ^ (((i >> k) & 1) * v)
    return r


def sobol2_bits(i: torch.Tensor) -> torch.Tensor:
    """Sobol' dimension-2 value of index ``i`` as 0.32 fixed point."""
    return sobol_bits(i, _SOBOL2_V)


def owen_scramble(v: torch.Tensor, seed) -> torch.Tensor:
    """Hash-based Owen scramble of a 0.32 fixed-point Sobol' value
    (Laine-Karras construction on the bit-reversed value; every multiply
    wraps mod 2^32)."""
    seed = _u32(seed)
    x = bitrev32(v)
    x = x ^ _mul32(x, 0x3D20ADEA)
    x = (x + seed) & M32
    x = _mul32(x, (seed >> 16) | 1)
    x = x ^ _mul32(x, 0x05526C56)
    x = x ^ _mul32(x, 0x53A22864)
    return bitrev32(x)


def _to_unit(x: torch.Tensor) -> torch.Tensor:
    """24-bit quantisation: a float32 on the 2^-24 grid in [0, 1)."""
    return (x >> 8).to(torch.float32) * _SCALE


def _seed0(slot, salt) -> torch.Tensor:
    return _fmix((_u32(slot) + GOLD) & M32) ^ _mul32(_u32(salt), _MIX1)


def pixel_uniforms(slot, sidx, salt) -> tuple:
    """The Owen-scrambled (0,2)-Sobol' pixel jitter pair of (slot, plain
    global sample index) under the render's camera salt: two float32
    tensors in [0, 1)."""
    sidx = _u32(sidx)
    sx = _seed0(slot, salt)
    sy = _fmix(sx ^ _MIX2)
    x = owen_scramble(bitrev32(sidx), sx)
    y = owen_scramble(sobol2_bits(sidx), sy)
    return _to_unit(x), _to_unit(y)


def lens_time_uniforms(slot, sidx, salt) -> tuple:
    """Sobol' dims 3-5 of (slot, sample index), Owen-scrambled: the lens
    radius and angle and the shutter-time draws.  The scramble seeds go on
    from :func:`pixel_uniforms`' chain."""
    sidx = _u32(sidx)
    sx = _seed0(slot, salt)
    sy = _fmix(sx ^ _MIX2)
    sr = _fmix((sy + GOLD) & M32)
    sp = _fmix(sr ^ _MIX1)
    st = _fmix((sp + _MIX2) & M32)
    return tuple(_to_unit(owen_scramble(sobol_bits(sidx, d), s))
                 for d, s in ((_SOBOL3_V, sr), (_SOBOL4_V, sp),
                              (_SOBOL5_V, st)))


def bounce0_uniforms(slot, sidx, salt) -> tuple:
    """Sobol' dims 6-10 of (slot, sample index), Owen-scrambled: the
    first-bounce scatter draws of the ``sobol-b0`` sampler on the work
    queue (the queue's step kernel draws dims 7-10 as ``csrc/qmc.cuh::
    sobol_bounce0``; dim 6, the mixture coin, stays hashed).  Five float32
    tensors in [0, 1)."""
    sidx = _u32(sidx)
    s = _seed0(slot, salt)
    for _ in range(4):       # past the five camera-dim seeds
        s = _fmix((s + GOLD) & M32)
    seeds = []
    for _ in range(5):
        s = _fmix(s ^ _MIX2)
        seeds.append(s)
    return tuple(_to_unit(owen_scramble(sobol_bits(sidx, d), sd))
                 for d, sd in zip(DEVICE_B0_DIRS, seeds))
