"""Batched 3-vector math on ``(..., 3)`` tensors.

Port of ``tpu_ray/core/vec.py``: every quantity is a trailing-axis-3 tensor
so a whole wavefront of rays is one value.  ``take_rows`` is a plain
indexed load here (the JAX package's one-hot contraction was a TPU gather
workaround).
"""
from __future__ import annotations

import torch

__all__ = [
    "sqrt_rn",
    "cbrt_rn",
    "dot",
    "cross",
    "length",
    "squared_length",
    "normalize",
    "where3",
    "reflect",
    "refract",
    "onb_from_w",
    "onb_local",
    "take_rows",
]


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The IEEE square root of a float32 tensor, rounded to nearest, as
    ``jnp.sqrt`` and the CUDA kernels' ``sqrtf`` give it.  ``torch.sqrt`` on
    the CPU calls a vector library whose float32 result is not correctly
    rounded (1 ulp off on ~0.6% of inputs); the float64 root rounded to
    float32 is the correctly rounded float32 root (the double rounding of a
    square root is harmless).  On the card ``torch.sqrt`` is already
    correctly rounded (``sqrt.rn.f32``; ``chip_smoke.py`` holds the two
    equal) and is taken as is, so no conversion launches are added there.
    Other dtypes take ``torch.sqrt``."""
    if x.dtype != torch.float32 or x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def cbrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The float32 cube root rounded to nearest: the float64 root rounded
    once to float32, as the kernels compute it (``(float)cbrt((double)x)``).
    torch has no ``cbrt``, and a float32 ``pow(x, 1/3)`` is not the cube
    root (1/3 is not a float32, and ``pow`` rounds on its own), so the root
    is taken in float64 on either device, where the error of ``1/3`` and of
    ``pow`` lies far below a float32 ulp."""
    d = x.double()
    return (torch.sign(d) * d.abs().pow(1.0 / 3.0)).to(x.dtype)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product over the trailing axis, summed x + y + z in order."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def squared_length(a: torch.Tensor) -> torch.Tensor:
    return dot(a, a)


def length(a: torch.Tensor) -> torch.Tensor:
    return sqrt_rn(squared_length(a))


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Unit vector; zero vectors map to zero instead of NaN."""
    n2 = squared_length(a)
    inv = torch.where(n2 > 0.0, 1.0 / sqrt_rn(torch.clamp(n2, min=1e-30)),
                      torch.zeros_like(n2))
    return a * inv[..., None]


def where3(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.where`` with a rank-(n-1) mask broadcast over the vector axis."""
    return torch.where(mask[..., None], a, b)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: torch.Tensor, n: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """Snell refraction of a *unit* direction."""
    cos_theta = dot(-uv, n)
    r_par = ratio[..., None] * (uv + cos_theta[..., None] * n)
    k = torch.clamp(1.0 - squared_length(r_par), min=0.0)
    return r_par + (-sqrt_rn(k))[..., None] * n


def onb_from_w(n: torch.Tensor):
    """Orthonormal basis (u, v, w) whose w-axis is ``unit(n)``."""
    w = normalize(n)
    pick = (torch.abs(w[..., 0]) > 0.9)[..., None]
    e_y = torch.tensor([0.0, 1.0, 0.0], dtype=w.dtype, device=w.device)
    e_x = torch.tensor([1.0, 0.0, 0.0], dtype=w.dtype, device=w.device)
    a = torch.where(pick, e_y, e_x)
    v = normalize(cross(w, a))
    return cross(w, v), v, w


def onb_local(uvw, x: torch.Tensor) -> torch.Tensor:
    u, v, w = uvw
    return x[..., 0:1] * u + x[..., 1:2] * v + x[..., 2:3] * w


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (rows of a small table per lane)."""
    return table[idx.to(torch.int64)]
