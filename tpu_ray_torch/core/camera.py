"""Thin-lens camera with defocus blur and shutter-time motion blur.

Port of ``tpu_ray/core/camera.py``.  The frame is computed in host numpy
float32 with the same operations, so its bits equal the JAX package's.
Ray directions are not normalized (the hit parameter t is in units of
|direction|).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .vec import sqrt_rn


@dataclass(frozen=True)
class Camera:
    origin: torch.Tensor        # (3,)
    lower_left: torch.Tensor    # (3,)
    horizontal: torch.Tensor    # (3,)
    vertical: torch.Tensor      # (3,)
    u: torch.Tensor             # (3,)
    v: torch.Tensor             # (3,)
    w: torch.Tensor             # (3,)
    lens_radius: torch.Tensor   # ()
    time0: torch.Tensor         # ()
    time1: torch.Tensor         # ()
    # image-plane sample generator; this port renders "uniform" only
    sampler: str = "uniform"

    @classmethod
    def create(cls, lookfrom, lookat, vup, vfov_deg: float, aspect: float,
               aperture: float, focus_dist: float, time0: float = 0.0,
               time1: float = 1.0) -> "Camera":
        """Precompute the camera frame: tan in float64 rounded once to
        float32, everything else IEEE float32 single ops."""
        f32 = np.float32
        lf = np.asarray(lookfrom, f32)
        la = np.asarray(lookat, f32)
        vu = np.asarray(vup, f32)
        theta = float(vfov_deg) * float(np.pi) / 180.0
        hh = f32(np.tan(theta / 2.0))
        hw = f32(aspect) * hh

        def norm(x):
            return x / f32(np.sqrt(f32(x @ x)))

        w = norm(lf - la)
        u = norm(np.cross(vu, w).astype(f32))
        v = np.cross(w, u).astype(f32)
        fd = f32(focus_dist)
        lower_left = lf - (hw * fd) * u - (hh * fd) * v - fd * w
        t = torch.from_numpy
        return cls(
            origin=t(lf.copy()),
            lower_left=t(lower_left),
            horizontal=t((f32(2.0) * hw * fd) * u),
            vertical=t((f32(2.0) * hh * fd) * v),
            u=t(u),
            v=t(v),
            w=t(w),
            lens_radius=t(np.asarray(f32(aperture / 2.0))),
            time0=t(np.asarray(f32(time0))),
            time1=t(np.asarray(f32(time1))),
        )

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Camera":
        """The camera with its tensors on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "sampler"})

    def vec(self) -> np.ndarray:
        """The 21 camera words of the pool-step kernel: origin, lower_left,
        horizontal, vertical, u, v, (lens_radius, time0, time1)."""
        parts = [self.origin, self.lower_left, self.horizontal,
                 self.vertical, self.u, self.v,
                 torch.stack([self.lens_radius, self.time0, self.time1])]
        return torch.cat([p.detach().cpu().reshape(-1) for p in parts]) \
            .numpy().astype(np.float32)

    def rays_from_uniforms(self, s: torch.Tensor, t: torch.Tensor,
                           u3: torch.Tensor):
        """``getRay`` from 3 pre-drawn uniforms per ray (lens disk r/phi,
        shutter time).  Returns (origin (R,3), direction (R,3), time (R,))."""
        r = self.lens_radius * sqrt_rn(u3[..., 0])
        phi = float(np.float32(2.0 * np.pi)) * u3[..., 1]
        offset = ((r * torch.cos(phi))[..., None] * self.u
                  + (r * torch.sin(phi))[..., None] * self.v)
        tm = self.time0 + (self.time1 - self.time0) * u3[..., 2]
        origin = self.origin + offset
        direction = (self.lower_left + s[..., None] * self.horizontal
                     + t[..., None] * self.vertical - self.origin - offset)
        return origin, direction, tm
