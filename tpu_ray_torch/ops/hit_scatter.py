"""Hit record and material scatter of a wavefront: the CUDA kernel and its
plain twin.

``csrc/pool_step.cu::hit_scatter_kernel`` replaces the TPU kernel
``tpu_ray/ops/shade_pallas.py::_shade_kernel`` (launched by
``hit_scatter_pallas``), the drop-in for ``ops/intersect.py::_hit_record``
+ ``ops/scatter.py::scatter`` + ``ops/lights.py``: from the sweep's
``(best_t, best_i)`` it rebuilds the hit record (point, normal, front face,
texture uv, material) and scatters (next direction, throughput weight,
emitted radiance, scattered flag) with the ``lane_uniforms`` stream of
``(key words, lane id)``.  :func:`hit_scatter` launches it for CUDA
tensors; :func:`hit_scatter_plain` is the same function in plain PyTorch
(the shade core of :mod:`tpu_ray_torch.ops.shade`), used for CPU tensors
and as the reference the kernel is held to.

Layout: structure of arrays, one column per lane, like the pool state -
``rays`` is (7, R) (origin, direction, time) and every vector field of the
result is (3, R).  ``direction`` and ``weight`` are defined where the lane
hit and scattered; elsewhere the kernel and the plain version may differ
(the plain version selects among every branch like the JAX code, the
kernel runs only the lane's own material).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..core.rng import M32
from .build import load_fn
from .shade import StepConfig, _params, _shade, table_ptrs, texture_ptrs

# roofline numerators per lane: 40 B read (7 ray rows, best_t, best_i, lane
# id) + 75 B written (17 float rows, 3 flag bytes, the material index);
# operations as the pool step's shade part
BYTES_PER_LANE = 115
OPS_PER_LANE = 350
N_FOUT = 17


@dataclass
class HitRecord:
    hit: torch.Tensor      # (R,) bool
    t: torch.Tensor        # (R,)
    point: torch.Tensor    # (3, R) world space
    normal: torch.Tensor   # (3, R) flipped against the ray
    front: torch.Tensor    # (R,) bool
    u: torch.Tensor        # (R,) texture coordinates (0 on scenes
    v: torch.Tensor        # (R,)  without image textures)
    mat: torch.Tensor      # (R,) int32 material index
    prim: torch.Tensor     # (R,) int32


@dataclass
class ScatterResult:
    direction: torch.Tensor  # (3, R) next ray direction
    weight: torch.Tensor     # (3, R) throughput multiplier
    emitted: torch.Tensor    # (3, R) radiance if the path ends here
    scattered: torch.Tensor  # (R,) bool; False -> the path ends (emissive)


def _check(cfg, rays, best_t, best_i, lane_ids):
    R = rays.shape[1] if rays.dim() == 2 else -1
    want = ((rays, (7, R), torch.float32), (best_t, (R,), torch.float32),
            (best_i, (R,), torch.int32), (lane_ids, (R,), torch.int32))
    for x, shape, dtype in want:
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"hit_scatter: expected {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous() or x.device != rays.device:
            raise ValueError("hit_scatter: inputs must be contiguous and on "
                             "one device")
    if cfg.tab.device != rays.device:
        raise ValueError("hit_scatter: scene tables are on another device")


def hit_scatter_plain(cfg: StepConfig, rays, best_t, best_i, kd, lane_ids):
    """Plain-PyTorch ``_hit_record`` + ``scatter``: (HitRecord,
    ScatterResult) of every lane.  ``kd``: the scatter key's two words;
    ``lane_ids``: (R,) int32 holding the uint32 ids that key the draws."""
    _check(cfg, rays, best_t, best_i, lane_ids)
    hit_scatter_plain.calls += 1
    kd = (int(kd[0]) & M32, int(kd[1]) & M32)
    s = _shade(cfg, (rays[0], rays[1], rays[2]), (rays[3], rays[4], rays[5]),
               rays[6], best_t, best_i, lane_ids, kd)
    rec = HitRecord(hit=s["hit"], t=best_t, point=torch.stack(s["point"]),
                    normal=torch.stack(s["normal"]), front=s["front"],
                    u=s["u"], v=s["v"], mat=s["mat"], prim=best_i)
    res = ScatterResult(direction=torch.stack(s["direction"]),
                        weight=torch.stack(s["weight"]),
                        emitted=torch.stack(s["emitted"]),
                        scattered=s["scattered"])
    return rec, res


hit_scatter_plain.calls = 0


def hit_scatter(cfg: StepConfig, rays, best_t, best_i, kd, lane_ids):
    """Hit record + scatter: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns (HitRecord, ScatterResult)."""
    if not rays.is_cuda:
        return hit_scatter_plain(cfg, rays, best_t, best_i, kd, lane_ids)
    _check(cfg, rays, best_t, best_i, lane_ids)
    fn = load_fn("pool_step", "tr_hit_scatter",
                 [ctypes.c_void_p] * 18 + [ctypes.c_longlong, ctypes.c_void_p])
    R = rays.shape[1]
    f = torch.empty((N_FOUT, R), dtype=torch.float32, device=rays.device)
    flags = torch.empty((3, R), dtype=torch.bool, device=rays.device)
    mat = torch.empty((R,), dtype=torch.int32, device=rays.device)
    params = _params(cfg, kd, False)
    err = fn(rays.data_ptr(), best_t.data_ptr(), best_i.data_ptr(),
             lane_ids.data_ptr(), *table_ptrs(cfg), *texture_ptrs(cfg),
             params.ctypes.data,
             f.data_ptr(), flags.data_ptr(), mat.data_ptr(), R,
             torch.cuda.current_stream(rays.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hit-scatter kernel launch failed (cudaError "
                           f"{err})")
    hit_scatter.launches += 1
    rec = HitRecord(hit=flags[0], t=best_t, point=f[0:3], normal=f[3:6],
                    front=flags[1], u=f[6], v=f[7], mat=mat, prim=best_i)
    res = ScatterResult(direction=f[8:11], weight=f[11:14], emitted=f[14:17],
                        scattered=flags[2])
    return rec, res


hit_scatter.launches = 0
