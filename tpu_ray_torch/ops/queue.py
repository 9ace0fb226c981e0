"""The work queue's bookkeeping around the sweep and the step: path ids,
flush and inject.

Port of the queue iteration of ``tpu_ray/integrator.py::_queue_body``
outside its kernels: the draw ids of (work item, bounce) (``path_ids``,
:686), the flush of the lanes that died (:764) and the inject of fresh
work into free lanes (:794-849: frontier ranks, the work map, the camera
draw ``hash_uniforms2`` or Sobol', the camera ray, the lane reset).  The
JAX package runs them inside the ``lax.while_loop`` of its queue epoch;
here :func:`path_ids` and :func:`queue_inject` launch the CUDA kernels of
``csrc/queue.cu`` for CUDA tensors (one and two launches), and their plain
twins :func:`path_ids_plain` and :func:`queue_inject_plain`, int64 torch
on the CPU, run for CPU tensors.  Kernel and twin agree bit for bit: the
kernel ranks free lanes in lane order (``cumsum(free) - 1``), which
decides which lane takes which work item.

Work ids are int64 (``work + id0`` passes 2^32 at large sample offsets,
``total`` may pass 2^31); the draw ids hash their low 32 bits, as JAX's
uint32 add wraps.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import rng
from ..core.vec import sqrt_rn
from .build import load_fn
from .shade import StepConfig, camera_uniforms

# Worklist packing (adaptive sampling): one item per entry, the pixel id in
# the high bits and the pixel's ABSOLUTE sample index in the low
# WL_SAMP_BITS, as in the JAX package.  Entries are uint32 values held in
# int64, because CPU torch has no ``>>`` for uint32.  The adaptive loop
# checks the bounds: at most 2^18 pixels and 2^14 - 1 samples a pixel.
WL_SAMP_BITS = 14
WL_SAMP_MASK = (1 << WL_SAMP_BITS) - 1
# lanes a block of the inject kernels (csrc/queue.cu QUEUE_THREADS)
QUEUE_THREADS = 1024
# operations of the flush and inject (csrc/queue.cu's bound), each hash
# word operation, cos, sin and root counted as one: a lane's rank and
# flush test; a refilled lane's work map, camera draw (the murmur3 pair
# hash, or the Sobol' point's 32-step direction loop and Owen scrambles)
# and camera ray
INJECT_LANE_OPS = 12
INJECT_REFILL_OPS = {"hash": 170, "sobol": 430}


def inject_ops(m: int, refilled: int, sobol: bool) -> int:
    """Operations of one flush and inject over ``m`` lanes of which
    ``refilled`` take new work, for the kernels' bound."""
    return m * INJECT_LANE_OPS + refilled * INJECT_REFILL_OPS[
        "sobol" if sobol else "hash"]


def render_words(k_isect, k_scat, cam_salt: int, id0: int,
                 gs0: int) -> np.ndarray:
    """The words of one work-queue render that its iterations read besides
    their tensors, as the 32-byte block ``RenderWords`` of
    csrc/shade_core.cuh (four int64): the intersect and scatter key words,
    the camera salt, the path ids' first work id and the first global
    sample ``work_base // (W * H)``.  A render replayed from CUDA graphs
    (``integrator.QueuePlan``) copies it to the device before its first
    replay, and its kernels read it there (their ``words`` argument)."""
    w = np.zeros(8, np.uint32)
    w[0:2] = [int(k) & rng.M32 for k in k_isect]
    w[2:4] = [int(k) & rng.M32 for k in k_scat]
    w[4] = int(cam_salt) & rng.M32
    w[5] = int(id0) & rng.M32
    w.view(np.int64)[3] = int(gs0)
    return w.view(np.int64)


def _words_ptr(words, dev):
    """The device pointer of a render's word block (None: no block)."""
    if words is None:
        return None
    _check("the render words", ((words, (4,), torch.int64),), dev)
    return words.data_ptr()


def _to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 with the same low 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def path_ids_plain(work: torch.Tensor, id0: int, bounce: torch.Tensor):
    """Draw ids (m,) int32 bits of (work item ``work + id0``, bounce):
    ``rng.path_ids`` of the low 32 bits."""
    path_ids_plain.calls += 1
    return _to_i32_bits(rng.path_ids(work + id0, bounce))


path_ids_plain.calls = 0


def _check(what, tensors, dev):
    """Each (tensor, shape, dtype) is contiguous, of that shape and type,
    on the CUDA device ``dev``; raises otherwise."""
    if dev.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors on one device")
    for x, shape, dtype in tensors:
        if tuple(x.shape) != shape or x.dtype != dtype \
                or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{what}: expected a contiguous {shape} {dtype} "
                             f"on {dev}, got {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}")


def path_ids(work: torch.Tensor, id0: int, bounce: torch.Tensor,
             words: torch.Tensor | None = None):
    """:func:`path_ids_plain`: the CUDA kernel for CUDA tensors (one
    launch), the plain twin for CPU tensors.  ``work``: (m,) int64 work
    items; ``id0``: the first global work id; ``bounce``: (m,) int32;
    ``words``: a render's block (:func:`render_words`) on the card, whose
    ``id0`` the kernel reads instead (the twin takes ``id0``)."""
    if not work.is_cuda:
        return path_ids_plain(work, id0, bounce)
    return path_ids_launch(work, id0, bounce, words)


path_ids.launches = 0


def path_ids_launch(work: torch.Tensor, id0: int, bounce: torch.Tensor,
                    words: torch.Tensor | None = None):
    """The path-ids kernel on CUDA tensors, one launch; counts into
    ``path_ids.launches``."""
    m = work.shape[0]
    _check("the path-ids kernel", ((work, (m,), torch.int64),
                                   (bounce, (m,), torch.int32)), work.device)
    fn = load_fn("queue", "tr_path_ids", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
    sid = torch.empty((m,), dtype=torch.int32, device=work.device)
    stream = torch.cuda.current_stream(work.device).cuda_stream
    err = fn(work.data_ptr(), bounce.data_ptr(), int(id0) & rng.M32,
             _words_ptr(words, work.device), m, sid.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"path-ids kernel launch failed (cudaError {err})")
    path_ids.launches += 1
    return sid


def queue_inject_plain(cfg: StepConfig, cam_salt: int, active0, f, i, work,
                       frontier, plane, lane, worklist, total: int,
                       work_base: int, width: int, height: int, census=None):
    """Flush the lanes that died and inject fresh work into the free ones.

    ``active0``: (m,) int32 active flags before the step; ``f`` (13, m) and
    ``i`` (3, m): the step's outputs, updated in place; ``work`` (m,) and
    ``frontier`` () int64; ``plane`` (3, pad + 1): a dying lane writes its
    radiance into column ``work`` in place (lanes that did not die write
    the last column); ``lane`` (2, m) int32 or None: the sobol-b0 (pixel,
    global sample) record; ``worklist`` (Wl,) int64 or None.  Free lanes
    take the next work items in lane order; item w is pixel ``w % P`` at
    global sample ``work_base // P + w // P`` (P = W x H), or the
    worklist's entry.  ``census`` (() int64 or None) gains, in place, the
    lanes left active: the next iteration's rays.  Returns (f, i, work,
    frontier, lane), the last three new tensors."""
    queue_inject_plain.calls += 1
    # flush: each work item dies exactly once, so its radiance is written
    died = (active0 > 0) & (i[2] == 0)
    plane.index_copy_(1, torch.where(died, work, plane.shape[1] - 1),
                      f[10:13])

    # inject: free lanes take the next work items off the frontier
    free = i[2] == 0
    ranks = torch.cumsum(free.to(torch.int64), dim=0) - 1
    w_new = frontier + torch.where(free, ranks, 0)
    valid = free & (w_new < total)
    P = width * height
    if worklist is None:
        pix = torch.where(valid, w_new % P, 0)
        gsample = ((work_base // P) + torch.where(valid, w_new // P, 0)
                   ) & rng.M32
    else:
        packed = worklist[torch.where(valid, w_new, 0)]
        pix = torch.where(valid, packed >> WL_SAMP_BITS, 0)
        gsample = torch.where(valid, packed & WL_SAMP_MASK, 0)
    # camera stream keyed by (pixel, global sample), the pool regen's draws
    # with the pixel id as the slot word (hashed, or the Sobol' point of the
    # plain global sample)
    u0, u1, u2, u3, u4 = camera_uniforms(cfg.sobol, pix, gsample,
                                         cam_salt & rng.M32)
    sx = ((pix % width).to(torch.float32) + u0) * cfg.inv_w
    sy = ((height - 1 - pix // width).to(torch.float32) + u1) * cfg.inv_h
    cam = [float(c) for c in cfg.cam]
    r = cam[18] * sqrt_rn(u2)
    phi = rng.TWO_PI * u3
    rc, rs = r * torch.cos(phi), r * torch.sin(phi)
    off = [rc * cam[12 + a] + rs * cam[15 + a] for a in range(3)]
    t_new = cam[19] + float(np.float32(cam[20]) - np.float32(cam[19])) * u4
    new = torch.stack(
        [cam[a] + off[a] for a in range(3)]
        + [cam[3 + a] + sx * cam[6 + a] + sy * cam[9 + a] - cam[a] - off[a]
           for a in range(3)] + [t_new])
    f[0:7] = torch.where(valid, new, f[0:7])
    f[7:10] = torch.where(valid, 1.0, f[7:10])
    f[10:13] = torch.where(valid, 0.0, f[10:13])
    i[0] = torch.where(valid, 0, i[0])
    i[2] = (~free | valid).to(torch.int32)
    frontier = torch.clamp(frontier + free.sum(), max=total)
    if census is not None:
        census.add_(i[2].sum())
    if cfg.b0:
        lane = torch.where(valid, torch.stack([_to_i32_bits(pix),
                                               _to_i32_bits(gsample)]), lane)
    return f, i, torch.where(valid, w_new, work), frontier, lane


queue_inject_plain.calls = 0


def queue_inject(cfg: StepConfig, cam_salt: int, active0, f, i, work,
                 frontier, plane, lane, worklist, total: int, work_base: int,
                 width: int, height: int, census=None, out=None, words=None):
    """:func:`queue_inject_plain`: the CUDA kernels for CUDA tensors (a
    count pass and the inject pass; ``f``, ``i``, ``plane`` and ``census``
    in place, the new work, frontier and lane record in fresh tensors; the
    trash column of ``plane`` is not written), the plain twin for CPU
    tensors.  ``out``: (work, frontier, lane) buffers, other than the
    inputs, that take the kernels' new work, frontier and lane record
    instead (lane None where ``cfg.b0`` is off; the twin returns fresh
    tensors); ``words``: a render's block
    (:func:`render_words`) on the card, whose camera salt and first global
    sample the kernel reads instead of ``cam_salt`` and ``work_base`` (the
    twin takes the arguments)."""
    if not f.is_cuda:
        return queue_inject_plain(cfg, cam_salt, active0, f, i, work,
                                  frontier, plane, lane, worklist, total,
                                  work_base, width, height, census)
    return queue_inject_launch(cfg, cam_salt, active0, f, i, work, frontier,
                               plane, lane, worklist, total, work_base,
                               width, height, census, out, words)


queue_inject.launches = 0


def queue_inject_launch(cfg: StepConfig, cam_salt: int, active0, f, i, work,
                        frontier, plane, lane, worklist, total: int,
                        work_base: int, width: int, height: int, census=None,
                        out=None, words=None):
    """The count and inject kernels on CUDA tensors, two launches; counts
    one into ``queue_inject.launches``."""
    dev = f.device
    m = work.shape[0]
    want = [(active0, (m,), torch.int32), (f, (13, m), torch.float32),
            (i, (3, m), torch.int32), (work, (m,), torch.int64),
            (frontier, (), torch.int64),
            (plane, (3, plane.shape[1]), torch.float32)]
    if cfg.b0:
        if lane is None:
            raise ValueError("queue inject: the sobol-b0 queue needs the "
                             "lanes' (pixel, global sample) record")
        want.append((lane, (2, m), torch.int32))
    if worklist is not None:
        want.append((worklist, (worklist.shape[0],), torch.int64))
    if census is not None:
        want.append((census, (), torch.int64))
    _check("the queue inject kernels", want, dev)
    if width * height <= 0 or plane.shape[1] < 1:
        raise ValueError("queue inject: an empty image or plane")
    fn = load_fn("queue", "tr_queue_inject", [ctypes.c_void_p] * 14 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p])
    counts = torch.empty((max(-(-m // QUEUE_THREADS), 1),), dtype=torch.int32,
                         device=dev)
    if out is None:
        work_out = torch.empty_like(work)
        frontier_out = torch.empty_like(frontier)
        lane_out = torch.empty_like(lane) if cfg.b0 else lane
    else:
        work_out, frontier_out, lane_out = out
        got = [(work_out, (m,), torch.int64), (frontier_out, (), torch.int64)]
        if cfg.b0:
            got.append((lane_out, (2, m), torch.int32))
        _check("the queue inject kernels' outputs", got, dev)
        if frontier_out.data_ptr() == frontier.data_ptr():
            raise ValueError("queue inject: the new frontier needs a buffer "
                             "of its own (block 0 writes it while the "
                             "others read the old one)")
    cam = np.ascontiguousarray(cfg.cam, np.float32)
    err = fn(active0.data_ptr(), f.data_ptr(), i.data_ptr(), work.data_ptr(),
             frontier.data_ptr(), plane.data_ptr(),
             lane.data_ptr() if cfg.b0 else None,
             None if worklist is None else worklist.data_ptr(),
             counts.data_ptr(), work_out.data_ptr(), frontier_out.data_ptr(),
             lane_out.data_ptr() if cfg.b0 else None,
             None if census is None else census.data_ptr(), cam.ctypes.data,
             cfg.inv_w, cfg.inv_h, int(total), int(work_base), width, height,
             int(cam_salt) & rng.M32, int(cfg.sobol), int(cfg.b0), m,
             plane.shape[1], _words_ptr(words, dev),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"queue inject kernels launch failed (cudaError "
                           f"{err})")
    queue_inject.launches += 1
    return f, i, work_out, frontier_out, lane_out
