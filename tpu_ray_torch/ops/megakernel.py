"""The whole-wave megakernel: one wave of the ray pool in one launch.

``csrc/megakernel.cu`` replaces the TPU kernel ``tpu_ray/ops/megakernel.py::
_kernel`` (launched by its ``trace_pool_mega``): per lane, the first camera
sample, then the loop { closest hit over every solid prim, free flight
through the constant media, hit record, textures, scatter with light MIS,
Russian roulette, accumulation, path death, regeneration } until the lane
has rendered its samples.  :func:`trace_pool_mega` launches it for CUDA
tensors; :func:`trace_pool_mega_plain` is the same wave as the uncompacted
pool loop on tensors (plain sweep, plain media, plain pool step), used for
CPU tensors and as the reference the card's kernel is held to.

Every draw is keyed by (slot id, sample) or (slot id, iteration), never by
lane position, so the megakernel, its plain version and the wavefront pool
(:func:`tpu_ray_torch.integrator.trace_pool_staged`) trace the same paths.
They differ in where radiance is summed: one running sum per lane here, a
sum across compaction levels there - agreement to reassociation, with equal
sample counts.

Scope (:func:`supported`, as the JAX package's): no image textures, no
checker with non-constant children, no strict mode, at most ``MAX_PRIMS``
prims (the kernel keeps the sweep's rows in shared memory).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import rng
from ..models.scene_data import SceneData
from .build import load_fn
from .intersect import INF, media_rows, merge_media_plain
from .shade import (N_FSTATE, N_ISTATE, StepConfig, _params, pool_step_plain,
                    table_ptrs)
from .sweep import _ranges, sweep_plain, sweep_table

MAX_PRIMS = 512
# roofline numerator: bytes per lane per wave (xy 8 + slot 4 in, radiance 12
# + sample count 4 out); the operations per lane-iteration are the sweep's
# per-pair counts (ops/sweep.py::FLOPS_PER_PAIR) over the solid prims plus
# the pool step's ops/shade.py::OPS_PER_LANE
BYTES_PER_LANE = 28


def supported(scene: SceneData) -> bool:
    """Scenes the megakernel can run (``megakernel.supported``)."""
    return (not scene.has_image and not scene.checker_fancy
            and not scene.strict and 0 < scene.n_prims <= MAX_PRIMS)


def key_table(k_loop, iter_cap: int) -> np.ndarray:
    """(iter_cap, 4) uint32 key words of a wave: columns 0:2 the scatter
    key ``fold_in(fold_in(k_loop, it), 1)``, 2:4 the intersect key
    ``fold_in(fold_in(k_loop, it), 0)``."""
    k_isect, k_scat = rng.pool_key_tables(np.asarray(k_loop, np.uint32),
                                          iter_cap)
    return np.ascontiguousarray(np.concatenate([k_scat, k_isect], axis=1))


def _check(scene, cfg, xy, slot):
    if not supported(scene):
        raise ValueError("scene outside the megakernel's scope (image "
                         "textures, strict mode or more than "
                         f"{MAX_PRIMS} prims)")
    R = slot.shape[0]
    for x, shape, dtype in ((xy, (2, R), torch.float32),
                            (slot, (R,), torch.int32)):
        if tuple(x.shape) != shape or x.dtype != dtype \
                or not x.is_contiguous() or x.device != slot.device:
            raise ValueError(f"megakernel: expected a contiguous {shape} "
                             f"{dtype} on one device")
    if cfg.tab.device != slot.device:
        raise ValueError("megakernel: scene tables are on another device")


def _empty_wave(cfg: StepConfig, R: int, dev):
    return (torch.zeros((3, R), dtype=torch.float32, device=dev),
            torch.full((R,), cfg.n_samples, dtype=torch.int32, device=dev))


def trace_pool_mega_plain(scene: SceneData, cfg: StepConfig, xy, slot,
                          k_loop, kern=None):
    """One wave as the uncompacted pool loop in plain PyTorch: every lane
    takes part in every iteration until none is active or the iteration cap
    ``n_samples * max_depth + max_depth`` is reached.  Arguments and result
    as :func:`trace_pool_mega`."""
    _check(scene, cfg, xy, slot)
    trace_pool_mega_plain.calls += 1
    R = slot.shape[0]
    dev = slot.device
    if cfg.max_depth <= 0:
        return _empty_wave(cfg, R, dev)
    geo = sweep_table(scene) if kern is None else kern.geo
    media = media_rows(scene) if kern is None else kern.media
    iter_cap = cfg.n_samples * cfg.max_depth + cfg.max_depth
    keys = key_table(k_loop, iter_cap)
    f = torch.zeros((N_FSTATE, R), dtype=torch.float32, device=dev)
    f[7:10] = 1.0
    i = torch.zeros((N_ISTATE, R), dtype=torch.int32, device=dev)
    none_t = torch.empty((R,), dtype=torch.float32, device=dev)
    none_i = torch.zeros((R,), dtype=torch.int32, device=dev)
    f, i = pool_step_plain(cfg, xy, slot, f, i, none_t, none_i, (0, 0),
                           init=True)
    it = 0
    while it < iter_cap and bool(i[2].any()):
        rays = f[:7]
        if scene.n_solid > 0:
            bt, bi = sweep_plain(rays, geo, _ranges(scene), scene.t_min)
        else:
            bt = torch.full((R,), INF, dtype=torch.float32, device=dev)
            bi = none_i
        if scene.has_media:
            bt, bi = merge_media_plain(scene, rays, keys[it, 2:4], slot,
                                       media, bt, bi)
        f, i = pool_step_plain(cfg, xy, slot, f, i, bt.contiguous(),
                               bi.to(torch.int32).contiguous(),
                               keys[it, 0:2])
        it += 1
    return f[10:13].contiguous(), i[1].contiguous()


trace_pool_mega_plain.calls = 0

_stats: dict = {}     # card index -> (2,) int64 that the kernel adds to


def _card(device) -> int:
    dev = torch.device(device)
    return torch.cuda.current_device() if dev.index is None else dev.index


def read_stats(device, reset: bool = True):
    """(lane-iterations, warp-iterations) the kernel has counted on
    ``device`` since the last reset: the iterations of all slots, and the
    loop trips of all warps (a trip in which any lane of the warp
    iterates).  Their ratio over 32 is the share of lane slots that did
    work.  Waits for the device."""
    st = _stats.get(_card(device))
    if st is None:
        return 0, 0
    lanes, warps = st.tolist()
    if reset:
        st.zero_()
    return lanes, warps


def persistent_threads(device) -> int:
    """Threads the card ``device`` holds at once in the megakernel
    (resident blocks per SM x SMs x block size, from the CUDA occupancy
    calculator): the persistent launch's thread count (cached)."""
    card = _card(device)
    n = _threads.get(card)
    if n is None:
        fn = load_fn("megakernel", "tr_megakernel_threads", [])
        fn.restype = ctypes.c_longlong
        with torch.cuda.device(card):
            n = int(fn())
        if n <= 0:
            raise RuntimeError("megakernel: the occupancy query failed")
        _threads[card] = n
    return n


_threads: dict = {}   # card index -> persistent thread count


def trace_pool_mega(scene: SceneData, cfg: StepConfig, xy, slot, k_loop,
                    kern=None):
    """Run one wave of the pool in one kernel: every slot renders
    ``cfg.n_samples`` samples starting at global sample ``cfg.sample0``,
    with loop key ``k_loop`` (numpy uint32[2]) - the arguments of
    :func:`tpu_ray_torch.integrator.trace_pool_staged`, and the same paths.

    ``xy``: (2, R) pixel-fraction bases; ``slot``: (R,) int32 global slot
    ids; ``kern``: the render's ``SceneKernels`` (only its prim table and
    media rows are read; built from the scene when omitted).  Returns
    (accum (3, R) summed radiance, samples done (R,) int32).  The CUDA
    kernel for CUDA tensors, launched persistent (:func:`persistent_threads`
    threads take the slots from a queue), the plain version for CPU
    tensors."""
    if not slot.is_cuda:
        return trace_pool_mega_plain(scene, cfg, xy, slot, k_loop, kern)
    return launch_mega(scene, cfg, xy, slot, k_loop, kern,
                       persistent_threads(slot.device))


trace_pool_mega.launches = 0


def launch_mega(scene: SceneData, cfg: StepConfig, xy, slot, k_loop, kern,
                threads: int):
    """The megakernel on CUDA tensors with ``threads`` threads (at most one
    per slot; whole blocks): fewer than the slots take them from a queue,
    one per slot runs each slot on its own thread.  Every thread count gives
    the same bits.  Arguments and result as :func:`trace_pool_mega`; counts
    into ``trace_pool_mega.launches``."""
    _check(scene, cfg, xy, slot)
    if not slot.is_cuda:
        raise ValueError("the megakernel takes CUDA tensors")
    R = slot.shape[0]
    dev = slot.device
    if cfg.max_depth <= 0:
        return _empty_wave(cfg, R, dev)
    geo = sweep_table(scene) if kern is None else kern.geo
    if not geo.is_cuda or not geo.is_contiguous() \
            or tuple(geo.shape) != (scene.n_solid, 16):
        raise ValueError("megakernel: the prim table must be a contiguous "
                         "(n_solid, 16) float32 on the lanes' device")
    iter_cap = cfg.n_samples * cfg.max_depth + cfg.max_depth
    keys = torch.from_numpy(key_table(k_loop, iter_cap).view(np.int32)).to(dev)
    stats = _stats.get(_card(dev))
    if stats is None:
        stats = _stats[_card(dev)] = torch.zeros((2,), dtype=torch.int64,
                                                 device=dev)
    nxt = torch.zeros((1,), dtype=torch.int64, device=dev)   # slot queue
    accum = torch.empty((3, R), dtype=torch.float32, device=dev)
    sample = torch.empty((R,), dtype=torch.int32, device=dev)
    fn = load_fn("megakernel", "tr_megakernel",
                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 13
                 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p])
    n_ss, n_s, n_sb, n_solid = _ranges(scene)
    params = _params(cfg, (0, 0), False)
    err = fn(xy.data_ptr(), slot.data_ptr(), geo.data_ptr(), n_ss, n_s, n_sb,
             n_solid, scene.n_prims, keys.data_ptr(), iter_cap,
             *table_ptrs(cfg), params.ctypes.data, accum.data_ptr(),
             sample.data_ptr(), stats.data_ptr(), nxt.data_ptr(), R,
             int(threads), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed (cudaError {err})")
    trace_pool_mega.launches += 1
    return accum, sample
