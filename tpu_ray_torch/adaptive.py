"""Adaptive sampling: per-pixel sample allocation driven by running
variance (``--adaptive TOL``; port of ``tpu_ray/adaptive.py``).

The quality contract changes from "spp samples everywhere" to "every
pixel's tone-mapped standard error <= TOL, within the budget": ``spp``
becomes the per-pixel cap.  Each round the host loop renders some samples of
the pixels still short of the target, folds the per-pixel radiance sums
and square sums into running float64 statistics on the host, and decides
the next round.  Two backends, picked like the uniform renderer's modes
(:func:`tpu_ray_torch.renderer.resolve_mode`):

- **queue** (:func:`_render_adaptive_queue`): each round is a packed
  worklist of (pixel, absolute sample) items, pixel-major in blocks of
  ``WL_QUANT``, expanded on the device from the compact per-pixel
  allocation and rendered by
  :func:`tpu_ray_torch.integrator.trace_queue` in worklist mode; the next
  allocation is about n * (err / tol)^2 per pixel.  Path draws are keyed
  by each item's position in the round's list, so one pixel allocated
  differently moves the draws of every pixel after it.
- **pool** (:func:`_render_adaptive_pool`): each round traces
  ``POOL_REPS`` replicate slots (slot id ``pixel + rep * P``) of every
  active pixel through the ray pool (or one megakernel launch per slab
  with ``engine="mega"``); all active pixels share one allocation, which
  doubles each round, and the variance of the replicate slot means is
  combined across rounds by inverse variance.

On a device mesh the queue backend renders, each round's worklist shared
out over the devices.  The CUDA kernels run on the card (the sweep and the
pool step, or the megakernel); the worklist expansion and the reductions
are torch on the render's device, the statistics numpy.  ``trace_queue``,
``trace_queue_wl_mesh`` and :func:`_pool_round` are looked up in this
module at call time.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from .core import rng
from .integrator import (WL_SAMP_BITS, WL_SAMP_MASK, SceneKernels,
                         trace_pool_mega, trace_pool_staged, trace_queue,
                         trace_queue_wl_mesh)
from .ops.shade import StepConfig
from .parallel import mesh as mesh_mod

# tone-map-space error floor: pixels darker than FLOOR**2 in linear RGB are
# judged against FLOOR, so black pixels don't demand infinite samples
DISPLAY_FLOOR = 0.05
# per-pixel allocations of the queue backend are multiples of WL_QUANT, the
# block of the blocked per-pixel reduction
WL_QUANT = 16
# per-round work cap: bounds the round's plane (12 bytes an item); over-
# demand spills into later rounds
ROUND_ITEMS = 32_000_000
# the JAX package's worklist shape buckets (its compiled programs are cached
# by shape).  On one device this port pads nothing: padding is inert, it
# keys no draw.  On a mesh the pad sets each device's shard of work ids, so
# the JAX package's pad rule is kept exactly (:func:`mesh_pad`)
PAD_LADDER = tuple((1 << 16) << (2 * i) for i in range(6))
# replicate slots per pixel on the pool backend: each round's variance
# estimate has POOL_REPS - 1 degrees of freedom
POOL_REPS = 8


def _round_sizes(n, s, s2, tol, spp_max, pilot_spp, round_cap):
    """Per-pixel extra samples for the next round (0 = converged or at the
    budget), and each pixel's tone-mapped standard error.

    Growth targets n * (err / tol)^2, the count at which the current
    variance estimate would meet ``tol``, but at least ``pilot_spp`` and at
    most ``round_cap`` a round."""
    nn = np.maximum(n, 1).astype(np.float64)[:, None]
    mean = s / nn
    # unbiased variance of the per-pixel MEAN, per channel
    var_mean = np.maximum(s2 / nn - mean * mean, 0.0) / np.maximum(
        nn - 1.0, 1.0)
    sigma_d = np.sqrt(var_mean) / (
        2.0 * np.sqrt(np.maximum(mean, DISPLAY_FLOOR**2)))
    err = sigma_d.max(axis=1)  # worst channel, tone-mapped space
    need = (err > tol) & (n < spp_max) & (n > 0)
    # n, pilot_spp, round_cap, spp_max are all multiples of WL_QUANT
    # (render_adaptive aligns them), so every bound below preserves that
    target = np.ceil(n * np.square(err / tol)).astype(np.int64)
    extra = np.clip(target - n, pilot_spp, round_cap)
    extra = -(-extra // WL_QUANT) * WL_QUANT
    extra = np.minimum(extra, spp_max - n)
    extra = np.where(need, extra, 0)
    total = int(extra.sum())
    if total > ROUND_ITEMS:
        scale = ROUND_ITEMS / total
        extra = np.where(
            need, np.maximum((extra * scale).astype(np.int64)
                             // WL_QUANT, 1) * WL_QUANT, 0)
    return extra.astype(np.int64), err


def _expand_worklist(idx, reps_q, base, nb: int, P: int):
    """From the compact per-pixel allocation (int64 tensors on one device:
    pixel ids ``idx``, ``WL_QUANT``-block counts ``reps_q``, first sample
    ``base``; zero-count rows allowed) build the (nb,) per-block pixel ids
    and the (nb * WL_QUANT,) packed entries on that device.  Blocks past
    the allocation get pixel id P (dropped by the blocked reduction; never
    dispatched)."""
    dev = idx.device
    K = idx.shape[0]
    b = torch.arange(nb, dtype=torch.int64, device=dev)
    if K == 0:
        block_pix = torch.full((nb,), P, dtype=torch.int64, device=dev)
        samp0 = torch.zeros_like(b)
    else:
        cumb = torch.cumsum(reps_q, 0)
        starts = cumb - reps_q
        k = torch.searchsorted(cumb, b, right=True)
        kc = torch.clamp(k, max=K - 1)
        valid = k < K
        block_pix = torch.where(valid, idx[kc], P)
        samp0 = torch.where(valid, base[kc] + (b - starts[kc]) * WL_QUANT, 0)
    q = torch.arange(WL_QUANT, dtype=torch.int64, device=dev)
    packed = (((block_pix << WL_SAMP_BITS) & rng.M32)[:, None]
              | (samp0[:, None] + q)) & rng.M32
    return packed.reshape(-1), block_pix


def _compact_alloc(extra: np.ndarray, n: np.ndarray, k_pad: int):
    """Host side of the worklist: (idx, reps_q, base) padded to k_pad rows
    (zero-count rows are inert in _expand_worklist)."""
    idx = np.nonzero(extra)[0]
    pad = (0, k_pad - idx.size)
    return (np.pad(idx.astype(np.int32), pad),
            np.pad((extra[idx] // WL_QUANT).astype(np.int32), pad),
            np.pad(n[idx].astype(np.int32), pad))


def _build_worklist(extra: np.ndarray, n: np.ndarray):
    """Host-side reference expansion (the tests' oracle for
    _expand_worklist): each pixel p repeated extra[p] times (a multiple of
    WL_QUANT, pixel-major) with absolute sample indices n[p], n[p]+1, ..."""
    idx = np.nonzero(extra)[0]
    reps = extra[idx]
    wl_pix = np.repeat(idx, reps)
    starts = np.repeat(np.cumsum(reps) - reps, reps)
    occ = np.arange(wl_pix.size, dtype=np.int64) - starts
    samp = n[wl_pix] + occ
    packed = ((wl_pix.astype(np.uint32) << np.uint32(WL_SAMP_BITS))
              | samp.astype(np.uint32))
    block_pix = np.repeat(idx, reps // WL_QUANT).astype(np.int32)
    return packed, block_pix


def jax_queue_lanes(n_prims: int, P: int, spp: int, rays_per_wave: int,
                    engine: str) -> int:
    """The lane count R of the JAX package's ``plan_queue`` for ``engine``
    (the resolved name): its lane cap above 512 prims
    (:func:`tpu_ray_torch.renderer.lane_cap`, which its pad rule reads),
    then ``max(1024, min(cap, P * spp))``."""
    from .renderer import lane_cap

    cap = lane_cap(n_prims, engine)
    cap = rays_per_wave if cap is None else min(rays_per_wave, cap)
    return max(1024, min(cap, P * spp))


def mesh_pad(n_work: int, R: int, D: int) -> int:
    """The worklist pad of a D-device round (``tpu_ray/adaptive.py:
    248-265``): at least the items, R lanes a device and one
    ``WL_QUANT`` block a device; the next ``PAD_LADDER`` bucket (else a
    whole number of blocks), rounded up to ``D * WL_QUANT``.  Device d's
    work ids start at ``d * pad / D``, so this rule decides which ids the
    round's items get."""
    unit = D * WL_QUANT
    floor = max(n_work, R * D, unit)
    pad = next((p for p in PAD_LADDER if p >= floor),
               -(-floor // WL_QUANT) * WL_QUANT)
    return -(-pad // unit) * unit


def render_adaptive(scene, camera, width: int, height: int, *,
                    spp_max: int = 1000, tol: float = 0.01,
                    max_depth: int = 50, seed: int = 1024,
                    rays_per_wave: int = 1 << 20, engine: str = "auto",
                    shade=None, mode: str = "auto", pilot_spp: int = 16,
                    round_cap: int = 512, max_rounds: int = 64,
                    rr_depth: int = 0, progress: bool = False,
                    return_spp: bool = False, mesh=None, device=None):
    """Render with per-pixel adaptive sampling; returns the (H, W, 3)
    float32 mean image (and the (H, W) int64 per-pixel sample counts if
    ``return_spp``).

    Every pixel receives between ``pilot_spp`` and ``spp_max`` samples;
    sampling stops per pixel once the standard error of its tone-mapped
    value (worst channel) is at most ``tol``.  ``mode``: "queue", "pool"
    or "auto"; "auto" is resolved by
    :func:`tpu_ray_torch.renderer.resolve_mode` (the queue above 512
    prims), and an explicit mode is kept, as in the JAX package.
    ``engine="mega"`` runs each pool slab as one megakernel launch.
    ``shade`` is accepted for the JAX signature; this port has one
    shading, the fused step.  Runs on the card unless ``device="cpu"``.

    With ``mesh`` (:func:`tpu_ray_torch.parallel.mesh.make_mesh`;
    ``device`` is not read) the queue backend renders, as in the JAX
    package (the worklist is what the mesh shares out): each round's
    worklist is padded by :func:`mesh_pad` and split over the devices
    (:func:`~tpu_ray_torch.integrator.trace_queue_wl_mesh`).  Every item
    draws what it draws on one device, so the statistics, the allocations
    and the image are the single-device queue backend's up to the f32 order
    of the per-round sum over devices.  ``scene`` may be a dict of its
    copies by device."""
    from .renderer import (resolve_device, resolve_engine,
                           resolve_mode)

    P = width * height
    if P > (1 << (32 - WL_SAMP_BITS)):
        raise ValueError(
            f"adaptive sampling supports up to {1 << (32 - WL_SAMP_BITS)} "
            f"pixels ({width}x{height} = {P}); render in slices")
    if spp_max > WL_SAMP_MASK:
        raise ValueError(
            f"adaptive sampling supports spp <= {WL_SAMP_MASK}")
    if mode not in ("auto", "pool", "queue"):
        raise ValueError(f"adaptive sampling runs mode 'auto', 'pool' or "
                         f"'queue', not {mode!r}")
    if mesh is not None:
        scenes = mesh_mod.replicate(scene, mesh)
        scene = scenes[mesh[0]]
    engine = resolve_engine(scene, engine)
    if mesh is None:
        if mode == "auto":
            # as the JAX package: an explicit "pool" or "queue" stays
            mode = resolve_mode(scene, "auto", engine, spp=spp_max)
        scene = scene.to(resolve_device(device))
        dev = scene.device
        scenes = {dev: scene}
    else:
        mode, dev = "queue", mesh[0]
    if camera.sampler == "sobol-b0" and mode == "pool":
        # the queue backend's rounds take the first-bounce override, as the
        # JAX package's do; the pool backend keeps hashed scatter draws
        print("tpu_ray_torch: sampler=sobol-b0's bounce-dim override only "
              "runs on the XLA work-queue path; the adaptive pool backend "
              "keeps the sobol camera dims with hashed scatter draws",
              file=sys.stderr)
    kerns = {}
    for d in mesh_mod.distinct(tuple(scenes)):
        with mesh_mod.device_guard(d):
            kerns[d] = SceneKernels.create(scenes[d], engine=engine)
    kw = dict(spp_max=spp_max, tol=tol, max_depth=max_depth, seed=seed,
              rays_per_wave=rays_per_wave, engine=engine,
              pilot_spp=pilot_spp, round_cap=round_cap,
              max_rounds=max_rounds, rr_depth=rr_depth, progress=progress)
    if mode == "pool":
        s, n = _render_adaptive_pool(scenes[dev], camera, width, height,
                                     kern=kerns[dev], **kw)
    else:
        s, n = _render_adaptive_queue(scenes[dev], camera, width, height,
                                      kerns=kerns, mesh=mesh, scenes=scenes,
                                      **kw)
    img = (s / n[:, None]).astype(np.float32).reshape(height, width, 3)
    if return_spp:
        return img, n.reshape(height, width)
    return img


def _render_adaptive_queue(scene, camera, width, height, *, spp_max, tol,
                           max_depth, seed, rays_per_wave, engine, pilot_spp,
                           round_cap, max_rounds, rr_depth, progress, kerns,
                           mesh=None, scenes=None):
    """Worklist rounds on the work queue (see render_adaptive), on
    ``scene``'s device or shared out over ``mesh`` (``scenes``: the copies
    by device; ``kerns``: the tables by device); returns the float64
    (P, 3) radiance sums and the (P,) sample counts."""
    from .renderer import plan_queue

    P = width * height
    dev = scene.device
    # align every budget knob to WL_QUANT blocks (the blocked reduction's
    # unit); spp_max rounds DOWN (a budget cap), the others up
    spp_max = max(WL_QUANT, spp_max // WL_QUANT * WL_QUANT)
    pilot_spp = max(2, min(pilot_spp, spp_max))  # variance needs n >= 2
    pilot_spp = -(-pilot_spp // WL_QUANT) * WL_QUANT
    round_cap = max(WL_QUANT, round_cap // WL_QUANT * WL_QUANT)
    if mesh is not None:
        R_pad = jax_queue_lanes(scene.n_prims, P, spp_max, rays_per_wave,
                                engine)

    key = rng.prng_key(seed)
    n = np.zeros(P, np.int64)
    s = np.zeros((P, 3), np.float64)
    s2 = np.zeros((P, 3), np.float64)
    extra = np.full(P, pilot_spp, np.int64)
    work_s0 = 0  # sample-unit offset keeping path-draw ids distinct
    for rnd in range(max_rounds):
        t_round = time.perf_counter()
        n_work = int(extra.sum())
        # lanes, epochs and drain ladder key no draw: each round takes
        # plan_queue's for its own item count (the JAX package plans once,
        # for the budget, with no ladder: each level there was one more
        # compiled program per worklist bucket)
        R, _, epoch_iters, drain = plan_queue(
            scene, width, height, -(-n_work // P), rays_per_wave)
        alloc = _compact_alloc(extra, n, int((extra > 0).sum()))
        pad = n_work if mesh is None else mesh_pad(n_work, R_pad, len(mesh))
        wl, bp = _expand_worklist(
            *(torch.from_numpy(a).to(device=dev, dtype=torch.int64)
              for a in alloc), pad // WL_QUANT, P)
        kw = dict(cam_salt=seed, epoch_iters=epoch_iters, drain_levels=drain,
                  rr_depth=rr_depth)
        if mesh is None:
            sums, sqs = trace_queue(
                scene, camera, width, height, 0, work_s0,
                rng.fold_in(key, rnd), max_depth, R, worklist=wl,
                n_work=n_work, wl_block_pix=bp, kern=kerns[dev], **kw)
        else:
            sums, sqs = trace_queue_wl_mesh(
                scenes, camera, width, height, work_s0,
                rng.fold_in(key, rnd), max_depth, R, mesh, wl, n_work, bp,
                kerns=kerns, **kw)
        both = torch.stack((sums, sqs)).cpu().numpy().astype(np.float64)
        s += both[0]
        s2 += both[1]
        n += extra
        work_s0 += -(-n_work // P)
        extra, err = _round_sizes(n, s, s2, tol, spp_max, pilot_spp,
                                  round_cap)
        # tail cutoff: once only a sliver of pixels still needs work,
        # finish them to the budget cap in ONE final round instead of
        # paying per-round fixed costs for repeated small re-estimates
        need = extra > 0
        if 0 < int(need.sum()) < max(64, P // 256):
            extra = np.where(need, spp_max - n, 0)
        if progress:
            sys.stderr.write(
                f"\r[adaptive] round {rnd + 1}: "
                f"{100.0 * np.mean(extra == 0):5.1f}% pixels converged, "
                f"spp {n.min()}-{n.max()} (mean {n.mean():.1f}), err p99 "
                f"{np.quantile(err, 0.99):.4f}, "
                f"{time.perf_counter() - t_round:.2f}s\n")
            sys.stderr.flush()
        if not extra.any():
            break
    if progress:
        sys.stderr.write("\n")
    return s, n


def _pool_round(scene, cfg: StepConfig, act: torch.Tensor, key, width: int,
                height: int, engine: str, kern: SceneKernels):
    """One pool round over the active pixels ``act`` ((A,) int64 on the
    scene's device; padding rows render pixel 0 and are discarded by the
    caller): each pixel runs ``POOL_REPS`` replicate slots of
    ``cfg.n_samples`` samples from per-slot sample ``cfg.sample0``, lane
    ``a * POOL_REPS + r`` holding slot ``act[a] + r * P``.  Returns the
    (2, A, 3) float32 [sum of slot sums, sum of squared slot sums]."""
    P = width * height
    A = act.shape[0]
    reps = torch.arange(POOL_REPS, dtype=torch.int64, device=act.device)
    slot = (act[:, None] + reps[None, :] * P).reshape(-1).to(torch.int32)
    # film bases as the JAX round builds them: a product with the float32
    # reciprocal, not the uniform renderer's quotient (1 ulp apart)
    sx = (act % width).to(torch.float32) * cfg.inv_w
    sy = ((height - 1) - act // width).to(torch.float32) * cfg.inv_h
    xy = torch.stack([sx, sy]).repeat_interleave(POOL_REPS, dim=1)
    trace_wave = trace_pool_mega if engine == "mega" else trace_pool_staged
    accum, _ = trace_wave(scene, cfg, xy, slot, key, kern)
    acc = accum.T.reshape(A, POOL_REPS, 3)
    return torch.stack((acc.sum(dim=1), (acc * acc).sum(dim=1)))


def _render_adaptive_pool(scene, camera, width, height, *, spp_max, tol,
                          max_depth, seed, rays_per_wave, engine, pilot_spp,
                          round_cap, max_rounds, rr_depth, progress, kern):
    """Replicate-slot doubling rounds on the pool (see render_adaptive);
    returns the float64 (P, 3) radiance sums and the (P,) sample counts.

    All active pixels share ONE sample count (every pixel gets the same
    allocation each round and drops out when converged or capped), so
    slot ids and film bases are broadcast from the compacted active list,
    and the reduction is a dense (A, POOL_REPS) sum."""
    P = width * height
    Q = POOL_REPS
    dev = scene.device
    spp_max = max(Q, spp_max // Q * Q)
    pilot_spp = -(-max(2, min(pilot_spp, spp_max)) // Q) * Q
    round_cap = max(Q, round_cap // Q * Q)
    lane_cap = max(Q * 4096, rays_per_wave)
    cfg0 = StepConfig.create(scene, camera, width, height, max_depth,
                             rr_depth=rr_depth, cam_salt=0)

    key = rng.prng_key(seed)
    n = np.zeros(P, np.int64)
    s = np.zeros((P, 3), np.float64)
    # inverse-variance bookkeeping: var(total mean) = acc_a / n^2 where
    # acc_a accumulates k_round^2 * var(round mean) per channel
    acc_a = np.zeros((P, 3), np.float64)
    active = np.arange(P, dtype=np.int64)
    k_round = pilot_spp
    for rnd in range(max_rounds):
        t_round = time.perf_counter()
        m = k_round // Q  # samples per replicate slot this round
        slot_base = int(n[active[0]]) // Q  # per-slot samples so far
        cfg = dataclasses.replace(cfg0, n_samples=m,
                                  sample0=slot_base & rng.M32)
        slab = max(4096, lane_cap // Q)
        ssum = np.empty((active.size, 3), np.float64)
        ssq = np.empty((active.size, 3), np.float64)
        for lo in range(0, active.size, slab):
            part = active[lo:lo + slab]
            # the JAX round's power-of-two lane count, so both compact at
            # the same ladder levels
            a_pad = 1 << max(12, (int(part.size) - 1).bit_length())
            act = torch.from_numpy(np.pad(part, (0, a_pad - part.size))
                                   ).to(dev)
            out = _pool_round(scene, cfg, act, rng.fold_in(key, rnd), width,
                              height, engine, kern)
            out = out.cpu().numpy().astype(np.float64)
            ssum[lo:lo + slab] = out[0, : part.size]
            ssq[lo:lo + slab] = out[1, : part.size]
        # per-round mean variance from the Q replicate slot means
        mu_sum = ssum / m
        mu_sq = ssq / (m * m)
        mean_r = mu_sum / Q
        var_mu = np.maximum(mu_sq - Q * mean_r * mean_r, 0.0) / (Q - 1)
        s[active] += ssum
        acc_a[active] += (k_round * k_round) * (var_mu / Q)
        n[active] += k_round
        # convergence: display-space stderr of the combined mean
        na = n[active].astype(np.float64)[:, None]
        mean = s[active] / na
        var_mean = acc_a[active] / (na * na)
        sigma_d = np.sqrt(var_mean) / (
            2.0 * np.sqrt(np.maximum(mean, DISPLAY_FLOOR**2)))
        err = sigma_d.max(axis=1)
        keep = (err > tol) & (n[active] < spp_max)
        if progress:
            sys.stderr.write(
                f"\r[adaptive/pool] round {rnd + 1}: "
                f"{100.0 * (1 - keep.sum() / P):5.1f}% pixels done, "
                f"spp {n.min()}-{n.max()} (mean {n.mean():.1f}), err p99 "
                f"{np.quantile(err, 0.99):.4f}, "
                f"{time.perf_counter() - t_round:.2f}s\n")
            sys.stderr.flush()
        active = active[keep]
        if active.size == 0:
            break
        # equal doubling, clipped to the per-round cap and the budget
        # (every active pixel shares n, so the remaining headroom is
        # identical across the set); a straggler sliver fills to the cap
        k_round = int(min(max(n[active[0]], pilot_spp), round_cap,
                          spp_max - n[active[0]]))
        if active.size < max(64, P // 256):
            k_round = int(spp_max - n[active[0]])
        k_round = max(Q, k_round // Q * Q)
    if progress:
        sys.stderr.write("\n")
    return s, n
