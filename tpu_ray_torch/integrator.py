"""Ray-pool path tracing with immediate path regeneration.

Port of the fused pool path of ``tpu_ray/integrator.py`` (``_PoolState``,
``_init_pool_state``, ``_pool_levels``, the fused body of
``_make_pool_loop`` and ``trace_pool_staged``).  Every slot owns one pixel
and renders ``n_samples`` camera samples in turn; each iteration runs the
closest-hit sweep and the fused pool step (the CUDA kernels on the card,
their plain versions on the CPU).  All randomness is keyed by the slot's
global id and the global iteration / sample index, never by lane position.

The host drives the loop:

* each wave's per-iteration key words ``fold_in(fold_in(k_loop, it), 0/1)``
  are precomputed in numpy for the whole iteration cap (the JAX
  megakernel's key-table trick);
* the active count is read every ``CHECK_EVERY`` iterations, not every
  one.  Iterations past the point where the count fell to a ladder level
  change nothing a later level would not do identically (draws are keyed
  by slot and iteration, and the active count never rises), so the
  estimate does not change - only where the radiance is summed;
* compaction gathers the most-active lanes with a stable argsort of
  ``~active`` at each ladder level, as ``integrator.py:506-529`` does.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .core import rng
from .models.scene_data import SceneData
from .ops.intersect import intersect_ti, media_rows
from .ops.shade import N_FSTATE, N_ISTATE, StepConfig, pool_step
from .ops.sweep import sweep_table

# compaction ladder (integrator.py COMPACT_* constants, kept identical:
# the ladder decides nothing about the estimate, but the port keeps the
# reference's schedule until it is retuned for the card)
COMPACT_MIN = 1 << 14
COMPACT_FRACTION = 2
COMPACT_FLOOR = 4096
COMPACT_FRACTION_TINY = 8
COMPACT_FLOOR_TINY = 1024
COMPACT_TINY_PRIMS = 128
CHECK_EVERY = 4


@dataclass
class PoolState:
    """The pool's lanes: float and int state (ops/shade.py layout) plus
    the per-lane constants and each lane's position in the full pool."""

    fstate: torch.Tensor   # (13, R) float32
    istate: torch.Tensor   # (3, R) int32
    xy: torch.Tensor       # (2, R) float32
    slot: torch.Tensor     # (R,) int32 (uint32 bits)
    gids: torch.Tensor     # (R,) int64


def init_pool_state(xy, slot) -> PoolState:
    """``_init_pool_state``: zero state, unit throughput, nothing active."""
    R = slot.shape[0]
    f = torch.zeros((N_FSTATE, R), dtype=torch.float32, device=slot.device)
    f[7:10] = 1.0
    i = torch.zeros((N_ISTATE, R), dtype=torch.int32, device=slot.device)
    return PoolState(f, i, xy, slot,
                     torch.arange(R, dtype=torch.int64, device=slot.device))


def pool_levels(R: int, n_prims: int):
    """Compaction-ladder pool sizes for an R-lane pool."""
    if n_prims > COMPACT_TINY_PRIMS:
        frac, floor = COMPACT_FRACTION, COMPACT_FLOOR
    else:
        frac, floor = COMPACT_FRACTION_TINY, COMPACT_FLOOR_TINY
    levels = []
    m = R
    while R >= COMPACT_MIN and m // frac >= floor:
        m = m // frac
        levels.append(m)
    return levels


@dataclass
class SceneKernels:
    """Per-render tables of the two kernels and the media rows."""

    geo: torch.Tensor
    media: list

    @classmethod
    def create(cls, scene: SceneData) -> "SceneKernels":
        return cls(geo=sweep_table(scene), media=media_rows(scene))


def _compact(st: PoolState, m: int) -> PoolState:
    """Gather the ``m`` most-active lanes (stable argsort of ~active),
    with a zero radiance accumulator."""
    order = torch.argsort((st.istate[2] == 0).to(torch.int32),
                          stable=True)[:m]
    f = st.fstate[:, order]
    f[10:13] = 0.0
    return PoolState(f, st.istate[:, order].contiguous(),
                     st.xy[:, order].contiguous(),
                     st.slot[order].contiguous(), st.gids[order])


def trace_pool_staged(scene: SceneData, cfg: StepConfig, xy, slot, k_loop,
                      kern: SceneKernels | None = None):
    """Run one wave of the pool: every slot renders ``cfg.n_samples``
    samples starting at global sample ``cfg.sample0``, with loop key
    ``k_loop`` (numpy uint32[2]).

    ``xy``: (2, R) pixel-fraction bases; ``slot``: (R,) int32 global slot
    ids.  Returns (accum (3, R) summed radiance, samples done (R,) int32).
    """
    R = slot.shape[0]
    dev = slot.device
    if cfg.max_depth <= 0:
        return (torch.zeros((3, R), dtype=torch.float32, device=dev),
                torch.full((R,), cfg.n_samples, dtype=torch.int32,
                           device=dev))
    if kern is None:
        kern = SceneKernels.create(scene)
    iter_cap = cfg.n_samples * cfg.max_depth + cfg.max_depth
    k_isect, k_scat = rng.pool_key_tables(np.asarray(k_loop, np.uint32),
                                          iter_cap)
    st = init_pool_state(xy, slot)
    dummy_t = torch.empty((R,), dtype=torch.float32, device=dev)
    dummy_i = torch.zeros((R,), dtype=torch.int32, device=dev)
    st.fstate, st.istate = pool_step(cfg, st.xy, st.slot, st.fstate,
                                     st.istate, dummy_t, dummy_i, (0, 0),
                                     init=True)
    it = 0

    def run_until(st: PoolState, threshold: int) -> PoolState:
        nonlocal it
        k = 0
        while it < iter_cap:
            if k % CHECK_EVERY == 0 and \
                    int(st.istate[2].sum()) <= threshold:
                break
            bt, bi = intersect_ti(scene, st.fstate[:7], k_isect[it],
                                  st.slot, kern.geo, kern.media)
            st.fstate, st.istate = pool_step(cfg, st.xy, st.slot, st.fstate,
                                             st.istate, bt, bi, k_scat[it])
            it += 1
            k += 1
        return st

    levels = pool_levels(R, scene.n_prims)
    st = run_until(st, levels[0] if levels else 0)
    accum = st.fstate[10:13].clone()
    sample = st.istate[1].clone()
    for li, m in enumerate(levels):
        st = _compact(st, m)
        st = run_until(st, levels[li + 1] if li + 1 < len(levels) else 0)
        accum.index_add_(1, st.gids, st.fstate[10:13])
        sample[st.gids] = st.istate[1]
    return accum, sample
