"""The work queue's plan cache (tpu_ray_torch.integrator.QueuePlan,
replay_key) on the CPU: the key holds the shape of a render and none of
its per-render words; worklist, mesh and unrouted calls give no key; a
key is planned at its second render and the cache keeps the most recent
plans; no plan is made off the card; and the launch counters that a
replay adds to (profiling.launch_counts, add_launches).  The plans and
their replays run on the card only (tests/test_torch_cuda.py).  Small
shapes: the file takes a few seconds."""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import replace

import pytest
import torch

from tpu_ray_torch import integrator
from tpu_ray_torch.core import rng
from tpu_ray_torch.integrator import (SceneKernels, replay_key, trace_queue,
                                      trace_queue_mesh)
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.ops.intersect import media_rows
from tpu_ray_torch.ops.sweep import sweep_table
from tpu_ray_torch.parallel.mesh import make_mesh
from tpu_ray_torch.utils import profiling

W = H = 16
SPP = 2


def _routed(scene) -> SceneKernels:
    """The scene's route (rule INDEX tables kept per scene object), as
    ``SceneKernels.create`` takes it on the card above 512 prims."""
    t = integrator._index_tables(scene, sweep_table(scene), media_rows(scene))
    return SceneKernels(geo=t.geo, media=t.media, bvh=t)


@pytest.fixture(scope="module")
def smoke():
    spec = SCENES["cornell-smoke"]
    scene = spec.build(seed=1024, earth=None)
    return scene, spec.camera(W, H), _routed(scene)


@pytest.fixture
def plans(monkeypatch):
    """An empty plan cache and record of keys seen, restored afterwards."""
    monkeypatch.setattr(integrator, "_queue_plans", OrderedDict())
    monkeypatch.setattr(integrator, "_queue_seen", OrderedDict())
    return integrator._queue_plans


def _key(seed):
    return rng.fold_in(rng.prng_key(seed), 0x5EED)


def _queue(scene, cam, kern, seed=5, cam_salt=3, chunk_s0=1, R=512,
           epoch_iters=8, drain=(256, 64), max_depth=6, spp=SPP, **kw):
    """The image of one trace_queue call."""
    return trace_queue(scene, cam, W, H, spp, chunk_s0, _key(seed),
                       max_depth, R, cam_salt=cam_salt,
                       epoch_iters=epoch_iters, drain_levels=drain,
                       kern=kern, **kw)


def _keys(monkeypatch):
    """Every key replay_key gives from here on, in call order."""
    got = []
    real = integrator.replay_key

    def spy(*a, **kw):
        got.append(real(*a, **kw))
        return got[-1]
    monkeypatch.setattr(integrator, "replay_key", spy)
    return got


def test_key_ignores_seed_salt_and_sample_offset(smoke, plans, monkeypatch):
    """Calls that differ only in their seed, camera salt and first sample
    give one key; off the card none of them makes a plan or marks the key
    as seen."""
    scene, cam, kern = smoke
    keys = _keys(monkeypatch)
    for seed, salt, s0 in ((5, 3, 1), (9, 11, 0), (2 ** 31 + 7, 2 ** 32 - 1,
                                                   5)):
        _queue(scene, cam, kern, seed=seed, cam_salt=salt, chunk_s0=s0)
    assert len(keys) == 3 and keys[0] is not None
    assert keys[0] == keys[1] == keys[2]
    assert not plans and not integrator._queue_seen


def test_key_changes_with_the_shape(smoke):
    """The scene object, the camera, the size, the depths, the work count,
    the pool sizes, the epoch length and the sampler (sobol-b0 adds the
    lanes' record) each give another key."""
    scene, cam, kern = smoke
    base = dict(scene=scene, kern=kern, camera=cam, width=W, height=H,
                max_depth=6, rr_depth=0, total=W * H * SPP, R=512,
                drain_levels=(256, 64), epoch_iters=8)
    k0 = replay_key(**base)
    assert k0 is not None and replay_key(**base) == k0
    other = SCENES["cornell-smoke"].build(seed=1024, earth=None)
    sobol = replace(cam, sampler="sobol")
    b0 = replace(cam, sampler="sobol-b0")
    moved = SCENES["cornell-smoke"].camera(W, H + 1)
    changes = [dict(scene=other, kern=_routed(other)), dict(camera=moved),
               dict(camera=sobol), dict(width=W + 1), dict(height=H + 1),
               dict(max_depth=7), dict(rr_depth=3), dict(total=W * H),
               dict(R=1024), dict(drain_levels=(256,)),
               dict(drain_levels=(256, 32)), dict(epoch_iters=4)]
    keys = [replay_key(**{**base, **c}) for c in changes]
    assert None not in keys
    assert len(set(keys + [k0])) == len(keys) + 1
    assert replay_key(**{**base, "camera": b0}) not in (k0, keys[2])


def test_worklist_mesh_and_unrouted_calls_run_eagerly(smoke, plans,
                                                      monkeypatch):
    """A worklist, a mesh's share and tables made anew per render give no
    key, and their calls leave the cache empty."""
    scene, cam, kern = smoke
    base = dict(scene=scene, kern=kern, camera=cam, width=W, height=H,
                max_depth=6, rr_depth=0, total=W * H * SPP, R=512,
                drain_levels=(256, 64), epoch_iters=8)
    wl = torch.arange(W * H, dtype=torch.int64) << integrator.WL_SAMP_BITS
    assert replay_key(**base, worklist=wl) is None
    assert replay_key(**base, mesh_share=True) is None
    assert replay_key(**{**base, "kern": SceneKernels.create(scene)}) is None
    # route tables of another scene object than the one rendered
    other = SCENES["cornell-smoke"].build(seed=1024, earth=None)
    assert replay_key(**{**base, "kern": _routed(other)}) is None

    keys = _keys(monkeypatch)
    trace_queue(scene, cam, W, H, 0, 0, _key(5), 6, 512, cam_salt=3,
                worklist=wl, kern=kern)
    trace_queue_mesh(scene, cam, W, H, SPP, 0, _key(5), 6, 512,
                     make_mesh(device=["cpu"] * 2),
                     kerns={torch.device("cpu"): kern}, cam_salt=3)
    _queue(scene, cam, SceneKernels.create(scene))
    assert keys == [None] * 4 and not plans


class _Made:
    """A stand-in plan, and the count of those made."""
    n = 0

    def __init__(self):
        _Made.n += 1


@pytest.mark.parametrize("renders", [1, 2, 3])
def test_a_key_is_planned_at_its_second_render(plans, renders):
    """A key's first render gets no plan and makes none; its second makes
    one; later renders find it.  No key gets none and marks nothing."""
    _Made.n = 0
    key = ("cuda:0", 1, 2)
    assert integrator._new_plan(None, _Made) is None
    got = []
    for _ in range(renders):
        plan = integrator._queue_plan(key)
        got.append(plan or integrator._new_plan(key, _Made))
    assert got[0] is None and _Made.n == (renders >= 2)
    assert all(p is got[1] is plans[key] for p in got[1:])
    assert (key in integrator._queue_seen) == (renders == 1)


def test_cache_keeps_the_most_recent_plans(plans, monkeypatch):
    """The cache holds QUEUE_PLANS plans and drops the least recently
    used; a dropped key is planned again at its second render after."""
    monkeypatch.setattr(integrator, "QUEUE_PLANS", 2)

    def render(k):
        return integrator._queue_plan(k) or integrator._new_plan(k, _Made)

    for k in (4, 4, 5, 5, 4, 6, 6):
        render(k)
    assert list(plans) == [4, 6]
    assert render(5) is None and list(plans) == [4, 6]
    made = render(5)
    assert made is not None and list(plans) == [6, 5]
    # the keys seen once stay few: QUEUE_PLANS x 4 at most
    for k in range(100, 120):
        render(k)
    assert len(integrator._queue_seen) == 8
    assert 119 in integrator._queue_seen and 100 not in integrator._queue_seen


@pytest.mark.parametrize("name", profiling.LAUNCHES)
def test_add_launches_moves_one_counter(name, monkeypatch):
    """``add_launches`` adds to the counters it names and no other, as
    ``launch_counts`` and ``counts`` read them (a replay adds what its
    capture held)."""
    holder, attr = profiling._holder(name)
    monkeypatch.setattr(holder, attr, getattr(holder, attr))
    before = profiling.launch_counts()
    assert set(before) == set(profiling.LAUNCHES)
    profiling.add_launches({name: 7})
    after = profiling.launch_counts()
    assert after[name] == before[name] + 7
    assert {k: v for k, v in after.items() if k != name} == \
        {k: v for k, v in before.items() if k != name}
    assert profiling.counts()[name] == after[name]
    profiling.add_launches({name: -7})
    assert profiling.launch_counts() == before
