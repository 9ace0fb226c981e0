"""The work queue's path ids, flush and inject (tpu_ray_torch.ops.queue,
the CPU twins of csrc/queue.cu): one tpu_ray_torch queue_body iteration
against one tpu_ray.integrator._queue_body iteration (its XLA shading)
from the same seeded queue state, on cornell 12x12 with a 200-lane pool:
the hashed camera, Sobol', sobol-b0 and a worklist padded past its total,
each with a frontier that runs out in mid-iteration and lanes that die and
are refilled in that iteration.  Integers (work, frontier, bounce, active)
are equal, floats (the ray, throughput, radiance, the plane) within the
cross-engine tolerances (rtol 2e-4, atol 1e-4).  Also: path_ids_plain
bit-equal to the JAX package's rng.path_ids, with work + id0 past 2^32;
the wrappers' dispatch."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import jax_scene_arrays

from tpu_ray import integrator as jinteg
from tpu_ray.core import rng as jrng
from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray_torch.convert import scene_from_jax_arrays
from tpu_ray_torch.core import rng
from tpu_ray_torch.integrator import QueueState, SceneKernels, queue_body
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.ops import queue as q
from tpu_ray_torch.ops.shade import StepConfig

W = H = 12
P = W * H
M = 200            # lanes
DEPTH = 4
CHUNK_S0 = 3
CAM_SALT = 7
JKEY = jax.random.fold_in(jax.random.PRNGKey(5), 0x5EED)
KEY = rng.fold_in(rng.prng_key(5), 0x5EED)
# (sampler, worklist items (None: the uniform map of a 2-sample chunk),
#  padding entries past them, frontier before the iteration)
CASES = {"uniform": ("uniform", None, 0, 270),
         "sobol": ("sobol", None, 0, 262),
         "sobol-b0": ("sobol-b0", None, 0, 266),
         "worklist": ("uniform", 250, 40, 226)}


@pytest.fixture(scope="module")
def cornell():
    js = JSCENES["cornell"].build(seed=1024)
    return js, scene_from_jax_arrays(jax_scene_arrays(js))


def _state(r, total, pad, frontier):
    """A seeded mid-render queue state: most lanes active on distinct
    items below the frontier at bounces 0-3, inside the box in every
    direction (some leave by the open front, some reach the light, some
    hit the depth cap); the inactive ones hold a flushed item or none."""
    active = r.random(M) < 0.85
    work = r.permutation(frontier)[:M].astype(np.int64)
    idle = ~active & (r.random(M) < 0.5)
    work[idle] = pad
    ro = r.uniform(20.0, 535.0, (M, 3)).astype(np.float32)
    d = r.normal(size=(M, 3))
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return dict(active=active, work=work, ro=ro, rd=rd,
                rt=r.random(M, dtype=np.float32),
                tp=r.uniform(0.1, 1.0, (M, 3)).astype(np.float32),
                ac=r.uniform(0.0, 0.3, (M, 3)).astype(np.float32),
                bounce=np.where(active, r.integers(0, DEPTH, M), 0)
                .astype(np.int32), total=total, pad=pad, frontier=frontier)


def _jax_iteration(js, s, sampler, worklist):
    cam = JSCENES["cornell"].camera(W, H).replace(sampler=sampler)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    st = jinteg._QueueState(
        iteration=jnp.int32(0), frontier=jnp.int32(s["frontier"]),
        origin=f32(s["ro"]), direction=f32(s["rd"]), time=f32(s["rt"]),
        throughput=f32(s["tp"]), accum=f32(s["ac"]),
        bounce=jnp.asarray(s["bounce"]),
        work=jnp.asarray(s["work"].astype(np.int32)),
        active=jnp.asarray(s["active"]),
        plane=tuple(jnp.zeros((s["pad"],), jnp.float32) for _ in range(3)),
        log=jnp.zeros((M, 3), jnp.float32),
        posmap=jnp.full((s["pad"],), -1, jnp.int32), cursor=jnp.int32(0))
    out = jinteg._queue_body(
        st, js, cam, jax.random.fold_in(JKEY, 0), jax.random.fold_in(JKEY, 1),
        jnp.uint32(CAM_SALT), jnp.uint32(CHUNK_S0), jnp.int32(s["total"]),
        m=M, width=W, height=H, engine="xla", fused=False, max_depth=DEPTH,
        worklist=None if worklist is None
        else jnp.asarray(worklist.astype(np.uint32)))
    posmap = np.asarray(out.posmap)
    rows = np.asarray(out.log)[np.clip(posmap, 0, M - 1)]
    plane = np.where(posmap[:, None] >= 0, rows, 0.0).T
    return dict(work=np.asarray(out.work), frontier=int(out.frontier),
                bounce=np.asarray(out.bounce), active=np.asarray(out.active),
                ray=np.concatenate([np.asarray(out.origin).T,
                                    np.asarray(out.direction).T,
                                    np.asarray(out.time)[None]]),
                tp=np.asarray(out.throughput).T, ac=np.asarray(out.accum).T,
                plane=plane)


def _port_iteration(ps, s, sampler, worklist):
    cam = SCENES["cornell"].camera(W, H).replace(sampler=sampler)
    cfg = StepConfig.create(ps, cam, W, H, DEPTH, n_samples=0,
                            cam_salt=CAM_SALT, queue=True)
    f = torch.from_numpy(np.concatenate([s["ro"].T, s["rd"].T, s["rt"][None],
                                         s["tp"].T, s["ac"].T]).copy())
    i = torch.from_numpy(np.stack([s["bounce"], np.zeros(M, np.int32),
                                   s["active"].astype(np.int32)]))
    work = torch.from_numpy(s["work"])
    lane = None
    if cfg.b0:      # the record inject wrote: (pixel, global sample)
        lane = torch.from_numpy(np.stack([
            s["work"] % P, CHUNK_S0 + s["work"] // P]).astype(np.int32))
    st = QueueState(f, i, work, torch.tensor(s["frontier"]),
                    torch.zeros((3, s["pad"] + 1)), lane)
    out = queue_body(st, ps, cfg, SceneKernels.create(ps),
                     rng.fold_in(KEY, 0), rng.fold_in(KEY, 1), CAM_SALT,
                     CHUNK_S0 * P, s["total"], W, H,
                     None if worklist is None
                     else torch.from_numpy(worklist))
    return dict(work=out.work.numpy(), frontier=int(out.frontier),
                bounce=out.istate[0].numpy(),
                active=out.istate[2].numpy() > 0, ray=out.fstate[:7].numpy(),
                tp=out.fstate[7:10].numpy(), ac=out.fstate[10:13].numpy(),
                plane=out.plane[:, :-1].numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_queue_iteration_matches_jax_queue_body(cornell, case):
    js, ps = cornell
    sampler, n_items, n_pad, frontier = CASES[case]
    r = np.random.default_rng(sorted(CASES).index(case))
    worklist = None
    if n_items is None:
        total = pad = 2 * P
    else:
        total, pad = n_items, n_items + n_pad
        items = (r.integers(0, P, n_items) << q.WL_SAMP_BITS) \
            | r.integers(0, 1 << q.WL_SAMP_BITS, n_items)
        worklist = np.concatenate([items, np.zeros(n_pad, np.int64)])
    s = _state(r, total, pad, frontier)
    calls = q.path_ids_plain.calls, q.queue_inject_plain.calls
    a = _jax_iteration(js, s, sampler, worklist)
    b = _port_iteration(ps, s, sampler, worklist)
    assert (q.path_ids_plain.calls, q.queue_inject_plain.calls) == \
        (calls[0] + 1, calls[1] + 1)
    for k in ("work", "bounce", "active"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert b["frontier"] == a["frontier"] == total
    for k in ("ray", "tp", "ac", "plane"):
        np.testing.assert_allclose(b[k], a[k], rtol=2e-4, atol=1e-4,
                                   err_msg=k)
    # the cases this test is for: lanes that died and took new work in the
    # same iteration, free lanes the spent frontier left idle, and flushed
    # radiance in the plane
    refilled = s["active"] & (b["work"] != s["work"]) & b["active"]
    assert refilled.sum() >= 8
    assert (~b["active"]).sum() >= 5
    assert (b["plane"] != 0).any(axis=0).sum() >= 10


def test_path_ids_plain_matches_jax_past_2_32():
    """2^12 (work item, bounce) pairs with work + id0 on both sides of
    2^32: the port hashes the low 32 bits of its int64 sum, the JAX package
    wraps its uint32 add."""
    r = np.random.default_rng(21)
    n = 1 << 12
    work = r.integers(0, 1 << 33, n, dtype=np.int64)
    id0 = int(r.integers(1 << 31, 1 << 33))
    bounce = r.integers(0, 64, n).astype(np.int32)
    assert ((work + id0) >= 1 << 32).mean() > 0.5
    assert ((work + id0) < 1 << 32).any()
    want = np.asarray(jrng.path_ids(
        jnp.asarray(work.astype(np.uint32)) + jnp.uint32(id0 & rng.M32),
        jnp.asarray(bounce)))
    got = q.path_ids_plain(torch.from_numpy(work), id0,
                           torch.from_numpy(bounce))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_wrappers_take_plain_path_on_cpu_only(cornell):
    """On CPU tensors path_ids and queue_inject run their twins and count
    no launch; the kernels' launches have no plain fallback: they raise on
    CPU tensors."""
    _, ps = cornell
    r = np.random.default_rng(3)
    s = _state(r, 2 * P, 2 * P, 270)
    cfg = StepConfig.create(ps, SCENES["cornell"].camera(W, H), W, H, DEPTH,
                            n_samples=0, queue=True)
    work = torch.from_numpy(s["work"])
    bounce = torch.from_numpy(s["bounce"])
    launches = q.path_ids.launches, q.queue_inject.launches
    assert torch.equal(q.path_ids(work, 5, bounce),
                       q.path_ids_plain(work, 5, bounce))

    after = np.stack([s["bounce"], np.zeros(M, np.int32),
                      (r.random(M) < 0.5).astype(np.int32)])

    def args():
        f = torch.rand((13, M), generator=torch.Generator().manual_seed(1))
        return (cfg, 3, torch.from_numpy(s["active"].astype(np.int32)), f,
                torch.from_numpy(after.copy()), work, torch.tensor(270),
                torch.zeros((3, 2 * P + 1)), None, None, 2 * P, 0, W, H)

    a = q.queue_inject(*args())
    b = q.queue_inject_plain(*args())
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    assert (q.path_ids.launches, q.queue_inject.launches) == launches
    with pytest.raises(ValueError, match="CUDA"):
        q.path_ids_launch(work, 5, bounce)
    with pytest.raises(ValueError, match="CUDA"):
        q.queue_inject_launch(*args())
    assert (q.path_ids.launches, q.queue_inject.launches) == launches
