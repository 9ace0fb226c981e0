"""Why the tensor-core matrix-product sweep retests its pairs in scalar, and
how many it retests: a study of ``csrc/sweep_mxu.cu`` in plain PyTorch.

The matrix-product sweep expands the sphere quadratic around the range
centroid, and the expansion cancels.  This module answers two questions on
the CPU, with the kernel's arithmetic emulated in float64:

1. If the kernel used its products' values directly - even exact products,
   rounded once - how far would t move from the plain twin's
   (``ops/sweep.py::sweep_sphere_mxu_plain``, fp32 products and sums in a
   fixed order)?  Against the tolerance ``chip_smoke.py`` holds the kernel
   to (at most 1e-5 of the rays beyond 1e-6 + 2e-5 |t|), every rounding but
   the plain twin's own fails.
2. The kernel instead uses its three-way-split TF32 products only to pick
   the pairs where the plain twin's discriminant can be > 0 (``b^2 > a cc -
   M``, the margin M of :data:`~tpu_ray_torch.ops.sweep.MXU_MARGIN`) and
   retests those in scalar.  :func:`split_filter` emulates that pick (the
   products of the split operands summed in float64, then rounded: the
   tensor cores' fp32 accumulation differs from it by ~2^-20 of the terms,
   well inside the margin); none of the plain twin's hits may be missed.

Run: ``python -m tpu_ray_torch.utils.mxu_split_study [--width 150 --height
100]`` (book1-final, bounce-1 rays of a pool of that size at 16 spp, seed
1024; a minute on the CPU at the default size).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import sweep as sw

INF = float("inf")


def _ray_terms(rays: torch.Tensor, pack: sw.MxuPack):
    dx, dy, dz = rays[3], rays[4], rays[5]
    ox, oy, oz = (rays[i] - pack.m[i] for i in range(3))
    a = dx * dx + dy * dy + dz * dz
    od = ox * dx + oy * dy + oz * dz
    oo = ox * ox + oy * oy + oz * oz
    return dx, dy, dz, ox, oy, oz, a, od, oo


def _dot64(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return p.double() @ q.double().T


def split_filter(rays: torch.Tensor, pack: sw.MxuPack,
                 tiles: bool = False) -> torch.Tensor:
    """(R, n) bool: the pairs the kernel's first pass retests, its products
    of split operands (``pack.frag`` on the sphere side, the same split of
    the ray side) summed exactly and rounded to fp32; with ``tiles`` (R,
    ceil(n / 8)): the 8-sphere tiles whose bounding sphere passes the same
    test (``pack.frag2``)."""
    n = pack.hi - pack.lo
    if tiles:
        n = -(-n // 8)
    f = (pack.frag2 if tiles else pack.frag).reshape(-1, 4, 8)[:n]
    bh, bl, y, ch, cl = (f[..., k] for k in (0, 1, 2, 4, 5))
    dx, dy, dz, ox, oy, oz, a, od, oo = _ray_terms(rays, pack)
    ah, al = sw.tf32_split(torch.stack([a * ox, a * oy, a * oz, a], 1))
    dh, dl = sw.tf32_split(torch.stack([dx, dy, dz, od], 1))
    xh, xl = sw.tf32_split(a * oo)
    x = torch.stack([xh, xl, xh, sw.tf32_round(a * torch.sqrt(oo))], 1)
    acc = (_dot64(ah, bh) + _dot64(ah, bl) + _dot64(al, bh)
           + _dot64(x, y)).float()                 # a cc - M
    nb = (_dot64(dh, ch) + _dot64(dh, cl) + _dot64(dl, ch)).float()  # -b
    return nb * nb > acc


def plain_disc(rays: torch.Tensor, pack: sw.MxuPack) -> torch.Tensor:
    """(R, n) float32 discriminant of the plain twin, its operations in its
    order."""
    c = pack.tab.T[:, None, :]
    dx, dy, dz, ox, oy, oz, a, od, oo = (v[:, None] for v in
                                         _ray_terms(rays, pack))
    cd = dx * c[0] + dy * c[1] + dz * c[2]
    ccp = ox * c[4] + oy * c[5] + oz * c[6] + c[3]
    b = od - cd
    return b * b - a * (oo + ccp)


def exact_products_sweep(rays, pack: sw.MxuPack, t_min: float):
    """(best_t, best_i) of the plain twin's pair test with c'.d and the
    -2 o'.c' + k' sum exact, rounded once to fp32 (what no kernel does
    better): the rest in the plain twin's order."""
    c = pack.tab
    dx, dy, dz, ox, oy, oz, a, od, oo = (v[:, None] for v in
                                         _ray_terms(rays, pack))
    d3 = torch.cat([dx, dy, dz], 1)
    o4 = torch.cat([ox, oy, oz, torch.ones_like(ox)], 1)
    cd = _dot64(d3, c[:, 0:3]).float()
    ccp = _dot64(o4, torch.cat([c[:, 4:7], c[:, 3:4]], 1)).float()
    b = od - cd
    disc = b * b - a * (oo + ccp)
    sd = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-b - sd) * (1.0 / a)
    t2 = (-b + sd) * (1.0 / a)
    ok = disc > 0.0
    t = torch.where(ok & (t1 > t_min), t1,
                    torch.where(ok & (t2 > t_min), t2, INF))
    ct, ci = torch.min(t, dim=1)
    return ct, torch.where(ct < INF, ci.to(torch.int32) + pack.lo, 0)


def book1_bounce_rays(width: int, height: int, seed: int = 1024):
    """The rays of a book1-final pool of width x height at 16 spp after one
    bounce, on the CPU through the port's own pool step."""
    from ..core import rng
    from ..integrator import SceneKernels, init_pool_state
    from ..models.scenes import SCENES
    from ..ops import shade
    from ..ops.intersect import intersect_ti
    from ..renderer import pick_samples_per_wave, pixel_grid, slot_ids

    spec = SCENES["book1-final"]
    scene = spec.build(seed=seed, earth=None)
    k = pick_samples_per_wave(width, height, 16, 1 << 20)
    cfg = shade.StepConfig.create(scene, spec.camera(width, height), width,
                                  height, 50, n_samples=16 // k,
                                  cam_salt=seed)
    kern = SceneKernels.create(scene)
    st = init_pool_state(pixel_grid(width, height, k, "cpu"),
                         slot_ids(width, height, k, "cpu"))
    R = st.slot.shape[0]
    st.fstate, st.istate = shade.pool_step(
        cfg, st.xy, st.slot, st.fstate, st.istate, torch.empty(R),
        torch.zeros(R, dtype=torch.int32), (0, 0), init=True)
    ki, ks = rng.pool_key_tables(rng.fold_in(rng.prng_key(seed), 0), 2)
    bt, bi = intersect_ti(scene, st.fstate[:7], ki[0], st.slot, kern.geo,
                          kern.media)
    st.fstate, st.istate = shade.pool_step(cfg, st.xy, st.slot, st.fstate,
                                           st.istate, bt, bi, ks[0])
    return scene, kern.geo, st.fstate[:7].contiguous()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=150)
    ap.add_argument("--height", type=int, default=100)
    args = ap.parse_args(argv)
    scene, geo, rays = book1_bounce_rays(args.width, args.height)
    n = scene.n_sphere_static
    pack = sw.mxu_pack(geo, 0, n)
    t_min = float(np.float32(scene.t_min))
    R = rays.shape[1]
    pt, pi = sw.sweep_sphere_mxu_plain(rays, geo, 0, n, t_min, pack)
    bad = hit_mis = idx = missed = picked = need = 0
    for r0 in range(0, R, 4096):
        blk = rays[:, r0:r0 + 4096]
        et, ei = exact_products_sweep(blk, pack, t_min)
        p_t, p_i = pt[r0:r0 + 4096], pi[r0:r0 + 4096]
        hit, hp = torch.isfinite(et), torch.isfinite(p_t)
        both = hit & hp
        err = (et - p_t).abs()[both]
        bad += int((err > 1e-6 + 2e-5 * p_t[both].abs()).sum())
        hit_mis += int((hit != hp).sum())
        idx += int((ei != p_i)[both].sum())
        cand = split_filter(blk, pack)
        pos = plain_disc(blk, pack) > 0.0
        missed += int((pos & ~cand).sum())
        picked += int(cand.sum())
        need += int(pos.sum())
    print(f"book1-final {args.width}x{args.height} 16 spp, bounce-1 rays: "
          f"R={R}, {n} spheres, {int(torch.isfinite(pt).sum())} hits")
    print(f"exact products rounded once vs the plain twin: t beyond "
          f"1e-6 + 2e-5|t| on {bad} rays, hit mismatches {hit_mis}, index "
          f"mismatches {idx} (chip_smoke.py allows {1e-5 * R:.1f} each)")
    print(f"split-product filter: retests {picked} of {R * n} pairs "
          f"({picked / (R * n):.4%}); plain discriminant > 0 on {need}; "
          f"missed {missed}")
    return 0 if missed == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
