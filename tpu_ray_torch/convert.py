"""Carry a scene across packages as a dict of numpy arrays.

For a ray tracer the scene arrays are the weights: to hold the port
against the JAX package, both must render the very same arrays.  A JAX
``SceneData`` flattens to a dict keyed ``"<group>.<field>"`` for its
tensors (``"prims.center"``, ``"texs.perlin_salt"``, ``"background"``,
...) plus its static fields by name (``"n_prims"``, ``"t_min"``, ...);
:func:`scene_from_jax_arrays` turns such a dict into the port's
:class:`~tpu_ray_torch.models.scene_data.SceneData`, and
:func:`scene_to_arrays` is its inverse.  :func:`bvh_from_arrays` carries a
JAX ``BVHArrays`` across the same way, so both packages traverse the very
same tree.  None imports JAX: the caller that holds a JAX scene or tree
builds the dict.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.scene_data import (
    STATIC_FIELDS,
    LightArrays,
    MaterialArrays,
    PrimArrays,
    SceneData,
    TextureArrays,
)
from .ops.bvh import BVHArrays

_GROUPS = {"prims": PrimArrays, "mats": MaterialArrays,
           "texs": TextureArrays, "lights": LightArrays}
_TOP = ("background", "prim_payload", "mat_payload")


def scene_to_arrays(scene: SceneData) -> dict:
    """The port scene as a dict of numpy arrays and static values."""
    out = {}
    for g in _GROUPS:
        sub = getattr(scene, g)
        for f in dataclasses.fields(sub):
            out[f"{g}.{f.name}"] = getattr(sub, f.name).cpu().numpy()
    for k in _TOP:
        out[k] = getattr(scene, k).cpu().numpy()
    for k in STATIC_FIELDS:
        out[k] = getattr(scene, k)
    return out


def scene_from_jax_arrays(d: dict, device="cpu") -> SceneData:
    """Build the port's ``SceneData`` from a dict of numpy arrays (the JAX
    ``SceneData`` leaves keyed as in the module note) plus static fields.
    Arrays keep their dtypes (uint32 stays uint32), so the packed image
    atlas ``texs.img_atlas`` and its ``texs.img_size`` cross over as they
    are, and a scene whose payload depends on where JAX built it
    (next-week-final) renders the very arrays JAX would."""
    def t(a):
        return torch.from_numpy(np.array(a, order="C")).to(device)

    groups = {
        g: cls(**{f.name: t(d[f"{g}.{f.name}"])
                  for f in dataclasses.fields(cls)})
        for g, cls in _GROUPS.items()
    }
    statics = {}
    for k in STATIC_FIELDS:
        v = d[k]
        statics[k] = float(v) if k == "t_min" else (
            bool(v) if isinstance(v, (bool, np.bool_)) else int(v))
    return SceneData(**groups, **{k: t(d[k]) for k in _TOP}, **statics)


_BVH_ARRAYS = ("node_min", "node_max", "child_l", "child_r", "first",
               "count", "order")


def bvh_from_arrays(d: dict, device="cpu") -> BVHArrays:
    """The port's :class:`~tpu_ray_torch.ops.bvh.BVHArrays` from a dict of
    a JAX ``BVHArrays``' numpy arrays (keyed by field name: node_min,
    node_max, child_l, child_r, first, count, order) plus its static
    ``n_nodes`` and ``leaf_size`` (optional: the node count and 4)."""
    arrs = {k: torch.from_numpy(np.array(d[k], order="C")).to(device)
            for k in _BVH_ARRAYS}
    return BVHArrays(**arrs,
                     n_nodes=int(d.get("n_nodes", arrs["count"].shape[0])),
                     leaf_size=int(d.get("leaf_size", 4)))
