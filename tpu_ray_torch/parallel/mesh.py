"""Device meshes: sample waves and work items shared out over several
devices of one process.

Port of ``tpu_ray/parallel/mesh.py``.  JAX's mesh is single-controller:
one program drives every device, and one ``psum`` folds the per-device
films.  Here a mesh is an ordered tuple of ``torch.device`` entries that
one process drives the same way: the renderer runs device ``d``'s share
of each round (a wave, a queue sub-chunk, a worklist shard) with that
device's copy of the scene and its own tables, then sums the per-device
partials on ``mesh[0]`` in device order (:func:`reduce_films`).  Every
draw is keyed by global wave, slot, sample or work-item ids, so the image
equals the single-device render up to the f32 order of that sum.

Each device's work runs under :func:`device_guard`: the kernels launch
through ``ctypes`` on the runtime's *current* device (the launch,
``cudaFuncSetAttribute``, ``cudaGetDevice``), so on a mesh of distinct
cards the current device must be the one the tensors live on.  A mesh may
name one device several times (``(cuda:0, cuda:0)`` on a one-card
machine): the schedule and keying are then those of a D-device render,
with every share run on that one card.  No ``torch.distributed``: one
process holds every device.
"""
from __future__ import annotations

import contextlib

import torch


def make_mesh(n_devices: int | None = None, device=None) -> tuple:
    """A mesh of ``n_devices`` entries.

    ``device``: ``None`` or ``"cuda"`` takes ``cuda:0 .. cuda:n-1`` (all
    the cards when ``n_devices`` is ``None``) and raises when fewer cards
    exist: unlike the JAX package's ``make_mesh``, which silently takes the
    devices there are, a short mesh would render on fewer devices than
    asked.  ``"cpu"`` gives ``n_devices`` (default 1) ``cpu`` entries.  A
    list or tuple of devices is taken as the mesh itself (it may repeat a
    device)."""
    if isinstance(device, (list, tuple)):
        mesh = tuple(_normalise(torch.device(d)) for d in device)
        if not mesh or (n_devices is not None and n_devices != len(mesh)):
            raise ValueError(f"make_mesh: {len(mesh)} devices given for "
                             f"n_devices={n_devices}")
        return mesh
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        _check_count(n)
        return (torch.device("cpu"),) * n
    if kind != "cuda":
        raise ValueError(f"make_mesh: unknown device {device!r}")
    present = torch.cuda.device_count()
    n = present if n_devices is None else int(n_devices)
    _check_count(n)
    if n > present:
        raise RuntimeError(f"make_mesh: {n} CUDA devices asked for, "
                           f"{present} present")
    return tuple(torch.device("cuda", i) for i in range(n))


def _check_count(n: int) -> None:
    if n < 1:
        raise ValueError(f"make_mesh: n_devices must be >= 1, got {n}")


def _normalise(dev: torch.device) -> torch.device:
    """``cuda`` without an index is the current card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def distinct(mesh: tuple) -> list:
    """The mesh's devices, each once, in mesh order."""
    return list(dict.fromkeys(mesh))


def replicate(obj, mesh: tuple) -> dict:
    """``{device: obj.to(device)}`` for each distinct device of the mesh,
    each built once.  ``obj`` may already be such a dict (a caller's cache
    of copies, as the render server keeps); it must cover the mesh."""
    if isinstance(obj, dict):
        missing = [d for d in distinct(mesh) if d not in obj]
        if missing:
            raise ValueError(f"no copy for the mesh's devices {missing}")
        return obj
    return {dev: obj.to(dev) for dev in distinct(mesh)}


def device_guard(dev: torch.device):
    """The context each device's share of a round runs in: that card made
    the current CUDA device (nothing on the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def reduce_films(parts, mesh: tuple) -> torch.Tensor:
    """Sum the per-device partial films on ``mesh[0]``, in device order
    (the JAX package's ``psum``; its order is not this one, so the two
    agree up to f32 summation order)."""
    out = parts[0].to(mesh[0])
    for p in parts[1:]:
        out = out + p.to(mesh[0])
    return out
