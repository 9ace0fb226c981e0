"""The one request generator: a closed loop of one client, whose requests
a traffic mix's data file parameterises.

Mix keys: ``spp`` (samples per pixel), ``engine`` (``renderer.render``'s),
``scene`` (``"same"``: one scene built at set-up from ``scene_seed`` and
reused, as the render server's scene cache gives it).  Request ``i`` of a
run with ``--seed s`` renders with the sample seed of (s, i); every run
does the same kind of work, in another draw.
"""
from __future__ import annotations

from dataclasses import dataclass

M64 = (1 << 64) - 1
SEED_BITS = 31          # the renderer keys its streams by 32-bit seeds


def mix64(*words: int) -> int:
    """splitmix64 of the words folded in order: a seed from (seed, i, ...)."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (int(w) & M64)) * 0xBF58476D1CE4E5B9 & M64
        h = (h ^ (h >> 31)) * 0x94D049BB133111EB & M64
        h ^= h >> 29
    return h


@dataclass(frozen=True)
class Request:
    scene_seed: int
    sample_seed: int
    spp: int
    engine: str


def request(mix: dict, seed: int, i: int) -> Request:
    """Request ``i`` of a run seeded ``seed``; ``i < 0`` is the warm-up."""
    if mix["scene"] != "same":
        raise ValueError(f"unknown scene policy {mix['scene']!r}")
    return Request(scene_seed=int(mix["scene_seed"]),
                   sample_seed=mix64(seed, i, 0) >> (64 - SEED_BITS),
                   spp=int(mix["spp"]), engine=str(mix["engine"]))
