"""Asset loading (the earth texture); port of ``tpu_ray/utils/assets.py``.

The reference reads ``./earthmap.jpg`` from the working directory and
degrades to a cyan texture when it is missing (src/Scenes.hs:157-165,
src/Lib.hs:510).  We search a couple of conventional locations and return
``None`` on failure, which the texture compiler turns into cyan.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

EARTH_SEARCH_PATHS = (
    "./earthmap.jpg",
    os.path.join(os.path.dirname(__file__), "..", "..", "assets", "earthmap.jpg"),
)


def load_image(path: str) -> Optional[np.ndarray]:
    """Decode an image file to (H, W, 3) uint8, or None on failure (or
    when no image decoder is installed)."""
    try:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    except Exception:
        return None


def load_earth_image(path: Optional[str] = None) -> Optional[np.ndarray]:
    paths = (path,) if path else EARTH_SEARCH_PATHS
    for p in paths:
        if p and os.path.exists(p):
            img = load_image(p)
            if img is not None:
                return img
    return None
