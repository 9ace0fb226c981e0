"""Book 3's Cornell box (``src/Scenes.hs:32-73``) and its camera
(``cornellCamera``, ``src/Scenes.hs:120-131``), the deployment that the
reference itself renders (``app/Main.hs``: 500x500, 1000 spp, depth 50).

Five walls, the light rect (xz 213-343 x 227-332 at y = 554, emission
15), the white 165 x 330 x 165 box rotated 15 degrees about y and then
moved by (265, 0, 295), as its six rects, and the glass sphere (centre
(190, 90, 190), radius 90, index 1.5); black background, ``t_min`` 1e-2.
The light list is the light rect and the glass sphere (``:68-71``), so
every Lambertian hit scatters by the mixture of the two and the cosine
lobe.  Departure: the short box that the reference builds (``:48-66``)
is left out, as it is never added to the world there either.  The seed
draws nothing.
"""
from __future__ import annotations

import numpy as np

from .scenes import (BLACK, box_faces, camera as _camera, dielectric,
                     diffuse_light, lambertian, rect, rot_y, sphere)


def build(seed: int):
    red = lambertian((0.65, 0.05, 0.05))
    white = lambertian((0.73, 0.73, 0.73))
    green = lambertian((0.12, 0.45, 0.15))
    light = rect("xz", 213, 343, 227, 332, 554,
                 diffuse_light((15.0, 15.0, 15.0)))
    glass = sphere((190, 90, 190), 90, dielectric(1.5))
    world = [rect("yz", 0, 555, 0, 555, 555, green),
             rect("yz", 0, 555, 0, 555, 0, red),
             light,
             rect("xz", 0, 555, 0, 555, 0, white),
             rect("xz", 0, 555, 0, 555, 555, white),
             rect("xy", 0, 555, 0, 555, 555, white),
             *box_faces((0, 0, 0), (165, 330, 165), white, rot_y(15.0),
                        np.array([265.0, 0.0, 295.0])),
             glass]
    return world, [], BLACK, 1e-2, [light, glass]


def camera(w: int, h: int):
    return _camera((278, 278, -800), (278, 278, 0), (0, 1, 0), 40.0, w / h,
                   0.0, 10.0)
