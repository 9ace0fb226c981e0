"""Film: tone mapping and image output (PPM, PNG, PFM, HDR).

Port of ``tpu_ray/core/film.py``: linear RGB -> gamma-2 (sqrt) -> clamp to
[0, 0.999] -> floor(256 x) -> uint8, and the P3 PPM writer (header, then
one image row per line).  PNG is encoded with ``zlib`` alone, so the port
needs no imaging package.  :class:`ProgressiveOutput` turns a render's
``on_partial`` estimates into streamed PPM rows or an atomically rewritten
image file.
"""
from __future__ import annotations

import os
import struct
import sys
import zlib

import numpy as np

__all__ = ["to_rgb8", "write_ppm", "ppm_string", "ppm_body_rows",
           "png_bytes", "write_png", "write_pfm", "write_hdr",
           "write_image", "ProgressiveOutput"]


def to_rgb8(img) -> np.ndarray:
    """Tone-map a linear (H, W, 3) float image to uint8
    (floor(256 * clamp(sqrt(x), 0, 0.999)); NaN maps to 0)."""
    x = np.asarray(img, np.float64)
    x = np.nan_to_num(x, nan=0.0, posinf=1.0, neginf=0.0)
    x = np.sqrt(np.maximum(x, 0.0))
    x = np.clip(x, 0.0, 0.999)
    return np.floor(256.0 * x).astype(np.uint8)


def ppm_body_rows(rgb8: np.ndarray) -> str:
    """P3 body text (no header) for a (H, W, 3) uint8 row block."""
    h, w, _ = rgb8.shape
    if h == 0:
        return ""
    flat = rgb8.reshape(h, w * 3)
    return "\n".join(" ".join(map(str, row)) for row in flat) + "\n"


def ppm_string(rgb8: np.ndarray) -> str:
    """P3 PPM text for a (H, W, 3) uint8 image."""
    h, w, _ = rgb8.shape
    return f"P3\n{w} {h}\n255\n" + ppm_body_rows(rgb8)


def write_ppm(rgb8: np.ndarray, fp=None) -> None:
    """Write a P3 PPM to ``fp`` (default stdout)."""
    (fp if fp is not None else sys.stdout).write(ppm_string(rgb8))


def png_bytes(rgb8: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of a (H, W, 3) uint8 image."""
    h, w, _ = rgb8.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)   # filter byte 0 per row
    raw[:, 1:] = np.ascontiguousarray(rgb8, np.uint8).reshape(h, 3 * w)

    def chunk(tag: bytes, data: bytes) -> bytes:
        crc = zlib.crc32(tag + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(rgb8: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(rgb8))


def write_pfm(img, path: str) -> None:
    """Portable FloatMap of the linear radiance (bottom-up rows,
    little-endian)."""
    a = np.asarray(img, np.float32)
    h, w, _ = a.shape
    with open(path, "wb") as f:
        f.write(b"PF\n%d %d\n-1.0\n" % (w, h))
        f.write(np.ascontiguousarray(a[::-1]).astype("<f4").tobytes())


def write_hdr(img, path: str) -> None:
    """Radiance RGBE (.hdr), flat scanlines, of the linear radiance."""
    a = np.asarray(img, np.float64)
    a = np.nan_to_num(a, nan=0.0, posinf=1e30, neginf=0.0)
    a = np.clip(a, 0.0, 1e30)
    h, w, _ = a.shape
    m = a.max(axis=-1)
    _, exp = np.frexp(m)
    scale = np.where(m > 1e-32, np.ldexp(256.0, -exp), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.minimum(a * scale[..., None], 255.0).astype(np.uint8)
    rgbe[..., 3] = np.where(m > 1e-32, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(b"-Y %d +X %d\n" % (h, w))
        f.write(rgbe.tobytes())


def write_image(img, path: str | None) -> None:
    """Tone-map and write; ``None``/``-`` -> PPM on stdout, else by
    extension (.ppm/.png tone-mapped; .pfm/.hdr linear radiance)."""
    if path is not None and path.endswith(".pfm"):
        return write_pfm(img, path)
    if path is not None and path.endswith(".hdr"):
        return write_hdr(img, path)
    rgb8 = to_rgb8(img)
    if path is None or path == "-":
        write_ppm(rgb8)
    elif path.endswith(".ppm"):
        with open(path, "w") as f:
            write_ppm(rgb8, f)
    else:
        write_png(rgb8, path)


class ProgressiveOutput:
    """Progressive render output (``tpu_ray/core/film.py::ProgressiveOutput``).

    Two modes, chosen by ``path``:

    - ``None``/``'-'``: stream P3 PPM rows to stdout (or ``fp``) the moment
      they are final (all spp accumulated): a banded render finalises its
      rows band by band, top to bottom; in an unbanded one no row is final
      before the render is, so the rows go out with :meth:`finish`.
    - a file path: atomically rewrite the file with the current estimate on
      every update (written under ``<path>.tmp``, then ``os.replace``), so
      a reader never sees a torn image and a crash keeps the latest frame.
      The format follows the destination's extension, as
      :func:`write_image`: .pfm / .hdr linear, .ppm, else PNG.

    Feed it to ``render(on_partial=po.update)`` and call
    ``po.finish(final_img)`` afterwards.
    """

    def __init__(self, path: str | None, width: int, height: int, fp=None):
        self.path = None if path in (None, "-") else path
        self.w, self.h = width, height
        self.fp = fp
        self.rows_emitted = 0
        self._header_done = False

    def _stream_rows(self, img, rows_final: int) -> None:
        out = self.fp if self.fp is not None else sys.stdout
        if not self._header_done:
            out.write(f"P3\n{self.w} {self.h}\n255\n")
            self._header_done = True
        if rows_final > self.rows_emitted:
            out.write(ppm_body_rows(to_rgb8(img[self.rows_emitted:rows_final])))
            self.rows_emitted = rows_final
        out.flush()

    def update(self, img, rows_final: int) -> None:
        if self.path is None:
            self._stream_rows(img, rows_final)
            return
        tmp = self.path + ".tmp"
        # dispatch on the destination's extension (the temporary name ends
        # in .tmp)
        if self.path.endswith(".pfm"):
            write_pfm(img, tmp)
        elif self.path.endswith(".hdr"):
            write_hdr(img, tmp)
        elif self.path.endswith(".ppm"):
            with open(tmp, "w") as f:
                write_ppm(to_rgb8(img), f)
        else:
            write_png(to_rgb8(img), tmp)
        os.replace(tmp, self.path)

    def finish(self, img) -> None:
        """Write whatever the progressive updates have not yet emitted."""
        if self.path is None:
            self._stream_rows(img, self.h)
        else:
            self.update(img, self.h)
