"""Test-image loading (port of `semiblind_tv_tpu/utils/images.py`).

The reference ships grayscale PNGs (`data/images/`, see its README) and the
demos default to wheel.png.  The JAX package decodes them with PIL; the
port decodes them with a small standard-library reader (zlib and the five
PNG row filters) so it needs no imaging package.  It reads 8-bit grayscale,
non-interlaced PNGs — every vendored image is one — and raises on any other
format.  A named file that fails to decode raises; only a missing 'wheel'
falls back to the synthetic phantom, as in the JAX package.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

__all__ = ["load_image", "synthetic_wheel", "available_images", "read_png_gray8"]

_DEFAULT_DIRS = (
    os.environ.get("SEMIBLIND_TV_IMAGES", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "data", "images"),
)

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def read_png_gray8(path: str) -> np.ndarray:
    """Decode an 8-bit grayscale non-interlaced PNG into a (H, W) uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color != 0 or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit grayscale non-interlaced PNGs are supported "
            f"(bit depth {depth}, colour type {color}, interlace {interlace})"
        )
    raw = zlib.decompress(b"".join(idat))
    stride = width + 1
    if len(raw) != stride * height:
        raise ValueError(f"{path}: image data has {len(raw)} bytes, expected {stride * height}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride)
    out = np.zeros((height, width), np.uint8)
    prev = np.zeros(width, np.int64)
    for r in range(height):
        kind, line = rows[r, 0], rows[r, 1:].astype(np.int64)
        if kind == 0:       # None
            cur = line
        elif kind == 1:     # Sub: running sum along the row
            cur = np.cumsum(line) % 256
        elif kind == 2:     # Up
            cur = (line + prev) % 256
        elif kind == 3:     # Average
            cur = np.empty(width, np.int64)
            left = 0
            for c in range(width):
                left = (int(line[c]) + (left + int(prev[c])) // 2) % 256
                cur[c] = left
        elif kind == 4:     # Paeth
            cur = np.empty(width, np.int64)
            left = up_left = 0
            for c in range(width):
                up = int(prev[c])
                left = (int(line[c]) + _paeth(left, up, up_left)) % 256
                cur[c] = left
                up_left = up
        else:
            raise ValueError(f"{path}: unknown PNG row filter {kind}")
        out[r] = cur
        prev = cur
    return out


def _search_dirs(image_dir: Optional[str]):
    dirs = [image_dir] if image_dir else []
    dirs += [d for d in _DEFAULT_DIRS if d]
    return [d for d in dirs if os.path.isdir(d)]


def available_images(image_dir: Optional[str] = None):
    names = set()
    for d in _search_dirs(image_dir):
        for f in os.listdir(d):
            if f.lower().endswith(".png"):
                names.add(os.path.splitext(f)[0])
    return sorted(names)


def load_image(name: str, image_dir: Optional[str] = None, size: int = 512) -> np.ndarray:
    """Load a grayscale image as float64 in [0, 255] (MATLAB double(imread))."""
    candidates = []
    if os.path.isfile(name):
        candidates.append(name)
    for d in _search_dirs(image_dir):
        candidates.append(os.path.join(d, name))
        candidates.append(os.path.join(d, name + ".png"))
    for path in candidates:
        if os.path.isfile(path):
            return read_png_gray8(path).astype(np.float64)
    if name in ("wheel", "synthetic", "synthetic_wheel"):
        return synthetic_wheel(size)
    raise FileNotFoundError(
        f"image {name!r} not found; set SEMIBLIND_TV_IMAGES to a directory of "
        f"grayscale PNGs or use the built-in 'wheel' phantom"
    )


def synthetic_wheel(size: int = 512, n_spokes: int = 36, soften: float = 1.2) -> np.ndarray:
    """Deterministic spoked-wheel resolution phantom in [0, 255] (sharp radial
    edges, flat regions, fine detail near the hub), softened by a mild blur
    and a low-amplitude deterministic texture so its gradient statistics
    resemble a photographed chart; soften=0 gives the binary mask."""
    c = (size - 1) / 2.0
    yy, xx = np.mgrid[0:size, 0:size]
    dx, dy = xx - c, yy - c
    r = np.hypot(dx, dy)
    ang = np.arctan2(dy, dx)
    spokes = 0.5 * (1.0 + np.sign(np.sin(n_spokes * ang)))
    img = spokes.copy()
    rim_outer = 0.47 * size
    rim_inner = 0.43 * size
    img[(r <= rim_outer) & (r >= rim_inner)] = 1.0
    img[r > rim_outer] = 0.0
    hub = 0.06 * size
    img[r < hub] = 1.0
    img[r < 0.5 * hub] = 0.0
    if soften > 0:
        from scipy.ndimage import gaussian_filter

        img = gaussian_filter(img, soften, mode="wrap")
        tex = 0.04 * (
            np.sin(2 * np.pi * 7 * xx / size) * np.sin(2 * np.pi * 5 * yy / size)
            + 0.5 * np.sin(2 * np.pi * 13 * (xx + yy) / size)
        )
        img = np.clip(img + tex, 0.0, 1.0)
    return (255.0 * img).astype(np.float64)
