"""Image output: tonemapping + dependency-free PNG writing.

The reference presents via swapchain blit and never saves images (it
includes stb_image_write but never calls it, main.cpp:7-8). A headless
renderer needs file output, so we write PNGs with stdlib zlib only.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap(rgb: np.ndarray) -> np.ndarray:
    """HDR (H, W, 3) float -> uint8, matching the reference's display path.

    The reference blits RGBA32F straight into an sRGB-ish swapchain with no
    tonemap; we clamp to [0, 1] and quantize (the same visual result for the
    Cornell scene where only the light pixel exceeds 1).
    """
    return (np.clip(np.asarray(rgb), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) uint8 (or float, tonemapped) as an RGB PNG."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = tonemap(arr)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    h, w, _ = arr.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Root-mean-square error between two images (the quality metric)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
