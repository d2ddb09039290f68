"""Image output: tonemapping, dependency-free PNG writing and rMSE.

The reference presents via swapchain blit and never saves images (it
includes stb_image_write but never calls it, main.cpp:7-8). The JAX
package's utils/image.py writes PNGs with stdlib zlib only; this is the
same, for numpy arrays or tensors on any device (read back to the host).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def _host(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def tonemap(rgb) -> np.ndarray:
    """HDR (H, W, 3) float -> uint8, matching the reference's display path.

    The reference blits RGBA32F straight into an sRGB-ish swapchain with no
    tonemap; this clamps to [0, 1] and quantizes (the same visual result for
    the Cornell scene, where only the light pixel exceeds 1).
    """
    return (np.clip(_host(rgb), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img) -> None:
    """Write (H, W, 3) uint8 (or float, tonemapped) as an RGB PNG."""
    arr = _host(img)
    if arr.dtype != np.uint8:
        arr = tonemap(arr)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    h, w, _ = arr.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def rmse(a, b) -> float:
    """Root-mean-square error between two images (BASELINE.md metric), in
    float64."""
    a = _host(a).astype(np.float64)
    b = _host(b).astype(np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
