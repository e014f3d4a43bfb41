"""A small PNG writer (standard library `zlib` + `struct`): 8-bit RGB, no
interlace, filter type 0 on every row. The pixels decode to the array as
given; channels are written in the order they come (the panorama writers
pass BGR frames through unchanged, as the JAX package's `imageio` calls
do). `write_pngs` writes many files on a thread pool: `zlib` releases the
interpreter lock while it compresses."""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + 3 * w), np.uint8)       # leading 0: filter type None
    rows[:, 1:] = img.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)   # 8-bit, colour type 2 (RGB)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_pngs(jobs) -> None:
    """Write each (path, (H, W, 3) uint8 array) of `jobs` concurrently."""
    with ThreadPoolExecutor() as pool:
        for future in [pool.submit(write_png, path, img) for path, img in jobs]:
            future.result()
