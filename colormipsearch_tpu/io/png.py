"""PNG encoder on the standard library (zlib + struct).

Writes the image kinds the pipeline produces: 8-bit RGB color depth
MIPs and z-gap variants, and 16-bit gray gradient variants.  The files
decode through the native decoder (io/native_decoder.py) and through any
standard PNG reader.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(pixels: np.ndarray, level: int = 6) -> bytes:
    """uint8 [H, W, 3] (RGB), uint8 [H, W] or uint16 [H, W] (gray) ->
    PNG bytes (no interlace, filter type 0 on every row)."""
    if pixels.ndim == 3 and pixels.shape[-1] == 3 \
            and pixels.dtype == np.uint8:
        color_type, depth = 2, 8
        rows = pixels.reshape(pixels.shape[0], -1)
    elif pixels.ndim == 2 and pixels.dtype == np.uint8:
        color_type, depth = 0, 8
        rows = pixels
    elif pixels.ndim == 2 and pixels.dtype == np.uint16:
        color_type, depth = 0, 16
        rows = pixels.astype(">u2").view(np.uint8).reshape(
            pixels.shape[0], -1)
    else:
        raise ValueError(f"cannot encode {pixels.dtype} {pixels.shape} "
                         "as PNG (expected uint8 RGB or uint8/uint16 gray)")
    h, w = pixels.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str | os.PathLike, pixels: np.ndarray,
              level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(pixels, level))
