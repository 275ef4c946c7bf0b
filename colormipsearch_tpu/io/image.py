"""Image decoding to packed numpy arrays.

Replaces the reference's ImageJ/ImageIO decode layer
(imageprocessing/ImageArrayUtils.java, LocalTiffDecoder.java) with
decoders producing numpy arrays ready for device upload:

  * RGB images  -> uint8 [H, W, 3]
  * 8-bit gray  -> uint8 [H, W]
  * 16-bit gray -> uint16 [H, W]

Color depth MIPs are RGB TIFF/PNG; gradient images are 16-bit gray;
z-gap variants are RGB.  TIFF and PNG go through the native decoder
(native/cdm_decoder.cpp).  Pillow is optional: it decodes the other
formats and the encodings the native decoder rejects.
"""

from __future__ import annotations

import dataclasses
import enum
import io as _io
import os

import numpy as np


class ImageType(enum.Enum):
    GRAY8 = "gray8"
    GRAY16 = "gray16"
    RGB = "rgb"


@dataclasses.dataclass
class ImageData:
    """Decoded image + pixel type (analogue of the reference ImageArray)."""
    type: ImageType
    pixels: np.ndarray  # [H, W] or [H, W, 3]

    @property
    def height(self) -> int:
        return self.pixels.shape[0]

    @property
    def width(self) -> int:
        return self.pixels.shape[1]

    def as_rgb(self) -> np.ndarray:
        """uint8 [H, W, 3] view (grays replicated across channels)."""
        if self.type is ImageType.RGB:
            return self.pixels
        if self.type is ImageType.GRAY8:
            return np.repeat(self.pixels[..., None], 3, axis=-1)
        raise ValueError(f"cannot view {self.type} as RGB")


SUPPORTED_SUFFIXES = (".png", ".tif", ".tiff", ".jpg", ".jpeg", ".gif", ".bmp")


def is_image_file(name: str) -> bool:
    return name.lower().endswith(SUPPORTED_SUFFIXES)


def _from_pil(img) -> ImageData:
    if img.mode in ("RGB", "RGBA", "P"):
        arr = np.asarray(img.convert("RGB"), dtype=np.uint8)
        return ImageData(ImageType.RGB, arr)
    if img.mode == "L":
        return ImageData(ImageType.GRAY8, np.asarray(img, dtype=np.uint8))
    if img.mode in ("I;16", "I;16B", "I;16L"):
        return ImageData(ImageType.GRAY16, np.asarray(img, dtype=np.uint16))
    if img.mode == "I":
        # PIL promotes 16-bit grayscale PNGs to 32-bit mode "I"; values
        # must fit the 16-bit pipeline — reject instead of silently
        # wrapping through astype (the bit-exactness contract)
        arr = np.asarray(img, dtype=np.int32)
        mx = int(arr.max(initial=0))
        if mx > 0xFFFF or int(arr.min(initial=0)) < 0:
            raise ValueError(
                f"32-bit gray image with values outside uint16 "
                f"(min {arr.min(initial=0)}, max {mx}) is not supported")
        if mx > 255:
            return ImageData(ImageType.GRAY16, arr.astype(np.uint16))
        return ImageData(ImageType.GRAY8, arr.astype(np.uint8))
    # fall back to RGB conversion for exotic modes
    return ImageData(ImageType.RGB, np.asarray(img.convert("RGB"), dtype=np.uint8))


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _try_native(data: bytes) -> ImageData | None:
    """Decode a TIFF or PNG with the native C++ decoder when possible."""
    if len(data) < 8 or (data[:2] not in (b"II", b"MM")
                         and not data.startswith(_PNG_MAGIC)):
        return None
    try:
        from colormipsearch_tpu.io import native_decoder
    except ImportError:
        return None
    arr = native_decoder.decode_img(data)
    if arr is None:
        return None
    if arr.ndim == 3 and arr.shape[-1] == 3:
        if arr.dtype != np.uint8:
            # 16-bit RGB TIFFs: let PIL convert; the RGB contract is
            # uint8 [H, W, 3]
            return None
        return ImageData(ImageType.RGB, np.ascontiguousarray(arr))
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        if arr.dtype == np.uint16:
            return ImageData(ImageType.GRAY16, arr)
        return ImageData(ImageType.GRAY8, arr)
    return None


def read_image(path_or_bytes) -> ImageData:
    """Decode an image from a path, byte string, or file-like object.

    TIFFs and PNGs go through the native C++ decoder
    (native/cdm_decoder.cpp) when it is available; everything else (and
    any native failure, e.g. palette or interlaced PNGs) falls back to
    Pillow, which is then required.
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    elif isinstance(path_or_bytes, (str, os.PathLike)) and \
            str(path_or_bytes).lower().endswith((".tif", ".tiff", ".png")):
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    else:
        data = None
    if data is not None:
        native = _try_native(data)
        if native is not None:
            return native
    try:
        from PIL import Image
    except ImportError:
        what = ("image bytes" if isinstance(path_or_bytes,
                                            (bytes, bytearray))
                else str(path_or_bytes))
        raise ValueError(
            f"cannot decode {what}: not a TIFF/PNG the native decoder "
            "reads, and Pillow is not installed") from None
    img = Image.open(_io.BytesIO(data) if data is not None
                     else path_or_bytes)
    with img:
        img.load()
        return _from_pil(img)
