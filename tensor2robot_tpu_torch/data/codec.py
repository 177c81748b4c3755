"""Image decode and encode: JPEG through the native codec, PNG through
data/png.py.

The codec is `data/csrc/jpeg_codec.cc` over libjpeg where the host has
`<jpeglib.h>`, else `data/csrc/jpeg_codec_nvjpeg.cc` over nvJPEG (picked
once by data/native.py's probe; `codec_name()` says which). Both take the
same C ABI: a decode straight into the caller's uint8 buffer, a decode of
a crop window that equals a full decode followed by the crop bit for bit,
and a baseline encode. A failed build raises, and so does a failed decode:
there is no Python decoder.

`decode_image` keeps the JAX package's semantics (its data/parser.py):
empty bytes give the zero image (replay buffers hold empty camera slots),
the result has the spec's image shape and dtype, and a one-channel spec
takes PIL's luma of the decoded RGB, (19595 R + 38470 G + 7471 B +
0x8000) >> 16. As PIL does there, the bytes pick the decoder: a PNG
signature decodes through data/png.py (converted as PIL's convert("RGB")
or convert("L")), anything else through the JPEG codec. A PNG crop
decodes the whole image and cuts the window.

With the nvJPEG codec a decode runs on the card: the process backend of
data/dataset.py then leaves image decoding to the parent process
(`needs_card()`), since its workers must not touch CUDA.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence, Tuple

import numpy as np

from tensor2robot_tpu_torch.data import native, png
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, parse_dtype

_INT_P = ctypes.POINTER(ctypes.c_int)


class JpegDecodeError(ValueError):
    """The codec refused an encoded image (corrupt, truncated, or of
    another geometry than the spec)."""


class _Counts:
    """Calls into the codec since the last reset (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.decodes = self.roi_decodes = self.encodes = 0
        self.png_decodes = self.png_encodes = 0

    def add(self, field: str) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + 1)

    def reset(self) -> None:
        with self._lock:
            self.decodes = self.roi_decodes = self.encodes = 0
            self.png_decodes = self.png_encodes = 0


COUNTS = _Counts()


def _lib() -> ctypes.CDLL:
    lib = native.load("jpeg_codec")
    if not getattr(lib, "_t2r_bound", False):
        lib.t2r_jpeg_codec_name.restype = ctypes.c_char_p
        lib.t2r_jpeg_codec_name.argtypes = []
        lib.t2r_decode_jpeg.restype = ctypes.c_int
        lib.t2r_decode_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t, _INT_P, _INT_P,
        ]
        lib.t2r_decode_jpeg_roi.restype = ctypes.c_int
        lib.t2r_decode_jpeg_roi.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _INT_P, _INT_P,
        ]
        lib.t2r_encode_jpeg.restype = ctypes.c_int
        lib.t2r_encode_jpeg.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib._t2r_bound = True
    return lib


def codec_name() -> str:
    """'libjpeg' or 'nvjpeg': the codec this host built."""
    return _lib().t2r_jpeg_codec_name().decode()


def needs_card() -> bool:
    """True when decoding runs on the card (the nvJPEG codec)."""
    return native.codec_build()[0] == "nvjpeg"


def _check_out(out: np.ndarray) -> None:
    if out.dtype != np.uint8 or out.ndim != 3 or out.shape[-1] != 3:
        raise ValueError(f"decode target must be uint8 HxWx3, got {out.dtype} {out.shape}")
    if not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError("decode target must be a writeable C-contiguous array")


def _png_rgb(data: bytes, source_hw: Sequence[int]) -> np.ndarray:
    """A PNG decoded to RGB; PngDecodeError unless it measures source_hw."""
    rgb = png.to_rgb(png.decode_png(data))
    COUNTS.add("png_decodes")
    if rgb.shape[:2] != tuple(source_hw):
        raise png.PngDecodeError(
            f"Decoded image shape {rgb.shape} does not match the target shape "
            f"{tuple(source_hw) + (3,)}")
    return rgb


def decode_into(data: bytes, out: np.ndarray) -> None:
    """Decodes an image as RGB straight into `out` (uint8 HxWx3, C order);
    raises JpegDecodeError (PngDecodeError for a PNG) when the decoder
    refuses it or its size is not out's."""
    _check_out(out)
    data = bytes(data)
    if png.is_png(data):
        out[...] = _png_rgb(data, out.shape[:2])
        return
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = _lib().t2r_decode_jpeg(data, len(data), out.ctypes.data, out.nbytes,
                                ctypes.byref(h), ctypes.byref(w))
    COUNTS.add("decodes")
    if rc not in (0, -3):
        raise JpegDecodeError(f"jpeg decode failed (codec code {rc})")
    if rc == -3 or (h.value, w.value) != tuple(out.shape[:2]):
        raise JpegDecodeError(
            f"Decoded image shape {(h.value, w.value, 3)} does not match "
            f"the target shape {tuple(out.shape)}"
        )


def decode_roi_into(data: bytes, out: np.ndarray, y: int, x: int,
                    source_hw: Sequence[int]) -> None:
    """Decodes the (y, x) window of out's size into `out`; the source must
    measure `source_hw` (the spec's H, W), else JpegDecodeError (or
    PngDecodeError)."""
    _check_out(out)
    data = bytes(data)
    if png.is_png(data):
        out[...] = _png_rgb(data, source_hw)[y:y + out.shape[0], x:x + out.shape[1]]
        return
    fh, fw = ctypes.c_int(), ctypes.c_int()
    rc = _lib().t2r_decode_jpeg_roi(
        data, len(data), out.ctypes.data, out.nbytes, int(y), int(x),
        out.shape[0], out.shape[1], ctypes.byref(fh), ctypes.byref(fw))
    COUNTS.add("roi_decodes")
    if rc != 0:
        raise JpegDecodeError(f"jpeg ROI decode failed (codec code {rc})")
    if (fh.value, fw.value) != tuple(source_hw):
        raise JpegDecodeError(
            f"Decoded image shape {(fh.value, fw.value)} does not match "
            f"the spec's {tuple(source_hw)}"
        )


def image_shape(spec: ExtendedTensorSpec) -> Tuple[int, ...]:
    """The spec's image shape: its trailing three dims (a stack's frame)."""
    shape = tuple(spec.shape[-3:]) if len(spec.shape) >= 3 else tuple(spec.shape)
    if any(d is None for d in shape):
        raise ValueError(
            f"Image spec {spec.name!r} must have static H/W/C, got {shape}")
    return shape


def _decode_png(data: bytes, shape: Tuple[int, ...], channels: int) -> np.ndarray:
    image = png.decode_png(data)
    COUNTS.add("png_decodes")
    arr = png.to_rgb(image) if channels == 3 else png.to_luma(image)
    if arr.size != int(np.prod(shape)) or arr.shape[:2] != tuple(shape[:2]):
        raise png.PngDecodeError(
            f"Decoded image shape {arr.shape} does not match the spec's shape {shape}")
    return arr.reshape(shape)


def decode_image(data: bytes, spec: ExtendedTensorSpec) -> np.ndarray:
    """Decodes an encoded image to the spec's image shape and dtype; empty
    bytes give the zero image."""
    shape = image_shape(spec)
    dtype = parse_dtype(spec)
    if not data:
        return np.zeros(shape, dtype=dtype)
    channels = shape[-1] if len(shape) == 3 else 1
    if len(shape) not in (2, 3) or channels not in (1, 3):
        raise ValueError(
            f"Image spec {spec.name!r} shape {shape} is not HxW, HxWx1 or HxWx3")
    if png.is_png(data):
        arr = _decode_png(bytes(data), shape, channels)
        return arr if dtype == np.uint8 else arr.astype(dtype)
    rgb = np.empty(tuple(shape[:2]) + (3,), np.uint8)
    decode_into(data, rgb)
    if channels == 3:
        return rgb if dtype == np.uint8 else rgb.astype(dtype)
    return png.luma(rgb).reshape(shape).astype(dtype)


def decode_image_roi(data: bytes, spec: ExtendedTensorSpec, y: int, x: int,
                     th: int, tw: int) -> np.ndarray:
    """The (y, x, th, tw) window of `decode_image(data, spec)`, decoding
    only the window where the spec is a uint8 RGB image."""
    shape = image_shape(spec)
    dtype = parse_dtype(spec)
    if not data:
        return np.zeros((th, tw) + tuple(shape[2:]), dtype=dtype)
    if len(shape) == 3 and shape[-1] == 3 and dtype == np.uint8:
        out = np.empty((th, tw, 3), np.uint8)
        decode_roi_into(data, out, y, x, shape[:2])
        return out
    return decode_image(data, spec)[y : y + th, x : x + tw]


def encode_jpeg(array: np.ndarray, quality: int = 95) -> bytes:
    """Baseline JPEG of a uint8 HxW, HxWx1 or HxWx3 image (4:2:0 chroma
    for colour) at `quality`."""
    arr = np.ascontiguousarray(np.asarray(array, dtype=np.uint8))
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        channels = 1
    elif arr.ndim == 3 and arr.shape[-1] == 3:
        channels = 3
    else:
        raise ValueError(f"cannot encode an image of shape {arr.shape}")
    lib = _lib()
    capacity = arr.nbytes + (64 << 10)
    out_len = ctypes.c_size_t()
    for _ in range(2):
        out = ctypes.create_string_buffer(capacity)
        rc = lib.t2r_encode_jpeg(arr.ctypes.data, arr.shape[0], arr.shape[1],
                                 channels, quality, ctypes.addressof(out),
                                 capacity, ctypes.byref(out_len))
        if rc != -3:
            break
        capacity = out_len.value
    COUNTS.add("encodes")
    if rc != 0:
        raise RuntimeError(f"jpeg encode failed (codec code {rc})")
    return out.raw[: out_len.value]


def encode_image(array: np.ndarray, data_format: str, quality: int = 95) -> bytes:
    """Encodes an image for a spec's data_format ('jpeg', 'jpg' or 'png';
    quality is JPEG's)."""
    if data_format.lower() == "png":
        COUNTS.add("png_encodes")
        return png.encode_png(np.asarray(array, dtype=np.uint8))
    return encode_jpeg(array, quality)
