"""PNG decode and encode without PIL.

The JAX package reads and writes PNG image features through PIL, which
the card's machine does not have. This module reads the chunks, checks
their CRCs, inflates the IDAT stream with Python's zlib, reverses the row
filters in native code (`data/csrc/png_unfilter.cc`, built by
data/native.py; `unfilter_numpy` is the plain version the tests hold it
against), unpacks sub-byte samples and undoes Adam7 interlacing.

Supported: bit depth 8 in colour types 0 (L), 2 (RGB), 4 (LA) and 6
(RGBA); colour type 3 (palette) at bit depths 1, 2, 4 and 8; greyscale at
bit depths 1, 2 and 4; non-interlaced and Adam7. Sixteen-bit samples raise
NotImplementedError (ROADMAP.md A12(b)).

`to_rgb` and `to_luma` convert a decoded image as PIL's convert("RGB")
and convert("L") do: alpha is dropped, a palette is looked up, sub-byte
greyscale is scaled to 0..255 (x255, x85, x17), and luma is PIL's integer
(19595 R + 38470 G + 7471 B + 0x8000) >> 16, of the palette's colours for
a palette image.

`encode_png` writes 8-bit L, LA, RGB or RGBA images, or palette indices
at bit depth 1, 2, 4 or 8, with one filter type for every row (0-4) and
optionally Adam7. Its bytes differ from PIL's; the pixels read back are
the same.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from tensor2robot_tpu_torch.data import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
BIT_DEPTH_ITEM = "A12(b)"

#: Colour type -> samples per pixel.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
#: Adam7 passes: (x0, y0, dx, dy).
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))
_GREY_SCALE = {1: 255, 2: 85, 4: 17, 8: 1}


class PngDecodeError(ValueError):
    """A malformed PNG stream, or one of another geometry than the spec."""


@dataclass
class PngImage:
    """A decoded PNG: `samples` [H, W, C] uint8 in the file's colour type
    (palette indices for type 3, sub-byte greyscale unscaled)."""

    samples: np.ndarray
    color_type: int
    bit_depth: int
    palette: Optional[np.ndarray] = None  # [N, 3] uint8


def is_png(data: bytes) -> bool:
    return bytes(data[:8]) == SIGNATURE


# -- row filters ----------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = native.load("png_unfilter")
    if not getattr(lib, "_t2r_bound", False):
        lib.t2r_png_unfilter.restype = ctypes.c_int
        lib.t2r_png_unfilter.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
        lib._t2r_bound = True
    return lib


def unfilter(data: bytes, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """[height, row_bytes] reconstructed scanlines of `height` filtered
    ones (a type byte and row_bytes bytes each), by the native code."""
    out = np.empty((height, row_bytes), np.uint8)
    bad = ctypes.c_int(-1)
    rc = _lib().t2r_png_unfilter(data, len(data), out.ctypes.data, height, row_bytes, bpp,
                                 ctypes.byref(bad))
    if rc == -1:
        raise PngDecodeError(f"PNG image data is short: {len(data)} bytes for {height} "
                             f"rows of {row_bytes}")
    if rc == -2:
        raise PngDecodeError(f"PNG row {bad.value} has an unknown filter type")
    if rc != 0:
        raise PngDecodeError(f"PNG unfilter failed (code {rc})")
    return out


def unfilter_numpy(data: bytes, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """The plain version of `unfilter`, in numpy."""
    rows = np.frombuffer(data, np.uint8)[: height * (row_bytes + 1)]
    if rows.size < height * (row_bytes + 1):
        raise PngDecodeError("PNG image data is short")
    rows = rows.reshape(height, row_bytes + 1)
    out = np.zeros((height, row_bytes), np.uint8)
    prior = np.zeros(row_bytes, np.int32)
    for y in range(height):
        kind, src = rows[y, 0], rows[y, 1:].astype(np.int32)
        row = np.zeros(row_bytes + bpp, np.int32)  # bpp leading zeros: "a" at i < bpp
        up = np.concatenate([np.zeros(bpp, np.int32), prior])
        if kind in (0, 2):
            row[bpp:] = (src + (prior if kind == 2 else 0)) & 0xFF
        elif kind in (1, 3, 4):
            for i in range(row_bytes):
                a, b, c = row[i], up[i + bpp], up[i]
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row[i + bpp] = (src[i] + pred) & 0xFF
        else:
            raise PngDecodeError(f"PNG row {y} has an unknown filter type")
        out[y] = row[bpp:]
        prior = row[bpp:]
    return out


# -- decode ---------------------------------------------------------------------


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise PngDecodeError(f"PNG chunk {kind!r} is truncated")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise PngDecodeError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise PngDecodeError("PNG stream ends before IEND")


def _unpack(rows: np.ndarray, width: int, bit_depth: int, channels: int) -> np.ndarray:
    """[h, row_bytes] scanlines -> [h, width, channels] uint8 samples."""
    if bit_depth == 8:
        return rows[:, : width * channels].reshape(rows.shape[0], width, channels)
    bits = np.unpackbits(rows, axis=1)
    bits = bits[:, : width * bit_depth].reshape(rows.shape[0], width, bit_depth)
    weights = (1 << np.arange(bit_depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[..., None]


def _row_bytes(width: int, bit_depth: int, channels: int) -> int:
    return (width * bit_depth * channels + 7) // 8


def decode_png(data: bytes, unfilter_fn=unfilter) -> PngImage:
    """Decodes a PNG byte string to its samples in its own colour type."""
    data = bytes(data)
    if not is_png(data):
        raise PngDecodeError("not a PNG stream (bad signature)")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise PngDecodeError("PNG IHDR has the wrong size")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if len(body) % 3:
                raise PngDecodeError("PNG palette is not whole RGB entries")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PngDecodeError("PNG stream has no IHDR")
    width, height, bit_depth, color_type, compression, filter_method, interlace = header
    if color_type not in _CHANNELS or compression or filter_method or interlace > 1:
        raise PngDecodeError(f"PNG header is invalid: colour type {color_type}, "
                             f"methods {compression}/{filter_method}/{interlace}")
    if bit_depth == 16:
        raise NotImplementedError(
            f"16-bit PNG samples are not supported yet (ROADMAP.md {BIT_DEPTH_ITEM})")
    allowed = {0: (1, 2, 4, 8), 3: (1, 2, 4, 8)}.get(color_type, (8,))
    if bit_depth not in allowed:
        raise PngDecodeError(f"PNG bit depth {bit_depth} is invalid for colour type "
                             f"{color_type}")
    if color_type == 3 and palette is None:
        raise PngDecodeError("palette PNG has no PLTE chunk")
    if width == 0 or height == 0:
        raise PngDecodeError("PNG image is empty")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as err:
        raise PngDecodeError(f"PNG image data does not inflate: {err}") from None
    channels = _CHANNELS[color_type]
    bpp = max(1, bit_depth * channels // 8)
    if not interlace:
        rows = unfilter_fn(raw, height, _row_bytes(width, bit_depth, channels), bpp)
        samples = _unpack(rows, width, bit_depth, channels)
    else:
        samples = np.zeros((height, width, channels), np.uint8)
        pos = 0
        for x0, y0, dx, dy in ADAM7:
            pw, ph = max(0, -(-(width - x0) // dx)), max(0, -(-(height - y0) // dy))
            if pw == 0 or ph == 0:
                continue
            row_bytes = _row_bytes(pw, bit_depth, channels)
            size = ph * (row_bytes + 1)
            rows = unfilter_fn(raw[pos:pos + size], ph, row_bytes, bpp)
            samples[y0::dy, x0::dx] = _unpack(rows, pw, bit_depth, channels)
            pos += size
    return PngImage(np.ascontiguousarray(samples), color_type, bit_depth, palette)


def _palette_rgb(image: PngImage) -> np.ndarray:
    palette = np.zeros((256, 3), np.uint8)
    palette[: len(image.palette)] = image.palette
    return palette[image.samples[..., 0]]


def luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's RGB -> L conversion, integer for integer."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _grey(image: PngImage) -> np.ndarray:
    return image.samples[..., 0] * np.uint8(_GREY_SCALE[image.bit_depth])


def to_rgb(image: PngImage) -> np.ndarray:
    """[H, W, 3] uint8, as PIL's convert("RGB")."""
    if image.color_type == 3:
        return _palette_rgb(image)
    if image.color_type in (0, 4):
        return np.repeat(_grey(image)[..., None], 3, axis=2)
    return np.ascontiguousarray(image.samples[..., :3])


def to_luma(image: PngImage) -> np.ndarray:
    """[H, W] uint8, as PIL's convert("L")."""
    if image.color_type in (0, 4):
        return _grey(image)
    if image.color_type == 3:
        return luma(_palette_rgb(image))
    return luma(image.samples[..., :3])


# -- encode ---------------------------------------------------------------------


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filter_rows(rows: np.ndarray, bpp: int, filter_type: int) -> np.ndarray:
    """[h, row_bytes] raw scanlines -> [h, 1 + row_bytes] filtered ones."""
    x = rows.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp] if bpp < x.shape[1] else 0
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp] if bpp < x.shape[1] else 0
    if filter_type == 0:
        pred = 0
    elif filter_type == 1:
        pred = a
    elif filter_type == 2:
        pred = b
    elif filter_type == 3:
        pred = (a + b) >> 1
    elif filter_type == 4:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"PNG filter type must be 0-4, got {filter_type}")
    out = ((x - pred) & 0xFF).astype(np.uint8)
    kinds = np.full((rows.shape[0], 1), filter_type, np.uint8)
    return np.concatenate([kinds, out], axis=1)


def _pack(samples: np.ndarray, bit_depth: int) -> np.ndarray:
    """[h, w, c] samples -> [h, row_bytes] scanlines."""
    h = samples.shape[0]
    if bit_depth == 8:
        return samples.reshape(h, -1)
    bits = np.unpackbits(samples.reshape(h, -1, 1), axis=2)[:, :, 8 - bit_depth:]
    return np.packbits(bits.reshape(h, -1), axis=1)


def encode_png(array: np.ndarray, filter_type: int = 2, interlace: bool = False,
               palette: Optional[np.ndarray] = None, bit_depth: int = 8) -> bytes:
    """A PNG of a uint8 image: HxW or HxWx1 (L), HxWx2 (LA), HxWx3 (RGB)
    or HxWx4 (RGBA) at bit depth 8; or, with `palette` ([N, 3] uint8),
    HxW indices at bit depth 1, 2, 4 or 8. Every row takes `filter_type`."""
    arr = np.asarray(array)
    if arr.dtype != np.uint8:
        raise ValueError(f"PNG encode takes uint8 samples, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[0] == 0 or arr.shape[1] == 0:
        raise ValueError(f"cannot encode an image of shape {np.asarray(array).shape}")
    chunks: List[bytes] = []
    if palette is not None:
        palette = np.asarray(palette, np.uint8).reshape(-1, 3)
        if arr.shape[-1] != 1 or bit_depth not in (1, 2, 4, 8):
            raise ValueError("a palette image is HxW indices at bit depth 1, 2, 4 or 8")
        if int(arr.max()) >= min(len(palette), 1 << bit_depth):
            raise ValueError("palette index out of range")
        color_type = 3
        chunks.append(_chunk(b"PLTE", palette.tobytes()))
    else:
        if bit_depth != 8:
            raise ValueError("only palette images take a bit depth other than 8")
        color_type = {1: 0, 2: 4, 3: 2, 4: 6}.get(arr.shape[-1])
        if color_type is None:
            raise ValueError(f"cannot encode {arr.shape[-1]} channels")
    h, w, channels = arr.shape
    bpp = max(1, bit_depth * channels // 8)
    if interlace:
        parts = []
        for x0, y0, dx, dy in ADAM7:
            sub = arr[y0::dy, x0::dx]
            if sub.shape[0] and sub.shape[1]:
                parts.append(_filter_rows(_pack(sub, bit_depth), bpp, filter_type))
        raw = b"".join(p.tobytes() for p in parts)
    else:
        raw = _filter_rows(_pack(arr, bit_depth), bpp, filter_type).tobytes()
    header = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, int(interlace))
    return (SIGNATURE + _chunk(b"IHDR", header) + b"".join(chunks)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))

