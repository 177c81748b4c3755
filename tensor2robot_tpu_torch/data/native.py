"""Builds the data stack's native libraries with g++ at first use.

Three sources under `data/csrc/`: `tfrecord_io.cc` (CRC32-C and record
framing), `png_unfilter.cc` (PNG row filters) and the JPEG codec. The
JPEG codec is picked once per process by a probe of the host's headers:
`jpeg_codec.cc` over libjpeg where `<jpeglib.h>` exists (with
libjpeg-turbo's cropped-scanline API when the header declares it), else
`jpeg_codec_nvjpeg.cc` over the CUDA toolkit's nvJPEG where `nvjpeg.h`
exists, else the build raises. There is no
fallback from one codec to the other at run time, and none to Python.

Each library goes to `build/native/` (gitignored) under a name that
carries a hash of its source and flags, so an edited source rebuilds and
concurrent builds (parse processes, test workers) never load a half-
written file: a build writes a temporary file and renames it into place.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared", "-Wall")
_LOCK = threading.Lock()


def _cuda_home() -> Path:
    return Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))


def _compiles(snippet: str) -> str:
    """The preprocessed text of `snippet`, or '' when g++ refuses it."""
    result = subprocess.run(
        ["g++", "-E", "-x", "c++", "-"], input=snippet, capture_output=True,
        text=True, check=False,
    )
    return result.stdout if result.returncode == 0 else ""


@functools.lru_cache(maxsize=None)
def codec_build() -> Tuple[str, str, Tuple[str, ...], Tuple[str, ...]]:
    """(codec name, source file, extra compile flags, link flags) of the
    JPEG codec this host builds: libjpeg when g++ finds <jpeglib.h>, else
    nvJPEG when the CUDA toolkit has nvjpeg.h; raises when neither."""
    text = _compiles("#include <cstdio>\n#include <jpeglib.h>\n")
    if text:
        roi = ("-DT2R_HAVE_JPEG_ROI",) if "jpeg_crop_scanline" in text else ()
        return "libjpeg", "jpeg_codec.cc", roi, ("-ljpeg",)
    cuda = _cuda_home()
    if (cuda / "include" / "nvjpeg.h").exists():
        lib = cuda / "lib64"
        return (
            "nvjpeg", "jpeg_codec_nvjpeg.cc", (f"-I{cuda / 'include'}",),
            (f"-L{lib}", f"-Wl,-rpath,{lib}", "-lnvjpeg", "-lcudart"),
        )
    raise RuntimeError(
        "no JPEG codec can be built here: g++ finds no <jpeglib.h> and "
        f"{cuda / 'include' / 'nvjpeg.h'} does not exist"
    )


def library_path(name: str, source: str, flags: Sequence[str]) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str, source: str, flags: Sequence[str] = (),
          libs: Sequence[str] = ()) -> Path:
    """Compiles csrc/<source> into build/native/ (once per library_path)
    and returns the shared library's path; raises with the compiler's
    output when g++ fails."""
    flags = tuple(_CXX_FLAGS) + tuple(flags)
    target = library_path(name, source, flags + tuple(libs))
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *flags, "-o", str(tmp), str(CSRC / source), *libs]
    result = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if result.returncode != 0:
        raise RuntimeError(
            f"g++ failed ({result.returncode}) building {CSRC / source}:\n"
            f"{result.stderr[-4000:]}"
        )
    os.replace(tmp, target)
    return target


@functools.lru_cache(maxsize=None)
def _load(name: str) -> ctypes.CDLL:
    if name in ("tfrecord_io", "png_unfilter"):
        path = build(name, f"{name}.cc")
    else:
        codec, source, flags, libs = codec_build()
        path = build(f"codec_{codec}", source, flags, libs)
    return ctypes.CDLL(str(path))


def load(name: str) -> ctypes.CDLL:
    """The loaded library 'tfrecord_io', 'png_unfilter' or 'jpeg_codec',
    built first if needed (thread-safe; once per process)."""
    with _LOCK:
        return _load(name)
