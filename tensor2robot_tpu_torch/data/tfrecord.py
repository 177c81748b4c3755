"""TFRecord container IO through the native codec.

The record format is the public TFRecord framing (length + masked
CRC32-C + payload + CRC). Framing, indexing and CRCs run in
`data/csrc/tfrecord_io.cc`, built with g++ at first use and bound with
ctypes (data/native.py); a failed build raises. `masked_crc32c_plain` is
the same CRC in Python, kept as the plain version the tests hold the
native one against; no reading or writing path uses it.

Port of tensor2robot_tpu/data/tfrecord.py.
"""

from __future__ import annotations

import ctypes
import glob as globlib
import os
import struct
from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np

from tensor2robot_tpu_torch.data import native

_U64P = ctypes.POINTER(ctypes.c_uint64)


def _lib() -> ctypes.CDLL:
    lib = native.load("tfrecord_io")
    if not getattr(lib, "_t2r_bound", False):
        lib.t2r_masked_crc32c.restype = ctypes.c_uint32
        lib.t2r_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.t2r_index_records.restype = ctypes.c_int64
        lib.t2r_index_records.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, _U64P, _U64P, ctypes.c_size_t,
            ctypes.c_int,
        ]
        lib.t2r_index_records_partial.restype = ctypes.c_int64
        lib.t2r_index_records_partial.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, _U64P, _U64P, ctypes.c_size_t,
            ctypes.c_int, _U64P,
        ]
        lib.t2r_frame_record.restype = ctypes.c_size_t
        lib.t2r_frame_record.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
        ]
        lib._t2r_bound = True
    return lib


# -- plain CRC32-C (tests only) ------------------------------------------------


def _crc_table() -> np.ndarray:
    poly = 0x82F63B78
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table[i] = crc
    return table


def masked_crc32c_plain(data: bytes) -> int:
    """The masked CRC32-C byte by byte in Python: the plain version of
    the native codec's, for the tests."""
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = int(table[(crc ^ b) & 0xFF]) ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return ((crc >> 15) | (crc << 17) & 0xFFFFFFFF) + 0xA282EAD8 & 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    return _lib().t2r_masked_crc32c(bytes(data), len(data))


# -- writer -------------------------------------------------------------------


class TFRecordWriter:
    """Appends framed records to a file. Context-manager friendly."""

    def __init__(self, path: str):
        self._path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._file = open(path, "wb")

    def write(self, record: bytes) -> None:
        record = bytes(record)
        out = ctypes.create_string_buffer(16 + len(record))
        n = _lib().t2r_frame_record(record, len(record), out)
        self._file.write(out.raw[:n])

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()

    def __enter__(self) -> "TFRecordWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_tfrecords(path: str, records: Iterable[bytes]) -> int:
    """Writes all records; returns the count."""
    n = 0
    with TFRecordWriter(path) as writer:
        for record in records:
            writer.write(record)
            n += 1
    return n


# -- reader -------------------------------------------------------------------


class TFRecordCorruptionError(IOError):
    pass


def index_tfrecord_buffer(
    buf: bytes, verify_crc: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (offsets, lengths) arrays of record payloads inside `buf`."""
    lib = _lib()
    buf = bytes(buf)
    # Two passes: count (the scan is bandwidth-bound anyway), then fill.
    count = lib.t2r_index_records(buf, len(buf), None, None, 0,
                                  1 if verify_crc else 0)
    if count < 0:
        raise TFRecordCorruptionError(f"Corrupt TFRecord data at byte {-count - 1}")
    offsets = (ctypes.c_uint64 * count)()
    lengths = (ctypes.c_uint64 * count)()
    lib.t2r_index_records(buf, len(buf), offsets, lengths, count, 0)
    return (
        np.frombuffer(offsets, dtype=np.uint64).copy(),
        np.frombuffer(lengths, dtype=np.uint64).copy(),
    )


# How much of a shard the reader holds at once: large enough to amortize
# syscalls and native calls over many records, small enough that the
# interleaver can keep several shards open.
_READ_BUFFER_BYTES = 8 << 20
# Records indexed per native call at most (bounds the scratch arrays).
_INDEX_BATCH = 4096


def read_tfrecords(
    path: str, verify_crc: bool = True, buffer_bytes: int = _READ_BUFFER_BYTES
) -> Iterator[bytes]:
    """Streams record payloads from a TFRecord file with bounded memory:
    reads `buffer_bytes` at a time and indexes every complete record of
    the block in one native call."""
    lib = _lib()
    offsets = (ctypes.c_uint64 * _INDEX_BATCH)()
    lengths = (ctypes.c_uint64 * _INDEX_BATCH)()
    consumed = ctypes.c_uint64()
    with open(path, "rb") as f:
        base = 0  # file offset of buf[0]
        buf = b""
        want = buffer_bytes
        while True:
            chunk = f.read(want)
            want = buffer_bytes
            if chunk:
                buf = buf + chunk if buf else chunk
            while buf:
                count = lib.t2r_index_records_partial(
                    buf, len(buf), offsets, lengths, _INDEX_BATCH,
                    1 if verify_crc else 0, ctypes.byref(consumed),
                )
                if count < 0:
                    raise TFRecordCorruptionError(
                        f"Corrupt TFRecord data at byte {base - count - 1}"
                    )
                if count == 0:
                    break
                for i in range(count):
                    off = offsets[i]
                    yield buf[off : off + lengths[i]]
                buf = buf[consumed.value :]
                base += consumed.value
            if not chunk:
                if buf:
                    raise TFRecordCorruptionError(
                        f"Truncated record at byte {base} "
                        f"({len(buf)} trailing bytes)"
                    )
                return
            if len(buf) >= 12:
                # The partial indexer reports an over-long length claim as
                # an incomplete tail: bound it before buffering more (a
                # corrupt length must error, not accrete memory), and read
                # the rest of a record larger than the block in one go.
                (length,) = struct.unpack_from("<Q", buf, 0)
                if length > (1 << 40):
                    raise TFRecordCorruptionError(
                        f"Implausible record length at {base}"
                    )
                needed = 12 + int(length) + 4 - len(buf)
                if needed > buffer_bytes:
                    want = needed


def count_tfrecords(path: str) -> int:
    """Counts records by header hopping (seeks past payloads)."""
    count = 0
    pos = 0
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return count
            if len(header) < 12:
                raise TFRecordCorruptionError(f"Truncated record header at {pos}")
            (length,) = struct.unpack_from("<Q", header, 0)
            (header_crc,) = struct.unpack_from("<I", header, 8)
            if masked_crc32c(header[:8]) != header_crc:
                raise TFRecordCorruptionError(f"Bad header CRC at {pos}")
            f.seek(length + 4, 1)
            pos += 12 + length + 4
            count += 1


def list_files(file_patterns: Sequence[str] | str) -> List[str]:
    """Expands comma-separated glob patterns to a sorted file list."""
    if isinstance(file_patterns, str):
        file_patterns = [p for p in file_patterns.split(",") if p]
    files: List[str] = []
    for pattern in file_patterns:
        matches = sorted(globlib.glob(pattern))
        if not matches and os.path.exists(pattern):
            matches = [pattern]
        files.extend(matches)
    if not files:
        raise FileNotFoundError(f"No files match patterns {file_patterns!r}")
    return files
