"""Wire-format batch parsing: spec-compiled Example decoding.

Port of tensor2robot_tpu/data/wire.py. `FastSpecParser` parses the
TFRecord `tf.Example` / `tf.SequenceExample` wire format straight from
the record bytes, a batch at a time:

  * one forward scan per record finds each feature's payload span
    (offset + length into the record bytes);
  * packed `float_list` payloads are read with `np.frombuffer` at their
    wire offset, packed `int64_list` varint runs are decoded vectorized
    (`decode_packed_varints`);
  * each field's batch array is allocated once and records decode
    straight into their slot (the JPEG codec writes into it), with an
    optional allocator for the image fields (data/dataset.py hands out
    pinned buffers from a ring on the card);
  * decoded images are optionally served from a content-keyed cache
    (`DecodeCache`, sized by T2R_DECODE_CACHE_MB).

`SpecParser` (data/parser.py) is the semantics oracle: the schema
compiler refuses specs it cannot prove equivalent (`supported == False`),
and any failure while fast-parsing a batch makes the dataset re-parse it
with `SpecParser`. The scanners are strict about wire framing (every LEN
frame must end exactly where it claims; skips may not cross EOF), so the
fast path never accepts a record the oracle refuses. They read untrusted
bytes: every bounds check of the JAX package's scanner is kept.

numpy has no bfloat16: a bfloat16 spec parses as float32 and leaves
`parse_batch` as a torch.bfloat16 tensor (`specs.parse_dtype`).

Wire layout (proto3 tf.Example):
  Example          = { 1: Features }
  SequenceExample  = { 1: Features (context), 2: FeatureLists }
  Features         = { 1: map<string, Feature> }
  FeatureLists     = { 1: map<string, FeatureList> }
  FeatureList      = { 1: repeated Feature }
  Feature          = oneof { 1: BytesList, 2: FloatList, 3: Int64List }
  BytesList.value  = repeated bytes        (one LEN frame per entry)
  FloatList.value  = packed fixed32 run(s) (proto3 default)
  Int64List.value  = packed varint run(s)
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tensor2robot_tpu_torch import flags
from tensor2robot_tpu_torch.data import codec
from tensor2robot_tpu_torch.data.roi import ResolvedROI
from tensor2robot_tpu_torch.specs import (
    ExtendedTensorSpec,
    TensorSpecStruct,
    flatten_spec_structure,
    parse_dtype,
)

__all__ = [
    "FastParseError",
    "FastSpecParser",
    "DecodeCache",
    "DeferredImages",
    "decode_packed_varints",
    "get_decode_cache",
    "reset_decode_cache",
    "scan_record",
]


class FastParseError(ValueError):
    """Raised when the fast path cannot parse a record it was compiled for.

    Callers treat this (and any other exception out of the fast path) as
    "fall back to SpecParser for this batch"."""


# -- varint / wire primitives -------------------------------------------------

_WT_VARINT, _WT_I64, _WT_LEN, _WT_I32 = 0, 1, 2, 5


def _uvarint(data: bytes, pos: int) -> Tuple[int, int]:
    """Reads one unsigned varint; returns (value, next_pos)."""
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise FastParseError("varint longer than 10 bytes")


def _skip_field(data: bytes, pos: int, wire_type: int) -> int:
    if wire_type == _WT_VARINT:
        _, pos = _uvarint(data, pos)
        return pos
    if wire_type == _WT_I64:
        return pos + 8
    if wire_type == _WT_LEN:
        length, pos = _uvarint(data, pos)
        return pos + length
    if wire_type == _WT_I32:
        return pos + 4
    raise FastParseError(f"unsupported wire type {wire_type}")


_SEVEN = np.uint64(7)


def decode_packed_varints(raw: np.ndarray) -> np.ndarray:
    """Vectorized decode of a packed int64 varint run -> int64 array.

    Protobuf int64 varints are little-endian base-128 with the high bit as
    continuation; negatives are 10-byte two's complement. The grouped
    shift/sum runs entirely in numpy: uint64 addition wraps mod 2^64, which
    IS two's-complement reassembly, so a final `.view(int64)` restores
    signs. Small non-negative ints (the overwhelmingly common case for
    action/flag features) are a single `astype` — every byte its own value.
    """
    if raw.size == 0:
        return np.empty(0, np.int64)
    is_end = raw < 0x80
    if is_end.all():  # all single-byte values
        return raw.astype(np.int64)
    if not is_end[-1]:
        raise FastParseError("truncated varint run")
    ends = np.flatnonzero(is_end)
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    lengths = ends - starts + 1
    if int(lengths.max()) > 10:
        raise FastParseError("varint longer than 10 bytes")
    payload = (raw & 0x7F).astype(np.uint64)
    idx = np.arange(raw.size, dtype=np.int64)
    shifts = (idx - np.repeat(starts, lengths)).astype(np.uint64) * _SEVEN
    return np.add.reduceat(payload << shifts, starts).view(np.int64)


# -- record scanning ----------------------------------------------------------
#
# A scanned Feature is the tuple (kind, spans, scalars):
#   kind:    1 bytes_list | 2 float_list | 3 int64_list | 0 unset
#   spans:   [(offset, length), ...] — bytes entries, or packed runs
#   scalars: values collected from UNPACKED float/int64 entries (rare
#            writers), or None. Mixing packed and unpacked is refused.

_Feature = Tuple[int, List[Tuple[int, int]], Optional[list]]


def _scan_feature(data: bytes, pos: int, end: int) -> _Feature:
    kind = 0
    spans: List[Tuple[int, int]] = []
    scalars: Optional[list] = None
    while pos < end:
        tag, pos = _uvarint(data, pos)
        fnum, wt = tag >> 3, tag & 7
        if fnum in (1, 2, 3) and wt == _WT_LEN:
            if kind and kind != fnum:
                # oneof re-assignment on the wire: last field wins.
                spans, scalars = [], None
            kind = fnum
            length, pos = _uvarint(data, pos)
            inner_end = pos + length
            if inner_end > end:
                raise FastParseError("value list frame exceeds feature")
            while pos < inner_end:
                tag2, pos = _uvarint(data, pos)
                f2, w2 = tag2 >> 3, tag2 & 7
                if f2 == 1 and w2 == _WT_LEN:
                    ln, pos = _uvarint(data, pos)
                    spans.append((pos, ln))
                    pos += ln
                elif f2 == 1 and w2 == _WT_I32 and fnum == 2:
                    if scalars is None:
                        scalars = []
                    scalars.append(
                        np.frombuffer(data, "<f4", count=1, offset=pos)[0]
                    )
                    pos += 4
                elif f2 == 1 and w2 == _WT_VARINT and fnum == 3:
                    value, pos = _uvarint(data, pos)
                    if scalars is None:
                        scalars = []
                    scalars.append(
                        value - (1 << 64) if value >= (1 << 63) else value
                    )
                else:
                    pos = _skip_field(data, pos, w2)
            if pos != inner_end:
                # A value entry claimed bytes past its list frame: the
                # oracle rejects this record, so the fast path must too.
                raise FastParseError("value list overran its frame")
        else:
            pos = _skip_field(data, pos, wt)
    if pos != end:
        raise FastParseError("feature scan overran its frame")
    return kind, spans, scalars


def _scan_features(
    data: bytes, pos: int, end: int, out: Dict[bytes, _Feature]
) -> None:
    """Scans a Features message (a map<string, Feature>) into `out`."""
    while pos < end:
        tag, pos = _uvarint(data, pos)
        if tag == 0x0A:  # map entry
            length, pos = _uvarint(data, pos)
            entry_end = pos + length
            if entry_end > end:
                raise FastParseError("map entry frame exceeds message")
            key = b""
            feature: Optional[_Feature] = None
            while pos < entry_end:
                tag2, pos = _uvarint(data, pos)
                if tag2 == 0x0A:  # key
                    klen, pos = _uvarint(data, pos)
                    key = data[pos : pos + klen]
                    pos += klen
                elif tag2 == 0x12:  # value Feature
                    flen, pos = _uvarint(data, pos)
                    if pos + flen > entry_end:
                        raise FastParseError("feature frame exceeds entry")
                    feature = _scan_feature(data, pos, pos + flen)
                    pos += flen
                else:
                    pos = _skip_field(data, pos, tag2 & 7)
            if pos != entry_end:
                raise FastParseError("map entry overran its frame")
            if feature is not None:
                out[key] = feature  # map semantics: last entry wins
        else:
            pos = _skip_field(data, pos, tag & 7)
    if pos != end:
        raise FastParseError("features scan overran its frame")


def _scan_feature_lists(
    data: bytes, pos: int, end: int, out: Dict[bytes, List[_Feature]]
) -> None:
    """Scans a FeatureLists message into {key: [per-step Feature, ...]}."""
    while pos < end:
        tag, pos = _uvarint(data, pos)
        if tag == 0x0A:  # map entry
            length, pos = _uvarint(data, pos)
            entry_end = pos + length
            if entry_end > end:
                raise FastParseError("map entry frame exceeds message")
            key = b""
            steps: List[_Feature] = []
            while pos < entry_end:
                tag2, pos = _uvarint(data, pos)
                if tag2 == 0x0A:  # key
                    klen, pos = _uvarint(data, pos)
                    key = data[pos : pos + klen]
                    pos += klen
                elif tag2 == 0x12:  # value FeatureList
                    flen, pos = _uvarint(data, pos)
                    flist_end = pos + flen
                    if flist_end > entry_end:
                        raise FastParseError(
                            "feature list frame exceeds entry"
                        )
                    while pos < flist_end:
                        tag3, pos = _uvarint(data, pos)
                        if tag3 == 0x0A:  # one step's Feature
                            slen, pos = _uvarint(data, pos)
                            if pos + slen > flist_end:
                                raise FastParseError(
                                    "step feature exceeds its list"
                                )
                            steps.append(_scan_feature(data, pos, pos + slen))
                            pos += slen
                        else:
                            pos = _skip_field(data, pos, tag3 & 7)
                    if pos != flist_end:
                        raise FastParseError(
                            "feature list overran its frame"
                        )
                else:
                    pos = _skip_field(data, pos, tag2 & 7)
            if pos != entry_end:
                raise FastParseError("map entry overran its frame")
            out[key] = steps
        else:
            pos = _skip_field(data, pos, tag & 7)
    if pos != end:
        raise FastParseError("feature lists scan overran its frame")


def scan_record(
    data: bytes, want_feature_lists: bool
) -> Tuple[Dict[bytes, _Feature], Dict[bytes, List[_Feature]]]:
    """One forward pass over an Example/SequenceExample record.

    Example.features and SequenceExample.context are both field 1 with the
    same Features payload, so a single scanner serves both message types;
    field 2 (feature_lists) only exists on SequenceExample and is skipped
    unless requested.
    """
    features: Dict[bytes, _Feature] = {}
    feature_lists: Dict[bytes, List[_Feature]] = {}
    pos, end = 0, len(data)
    while pos < end:
        tag, pos = _uvarint(data, pos)
        if tag == 0x0A:  # features / context
            length, pos = _uvarint(data, pos)
            if pos + length > end:
                raise FastParseError("features frame exceeds record")
            _scan_features(data, pos, pos + length, features)
            pos += length
        elif tag == 0x12 and want_feature_lists:
            length, pos = _uvarint(data, pos)
            if pos + length > end:
                raise FastParseError("feature lists frame exceeds record")
            _scan_feature_lists(data, pos, pos + length, feature_lists)
            pos += length
        else:
            pos = _skip_field(data, pos, tag & 7)
    if pos != end:
        # A skipped field claimed bytes past EOF: a truncated record,
        # which the oracle rejects, so the fast scan must too.
        raise FastParseError("record scan overran EOF (truncated record)")
    return features, feature_lists


class DecodeCache:
    """Byte-budgeted cache of decoded images, exact-verified per lookup.

    Replay-style training (the QT-Opt configuration repeats one file set)
    decodes the same encoded images every epoch. The cache sits inside the
    decode-into stage: a hit is one copy into the batch slot instead of a
    decode.

    The dict key is a cheap sampled fingerprint (length and head, middle
    and tail slices), and every fingerprint match is verified by comparing
    the stored encoded bytes with the query, so a collision degrades to a
    miss (and replaces the entry), never to wrong pixels.

    Eviction is insertion order (FIFO): for the cyclic epoch access
    pattern this equals LRU without per-hit bookkeeping. Gets are lock-free
    (a dict read and a bytes compare under the GIL); puts and evictions
    take a lock; hit/miss counters are best-effort under concurrency.
    Sized by T2R_DECODE_CACHE_MB (default 512; 0 disables).
    """

    def __init__(self, capacity_bytes: int):
        self.capacity_bytes = int(capacity_bytes)
        # fingerprint -> (encoded bytes, decoded readonly array)
        self._entries: "OrderedDict[Any, Tuple[bytes, np.ndarray]]" = (
            OrderedDict()
        )
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def fingerprint(sig, data: bytes):
        n = len(data)
        if n <= 96:
            return (sig, data)
        mid = n >> 1
        return (sig, n, data[:32], data[mid : mid + 32], data[-32:])

    def get(self, sig, data: bytes) -> Optional[np.ndarray]:
        entry = self._entries.get(self.fingerprint(sig, data))
        if entry is not None and entry[0] == data:
            self.hits += 1
            return entry[1]
        self.misses += 1
        return None

    def put(self, sig, data: bytes, value: np.ndarray) -> None:
        nbytes = value.nbytes + len(data)
        if nbytes > self.capacity_bytes:
            return
        value = value if value.flags.owndata else value.copy()
        value.setflags(write=False)
        key = self.fingerprint(sig, data)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1].nbytes + len(old[0])
            self._entries[key] = (data, value)
            self._bytes += nbytes
            while self._bytes > self.capacity_bytes and self._entries:
                _, (old_data, old_value) = self._entries.popitem(last=False)
                self._bytes -= old_value.nbytes + len(old_data)

    def thrashing(self) -> bool:
        """True when the cache is full and hits are negligible — the
        working set provably does not fit the byte budget (FIFO eviction
        under a cyclic epoch scan then yields ~0 hits forever). Callers
        use this to stop paying population costs for entries that will be
        evicted before they can ever be served: specifically, randomized-
        ROI decode stops full-frame decoding to feed the cache and drops
        to the pure (cheaper) ROI decode. Thresholds: full means >=90% of
        budget, negligible means <5% hit rate over >=512 lookups — a set
        that fits reaches a high hit rate by its second epoch, well
        before a full-at-512-lookups cache can misclassify it (the
        default 512 MB budget holds ~380 full QT-Opt frames)."""
        total = self.hits + self.misses
        return (
            total >= 512
            and self._bytes * 10 >= self.capacity_bytes * 9
            and self.hits * 20 < total
        )

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {
            "entries": len(self._entries),
            "bytes": self._bytes,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
        }


_decode_cache: Optional[DecodeCache] = None
_decode_cache_lock = threading.Lock()


def default_decode_cache_mb() -> int:
    return flags.get_int("T2R_DECODE_CACHE_MB")


def get_decode_cache() -> Optional[DecodeCache]:
    """Process-wide decode cache, or None when disabled (cache size 0)."""
    global _decode_cache
    if _decode_cache is None:
        with _decode_cache_lock:
            if _decode_cache is None:
                mb = default_decode_cache_mb()
                if mb == 0:
                    return None
                _decode_cache = DecodeCache(mb << 20)
    return _decode_cache


def reset_decode_cache() -> None:
    """Drops the process-wide cache (tests, measurement legs)."""
    global _decode_cache
    with _decode_cache_lock:
        _decode_cache = None


# -- spec compilation ---------------------------------------------------------

Rect = Tuple[int, int, int, int]
# An image allocator: shape -> a uint8 torch tensor the batch may keep.
Alloc = Callable[[Tuple[int, ...]], torch.Tensor]


class _CompiledField:
    """One spec's parse plan: where to look, how to decode, where to write."""

    __slots__ = (
        "key", "spec", "name_bytes", "kind", "out_dtype", "shape",
        "n_elements", "image_shape", "stack_size", "varlen", "pad_value",
        "optional", "native_image_ok", "cache_sig",
    )

    def is_image_field(self) -> bool:
        return self.image_shape is not None

    def __init__(self, key: str, spec: ExtendedTensorSpec):
        self.key = key
        self.spec = spec
        self.name_bytes = (spec.name or key).encode("utf-8")
        self.out_dtype = parse_dtype(spec)
        self.optional = spec.is_optional
        self.varlen = spec.varlen_default_value is not None
        self.shape = tuple(spec.shape)
        if spec.data_format is not None:
            self.kind = 1
            # As decode_image: the trailing 3 dims are the image.
            self.image_shape = (
                tuple(self.shape[-3:]) if len(self.shape) >= 3 else self.shape
            )
            if any(d is None for d in self.image_shape):
                raise FastParseError(
                    f"image spec {key!r} lacks static H/W/C: {self.shape}"
                )
            self.stack_size = (
                int(self.shape[0]) if len(self.shape) >= 4 else None
            )
            self.native_image_ok = (
                self.out_dtype == np.dtype(np.uint8)
                and len(self.image_shape) == 3
                and self.image_shape[-1] == 3
                and spec.data_format.lower() in ("jpeg", "jpg")
            )
            self.cache_sig = (
                self.image_shape, str(self.out_dtype), spec.data_format.lower(),
            )
            self.n_elements = None
            self.pad_value = None
            return
        self.image_shape = None
        self.stack_size = None
        self.native_image_ok = False
        self.cache_sig = None
        if np.issubdtype(self.out_dtype, np.floating):
            self.kind = 2
        elif (np.issubdtype(self.out_dtype, np.integer)
              or self.out_dtype == np.dtype(bool)):
            self.kind = 3
        else:
            raise FastParseError(
                f"no fast storage mapping for dtype {self.out_dtype} ({key!r})"
            )
        if self.varlen:
            if len(self.shape) != 1 or self.shape[0] is None:
                raise FastParseError(
                    f"varlen spec {key!r} must be rank-1, got {self.shape}"
                )
            # As pad_or_clip + astype(parse dtype): the pad scalar is made
            # in the storage dtype first, so float64 specs see the same
            # f32 rounding as the oracle.
            storage = np.float32 if self.kind == 2 else np.int64
            self.pad_value = np.asarray(
                spec.varlen_default_value, dtype=storage
            ).astype(self.out_dtype)[()]
            self.n_elements = None
        else:
            self.pad_value = None
            n = 1
            for dim in self.shape:
                if dim is None:
                    raise FastParseError(
                        f"FixedLen parse requires static shape, got "
                        f"{self.shape} ({key!r})"
                    )
                n *= dim
            self.n_elements = n

    # -- value materialization ------------------------------------------------

    def _values(self, record: bytes, feature: _Feature) -> np.ndarray:
        """A numeric feature's flat value array (storage dtype)."""
        kind, spans, scalars = feature
        if kind != self.kind:
            raise FastParseError(
                f"feature {self.key!r} stored as kind {kind}, spec expects "
                f"{self.kind}"
            )
        if scalars is not None:
            if spans:
                raise FastParseError("mixed packed/unpacked list encoding")
            dtype = np.float32 if self.kind == 2 else np.int64
            return np.asarray(scalars, dtype=dtype)
        if self.kind == 2:
            chunks = []
            for off, ln in spans:
                if ln % 4:
                    raise FastParseError("packed float run not 4-byte aligned")
                chunks.append(
                    np.frombuffer(record, "<f4", count=ln // 4, offset=off)
                )
        else:
            chunks = [
                decode_packed_varints(
                    np.frombuffer(record, np.uint8, count=ln, offset=off)
                )
                for off, ln in spans
            ]
        if not chunks:
            dtype = np.float32 if self.kind == 2 else np.int64
            return np.empty(0, dtype)
        return chunks[0] if len(chunks) == 1 else np.concatenate(chunks)

    # -- images ---------------------------------------------------------------

    def image_payloads(self, record: bytes, feature: _Feature,
                       roi: bool = False) -> List[bytes]:
        """The encoded images one record holds for this field, checked
        against the spec (a single image, or a stack of its size; a varlen
        stack is clipped to it)."""
        kind, spans, scalars = feature
        if kind != 1 or scalars is not None:
            raise FastParseError(f"image feature {self.key!r} not bytes_list")
        if roi and self.stack_size is not None:
            # normalize_decode_rois allows ROIs on single images only.
            raise FastParseError(
                f"ROI decode unsupported for image stack {self.key!r}")
        if self.stack_size is None:
            if len(spans) != 1:
                raise FastParseError(
                    f"feature {self.key!r} holds {len(spans)} images, spec "
                    "declares one"
                )
        elif self.varlen:
            spans = spans[: self.stack_size]
        elif len(spans) != self.stack_size:
            raise FastParseError(
                f"feature {self.key!r} holds {len(spans)} images, stack "
                f"requires {self.stack_size}"
            )
        return [record[off : off + ln] for off, ln in spans]

    def decode_payloads(self, datas: Sequence[bytes], out_slice: np.ndarray,
                        cache: Optional[DecodeCache], rect: Optional[Rect] = None,
                        randomized: bool = False) -> None:
        """Decodes `image_payloads`' result into the record's slot; a
        varlen stack's missing images are zeros."""
        if self.stack_size is None:
            self._decode_one_image(datas[0], out_slice, cache, rect, randomized)
            return
        for j, data in enumerate(datas):
            self._decode_one_image(data, out_slice[j], cache)
        if len(datas) < self.stack_size:
            out_slice[len(datas):] = 0

    def fill_image(self, record: bytes, feature: _Feature, out_slice: np.ndarray,
                   cache: Optional[DecodeCache], rect: Optional[Rect] = None,
                   randomized: bool = False) -> None:
        datas = self.image_payloads(record, feature, roi=rect is not None)
        self.decode_payloads(datas, out_slice, cache, rect, randomized)

    def _decode_one_image(self, data: bytes, out_slice: np.ndarray,
                          cache: Optional[DecodeCache],
                          rect: Optional[Rect] = None,
                          randomized: bool = False) -> None:
        if not data:
            out_slice[...] = 0
            return
        if rect is not None:
            self._decode_one_image_roi(data, out_slice, cache, rect, randomized)
            return
        if cache is not None:
            hit = cache.get(self.cache_sig, data)
            if hit is not None:
                out_slice[...] = hit
                return
        if self.native_image_ok and out_slice.flags.c_contiguous:
            codec.decode_into(data, out_slice)
            if cache is not None:
                cache.put(self.cache_sig, data, out_slice.copy())
            return
        arr = codec.decode_image(data, self.spec)
        out_slice[...] = arr
        if cache is not None:
            cache.put(self.cache_sig, data, np.ascontiguousarray(arr))

    def _roi_decode(self, data, out_slice, y, x, th, tw) -> None:
        """Window decode into the slot (bit-identical to a full decode and
        the crop)."""
        if self.native_image_ok and out_slice.flags.c_contiguous:
            codec.decode_roi_into(data, out_slice, y, x, self.image_shape[:2])
            return
        out_slice[...] = codec.decode_image(data, self.spec)[y : y + th, x : x + tw]

    def _decode_one_image_roi(self, data, out_slice, cache, rect,
                              randomized) -> None:
        """Cropped decode with a cache policy that follows how often the
        offsets repeat.

        Static offsets (center or fixed crops: eval) repeat every epoch, so
        the cache keys on (sig, rect) and stores the cropped window.
        Random offsets (the training crop) almost never repeat, so the
        cache keeps the full frame under the plain sig (shared with full
        decodes) and serves each window as a slice; only a miss pays the
        full decode. Once the cache reports `thrashing()` (full, hits
        negligible: the data set exceeds the budget), random crops stop
        feeding it and decode just the window.
        """
        y, x, th, tw = rect
        if cache is not None and randomized:
            hit = cache.get(self.cache_sig, data)
            if hit is not None:
                out_slice[...] = hit[y : y + th, x : x + tw]
                return
            if cache.thrashing():
                self._roi_decode(data, out_slice, y, x, th, tw)
                return
            arr = codec.decode_image(data, self.spec)
            out_slice[...] = arr[y : y + th, x : x + tw]
            cache.put(self.cache_sig, data, np.ascontiguousarray(arr))
            return
        if cache is not None:
            sig = (self.cache_sig, y, x, th, tw)
            hit = cache.get(sig, data)
            if hit is not None:
                out_slice[...] = hit
                return
            self._roi_decode(data, out_slice, y, x, th, tw)
            cache.put(sig, data, out_slice.copy())
            return
        self._roi_decode(data, out_slice, y, x, th, tw)

    def fill_numeric(self, record: bytes, feature: _Feature, batch: np.ndarray,
                     index) -> None:
        """Writes one record's value into batch[index] (index may be a
        tuple for sequence steps), through setitem so scalar-shaped specs
        land in the batch too."""
        values = self._values(record, feature)
        if self.varlen:
            out_slice = batch[index]
            target = int(self.shape[0])
            keep = min(values.size, target)
            out_slice[:keep] = values[:keep]
            if keep < target:
                out_slice[keep:] = self.pad_value
            return
        if values.size != self.n_elements:
            raise FastParseError(
                f"feature {self.key!r} has {values.size} elements, spec "
                f"{self.shape} requires {self.n_elements}"
            )
        batch[index] = values.reshape(self.shape)


class DeferredImages:
    """One image field of a batch whose decoding is left to another
    process: the batch array's shape and, per slot, its index in the array,
    the encoded images and the crop. A parse process of data/dataset.py
    makes these when the codec runs on the card (its workers must not
    touch CUDA); the parent decodes them with `FastSpecParser.finish`."""

    __slots__ = ("key", "shape", "slots", "randomized")

    def __init__(self, key: str, shape: Tuple[int, ...], randomized: bool):
        self.key = key
        self.shape = shape
        self.slots: List[Tuple[Any, List[bytes], Optional[Rect]]] = []
        self.randomized = randomized


def _missing(field: _CompiledField, present: List[bool], what: str) -> None:
    """Raises for a field that is absent from some records: a required
    field names the first, an optional one must be all-or-none."""
    if not field.optional:
        raise KeyError(
            f"Required {what}{field.spec.name or field.key!r} missing from "
            f"example {present.index(False)}"
        )
    raise ValueError(
        f"Optional feature {field.key!r} present in only some batch "
        "elements; optional features must be all-present or all-absent "
        "within a batch."
    )


class _CompiledGroup:
    """All fields of one dataset_key group and its record scanner."""

    def __init__(self, specs: Mapping[str, ExtendedTensorSpec]):
        self.context_fields: List[_CompiledField] = []
        self.sequence_fields: List[_CompiledField] = []
        for key, spec in specs.items():
            field = _CompiledField(key, spec)
            if spec.is_sequence:
                self.sequence_fields.append(field)
            else:
                self.context_fields.append(field)
        self.is_sequence = bool(self.sequence_fields)

    def parse_into(
        self,
        records: Sequence[bytes],
        out: Dict[str, Any],
        cache: Optional[DecodeCache],
        roi: Optional[Mapping[str, ResolvedROI]] = None,
        alloc: Optional[Alloc] = None,
        defer_images: bool = False,
    ) -> None:
        n = len(records)
        records = [bytes(r) for r in records]
        scans = [scan_record(r, self.is_sequence) for r in records]
        for field in self.context_fields:
            features = [scan[0].get(field.name_bytes) for scan in scans]
            present = [f is not None for f in features]
            if not all(present):
                if field.optional and not any(present):
                    continue
                _missing(field, present, "feature ")
            if not field.is_image_field():
                batch = np.empty((n,) + field.shape, dtype=field.out_dtype)
                for i in range(n):
                    field.fill_numeric(records[i], features[i], batch, i)
                out[field.key] = batch
                continue
            resolved = roi.get(field.key) if roi else None
            if resolved is not None:
                if len(resolved.ys) != n:
                    raise FastParseError(
                        f"ResolvedROI for {field.key!r} has "
                        f"{len(resolved.ys)} offsets, batch holds {n}"
                    )
                shape = ((n, resolved.height, resolved.width)
                         + tuple(field.shape[2:]))
                rects = [resolved.rect(i) for i in range(n)]
                randomized = resolved.randomized
            else:
                shape = (n,) + field.shape
                rects = [None] * n
                randomized = False
            payloads = [
                field.image_payloads(records[i], features[i], rects[i] is not None)
                for i in range(n)
            ]
            if defer_images:
                deferred = DeferredImages(field.key, shape, randomized)
                deferred.slots = [(i, payloads[i], rects[i]) for i in range(n)]
                out[field.key] = deferred
                continue
            batch, owner = _allocate(field, shape, alloc, zeros=False)
            for i in range(n):
                field.decode_payloads(payloads[i], batch[i], cache, rects[i],
                                      randomized)
            out[field.key] = owner
        for field in self.sequence_fields:
            steps = [scan[1].get(field.name_bytes) for scan in scans]
            present = [s is not None for s in steps]
            if not all(present):
                if field.optional and not any(present):
                    continue
                _missing(field, present, "sequence feature ")
            lengths = np.asarray([len(s) for s in steps], np.int64)
            max_len = int(lengths.max()) if n else 0
            shape = (n, max_len) + field.shape
            if field.is_image_field():
                slots = [
                    ((i, t), field.image_payloads(records[i], feature), None)
                    for i, record_steps in enumerate(steps)
                    for t, feature in enumerate(record_steps)
                ]
                if defer_images:
                    deferred = DeferredImages(field.key, shape, False)
                    deferred.slots = slots
                    out[field.key] = deferred
                else:
                    batch, owner = _allocate(field, shape, alloc, zeros=True)
                    for index, datas, _ in slots:
                        field.decode_payloads(datas, batch[index], cache)
                    out[field.key] = owner
            else:
                batch = np.zeros(shape, dtype=field.out_dtype)
                for i, record_steps in enumerate(steps):
                    for t, feature in enumerate(record_steps):
                        field.fill_numeric(records[i], feature, batch, (i, t))
                out[field.key] = batch
            out[field.key + "_length"] = lengths


def _allocate(field: _CompiledField, shape, alloc: Optional[Alloc], zeros: bool):
    """(array to fill, value the batch keeps): a uint8 image field goes
    into `alloc`'s tensor when there is one, else a fresh numpy array."""
    if alloc is not None and field.out_dtype == np.dtype(np.uint8):
        owner = alloc(tuple(shape))
        array = owner.numpy()
        if zeros:
            array[...] = 0
        return array, owner
    make = np.zeros if zeros else np.empty
    array = make(shape, dtype=field.out_dtype)
    return array, array


class FastSpecParser:
    """Drop-in fast twin of `SpecParser.parse_batch` with compile-time
    opt-out.

    `supported` is False when the spec structure uses storage the fast path
    does not implement (e.g. raw string features); callers then keep the
    `SpecParser` oracle. At run time any per-batch failure raises out of
    `parse_batch`; the dataset re-parses that batch with `SpecParser`.
    """

    def __init__(self, specs: Union[TensorSpecStruct, Mapping]):
        self._flat = flatten_spec_structure(specs)
        self._groups: Dict[str, _CompiledGroup] = {}
        self.supported = True
        self.unsupported_reason: Optional[str] = None
        self.fallbacks = 0
        grouped: Dict[str, Dict[str, ExtendedTensorSpec]] = {}
        for key, spec in self._flat.items():
            if isinstance(spec, ExtendedTensorSpec):
                grouped.setdefault(spec.dataset_key, {})[key] = spec
        try:
            for dataset_key, group in grouped.items():
                self._groups[dataset_key] = _CompiledGroup(group)
        except Exception as err:  # noqa: BLE001 — any compile failure keeps the oracle
            self.supported = False
            self.unsupported_reason = str(err)
        self._bf16_keys = [
            key for key, spec in self._flat.items()
            if isinstance(spec, ExtendedTensorSpec) and spec.dtype == torch.bfloat16
        ]

    @property
    def dataset_keys(self) -> Tuple[str, ...]:
        return tuple(self._groups.keys())

    def parse_batch(
        self,
        serialized_batch: Union[Sequence[bytes], Mapping[str, Sequence[bytes]]],
        cache: Optional[DecodeCache] = None,
        roi: Optional[Mapping[str, ResolvedROI]] = None,
        alloc: Optional[Alloc] = None,
        defer_images: bool = False,
    ) -> TensorSpecStruct:
        """Fast parse. `roi` ({flat key: ResolvedROI}) decodes the named
        image fields cropped, bit-identical to `SpecParser.parse_batch(...,
        roi=roi)`; `alloc` makes the uint8 image arrays; `defer_images`
        leaves images undecoded as `DeferredImages` (see `finish`)."""
        if not self.supported:
            raise FastParseError(
                f"unsupported spec structure: {self.unsupported_reason}"
            )
        if cache is None:
            cache = get_decode_cache()
        if isinstance(serialized_batch, Mapping):
            by_key = dict(serialized_batch)
        else:
            if list(self._groups.keys()) != [""]:
                raise ValueError(
                    "Multi-dataset specs require a dict of serialized "
                    f"records keyed by {sorted(self._groups.keys())}"
                )
            by_key = {"": list(serialized_batch)}
        sizes = {len(v) for v in by_key.values()}
        if not sizes or sizes == {0}:
            raise ValueError("Cannot parse an empty batch.")
        flat: Dict[str, Any] = {}
        for dataset_key, group in self._groups.items():
            if dataset_key not in by_key:
                raise KeyError(
                    f"Missing serialized record for dataset {dataset_key!r}"
                )
            group.parse_into(by_key[dataset_key], flat, cache, roi, alloc,
                             defer_images)
        out = TensorSpecStruct()
        for key, value in flat.items():
            out[key] = value
        return self._cast_bf16(out)

    def _cast_bf16(self, out: TensorSpecStruct) -> TensorSpecStruct:
        for key in self._bf16_keys:
            if key in out and isinstance(out[key], np.ndarray):
                out[key] = torch.from_numpy(out[key]).to(torch.bfloat16)
        return out

    def finish(self, batch: TensorSpecStruct, cache: Optional[DecodeCache] = None,
               alloc: Optional[Alloc] = None) -> TensorSpecStruct:
        """Decodes every `DeferredImages` of a batch in place (the parent's
        half of a `defer_images` parse)."""
        if cache is None:
            cache = get_decode_cache()
        fields = {field.key: field for group in self._groups.values()
                  for field in group.context_fields + group.sequence_fields}
        for key, value in list(batch.items()):
            if not isinstance(value, DeferredImages):
                continue
            field = fields[key]
            sequence = len(value.shape) == len(field.shape) + 2
            array, owner = _allocate(field, value.shape, alloc, zeros=sequence)
            for index, datas, rect in value.slots:
                field.decode_payloads(datas, array[index], cache, rect,
                                      value.randomized)
            batch[key] = owner
        return self._cast_bf16(batch)
