"""Spec-driven Example/SequenceExample parsing: the semantics oracle.

Port of tensor2robot_tpu/data/parser.py. A model declares what it
consumes and the parser for serialized records is derived from the
specs:

  * `data_format` set -> a bytes feature decoded to the spec's image shape
    (data/codec.py); an empty string decodes to a zero image.
  * floating dtypes  -> float_list (bfloat16 specs parse as float32 and
    leave as torch.bfloat16 tensors: numpy has no bfloat16).
  * integer/bool     -> int64_list, cast to the spec dtype.
  * `varlen_default_value` set -> variable-length parse, padded/clipped to
    the spec's static shape.
  * `is_sequence`    -> read from SequenceExample feature_lists (one step
    per list entry); other specs of the same dataset read from `context`.
    A `<key>_length` int64 scalar reports the true length; batching pads
    to the batch max.
  * `dataset_key`    -> specs are routed to named datasets; the parser then
    takes a dict of serialized records, one per key.

The JAX package parses with protobuf's generated classes; the port
decodes the wire format itself (`decode_example`), with protobuf's
semantics: unknown fields (groups included) are skipped, a repeated
message or list that appears twice is merged, a oneof takes its last
member, map entries replace earlier ones of the same key, map keys must
be UTF-8, packed and unpacked list entries mix, field number 0, wire types
6 and 7, unterminated groups, varints over 10 bytes and frames past their
end are refused. `FastSpecParser` (data/wire.py) falls back to this parser
for any batch it cannot parse, so both must refuse the same records; the
two share the packed-varint decoder.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tensor2robot_tpu_torch.data.codec import decode_image
from tensor2robot_tpu_torch.data.roi import apply_roi_to_batch
from tensor2robot_tpu_torch.data.wire import decode_packed_varints
from tensor2robot_tpu_torch.specs import (
    ExtendedTensorSpec,
    TensorSpecStruct,
    flatten_spec_structure,
    pad_or_clip_tensor_to_spec_shape,
    parse_dtype,
)

__all__ = [
    "DecodeError",
    "ExampleParser",
    "Feature",
    "SpecParser",
    "decode_example",
    "decode_image",
]


class DecodeError(ValueError):
    """The record is not a well-formed Example/SequenceExample."""


# -- the wire decoder ---------------------------------------------------------

_MASK64 = (1 << 64) - 1
_MAX_DEPTH = 100  # protobuf's default recursion limit
_KINDS = {1: "bytes_list", 2: "float_list", 3: "int64_list"}


def _varint(data: bytes, pos: int, end: int, max_bytes: int = 10) -> Tuple[int, int]:
    result = 0
    for i in range(max_bytes):
        if pos >= end:
            raise DecodeError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return result & _MASK64, pos
    raise DecodeError(f"varint longer than {max_bytes} bytes")


def _tag(data: bytes, pos: int, end: int) -> Tuple[int, int, int]:
    """(field number, wire type, next pos); tags are 32-bit varints."""
    tag, pos = _varint(data, pos, end, max_bytes=5)
    if tag >> 32:
        raise DecodeError("tag exceeds 32 bits")
    if tag >> 3 == 0:
        raise DecodeError("field number 0")
    return tag >> 3, tag & 7, pos


def _length(data: bytes, pos: int, end: int) -> Tuple[int, int]:
    """(end of a LEN frame, start of its payload)."""
    length, pos = _varint(data, pos, end)
    if length > end - pos:
        raise DecodeError("length-delimited frame exceeds its message")
    return pos + length, pos


def _skip(data: bytes, pos: int, end: int, field: int, wire_type: int,
          depth: int) -> int:
    """Skips one unknown field's value; returns the next position."""
    if wire_type == 0:
        return _varint(data, pos, end)[1]
    if wire_type in (1, 5):
        size = 8 if wire_type == 1 else 4
        if end - pos < size:
            raise DecodeError("truncated fixed-width field")
        return pos + size
    if wire_type == 2:
        return _length(data, pos, end)[0]
    if wire_type == 3:
        if depth >= _MAX_DEPTH:
            raise DecodeError("groups nested too deep")
        while True:
            if pos >= end:
                raise DecodeError("unterminated group")
            inner, inner_type, pos = _tag(data, pos, end)
            if inner_type == 4:
                if inner != field:
                    raise DecodeError("mismatched end-group tag")
                return pos
            pos = _skip(data, pos, end, inner, inner_type, depth + 1)
    raise DecodeError(f"invalid wire type {wire_type}")


class Feature:
    """A decoded tf.train.Feature: `kind` (1 bytes, 2 float, 3 int64, 0
    unset) and its values in wire order."""

    __slots__ = ("kind", "values")

    def __init__(self):
        self.kind = 0
        self.values: List[Any] = []

    def merge(self, data: bytes, pos: int, end: int, depth: int) -> None:
        while pos < end:
            field, wire_type, pos = _tag(data, pos, end)
            if field in _KINDS and wire_type == 2:
                if self.kind != field:  # the oneof switches: drop the old member
                    self.kind, self.values = field, []
                stop, pos = _length(data, pos, end)
                self._merge_list(data, pos, stop, depth + 1)
                pos = stop
            else:
                pos = _skip(data, pos, end, field, wire_type, depth)

    def _merge_list(self, data: bytes, pos: int, end: int, depth: int) -> None:
        while pos < end:
            field, wire_type, pos = _tag(data, pos, end)
            if field == 1 and wire_type == 2:
                stop, pos = _length(data, pos, end)
                if self.kind == 1:
                    self.values.append(data[pos:stop])
                elif self.kind == 2:
                    if (stop - pos) % 4:
                        raise DecodeError("packed float run not 4-byte aligned")
                    self.values.append(np.frombuffer(data, "<f4", (stop - pos) // 4, pos))
                else:
                    self.values.append(decode_packed_varints(
                        np.frombuffer(data, np.uint8, stop - pos, pos)))
                pos = stop
            elif field == 1 and wire_type == 5 and self.kind == 2:
                if end - pos < 4:
                    raise DecodeError("truncated float")
                self.values.append(np.frombuffer(data, "<f4", 1, pos))
                pos += 4
            elif field == 1 and wire_type == 0 and self.kind == 3:
                value, pos = _varint(data, pos, end)
                self.values.append(np.asarray([value], np.uint64).view(np.int64))
            else:
                pos = _skip(data, pos, end, field, wire_type, depth)

    def value_array(self) -> Tuple[int, Any]:
        """(kind, values): a list of bytes, or a float32/int64 array."""
        if self.kind == 1:
            return 1, list(self.values)
        if self.kind in (2, 3):
            dtype = np.float32 if self.kind == 2 else np.int64
            if not self.values:
                return self.kind, np.empty(0, dtype)
            return self.kind, np.concatenate(self.values).astype(dtype)
        return 0, None


def _map_entry(data: bytes, pos: int, end: int, depth: int, merge_value):
    """One map<string, V> entry: (key, value); `merge_value(value, data,
    pos, end)` merges a value frame into the entry's value."""
    key = b""
    value = None
    while pos < end:
        field, wire_type, pos = _tag(data, pos, end)
        if field == 1 and wire_type == 2:
            stop, pos = _length(data, pos, end)
            key = data[pos:stop]
            pos = stop
        elif field == 2 and wire_type == 2:
            stop, pos = _length(data, pos, end)
            value = merge_value(value, data, pos, stop, depth + 1)
            pos = stop
        else:
            pos = _skip(data, pos, end, field, wire_type, depth)
    try:
        return key.decode("utf-8"), value
    except UnicodeDecodeError as err:
        raise DecodeError("map key is not valid UTF-8") from err


def _merge_feature(value, data, pos, end, depth):
    value = value if value is not None else Feature()
    value.merge(data, pos, end, depth)
    return value


def _merge_feature_list(value, data, pos, end, depth):
    value = value if value is not None else []
    while pos < end:
        field, wire_type, pos = _tag(data, pos, end)
        if field == 1 and wire_type == 2:
            stop, pos = _length(data, pos, end)
            value.append(_merge_feature(None, data, pos, stop, depth + 1))
            pos = stop
        else:
            pos = _skip(data, pos, end, field, wire_type, depth)
    return value


def _merge_map(out: Dict, data, pos, end, depth, merge_value) -> None:
    while pos < end:
        field, wire_type, pos = _tag(data, pos, end)
        if field == 1 and wire_type == 2:
            stop, pos = _length(data, pos, end)
            key, value = _map_entry(data, pos, stop, depth + 1, merge_value)
            out[key] = value if value is not None else merge_value(
                None, data, stop, stop, depth + 1)
            pos = stop
        else:
            pos = _skip(data, pos, end, field, wire_type, depth)


def decode_example(
    data: bytes, sequence: bool
) -> Tuple[Dict[str, Feature], Dict[str, List[Feature]]]:
    """Decodes an Example (`sequence` False) or a SequenceExample into
    ({key: Feature} of features/context, {key: [Feature per step]} of
    feature_lists); raises DecodeError where protobuf refuses the bytes."""
    data = bytes(data)
    features: Dict[str, Feature] = {}
    feature_lists: Dict[str, List[Feature]] = {}
    pos, end = 0, len(data)
    while pos < end:
        field, wire_type, pos = _tag(data, pos, end)
        if field == 1 and wire_type == 2:
            stop, pos = _length(data, pos, end)
            _merge_map(features, data, pos, stop, 1, _merge_feature)
            pos = stop
        elif field == 2 and wire_type == 2 and sequence:
            stop, pos = _length(data, pos, end)
            _merge_map(feature_lists, data, pos, stop, 1, _merge_feature_list)
            pos = stop
        else:
            pos = _skip(data, pos, end, field, wire_type, 0)
    return features, feature_lists


# -- spec-driven conversion ---------------------------------------------------


def _num_elements(shape: Sequence[Optional[int]]) -> int:
    n = 1
    for d in shape:
        if d is None:
            raise ValueError(f"FixedLen parse requires static shape, got {shape}")
        n *= d
    return n


def _storage_kind(spec: ExtendedTensorSpec) -> int:
    if spec.data_format is not None:
        return 1
    dtype = parse_dtype(spec)
    if np.issubdtype(dtype, np.floating):
        return 2
    if np.issubdtype(dtype, np.integer) or dtype == np.dtype(bool):
        return 3
    raise ValueError(f"No storage mapping for spec dtype {dtype} ({spec.name!r})")


class _FieldParser:
    """Parses one spec's value out of a Features map or FeatureList."""

    def __init__(self, key: str, spec: ExtendedTensorSpec):
        self.key = key
        self.spec = spec
        self.lookup_name = spec.name or key
        self.kind = _storage_kind(spec)
        self.parse_dtype = parse_dtype(spec)

    def _convert(self, feature: Feature) -> np.ndarray:
        kind, values = feature.value_array()
        spec = self.spec
        if spec.data_format is not None:
            if kind != 1:
                raise ValueError(
                    f"Feature {self.lookup_name!r} stored as "
                    f"{_KINDS.get(kind, 'nothing')} but spec expects bytes_list")
            images = [decode_image(v, spec) for v in values]
            if spec.varlen_default_value is not None and len(spec.shape) >= 4:
                # Varlen image stacks pad with zero images, or clip, to the
                # spec's leading dim.
                target = int(spec.shape[0])
                images = images[:target]
                zero = np.zeros_like(images[0]) if images else np.zeros(
                    tuple(int(d) for d in spec.shape[1:]), self.parse_dtype)
                images = images + [zero] * (target - len(images))
                return np.stack(images)
            if len(spec.shape) <= 3:
                if len(images) != 1:
                    raise ValueError(
                        f"Feature {self.lookup_name!r} holds {len(images)} "
                        "images but the spec declares a single image "
                        f"{tuple(spec.shape)}"
                    )
                return images[0]
            if spec.shape[0] is not None and len(images) != spec.shape[0]:
                raise ValueError(
                    f"Feature {self.lookup_name!r} holds {len(images)} images "
                    f"but the spec stack requires {spec.shape[0]}"
                )
            return np.stack(images)
        if kind != self.kind:
            raise ValueError(
                f"Feature {self.lookup_name!r} stored as "
                f"{_KINDS.get(kind, 'nothing')} but spec expects "
                f"{_KINDS[self.kind]}"
            )
        if spec.varlen_default_value is not None:
            return pad_or_clip_tensor_to_spec_shape(values, spec).astype(
                self.parse_dtype)
        n = _num_elements(spec.shape)
        if values.size != n:
            raise ValueError(
                f"Feature {self.lookup_name!r} has {values.size} elements, spec "
                f"{tuple(spec.shape)} requires {n}"
            )
        return values.reshape(tuple(spec.shape)).astype(self.parse_dtype)

    def parse_context(self, features: Dict[str, Feature]) -> Optional[np.ndarray]:
        feature = features.get(self.lookup_name)
        if feature is None:
            if self.spec.is_optional:
                return None
            raise KeyError(
                f"Required feature {self.lookup_name!r} missing from example "
                f"(available: {sorted(features.keys())[:20]})"
            )
        return self._convert(feature)

    def parse_sequence(
        self, feature_lists: Dict[str, List[Feature]]
    ) -> Optional[Tuple[np.ndarray, int]]:
        steps_in = feature_lists.get(self.lookup_name)
        if steps_in is None:
            if self.spec.is_optional:
                return None
            raise KeyError(
                f"Required sequence feature {self.lookup_name!r} missing "
                f"(available: {sorted(feature_lists.keys())[:20]})"
            )
        steps = [self._convert(feature) for feature in steps_in]
        if not steps:
            shape = (0,) + tuple(int(d) for d in self.spec.shape)
            return np.zeros(shape, self.parse_dtype), 0
        return np.stack(steps), len(steps)


class ExampleParser:
    """Parses serialized records of one dataset_key group into a flat
    {path: np.ndarray} dict."""

    def __init__(self, specs: Union[TensorSpecStruct, Mapping]):
        flat = flatten_spec_structure(specs)
        self._fields: List[_FieldParser] = []
        self._sequence_fields: List[_FieldParser] = []
        for key, spec in flat.items():
            if not isinstance(spec, ExtendedTensorSpec):
                continue
            field = _FieldParser(key, spec)
            if spec.is_sequence:
                self._sequence_fields.append(field)
            else:
                self._fields.append(field)
        self.is_sequence_parser = bool(self._sequence_fields)

    def parse(self, serialized: bytes) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        context, feature_lists = decode_example(serialized, self.is_sequence_parser)
        for field in self._sequence_fields:
            parsed = field.parse_sequence(feature_lists)
            if parsed is not None:
                tensor, length = parsed
                out[field.key] = tensor
                out[field.key + "_length"] = np.asarray(length, np.int64)
        for field in self._fields:
            value = field.parse_context(context)
            if value is not None:
                out[field.key] = value
        return out


def _pad_to(arr: np.ndarray, length: int) -> np.ndarray:
    if arr.shape[0] == length:
        return arr
    pad = np.zeros((length - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0)


class SpecParser:
    """Spec-complete parser: multi-dataset routing, batching and the
    bfloat16 cast.

    parse_batch() parses a list of serialized records (or a dict of lists
    for multi-dataset specs), stacks them along a new batch axis, pads
    sequence features to the batch-max length, and hands bfloat16 specs on
    as torch.bfloat16 tensors.
    """

    def __init__(self, specs: Union[TensorSpecStruct, Mapping]):
        self._flat = flatten_spec_structure(specs)
        self._parsers: Dict[str, ExampleParser] = {}
        groups: Dict[str, TensorSpecStruct] = {}
        for key, spec in self._flat.items():
            if isinstance(spec, ExtendedTensorSpec):
                groups.setdefault(spec.dataset_key, TensorSpecStruct())[key] = spec
        for dataset_key, group in groups.items():
            self._parsers[dataset_key] = ExampleParser(group)
        self._bf16_keys = [
            key for key, spec in self._flat.items()
            if isinstance(spec, ExtendedTensorSpec) and spec.dtype == torch.bfloat16
        ]

    @property
    def dataset_keys(self) -> Tuple[str, ...]:
        return tuple(self._parsers.keys())

    def parse_single(
        self, serialized: Union[bytes, Mapping[str, bytes]]
    ) -> Dict[str, np.ndarray]:
        if isinstance(serialized, (bytes, bytearray)):
            if list(self._parsers.keys()) != [""]:
                raise ValueError(
                    "Multi-dataset specs require a dict of serialized records "
                    f"keyed by {sorted(self._parsers.keys())}"
                )
            return self._parsers[""].parse(bytes(serialized))
        out: Dict[str, np.ndarray] = {}
        for dataset_key, parser in self._parsers.items():
            if dataset_key not in serialized:
                raise KeyError(f"Missing serialized record for dataset {dataset_key!r}")
            out.update(parser.parse(serialized[dataset_key]))
        return out

    def parse_batch(
        self,
        serialized_batch: Union[Sequence[bytes], Mapping[str, Sequence[bytes]]],
        roi: Optional[Mapping[str, Any]] = None,
    ) -> TensorSpecStruct:
        """Parses and stacks a batch; `roi` ({key: ResolvedROI}) crops the
        named image fields after the full decode: the semantics decode-time
        ROI (data/wire.py) reproduces bit for bit."""
        if isinstance(serialized_batch, Mapping):
            n = len(next(iter(serialized_batch.values())))
            rows = [
                self.parse_single({k: v[i] for k, v in serialized_batch.items()})
                for i in range(n)
            ]
        else:
            rows = [self.parse_single(s) for s in serialized_batch]
        if not rows:
            raise ValueError("Cannot parse an empty batch.")
        out = TensorSpecStruct()
        all_keys = list(dict.fromkeys(key for row in rows for key in row.keys()))
        for key in all_keys:
            values = [row[key] for row in rows if key in row]
            if len(values) != len(rows):
                raise ValueError(
                    f"Optional feature {key!r} present in only some batch "
                    "elements; optional features must be all-present or "
                    "all-absent within a batch."
                )
            spec = self._flat[key] if key in self._flat else None
            if isinstance(spec, ExtendedTensorSpec) and spec.is_sequence:
                max_len = max(v.shape[0] for v in values)
                values = [_pad_to(v, max_len) for v in values]
            out[key] = np.stack(values)
        if roi:
            apply_roi_to_batch(out, roi)
        for key in self._bf16_keys:
            if key in out:
                out[key] = torch.from_numpy(out[key]).to(torch.bfloat16)
        return out
