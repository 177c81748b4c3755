"""Spec-driven Example/SequenceExample encoding: the write side.

Port of tensor2robot_tpu/data/encoder.py, used by record writers, test
fixtures and `chip_smoke.py`. numpy structures that conform to a spec are
serialized so that the parsers read them back exactly. The JAX package
builds protobuf messages and encodes images with PIL; the port writes the
protobuf wire format itself (proto3 tf.Example: packed floats and
varints, one LEN frame per bytes entry) and encodes images with the
native codec (data/codec.py, JPEG at quality 95). The bytes may differ
from protobuf's (map order is not a contract); what a parser reads back
is the same.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Union

import numpy as np

from tensor2robot_tpu_torch.data.codec import encode_image
from tensor2robot_tpu_torch.specs import (
    ExtendedTensorSpec,
    TensorSpecStruct,
    flatten_spec_structure,
    parse_dtype,
)

__all__ = ["encode_example", "encode_examples_by_dataset", "encode_image"]


def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1  # negatives as 64-bit two's complement
    out = bytearray()
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _len_field(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _image_values(spec: ExtendedTensorSpec, value: Any) -> List[bytes]:
    if isinstance(value, (bytes, bytearray)):
        # Pre-encoded image bytes pass through unchanged: writers usually
        # hold the camera's JPEG already, and a re-encode is lossy.
        return [bytes(value)]
    arr = np.asarray(value)
    if arr.dtype.kind in ("S", "O", "U"):
        items = []
        for item in arr.ravel():
            if isinstance(item, str):
                items.append(item.encode())
            elif isinstance(item, (bytes, bytearray, np.bytes_)):
                items.append(bytes(item))
            else:
                raise ValueError(
                    f"Pre-encoded image values for {spec.name!r} must "
                    f"be bytes/str, got {type(item).__name__}"
                )
        return items
    if arr.ndim >= 4:
        # An image stack: one encoded entry per leading-dim image.
        return [encode_image(image, spec.data_format) for image in arr]
    return [encode_image(arr, spec.data_format)]


def _feature(spec: ExtendedTensorSpec, value: Any) -> bytes:
    """A serialized tf.train.Feature of `value` under `spec`."""
    if spec.data_format is not None:
        return _len_field(1, b"".join(
            _len_field(1, item) for item in _image_values(spec, value)))
    dtype = parse_dtype(spec)
    if np.issubdtype(dtype, np.floating):
        floats = np.asarray(value, dtype=np.float32).ravel()
        packed = _len_field(1, floats.astype("<f4").tobytes()) if floats.size else b""
        return _len_field(2, packed)
    if np.issubdtype(dtype, np.integer) or dtype == np.dtype(bool):
        ints = np.asarray(value, dtype=np.int64).ravel()
        run = b"".join(_varint(int(v)) for v in ints)
        return _len_field(3, _len_field(1, run) if ints.size else b"")
    raise ValueError(f"Cannot encode dtype {dtype} for {spec.name!r}")


def _map_entry(key: str, value: bytes) -> bytes:
    return _len_field(1, _len_field(1, key.encode("utf-8")) + _len_field(2, value))


def encode_example(
    specs: Union[TensorSpecStruct, Mapping], values: Union[TensorSpecStruct, Mapping]
) -> bytes:
    """Serializes one (unbatched) spec-conforming structure.

    Sequence specs expect a leading time dimension and are written to the
    feature_lists of a SequenceExample (one Feature per step); everything
    else lands in Example.features / SequenceExample.context.
    """
    flat_specs = flatten_spec_structure(specs)
    flat_values = flatten_spec_structure(values)
    context: Dict[str, bytes] = {}
    feature_lists: Dict[str, bytes] = {}
    for key, spec in flat_specs.items():
        if not isinstance(spec, ExtendedTensorSpec):
            continue
        if key not in flat_values:
            if spec.is_optional:
                continue
            raise ValueError(f"Missing value for required spec {key!r}")
        value = flat_values[key]
        name = spec.name or key
        if spec.is_sequence:
            steps = b"".join(
                _len_field(1, _feature(spec, step)) for step in np.asarray(value))
            feature_lists[name] = feature_lists.get(name, b"") + steps
        else:
            context[name] = _feature(spec, value)
    features = b"".join(_map_entry(k, v) for k, v in context.items())
    out = _len_field(1, features) if features else b""
    if feature_lists:
        out += _len_field(2, b"".join(
            _map_entry(k, v) for k, v in feature_lists.items()))
    return out


def encode_examples_by_dataset(
    specs: Union[TensorSpecStruct, Mapping], values: Union[TensorSpecStruct, Mapping]
) -> Dict[str, bytes]:
    """Multi-dataset encoding: one serialized record per dataset_key."""
    flat_specs = flatten_spec_structure(specs)
    groups: Dict[str, TensorSpecStruct] = {}
    for key, spec in flat_specs.items():
        if isinstance(spec, ExtendedTensorSpec):
            groups.setdefault(spec.dataset_key, TensorSpecStruct())[key] = spec
    return {
        dataset_key: encode_example(group, values)
        for dataset_key, group in groups.items()
    }
