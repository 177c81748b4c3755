"""MetaExample assembly: one record holding a task's episodes as prefixed
feature columns.

Port of tensor2robot_tpu/meta_learning/meta_example.py over serialized
tf.Example / tf.SequenceExample bytes (the port has no protobuf: its
records are wire-format bytes, data/encoder.py and data/wire.py). Episode
i of the condition (inference) set contributes every feature-map entry
under `condition_ep<i>/<name>` (`inference_ep<i>/<name>`), the layout
`preprocessors.create_metaexample_spec` parses back. The entries' values
are copied byte for byte.

Wire layout used: Example {Features features = 1}; SequenceExample
{Features context = 1; FeatureLists feature_lists = 2}; Features and
FeatureLists each {map<string, ...> = 1}, a map entry {key = 1; value = 2}.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

_LEN = 2  # the length-delimited wire type


def _varint(value: int) -> bytes:
    out = bytearray()
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    value, shift = 0, 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint in a serialized Example")
        byte = data[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if byte < 0x80:
            return value, pos
        shift += 7


def _len_field(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | _LEN) + _varint(len(payload)) + payload


def _len_fields(data: bytes) -> Iterator[Tuple[int, bytes]]:
    """(field number, payload) of each field of a message; every field of
    the messages read here is length-delimited."""
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        if tag & 7 != _LEN:
            raise ValueError(f"field {tag >> 3} has wire type {tag & 7}, not a "
                             "length-delimited Example field")
        size, pos = _read_varint(data, pos)
        if pos + size > len(data):
            raise ValueError("truncated field in a serialized Example")
        yield tag >> 3, data[pos:pos + size]
        pos += size


def _map_entries(message: bytes) -> List[Tuple[str, bytes]]:
    """(key, serialized value) of each entry of a Features or FeatureLists
    message's map (field 1)."""
    entries = []
    for field, entry in _len_fields(message):
        if field != 1:
            continue
        key, value = "", b""
        for entry_field, payload in _len_fields(entry):
            if entry_field == 1:
                key = payload.decode("utf-8")
            elif entry_field == 2:
                value = payload
        entries.append((key, value))
    return entries


def _prefixed(message: bytes, prefix: str) -> bytes:
    """A map message's entries re-keyed to `<prefix>/<key>`, serialized."""
    return b"".join(
        _len_field(1, _len_field(1, f"{prefix}/{key}".encode("utf-8"))
                   + _len_field(2, value))
        for key, value in _map_entries(message))


def _parts(serialized: bytes) -> Tuple[bytes, bytes]:
    """(features or context, feature_lists) map entries of one record."""
    maps = {1: b"", 2: b""}
    for field, payload in _len_fields(serialized):
        if field in maps:
            maps[field] += payload
    return maps[1], maps[2]


def _is_sequence(serialized: bytes) -> bool:
    return any(field == 2 for field, _ in _len_fields(serialized))


class _MetaRecord:
    """Accumulates re-keyed entries; `serialize` writes the record."""

    def __init__(self, sequence: bool):
        self.sequence = sequence
        self.features = b""
        self.feature_lists = b""

    def serialize(self) -> bytes:
        out = _len_field(1, self.features) if self.features else b""
        if self.sequence and self.feature_lists:
            out += _len_field(2, self.feature_lists)
        return out


def append_example(meta_example: _MetaRecord, ep_example: bytes, prefix: str) -> None:
    """Adds every feature of the serialized Example `ep_example` to
    `meta_example` under `<prefix>/`."""
    features, _ = _parts(ep_example)
    meta_example.features += _prefixed(features, prefix)


def append_sequence_example(meta_example: _MetaRecord, ep_example: bytes,
                            prefix: str) -> None:
    """SequenceExample variant: prefixes both the context features and the
    feature_lists."""
    context, feature_lists = _parts(ep_example)
    meta_example.features += _prefixed(context, prefix)
    meta_example.feature_lists += _prefixed(feature_lists, prefix)


def make_meta_example(
    condition_examples: Sequence[bytes],
    inference_examples: Sequence[bytes],
) -> bytes:
    """One serialized MetaExample from per-episode serialized records: a
    SequenceExample when any record has feature_lists, else an Example."""
    records = list(condition_examples) + list(inference_examples)
    sequence = any(_is_sequence(bytes(record)) for record in records)
    meta = _MetaRecord(sequence)
    append_fn = append_sequence_example if sequence else append_example
    for i, example in enumerate(condition_examples):
        append_fn(meta, bytes(example), f"condition_ep{i}")
    for i, example in enumerate(inference_examples):
        append_fn(meta, bytes(example), f"inference_ep{i}")
    return meta.serialize()
