"""The T2RAssets sidecar: an export's spec contract as protobuf text.

Every export ships `assets.extra/t2r_assets.pbtxt` holding its feature and
label specs and its global step, so predictors rebuild the input contract
without model code. Port of tensor2robot_tpu/specs/proto_io.py for the
schema of tensor2robot_tpu/proto/t2r.proto (messages T2RAssets,
TensorSpecStructProto, ExtendedTensorSpecProto). The port does not import
protobuf, so this module writes and parses the text format of that one
schema itself, as protobuf's `text_format.MessageToString` prints it:

  * fields in field-number order; a proto3 scalar at its default (0,
    false, "") is left out, a set message field is printed even when
    empty (`label_spec {` / `}`);
  * nested messages indented by two spaces;
  * map entries (`key_value`) sorted by key, each as `key: ...` then
    `value { ... }`;
  * strings in double quotes, the ASCII control characters as three-digit
    octal escapes, `\\t \\n \\r \\" \\' \\\\` as C escapes, any other
    character as it is (UTF-8);
  * `varlen_default_value`, a float32, as the shortest of `%.6g`..`%.9g`
    that reads back to the same float32, printed as a Python float.

Dtypes travel as numpy names ("float32", "uint8", "bfloat16"); an unknown
dim is -1.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Dict, List, Optional, Tuple

import torch

from tensor2robot_tpu_torch.specs.spec import (
    ExtendedTensorSpec,
    canonical_dtype,
    numpy_dtype,
)
from tensor2robot_tpu_torch.specs.struct import TensorSpecStruct
from tensor2robot_tpu_torch.specs.utils import flatten_spec_structure

T2R_ASSETS_FILENAME = "t2r_assets.pbtxt"
ASSETS_EXTRA_DIR = "assets.extra"

# ExtendedTensorSpecProto's scalar fields in field-number order (shape,
# field 1, is printed apart as a repeated field).
_SPEC_FIELDS = (
    ("dtype", str), ("name", str), ("is_optional", bool),
    ("is_extracted", bool), ("is_sequence", bool), ("data_format", str),
    ("dataset_key", str), ("has_varlen_default_value", bool),
    ("varlen_default_value", float),
)
_SPEC_TYPES = dict(_SPEC_FIELDS, shape=int)


# -- scalars -----------------------------------------------------------------------


def _escape_table() -> Dict[int, str]:
    table = {i: "\\%03o" % i for i in range(128) if not 32 <= i < 127}
    table.update({
        ord("\t"): r"\t", ord("\n"): r"\n", ord("\r"): r"\r",
        ord('"'): r"\"", ord("'"): r"\'", ord("\\"): r"\\",
    })
    return table


_ESCAPES = _escape_table()


def _float32(value: float) -> float:
    return struct.unpack("<f", struct.pack("<f", value))[0]


def _float32_from_double(value: float) -> float:
    """A double rounded to float32 as protobuf stores a float field:
    values past float32's range become infinities."""
    try:
        return _float32(value)
    except OverflowError:
        return float("inf") if value > 0 else float("-inf")


def _format_float(value: float) -> str:
    if value != value:  # nan
        return str(value)
    precision = 6
    rounded = float(f"{value:.{precision}g}")
    while _float32_from_double(rounded) != value:
        precision += 1
        rounded = float(f"{value:.{precision}g}")
    return str(rounded)


def _format_scalar(value, kind) -> str:
    if kind is str:
        return '"' + value.translate(_ESCAPES) + '"'
    if kind is bool:
        return "true" if value else "false"
    if kind is float:
        return _format_float(value)
    return str(int(value))


def _dtype_name(dtype) -> str:
    dtype = canonical_dtype(dtype)
    if dtype == torch.bfloat16:
        return "bfloat16"
    return numpy_dtype(dtype).name


# -- writing -----------------------------------------------------------------------


def spec_to_fields(spec: ExtendedTensorSpec) -> Dict[str, object]:
    """The ExtendedTensorSpecProto of a spec, as {field: value} with
    proto3 defaults for the unset fields."""
    fields = {
        "shape": [-1 if d is None else int(d) for d in spec.shape],
        "dtype": _dtype_name(spec.dtype),
        "name": spec.name or "",
        "is_optional": bool(spec.is_optional),
        "is_extracted": bool(spec.is_extracted),
        "is_sequence": bool(spec.is_sequence),
        "data_format": spec.data_format or "",
        "dataset_key": spec.dataset_key or "",
        "has_varlen_default_value": spec.varlen_default_value is not None,
        "varlen_default_value": 0.0,
    }
    if spec.varlen_default_value is not None:
        fields["varlen_default_value"] = _float32_from_double(
            float(spec.varlen_default_value)
        )
    return fields


def _spec_lines(spec: ExtendedTensorSpec, indent: str) -> List[str]:
    fields = spec_to_fields(spec)
    lines = [f"{indent}shape: {d}" for d in fields["shape"]]
    for name, kind in _SPEC_FIELDS:
        value = fields[name]
        # proto3 leaves a field at its default out (a float by its bits,
        # so -0.0 is printed).
        if (struct.pack("<f", value) != bytes(4) if kind is float
                else value != kind()):
            lines.append(f"{indent}{name}: {_format_scalar(value, kind)}")
    return lines


def _struct_lines(structure, indent: str) -> List[str]:
    flat = flatten_spec_structure(structure)
    lines = []
    for key, spec in flat.items():
        if not isinstance(spec, ExtendedTensorSpec):
            raise ValueError(
                f"Only spec structures serialize; {key!r} is not a spec."
            )
        lines.append(f"{indent}keys: {_format_scalar(key, str)}")
    inner = indent + "    "
    for key in sorted(flat.keys()):
        lines.append(f"{indent}key_value {{")
        lines.append(f"{indent}  key: {_format_scalar(key, str)}")
        lines.append(f"{indent}  value {{")
        lines.extend(_spec_lines(flat[key], inner))
        lines.append(f"{indent}  }}")
        lines.append(f"{indent}}}")
    return lines


def assets_to_text(feature_spec, label_spec=None, global_step: int = 0) -> str:
    """The T2RAssets message of the specs and step in text format."""
    lines = ["feature_spec {"]
    lines.extend(_struct_lines(feature_spec, "  "))
    lines.append("}")
    if label_spec is not None:
        lines.append("label_spec {")
        lines.extend(_struct_lines(label_spec, "  "))
        lines.append("}")
    if int(global_step):
        lines.append(f"global_step: {int(global_step)}")
    return "".join(line + "\n" for line in lines)


def write_t2r_assets(
    export_dir: str,
    feature_spec,
    label_spec=None,
    global_step: int = 0,
) -> str:
    """Writes assets.extra/t2r_assets.pbtxt under `export_dir` (to a .tmp
    file renamed into place); returns its path."""
    assets_dir = os.path.join(export_dir, ASSETS_EXTRA_DIR)
    os.makedirs(assets_dir, exist_ok=True)
    path = os.path.join(assets_dir, T2R_ASSETS_FILENAME)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(assets_to_text(feature_spec, label_spec, global_step))
    os.replace(tmp, path)
    return path


# -- parsing -----------------------------------------------------------------------

_TOKEN = re.compile(
    r"""\s+|\#[^\n]*|(?P<punct>[{}<>:;,\[\]])"""
    r"""|(?P<string>"(?:[^"\\\n]|\\.)*"|'(?:[^'\\\n]|\\.)*')"""
    r"""|(?P<word>[-+]?(?:0[xX][0-9a-fA-F]+"""
    r"""|(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][-+]?[0-9]+)?[fF]?"""
    r"""|[A-Za-z_][A-Za-z0-9_]*))""",
    re.DOTALL,
)
_SIMPLE_ESCAPES = {
    "n": 10, "t": 9, "r": 13, '"': 34, "'": 39, "\\": 92, "a": 7, "b": 8,
    "f": 12, "v": 11, "?": 63,
}


def _unescape(body: str) -> str:
    out = bytearray()
    i = 0
    while i < len(body):
        char = body[i]
        if char != "\\":
            out += char.encode("utf-8")
            i += 1
            continue
        nxt = body[i + 1]
        if nxt in _SIMPLE_ESCAPES:
            out.append(_SIMPLE_ESCAPES[nxt])
            i += 2
        elif nxt in "01234567":
            digits = re.match(r"[0-7]{1,3}", body[i + 1:]).group()
            out.append(int(digits, 8) & 0xFF)
            i += 1 + len(digits)
        elif nxt in "xX":
            digits = re.match(r"[0-9a-fA-F]{1,2}", body[i + 2:]).group()
            out.append(int(digits, 16))
            i += 2 + len(digits)
        else:
            raise ValueError(f"unknown escape \\{nxt} in a pbtxt string")
    return out.decode("utf-8")


def _tokens(text: str) -> List[Tuple[str, str]]:
    tokens, pos = [], 0
    while pos < len(text):
        match = _TOKEN.match(text, pos)
        if match is None:
            raise ValueError(
                f"t2r_assets.pbtxt: cannot parse at {text[pos:pos + 20]!r}"
            )
        pos = match.end()
        for kind in ("punct", "string", "word"):
            if match.group(kind) is not None:
                tokens.append((kind, match.group(kind)))
    return tokens


def _parse_message(tokens, pos: int, close: Optional[str]):
    """{field: [values]} of one message; values are strings (quoted
    strings unescaped), words, or nested messages as dicts."""
    fields: Dict[str, list] = {}
    while True:
        if pos == len(tokens):
            if close is not None:
                raise ValueError("t2r_assets.pbtxt: unclosed message")
            return fields, pos
        kind, value = tokens[pos]
        if close is not None and (kind, value) == ("punct", close):
            return fields, pos + 1
        if kind != "word":
            raise ValueError(f"t2r_assets.pbtxt: expected a field, got {value!r}")
        name, pos = value, pos + 1
        if tokens[pos] == ("punct", ":"):
            pos += 1
        kind, value = tokens[pos]
        if (kind, value) in (("punct", "{"), ("punct", "<")):
            nested, pos = _parse_message(
                tokens, pos + 1, "}" if value == "{" else ">"
            )
            fields.setdefault(name, []).append(nested)
        elif kind == "string":
            parts = []
            while pos < len(tokens) and tokens[pos][0] == "string":
                parts.append(_unescape(tokens[pos][1][1:-1]))
                pos += 1
            fields.setdefault(name, []).append(("string", "".join(parts)))
        elif kind == "word":
            fields.setdefault(name, []).append(("word", value))
            pos += 1
        elif value == "[":  # a repeated scalar's list form: [1, 2]
            pos += 1
            while tokens[pos] != ("punct", "]"):
                if tokens[pos][0] == "punct":
                    if tokens[pos][1] != ",":
                        raise ValueError(f"t2r_assets.pbtxt: bad list for {name}")
                else:
                    entry = tokens[pos]
                    if entry[0] == "string":
                        entry = ("string", _unescape(entry[1][1:-1]))
                    fields.setdefault(name, []).append(entry)
                pos += 1
            pos += 1
        else:
            raise ValueError(f"t2r_assets.pbtxt: bad value {value!r} for {name}")
        if pos < len(tokens) and tokens[pos] in (("punct", ";"), ("punct", ",")):
            pos += 1


def _scalar(entry, kind, field: str):
    tag, text = entry
    if kind is str:
        if tag != "string":
            raise ValueError(f"t2r_assets.pbtxt: {field} must be a string")
        return text
    if tag != "word":
        raise ValueError(f"t2r_assets.pbtxt: {field} must not be a string")
    if kind is bool:
        if text in ("true", "True", "t", "1"):
            return True
        if text in ("false", "False", "f", "0"):
            return False
        raise ValueError(f"t2r_assets.pbtxt: {field}: bad bool {text!r}")
    if kind is float:
        lowered = text.lower()
        if lowered.lstrip("-+") not in ("inf", "infinity", "nan"):
            lowered = lowered.rstrip("f")  # a C float suffix, as in 1.5f
        return _float32_from_double(float(lowered))
    return int(text, 0)


def _singular(fields, name, kind, where):
    values = fields.get(name, [])
    if len(values) > 1:
        raise ValueError(f"t2r_assets.pbtxt: {where}.{name} set twice")
    return _scalar(values[0], kind, name) if values else kind()


def _message(fields, name, where) -> Optional[dict]:
    values = fields.get(name, [])
    if len(values) > 1:
        raise ValueError(f"t2r_assets.pbtxt: {where}.{name} set twice")
    if values and not isinstance(values[0], dict):
        raise ValueError(f"t2r_assets.pbtxt: {where}.{name} must be a message")
    return values[0] if values else None


def _check_known(fields, known, where) -> None:
    unknown = set(fields) - set(known)
    if unknown:
        raise ValueError(f"t2r_assets.pbtxt: unknown fields {sorted(unknown)} in {where}")


def spec_from_fields(fields: dict) -> ExtendedTensorSpec:
    _check_known(fields, _SPEC_TYPES, "ExtendedTensorSpecProto")
    values = {
        name: _singular(fields, name, kind, "ExtendedTensorSpecProto")
        for name, kind in _SPEC_FIELDS
    }
    shape = tuple(
        None if d == -1 else d
        for d in (_scalar(e, int, "shape") for e in fields.get("shape", []))
    )
    return ExtendedTensorSpec(
        shape=shape,
        dtype=canonical_dtype(values["dtype"]),
        name=values["name"] or None,
        is_optional=values["is_optional"],
        is_extracted=values["is_extracted"],
        is_sequence=values["is_sequence"],
        data_format=values["data_format"] or None,
        dataset_key=values["dataset_key"],
        varlen_default_value=(
            values["varlen_default_value"]
            if values["has_varlen_default_value"] else None
        ),
    )


def _struct_from_fields(fields: dict) -> TensorSpecStruct:
    _check_known(fields, ("keys", "key_value"), "TensorSpecStructProto")
    entries: Dict[str, ExtendedTensorSpec] = {}
    for entry in fields.get("key_value", []):
        if not isinstance(entry, dict):
            raise ValueError("t2r_assets.pbtxt: key_value must be a message")
        _check_known(entry, ("key", "value"), "key_value")
        key = _singular(entry, "key", str, "key_value")
        # A later entry of the same key replaces an earlier one (protobuf's
        # map semantics).
        entries[key] = spec_from_fields(_message(entry, "value", "key_value") or {})
    keys = [_scalar(e, str, "keys") for e in fields.get("keys", [])]
    out = TensorSpecStruct()
    for key in keys or sorted(entries):
        out[key] = entries[key]
    return out


def assets_from_text(
    text: str,
) -> Tuple[TensorSpecStruct, Optional[TensorSpecStruct], int]:
    """(feature_spec, label_spec, global_step) of a T2RAssets text; an
    absent or empty label spec reads as None."""
    fields, _ = _parse_message(_tokens(text), 0, None)
    _check_known(fields, ("feature_spec", "label_spec", "global_step"), "T2RAssets")
    feature = _message(fields, "feature_spec", "T2RAssets") or {}
    label = _message(fields, "label_spec", "T2RAssets")
    label_spec = None
    if label is not None and label.get("key_value"):
        label_spec = _struct_from_fields(label)
    return (
        _struct_from_fields(feature),
        label_spec,
        _singular(fields, "global_step", int, "T2RAssets"),
    )


def read_t2r_assets(
    export_dir: str,
) -> Tuple[TensorSpecStruct, Optional[TensorSpecStruct], int]:
    """Reads the sidecar; returns (feature_spec, label_spec, global_step)."""
    path = os.path.join(export_dir, ASSETS_EXTRA_DIR, T2R_ASSETS_FILENAME)
    with open(path, encoding="utf-8") as f:
        return assets_from_text(f.read())
