"""Typed tensor specifications — the contract core of the framework.

`ExtendedTensorSpec` declares the shape/dtype/name of a tensor a model
consumes or produces, plus data-sourcing metadata (optionality,
sequence-ness, on-disk image encoding, multi-dataset routing, varlen
padding). Every other layer — preprocessing, serving validation, fixture
generation — is derived from structures of these specs.

Port of tensor2robot_tpu/specs/spec.py. Dtypes are canonical
`torch.dtype`s: numpy dtypes, numpy type objects, strings ('float32',
'bfloat16') and torch dtypes all normalize to one, so a spec compares
equal to numpy arrays and torch tensors alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

# Image encodings we can decode from serialized byte features.
_VALID_DATA_FORMATS = frozenset(["jpeg", "png", "JPEG", "PNG"])

_NUMPY_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}
_TORCH_TO_NUMPY = {v: k for k, v in _NUMPY_TO_TORCH.items()}


def canonical_dtype(dtype: Any) -> torch.dtype:
    """Normalizes any dtype-like (str, np.dtype, numpy type, torch.dtype)
    to a torch.dtype. 'bfloat16' (and numpy extension dtypes of that
    name) map to torch.bfloat16."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype == "bfloat16":
        return torch.bfloat16
    np_dtype = np.dtype(dtype)
    if np_dtype.name == "bfloat16":
        return torch.bfloat16
    try:
        return _NUMPY_TO_TORCH[np_dtype]
    except KeyError:
        raise TypeError(f"dtype {np_dtype} has no torch counterpart") from None


def numpy_dtype(dtype: Any) -> np.dtype:
    """The numpy dtype of a spec dtype (bfloat16 has none and raises)."""
    torch_dtype = canonical_dtype(dtype)
    try:
        return _TORCH_TO_NUMPY[torch_dtype]
    except KeyError:
        raise TypeError(f"{torch_dtype} has no numpy counterpart") from None


@dataclasses.dataclass(frozen=True)
class ExtendedTensorSpec:
    """A tensor contract: shape (without batch dim), dtype, and metadata.

    Attributes:
      shape: Tensor shape *excluding* the batch dimension. Entries may be
        ``None`` for dimensions only known at runtime.
      dtype: Element dtype (canonical torch.dtype; bfloat16 supported).
      name: The feature key used to look the tensor up in serialized
        examples and feed dicts. Distinct from the *path* a spec occupies
        inside a TensorSpecStruct.
      is_optional: Optional tensors may be absent from inputs; validation
        drops them rather than failing.
      is_sequence: The feature carries a variable leading time dimension.
      is_extracted: Marks a spec as already extracted from raw data.
      data_format: 'jpeg'/'png' if the on-disk representation is an encoded
        image string that must be decoded to this spec's shape.
      dataset_key: Routes the feature to a named dataset ('' = default).
      varlen_default_value: If set, the feature is a variable-length list
        padded (with this value) or clipped to the spec shape.
    """

    shape: Tuple[Optional[int], ...]
    dtype: torch.dtype
    name: Optional[str] = None
    is_optional: bool = False
    is_sequence: bool = False
    is_extracted: bool = False
    data_format: Optional[str] = None
    dataset_key: str = ""
    varlen_default_value: Optional[float] = None

    def __post_init__(self):
        raw = self.shape
        if raw is None:
            raw = ()
        if isinstance(raw, (int, np.integer)):
            raw = (int(raw),)
        shape = tuple(None if d is None else int(d) for d in raw)
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "dtype", canonical_dtype(self.dtype))
        if (
            self.data_format is not None
            and self.data_format not in _VALID_DATA_FORMATS
        ):
            raise ValueError(
                f"data_format must be one of {sorted(_VALID_DATA_FORMATS)}, "
                f"got {self.data_format!r}"
            )
        if self.varlen_default_value is not None and self.data_format is None:
            if len(shape) != 1 or shape[0] is None:
                raise ValueError(
                    "varlen_default_value requires a rank-1 shape with a "
                    f"concrete length (or an image data_format); got {shape}"
                )

    @classmethod
    def from_spec(
        cls, spec: "ExtendedTensorSpec", **overrides
    ) -> "ExtendedTensorSpec":
        """Copy `spec`, overriding any subset of fields (duck-typed: any
        object exposing shape/dtype is accepted)."""
        base = dict(
            shape=tuple(spec.shape) if spec.shape is not None else (),
            dtype=spec.dtype,
            name=getattr(spec, "name", None),
            is_optional=getattr(spec, "is_optional", False),
            is_sequence=getattr(spec, "is_sequence", False),
            is_extracted=getattr(spec, "is_extracted", False),
            data_format=getattr(spec, "data_format", None),
            dataset_key=getattr(spec, "dataset_key", ""),
            varlen_default_value=getattr(spec, "varlen_default_value", None),
        )
        base.update(overrides)
        return cls(**base)

    # Equality is shape + dtype only (the reference's contract).
    def __eq__(self, other: Any) -> bool:
        if not hasattr(other, "shape") or not hasattr(other, "dtype"):
            return NotImplemented
        try:
            other_dtype = canonical_dtype(other.dtype)
        except TypeError:
            return False
        return (
            tuple(self.shape) == tuple(other.shape)
            and self.dtype == other_dtype
        )

    def __hash__(self) -> int:
        return hash((tuple(self.shape), str(self.dtype)))

    def __repr__(self) -> str:
        fields = [f"shape={self.shape}", f"dtype={self.dtype}"]
        if self.name is not None:
            fields.append(f"name={self.name!r}")
        for flag in ("is_optional", "is_sequence", "is_extracted"):
            if getattr(self, flag):
                fields.append(f"{flag}=True")
        if self.data_format:
            fields.append(f"data_format={self.data_format!r}")
        if self.dataset_key:
            fields.append(f"dataset_key={self.dataset_key!r}")
        if self.varlen_default_value is not None:
            fields.append(f"varlen_default_value={self.varlen_default_value}")
        return f"ExtendedTensorSpec({', '.join(fields)})"


def is_leaf(value: Any) -> bool:
    """True for values that terminate a spec/tensor structure."""
    return isinstance(
        value,
        (ExtendedTensorSpec, np.ndarray, torch.Tensor, np.number, bytes, str),
    ) or np.isscalar(value)
