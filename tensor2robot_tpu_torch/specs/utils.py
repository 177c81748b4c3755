"""Spec algebra: flatten / validate / pack / fixture generation.

  * `flatten_spec_structure` normalizes any hierarchical structure (dicts,
    (named)tuples, lists, TensorSpecStruct) into a flat TensorSpecStruct.
  * `validate_and_flatten` / `validate_and_pack` check that a structure of
    tensors (numpy arrays or torch tensors) conforms to a structure of
    specs and return the flat / packed form — the gate at every model and
    preprocessor boundary.
  * `make_random_numpy` generates spec-conforming fixtures, the basis of
    the server's bucket prewarm batches and the tests.

Port of tensor2robot_tpu/specs/utils.py (the subset the serving path and
its tests use).
"""

from __future__ import annotations

from collections import abc as cabc
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

from tensor2robot_tpu_torch.specs.spec import (
    ExtendedTensorSpec,
    canonical_dtype,
    is_leaf,
    numpy_dtype,
)
from tensor2robot_tpu_torch.specs.struct import TensorSpecStruct

SpecStructure = Union[TensorSpecStruct, cabc.Mapping, tuple, list]


def _is_namedtuple(value: Any) -> bool:
    return isinstance(value, tuple) and hasattr(value, "_fields")


def flatten_spec_structure(structure: Any) -> TensorSpecStruct:
    """Flattens any hierarchical spec/tensor structure to path-keyed form.

    Supports dict, OrderedDict, TensorSpecStruct, namedtuple, tuple and
    list containers (tuples/lists use their index as the path component).
    Two specs that share a `name` but disagree on shape/dtype are rejected.
    """
    flat = TensorSpecStruct()
    _flatten_into(flat, "", structure)
    _check_name_collisions(flat)
    return flat


def _flatten_into(flat: TensorSpecStruct, prefix: str, value: Any) -> None:
    if value is None:
        return
    if is_leaf(value):
        if not prefix:
            raise ValueError(
                "Cannot flatten a bare leaf; wrap it in a container."
            )
        flat[prefix] = value
        return
    if _is_namedtuple(value):
        items = [(f, getattr(value, f)) for f in value._fields]
    elif isinstance(value, cabc.Mapping):
        items = list(value.items())
    elif isinstance(value, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(value)]
    else:
        raise ValueError(
            f"Unsupported structure element of type {type(value)!r} at "
            f"{prefix or '<root>'!r}"
        )
    for key, sub_value in items:
        if sub_value is None:
            continue
        sub_prefix = f"{prefix}/{key}" if prefix else str(key)
        _flatten_into(flat, sub_prefix, sub_value)


def _check_name_collisions(flat: TensorSpecStruct) -> None:
    by_name: Dict[str, ExtendedTensorSpec] = {}
    for _, spec in flat.items():
        if not isinstance(spec, ExtendedTensorSpec) or spec.name is None:
            continue
        ref = by_name.get(spec.name)
        if ref is None:
            by_name[spec.name] = spec
        elif ref != spec:
            raise ValueError(
                f"Name collision: two specs named {spec.name!r} disagree on "
                f"shape/dtype ({ref} vs {spec})."
            )


# -- validation ---------------------------------------------------------------


def _shapes_compatible(
    spec_shape: Tuple[Optional[int], ...],
    tensor_shape: Tuple[Optional[int], ...],
    ignore_batch: bool,
) -> bool:
    if ignore_batch:
        if len(tensor_shape) != len(spec_shape) + 1:
            return False
        tensor_shape = tensor_shape[1:]
    elif len(tensor_shape) != len(spec_shape):
        return False
    return all(
        s is None or t is None or s == t
        for s, t in zip(spec_shape, tensor_shape)
    )


def assert_equal_spec_or_tensor(
    spec: ExtendedTensorSpec, tensor: Any, ignore_batch: bool = False
) -> None:
    """Raises ValueError unless `tensor` (or a second spec) conforms to
    `spec`. Spec-to-spec comparison ignores `ignore_batch`."""
    if not isinstance(tensor, ExtendedTensorSpec) and not hasattr(
        tensor, "shape"
    ):
        tensor = np.asarray(tensor)
    tensor_shape = tuple(
        None if d is None else int(d) for d in tuple(tensor.shape)
    )
    spec_shape = tuple(spec.shape)
    if isinstance(tensor, ExtendedTensorSpec):
        ok = _shapes_compatible(spec_shape, tensor_shape, ignore_batch=False)
    else:
        if spec.is_sequence:
            spec_shape = (None,) + spec_shape
        ok = _shapes_compatible(spec_shape, tensor_shape, ignore_batch)
    if not ok:
        raise ValueError(
            f"Shape mismatch for {spec.name!r}: spec {spec_shape} vs tensor "
            f"{tensor_shape} (ignore_batch={ignore_batch})."
        )
    if canonical_dtype(tensor.dtype) != spec.dtype:
        raise ValueError(
            f"Dtype mismatch for {spec.name!r}: spec {spec.dtype} vs tensor "
            f"{tensor.dtype}."
        )


def assert_required(
    expected_specs: SpecStructure,
    actual: SpecStructure,
    ignore_batch: bool = False,
) -> None:
    """Every required spec is present and conforms; optional specs may be
    absent and tensors beyond the declared specs are tolerated."""
    flat_specs = flatten_spec_structure(expected_specs)
    flat_actual = flatten_spec_structure(actual)
    for key, spec in flat_specs.items():
        if key not in flat_actual:
            if isinstance(spec, ExtendedTensorSpec) and spec.is_optional:
                continue
            raise ValueError(f"Required tensor {key!r} missing from structure.")
        assert_equal_spec_or_tensor(spec, flat_actual[key], ignore_batch)


def validate_and_flatten(
    expected_spec: SpecStructure,
    actual_tensors_or_spec: SpecStructure,
    ignore_batch: bool = False,
) -> TensorSpecStruct:
    """Validates then returns the flat view of `actual_tensors_or_spec`,
    restricted to the keys the spec declares (extras are dropped)."""
    flat_spec = flatten_spec_structure(expected_spec)
    flat_actual = flatten_spec_structure(actual_tensors_or_spec)
    assert_required(flat_spec, flat_actual, ignore_batch)
    out = TensorSpecStruct()
    for key in flat_spec.keys():
        if key in flat_actual:
            out[key] = flat_actual[key]
    return out


def validate_and_pack(
    expected_spec: SpecStructure,
    actual_tensors_or_spec: SpecStructure,
    ignore_batch: bool = False,
) -> TensorSpecStruct:
    """Validates `actual` against the spec and packs it into the spec's
    hierarchy (a TensorSpecStruct mirroring the expected paths)."""
    return validate_and_flatten(
        expected_spec, actual_tensors_or_spec, ignore_batch
    )


# -- copying / filtering ------------------------------------------------------


def copy_tensorspec(
    structure: SpecStructure,
    batch_size: Optional[int] = None,
    prefix: str = "",
) -> TensorSpecStruct:
    """Deep-copies a spec structure, optionally prefixing every spec *name*.

    `prefix` lands on the feature `name` while the returned struct keeps
    the original relative paths. batch_size, if given, is prepended to
    every spec's shape (-1 prepends a wildcard dim).
    """
    flat = flatten_spec_structure(structure)
    out = TensorSpecStruct()
    for key, spec in flat.items():
        if not isinstance(spec, ExtendedTensorSpec):
            out[key] = spec
            continue
        name = spec.name if spec.name is not None else key
        if prefix:
            name = f"{prefix}/{name}"
        shape = spec.shape
        if batch_size is not None:
            leading = None if batch_size == -1 else batch_size
            shape = (leading,) + tuple(shape)
        out[key] = ExtendedTensorSpec.from_spec(spec, name=name, shape=shape)
    return out


def filter_required_flat_tensor_spec(
    structure: SpecStructure,
) -> TensorSpecStruct:
    """Drops optional specs."""
    flat = flatten_spec_structure(structure)
    out = TensorSpecStruct()
    for key, spec in flat.items():
        if isinstance(spec, ExtendedTensorSpec) and spec.is_optional:
            continue
        out[key] = spec
    return out


# -- fixture generation -------------------------------------------------------


def _resolve_shape(
    spec: ExtendedTensorSpec, batch_size: Optional[int], sequence_length: int
) -> Tuple[int, ...]:
    shape = tuple(sequence_length if d is None else d for d in spec.shape)
    if spec.is_sequence:
        shape = (sequence_length,) + shape
    if batch_size is not None:
        shape = (batch_size,) + shape
    return shape


def make_random_numpy(
    structure: SpecStructure,
    batch_size: Optional[int] = 2,
    sequence_length: int = 3,
    seed: int = 0,
) -> TensorSpecStruct:
    """Spec-conforming random numpy tensors: floats U[0,1), uint8 over its
    full range, other ints U[0,10). The same seed draws the same values as
    the JAX package's make_random_numpy."""
    rng = np.random.RandomState(seed)
    flat = flatten_spec_structure(structure)
    out = TensorSpecStruct()
    for key, spec in flat.items():
        if not isinstance(spec, ExtendedTensorSpec):
            continue
        shape = _resolve_shape(spec, batch_size, sequence_length)
        dtype = numpy_dtype(spec.dtype)
        if np.issubdtype(dtype, np.floating):
            value = rng.rand(*shape).astype(dtype)
        elif dtype == np.dtype(np.uint8):
            value = rng.randint(0, 256, size=shape, dtype=np.uint8)
        elif np.issubdtype(dtype, np.integer):
            value = rng.randint(0, 10, size=shape).astype(dtype)
        elif dtype == np.dtype(bool):
            value = rng.rand(*shape) > 0.5
        else:
            raise ValueError(f"Unsupported random dtype {dtype} for {key!r}")
        out[key] = value
    return out


def make_constant_numpy(
    structure: SpecStructure,
    constant_value: float = 0.0,
    batch_size: Optional[int] = 2,
    sequence_length: int = 3,
) -> TensorSpecStruct:
    """Spec-conforming constant numpy tensors; byte-identical to the JAX
    package's make_constant_numpy."""
    flat = flatten_spec_structure(structure)
    out = TensorSpecStruct()
    for key, spec in flat.items():
        if not isinstance(spec, ExtendedTensorSpec):
            continue
        shape = _resolve_shape(spec, batch_size, sequence_length)
        out[key] = np.full(shape, constant_value, dtype=numpy_dtype(spec.dtype))
    return out
