"""Task-batched data utilities for meta-learning.

Port of tensor2robot_tpu/meta_learning/meta_tfdata.py. Meta batches carry
two leading dims, [num_tasks, num_samples_per_task, ...], and these helpers
move structures between that layout and the flat
[num_tasks * num_samples, ...] layout base models expect. All are plain
reshapes, slices and tiles of every tensor (or numpy array) in a
structure: a TensorSpecStruct, a mapping, a list or tuple, or one array.
Anything else (None, a Python number) passes through.
"""

from __future__ import annotations

from collections import abc as cabc
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.specs import TensorSpecStruct


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def map_structure(fn: Callable, structure: Any) -> Any:
    """`fn` over every array leaf of `structure`, keeping its containers
    (a TensorSpecStruct stays one, flat keys and all)."""
    if isinstance(structure, TensorSpecStruct):
        return TensorSpecStruct(
            {key: map_structure(fn, value) for key, value in structure.items()})
    if isinstance(structure, cabc.Mapping):
        return type(structure)(
            (key, map_structure(fn, value)) for key, value in structure.items())
    if isinstance(structure, (list, tuple)):
        return type(structure)(map_structure(fn, value) for value in structure)
    return fn(structure) if _is_array(structure) else structure


def _leaves(structure: Any) -> List[Any]:
    found: List[Any] = []
    map_structure(found.append, structure)
    return found


def flatten_batch_examples(structure: Any) -> Any:
    """[num_tasks, num_samples, ...] -> [num_tasks * num_samples, ...];
    rank-1 arrays (per-task scalars) pass through untouched."""

    def reshape(x):
        if x.ndim <= 1:
            return x
        return x.reshape((-1,) + tuple(x.shape[2:]))

    return map_structure(reshape, structure)


def unflatten_batch_examples(structure: Any, num_samples_per_task: int) -> Any:
    """[num_tasks * num_samples, ...] -> [num_tasks, num_samples, ...]."""
    return map_structure(
        lambda x: x.reshape((-1, num_samples_per_task) + tuple(x.shape[1:])),
        structure)


def merge_first_n_dims(structure: Any, n: int) -> Any:
    """Collapses the first n dims of every array; 0-d arrays pass through."""
    return map_structure(
        lambda x: x if x.ndim == 0 else x.reshape((-1,) + tuple(x.shape[n:])),
        structure)


def expand_batch_dims(structure: Any, batch_sizes: Sequence[int]) -> Any:
    """Re-expands the first dim of every array to `batch_sizes`; 0-d arrays
    (reduced losses) pass through."""
    batch_sizes = tuple(batch_sizes)
    return map_structure(
        lambda x: x if x.ndim == 0 else x.reshape(batch_sizes + tuple(x.shape[1:])),
        structure)


def multi_batch_apply(f: Callable, num_batch_dims: int, *args, **kwargs) -> Any:
    """Runs `f` (which expects one batch dim) over inputs with
    `num_batch_dims` leading batch dims and restores them on the outputs.
    One reshaped call, so batch norm sees the whole flattened batch."""
    leaves = _leaves((args, kwargs))
    if not leaves:
        raise ValueError("multi_batch_apply needs at least one array input.")
    batch_sizes = tuple(leaves[0].shape[:num_batch_dims])
    outputs = f(*merge_first_n_dims(args, num_batch_dims),
                **merge_first_n_dims(kwargs, num_batch_dims))
    return expand_batch_dims(outputs, batch_sizes)


def split_train_val(structure: Any, num_train_samples_per_task: int) -> Tuple[Any, Any]:
    """Splits the per-task samples dim into (train, val) structures."""
    return (map_structure(lambda x: x[:, :num_train_samples_per_task], structure),
            map_structure(lambda x: x[:, num_train_samples_per_task:], structure))


def tile_val_mode(structure: Any, num_tiles: int) -> Any:
    """Tiles every array `num_tiles` times along the per-task samples dim."""

    def tile(x):
        reps = (1, num_tiles) + (1,) * (x.ndim - 2)
        return x.repeat(*reps) if isinstance(x, torch.Tensor) else np.tile(x, reps)

    return map_structure(tile, structure)
