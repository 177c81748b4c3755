"""TensorSpecStruct: an ordered mapping that is simultaneously flat and
hierarchical.

The flat view is a dict with '/'-separated path keys ('train/state'); the
hierarchical view is attribute access (`struct.train.state`) returning
*live* sub-views backed by the same storage — mutation through a view
writes through to the root. It is the universal container for both specs
and tensors throughout the framework.

Port of tensor2robot_tpu/specs/struct.py (without the pytree
registration, which PyTorch does not need).
"""

from __future__ import annotations

import collections
from collections import abc as cabc
from typing import Any, Iterator

import numpy as np
import torch


class TensorSpecStruct(cabc.MutableMapping):
    """Ordered flat mapping with live hierarchical attribute views.

    Invariants:
      * Keys are non-empty '/'-separated paths; a path is either a leaf or
        a prefix of deeper leaves, never both (collision-checked on insert).
      * A view created by attribute access shares storage with its root;
        `keys()`/`items()` on the view are relative to the view's prefix.
      * Assigning a mapping to an attribute copies its items under the
        attribute's prefix; assigning an *empty* mapping is forbidden.
    """

    __slots__ = ("_storage", "_prefix")

    def __init__(self, *args, **kwargs):
        object.__setattr__(self, "_storage", collections.OrderedDict())
        object.__setattr__(self, "_prefix", "")
        init = collections.OrderedDict(*args, **kwargs)
        for key, value in init.items():
            self[key] = value

    @classmethod
    def _view(cls, storage, prefix: str) -> "TensorSpecStruct":
        view = cls.__new__(cls)
        object.__setattr__(view, "_storage", storage)
        object.__setattr__(view, "_prefix", prefix)
        return view

    def _abs(self, key: str) -> str:
        if not isinstance(key, str):
            raise KeyError(f"Keys must be non-empty strings, got {key!r}")
        key = key.strip("/")
        if not key:
            raise KeyError("Keys must be non-empty strings")
        return f"{self._prefix}/{key}" if self._prefix else key

    # -- MutableMapping interface (flat, prefix-relative) ---------------------

    def __getitem__(self, key: str) -> Any:
        abs_key = self._abs(key)
        if abs_key in self._storage:
            return self._storage[abs_key]
        sub_prefix = abs_key + "/"
        if any(k.startswith(sub_prefix) for k in self._storage):
            return TensorSpecStruct._view(self._storage, abs_key)
        raise KeyError(key)

    def __setitem__(self, key: str, value: Any) -> None:
        abs_key = self._abs(key)
        if isinstance(value, cabc.Mapping):
            items = list(value.items())
            if not items:
                raise ValueError(
                    f"Cannot assign an empty mapping to {key!r}; build the "
                    "sub-struct first, then assign it."
                )
            for sub_key, sub_value in items:
                self[f"{key}/{sub_key}"] = sub_value
            return
        self._check_collision(abs_key)
        self._storage[abs_key] = value

    def __delitem__(self, key: str) -> None:
        abs_key = self._abs(key)
        if abs_key in self._storage:
            del self._storage[abs_key]
            return
        sub_prefix = abs_key + "/"
        sub_keys = [k for k in self._storage if k.startswith(sub_prefix)]
        if not sub_keys:
            raise KeyError(key)
        for k in sub_keys:
            del self._storage[k]

    def __iter__(self) -> Iterator[str]:
        if not self._prefix:
            yield from list(self._storage)
            return
        prefix = self._prefix + "/"
        for k in list(self._storage):
            if k.startswith(prefix):
                yield k[len(prefix):]

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def __contains__(self, key: object) -> bool:
        try:
            abs_key = self._abs(key)  # type: ignore[arg-type]
        except KeyError:
            return False
        if abs_key in self._storage:
            return True
        sub_prefix = abs_key + "/"
        return any(k.startswith(sub_prefix) for k in self._storage)

    # -- hierarchical (attribute) interface -----------------------------------

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self[name]
        except KeyError:
            raise AttributeError(
                f"TensorSpecStruct has no key or sub-structure {name!r}; "
                f"available: {list(self)}"
            ) from None

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_"):
            object.__setattr__(self, name, value)
            return
        self[name] = value

    def __delattr__(self, name: str) -> None:
        if name.startswith("_"):
            object.__delattr__(self, name)
            return
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def _check_collision(self, abs_key: str) -> None:
        """A path may not be both a leaf and a prefix of deeper leaves."""
        sub_prefix = abs_key + "/"
        if any(k.startswith(sub_prefix) for k in self._storage):
            raise ValueError(
                f"Key {abs_key!r} already exists as a sub-structure; cannot "
                "overwrite it with a leaf."
            )
        parts = abs_key.split("/")
        for i in range(1, len(parts)):
            ancestor = "/".join(parts[:i])
            if ancestor in self._storage:
                raise ValueError(
                    f"Key {abs_key!r} collides with existing leaf {ancestor!r}."
                )

    def to_dict(self) -> "collections.OrderedDict[str, Any]":
        """Flat OrderedDict copy (prefix-relative keys)."""
        return collections.OrderedDict(self.items())

    def to_hierarchical_dict(self) -> dict:
        """Nested plain-dict copy."""
        out: dict = {}
        for key, value in self.items():
            parts = key.split("/")
            node = out
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = value
        return out

    def copy(self) -> "TensorSpecStruct":
        """Shallow copy materializing this view into a fresh root struct."""
        fresh = TensorSpecStruct()
        for key, value in self.items():
            fresh[key] = value
        return fresh

    def __repr__(self) -> str:
        inner = ", ".join(f"{k!r}: {v!r}" for k, v in self.items())
        prefix = f", prefix={self._prefix!r}" if self._prefix else ""
        return f"TensorSpecStruct({{{inner}}}{prefix})"

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, cabc.Mapping):
            if list(self.keys()) != list(other.keys()):
                return False
            return all(_leaves_equal(self[k], other[k]) for k in self)
        return NotImplemented

    def __ne__(self, other: Any) -> bool:
        result = self.__eq__(other)
        return result if result is NotImplemented else not result

    __hash__ = None  # type: ignore[assignment]


def _leaves_equal(a: Any, b: Any) -> bool:
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (
            isinstance(a, torch.Tensor)
            and isinstance(b, torch.Tensor)
            and torch.equal(a, b)
        )
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return bool(np.array_equal(np.asarray(a), np.asarray(b)))
    return bool(a == b)
