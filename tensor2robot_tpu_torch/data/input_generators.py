"""Input generators: the bridge from models' specs to batched data streams.

An input generator holds a batch size and (after
`set_specification_from_model`) the feature/label specs pulled from the
model's preprocessor; `create_dataset` then yields numpy batches packed as
{features, labels}. Port of tensor2robot_tpu/data/input_generators.py:
the same seed gives byte-identical batches. Generators yield host numpy
batches; the trainer copies them to the card (train/infeed.py).

The record-reading generators (TFRecord shards, weighted mixtures) are not
ported yet (ROADMAP.md A4).
"""

from __future__ import annotations

import abc
import itertools
from typing import Any, Callable, Iterator, Mapping, Optional

import numpy as np

from tensor2robot_tpu_torch.specs import (
    TensorSpecStruct,
    make_constant_numpy,
    make_random_numpy,
    validate_and_pack,
)

MODE_TRAIN = "train"
MODE_EVAL = "eval"
MODE_PREDICT = "predict"
ALL_MODES = (MODE_TRAIN, MODE_EVAL, MODE_PREDICT)


class AbstractInputGenerator(abc.ABC):
    """Holds batch size + specs; produces mode-bound batch iterators."""

    def __init__(self, batch_size: int = 32):
        self._batch_size = batch_size
        self._feature_spec: Optional[TensorSpecStruct] = None
        self._label_spec: Optional[TensorSpecStruct] = None

    @property
    def batch_size(self) -> int:
        return self._batch_size

    @property
    def feature_spec(self) -> TensorSpecStruct:
        if self._feature_spec is None:
            raise ValueError(
                "Specs not set; call set_specification_from_model first."
            )
        return self._feature_spec

    def set_specification_from_model(self, model: Any, mode: str) -> None:
        """Pulls the *in* specs off the model's preprocessor: the data must
        match what the preprocessor consumes."""
        preprocessor = model.preprocessor
        self._feature_spec = preprocessor.get_in_feature_specification(mode)
        self._label_spec = preprocessor.get_in_label_specification(mode)

    def combined_spec(self) -> TensorSpecStruct:
        spec = TensorSpecStruct()
        for key, value in self.feature_spec.items():
            spec[f"features/{key}"] = value
        if self._label_spec is not None:
            for key, value in self._label_spec.items():
                spec[f"labels/{key}"] = value
        return spec

    def create_dataset(self, mode: str) -> Iterator[TensorSpecStruct]:
        """Yields batches packed as struct with 'features/...' and
        'labels/...' subtrees."""
        if mode not in ALL_MODES:
            raise ValueError(f"mode must be one of {ALL_MODES}, got {mode!r}")
        return self._create_dataset(mode)

    @abc.abstractmethod
    def _create_dataset(self, mode: str) -> Iterator[TensorSpecStruct]:
        ...


class GeneratorInputGenerator(AbstractInputGenerator):
    """Batches from a user python generator producing per-example dicts
    keyed like the combined spec; a short last batch is dropped."""

    def __init__(
        self,
        generator_fn: Callable[[], Iterator[Mapping[str, np.ndarray]]],
        batch_size: int = 32,
    ):
        super().__init__(batch_size=batch_size)
        self._generator_fn = generator_fn

    def _create_dataset(self, mode: str) -> Iterator[TensorSpecStruct]:
        source = self._generator_fn()
        while True:
            rows = list(itertools.islice(source, self._batch_size))
            if len(rows) < self._batch_size:
                return
            batch = TensorSpecStruct()
            for key in rows[0].keys():
                batch[key] = np.stack([np.asarray(r[key]) for r in rows])
            yield validate_and_pack(self.combined_spec(), batch, ignore_batch=True)


class DefaultRandomInputGenerator(AbstractInputGenerator):
    """Spec-conforming random batches, batch i drawn from seed + i: a
    data-free source for tests and bring-up."""

    def __init__(self, batch_size: int = 32, sequence_length: int = 3, seed: int = 0):
        super().__init__(batch_size=batch_size)
        self._sequence_length = sequence_length
        self._seed = seed

    def _create_dataset(self, mode: str) -> Iterator[TensorSpecStruct]:
        for step in itertools.count():
            yield make_random_numpy(
                self.combined_spec(),
                batch_size=self._batch_size,
                sequence_length=self._sequence_length,
                seed=self._seed + step,
            )


class DefaultConstantInputGenerator(AbstractInputGenerator):
    """Spec-conforming constant batches."""

    def __init__(self, constant_value: float, batch_size: int = 32, sequence_length: int = 3):
        super().__init__(batch_size=batch_size)
        self._constant_value = constant_value
        self._sequence_length = sequence_length

    def _create_dataset(self, mode: str) -> Iterator[TensorSpecStruct]:
        while True:
            yield make_constant_numpy(
                self.combined_spec(),
                constant_value=self._constant_value,
                batch_size=self._batch_size,
                sequence_length=self._sequence_length,
            )
