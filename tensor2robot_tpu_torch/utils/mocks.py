"""Mock model and input generator for the port's tests and smoke configs.

Port of tensor2robot_tpu/utils/mocks.py: `MockT2RModel` is a 3-layer MLP
with batch norm over a 3-vector input predicting one logit;
`MockInputGenerator` emits a deterministic linearly separable dataset
(label = x0 + x1 + x2 > 0), so a few hundred steps of training must
converge. Module names follow flax's (Dense_0, BatchNorm_0, ...), so the
JAX mock's variables load through utils/jax_params.py.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.data.input_generators import AbstractInputGenerator
from tensor2robot_tpu_torch.layers.batch_norm import BatchNorm
from tensor2robot_tpu_torch.models.base_models import ClassificationModel
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, TensorSpecStruct

_FEATURE_DIM = 3
_WIDTHS = (100, 100)


class _MockNetwork(nn.Module):
    """Dense -> batch norm -> relu, twice, then a Dense logit."""

    def __init__(self, use_batch_norm: bool = True):
        super().__init__()
        self._use_batch_norm = use_batch_norm
        in_features = _FEATURE_DIM
        for i, width in enumerate(_WIDTHS):
            self.add_module(f"Dense_{i}", nn.Linear(in_features, width))
            if use_batch_norm:
                self.add_module(f"BatchNorm_{i}", BatchNorm(width, momentum=0.9))
            in_features = width
        self.add_module(f"Dense_{len(_WIDTHS)}", nn.Linear(in_features, 1))

    def forward(self, features, mode: str):
        x = features["x"].float()
        for i in range(len(_WIDTHS)):
            x = getattr(self, f"Dense_{i}")(x)
            if self._use_batch_norm:
                x = getattr(self, f"BatchNorm_{i}")(x, mode == "train")
            x = F.relu(x)
        return {"a_predicted": getattr(self, f"Dense_{len(_WIDTHS)}")(x)}


class MockT2RModel(ClassificationModel):
    """Minimal end-to-end-trainable model."""

    def __init__(self, device_type: str = "cpu", use_batch_norm: bool = True,
                 multi_dataset: bool = False, **kwargs):
        super().__init__(device_type=device_type, **kwargs)
        self._use_batch_norm = use_batch_norm
        self._multi_dataset = multi_dataset

    def create_network(self) -> nn.Module:
        return _MockNetwork(use_batch_norm=self._use_batch_norm)

    def get_feature_specification(self, mode: str) -> TensorSpecStruct:
        del mode
        extra = {"dataset_key": "dataset1"} if self._multi_dataset else {}
        return TensorSpecStruct(x=ExtendedTensorSpec(
            shape=(_FEATURE_DIM,), dtype=np.float32, name="measured_position",
            **extra))

    def get_label_specification(self, mode: str) -> TensorSpecStruct:
        del mode
        extra = {"dataset_key": "dataset2"} if self._multi_dataset else {}
        return TensorSpecStruct(a_target=ExtendedTensorSpec(
            shape=(1,), dtype=np.float32, name="valid_position", **extra))


def _separable(rng: np.random.RandomState, count: int):
    x = rng.uniform(-1.0, 1.0, size=(count, _FEATURE_DIM))
    y = (x.sum(axis=1, keepdims=True) > 0).astype(np.float32)
    return x.astype(np.float32), y


class MockInputGenerator(AbstractInputGenerator):
    """Deterministic linearly separable data: label = x0 + x1 + x2 > 0."""

    def __init__(self, batch_size: int = 32, seed: int = 0):
        super().__init__(batch_size=batch_size)
        self._seed = seed

    def _create_dataset(self, mode: str) -> Iterator[TensorSpecStruct]:
        rng = np.random.RandomState(self._seed)
        while True:
            x, y = _separable(rng, self._batch_size)
            batch = TensorSpecStruct()
            batch["features/x"] = x
            batch["labels/a_target"] = y
            yield batch

    def create_numpy_data(self, num_examples: int = 256):
        return _separable(np.random.RandomState(self._seed), num_examples)
