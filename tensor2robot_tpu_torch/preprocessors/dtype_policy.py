"""The bfloat16 dtype policy of a preprocessor: the bf16 infeed contract.

Port of tensor2robot_tpu/preprocessors/dtype_policy.py
(TPUPreprocessorWrapper). Wraps any preprocessor so that:

  * its *in* specs declare bfloat16 features as float32: the host
    pipeline produces float32 (bf16 has no on-disk form);
  * its *out* specs declare float32 as bfloat16 and drop optional
    tensors, halving the model's input bytes;
  * `_preprocess_fn` runs the wrapped preprocessor, then keeps the out
    specs' tensors and casts float32 to bfloat16.

models/tpu_model_wrapper.py pairs it with a bf16 autocast of the model.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
    AbstractPreprocessor,
)
from tensor2robot_tpu_torch.specs import (
    ExtendedTensorSpec,
    TensorSpecStruct,
    filter_required_flat_tensor_spec,
    flatten_spec_structure,
)


def cast_spec_dtypes(structure, source: torch.dtype, target: torch.dtype):
    """A flat copy of a spec structure with every `source` spec declared
    `target`."""
    out = TensorSpecStruct()
    for key, spec in flatten_spec_structure(structure).items():
        if isinstance(spec, ExtendedTensorSpec) and spec.dtype == source:
            spec = ExtendedTensorSpec.from_spec(spec, dtype=target)
        out[key] = spec
    return out


def cast_tensors(structure, source: torch.dtype, target: torch.dtype):
    """A flat copy of a tensor structure with every `source` tensor cast to
    `target` (on its device)."""
    out = TensorSpecStruct()
    for key, value in flatten_spec_structure(structure).items():
        if isinstance(value, torch.Tensor) and value.dtype == source:
            value = value.to(target)
        out[key] = value
    return out


class BFloat16PreprocessorWrapper(AbstractPreprocessor):
    """Decorates `preprocessor` with the bf16 + strip-optional policy."""

    def __init__(self, preprocessor: AbstractPreprocessor):
        super().__init__(model_spec_provider=None)
        self._preprocessor = preprocessor

    @property
    def wrapped(self) -> AbstractPreprocessor:
        return self._preprocessor

    def get_in_feature_specification(self, mode: str) -> TensorSpecStruct:
        return cast_spec_dtypes(
            self._preprocessor.get_in_feature_specification(mode),
            torch.bfloat16, torch.float32,
        )

    def get_in_label_specification(self, mode: str) -> TensorSpecStruct:
        return cast_spec_dtypes(
            self._preprocessor.get_in_label_specification(mode),
            torch.bfloat16, torch.float32,
        )

    def get_out_feature_specification(self, mode: str) -> TensorSpecStruct:
        return cast_spec_dtypes(
            filter_required_flat_tensor_spec(
                self._preprocessor.get_out_feature_specification(mode)),
            torch.float32, torch.bfloat16,
        )

    def get_out_label_specification(self, mode: str) -> TensorSpecStruct:
        return cast_spec_dtypes(
            filter_required_flat_tensor_spec(
                self._preprocessor.get_out_label_specification(mode)),
            torch.float32, torch.bfloat16,
        )

    def _preprocess_fn(
        self, features, labels, mode: str, generator: Optional[torch.Generator],
    ) -> Tuple[TensorSpecStruct, Optional[TensorSpecStruct]]:
        # The wrapped preprocessor runs at its own (f32-in) contract; the
        # casts are on the way out.
        out_features, out_labels = self._preprocessor._preprocess_fn(
            features, labels, mode, generator
        )
        out_features = self._filter_and_cast(
            out_features, self.get_out_feature_specification(mode))
        if out_labels is not None:
            out_labels = self._filter_and_cast(
                out_labels, self.get_out_label_specification(mode))
        return out_features, out_labels

    @staticmethod
    def _filter_and_cast(tensors, out_spec: TensorSpecStruct) -> TensorSpecStruct:
        flat = flatten_spec_structure(tensors)
        kept = TensorSpecStruct()
        for key in out_spec.keys():
            if key in flat:
                kept[key] = flat[key]
        return cast_tensors(kept, torch.float32, torch.bfloat16)
