"""Preprocessor abstraction: per-batch transforms between parsed data and
the model.

A preprocessor declares four specs — what it consumes (`in`) and what it
produces (`out`), for features and labels — and a `_preprocess_fn`. The
public `preprocess` validates+packs its inputs, applies the transform, and
validates+flattens the outputs, so models always see exactly their
declared contract.

Port of tensor2robot_tpu/preprocessors/abstract_preprocessor.py. The
JAX version takes an explicit `jax.random` key; here randomness comes from
an explicit `torch.Generator` (None = deterministic).
"""

from __future__ import annotations

import abc
from typing import Any, Optional, Tuple

import torch

from tensor2robot_tpu_torch.data.roi import adjust_spec_for_roi_tensors
from tensor2robot_tpu_torch.specs import (
    ExtendedTensorSpec,
    TensorSpecStruct,
    validate_and_flatten,
    validate_and_pack,
)

MODE_TRAIN = "train"
MODE_EVAL = "eval"
MODE_PREDICT = "predict"
ALL_MODES = (MODE_TRAIN, MODE_EVAL, MODE_PREDICT)


class AbstractPreprocessor(abc.ABC):
    """Base preprocessor; subclasses override the 4 spec getters and
    `_preprocess_fn`."""

    def __init__(self, model_spec_provider: Optional[Any] = None):
        # Validate up front that the model exposes specs for all modes.
        if model_spec_provider is not None:
            for mode in (MODE_TRAIN, MODE_EVAL):
                model_spec_provider.get_feature_specification(mode)
                model_spec_provider.get_label_specification(mode)
        self._model = model_spec_provider

    @abc.abstractmethod
    def get_in_feature_specification(self, mode: str) -> TensorSpecStruct:
        """Spec of the features this preprocessor consumes."""

    @abc.abstractmethod
    def get_in_label_specification(self, mode: str) -> TensorSpecStruct:
        """Spec of the labels this preprocessor consumes."""

    @abc.abstractmethod
    def get_out_feature_specification(self, mode: str) -> TensorSpecStruct:
        """Spec of the features this preprocessor produces (= model in-spec)."""

    @abc.abstractmethod
    def get_out_label_specification(self, mode: str) -> TensorSpecStruct:
        """Spec of the labels this preprocessor produces."""

    def get_decode_rois(self, mode: str):
        """Optional {in-feature key: data.roi.DecodeROI}: crops the data
        layer may apply at JPEG-decode time instead of this preprocessor on
        the card (the pixels are identical; data/roi.py). The input
        generator hands the map to RecordDataset; `preprocess` then accepts
        the named features at the source or the cropped shape, and
        `_preprocess_fn` must not crop again an input that arrives
        cropped. Base: no ROIs (None)."""
        del mode
        return None

    @abc.abstractmethod
    def _preprocess_fn(
        self,
        features: TensorSpecStruct,
        labels: Optional[TensorSpecStruct],
        mode: str,
        generator: Optional[torch.Generator],
    ) -> Tuple[TensorSpecStruct, Optional[TensorSpecStruct]]:
        """The transform; randomness only through `generator`."""

    def preprocess(
        self,
        features,
        labels=None,
        mode: str = MODE_TRAIN,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[TensorSpecStruct, Optional[TensorSpecStruct]]:
        """Validated transform: pack(in-spec) -> _preprocess_fn ->
        flatten(out-spec)."""
        if mode not in ALL_MODES:
            raise ValueError(f"mode must be one of {ALL_MODES}, got {mode!r}")
        in_feature_spec = self.get_in_feature_specification(mode)
        decode_rois = self.get_decode_rois(mode)
        if decode_rois:
            # Features named in the decode-ROI map may arrive already
            # cropped (a ROI-decoding dataset) or at the source shape
            # (direct feeds, T2R_DECODE_ROI=0): accept exactly those two.
            in_feature_spec = adjust_spec_for_roi_tensors(
                in_feature_spec, decode_rois, features)
        packed_features = validate_and_pack(
            in_feature_spec, features, ignore_batch=True,
        )
        packed_labels = None
        if labels is not None:
            packed_labels = validate_and_pack(
                self.get_in_label_specification(mode), labels,
                ignore_batch=True,
            )
        out_features, out_labels = self._preprocess_fn(
            packed_features, packed_labels, mode, generator
        )
        out_features = validate_and_flatten(
            self.get_out_feature_specification(mode), out_features,
            ignore_batch=True,
        )
        if out_labels is not None:
            out_labels = validate_and_flatten(
                self.get_out_label_specification(mode), out_labels,
                ignore_batch=True,
            )
        return out_features, out_labels


class NoOpPreprocessor(AbstractPreprocessor):
    """Identity: in == out == the model's specs."""

    def __init__(self, model_spec_provider: Any):
        super().__init__(model_spec_provider)

    def get_in_feature_specification(self, mode: str) -> TensorSpecStruct:
        return self._model.get_feature_specification(mode)

    def get_in_label_specification(self, mode: str) -> TensorSpecStruct:
        return self._model.get_label_specification(mode)

    def get_out_feature_specification(self, mode: str) -> TensorSpecStruct:
        return self._model.get_feature_specification(mode)

    def get_out_label_specification(self, mode: str) -> TensorSpecStruct:
        return self._model.get_label_specification(mode)

    def _preprocess_fn(self, features, labels, mode, generator):
        return features, labels


class SpecTransformationPreprocessor(NoOpPreprocessor):
    """Convenience base: identity transform with rewritten *in* specs.

    Override `_transform_in_feature_specification` (and/or the label
    variant) to declare a different on-disk representation, e.g. a uint8
    jpeg source for a float32 model input, then implement `_preprocess_fn`
    for the value conversion. Port of the JAX package's class of the same
    name.
    """

    def get_in_feature_specification(self, mode: str) -> TensorSpecStruct:
        return self._transform_in_feature_specification(
            self._model.get_feature_specification(mode).copy(), mode
        )

    def get_in_label_specification(self, mode: str) -> TensorSpecStruct:
        return self._transform_in_label_specification(
            self._model.get_label_specification(mode).copy(), mode
        )

    def _transform_in_feature_specification(
        self, spec: TensorSpecStruct, mode: str
    ) -> TensorSpecStruct:
        return spec

    def _transform_in_label_specification(
        self, spec: TensorSpecStruct, mode: str
    ) -> TensorSpecStruct:
        return spec

    @staticmethod
    def update_spec(spec_struct: TensorSpecStruct, key: str, **overrides) -> None:
        """Rewrites the spec at `key` in place with `overrides`."""
        spec_struct[key] = ExtendedTensorSpec.from_spec(
            spec_struct[key], **overrides
        )
