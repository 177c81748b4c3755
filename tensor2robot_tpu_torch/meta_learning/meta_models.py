"""The legacy TrainValPair meta-learning surface.

Port of tensor2robot_tpu/meta_learning/meta_models.py (`select_mode`,
`create_meta_spec`, `MetaPreprocessor`, `MetalearningModel`): the first
meta-learning interface of tensor2robot, later superseded by
MAMLPreprocessorV2 (preprocessors.py), ported so RL^2-style models have
their base class.

Every feature and label spec is wrapped into a TrainValPair: a
`train/`-prefixed branch, a `val/`-prefixed branch and a boolean
`val_mode` switch. Both branches get their serialized names rewritten
with the branch prefix, so the input pipeline writes `train/<name>` and
`val/<name>` features and the parser maps each branch to its own inputs.
Both branches are required. The network hooks stay abstract: subclasses
combine the two branches, typically through `select_mode`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tensor2robot_tpu_torch.meta_learning import meta_tfdata
from tensor2robot_tpu_torch.models.abstract_model import AbstractT2RModel
from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
    AbstractPreprocessor,
)
from tensor2robot_tpu_torch.specs import (
    ExtendedTensorSpec,
    TensorSpecStruct,
    copy_tensorspec,
    flatten_spec_structure,
)


def select_mode(val_mode, train, val):
    """Per-element switch between the train and val branches.

    `val_mode` is a boolean of shape [], [tasks] or [tasks, 1]; it is
    right-broadcast against each leaf, so whole tasks switch branches.
    Leaves must have matching shapes across branches.
    """
    train_flat = flatten_spec_structure(train)
    val_flat = flatten_spec_structure(val)
    train_keys = set(train_flat.keys())
    val_keys = set(val_flat.keys())
    if train_keys != val_keys:
        # Silently dropping a val-only leaf would corrupt val-mode tasks
        # downstream.
        raise ValueError(
            "select_mode requires identical train/val structures; "
            f"train-only: {sorted(train_keys - val_keys)}, "
            f"val-only: {sorted(val_keys - train_keys)}"
        )
    out = TensorSpecStruct()
    for key in train_flat:
        t, v = train_flat[key], val_flat[key]
        t, v = torch.as_tensor(t), torch.as_tensor(v)
        cond = torch.as_tensor(val_mode, device=t.device)
        cond = cond.reshape((-1,) + (1,) * (t.ndim - 1) if cond.ndim > 0 else ())
        out[key] = torch.where(cond, v, t)
    return out


def create_meta_spec(
    tensor_spec,
    spec_type: str,
    num_train_samples_per_task: Optional[int],
    num_val_samples_per_task: Optional[int],
) -> TensorSpecStruct:
    """Wraps a spec structure into a flattened TrainValPair spec.

    Both branches' serialized names
    are rewritten with the branch prefix (`train/<name>`, `val/<name>`)
    so each branch maps to its own serialized inputs; both branches are
    forced non-optional; a boolean `val_mode` switch is added per spec
    type.
    """
    if spec_type not in ("features", "labels"):
        raise ValueError(
            'We only support spec_type "features" or "labels" '
            f"but received {spec_type}."
        )
    train_spec = flatten_spec_structure(
        copy_tensorspec(
            tensor_spec, batch_size=num_train_samples_per_task, prefix="train"
        )
    )
    for key, value in train_spec.items():
        train_spec[key] = ExtendedTensorSpec.from_spec(
            value, is_optional=False
        )
    val_spec = flatten_spec_structure(
        copy_tensorspec(
            tensor_spec, batch_size=num_val_samples_per_task, prefix="val"
        )
    )
    for key, value in val_spec.items():
        val_spec[key] = ExtendedTensorSpec.from_spec(value, is_optional=False)

    val_mode_shape = () if num_train_samples_per_task is None else (1,)
    out = TensorSpecStruct()
    out.train = train_spec
    out.val = val_spec
    out.val_mode = ExtendedTensorSpec(
        shape=val_mode_shape,
        dtype=np.bool_,
        name=f"val_mode/{spec_type}",
    )
    return flatten_spec_structure(out)


class MetaPreprocessor(AbstractPreprocessor):
    """Wraps a base preprocessor's contract into TrainValPairs.

    The transform flattens each branch's [tasks, samples, ...] leaves to
    a flat batch, applies the base preprocessor per branch (the train
    branch draws from the step's generator first, then the val branch),
    and restores the task structure.
    """

    def __init__(
        self,
        base_preprocessor: AbstractPreprocessor,
        num_train_samples_per_task: int,
        num_val_samples_per_task: int,
    ):
        super().__init__()
        self._base_preprocessor = base_preprocessor
        self._num_train_samples_per_task = num_train_samples_per_task
        self._num_val_samples_per_task = num_val_samples_per_task

    @property
    def base_preprocessor(self) -> AbstractPreprocessor:
        return self._base_preprocessor

    @property
    def num_train_samples_per_task(self) -> int:
        return self._num_train_samples_per_task

    @property
    def num_val_samples_per_task(self) -> int:
        return self._num_val_samples_per_task

    def get_in_feature_specification(self, mode):
        return create_meta_spec(
            self._base_preprocessor.get_in_feature_specification(mode),
            "features",
            self._num_train_samples_per_task,
            self._num_val_samples_per_task,
        )

    def get_in_label_specification(self, mode):
        return create_meta_spec(
            self._base_preprocessor.get_in_label_specification(mode),
            "labels",
            self._num_train_samples_per_task,
            self._num_val_samples_per_task,
        )

    def get_out_feature_specification(self, mode):
        return create_meta_spec(
            self._base_preprocessor.get_out_feature_specification(mode),
            "features",
            self._num_train_samples_per_task,
            self._num_val_samples_per_task,
        )

    def get_out_label_specification(self, mode):
        return create_meta_spec(
            self._base_preprocessor.get_out_label_specification(mode),
            "labels",
            self._num_train_samples_per_task,
            self._num_val_samples_per_task,
        )

    def _preprocess_fn(self, features, labels, mode, generator):
        if mode is None:
            raise ValueError("The mode should never be None.")
        flat_train_features = meta_tfdata.flatten_batch_examples(
            features.train
        )
        flat_val_features = meta_tfdata.flatten_batch_examples(features.val)
        flat_train_labels = flat_val_labels = None
        if labels is not None:
            flat_train_labels = meta_tfdata.flatten_batch_examples(
                labels.train
            )
            flat_val_labels = meta_tfdata.flatten_batch_examples(labels.val)

        train_features_out, train_labels_out = (
            self._base_preprocessor.preprocess(
                flat_train_features, flat_train_labels, mode=mode,
                generator=generator,
            )
        )
        val_features_out, val_labels_out = self._base_preprocessor.preprocess(
            flat_val_features, flat_val_labels, mode=mode, generator=generator
        )

        out_features = TensorSpecStruct()
        out_features.train = meta_tfdata.unflatten_batch_examples(
            train_features_out, self._num_train_samples_per_task
        )
        out_features.val = meta_tfdata.unflatten_batch_examples(
            val_features_out, self._num_val_samples_per_task
        )
        out_features.val_mode = features.val_mode.reshape(-1, 1)
        out_labels = None
        if labels is not None:
            out_labels = TensorSpecStruct()
            out_labels.train = meta_tfdata.unflatten_batch_examples(
                train_labels_out, self._num_train_samples_per_task
            )
            out_labels.val = meta_tfdata.unflatten_batch_examples(
                val_labels_out, self._num_val_samples_per_task
            )
            out_labels.val_mode = labels.val_mode.reshape(-1, 1)
        return out_features, out_labels


class MetalearningModel(AbstractT2RModel):
    """Base class for legacy TrainValPair meta models (e.g. RL^2).

    Wraps a base model, exposes the
    TrainValPair spec surface, and leaves the network/train hooks to
    subclasses, which minimize some `L_val(update(L_train))`.
    """

    def __init__(
        self,
        base_model: AbstractT2RModel,
        num_train_samples_per_task: int,
        num_val_samples_per_task: int,
        preprocessor_cls=None,
        **kwargs,
    ):
        super().__init__(preprocessor_cls=preprocessor_cls, **kwargs)
        self._base_model = base_model
        self._num_train_samples_per_task = num_train_samples_per_task
        self._num_val_samples_per_task = num_val_samples_per_task

    @property
    def base_model(self) -> AbstractT2RModel:
        return self._base_model

    @property
    def default_preprocessor_cls(self):
        return MetaPreprocessor

    @property
    def preprocessor(self) -> AbstractPreprocessor:
        preprocessor_cls = self._preprocessor_cls
        if preprocessor_cls is None:
            preprocessor_cls = self.default_preprocessor_cls
        return preprocessor_cls(
            self._base_model.preprocessor,
            num_train_samples_per_task=self._num_train_samples_per_task,
            num_val_samples_per_task=self._num_val_samples_per_task,
        )

    def get_feature_specification(self, mode: str) -> TensorSpecStruct:
        return create_meta_spec(
            self._base_model.get_feature_specification(mode),
            "features",
            self._num_train_samples_per_task,
            self._num_val_samples_per_task,
        )

    def get_label_specification(self, mode: str) -> TensorSpecStruct:
        return create_meta_spec(
            self._base_model.get_label_specification(mode),
            "labels",
            self._num_train_samples_per_task,
            self._num_val_samples_per_task,
        )

    def flatten_and_add_meta_dim(
        self, train_data, val_data, val_mode
    ) -> TensorSpecStruct:
        """Packs one task's data into a flattened TrainValPair with the
        meta (tasks) dimension prepended: the on-robot inference path."""
        pair = TensorSpecStruct()
        pair.train = flatten_spec_structure(train_data)
        pair.val = flatten_spec_structure(val_data)
        pair.val_mode = val_mode
        flat = flatten_spec_structure(pair)
        for key in flat.train:
            flat.train[key] = np.expand_dims(flat.train[key], 0)
        for key in flat.val:
            flat.val[key] = np.expand_dims(flat.val[key], 0)
        return flat
