"""Meta-learning specs and preprocessors.

Port of tensor2robot_tpu/meta_learning/preprocessors.py. Meta specs nest a
base model's contract into:

  features.condition.features / features.condition.labels   (adaptation data)
  features.inference.features                               (evaluation data)
  labels (meta_labels prefix)                               (outer-loss labels)

with a per-task samples dim (None) prepended to every spec. The
MetaExample layout stores episode i of a task as `<prefix>_ep<i>/<name>`
feature columns of one example (create_metaexample_spec).

Where the JAX preprocessors split one rng into a condition half and an
inference half, these draw both halves from the step's one
torch.Generator, the condition batch first.
"""

from __future__ import annotations

import torch

from tensor2robot_tpu_torch.meta_learning import meta_tfdata
from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
    AbstractPreprocessor,
)
from tensor2robot_tpu_torch.specs import (
    ExtendedTensorSpec,
    TensorSpecStruct,
    copy_tensorspec,
    flatten_spec_structure,
)


def create_maml_feature_spec(feature_spec, label_spec) -> TensorSpecStruct:
    """Meta feature spec from base specs: condition carries features and
    labels, inference carries features; every spec gains a per-task samples
    dim and a routing prefix on its name."""
    condition_spec = TensorSpecStruct()
    condition_spec.features = flatten_spec_structure(
        copy_tensorspec(feature_spec, batch_size=-1, prefix="condition_features"))
    condition_spec.labels = flatten_spec_structure(
        copy_tensorspec(label_spec, batch_size=-1, prefix="condition_labels"))
    inference_spec = TensorSpecStruct()
    inference_spec.features = flatten_spec_structure(
        copy_tensorspec(feature_spec, batch_size=-1, prefix="inference_features"))
    meta_feature_spec = TensorSpecStruct()
    meta_feature_spec.condition = condition_spec
    meta_feature_spec.inference = inference_spec
    return meta_feature_spec


def create_maml_label_spec(label_spec) -> TensorSpecStruct:
    """The outer loss's label spec."""
    return flatten_spec_structure(
        copy_tensorspec(label_spec, batch_size=-1, prefix="meta_labels"))


class MAMLPreprocessorV2(AbstractPreprocessor):
    """Wraps a base preprocessor's contract into meta shape: the transform
    flattens [task, samples] to one batch, runs the base preprocessor, and
    restores the task structure."""

    def __init__(self, base_preprocessor: AbstractPreprocessor):
        super().__init__()
        self._base_preprocessor = base_preprocessor

    @property
    def base_preprocessor(self) -> AbstractPreprocessor:
        return self._base_preprocessor

    def get_in_feature_specification(self, mode):
        return create_maml_feature_spec(
            self._base_preprocessor.get_in_feature_specification(mode),
            self._base_preprocessor.get_in_label_specification(mode))

    def get_in_label_specification(self, mode):
        return create_maml_label_spec(
            self._base_preprocessor.get_in_label_specification(mode))

    def get_out_feature_specification(self, mode):
        return create_maml_feature_spec(
            self._base_preprocessor.get_out_feature_specification(mode),
            self._base_preprocessor.get_out_label_specification(mode))

    def get_out_label_specification(self, mode):
        return create_maml_label_spec(
            self._base_preprocessor.get_out_label_specification(mode))

    def _preprocess_fn(self, features, labels, mode, generator):
        num_condition = list(features.condition.features.values())[0].shape[1]
        num_inference = list(features.inference.features.values())[0].shape[1]
        flatten = meta_tfdata.flatten_batch_examples
        cond_features, cond_labels = self._base_preprocessor.preprocess(
            flatten(features.condition.features), flatten(features.condition.labels),
            mode=mode, generator=generator)
        inf_features, out_labels = self._base_preprocessor.preprocess(
            flatten(features.inference.features),
            flatten(labels) if labels is not None else None,
            mode=mode, generator=generator)

        out = TensorSpecStruct()
        condition = TensorSpecStruct()
        condition.features = meta_tfdata.unflatten_batch_examples(
            cond_features, num_condition)
        condition.labels = meta_tfdata.unflatten_batch_examples(cond_labels, num_condition)
        inference = TensorSpecStruct()
        inference.features = meta_tfdata.unflatten_batch_examples(
            inf_features, num_inference)
        out.condition = condition
        out.inference = inference
        if out_labels is not None:
            out_labels = meta_tfdata.unflatten_batch_examples(out_labels, num_inference)
        return out, out_labels


def create_metaexample_spec(model_spec, num_samples_per_task: int,
                            prefix: str) -> TensorSpecStruct:
    """Expands each spec into per-episode columns `<key>/<i>` named
    `<prefix>_ep<i>/<name>`."""
    model_spec = flatten_spec_structure(model_spec)
    meta_example_spec = TensorSpecStruct()
    for key in model_spec.keys():
        spec = model_spec[key]
        name = spec.name if spec.name is not None else key
        for i in range(num_samples_per_task):
            meta_example_spec[f"{key}/{i}"] = ExtendedTensorSpec.from_spec(
                spec, name=f"{prefix}_ep{i}/{name}")
    return meta_example_spec


def stack_intra_task_episodes(in_tensors, num_samples_per_task: int) -> TensorSpecStruct:
    """Stacks `<key>/<i>` episode columns into one [batch, samples, ...]
    tensor per key."""
    out_tensors = TensorSpecStruct()
    key_set = sorted({"/".join(key.split("/")[:-1]) for key in in_tensors.keys()})
    for key in key_set:
        out_tensors[key] = torch.stack(
            [in_tensors[f"{key}/{i}"] for i in range(num_samples_per_task)], dim=1)
    return out_tensors


class FixedLenMetaExamplePreprocessor(MAMLPreprocessorV2):
    """Parses per-episode MetaExample columns, stacks them into the task
    layout, then applies the MAML preprocessing."""

    def __init__(
        self,
        base_preprocessor: AbstractPreprocessor,
        num_condition_samples_per_task: int = 1,
        num_inference_samples_per_task: int = 1,
    ):
        self._num_condition_samples_per_task = num_condition_samples_per_task
        self._num_inference_samples_per_task = num_inference_samples_per_task
        super().__init__(base_preprocessor)

    @property
    def num_condition_samples_per_task(self) -> int:
        return self._num_condition_samples_per_task

    @property
    def num_inference_samples_per_task(self) -> int:
        return self._num_inference_samples_per_task

    def get_in_feature_specification(self, mode):
        base = self._base_preprocessor
        condition_spec = TensorSpecStruct()
        condition_spec.features = base.get_in_feature_specification(mode)
        condition_spec.labels = base.get_in_label_specification(mode)
        inference_spec = TensorSpecStruct()
        inference_spec.features = base.get_in_feature_specification(mode)
        feature_spec = TensorSpecStruct()
        feature_spec.condition = create_metaexample_spec(
            condition_spec, self._num_condition_samples_per_task, "condition")
        feature_spec.inference = create_metaexample_spec(
            inference_spec, self._num_inference_samples_per_task, "inference")
        return flatten_spec_structure(feature_spec)

    def get_in_label_specification(self, mode):
        return flatten_spec_structure(create_metaexample_spec(
            self._base_preprocessor.get_in_label_specification(mode),
            self._num_inference_samples_per_task, "inference"))

    def _preprocess_fn(self, features, labels, mode, generator):
        stacked = TensorSpecStruct()
        stacked.condition = stack_intra_task_episodes(
            features.condition, self._num_condition_samples_per_task)
        stacked.inference = stack_intra_task_episodes(
            features.inference, self._num_inference_samples_per_task)
        stacked_labels = None
        if labels is not None:
            stacked_labels = stack_intra_task_episodes(
                labels, self._num_inference_samples_per_task)
        return super()._preprocess_fn(stacked, stacked_labels, mode, generator)
