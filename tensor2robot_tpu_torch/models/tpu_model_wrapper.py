"""The bf16 dtype policy of a model, as a CUDA (or CPU) bf16 autocast.

Port of tensor2robot_tpu/models/tpu_model_wrapper.py (TPUT2RModelWrapper):
  * feature and label specs declare float32 as bfloat16 (the infeed
    contract), and the preprocessor is wrapped in
    preprocessors/dtype_policy.py's BFloat16PreprocessorWrapper;
  * the network runs under torch.autocast(bfloat16): convs and dense
    layers compute in bf16 with float32 master parameters, and a network
    that asks for float32 (the Grasping44 logit head, batch-norm
    statistics) keeps it. The float32 forward is the unwrapped model;
  * losses, eval metrics and export outputs are computed from float32.
"""

from __future__ import annotations

import torch

from tensor2robot_tpu_torch.models.abstract_model import (
    AbstractT2RModel,
    generator_kwargs,
)
from tensor2robot_tpu_torch.preprocessors.dtype_policy import (
    BFloat16PreprocessorWrapper,
    cast_spec_dtypes,
    cast_tensors,
)
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.utils.device import DEFAULT_DEVICE


def _to_f32(structure):
    if structure is None:
        return None
    return cast_tensors(structure, torch.bfloat16, torch.float32)


class BFloat16ModelWrapper(AbstractT2RModel):
    """Wraps `model` with the bf16 spec and autocast policy."""

    def __init__(self, model: AbstractT2RModel):
        super().__init__(
            device_type="tpu",
            use_avg_model_params=model.use_avg_model_params,
            avg_model_params_decay=model.avg_model_params_decay,
        )
        self._model = model

    @property
    def wrapped(self) -> AbstractT2RModel:
        return self._model

    def get_feature_specification(self, mode: str) -> TensorSpecStruct:
        return cast_spec_dtypes(self._model.get_feature_specification(mode),
                                torch.float32, torch.bfloat16)

    def get_label_specification(self, mode: str) -> TensorSpecStruct:
        return cast_spec_dtypes(self._model.get_label_specification(mode),
                                torch.float32, torch.bfloat16)

    def get_feature_specification_for_packing(self, mode: str) -> TensorSpecStruct:
        return self._model.get_feature_specification_for_packing(mode)

    @property
    def preprocessor(self):
        return BFloat16PreprocessorWrapper(self._model.preprocessor)

    # -- the network's lifecycle: float32 masters of the wrapped model ------

    def create_network(self):
        return self._model.create_network()

    def init_network(self, generator=None, device=DEFAULT_DEVICE):
        return self._model.init_network(generator, device)

    def create_optimizer(self):
        return self._model.create_optimizer()

    def maybe_init_from_checkpoint(self, state_dict):
        return self._model.maybe_init_from_checkpoint(state_dict)

    @property
    def forward_takes_gradients(self) -> bool:
        return self._model.forward_takes_gradients

    # -- the hooks: autocast, and float32 at the boundaries ------------------

    def inference_network_fn(self, network, features, mode, labels=None, generator=None):
        device_type = next(network.parameters()).device.type
        with torch.autocast(device_type=device_type, dtype=torch.bfloat16):
            return self._model.inference_network_fn(
                network, features, mode, labels=labels,
                **generator_kwargs(self._model.inference_network_fn, generator))

    def without_mesh(self):
        inner = self._model.without_mesh()
        return self if inner is self._model else BFloat16ModelWrapper(inner)

    def model_train_fn(self, features, labels, inference_outputs, mode):
        return self._model.model_train_fn(
            _to_f32(features), _to_f32(labels), _to_f32(inference_outputs), mode)

    def model_eval_fn(self, features, labels, inference_outputs):
        return self._model.model_eval_fn(
            _to_f32(features), _to_f32(labels), _to_f32(inference_outputs))

    def create_export_outputs_fn(self, features, inference_outputs):
        return _to_f32(
            self._model.create_export_outputs_fn(features, inference_outputs))
