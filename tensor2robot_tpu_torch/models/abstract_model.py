"""Model abstraction: the T2RModel contract over torch modules.

A T2RModel declares its tensor specs, owns its preprocessor, builds its
network and provides the pure hooks `inference_network_fn`,
`model_train_fn`, `model_eval_fn` and `create_export_outputs_fn`.

Port of tensor2robot_tpu/models/abstract_model.py. Where the JAX package
passes parameters as an explicit pytree of flax collections, here the
parameters live in the network `nn.Module` that `init_network` builds (or
a predictor restores) and the hooks take that module.
"""

from __future__ import annotations

import abc
import copy
import inspect
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.preprocessors import (
    AbstractPreprocessor,
    NoOpPreprocessor,
)
from tensor2robot_tpu_torch.specs import TensorSpecStruct, validate_and_pack
from tensor2robot_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

MODE_TRAIN = "train"
MODE_EVAL = "eval"
MODE_PREDICT = "predict"


class ModelInterface(abc.ABC):
    """The minimal interface infra relies on."""

    @abc.abstractmethod
    def get_feature_specification(self, mode: str) -> TensorSpecStruct:
        ...

    @abc.abstractmethod
    def get_label_specification(self, mode: str) -> TensorSpecStruct:
        ...

    @property
    @abc.abstractmethod
    def preprocessor(self) -> AbstractPreprocessor:
        ...


class AbstractT2RModel(ModelInterface):
    """Base model: subclass and implement the spec getters, `init_network`,
    `inference_network_fn` and `model_train_fn`.

    Attributes:
      device_type: "tpu" (the JAX default) asks the trainer for the bf16
        policy (models/tpu_model_wrapper.BFloat16ModelWrapper, applied by
        train/train_eval.maybe_wrap_for_tpu); "gpu" or "cpu" train in
        float32.
      use_avg_model_params: the trainer keeps an EMA of the parameters;
        checkpoints hold both and eval and serving select the EMA
        (the JAX package's swapping-saver parity).
      avg_model_params_decay: that EMA's decay.
      init_from_checkpoint_fn: a warm start, state dict -> state dict,
        applied to every freshly initialized network
        (models/checkpoint_init.default_init_from_checkpoint_fn).
      use_summaries: whether the trainer asks its train metrics writer for
        TensorBoard events when train_eval_model's use_tensorboard is None
        (None: off on "tpu", on otherwise, as in the JAX package). The port
        writes no TensorBoard events (train/metrics.py), so this only
        reaches MetricsWriter.
    """

    def __init__(
        self,
        preprocessor_cls: Optional[Callable[..., AbstractPreprocessor]] = None,
        create_optimizer_fn: Optional[Callable[[], Any]] = None,
        device_type: str = "tpu",
        use_avg_model_params: bool = False,
        avg_model_params_decay: float = 0.9999,
        init_from_checkpoint_fn: Optional[
            Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]] = None,
        use_summaries: Optional[bool] = None,
    ):
        self._preprocessor_cls = preprocessor_cls
        self._create_optimizer_fn = create_optimizer_fn
        self._device_type = device_type
        self.use_avg_model_params = use_avg_model_params
        self.avg_model_params_decay = avg_model_params_decay
        self._init_from_checkpoint_fn = init_from_checkpoint_fn
        self._use_summaries = (use_summaries if use_summaries is not None
                               else device_type != "tpu")

    @property
    def device_type(self) -> str:
        return self._device_type

    @property
    def use_summaries(self) -> bool:
        return self._use_summaries

    @property
    def is_device_tpu(self) -> bool:
        return self.device_type == "tpu"

    def maybe_init_from_checkpoint(
        self, state_dict: Dict[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        """The warm-start hook: a fresh network's state dict rewritten from
        a foreign checkpoint, or returned as it is."""
        if self._init_from_checkpoint_fn is not None:
            return self._init_from_checkpoint_fn(state_dict)
        return state_dict

    #: True for a model whose predict forward takes gradients inside (MAML's
    #: inner loop): its export is traced per static batch
    #: (export/saved_model.py).
    forward_takes_gradients = False

    @property
    def preprocessor(self) -> AbstractPreprocessor:
        if self._preprocessor_cls is not None:
            return self._preprocessor_cls(self)
        return NoOpPreprocessor(self)

    @abc.abstractmethod
    def init_network(
        self,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
    ) -> nn.Module:
        """A freshly initialized network on `device`, its weights drawn
        from `generator`."""

    @abc.abstractmethod
    def inference_network_fn(
        self,
        network: nn.Module,
        features: TensorSpecStruct,
        mode: str,
        labels: Optional[TensorSpecStruct] = None,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """Forward pass. Returns (outputs, updates); updates carries any
        state a train-mode forward changes and is {} otherwise. An
        implementation that takes `generator=` receives the train step's
        network generator (JAX's rng for the 'sample' and 'dropout'
        streams); one that does not never draws."""

    @abc.abstractmethod
    def model_train_fn(
        self,
        features: TensorSpecStruct,
        labels: TensorSpecStruct,
        inference_outputs: Dict[str, torch.Tensor],
        mode: str,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns (scalar loss, {metric_name: scalar})."""

    def model_eval_fn(self, features, labels, inference_outputs):
        """Per-batch eval statistics; defaults to the train loss/metrics."""
        loss, metrics = self.model_train_fn(
            features, labels, inference_outputs, MODE_EVAL
        )
        out = {"loss": loss}
        out.update(metrics)
        return out

    def create_export_outputs_fn(self, features, inference_outputs):
        """Selects the serving outputs; defaults to all inference outputs."""
        return inference_outputs

    def create_optimizer(self):
        """The optimizer factory (models/optimizers.py) the trainer binds
        to the network's parameters; Adam at its defaults unless
        `create_optimizer_fn` was given."""
        if self._create_optimizer_fn is not None:
            return self._create_optimizer_fn()
        return optimizers.create_adam_optimizer()

    #: Whether the train loss couples the batch's examples (a contrastive
    #: loss over in-batch negatives): over data x fsdp shards such a model
    #: must carry the trainer's mesh, through which it gathers the
    #: shards' embeddings (collectives.all_gather_data_shards).
    loss_spans_the_batch = False

    def without_mesh(self) -> "AbstractT2RModel":
        """This model as one device runs it: the same network and state
        dict with no mesh (an export over a mesh run's weights). A model
        without a mesh is itself."""
        if getattr(self, "_mesh", None) is None:
            return self
        clone = copy.copy(self)
        clone._mesh = None
        return clone

    def packed_inference(self, network, features, mode, labels=None, generator=None):
        """validate_and_pack features/labels against the model specs, run
        the network, return (features, labels, outputs, updates). In train
        mode `generator` is the step's network generator, passed on where
        inference_network_fn takes one."""
        packed_features = validate_and_pack(
            self.get_feature_specification(mode), features, ignore_batch=True
        )
        packed_labels = None
        if labels is not None:
            packed_labels = validate_and_pack(
                self.get_label_specification(mode), labels, ignore_batch=True
            )
        outputs, updates = self.inference_network_fn(
            network, packed_features, mode, labels=packed_labels,
            **generator_kwargs(self.inference_network_fn, generator)
        )
        return packed_features, packed_labels, outputs, updates


def generator_kwargs(fn: Callable, generator: Optional[torch.Generator]) -> Dict[str, Any]:
    """{"generator": generator} when there is one and `fn` (a function or
    a module's forward) takes it by that name, else {}."""
    if generator is None:
        return {}
    if isinstance(fn, nn.Module):
        fn = fn.forward
    try:
        parameters = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return {}
    return {"generator": generator} if "generator" in parameters else {}


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator) -> None:
    """flax's default kernel init: variance-scaling(1, fan_in) truncated
    normal at two standard deviations."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(
        weight, std=std, a=-2.0 * std, b=2.0 * std, generator=generator
    )


def init_parameters(network: nn.Module, generator: torch.Generator) -> None:
    """Initializes every parameter of `network` in place as flax would:
    Linear/Conv1d/Conv2d kernels lecun-normal and biases zero, LayerNorm
    scale one and bias zero, and modules with parameters of their own
    through their `init_own_parameters(generator)`. The draws come from
    `generator`, so the same seed gives the same weights on any device."""
    with torch.no_grad():
        for module in network.modules():
            if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                fan_in = module.weight[0].numel()
                _lecun_normal_(module.weight, fan_in, generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            init_own = getattr(module, "init_own_parameters", None)
            if init_own is not None:
                init_own(generator)


class TorchT2RModel(AbstractT2RModel):
    """T2RModel over a torch module — the counterpart of the JAX package's
    FlaxT2RModel. Subclasses implement `create_network() -> nn.Module`
    whose `forward(features, mode)` consumes the packed feature struct."""

    @abc.abstractmethod
    def create_network(self) -> nn.Module:
        ...

    def init_network(self, generator=None, device=DEFAULT_DEVICE) -> nn.Module:
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        network = self.create_network()
        init_parameters(network, generator)
        return network.to(device)

    def inference_network_fn(self, network, features, mode, labels=None, generator=None):
        del labels
        return dict(network(features, mode, **generator_kwargs(network, generator))), {}
