"""MAML as model composition: wraps any base T2RModel.

Port of tensor2robot_tpu/meta_learning/maml_model.py. The network is a
`MAMLNetwork`: the base model's network under `base` and the learned inner
learning rates under `inner_lrs` (the JAX variables {'params': {'base': ...,
'inner_lrs': ...}}; utils/jax_params.py loads them). The forward maps the
inner loop (maml_inner_loop.py) over the task axis with torch.func.vmap,
as JAX maps it with jax.vmap: each task adapts the base network's real
parameters with torch.func.grad, so the outer loss backpropagates through
the adaptation to the nn.Parameters the optimizer steps. Randomness is the
same across tasks, as in JAX (no pose network draws any).

Batch-norm buffers go into each task's inner loop as per-task copies; a
train-mode forward's updates to them are thrown away, and the network's
own buffers never move in a MAML step, as JAX's MAML forward returns no
mutable updates.

Eval and predict run the inner loop as well, so the forward leaves
inference mode for its inner gradients (on detached parameters: no graph
is kept for an outer backward) and returns detached outputs there. Under
the bf16 wrapper's autocast, which does not reach inside vmap, the
forward applies autocast's casts of convolutions and dense layers as a
torch function mode; FlaxLayerNorm takes its decomposed formula inside
(tf_modules.decomposed_layer_norms), whose second derivatives hold.

In the trainer's sharded_params regime (an fsdp or model dim above 1)
the base's leaves that the rule cuts are this rank's shards; the forward
gathers each whole once before the inner loop and the learned inner rates
(scalars) stay whole (parallel/sharded_params.py has the rule).

Because the predict forward takes gradients (`forward_takes_gradients`),
its export is traced by make_fx per static batch of tasks, inner backward
included, rather than by torch.export over a dynamic batch
(export/saved_model.py).
"""

from __future__ import annotations

import abc
import copy
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode

from tensor2robot_tpu_torch.meta_learning import meta_tfdata, preprocessors
from tensor2robot_tpu_torch.meta_learning.maml_inner_loop import (
    MAMLInnerLoopGradientDescent,
)
from tensor2robot_tpu_torch.models.abstract_model import AbstractT2RModel
from tensor2robot_tpu_torch.parallel import sharded_params
from tensor2robot_tpu_torch.research.dql_grasping_lib.tf_modules import (
    decomposed_layer_norms,
)
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.utils.device import DEFAULT_DEVICE
from tensor2robot_tpu_torch.utils.keypath import flax_parameter_paths


class MAMLNetwork(nn.Module):
    """The base network (`base`) and one learned inner learning rate per
    base parameter (`inner_lrs`, keyed by the parameter's flax path:
    a ParameterDict key cannot hold the '.' of a torch name; empty when
    the rates are not learned)."""

    #: The inner loop takes the base's parameters functionally
    #: (functional_call): sharded over fsdp or model, they are gathered
    #: whole before it (parallel/sharded_params.gathered_parameters).
    takes_sharded_params = False

    def __init__(self, base: nn.Module, learn_inner_lr: bool = False,
                 learning_rate: float = 0.001):
        super().__init__()
        self.base = base
        self.inner_lr_keys = (flax_parameter_paths(base) if learn_inner_lr else {})
        self.inner_lrs = nn.ParameterDict({
            key: nn.Parameter(torch.tensor(float(learning_rate), dtype=torch.float32))
            for key in self.inner_lr_keys.values()
        })


class _BaseCall(nn.Module):
    """A base-model hook over `base`, as a module for functional_call."""

    def __init__(self, fn: Callable, base: nn.Module):
        super().__init__()
        self.fn = fn
        self.base = base

    def forward(self, features, mode, labels=None):
        return self.fn(self.base, features, mode, labels=labels)


def _usable(value):
    """A tensor made in inference mode, cloned into a normal one (autograd
    may not save an inference tensor)."""
    if isinstance(value, torch.Tensor) and value.is_inference():
        return value.clone()
    return value


class _LowPrecisionOps(TorchFunctionMode):
    """Autocast's casts for the ops the port's networks run in lower
    precision under it (convolutions, dense layers, matrix products): their
    floating operands go to `dtype`, the float32 masters' gradients flow
    back through the casts. Norms keep float32 as under autocast
    (FlaxLayerNorm promotes its input to its parameters' dtype)."""

    OPS = frozenset({torch.conv1d, torch.conv2d, torch.conv3d, F.linear, torch.matmul,
                     torch.mm, torch.bmm, torch.addmm, torch.baddbmm})

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self._dtype = dtype

    def _cast(self, value):
        if isinstance(value, torch.Tensor) and value.is_floating_point():
            return value.to(self._dtype)
        return value

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.OPS:
            args = tuple(self._cast(a) for a in args)
            kwargs = {k: self._cast(v) for k, v in kwargs.items()}
        return func(*args, **kwargs)


def _float32(structure):
    """bf16 tensors of a structure in float32 (the inner losses, as the
    bf16 wrapper computes every loss, accumulate in float32)."""
    return meta_tfdata.map_structure(
        lambda x: x.float() if x.dtype == torch.bfloat16 else x, structure)


class MAMLModel(AbstractT2RModel):
    """Base class for MAML meta models. Subclasses implement
    `_select_inference_output` to pick the `condition_output` and
    `inference_output` keys that meta policies consume."""

    forward_takes_gradients = True

    def __init__(
        self,
        base_model: AbstractT2RModel,
        preprocessor_cls=None,
        num_inner_loop_steps: int = 1,
        var_scope: Optional[str] = None,
        inner_learning_rate: float = 0.001,
        use_second_order: bool = True,
        learn_inner_lr: bool = False,
        **kwargs,
    ):
        kwargs.setdefault("device_type", base_model.device_type)
        super().__init__(**kwargs)
        self._base_model = base_model
        self._maml_preprocessor_cls = preprocessor_cls
        self._num_inner_loop_steps = max(1, num_inner_loop_steps)
        self._inner_loop = MAMLInnerLoopGradientDescent(
            learning_rate=inner_learning_rate,
            use_second_order=use_second_order,
            var_scope=var_scope,
            learn_inner_lr=learn_inner_lr,
        )

    @property
    def base_model(self) -> AbstractT2RModel:
        return self._base_model

    # -- a base built with the trainer's mesh ----------------------------------

    @property
    def loss_spans_the_batch(self) -> bool:
        """The base's: the outer loss is the base's over every task."""
        return getattr(self._base_model, "loss_spans_the_batch", False)

    @property
    def _mesh(self):
        return getattr(self._base_model, "_mesh", None)

    def without_mesh(self) -> "MAMLModel":
        """This model over the base without its mesh."""
        base = self._base_model.without_mesh()
        if base is self._base_model:
            return self
        clone = copy.copy(self)
        clone._base_model = base
        return clone

    @property
    def num_inner_loop_steps(self) -> int:
        return self._num_inner_loop_steps

    # -- specs ----------------------------------------------------------------

    @property
    def preprocessor(self):
        cls = self._maml_preprocessor_cls or preprocessors.MAMLPreprocessorV2
        preprocessor = cls(self._base_model.preprocessor)
        if not isinstance(preprocessor, preprocessors.MAMLPreprocessorV2):
            raise ValueError("Only MAMLPreprocessorV2 subclasses are supported.")
        return preprocessor

    def get_feature_specification(self, mode: str) -> TensorSpecStruct:
        return preprocessors.create_maml_feature_spec(
            self._base_model.get_feature_specification(mode),
            self._base_model.get_label_specification(mode))

    def get_label_specification(self, mode: str) -> TensorSpecStruct:
        return preprocessors.create_maml_label_spec(
            self._base_model.get_label_specification(mode))

    def get_feature_specification_for_packing(self, mode: str):
        return self._base_model.preprocessor.get_in_feature_specification(mode)

    def get_label_specification_for_packing(self, mode: str):
        return self._base_model.preprocessor.get_in_label_specification(mode)

    # -- the network ----------------------------------------------------------

    def create_network(self) -> MAMLNetwork:
        return MAMLNetwork(self._base_model.create_network(),
                           self._inner_loop.learn_inner_lr,
                           self._inner_loop.learning_rate)

    def init_network(self, generator: Optional[torch.Generator] = None,
                     device: Union[str, torch.device] = DEFAULT_DEVICE) -> MAMLNetwork:
        """The base model's initialized network, and the inner rates at
        inner_learning_rate."""
        base = self._base_model.init_network(generator, device)
        network = MAMLNetwork(base, self._inner_loop.learn_inner_lr,
                              self._inner_loop.learning_rate)
        return network.to(next(base.parameters()).device)

    # -- forward --------------------------------------------------------------

    def inference_network_fn(self, network: MAMLNetwork, features, mode, labels=None):
        outer_grad = torch.is_grad_enabled() and not torch.is_inference_mode_enabled()
        with torch.inference_mode(False), torch.enable_grad(), decomposed_layer_norms():
            predictions = self._meta_forward(
                network, meta_tfdata.map_structure(_usable, features), mode,
                meta_tfdata.map_structure(_usable, labels), outer_grad)
        if not outer_grad:
            predictions = TensorSpecStruct(
                {key: value.detach() for key, value in predictions.items()})
        predictions = self._select_inference_output(predictions)
        for key in ("condition_output", "inference_output"):
            if key not in predictions:
                raise ValueError(f"The required {key} is not in predictions "
                                 f"{list(predictions.keys())}.")
        return predictions, {}

    def _meta_forward(self, network, features, mode, labels, outer_grad):
        base = network.base
        # Whole tensors for functional_call: a leaf sharded over fsdp or
        # model is gathered here, once, outside the vmap over tasks and the
        # inner grad, so its backward runs once, in the outer backward.
        params = sharded_params.gathered_parameters(base)
        inner_lrs = None
        if self._inner_loop.learn_inner_lr:
            inner_lrs = {name: network.inner_lrs[key]
                         for name, key in network.inner_lr_keys.items()}
        if not outer_grad:
            params = {name: p.detach() for name, p in params.items()}
            if inner_lrs is not None:
                inner_lrs = {name: lr.detach() for name, lr in inner_lrs.items()}
        paths = flax_parameter_paths(base)
        # Each task adapts on its own samples: the inner loop runs the base
        # without a mesh (the outer loss, model_train_fn, takes the base's
        # over the tasks of every shard).
        base_model = self._base_model.without_mesh()

        def bind(fn: Callable) -> Callable:
            call = _BaseCall(fn, base)

            def run(variables, task_features, mode_, labels=None):
                tensors = {f"base.{n}": t for n, t in variables["params"].items()}
                tensors.update({f"base.{n}": t for n, t in variables["buffers"].items()})
                return torch.func.functional_call(call, tensors, (task_features, mode_),
                                                  {"labels": labels})
            return run

        inner_forward = getattr(base_model, "inner_inference_network_fn", None)
        inner_train = getattr(base_model, "model_inner_loop_fn", None)

        def f32_loss(fn: Callable) -> Callable:
            return lambda f, l, o, m: fn(f, _float32(l), _float32(o), m)

        k = self._num_inner_loop_steps

        def task_learn(task_buffers, cond_features, cond_labels, inf_features,
                       *inf_labels):
            cond_features = TensorSpecStruct(cond_features)
            cond_labels = TensorSpecStruct(cond_labels)
            inf_features = TensorSpecStruct(inf_features)
            val_labels = TensorSpecStruct(inf_labels[0]) if inf_labels else cond_labels
            inputs_list = ((cond_features, cond_labels),) * k + (
                (inf_features, val_labels),)
            (uncond, cond), inner_outputs, inner_losses = self._inner_loop.inner_loop(
                {"params": params, "buffers": task_buffers},
                inputs_list,
                bind(base_model.inference_network_fn),
                f32_loss(base_model.model_train_fn),
                mode,
                inner_lrs=inner_lrs,
                inner_inference_network_fn=bind(inner_forward) if inner_forward else None,
                inner_model_train_fn=f32_loss(inner_train) if inner_train else None,
                param_paths=paths,
            )
            return (dict(uncond), dict(cond), tuple(dict(o) for o in inner_outputs),
                    tuple(inner_losses))

        cond_features = dict(features.condition.features.items())
        num_tasks = next(iter(cond_features.values())).shape[0]
        base_device = next(iter(params.values())).device
        task_buffers = {
            name: buffer.detach().expand((num_tasks,) + tuple(buffer.shape)).clone()
            for name, buffer in base.named_buffers()
        }
        args = [task_buffers, cond_features, dict(features.condition.labels.items()),
                dict(features.inference.features.items())]
        if labels is not None:
            args.append(dict(labels.items()))
        task_map = torch.func.vmap(task_learn, randomness="same")
        if torch.is_autocast_enabled(base_device.type):
            # autocast does not reach inside torch.func.vmap (its ops run
            # there in float32, and a bf16 input then meets a float32 conv
            # bias): its casts of the networks' convolutions and dense
            # layers run as a torch function mode instead.
            low = torch.get_autocast_dtype(base_device.type)
            with torch.autocast(base_device.type, enabled=False), _LowPrecisionOps(low):
                uncond, cond, inner_outputs, inner_losses = task_map(*args)
        else:
            uncond, cond, inner_outputs, inner_losses = task_map(*args)

        predictions = TensorSpecStruct()
        for key, value in inner_outputs[0].items():
            predictions[f"full_condition_output/{key}"] = value
        for pos, step_output in enumerate(inner_outputs):
            for key, value in step_output.items():
                predictions[f"full_condition_outputs/output_{pos}/{key}"] = value
        for key, value in uncond.items():
            predictions[f"full_inference_output_unconditioned/{key}"] = value
        for key, value in cond.items():
            predictions[f"full_inference_output/{key}"] = value
        for pos, loss in enumerate(inner_losses):
            predictions[f"inner_losses/step_{pos}"] = loss
        return predictions

    @abc.abstractmethod
    def _select_inference_output(self, predictions: TensorSpecStruct) -> TensorSpecStruct:
        """Assigns `condition_output` and `inference_output` from the full
        outputs."""

    # -- losses ---------------------------------------------------------------

    def _flat_inference(self, features, labels, inference_outputs):
        flatten = meta_tfdata.flatten_batch_examples
        return (flatten(features.inference.features), flatten(labels),
                flatten(inference_outputs.full_inference_output))

    def model_train_fn(self, features, labels, inference_outputs, mode):
        """The outer loss: the base loss on the conditioned inference
        outputs over the flattened [task, samples] batch, and the mean inner
        loss of each step as `inner_loss_{i}`."""
        loss, metrics = self._base_model.model_train_fn(
            *self._flat_inference(features, labels, inference_outputs), mode)
        out_metrics = dict(metrics)
        for pos in range(self._num_inner_loop_steps + 1):
            out_metrics[f"inner_loss_{pos}"] = torch.mean(
                inference_outputs[f"inner_losses/step_{pos}"])
        return loss, out_metrics

    def model_eval_fn(self, features, labels, inference_outputs):
        return self._base_model.model_eval_fn(
            *self._flat_inference(features, labels, inference_outputs))

    def create_optimizer(self):
        return self._base_model.create_optimizer()
