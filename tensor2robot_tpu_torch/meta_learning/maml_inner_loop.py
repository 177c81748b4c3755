"""MAML inner-loop gradient descent over explicit parameter dicts.

Port of tensor2robot_tpu/meta_learning/maml_inner_loop.py. The parameters
are a {name: tensor} dict (the real nn.Parameters of a network, or their
adapted values), and each adaptation step is `torch.func.grad_and_value`
of the inner loss:

  for each condition step:  params' = params - lr * grad(inner_loss)
  final monitored step      (forward only, tracks adaptation progress)
  conditioned val pass      (adapted params): the MAML objective
  unconditioned val pass    (original params): for diagnostics

The update is differentiable, so an outer backward through the adapted
parameters takes the second-order gradient, as JAX's default does;
`use_second_order=False` detaches the inner gradients (first-order MAML,
JAX's stop_gradient). Learned inner learning rates are scalar tensors keyed
like the parameters, which the outer optimizer trains.

`var_scope` selects the adapted parameters by their flax path
(utils/keypath.py), so one gin string picks the same parameters in both
packages; the others keep their values in the inner loop.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


class MAMLInnerLoopGradientDescent:
    """Configurable inner-loop SGD.

    Args:
      learning_rate: inner-loop step size (initial value when learned).
      use_second_order: differentiate through the inner gradients; False
        is first-order MAML.
      var_scope: flax path prefix of the parameters that adapt; the others
        stay frozen in the inner loop (the outer loop trains them all).
      learn_inner_lr: per-parameter learned rates, initialized at
        learning_rate.
    """

    def __init__(
        self,
        learning_rate: float = 0.001,
        use_second_order: bool = True,
        var_scope: Optional[str] = None,
        learn_inner_lr: bool = False,
    ):
        self._learning_rate = learning_rate
        self._use_second_order = use_second_order
        self._var_scope = var_scope
        self._learn_inner_lr = learn_inner_lr

    @property
    def learning_rate(self) -> float:
        return self._learning_rate

    @property
    def learn_inner_lr(self) -> bool:
        return self._learn_inner_lr

    def create_inner_lr_params(self, base_params: Mapping[str, torch.Tensor]) -> Tensors:
        """One float32 scalar per parameter, at learning_rate ({} when the
        rates are not learned)."""
        if not self._learn_inner_lr:
            return {}
        return {
            name: torch.tensor(self._learning_rate, dtype=torch.float32,
                               device=param.device)
            for name, param in base_params.items()
        }

    def adapts(self, path: str) -> bool:
        return self._var_scope is None or path.startswith(self._var_scope)

    def _apply_update(self, params: Tensors, grads: Tensors,
                      inner_lrs: Optional[Tensors], paths: Mapping[str, str]) -> Tensors:
        learned = self._learn_inner_lr and bool(inner_lrs)
        out = {}
        for name, param in params.items():
            if not self.adapts(paths.get(name, name)):
                out[name] = param
                continue
            rate = inner_lrs[name] if learned else self._learning_rate
            out[name] = param - rate * grads[name]
        return out

    def inner_loop(
        self,
        base_variables: Mapping[str, Mapping[str, torch.Tensor]],
        inputs_list: Sequence[Tuple[Any, Any]],
        inference_network_fn: Callable,
        model_train_fn: Callable,
        mode: str,
        inner_lrs: Optional[Tensors] = None,
        inner_inference_network_fn: Optional[Callable] = None,
        inner_model_train_fn: Optional[Callable] = None,
        param_paths: Optional[Mapping[str, str]] = None,
    ):
        """Runs len(inputs_list) - 1 adaptation steps.

        Args:
          base_variables: {'params': {name: tensor}, ...}: 'params' adapts;
            any other collection (e.g. 'buffers') is passed along. A
            train-mode forward may update those in place (batch norm): they
            are copied once here, so the updates are thrown away, as JAX
            discards the mutable collections.
          inputs_list: ((cond_f, cond_l),) * k + ((val_f, val_l),); the last
            entry is validation data, never used for an inner gradient.
          inference_network_fn: (variables, features, mode, labels=...) ->
            (outputs, updates).
          model_train_fn: (features, labels, outputs, mode) -> loss or
            (loss, metrics).
          mode: train/eval/predict.
          inner_lrs: the learned rates (learn_inner_lr), keyed as params.
          inner_inference_network_fn: an optional forward for the
            adaptation steps and the unconditioned val pass; the
            conditioned val pass always takes `inference_network_fn`.
          inner_model_train_fn: an optional inner-step loss.
          param_paths: {name: flax path} for var_scope (default: the name).

        Returns:
          ([unconditioned_val_outputs, conditioned_val_outputs],
           inner_outputs (k + 1 entries), inner_losses (k + 1 entries)).
        """
        original_params = dict(base_variables["params"])
        own_collections = {
            collection: {name: value.clone() for name, value in values.items()}
            for collection, values in base_variables.items() if collection != "params"
        }
        paths = param_paths or {}
        inner_forward_fn = inner_inference_network_fn or inference_network_fn
        inner_train_fn = inner_model_train_fn or model_train_fn

        def forward(params, collections, features, labels=None, fn=None):
            variables = dict(collections, params=params)
            outputs, _ = (fn or inference_network_fn)(variables, features, mode,
                                                     labels=labels)
            return outputs

        def step_loss(params, collections, features, labels):
            outputs = forward(params, collections, features, labels, fn=inner_forward_fn)
            result = inner_train_fn(features, labels, outputs, mode)
            loss = result[0] if isinstance(result, tuple) else result
            return loss, outputs

        adapted = original_params
        inner_outputs: List[Any] = []
        inner_losses: List[torch.Tensor] = []
        for features, labels in inputs_list[:-1]:
            grads, (loss, outputs) = torch.func.grad_and_value(step_loss, has_aux=True)(
                adapted, own_collections, features, labels)
            inner_outputs.append(outputs)
            inner_losses.append(loss)
            if not self._use_second_order:
                grads = {name: grad.detach() for name, grad in grads.items()}
            adapted = self._apply_update(adapted, grads, inner_lrs, paths)

        # The final monitored pass on the last condition data: did the
        # adaptation help? Forward only, no gradient step.
        final_features, final_labels = inputs_list[-2]
        final_loss, final_outputs = step_loss(adapted, own_collections, final_features,
                                              final_labels)
        inner_outputs.append(final_outputs)
        inner_losses.append(final_loss)

        val_features, val_labels = inputs_list[-1]
        conditioned = forward(adapted, own_collections, val_features, val_labels)
        unconditioned = forward(original_params, own_collections, val_features, val_labels,
                                fn=inner_forward_fn)
        return [unconditioned, conditioned], inner_outputs, inner_losses
