"""Concrete model-family bases: Classification, Regression, Critic.

Port of tensor2robot_tpu/models/base_models.py:
  * ClassificationModel: the network emits `a_predicted` logits; sigmoid
    cross-entropy against labels `a_target`; accuracy, precision, recall
    and mse in eval.
  * RegressionModel: the network emits `inference_output`; mse against
    labels `target`.
  * CriticModel: Q(state, action) with split state/action specs, the
    PREDICT action spec tiled by `action_batch_size` for CEM, `q_predicted`
    logits and a sigmoid cross-entropy against labels `reward`.

The cross-entropy is optax.sigmoid_binary_cross_entropy's formula:
-y log sigmoid(x) - (1 - y) log sigmoid(-x).
"""

from __future__ import annotations

import abc
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tensor2robot_tpu_torch.models.abstract_model import (
    MODE_PREDICT,
    TorchT2RModel,
)
from tensor2robot_tpu_torch.specs import (
    ExtendedTensorSpec,
    TensorSpecStruct,
    copy_tensorspec,
)


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Elementwise, as optax.sigmoid_binary_cross_entropy."""
    labels = labels.to(logits.dtype)
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


class ClassificationModel(TorchT2RModel):
    """Binary/multi-label classifier contract."""

    def model_train_fn(self, features, labels, inference_outputs, mode):
        loss = torch.mean(sigmoid_binary_cross_entropy(
            inference_outputs["a_predicted"], labels["a_target"]))
        return loss, {"loss/sigmoid_ce": loss}

    def model_eval_fn(self, features, labels, inference_outputs):
        logits = inference_outputs["a_predicted"]
        targets = labels["a_target"].float()
        probabilities = torch.sigmoid(logits)
        predictions = (probabilities > 0.5).float()
        accuracy = torch.mean((predictions == targets).float())
        true_positives = torch.sum(predictions * targets)
        precision = true_positives / torch.clamp_min(torch.sum(predictions), 1.0)
        recall = true_positives / torch.clamp_min(torch.sum(targets), 1.0)
        return {
            "loss": torch.mean(sigmoid_binary_cross_entropy(logits, targets)),
            "accuracy": accuracy,
            "precision": precision,
            "recall": recall,
            "mean_squared_error": torch.mean(torch.square(probabilities - targets)),
        }


class RegressionModel(TorchT2RModel):
    """Regressor contract: network emits `inference_output`; labels carry
    `target`."""

    def model_train_fn(self, features, labels, inference_outputs, mode):
        loss = torch.mean(torch.square(
            inference_outputs["inference_output"] - labels["target"]))
        return loss, {"loss/mse": loss}


def _rewards_like(q: torch.Tensor, reward: torch.Tensor) -> torch.Tensor:
    if reward.ndim == q.ndim + 1:
        reward = reward.squeeze(-1)
    return reward


class CriticModel(TorchT2RModel):
    """Q(s, a) critic with CEM-friendly action tiling.

    Subclasses provide `get_state_specification` and
    `get_action_specification`; the feature spec nests them under state/
    and action/. In PREDICT the action spec gains a leading
    `action_batch_size` dim, so one forward scores a whole CEM population
    per state.
    """

    def __init__(self, action_batch_size: Optional[int] = None, **kwargs):
        super().__init__(**kwargs)
        self._action_batch_size = action_batch_size

    @abc.abstractmethod
    def get_state_specification(self) -> TensorSpecStruct:
        ...

    @abc.abstractmethod
    def get_action_specification(self) -> TensorSpecStruct:
        ...

    @property
    def action_batch_size(self) -> Optional[int]:
        return self._action_batch_size

    def get_feature_specification(self, mode: str) -> TensorSpecStruct:
        spec = TensorSpecStruct()
        spec.state = self.get_state_specification()
        if mode == MODE_PREDICT and self._action_batch_size is not None:
            spec.action = copy_tensorspec(
                self.get_action_specification(),
                batch_size=self._action_batch_size,
            )
        else:
            spec.action = self.get_action_specification()
        return spec

    def get_feature_specification_for_packing(self, mode: str) -> TensorSpecStruct:
        # Policies pack raw observations only; the CEM layer supplies actions.
        spec = TensorSpecStruct()
        spec.state = self.get_state_specification()
        return spec

    def get_label_specification(self, mode: str) -> TensorSpecStruct:
        spec = TensorSpecStruct()
        spec["reward"] = ExtendedTensorSpec(
            shape=(1,), dtype=np.float32, name="reward"
        )
        return spec

    def model_train_fn(self, features, labels, inference_outputs, mode):
        q = inference_outputs["q_predicted"]
        reward = _rewards_like(q, labels["reward"])
        loss = torch.mean(sigmoid_binary_cross_entropy(q, reward))
        return loss, {"loss/bellman_supervised": loss}

    def model_eval_fn(self, features, labels, inference_outputs):
        q = inference_outputs["q_predicted"]
        reward = _rewards_like(q, labels["reward"])
        probabilities = torch.sigmoid(q)
        predictions = (probabilities > 0.5).float()
        return {
            "loss": torch.mean(sigmoid_binary_cross_entropy(q, reward)),
            "accuracy": torch.mean((predictions == reward).float()),
            "q_mean": torch.mean(probabilities),
        }


def tile_actions_for_cem(
    state_features: TensorSpecStruct, actions: torch.Tensor,
) -> Tuple[TensorSpecStruct, torch.Tensor]:
    """Expands [B, N, A] CEM action populations and [B, ...] states into
    the megabatch layout [B*N, ...]: each state repeated N times, so the
    critic scores every (state, candidate) pair in one batched pass."""
    b, n = actions.shape[0], actions.shape[1]
    flat_actions = actions.reshape((b * n,) + tuple(actions.shape[2:]))
    tiled = TensorSpecStruct()
    for key, value in state_features.items():
        tiled[key] = torch.repeat_interleave(value, n, dim=0)
    return tiled, flat_actions
