"""PoseEnv models: the minimal end-to-end train/collect/eval testbed.

Port of tensor2robot_tpu/research/pose_env/pose_env_models.py:
`PoseEnvContinuousMCModel` (a Monte-Carlo critic Q(image, pose) that
scores a whole CEM population per state) and `PoseEnvRegressionModel`
(image -> pose, reward-weighted MSE), with their uint8 -> [0, 1]
preprocessors. Modules are named as the flax modules are, so
utils/jax_params.py converts the JAX package's variables onto them. The
MAML variant is pose_env_maml_models.py.

The regression loss is a ratio of sums over the batch (the weighted
squared error over the weights), so over data x fsdp shards the model is
built with the trainer's mesh (`loss_spans_the_batch`) and sums both over
the shards (collectives.psum_data_shards) before it divides: every rank
takes the global batch's loss, as the JAX package's GSPMD step does,
where a mean of the shards' ratios would weigh each shard's samples by
its own total weight.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers.vision_layers import (
    ImageFeaturesToPoseNet,
    ImagesToFeaturesNet,
    init_flax_layers,
)
from tensor2robot_tpu_torch.models.abstract_model import MODE_TRAIN, init_parameters
from tensor2robot_tpu_torch.models.base_models import CriticModel, RegressionModel
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
    SpecTransformationPreprocessor,
)
from tensor2robot_tpu_torch.research.dql_grasping_lib import tf_modules
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, TensorSpecStruct
from tensor2robot_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

IMAGE_SHAPE = (64, 64, 3)


def _image_spec(name: str = "state/image") -> ExtendedTensorSpec:
    return ExtendedTensorSpec(
        shape=IMAGE_SHAPE, dtype=np.float32, name=name, data_format="jpeg")


def _init_network(model, generator, device) -> nn.Module:
    """flax's default inits (models/abstract_model.init_parameters), then
    each layer's own flax initializers (vision_layers.init_flax_layers)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    network = model.create_network()
    init_parameters(network, generator)
    init_flax_layers(network, generator)
    return network.to(device)


class DefaultPoseEnvContinuousPreprocessor(SpecTransformationPreprocessor):
    """uint8 jpeg image source -> float32 [0, 1]."""

    def _transform_in_feature_specification(self, spec, mode):
        self.update_spec(spec, "state/image", dtype=np.uint8)
        return spec

    def _preprocess_fn(self, features, labels, mode, generator):
        features["state/image"] = features["state/image"].to(torch.float32) / 255.0
        return features, labels


class _PoseMCNet(nn.Module):
    """Q(image, pose) tower: 3 stride-2 VALID convs with layer norm, the
    action context broadcast-added to the conv map, then an fc stack to
    one Q logit."""

    def __init__(self, channels: int = 32):
        super().__init__()
        in_channels, size = IMAGE_SHAPE[2], IMAGE_SHAPE[0]
        for i in range(3):
            conv, norm = tf_modules.make_conv_block(in_channels, channels)
            self.add_module(f"conv{i}", conv)
            self.add_module(f"conv{i}_ln", norm)
            in_channels, size = channels, (size - 3) // 2 + 1
        self.action_fc = nn.Linear(2, channels)
        self.action_ln = tf_modules.FlaxLayerNorm(channels)
        width = size * size * channels
        for i, hidden in enumerate((100, 100)):
            self.add_module(f"fc{i}", nn.Linear(width, hidden))
            self.add_module(f"fc_ln{i}", tf_modules.FlaxLayerNorm(hidden))
            width = hidden
        self.q = nn.Linear(width, 1)

    def flax_init(self, generator: torch.Generator) -> None:
        for i in range(3):
            tf_modules.init_conv_block(getattr(self, f"conv{i}"), generator)

    def forward(self, features, mode):
        del mode
        image = features["state/image"]
        pose = features["action/pose"]
        tiled = pose.ndim == 3
        if tiled:
            # CEM megabatch: [B, N, 2] actions against [B, H, W, C] states.
            action_batch = pose.shape[1]
            pose = pose.reshape(-1, pose.shape[-1])
        net = image
        for i in range(3):
            net = tf_modules.conv_block(
                net, getattr(self, f"conv{i}"), getattr(self, f"conv{i}_ln"))
        context = F.relu(self.action_ln(self.action_fc(pose)))
        if tiled:
            net = torch.repeat_interleave(net, action_batch, dim=0)
        net = tf_modules.add_context(net, context)
        net = net.reshape(net.shape[0], -1)  # NHWC order, as flax flattens
        for i in range(2):
            net = F.relu(getattr(self, f"fc_ln{i}")(getattr(self, f"fc{i}")(net)))
        q = self.q(net).squeeze(-1)
        if tiled:
            q = q.reshape(-1, action_batch)
        return {"q_predicted": q}


class PoseEnvContinuousMCModel(CriticModel):
    """Monte-Carlo critic Q(image, pose)."""

    def __init__(self, **kwargs):
        kwargs.setdefault("preprocessor_cls", DefaultPoseEnvContinuousPreprocessor)
        super().__init__(**kwargs)

    def get_state_specification(self) -> TensorSpecStruct:
        return TensorSpecStruct(image=_image_spec())

    def get_action_specification(self) -> TensorSpecStruct:
        return TensorSpecStruct(
            pose=ExtendedTensorSpec(shape=(2,), dtype=np.float32, name="pose"))

    def get_label_specification(self, mode: str) -> TensorSpecStruct:
        del mode
        return TensorSpecStruct(
            reward=ExtendedTensorSpec(shape=(), dtype=np.float32, name="reward"))

    def create_network(self) -> nn.Module:
        return _PoseMCNet()

    def init_network(self, generator=None, device: Union[str, torch.device] = DEFAULT_DEVICE):
        return _init_network(self, generator, device)

    def model_train_fn(self, features, labels, inference_outputs, mode):
        # MC regression of Q toward the observed return (the env's reward
        # is continuous, so MSE rather than the log loss of binary critics).
        q = inference_outputs["q_predicted"]
        loss = torch.mean(torch.square(q - labels["reward"]))
        return loss, {"loss/q_mse": loss}

    def model_eval_fn(self, features, labels, inference_outputs):
        loss, metrics = self.model_train_fn(
            features, labels, inference_outputs, "eval")
        out = {"loss": loss}
        out.update(metrics)
        return out

    def pack_features(self, state, context, timestep, actions):
        """(obs, CEM action population) -> predict features in the CEM
        megabatch layout: [1, ...] state + [1, N, 2] actions."""
        del context, timestep
        actions = np.asarray(actions)
        if actions.ndim == 2:
            actions = actions[None, ...]
        return {
            "state/image": np.expand_dims(state, 0),
            "action/pose": actions,
        }


class DefaultPoseEnvRegressionPreprocessor(SpecTransformationPreprocessor):
    """uint8 source image -> float32 [0, 1]."""

    def _transform_in_feature_specification(self, spec, mode):
        self.update_spec(spec, "state", dtype=np.uint8)
        return spec

    def _preprocess_fn(self, features, labels, mode, generator):
        features["state"] = features["state"].to(torch.float32) / 255.0
        return features, labels


class _PoseRegressionNet(nn.Module):
    def __init__(self, action_size: int):
        super().__init__()
        self.state_features = ImagesToFeaturesNet(normalizer="layer_norm")
        self.pose_net = ImageFeaturesToPoseNet(
            input_size=2 * 32, num_outputs=action_size)

    def forward(self, features, mode):
        feature_points, _ = self.state_features(features["state"], mode == MODE_TRAIN)
        estimated_pose, _ = self.pose_net(feature_points)
        return {"inference_output": estimated_pose, "state_features": feature_points}


class PoseEnvRegressionModel(RegressionModel):
    """Image -> pose regression, reward-weighted MSE; with a `mesh` the
    loss's sums span every data x fsdp shard's batch (module docstring)."""

    loss_spans_the_batch = True

    def __init__(self, action_size: int = 2, mesh=None, **kwargs):
        kwargs.setdefault("preprocessor_cls", DefaultPoseEnvRegressionPreprocessor)
        super().__init__(**kwargs)
        self._action_size = action_size
        self._mesh = mesh

    @property
    def action_size(self) -> int:
        return self._action_size

    def get_feature_specification(self, mode: str) -> TensorSpecStruct:
        del mode
        return TensorSpecStruct(state=_image_spec())

    def get_label_specification(self, mode: str) -> TensorSpecStruct:
        del mode
        return TensorSpecStruct(
            target_pose=ExtendedTensorSpec(
                shape=(self._action_size,), dtype=np.float32, name="target_pose"),
            reward=ExtendedTensorSpec(shape=(1,), dtype=np.float32, name="reward"),
        )

    def create_network(self) -> nn.Module:
        return _PoseRegressionNet(action_size=self._action_size)

    def init_network(self, generator=None, device: Union[str, torch.device] = DEFAULT_DEVICE):
        return _init_network(self, generator, device)

    def model_train_fn(self, features, labels, inference_outputs, mode):
        # Reward-weighted MSE. Weights are clamped to >= 0: the env's raw
        # rewards are negative distances, and a negative weight would flip
        # the objective into error maximization; zero-weight entries still
        # contribute no gradient.
        weights = torch.clamp_min(labels["reward"], 0.0)
        squared = torch.square(
            inference_outputs["inference_output"] - labels["target_pose"])
        sums = torch.stack([torch.sum(weights * squared),
                            torch.sum(weights) * squared.shape[-1]])
        if self._mesh is not None:
            # Each shard's rows then take N x their cotangent, and the
            # trainer's mean over the ranks divides the N back out.
            sums = collectives.psum_data_shards(sums, self._mesh)
        loss = sums[0] / torch.clamp_min(sums[1], 1e-6)
        return loss, {"loss/weighted_mse": loss}

    def pack_features(self, state, context, timestep):
        del context, timestep
        return {"state": np.expand_dims(state, 0)}
