"""VRGripper behavioral-cloning models (Watch-Try-Learn lineage).

Port of tensor2robot_tpu/research/vrgripper/vrgripper_env_models.py:
`DefaultVRGripperPreprocessor`, `VRGripperRegressionModel` and
`VRGripperDomainAdaptiveModel`. Batches are episodes, [B, T, ...]; the
image tower runs over the merged [B * T] batch. Modules are named as the
flax modules are (state_features, pose_net, mdn, learned_loss_pose,
ll_conv{i}, ...), so utils/jax_params.py carries a JAX variables tree
over.

The domain-adaptive model's inner-loop forward withholds the gripper
pose; which forward runs is an argument of the network's call
(`is_inner_loop`), never an attribute of the model, so the same module
serves both under torch.func's vmap and grad. Mixup draws its Beta(a, a)
weight from two gamma draws of the preprocessing generator
(`sample_gamma`: torch has no gamma sampler over an explicit generator).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import mdn as mdn_lib
from tensor2robot_tpu_torch.layers.vision_layers import (
    ImageFeaturesToPoseNet,
    ImagesToFeaturesNet,
    init_flax_layers,
)
from tensor2robot_tpu_torch.meta_learning import meta_tfdata
from tensor2robot_tpu_torch.models.abstract_model import (
    MODE_PREDICT,
    MODE_TRAIN,
    TorchT2RModel,
    generator_kwargs,
    init_parameters,
)
from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
    AbstractPreprocessor,
)
from tensor2robot_tpu_torch.preprocessors.image_transformations import (
    center_crop_image_batch,
    random_crop_image_batch,
    resize_image_batch,
    uint8_to_float,
)
from tensor2robot_tpu_torch.research.dql_grasping_lib.tf_modules import FlaxLayerNorm
from tensor2robot_tpu_torch.specs import (
    ExtendedTensorSpec,
    TensorSpecStruct,
    copy_tensorspec,
    flatten_spec_structure,
)
from tensor2robot_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

#: The conv tower's feature points (2 x 32 maps) and the gripper pose.
FEATURE_POINTS = 64
GRIPPER_POSE = 14


def sample_gamma(generator: Optional[torch.Generator], alpha: float, device=None) -> float:
    """One Gamma(alpha, 1) draw from `generator` (Marsaglia and Tsang's
    squeeze method; alpha < 1 through Gamma(alpha + 1) * U^(1 / alpha))."""

    def uniform() -> float:
        return float(torch.rand((), generator=generator, device=device))

    boost = 1.0
    if alpha < 1.0:
        boost = uniform() ** (1.0 / alpha)
        alpha += 1.0
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        x = float(torch.randn((), generator=generator, device=device))
        v = (1.0 + c * x) ** 3
        if v <= 0.0:
            continue
        u = uniform()
        if u > 0.0 and math.log(u) < 0.5 * x * x + d - d * v + d * math.log(v):
            return boost * d * v


def apply_mixup(structure: TensorSpecStruct, lmbda: float) -> None:
    """Blends every floating tensor of `structure` in place with its batch
    reversed: lmbda * x + (1 - lmbda) * flip(x)."""
    for key, x in structure.items():
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            structure[key] = lmbda * x + (1 - lmbda) * torch.flip(x, dims=(0,))


class DefaultVRGripperPreprocessor(AbstractPreprocessor):
    """uint8 episode images at `src_img_res` -> a `crop_size` crop (random
    per image in train with a generator, centered otherwise) -> float
    [0, 1] -> resized (jax.image.resize's antialiased bilinear) to the
    model's image shape; with mixup_alpha > 0, train features and labels
    are Mixup-blended along the batch."""

    def __init__(self, model_spec_provider, src_img_res: Tuple[int, int] = (220, 300),
                 crop_size: Tuple[int, int] = (200, 280), mixup_alpha: float = 0.0):
        super().__init__(model_spec_provider)
        self._src_img_res = tuple(src_img_res)
        self._crop_size = tuple(crop_size)
        self._mixup_alpha = mixup_alpha

    def get_in_feature_specification(self, mode) -> TensorSpecStruct:
        feature_spec = self._model.get_feature_specification(mode).copy()
        if mode != MODE_PREDICT and "original_image" in feature_spec.keys():
            del feature_spec["original_image"]
        if "image" in feature_spec.keys():
            true_shape = list(feature_spec["image"].shape)
            true_shape[-3:-1] = self._src_img_res
            feature_spec["image"] = ExtendedTensorSpec.from_spec(
                feature_spec["image"], shape=tuple(true_shape), dtype=np.uint8)
        return flatten_spec_structure(feature_spec)

    def get_in_label_specification(self, mode) -> TensorSpecStruct:
        return flatten_spec_structure(self._model.get_label_specification(mode))

    def get_out_feature_specification(self, mode) -> TensorSpecStruct:
        return flatten_spec_structure(self._model.get_feature_specification(mode))

    def get_out_label_specification(self, mode) -> TensorSpecStruct:
        return flatten_spec_structure(self._model.get_label_specification(mode))

    def _preprocess_fn(self, features, labels, mode, generator):
        if "image" in features.keys():
            image = features["image"]
            leading = tuple(image.shape[:-3])
            flat = image.reshape((-1,) + tuple(image.shape[-3:]))
            if mode == MODE_TRAIN and generator is not None:
                flat = random_crop_image_batch(generator, flat, self._crop_size)
            else:
                flat = center_crop_image_batch(flat, self._crop_size)
            flat = uint8_to_float(flat)
            target_hw = tuple(self.get_out_feature_specification(mode)["image"].shape[-3:-1])
            if target_hw != self._crop_size:
                flat = resize_image_batch(flat, target_hw)
            features["original_image"] = features["image"]
            features["image"] = flat.reshape(leading + tuple(flat.shape[1:]))
        if (self._mixup_alpha > 0.0 and labels is not None and mode == MODE_TRAIN
                and generator is not None):
            g1 = sample_gamma(generator, self._mixup_alpha, features["image"].device)
            g2 = sample_gamma(generator, self._mixup_alpha, features["image"].device)
            lmbda = g1 / (g1 + g2)
            apply_mixup(features, lmbda)
            apply_mixup(labels, lmbda)
        return features, labels


def init_vrgripper_network(model, generator, device) -> nn.Module:
    """flax's default inits, then the vision layers' and MADE's own."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    network = model.create_network()
    init_parameters(network, generator)
    init_flax_layers(network, generator)
    return network.to(device)


def _optional(value: Optional[np.ndarray], like: torch.Tensor):
    return None if value is None else torch.as_tensor(value, dtype=like.dtype,
                                                      device=like.device)


class _VRGripperRegressionNet(nn.Module):
    """State -> action over [B, T] batches: the conv tower's feature
    points (and the gripper pose) into a pose head or an MDN."""

    def __init__(self, action_size: int, use_gripper_input: bool,
                 num_mixture_components: int, condition_mixture_stddev: bool,
                 output_mixture_sample: bool, normalize_outputs: bool,
                 output_mean: Optional[np.ndarray], output_stddev: Optional[np.ndarray]):
        super().__init__()
        self.action_size = action_size
        self.use_gripper_input = use_gripper_input
        self.num_mixture_components = num_mixture_components
        self.output_mixture_sample = output_mixture_sample
        self.normalize_outputs = normalize_outputs
        self.output_mean, self.output_stddev = output_mean, output_stddev
        self.state_features = ImagesToFeaturesNet(normalizer="layer_norm")
        width = FEATURE_POINTS + (GRIPPER_POSE if use_gripper_input else 0)
        if num_mixture_components > 1:
            self.mdn = mdn_lib.MDNParams(width, num_mixture_components, action_size,
                                         condition_mixture_stddev)
        else:
            self.pose_net = ImageFeaturesToPoseNet(input_size=width,
                                                   num_outputs=action_size)

    def forward(self, features, mode, labels=None, generator=None):
        train = mode == MODE_TRAIN

        def single_batch(image, gripper_pose, action_label):
            feature_points, end_points = self.state_features(image, train)
            fc_input = feature_points
            if self.use_gripper_input:
                fc_input = torch.cat([feature_points, gripper_pose], dim=-1)
            outputs = {}
            if self.num_mixture_components > 1:
                dist_params = self.mdn(fc_input)
                output_mean = (_optional(self.output_mean, dist_params)
                               if self.normalize_outputs else None)
                gm = mdn_lib.get_mixture_distribution(
                    dist_params, self.num_mixture_components, self.action_size,
                    output_mean)
                if self.output_mixture_sample and generator is not None:
                    action = gm.sample(generator)
                else:
                    action = gm.approximate_mode()
                outputs["dist_params"] = dist_params
                if action_label is not None:
                    outputs["nll"] = mdn_lib.mdn_loss(gm, action_label)
            else:
                action, _ = self.pose_net(fc_input)
                if self.output_mean is not None:
                    action = (_optional(self.output_mean, action)
                              + _optional(self.output_stddev, action) * action)
            outputs.update({"inference_output": action, "feature_points": feature_points,
                            "softmax": end_points.get("softmax")})
            return outputs

        action_label = labels["action"] if labels is not None else None
        outputs = meta_tfdata.multi_batch_apply(
            single_batch, 2, features["image"], features["gripper_pose"], action_label)
        return {key: value for key, value in outputs.items() if value is not None}


class VRGripperRegressionModel(TorchT2RModel):
    """Continuous-action BC regression for the VRGripper env."""

    def __init__(
        self,
        action_size: int = 7,
        use_gripper_input: bool = True,
        normalize_outputs: bool = False,
        output_mean: Optional[Sequence[float]] = None,
        output_stddev: Optional[Sequence[float]] = None,
        outer_loss_multiplier: float = 1.0,
        num_mixture_components: int = 1,
        output_mixture_sample: bool = False,
        condition_mixture_stddev: bool = False,
        episode_length: int = 40,
        image_size: Tuple[int, int] = (100, 100),
        **kwargs,
    ):
        kwargs.setdefault("preprocessor_cls", DefaultVRGripperPreprocessor)
        super().__init__(**kwargs)
        self._action_size = action_size
        self._use_gripper_input = use_gripper_input
        self._normalize_outputs = normalize_outputs
        self._outer_loss_multiplier = outer_loss_multiplier
        self._num_mixture_components = num_mixture_components
        self._output_mixture_sample = output_mixture_sample
        self._condition_mixture_stddev = condition_mixture_stddev
        self._episode_length = episode_length
        self._image_size = tuple(image_size)
        self._output_mean = None
        self._output_stddev = None
        if output_mean and output_stddev:
            if not len(output_mean) == len(output_stddev) == action_size:
                raise ValueError(f"Output mean and stddev have lengths {len(output_mean)} "
                                 f"and {len(output_stddev)}.")
            self._output_mean = np.array([output_mean], np.float32)
            self._output_stddev = np.array([output_stddev], np.float32)

    @property
    def action_size(self) -> int:
        return self._action_size

    @property
    def episode_length(self) -> int:
        return self._episode_length

    def get_feature_specification(self, mode: str) -> TensorSpecStruct:
        del mode
        spec = TensorSpecStruct(
            image=ExtendedTensorSpec(shape=self._image_size + (3,), dtype=np.float32,
                                     name="image0", data_format="jpeg"),
            gripper_pose=ExtendedTensorSpec(shape=(GRIPPER_POSE,), dtype=np.float32,
                                            name="world_pose_gripper"))
        return copy_tensorspec(spec, batch_size=self._episode_length)

    def get_label_specification(self, mode: str) -> TensorSpecStruct:
        del mode
        spec = TensorSpecStruct(action=ExtendedTensorSpec(
            shape=(self._action_size,), dtype=np.float32, name="action_world"))
        return copy_tensorspec(spec, batch_size=self._episode_length)

    def create_network(self) -> nn.Module:
        return _VRGripperRegressionNet(
            action_size=self._action_size, use_gripper_input=self._use_gripper_input,
            num_mixture_components=self._num_mixture_components,
            condition_mixture_stddev=self._condition_mixture_stddev,
            output_mixture_sample=self._output_mixture_sample,
            normalize_outputs=self._normalize_outputs, output_mean=self._output_mean,
            output_stddev=self._output_stddev)

    def init_network(self, generator=None,
                     device: Union[str, torch.device] = DEFAULT_DEVICE) -> nn.Module:
        return init_vrgripper_network(self, generator, device)

    def inference_network_fn(self, network, features, mode, labels=None, generator=None):
        return dict(network(features, mode, labels=labels,
                            **generator_kwargs(network, generator))), {}

    def model_train_fn(self, features, labels, inference_outputs, mode):
        if self._num_mixture_components > 1:
            loss = inference_outputs["nll"]
            return loss, {"loss/mdn_nll": loss}
        loss = self._outer_loss_multiplier * torch.mean(torch.square(
            inference_outputs["inference_output"] - labels["action"]))
        return loss, {"loss/mse": loss}


class _DomainAdaptiveNet(nn.Module):
    """Video-only inner loop with a learned loss: in the inner loop the
    gripper pose is withheld (zeros, or predicted from the feature
    points); a conv1d critic over [predicted action, feature points,
    action] gives the learned loss."""

    def __init__(self, action_size: int, predict_con_gripper_pose: bool,
                 output_mean: Optional[np.ndarray], output_stddev: Optional[np.ndarray],
                 learned_loss_conv1d_layers: Optional[Tuple[int, ...]] = (10, 10, 6)):
        super().__init__()
        self.predict_con_gripper_pose = predict_con_gripper_pose
        self.output_mean, self.output_stddev = output_mean, output_stddev
        self.learned_loss_conv1d_layers = learned_loss_conv1d_layers
        self.state_features = ImagesToFeaturesNet(normalizer="layer_norm")
        if predict_con_gripper_pose:
            self.pose_pred_fc = nn.Linear(FEATURE_POINTS, 40, bias=False)
            self.pose_pred_ln = FlaxLayerNorm(40)
            self.pose_pred_out = nn.Linear(40, GRIPPER_POSE)
        self.pose_net = ImageFeaturesToPoseNet(input_size=FEATURE_POINTS,
                                               num_outputs=action_size,
                                               aux_input_size=GRIPPER_POSE)
        self.learned_loss_pose = ImageFeaturesToPoseNet(input_size=FEATURE_POINTS,
                                                        num_outputs=action_size)
        if learned_loss_conv1d_layers is not None:
            width = 2 * action_size + FEATURE_POINTS
            for i, filters in enumerate(learned_loss_conv1d_layers[:-1]):
                self.add_module(f"ll_conv{i}", nn.Conv1d(width, filters, 10, bias=False))
                self.add_module(f"ll_ln{i}", FlaxLayerNorm(filters))
                width = filters
            self.ll_conv_out = nn.Conv1d(width, learned_loss_conv1d_layers[-1], 1)

    def forward(self, features, mode, labels=None, is_inner_loop: bool = False):
        del labels
        train = mode == MODE_TRAIN

        def single_batch(image, gripper_pose):
            feature_points, end_points = self.state_features(image, train)
            pose = gripper_pose
            if is_inner_loop:
                if self.predict_con_gripper_pose:
                    out = F.relu(self.pose_pred_ln(self.pose_pred_fc(feature_points)))
                    pose = self.pose_pred_out(out)
                else:
                    pose = torch.zeros_like(gripper_pose)
            action, _ = self.pose_net(feature_points, aux_input=pose)
            if self.output_mean is not None:
                action = (_optional(self.output_mean, action)
                          + _optional(self.output_stddev, action) * action)
            return {"inference_output": action, "feature_points": feature_points,
                    "softmax": end_points.get("softmax")}

        outputs = meta_tfdata.multi_batch_apply(
            single_batch, 2, features["image"], features["gripper_pose"])
        feature_points = outputs["feature_points"]
        predicted_action, _ = meta_tfdata.multi_batch_apply(
            self.learned_loss_pose, 2, feature_points)
        if self.learned_loss_conv1d_layers is None:
            learned_loss = torch.mean(torch.square(
                predicted_action - outputs["inference_output"]))
        else:
            net = torch.cat([predicted_action, feature_points, outputs["inference_output"]],
                            dim=-1).transpose(1, 2)
            for i in range(len(self.learned_loss_conv1d_layers) - 1):
                # flax's "SAME" for a kernel of 10: 4 before, 5 after.
                net = getattr(self, f"ll_conv{i}")(F.pad(net, (4, 5)))
                net = F.relu(getattr(self, f"ll_ln{i}")(net.transpose(1, 2))).transpose(1, 2)
            net = self.ll_conv_out(net)
            learned_loss = torch.mean(torch.sum(torch.square(net), dim=(1, 2)))
        outputs["learned_loss"] = learned_loss
        return {key: value for key, value in outputs.items() if value is not None}


class VRGripperDomainAdaptiveModel(VRGripperRegressionModel):
    """Domain-adaptive imitation with a learned inner loss: the base model
    of a MAMLModel whose inner loop minimizes the learned loss (adapting
    from video alone) and whose outer loop behavior-clones."""

    def __init__(self, predict_con_gripper_pose: bool = False,
                 learned_loss_conv1d_layers: Tuple[int, ...] = (10, 10, 6), **kwargs):
        super().__init__(**kwargs)
        self._predict_con_gripper_pose = predict_con_gripper_pose
        self._learned_loss_conv1d_layers = learned_loss_conv1d_layers

    def create_network(self) -> nn.Module:
        return _DomainAdaptiveNet(
            action_size=self._action_size,
            predict_con_gripper_pose=self._predict_con_gripper_pose,
            output_mean=self._output_mean, output_stddev=self._output_stddev,
            learned_loss_conv1d_layers=self._learned_loss_conv1d_layers)

    def inner_inference_network_fn(self, network, features, mode, labels=None):
        """The inner-loop forward: the gripper pose withheld."""
        return dict(network(features, mode, labels, is_inner_loop=True)), {}

    def model_inner_loop_fn(self, features, labels, inference_outputs, mode):
        """The inner loop's adaptation signal: the learned loss."""
        loss = inference_outputs["learned_loss"]
        return loss, {"loss/learned": loss}

    def model_train_fn(self, features, labels, inference_outputs, mode):
        """The outer loop: behavior cloning."""
        loss = self._outer_loss_multiplier * torch.mean(torch.square(
            inference_outputs["inference_output"] - labels["action"]))
        return loss, {"loss/bc_mse": loss}
