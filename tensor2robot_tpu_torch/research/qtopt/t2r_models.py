"""QT-Opt T2R models: the Grasping44 critic family and its preprocessor.

Port of tensor2robot_tpu/research/qtopt/t2r_models.py. The wrapper adapts
the Grasping44 Q-tower to the CriticModel contract: split state/action
specs, `q_predicted` logits, log-loss against `grasp_success` rewards, CEM
action tiling in PREDICT, a momentum optimizer with staircase learning-rate
decay, and EMA parameters.

The infeed carries uint8 images: 512x640 sources, or (from a record
dataset that honors `get_decode_rois`) 472x472 crops cut at decode time.
The crop of a source, the conversion to float and the photometric
distortion run on the device inside the train step, from the step's
generator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch.data.roi import DecodeROI
from tensor2robot_tpu_torch.models.abstract_model import MODE_TRAIN
from tensor2robot_tpu_torch.models.base_models import CriticModel
from tensor2robot_tpu_torch.preprocessors import image_transformations
from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
    SpecTransformationPreprocessor,
)
from tensor2robot_tpu_torch.research.qtopt import optimizer_builder
from tensor2robot_tpu_torch.research.qtopt.networks import (
    E2E_GRASP_PARAM_BLOCKS,
    Grasping44,
    concat_e2e_grasp_params,
)
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, TensorSpecStruct
from tensor2robot_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

INPUT_SHAPE = (512, 640, 3)
TARGET_SHAPE = (472, 472)


@dataclasses.dataclass
class ImageDraws:
    """The random numbers of one train-mode preprocess of a batch: crop
    offsets (int64 [B] each; None for images cropped at decode time) and
    the photometric distortion's draws."""

    ys: Optional[torch.Tensor]
    xs: Optional[torch.Tensor]
    photometric: image_transformations.PhotometricDraws


class DefaultGrasping44ImagePreprocessor(SpecTransformationPreprocessor):
    """uint8 source -> crop (random in train with a generator, center
    otherwise) -> float [0, 1] -> photometric distortion (train with a
    generator only). The source is the model's image plus 40 rows and 168
    columns (512x640 for 472x472).

    The crop is also published as a decode-time ROI (`get_decode_rois`):
    a record dataset then decodes only the crop window, the image arrives
    at the target shape, and this preprocessor does not crop it again.
    Its random offsets then come from the dataset's seeded numpy
    generator, not from the step's; the distortion still draws from the
    step's generator."""

    def _target_shape(self) -> Tuple[int, int]:
        model_image = self._model.get_feature_specification(MODE_TRAIN)["state/image"]
        return tuple(model_image.shape[:2])

    def _source_shape(self) -> Tuple[int, int, int]:
        target = self._target_shape()
        return (target[0] + 40, target[1] + 168, 3)

    def _transform_in_feature_specification(self, spec, mode):
        self.update_spec(
            spec, "state/image", shape=self._source_shape(), dtype=np.uint8,
            data_format="jpeg",
        )
        return spec

    def get_decode_rois(self, mode):
        th, tw = self._target_shape()
        return {"state/image": DecodeROI(
            th, tw, mode="random" if mode == MODE_TRAIN else "center")}

    def _cropped(self, images_shape) -> bool:
        """Whether a batch arrives cropped at decode time."""
        return tuple(images_shape[1:3]) == self._target_shape()

    def draw(self, generator: torch.Generator, images_shape, device) -> ImageDraws:
        """A batch's draws from `generator`: the crop offsets (none for a
        batch cropped at decode time), then the distortion (a test
        replaces this with the JAX package's draws)."""
        ys = xs = None
        if not self._cropped(images_shape):
            ys, xs = image_transformations.draw_random_crop_offsets(
                generator, images_shape[0], images_shape[1:3],
                self._target_shape(), device,
            )
        target = (images_shape[0],) + self._target_shape() + (images_shape[3],)
        photometric = image_transformations.draw_photometric_distortions(
            generator, target, device
        )
        return ImageDraws(ys, xs, photometric)

    def _preprocess_fn(self, features, labels, mode, generator):
        image = features["state/image"]
        target = self._target_shape()
        cropped = self._cropped(tuple(image.shape))
        if mode == MODE_TRAIN and generator is not None:
            draws = self.draw(generator, tuple(image.shape), image.device)
            if not cropped:
                image = image_transformations.crop_image_batch_at(
                    image, draws.ys, draws.xs, target)
            image = image_transformations.uint8_to_float(image)
            image = image_transformations.apply_photometric_image_distortions(
                None, image, draws=draws.photometric)
        else:
            # No generator, no randomness: the deterministic center crop.
            if not cropped:
                image = image_transformations.center_crop_image_batch(image, target)
            image = image_transformations.uint8_to_float(image)
        features["state/image"] = image
        return features, labels


class _Grasping44Net(nn.Module):
    """The Grasping44 tower (as `grasping44`, the flax module name) under
    the T2R calling convention `forward(features, mode) -> outputs`."""

    def __init__(
        self,
        grasp_param_blocks: Optional[Dict[str, Tuple[int, int]]] = None,
        num_convs: Tuple[int, int, int] = (6, 6, 3),
        batch_norm_momentum: float = 0.9997,
        width: int = 64,
        image_size: Tuple[int, int] = TARGET_SHAPE,
    ):
        super().__init__()
        self.grasping44 = Grasping44(
            grasp_param_blocks=grasp_param_blocks, num_convs=num_convs,
            batch_norm_momentum=batch_norm_momentum, width=width,
            image_size=image_size,
        )

    def forward(self, features, mode):
        grasp_params = concat_e2e_grasp_params(features["action"])
        logits, end_points = self.grasping44(
            features["state/image"], grasp_params,
            is_training=mode == MODE_TRAIN,
        )
        # q_predicted carries the logits (loss-stable); q_probability the
        # sigmoid. CEM's argmax is the same over either.
        tiled = grasp_params.ndim == 3
        q_logits = (logits.reshape(end_points["predictions"].shape) if tiled
                    else logits.reshape(-1))
        return {"q_predicted": q_logits,
                "q_probability": end_points["predictions"]}


class GraspingModelWrapper(CriticModel):
    """CriticModel over the Grasping44 tower: momentum/rmsprop/adam with
    staircase exponential decay; EMA parameters when
    use_avg_model_params."""

    def __init__(
        self,
        learning_rate: float = 1e-4,
        model_weights_averaging: float = 0.9999,
        momentum: float = 0.9,
        export_batch_size: int = 1,
        use_avg_model_params: bool = True,
        learning_rate_decay_factor: float = 0.999,
        optimizer: str = "momentum",
        batch_size: int = 32,
        examples_per_epoch: int = 3_000_000,
        action_batch_size: Optional[int] = None,
        **kwargs,
    ):
        self.hparams = optimizer_builder.QtOptHParams(
            batch_size=batch_size,
            examples_per_epoch=examples_per_epoch,
            learning_rate=learning_rate,
            learning_rate_decay_factor=learning_rate_decay_factor,
            model_weights_averaging=model_weights_averaging,
            momentum=momentum,
            optimizer=optimizer,
            use_avg_model_params=use_avg_model_params,
        )
        self._export_batch_size = export_batch_size
        kwargs.setdefault("preprocessor_cls", DefaultGrasping44ImagePreprocessor)
        super().__init__(
            action_batch_size=action_batch_size,
            create_optimizer_fn=lambda: optimizer_builder.build_opt(self.hparams),
            use_avg_model_params=use_avg_model_params,
            avg_model_params_decay=model_weights_averaging,
            **kwargs,
        )

    def get_label_specification(self, mode: str) -> TensorSpecStruct:
        spec = TensorSpecStruct()
        spec["reward"] = ExtendedTensorSpec(
            shape=(1,), dtype=np.float32, name="grasp_success"
        )
        return spec

    def init_network(self, generator=None, device=DEFAULT_DEVICE) -> nn.Module:
        """The tower's own (flax) initial values, drawn from `generator`
        (seed 0 when None) on the host, then moved to `device`."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        network = self.create_network()
        network.grasping44.init_parameters(generator)
        return network.to(device)


class Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
    GraspingModelWrapper
):
    """The e2e open/close/terminate/gripper-status/height-to-bottom critic:
    a 472x472 image state and a 10-dim action in 7 named blocks.
    `image_size` shrinks the state for tests and dry runs."""

    def __init__(
        self,
        image_size: Tuple[int, int] = TARGET_SHAPE,
        num_convs: Tuple[int, int, int] = (6, 6, 3),
        batch_norm_momentum: float = 0.9997,
        width: int = 64,
        **kwargs,
    ):
        self._image_size = tuple(image_size)
        self._num_convs = tuple(num_convs)
        self._width = width
        self._batch_norm_momentum = batch_norm_momentum
        super().__init__(**kwargs)

    def get_state_specification(self) -> TensorSpecStruct:
        return TensorSpecStruct(
            image=ExtendedTensorSpec(
                shape=self._image_size + (3,), dtype=np.float32, name="image_1",
            )
        )

    def get_action_specification(self) -> TensorSpecStruct:
        def action_spec(name, size=1):
            return ExtendedTensorSpec(shape=(size,), dtype=np.float32, name=name)

        return TensorSpecStruct(
            world_vector=action_spec("world_vector", 3),
            vertical_rotation=action_spec("vertical_rotation", 2),
            close_gripper=action_spec("close_gripper"),
            open_gripper=action_spec("open_gripper"),
            terminate_episode=action_spec("terminate_episode"),
            gripper_closed=action_spec("gripper_closed"),
            height_to_bottom=action_spec("height_to_bottom"),
        )

    def create_network(self) -> nn.Module:
        return _Grasping44Net(
            grasp_param_blocks=E2E_GRASP_PARAM_BLOCKS,
            num_convs=self._num_convs,
            batch_norm_momentum=self._batch_norm_momentum,
            width=self._width,
            image_size=self._image_size,
        )
