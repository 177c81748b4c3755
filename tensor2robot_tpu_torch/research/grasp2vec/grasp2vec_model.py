"""Grasp2Vec model and preprocessor.

Port of tensor2robot_tpu/research/grasp2vec/grasp2vec_model.py. The
learning signal is embedding arithmetic, pre - post ~ goal, through a
bidirectional n-pairs (or triplet) loss over per-image ResNet embeddings;
the label spec is empty. The pre- and post-grasp scene images go through
the scene tower as one batch of 2B, so the train-mode batch-norm
statistics span both, as in the JAX package; the goal image has its own
tower. Modules are named as the flax modules are (scene.resnet...,
goal.resnet...).

The preprocessor crops the 512x640 uint8 sources (one offset shared by
the scene pair, another for the goal; random within the crop window in
train with a generator, its center otherwise), converts to float32 in
[0, 1] and, in train with a generator, flips left-right and up-down per
image: the scene pair shares its flip decisions, the goal draws its own.
With no generator there is no random crop and no flip.

The n-pairs and triplet losses take their negatives from the batch, so
over data x fsdp shards the model is built with the trainer's mesh and
gathers every shard's embeddings before the loss
(collectives.all_gather_data_shards): each rank computes the global
batch's loss, as JAX's step over the sharded batch does.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch.layers.vision_layers import init_flax_layers
from tensor2robot_tpu_torch.models.abstract_model import (
    MODE_TRAIN,
    TorchT2RModel,
    init_parameters,
)
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
    SpecTransformationPreprocessor,
)
from tensor2robot_tpu_torch.preprocessors.image_transformations import (
    crop_image_batch_at,
    uint8_to_float,
)
from tensor2robot_tpu_torch.research.grasp2vec import losses
from tensor2robot_tpu_torch.research.grasp2vec.networks import Embedding
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, TensorSpecStruct
from tensor2robot_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

# (min_offset_height, max_offset_height, target_height,
#  min_offset_width, max_offset_width, target_width)
CropParams = Tuple[int, int, int, int, int, int]
_DEFAULT_CROP: CropParams = (0, 40, 472, 0, 168, 472)
SOURCE_SHAPE = (512, 640, 3)

_IMAGE_KEYS = ("pregrasp_image", "postgrasp_image", "goal_image")


def maybe_crop_images(images: Sequence[torch.Tensor], params: CropParams, mode: str,
                      generator: Optional[torch.Generator]):
    """Crops each [B, H, W, C] image batch with one shared offset: drawn
    uniformly from [min, max) in train with a generator (height first),
    (min + max) // 2 otherwise. Returns (crops, offset_h, offset_w)."""
    min_oh, max_oh, target_h, min_ow, max_ow, target_w = params
    device = images[0].device
    if mode == MODE_TRAIN and generator is not None:
        offset_h = torch.randint(min_oh, max(max_oh, min_oh + 1), (),
                                 generator=generator, device=device)
        offset_w = torch.randint(min_ow, max(max_ow, min_ow + 1), (),
                                 generator=generator, device=device)
    else:
        offset_h = torch.tensor((min_oh + max_oh) // 2, device=device)
        offset_w = torch.tensor((min_ow + max_ow) // 2, device=device)
    batch = images[0].shape[0]
    ys, xs = offset_h.expand(batch), offset_w.expand(batch)
    crops = [crop_image_batch_at(image, ys, xs, (target_h, target_w)) for image in images]
    return crops, offset_h, offset_w


def draw_flips(generator: torch.Generator, batch: int, device) -> torch.Tensor:
    """[2, B] bool: per image, flip left-right (row 0) and up-down (row 1)."""
    return torch.rand((2, batch), generator=generator, device=device) < 0.5


def apply_flips(image: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """Flips each image of [B, H, W, C] as `flips` ([2, B]) says."""
    image = torch.where(flips[0][:, None, None, None], image.flip(2), image)
    return torch.where(flips[1][:, None, None, None], image.flip(1), image)


class Grasp2VecPreprocessor(SpecTransformationPreprocessor):
    """512x640 JPEG uint8 sources -> crop -> float [0, 1] -> flips."""

    def __init__(self, model_spec_provider=None, scene_crop: CropParams = _DEFAULT_CROP,
                 goal_crop: CropParams = _DEFAULT_CROP):
        super().__init__(model_spec_provider)
        self._scene_crop = tuple(scene_crop)
        self._goal_crop = tuple(goal_crop)

    def _transform_in_feature_specification(self, spec, mode):
        for name in _IMAGE_KEYS:
            self.update_spec(spec, name, shape=SOURCE_SHAPE, dtype=np.uint8,
                             data_format="jpeg")
        return spec

    def _preprocess_fn(self, features, labels, mode, generator):
        scene, _, _ = maybe_crop_images(
            [features["pregrasp_image"], features["postgrasp_image"]],
            self._scene_crop, mode, generator)
        goal = maybe_crop_images([features["goal_image"]], self._goal_crop, mode,
                                 generator)[0][0]
        images = dict(zip(_IMAGE_KEYS, (scene[0], scene[1], goal)))
        flips = {}
        if mode == MODE_TRAIN and generator is not None:
            batch, device = goal.shape[0], goal.device
            flips["pregrasp_image"] = flips["postgrasp_image"] = draw_flips(
                generator, batch, device)
            flips["goal_image"] = draw_flips(generator, batch, device)
        for name, image in images.items():
            image = uint8_to_float(image)
            if name in flips:
                image = apply_flips(image, flips[name])
            features[name] = image
        return features, labels


class _Grasp2VecNetwork(nn.Module):
    def __init__(self, resnet_size: int = 50):
        super().__init__()
        self.scene = Embedding(resnet_size)
        self.goal = Embedding(resnet_size)

    def forward(self, features, mode: str):
        train = mode == MODE_TRAIN
        scene_images = torch.cat(
            [features["pregrasp_image"], features["postgrasp_image"]], dim=0)
        v, s = self.scene(scene_images, train)
        pre_v, post_v = torch.chunk(v, 2, dim=0)
        pre_s, post_s = torch.chunk(s, 2, dim=0)
        goal_v, goal_s = self.goal(features["goal_image"], train)
        return {"pre_vector": pre_v, "post_vector": post_v, "pre_spatial": pre_s,
                "post_spatial": post_s, "goal_vector": goal_v, "goal_spatial": goal_s}


def _crop_for(size: Tuple[int, int]) -> CropParams:
    """The crop window of a `size` output over the whole 512x640 source
    slack (the reference default (0, 40, 472, 0, 168, 472) for 472x472)."""
    th, tw = int(size[0]), int(size[1])
    if th > SOURCE_SHAPE[0] or tw > SOURCE_SHAPE[1]:
        raise ValueError(f"Crop size {tuple(size)} exceeds the 512x640 source.")
    return (0, SOURCE_SHAPE[0] - th, th, 0, SOURCE_SHAPE[1] - tw, tw)


class Grasp2VecModel(TorchT2RModel):
    """Grasp2Vec T2R model: scene and goal ResNet embeddings trained by
    `embedding_loss_fn(pre, goal, post)`; with a `mesh` the loss spans
    every data x fsdp shard's batch."""

    loss_spans_the_batch = True

    def __init__(
        self,
        scene_size: Tuple[int, int] = (472, 472),
        goal_size: Tuple[int, int] = (472, 472),
        embedding_loss_fn: Callable = losses.npairs_embedding_loss,
        resnet_size: int = 50,
        preprocessor_cls=None,
        mesh=None,
        **kwargs,
    ):
        if preprocessor_cls is None:
            scene_crop, goal_crop = _crop_for(scene_size), _crop_for(goal_size)

            def preprocessor_cls(model):
                return Grasp2VecPreprocessor(model, scene_crop=scene_crop,
                                             goal_crop=goal_crop)

        super().__init__(preprocessor_cls=preprocessor_cls, **kwargs)
        self._scene_size = tuple(scene_size)
        self._goal_size = tuple(goal_size)
        self._embedding_loss_fn = embedding_loss_fn
        self._resnet_size = resnet_size
        self._mesh = mesh

    def get_feature_specification(self, mode):
        del mode
        spec = TensorSpecStruct()
        for key, size, name in (("pregrasp_image", self._scene_size, "image"),
                                ("postgrasp_image", self._scene_size, "postgrasp_image"),
                                ("goal_image", self._goal_size, "present_image")):
            spec[key] = ExtendedTensorSpec(shape=size + (3,), dtype=np.float32,
                                           name=name, data_format="jpeg")
        return spec

    def get_label_specification(self, mode):
        del mode
        return TensorSpecStruct()

    def create_network(self) -> nn.Module:
        return _Grasp2VecNetwork(resnet_size=self._resnet_size)

    def init_network(self, generator=None,
                     device: Union[str, torch.device] = DEFAULT_DEVICE) -> nn.Module:
        """flax's default inits, then the ResNet convs' own
        (variance_scaling(2, fan_out))."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        network = self.create_network()
        init_parameters(network, generator)
        init_flax_layers(network, generator)
        return network.to(device)

    def model_train_fn(self, features, labels, inference_outputs, mode):
        vectors = [inference_outputs[key] for key in ("pre_vector", "goal_vector",
                                                       "post_vector")]
        if self._mesh is not None:
            vectors = [collectives.all_gather_data_shards(v, self._mesh) for v in vectors]
        embed_loss = self._embedding_loss_fn(*vectors)
        if isinstance(embed_loss, tuple):  # triplet: (loss, pairs, labels)
            embed_loss = embed_loss[0]
        return embed_loss, {"embed_loss": embed_loss}
