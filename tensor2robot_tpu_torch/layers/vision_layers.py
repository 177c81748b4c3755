"""Vision towers: conv feature extractors and pose heads.

Port of tensor2robot_tpu/layers/vision_layers.py. Modules are named as
the flax modules are (conv2, norm_conv2, final_conv_1x1, norm_final,
pose_fc0, pose_ln0, bias_transform, ...), so utils/jax_params.py maps a
flax params tree onto them leaf by leaf. Tensors are NHWC at the module
boundaries as in the JAX package; each conv runs NCHW inside.

Conventions kept: VALID 3x3 convs, strides (2, 2, 1, 1, ...) over
num_blocks, 32 channels per block, optional FiLM (1 + gamma) * x + beta
before the ReLU, a final 1x1 conv to num_output_maps, optional spatial
softmax returning [x1..xN, y1..yN] feature points. flax's LayerNorm
normalizes the channel axis only, with epsilon 1e-6, and the blocks'
norms have no scale (research/dql_grasping_lib/tf_modules.FlaxLayerNorm).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers.batch_norm import BatchNorm
from tensor2robot_tpu_torch.layers.spatial_softmax import spatial_softmax
from tensor2robot_tpu_torch.ops import pooling
from tensor2robot_tpu_torch.research.dql_grasping_lib.tf_modules import (
    FlaxLayerNorm,
    conv2d_nhwc,
)


def apply_film(x: torch.Tensor, film_gamma_beta: Optional[torch.Tensor]) -> torch.Tensor:
    """FiLM modulation (1 + gamma) * x + beta of an NHWC map with
    [batch, 2C] params."""
    if film_gamma_beta is None:
        return x
    gamma, beta = torch.chunk(film_gamma_beta[:, None, None, :], 2, dim=-1)
    return (1.0 + gamma) * x + beta


def init_flax_layers(network: nn.Module, generator: torch.Generator) -> None:
    """Redraws, in module order, the parameters of every module with a
    `flax_init(generator)` hook (its flax initializers), after
    models/abstract_model.init_parameters gave every conv and dense layer
    flax's default init."""
    for module in network.modules():
        hook = getattr(module, "flax_init", None)
        if hook is not None:
            hook(generator)


def _xavier_uniform_(weight: torch.Tensor, generator) -> None:
    """flax xavier_uniform over a torch conv weight [O, I, kh, kw]."""
    receptive = weight[0, 0].numel()
    fan_in, fan_out = weight.shape[1] * receptive, weight.shape[0] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    nn.init.uniform_(weight, -limit, limit, generator=generator)


def _trunc_normal_(weight: torch.Tensor, stddev: float, generator) -> None:
    """flax truncated_normal(stddev): cut at two standard deviations of
    the untruncated normal, rescaled to `stddev`."""
    std = stddev / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


class FilmParams(nn.Module):
    """Linear FiLM generator (flax `FilmParams`, its Dense named film)."""

    def __init__(self, embedding_size: int, film_output_size: int = 2 * 5 * 32):
        super().__init__()
        self.film = nn.Linear(embedding_size, film_output_size)

    def forward(self, embedding: torch.Tensor) -> torch.Tensor:
        return self.film(embedding)


class ImagesToFeaturesNet(nn.Module):
    """Conv tower: NHWC images in [0, 1] -> feature points or maps.

    Returns (features, extra): with spatial softmax, features is
    [B, 2 * num_output_maps] and extra = {'softmax': maps}; without,
    features is the [B, h, w, num_output_maps] activation and extra = {}.
    """

    def __init__(
        self,
        in_channels: int = 3,
        filter_size: int = 3,
        num_blocks: int = 5,
        num_output_maps: int = 32,
        num_channels_per_block: int = 32,
        use_spatial_softmax: bool = True,
        normalizer: str = "layer_norm",  # 'layer_norm' | 'batch_norm' | 'none'
    ):
        super().__init__()
        if normalizer not in ("layer_norm", "batch_norm", "none"):
            raise ValueError(f"unknown normalizer {normalizer!r}")
        self.num_blocks = num_blocks
        self.num_channels_per_block = num_channels_per_block
        self.use_spatial_softmax = use_spatial_softmax
        self.normalizer = normalizer
        channels = in_channels
        for i in range(num_blocks):
            stride = 2 if i < 2 else 1
            self.add_module(f"conv{i + 2}", nn.Conv2d(
                channels, num_channels_per_block, filter_size, stride=stride))
            self._add_norm(f"norm_conv{i + 2}", num_channels_per_block, scale=False)
            channels = num_channels_per_block
        self.final_conv_1x1 = nn.Conv2d(channels, num_output_maps, 1)
        self._add_norm("norm_final", num_output_maps, scale=True)

    def _add_norm(self, name: str, features: int, scale: bool) -> None:
        if self.normalizer == "layer_norm":
            self.add_module(name, FlaxLayerNorm(features, use_scale=scale))
        elif self.normalizer == "batch_norm":
            self.add_module(name, BatchNorm(
                features, momentum=0.99, epsilon=1e-4, use_scale=scale, axis=-1))

    def flax_init(self, generator: torch.Generator) -> None:
        """xavier_uniform kernels and biases of 0.01 (the flax inits)."""
        with torch.no_grad():
            for module in self.children():
                if isinstance(module, nn.Conv2d):
                    _xavier_uniform_(module.weight, generator)
                    module.bias.fill_(0.01)

    def _normalize(self, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.normalizer == "layer_norm":
            return getattr(self, name)(x)
        if self.normalizer == "batch_norm":
            return getattr(self, name)(x, train)
        return x

    def forward(
        self,
        images: torch.Tensor,
        train: bool = False,
        film_output_params: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        film_gamma_betas = [None] * self.num_blocks
        if film_output_params is not None:
            expected = 2 * self.num_blocks * self.num_channels_per_block
            if film_output_params.ndim != 2 or film_output_params.shape[-1] != expected:
                raise ValueError(
                    f"FiLM params shape {tuple(film_output_params.shape)}, "
                    f"expected [batch, {expected}]"
                )
            film_gamma_betas = torch.chunk(film_output_params, self.num_blocks, dim=-1)
        net = images
        for i in range(self.num_blocks):
            net = conv2d_nhwc(getattr(self, f"conv{i + 2}"), net)
            net = self._normalize(f"norm_conv{i + 2}", net, train)
            net = apply_film(net, film_gamma_betas[i])
            net = F.relu(net)
        net = conv2d_nhwc(self.final_conv_1x1, net)
        net = F.relu(self._normalize("norm_final", net, train))
        if self.use_spatial_softmax:
            points, softmax = spatial_softmax(net)
            return points, {"softmax": softmax}
        return net, {}


class ImagesToFeaturesHighResNet(nn.Module):
    """Multi-resolution conv tower: block outputs at every scale are resized
    (nearest, half-pixel centers as jax.image.resize) to the highest
    resolution and summed before the spatial softmax (PI-GPS
    architecture, arXiv:1610.00529). Kernels take the default init."""

    def __init__(self, in_channels: int = 3, filter_size: int = 3,
                 num_blocks: int = 5, num_output_maps: int = 32):
        super().__init__()
        self.num_blocks = num_blocks
        self.conv1 = nn.Conv2d(in_channels, 16, filter_size, stride=2)
        self.norm1 = FlaxLayerNorm(16)
        self.conv2 = nn.Conv2d(16, 32, filter_size)
        self.norm2 = FlaxLayerNorm(32)
        self.conv2_1x1 = nn.Conv2d(32, 32, 1)
        for i in range(1, num_blocks):
            self.add_module(f"conv{i + 2}", nn.Conv2d(32, 32, filter_size))
            self.add_module(f"norm{i + 2}", FlaxLayerNorm(32))
            self.add_module(f"conv{i + 2}_1x1", nn.Conv2d(32, 32, 1))
        self.final_conv_1x1 = nn.Conv2d(32, num_output_maps, 1)

    def forward(self, images: torch.Tensor, train: bool = False):
        del train
        net = images.permute(0, 3, 1, 2)
        net = F.avg_pool2d(net, 2, 2).permute(0, 2, 3, 1)
        net = F.relu(self.norm1(conv2d_nhwc(self.conv1, net)))
        net = F.relu(self.norm2(conv2d_nhwc(self.conv2, net)))
        block_outs = [conv2d_nhwc(self.conv2_1x1, net)]
        for i in range(1, self.num_blocks):
            pooled = pooling.max_pool(net.permute(0, 3, 1, 2), (2, 2), "VALID")
            net = conv2d_nhwc(getattr(self, f"conv{i + 2}"), pooled.permute(0, 2, 3, 1))
            net = F.relu(getattr(self, f"norm{i + 2}")(net))
            block_outs.append(conv2d_nhwc(getattr(self, f"conv{i + 2}_1x1"), net))
        target_hw = tuple(block_outs[0].shape[1:3])
        net = sum(
            F.interpolate(b.permute(0, 3, 1, 2), size=target_hw,
                          mode="nearest-exact").permute(0, 2, 3, 1)
            for b in block_outs
        )
        net = conv2d_nhwc(self.final_conv_1x1, net)
        points, softmax = spatial_softmax(net)
        return points, {"softmax": softmax}


class ImageFeaturesToPoseNet(nn.Module):
    """FC head mapping feature points (+aux input) to a pose vector, with
    the MAML-friendly learned bias transform."""

    def __init__(
        self,
        input_size: int,
        num_outputs: Optional[int],
        aux_input_size: int = 0,
        aux_output_dim: int = 0,
        hidden_dim: int = 100,
        num_layers: int = 2,
        bias_transform_size: int = 10,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.num_outputs = num_outputs
        self.bias_transform_size = bias_transform_size
        self.aux_output_dim = aux_output_dim
        width = input_size + aux_input_size
        if bias_transform_size > 0:
            self.bias_transform = nn.Parameter(torch.full((bias_transform_size,), 0.01))
            width += bias_transform_size
        for layer_index in range(num_layers):
            self.add_module(f"pose_fc{layer_index}", nn.Linear(width, hidden_dim))
            self.add_module(f"pose_ln{layer_index}", FlaxLayerNorm(hidden_dim))
            width = hidden_dim
        if num_outputs:
            self.add_module(f"pose_fc{num_layers}", nn.Linear(width, num_outputs))
        if aux_output_dim > 0:
            self.pose_fc_aux = nn.Linear(input_size, aux_output_dim)

    def flax_init(self, generator: torch.Generator) -> None:
        """truncated_normal(0.01) kernels, biases and bias transform 0.01."""
        with torch.no_grad():
            for module in self.children():
                if isinstance(module, nn.Linear):
                    _trunc_normal_(module.weight, 0.01, generator)
                    module.bias.fill_(0.01)
            if self.bias_transform_size > 0:
                self.bias_transform.fill_(0.01)

    def forward(
        self,
        expected_feature_points: torch.Tensor,
        aux_input: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        net = expected_feature_points
        if aux_input is not None:
            net = torch.cat([net, aux_input], dim=1)
        if self.bias_transform_size > 0:
            tiled = self.bias_transform.to(net.dtype).expand(
                net.shape[0], self.bias_transform_size)
            net = torch.cat([net, tiled], dim=1)
        for layer_index in range(self.num_layers):
            net = getattr(self, f"pose_fc{layer_index}")(net)
            net = F.relu(getattr(self, f"pose_ln{layer_index}")(net))
        if self.num_outputs:
            net = getattr(self, f"pose_fc{self.num_layers}")(net)
        aux_output = None
        if self.aux_output_dim > 0:
            aux_output = self.pose_fc_aux(expected_feature_points)
        return net, aux_output
