"""FiLM-capable ResNet (v1/v2, sizes 18-200).

Port of tensor2robot_tpu/layers/resnet.py. Modules are named as the flax
modules are (initial_conv.Conv_0, block_layer1_block0.preact_bn.bn,
block_layer1_block0.conv1.Conv_0, postact_bn.bn, final_dense,
film_generator.film0, ...), so utils/jax_params.py maps a flax variables
tree onto them leaf by leaf. Images are NHWC at the boundary, as in the
JAX package, and every endpoint is returned NHWC; inside, the tower runs
NCHW.

Kept from the JAX package: fixed padding on strided convs ((k - 1) // 2
before and the rest after, then VALID; every kernel here is odd, so that
is symmetric and equals a stride-1 "SAME"), v2 pre-activation by
default, batch norm with momentum 0.997 and epsilon 1e-5, FiLM as
(1 + gamma) * x + beta at the filters-wide second norm of each block,
block strides [1, 2, 2, 2] and widths num_filters * 2^i. The stem's max
pool pads as flax's "SAME" pool does: with -inf, (total // 2) before and
the rest after, which on an even input is (0, 1), not torch's (1, 1).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers.batch_norm import BatchNorm

_BLOCK_SIZES = {
    18: [2, 2, 2, 2],
    34: [3, 4, 6, 3],
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
    200: [3, 24, 36, 3],
}


def get_block_sizes(resnet_size: int) -> List[int]:
    if resnet_size not in _BLOCK_SIZES:
        raise ValueError(
            f"resnet_size {resnet_size} not in {sorted(_BLOCK_SIZES)}")
    return _BLOCK_SIZES[resnet_size]


def max_pool_same(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """flax.linen.max_pool(padding="SAME") over an NCHW map: each spatial
    dim padded with -inf by (total // 2, total - total // 2), where total
    = max((ceil(n / stride) - 1) * stride + size - n, 0), then a VALID
    pool."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad takes the last dim first
        total = max((-(-n // stride) - 1) * stride + size - n, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, size, stride)


def apply_film_nchw(x: torch.Tensor, film_gamma_beta: Optional[torch.Tensor]):
    """(1 + gamma) * x + beta of an NCHW map with [batch, 2C] params."""
    if film_gamma_beta is None:
        return x
    gamma, beta = torch.chunk(film_gamma_beta[:, :, None, None], 2, dim=1)
    return (1.0 + gamma) * x + beta


class _ConvFixedPadding(nn.Module):
    """flax `_ConvFixedPadding`: its Conv is `Conv_0`, no bias, kernels
    variance_scaling(2, fan_out, truncated normal)."""

    def __init__(self, in_channels: int, filters: int, kernel_size: int,
                 strides: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, filters, kernel_size, stride=strides,
                                padding=(kernel_size - 1) // 2, bias=False)

    def flax_init(self, generator: torch.Generator) -> None:
        weight = self.Conv_0.weight
        fan_out = weight.shape[0] * weight[0, 0].numel()
        std = math.sqrt(2.0 / fan_out) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(x)


class _BatchNorm(nn.Module):
    """flax `_BatchNorm`: its BatchNorm is `bn`."""

    def __init__(self, features: int):
        super().__init__()
        self.bn = BatchNorm(features, momentum=0.997, epsilon=1e-5, axis=1)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return self.bn(x, train)


class _Block(nn.Module):
    """One residual block; v1/v2 and plain/bottleneck variants."""

    def __init__(self, in_channels: int, filters: int, strides: int,
                 bottleneck: bool, version: int, use_projection: bool):
        super().__init__()
        self.bottleneck = bottleneck
        self.version = version
        self.use_projection = use_projection
        out_filters = filters * (4 if bottleneck else 1)
        if version == 2:
            self.preact_bn = _BatchNorm(in_channels)
        if use_projection:
            self.proj = _ConvFixedPadding(in_channels, out_filters, 1, strides)
            if version == 1:
                self.proj_bn = _BatchNorm(out_filters)
        if bottleneck:
            self.conv1 = _ConvFixedPadding(in_channels, filters, 1, 1)
            self.bn1 = _BatchNorm(filters)
            self.conv2 = _ConvFixedPadding(filters, filters, 3, strides)
            self.bn2 = _BatchNorm(filters)
            self.conv3 = _ConvFixedPadding(filters, out_filters, 1, 1)
            if version == 1:
                self.bn3 = _BatchNorm(out_filters)
        else:
            self.conv1 = _ConvFixedPadding(in_channels, filters, 3, strides)
            self.bn1 = _BatchNorm(filters)
            self.conv2 = _ConvFixedPadding(filters, filters, 3, 1)
            self.bn2 = _BatchNorm(filters)

    def forward(self, x, train: bool, film_gamma_beta=None):
        shortcut = x
        if self.version == 2:
            x = F.relu(self.preact_bn(x, train))
            if self.use_projection:
                shortcut = self.proj(x)
        elif self.use_projection:
            shortcut = self.proj_bn(self.proj(x), train)

        if self.bottleneck:
            x = F.relu(self.bn1(self.conv1(x), train))
            x = self.bn2(self.conv2(x), train)
            x = F.relu(apply_film_nchw(x, film_gamma_beta))
            x = self.conv3(x)
            if self.version == 1:
                return F.relu(self.bn3(x, train) + shortcut)
            return x + shortcut

        x = F.relu(self.bn1(self.conv1(x), train))
        x = apply_film_nchw(self.bn2(self.conv2(x), train), film_gamma_beta)
        if self.version == 1:
            return F.relu(x + shortcut)
        return F.relu(x) + shortcut


class LinearFilmGenerator(nn.Module):
    """Per-block-layer linear FiLM projections (`film{i}`). Returns
    film_gamma_betas[i][j]: [batch, 2C_i], or None where a block layer is
    disabled."""

    def __init__(self, embedding_size: int, block_sizes: Sequence[int],
                 filter_sizes: Sequence[int],
                 enabled_block_layers: Optional[Sequence[bool]] = None):
        super().__init__()
        if enabled_block_layers and len(enabled_block_layers) != len(block_sizes):
            raise ValueError(
                f"Got {len(enabled_block_layers)} bools for enabled_block_layers, "
                f"expected {len(block_sizes)}")
        self.block_sizes = list(block_sizes)
        self.enabled = [not enabled_block_layers or bool(enabled_block_layers[i])
                        for i in range(len(block_sizes))]
        for i, num_blocks in enumerate(block_sizes):
            if self.enabled[i]:
                self.add_module(f"film{i}", nn.Linear(
                    embedding_size, num_blocks * filter_sizes[i] * 2))

    def forward(self, embedding: torch.Tensor) -> List[List[Optional[torch.Tensor]]]:
        film_gamma_betas: List[List[Optional[torch.Tensor]]] = []
        for i, num_blocks in enumerate(self.block_sizes):
            if not self.enabled[i]:
                film_gamma_betas.append([None] * num_blocks)
                continue
            out = getattr(self, f"film{i}")(embedding)
            film_gamma_betas.append(list(torch.chunk(out, num_blocks, dim=-1)))
        return film_gamma_betas


class ResNet(nn.Module):
    """ResNet with optional FiLM conditioning and intermediate endpoints.

    `logits = model(images, train)` or `logits, endpoints = model(images,
    train, return_intermediate_values=True)`; endpoints (NHWC) are
    'initial_conv', 'initial_max_pool', 'block_layer{1..4}',
    'pre_final_pool', 'final_reduce_mean' and 'final_dense'. Images are
    RGB. FiLM needs `film_embedding_size`, the width of the embedding the
    forward takes.
    """

    def __init__(
        self,
        num_classes: int,
        resnet_size: int = 50,
        num_filters: int = 64,
        kernel_size: int = 7,
        conv_stride: int = 2,
        first_pool_size: int = 3,
        first_pool_stride: int = 2,
        version: int = 2,
        film_enabled_block_layers: Optional[Sequence[bool]] = None,
        film_embedding_size: Optional[int] = None,
    ):
        super().__init__()
        self.version = version
        self.first_pool_size = first_pool_size
        self.first_pool_stride = first_pool_stride
        self.block_sizes = get_block_sizes(resnet_size)
        bottleneck = resnet_size >= 50
        filter_sizes = [num_filters * (2 ** i) for i in range(len(self.block_sizes))]
        if film_embedding_size is not None:
            self.film_generator = LinearFilmGenerator(
                film_embedding_size, self.block_sizes, filter_sizes,
                film_enabled_block_layers)
        self.initial_conv = _ConvFixedPadding(3, num_filters, kernel_size, conv_stride)
        if version == 1:
            self.initial_bn = _BatchNorm(num_filters)
        channels = num_filters
        for i, num_blocks in enumerate(self.block_sizes):
            for j in range(num_blocks):
                self.add_module(f"block_layer{i + 1}_block{j}", _Block(
                    channels, filter_sizes[i], (1, 2, 2, 2)[i] if j == 0 else 1,
                    bottleneck, version, use_projection=(j == 0)))
                channels = filter_sizes[i] * (4 if bottleneck else 1)
        if version == 2:
            self.postact_bn = _BatchNorm(channels)
        self.final_dense = nn.Linear(channels, num_classes)

    def forward(self, images: torch.Tensor, train: bool = False,
                film_embedding: Optional[torch.Tensor] = None,
                return_intermediate_values: bool = False):
        if film_embedding is not None:
            film_gamma_betas = self.film_generator(film_embedding)
        else:
            film_gamma_betas = [[None] * n for n in self.block_sizes]

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        endpoints: Dict[str, torch.Tensor] = {}
        x = self.initial_conv(images.permute(0, 3, 1, 2))
        endpoints["initial_conv"] = nhwc(x)
        if self.version == 1:
            x = F.relu(self.initial_bn(x, train))
        if self.first_pool_size:
            x = max_pool_same(x, self.first_pool_size, self.first_pool_stride)
        endpoints["initial_max_pool"] = nhwc(x)
        for i, num_blocks in enumerate(self.block_sizes):
            for j in range(num_blocks):
                x = getattr(self, f"block_layer{i + 1}_block{j}")(
                    x, train, film_gamma_betas[i][j])
            endpoints[f"block_layer{i + 1}"] = nhwc(x)
        if self.version == 2:
            x = F.relu(self.postact_bn(x, train))
        endpoints["pre_final_pool"] = nhwc(x)
        x = x.mean(dim=(2, 3))
        endpoints["final_reduce_mean"] = x[:, None, None, :]
        x = self.final_dense(x)
        endpoints["final_dense"] = x
        if return_intermediate_values:
            return x, endpoints
        return x


def get_resnet50_spatial(images: torch.Tensor, model: ResNet,
                         train: bool = False) -> torch.Tensor:
    """The last block layer's spatial feature map (NHWC) of `model`, a
    ResNet50 (ResNet(num_classes=1, resnet_size=50) in the JAX package's
    default)."""
    _, endpoints = model(images, train, return_intermediate_values=True)
    return endpoints["block_layer4"]
