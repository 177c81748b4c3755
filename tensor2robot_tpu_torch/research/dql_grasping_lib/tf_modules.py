"""Convnet building blocks for grasping-style critics.

Port of tensor2robot_tpu/research/dql_grasping_lib/tf_modules.py. The
JAX package's `conv_block` declares a flax Conv + LayerNorm inside its
caller; here the caller owns the modules (`make_conv_block`, named as
the flax modules are: `<name>` and `<name>_ln`) and `conv_block` applies
them. Tensors are NHWC as in the JAX package.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

#: flax.linen.LayerNorm's epsilon (torch's default is 1e-5).
LAYER_NORM_EPS = 1e-6

_STATE = threading.local()


class FlaxLayerNorm(nn.Module):
    """flax.linen.LayerNorm: normalizes over the LAST axis only (channels
    of an NHWC map), epsilon 1e-6, an optional scale (`weight`; flax's
    use_scale=False has none) and a bias. As flax promotes a bf16 input
    with its float32 parameters, the norm computes and returns float32
    under any autocast (CUDA's autocast does so by itself; the CPU's would
    mix bf16 and float32 in the backward)."""

    def __init__(self, features: int, use_scale: bool = True,
                 eps: float = LAYER_NORM_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(features))

    def init_own_parameters(self, generator: Optional[torch.Generator]) -> None:
        del generator
        if self.weight is not None:
            self.weight.data.fill_(1.0)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(device_type=x.device.type, enabled=False):
            x = x.to(torch.promote_types(x.dtype, self.bias.dtype))
            if getattr(_STATE, "decomposed", False):
                return self._decomposed(x)
            if self.weight is None:
                # The bias is added outside the fused norm: with a bias and
                # no weight, CUDA's fused backward returned an empty bias
                # gradient on the card (torch 2.11; VRGripper's tower over
                # 320 images of 100x100).
                return F.layer_norm(x, (x.shape[-1],), None, None, self.eps) + self.bias
            return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias, self.eps)

    def _decomposed(self, x: torch.Tensor) -> torch.Tensor:
        """flax's own formula, in elementwise ops and means."""
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp_min(torch.square(x).mean(dim=-1, keepdim=True)
                              - torch.square(mean), 0.0)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight
        return y + self.bias


@contextlib.contextmanager
def decomposed_layer_norms() -> Iterator[None]:
    """FlaxLayerNorm computes flax's formula in elementwise ops in this
    thread. Second derivatives need it: layer_norm's double backward
    raises for a norm without a scale under autograd, and under torch.func's
    vmap of grad it gives wrong second derivatives for one with a scale
    (MAML's second order over tasks; checked against float64 central
    differences)."""
    previous = getattr(_STATE, "decomposed", False)
    _STATE.decomposed = True
    try:
        yield
    finally:
        _STATE.decomposed = previous


def conv2d_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A torch (NCHW) conv applied to an NHWC tensor, NHWC out."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def make_conv_block(
    in_channels: int, channels: int, kernel_size: int = 3, stride: int = 2,
) -> Tuple[nn.Conv2d, FlaxLayerNorm]:
    """The conv (VALID, stride 2) and layer norm of one block; the conv's
    kernel is drawn truncated-normal(0.01) by `init_conv_block`."""
    return (nn.Conv2d(in_channels, channels, kernel_size, stride=stride),
            FlaxLayerNorm(channels))


def init_conv_block(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """flax truncated_normal(stddev=0.01) kernel (cut at two standard
    deviations), zero bias."""
    with torch.no_grad():
        std = 0.01 / 0.87962566103423978
        nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        conv.bias.zero_()


def conv_block(x: torch.Tensor, conv: nn.Conv2d, norm: FlaxLayerNorm) -> torch.Tensor:
    """conv(VALID, stride 2) + layer norm + relu over an NHWC map."""
    return F.relu(norm(conv2d_nhwc(conv, x)))


def tile_to_match_context(net: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
    """Tiles net along a new axis=1 to match context's per-batch examples:
    [B, ...] + [B, M, C] -> [B, M, ...]."""
    num_samples = context.shape[1]
    expanded = net.unsqueeze(1)
    reps = [1] * expanded.ndim
    reps[1] = num_samples
    return expanded.repeat(*reps)


def add_context(net: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
    """Broadcast-adds a [B*M, C] context into a [B*M, H, W, C] conv map.
    `net` must already be tiled to B*M rows."""
    if net.shape[0] != context.shape[0]:
        raise ValueError(
            f"net rows {net.shape[0]} != context rows {context.shape[0]}; "
            "tile the conv map to the action megabatch first."
        )
    if net.shape[-1] != context.shape[-1]:
        raise ValueError(
            f"Channel mismatch: {net.shape[-1]} vs {context.shape[-1]}."
        )
    return net + context[:, None, None, :]
