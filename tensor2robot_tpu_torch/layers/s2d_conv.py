"""Space-to-depth lowering of a strided stem convolution.

Port of tensor2robot_tpu/layers/s2d_conv.py. A KxK, stride-S convolution
whose kernel size is a multiple of its stride equals space-to-depth by S
(each SxS block of pixels folded into channels) followed by a (K/S)x(K/S)
stride-1 convolution whose kernel is a reshape of the original: output
(i, j) reads input rows S*i - pad ... S*i - pad + K - 1 on both paths, and
SAME zero padding of (K - S) / 2 pixels a side is (K - S) / (2S) folded
pixels a side.

The parameter keeps the plain convolution's layout and name (`weight`,
[F, C, K, K], as `research/qtopt/networks._Conv`), so checkpoints load
unchanged into either stem, and utils/jax_params.py maps the JAX stem's
`conv1_1` kernel to both. The port runs NCHW: the fold orders the
folded channels (p, q, c) with c fastest, as the JAX package's NHWC fold
does ((p * S + q) * C + c), and the kernel is reshaped in the same order
at each forward.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch import flags


def stem_s2d_enabled() -> bool:
    """Whether strided stems lower via space-to-depth: T2R_STEM_S2D=1 on,
    0 off, and auto (the default) off, as in the JAX package."""
    mode = flags.get_enum("T2R_STEM_S2D")
    if mode == "auto":
        return False
    return mode == "1"


def _check_geometry(kernel_size: Tuple[int, int], strides: Tuple[int, int]) -> None:
    (kh, kw), (sh, sw) = kernel_size, strides
    if kh % sh or kw % sw:
        raise ValueError(
            f"kernel {tuple(kernel_size)} not a multiple of strides {tuple(strides)}; "
            "space-to-depth lowering needs K % S == 0")
    if (kh - sh) % (2 * sh) or (kw - sw) % (2 * sw):
        raise ValueError(
            f"SAME padding of kernel {tuple(kernel_size)} stride {tuple(strides)} is "
            "not a whole number of space-to-depth blocks per side")


def space_to_depth(x: torch.Tensor, strides: Tuple[int, int]) -> torch.Tensor:
    """[B, C, H, W] -> [B, S*S*C, H/S, W/S], folded channel (p * S + q) * C + c
    for the pixel (S*i + p, S*j + q)."""
    b, c, h, w = x.shape
    sh, sw = strides
    if h % sh or w % sw:
        raise ValueError(f"input spatial dims {(h, w)} not divisible by strides "
                         f"{tuple(strides)}")
    x = x.reshape(b, c, h // sh, sh, w // sw, sw).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, sh * sw * c, h // sh, w // sw)


def folded_kernel(weight: torch.Tensor, strides: Tuple[int, int]) -> torch.Tensor:
    """[F, C, K, K] -> [F, S*S*C, K/S, K/S]: tap (a, b) over folded channel
    (p, q, c) is the plain kernel's (S*a + p, S*b + q) for channel c."""
    f, c, kh, kw = weight.shape
    sh, sw = strides
    k = weight.reshape(f, c, kh // sh, sh, kw // sw, sw).permute(0, 3, 5, 1, 2, 4)
    return k.reshape(f, sh * sw * c, kh // sh, kw // sw)


class SpaceToDepthConv(nn.Module):
    """Twin of `_Conv(in_channels, features, (K, K), stride=(S, S))` (SAME,
    no bias) on NCHW input, for K % S == 0, lowered as space-to-depth(S) and
    a (K/S)^2 stride-1 convolution.

    Unlike the plain conv it needs spatial dims divisible by S, and it has
    no bias: a state dict carrying `bias` raises rather than being dropped.
    """

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int] = (6, 6), strides: Tuple[int, int] = (2, 2)):
        super().__init__()
        _check_geometry(kernel_size, strides)
        self.kernel_size = tuple(kernel_size)
        self.stride = tuple(strides)
        self.weight = nn.Parameter(torch.empty(features, in_channels, *self.kernel_size))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        if prefix + "bias" in state_dict:
            raise ValueError(
                f"SpaceToDepthConv has no bias, but {prefix}bias was restored into it "
                "(a convolution trained with a bias?); it would be silently dropped, "
                "changing the computation. Fold the bias away or load into a plain "
                "convolution.")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        pad = ((kh - sh) // (2 * sh), (kw - sw) // (2 * sw))
        return F.conv2d(space_to_depth(x, self.stride),
                        folded_kernel(self.weight, self.stride), padding=pad)
