"""QT-Opt grasping Q-network: the Grasping44 tower.

Port of tensor2robot_tpu/research/qtopt/networks.py. The tower:

  472x472x3 image
    -> conv 64@6x6 /2 (no norm) -> BN(scale=False) -> relu -> maxpool 3x3 /3
    -> 6x [conv 64@5x5 + BN + relu]            -> maxpool 3x3 /3   (pool2)
  grasp params (one Dense(256) per named block, summed)
    -> BN(scale=False) -> relu -> Dense(64) -> BN -> relu -> context
  merge: image embedding (tiled per CEM action) + context broadcast-add
    -> 6x [conv 64@3x3 + BN + relu]            -> maxpool 2x2 /2
    -> 3x [conv 64@3x3 VALID + BN + relu]                        (final_conv)
    -> flatten -> 2x [Dense(64) + BN + relu] -> Dense(1) logit -> sigmoid

What follows the JAX package exactly, for parity and for its checkpoints:

  * Activations are NCHW inside (cuDNN's layout); images come in NHWC.
    Convs use TF `SAME` padding, made explicit (lo = total // 2, the odd
    pixel after), and have no bias. Pools are ops/pooling.py's.
  * The activation is flattened in NHWC order before fc0, so fc0's
    weight is the JAX kernel transposed, with no reordering of its rows.
  * Module names are the flax modules' (conv1_1, bn1, conv<i>.Conv_0,
    conv<i>.BatchNorm_0, fcgrasp_*, bn_fcgrasp, fcgrasp2, bn_fcgrasp2,
    fc<i>, bn_fc<i>, logit), so utils/jax_params.py converts a flax
    variables tree (params and batch_stats) one to one.
  * Kernels draw from a normal truncated at two standard deviations with
    std 0.01 (flax's truncated_normal(0.01)), biases are 0; batch norms
    start at scale 1, bias 0, mean 0, var 1.
  * The CEM megabatch ([B, N, P] grasp params) tiles the image EMBEDDING
    after pool2, not the image: the image convs run once per state.
  * The compute dtype follows the image: under a bf16 autocast
    (models/tpu_model_wrapper.py) convs and dense layers run in bf16 with
    f32 parameters; batch-norm statistics stay f32 and the logit head
    computes and emits f32.

With T2R_STEM_S2D=1 the stem lowers via space-to-depth
(layers/s2d_conv.py), as in the JAX package; auto and 0 keep the plain
strided stem. Both stems store `conv1_1.weight` alike.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import remat
from tensor2robot_tpu_torch.layers.batch_norm import BatchNorm
from tensor2robot_tpu_torch.layers.s2d_conv import SpaceToDepthConv, stem_s2d_enabled
from tensor2robot_tpu_torch.ops import pooling

# Named grasp-param sub-blocks of the E2E variant: {name: (offset, size)}.
E2E_GRASP_PARAM_BLOCKS: Dict[str, Tuple[int, int]] = {
    "fcgrasp_wv": (0, 3),
    "fcgrasp_vr": (3, 2),
    "fcgrasp_gripper_close": (5, 1),
    "fcgrasp_gripper_open": (6, 1),
    "fcgrasp_terminate_episode": (7, 1),
    "fcgrasp_gripper_closed": (8, 1),
    "fcgrasp_height_to_bottom": (9, 1),
}

CONV_INIT_STD = 0.01


def pad_same(x: torch.Tensor, kernel: Tuple[int, int], stride: Tuple[int, int]):
    """TF 'SAME' zero padding of an NCHW tensor for a conv: ceil(n /
    stride) outputs, lo = total // 2 and the odd pixel after."""
    pads = []
    for n, k, s in ((x.shape[3], kernel[1], stride[1]),
                    (x.shape[2], kernel[0], stride[0])):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class _Conv(nn.Conv2d):
    """A bias-free conv with TF padding ('SAME' or 'VALID')."""

    def __init__(self, in_channels, out_channels, kernel, stride=(1, 1),
                 padding="SAME"):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         bias=False)
        self.tf_padding = padding

    def forward(self, x):
        if self.tf_padding == "SAME":
            x = pad_same(x, self.kernel_size, self.stride)
        return super().forward(x)


class _ConvBNRelu(nn.Module):
    def __init__(self, in_channels, features, kernel, padding="SAME",
                 momentum=0.9997, epsilon=0.001):
        super().__init__()
        self.Conv_0 = _Conv(in_channels, features, kernel, padding=padding)
        self.BatchNorm_0 = BatchNorm(features, momentum=momentum,
                                     epsilon=epsilon)

    def forward(self, x, is_training: bool):
        return F.relu(self.BatchNorm_0(self.Conv_0(x), is_training))


class Grasping44(nn.Module):
    """The flexible-grasp-params Grasping44 Q-tower.

    Call with `images` [B, H, W, 3] (NHWC) and `grasp_params` [B, P]
    (train/eval) or [B, N, P] (CEM megabatch, N = action_batch_size).
    Returns (logits, end_points); end_points['predictions'] is
    sigmoid(logits), [B, N] when action-tiled, [B] otherwise.
    """

    def __init__(
        self,
        grasp_param_blocks: Optional[Dict[str, Tuple[int, int]]] = None,
        num_convs: Sequence[int] = (6, 6, 3),
        hid_layers: int = 2,
        num_classes: int = 1,
        batch_norm_momentum: float = 0.9997,
        batch_norm_epsilon: float = 0.001,
        width: int = 64,
        grasp_param_size: int = 10,
        image_size: Tuple[int, int] = (472, 472),
    ):
        super().__init__()
        self.num_convs = tuple(num_convs)
        self.hid_layers = hid_layers
        self.num_classes = num_classes
        self.width = width
        bn = dict(momentum=batch_norm_momentum, epsilon=batch_norm_epsilon)

        if stem_s2d_enabled():
            self.conv1_1 = SpaceToDepthConv(3, width, (6, 6), strides=(2, 2))
        else:
            self.conv1_1 = _Conv(3, width, (6, 6), stride=(2, 2))
        self.bn1 = BatchNorm(width, use_scale=False, **bn)
        for i in range(self.num_convs[0]):
            self.add_module(f"conv{2 + i}", _ConvBNRelu(width, width, (5, 5), **bn))
        self.blocks = dict(
            grasp_param_blocks or {"fcgrasp": (0, grasp_param_size)}
        )
        for name in sorted(self.blocks):
            self.add_module(name, nn.Linear(self.blocks[name][1], 256))
        self.bn_fcgrasp = BatchNorm(256, use_scale=False, **bn)
        self.fcgrasp2 = nn.Linear(256, width)
        self.bn_fcgrasp2 = BatchNorm(width, **bn)
        first = 2 + self.num_convs[0]
        for i in range(self.num_convs[1]):
            self.add_module(f"conv{first + i}",
                            _ConvBNRelu(width, width, (3, 3), **bn))
        first += self.num_convs[1]
        for i in range(self.num_convs[2]):
            self.add_module(f"conv{first + i}",
                            _ConvBNRelu(width, width, (3, 3), padding="VALID", **bn))
        features = width * final_conv_area(image_size, self.num_convs)
        for i in range(hid_layers):
            self.add_module(f"fc{i}", nn.Linear(features, 64))
            self.add_module(f"bn_fc{i}", BatchNorm(64, **bn))
            features = 64
        self.logit = nn.Linear(features, num_classes)

    def init_parameters(self, generator: torch.Generator) -> None:
        """flax's initial values (module docstring), drawn from
        `generator` module by module in registration order."""
        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, (nn.Conv2d, nn.Linear, SpaceToDepthConv)):
                    nn.init.trunc_normal_(
                        module.weight, std=CONV_INIT_STD,
                        a=-2 * CONV_INIT_STD, b=2 * CONV_INIT_STD,
                        generator=generator,
                    )
                    if getattr(module, "bias", None) is not None:
                        module.bias.zero_()
                elif isinstance(module, BatchNorm):
                    module.init_own_parameters()

    # The image convs run as four remat segments (layers/remat.py): the
    # stem, and each conv stage with its pool.

    def _stem(self, net, is_training):
        net = F.relu(self.bn1(self.conv1_1(net), is_training))
        return pooling.max_pool(net, (3, 3))

    def _stage(self, net, first, count, pool, is_training):
        for i in range(count):
            net = getattr(self, f"conv{first + i}")(net, is_training)
        return net if pool is None else pooling.max_pool(net, (pool, pool))

    def forward(self, images, grasp_params, is_training=False, softmax=False):
        end_points: Dict[str, torch.Tensor] = {}
        tile_batch = grasp_params.ndim == 3
        action_batch_size = grasp_params.shape[1] if tile_batch else 1
        if tile_batch:
            grasp_params = grasp_params.reshape(-1, grasp_params.shape[-1])

        net = remat.segment(self._stem, images.permute(0, 3, 1, 2), is_training)
        net = remat.segment(self._stage, net, 2, self.num_convs[0], 3, is_training)
        end_points["pool2"] = net

        fcgrasp = None
        for name in sorted(self.blocks):
            offset, size = self.blocks[name]
            piece = getattr(self, name)(grasp_params[:, offset:offset + size])
            fcgrasp = piece if fcgrasp is None else fcgrasp + piece
        fcgrasp = F.relu(self.bn_fcgrasp(fcgrasp, is_training))
        fcgrasp = F.relu(self.bn_fcgrasp2(self.fcgrasp2(fcgrasp), is_training))
        end_points["fcgrasp"] = fcgrasp
        context = fcgrasp.reshape(-1, self.width, 1, 1)

        if tile_batch:
            net = torch.repeat_interleave(net, action_batch_size, dim=0)
        net = net + context.to(net.dtype)
        end_points["vsum"] = net

        first = 2 + self.num_convs[0]
        net = remat.segment(self._stage, net, first, self.num_convs[1], 2, is_training)
        first += self.num_convs[1]
        net = remat.segment(self._stage, net, first, self.num_convs[2], None,
                            is_training)
        end_points["final_conv"] = net

        # Flatten in NHWC order, as the JAX package does.
        net = net.permute(0, 2, 3, 1).reshape(net.shape[0], -1)
        for i in range(self.hid_layers):
            net = getattr(self, f"fc{i}")(net)
            net = F.relu(getattr(self, f"bn_fc{i}")(net, is_training))

        # The logit head computes and emits (at least) float32, under any
        # autocast (its parameters are float32: autocast casts none). It is
        # called as a module, so a serving export can lower it as the JAX
        # package's Dense. Outside autocast there is no region to leave (an
        # exported program would carry it as a subgraph).
        head = torch.promote_types(net.dtype, torch.float32)
        if torch.is_autocast_enabled(net.device.type):
            with torch.autocast(device_type=net.device.type, enabled=False):
                logits = self.logit(net.to(head))
        else:
            logits = self.logit(net.to(head))
        end_points["logits"] = logits
        predictions = (torch.softmax(logits, dim=-1) if softmax
                       else torch.sigmoid(logits))
        if tile_batch:
            if self.num_classes > 1:
                predictions = predictions.reshape(-1, action_batch_size,
                                                  self.num_classes)
            else:
                predictions = predictions.reshape(-1, action_batch_size)
        elif self.num_classes == 1:
            predictions = predictions.reshape(-1)
        end_points["predictions"] = predictions
        return logits, end_points


def final_conv_area(image_size: Tuple[int, int], num_convs: Sequence[int]) -> int:
    """Pixels of the final conv's output: the stem conv and the three
    pools take ceil(n / stride), each VALID 3x3 conv takes 2 off."""
    area = 1
    for n in image_size:
        for stride in (2, 3, 3, 2):
            n = -(-n // stride)
        n -= 2 * num_convs[2]
        if n < 1:
            raise ValueError(
                f"image {tuple(image_size)} is too small for {num_convs[2]} "
                "VALID convs at the tail"
            )
        area *= n
    return area


E2E_ACTION_KEYS = (
    "world_vector",            # 3
    "vertical_rotation",       # 2
    "close_gripper",           # 1
    "open_gripper",            # 1
    "terminate_episode",       # 1
    "gripper_closed",          # 1
    "height_to_bottom",        # 1
)


def concat_e2e_grasp_params(action) -> torch.Tensor:
    """Packs the E2E action struct into the flat 10-dim grasp-params layout
    the block table indexes."""
    return torch.cat([action[k] for k in E2E_ACTION_KEYS], dim=-1)
