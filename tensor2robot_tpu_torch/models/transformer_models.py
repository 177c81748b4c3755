"""Transformer model family: long-context behavioral cloning.

Port of tensor2robot_tpu/models/transformer_models.py: a per-step conv
embed, a causal transformer over the episode and a per-step action head.
Per-step image + proprioception in, per-step action out. The streaming
(KV-cache decode) policy is not ported yet (ROADMAP.md A6).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import remat
from tensor2robot_tpu_torch.layers.spatial_softmax import spatial_softmax
from tensor2robot_tpu_torch.layers.transformer import TransformerEncoder
from tensor2robot_tpu_torch.models.abstract_model import TorchT2RModel
from tensor2robot_tpu_torch.specs import (
    ExtendedTensorSpec,
    TensorSpecStruct,
    copy_tensorspec,
)

_CONV_FILTERS = (32, 64)
# Frames per remat segment of the per-frame conv embed, whose activations
# dominate a step's memory (layers/remat.py).
REMAT_FRAMES = 1024


def _pad_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """XLA 'SAME' padding of an NCHW tensor: the output has ceil(n/stride)
    positions and the odd pixel of padding goes AFTER (for a stride-2 3x3
    conv over an even size: 0 before, 1 after — not torch's symmetric 1)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad lists the last dim first
        out = -(-n // stride)
        total = max((out - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class _TransformerBCNet(nn.Module):
    """Per-step conv embed -> causal transformer over time -> action head.
    Features are {'image': [B, T, H, W, 3], 'gripper_pose': [B, T, P]}."""

    def __init__(
        self,
        action_size: int,
        pose_size: int,
        d_model: int = 64,
        num_layers: int = 2,
        num_heads: int = 4,
        head_dim: int = 16,
        max_seq_len: int = 2048,
        num_experts: int = 1,
        mesh: Optional[object] = None,
        use_flash: Optional[bool] = None,
        pipeline_stages: int = 1,
        attention_window: Optional[int] = None,
        num_kv_heads: Optional[int] = None,
    ):
        super().__init__()
        in_channels = 3
        for i, filters in enumerate(_CONV_FILTERS):
            self.add_module(
                f"Conv_{i}", nn.Conv2d(in_channels, filters, 3, stride=2)
            )
            in_channels = filters
        self.embed = nn.Linear(2 * in_channels + pose_size, d_model)
        self.encoder = TransformerEncoder(
            d_model, num_layers, num_heads, head_dim,
            max_seq_len=max_seq_len, causal=True, use_flash=use_flash,
            window=attention_window, num_kv_heads=num_kv_heads,
            num_experts=num_experts, mesh=mesh,
            pipeline_stages=pipeline_stages,
        )
        self.action_head = nn.Linear(d_model, action_size)

    def _embed_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] frames -> [N, 2C] spatial-softmax keypoints."""
        # NHWC at the module boundary (as the JAX package); NCHW for conv.
        x = frames.permute(0, 3, 1, 2)
        for i in range(len(_CONV_FILTERS)):
            x = F.relu(getattr(self, f"Conv_{i}")(_pad_same(x, 3, 2)))
        points, _ = spatial_softmax(x.permute(0, 2, 3, 1))
        return points

    def forward(self, features, mode):
        del mode
        image = features["image"]
        pose = features["gripper_pose"]
        batch, steps = image.shape[:2]
        frames = image.reshape((batch * steps,) + tuple(image.shape[2:]))
        points = remat.segments_over_batch(self._embed_frames, frames, REMAT_FRAMES)
        x = torch.cat([points.reshape(batch, steps, -1), pose], dim=-1)
        x = self.encoder(self.embed(x))
        action = self.action_head(x)
        return {"inference_output": action, "action": action}


class TransformerBCModel(TorchT2RModel):
    """Behavioral cloning over episodes with a causal transformer: the
    same spec contract as the JAX TransformerBCModel."""

    def __init__(
        self,
        action_size: int = 7,
        pose_size: int = 14,
        episode_length: int = 40,
        image_size: Tuple[int, int] = (64, 64),
        d_model: int = 64,
        num_layers: int = 2,
        num_heads: int = 4,
        head_dim: int = 16,
        num_experts: int = 1,
        mesh: Optional[object] = None,
        use_flash: Optional[bool] = None,
        pipeline_stages: int = 1,
        attention_window: Optional[int] = None,
        num_kv_heads: Optional[int] = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self._action_size = action_size
        self._pose_size = pose_size
        self._episode_length = episode_length
        self._image_size = tuple(image_size)
        self._net_kwargs = dict(
            d_model=d_model, num_layers=num_layers, num_heads=num_heads,
            head_dim=head_dim, max_seq_len=max(episode_length, 8),
            num_experts=num_experts, mesh=mesh, use_flash=use_flash,
            pipeline_stages=pipeline_stages,
            attention_window=attention_window, num_kv_heads=num_kv_heads,
        )

    def get_feature_specification(self, mode: str) -> TensorSpecStruct:
        del mode
        spec = TensorSpecStruct(
            image=ExtendedTensorSpec(
                shape=self._image_size + (3,),
                dtype=np.float32,
                name="image",
                data_format="jpeg",
            ),
            gripper_pose=ExtendedTensorSpec(
                shape=(self._pose_size,),
                dtype=np.float32,
                name="gripper_pose",
            ),
        )
        return copy_tensorspec(spec, batch_size=self._episode_length)

    def get_label_specification(self, mode: str) -> TensorSpecStruct:
        del mode
        spec = TensorSpecStruct(
            action=ExtendedTensorSpec(
                shape=(self._action_size,), dtype=np.float32, name="action"
            )
        )
        return copy_tensorspec(spec, batch_size=self._episode_length)

    def create_network(self) -> nn.Module:
        return _TransformerBCNet(
            action_size=self._action_size,
            pose_size=self._pose_size,
            **self._net_kwargs,
        )

    def model_train_fn(self, features, labels, inference_outputs, mode):
        del features, mode
        mse = torch.mean(
            torch.square(inference_outputs["inference_output"] - labels["action"])
        )
        return mse, {"loss/mse": mse}

    def model_eval_fn(self, features, labels, inference_outputs):
        del features
        return {
            "eval/mse": torch.mean(
                torch.square(
                    inference_outputs["inference_output"] - labels["action"]
                )
            )
        }
