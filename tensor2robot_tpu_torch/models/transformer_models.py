"""Transformer model family: long-context behavioral cloning.

Port of tensor2robot_tpu/models/transformer_models.py: a per-step conv
embed, a causal transformer over the episode and a per-step action head.
Per-step image + proprioception in, per-step action out. Optional
mixture-of-experts feed-forwards (`num_experts > 1`) put the mean of the
blocks' router aux losses into the TRAIN outputs only (`moe_aux_loss`),
and model_train_fn folds it into the loss. StreamingBCPolicy serves one
control step at a time from a KV cache (the decode network).

With a `mesh` (parallel/mesh.py) whose `sequence` dim is above 1 the
encoder runs sequence-parallel (`sequence_parallel_mode` "ring" or
"ulysses"; layers/transformer.py), and with an `expert` dim above 1 each
rank computes its resident experts (ops/moe.py). Such a mesh adds no
parameter: the state dict, and so the checkpoint, has the single-device
layout, and `without_mesh()` is the model that exports and serves it.

With `pipeline_stages` = S over a mesh whose `pipe` dim is S, the encoder
runs as a GPipe pipeline (`pipeline_microbatches` microbatches;
layers/transformer.py): each pipe rank's network holds one stage's blocks
under `encoder.pipe_stages`, the trainer's checkpoint stacks them ([S,
...], the JAX tree's layout), and `without_mesh()` is the
`pipeline_stages=1` twin, whose network loads that checkpoint as the
chain of blocks it computes. Decoding is always single-device.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.export.streaming import StreamingStepRunner
from tensor2robot_tpu_torch.layers import remat
from tensor2robot_tpu_torch.layers.spatial_softmax import spatial_softmax
from tensor2robot_tpu_torch.layers.transformer import DecodeCache, TransformerEncoder
from tensor2robot_tpu_torch.models.abstract_model import (
    MODE_PREDICT,
    MODE_TRAIN,
    TorchT2RModel,
)
from tensor2robot_tpu_torch.specs import (
    ExtendedTensorSpec,
    TensorSpecStruct,
    copy_tensorspec,
)
from tensor2robot_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

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


class _SameConv(nn.Conv2d):
    """A 3x3 stride-2 conv with XLA 'SAME' padding applied inside it (flax
    nn.Conv's default), so the module's input is the unpadded map, as the
    JAX package's conv sees it."""

    def __init__(self, in_channels: int, filters: int):
        super().__init__(in_channels, filters, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(_pad_same(x, 3, 2))


class _TransformerBCNet(nn.Module):
    """Per-step conv embed -> causal transformer over time -> action head.
    Features are {'image': [B, T, H, W, 3], 'gripper_pose': [B, T, P]}.

    decode: the streaming twin (identical parameter names, so trained
    weights load as they are): `decode_step` takes one step against the
    cache of `init_cache`. Training always takes the full forward.
    """

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
        pipeline_microbatches: Optional[int] = None,
        attention_window: Optional[int] = None,
        num_kv_heads: Optional[int] = None,
        decode: bool = False,
        sequence_parallel_mode: str = "ring",
    ):
        super().__init__()
        in_channels = 3
        for i, filters in enumerate(_CONV_FILTERS):
            self.add_module(f"Conv_{i}", _SameConv(in_channels, filters))
            in_channels = filters
        self.embed = nn.Linear(2 * in_channels + pose_size, d_model)
        self.encoder = TransformerEncoder(
            d_model, num_layers, num_heads, head_dim,
            max_seq_len=max_seq_len, causal=True, use_flash=use_flash,
            window=attention_window, num_kv_heads=num_kv_heads,
            num_experts=num_experts, decode=decode, mesh=mesh,
            pipeline_stages=pipeline_stages,
            pipeline_microbatches=pipeline_microbatches,
            sequence_parallel_mode=sequence_parallel_mode,
        )
        self.action_head = nn.Linear(d_model, action_size)

    def _embed_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] frames -> [N, 2C] spatial-softmax keypoints."""
        # NHWC at the module boundary (as the JAX package); NCHW for conv.
        x = frames.permute(0, 3, 1, 2)
        for i in range(len(_CONV_FILTERS)):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        points, _ = spatial_softmax(x.permute(0, 2, 3, 1))
        return points

    def forward(self, features, mode, cache: Optional[DecodeCache] = None):
        image = features["image"]
        pose = features["gripper_pose"]
        batch, steps = image.shape[:2]
        frames = image.reshape((batch * steps,) + tuple(image.shape[2:]))
        points = remat.segments_over_batch(self._embed_frames, frames, REMAT_FRAMES)
        x = torch.cat([points.reshape(batch, steps, -1), pose], dim=-1)
        x, aux_losses = self.encoder(
            self.embed(x), None if cache is None else cache.child("encoder")
        )
        action = self.action_head(x)
        outputs = {"inference_output": action, "action": action}
        # Train outputs only: eval and serving signatures (and exports)
        # carry no aux scalar.
        if mode == MODE_TRAIN and aux_losses:
            outputs["moe_aux_loss"] = sum(aux_losses) / len(aux_losses)
        return outputs

    def init_cache(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """The zeroed decode cache (an episode's start) on the network's
        device, in its parameters' dtype."""
        weight = self.embed.weight
        tensors: Dict[str, torch.Tensor] = {}
        self.encoder.init_cache(
            batch_size, DecodeCache(tensors).child("encoder"), weight.dtype,
            weight.device,
        )
        return tensors

    def decode_step(
        self,
        cache: Mapping[str, torch.Tensor],
        image: torch.Tensor,
        pose: torch.Tensor,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One step: image [B, 1, H, W, 3], pose [B, 1, P] -> (action
        [B, A], the new cache)."""
        state = DecodeCache(dict(cache))
        outputs = self.forward(
            {"image": image, "gripper_pose": pose}, MODE_PREDICT, state
        )
        return outputs["action"][:, 0], state.tensors


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
        moe_aux_weight: float = 0.01,
        mesh: Optional[object] = None,
        use_flash: Optional[bool] = None,
        pipeline_stages: int = 1,
        pipeline_microbatches: Optional[int] = None,
        attention_window: Optional[int] = None,
        num_kv_heads: Optional[int] = None,
        sequence_parallel_mode: str = "ring",
        **kwargs,
    ):
        super().__init__(**kwargs)
        self._action_size = action_size
        self._pose_size = pose_size
        self._episode_length = episode_length
        self._image_size = tuple(image_size)
        self._moe_aux_weight = moe_aux_weight
        self._attention_window = attention_window
        self._mesh = mesh
        self._net_kwargs = dict(
            d_model=d_model, num_layers=num_layers, num_heads=num_heads,
            head_dim=head_dim, max_seq_len=max(episode_length, 8),
            num_experts=num_experts, mesh=mesh, use_flash=use_flash,
            pipeline_stages=pipeline_stages,
            pipeline_microbatches=pipeline_microbatches,
            attention_window=attention_window, num_kv_heads=num_kv_heads,
            sequence_parallel_mode=sequence_parallel_mode,
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

    def without_mesh(self) -> "TransformerBCModel":
        """This model with no mesh: the same network, single-device (its
        state dict is the mesh network's; a pipelined model's twin has
        pipeline_stages=1 and loads the stacked stages as its chain)."""
        clone = super().without_mesh()
        if clone is not self:
            clone._net_kwargs = dict(self._net_kwargs, mesh=None, pipeline_stages=1)
        return clone

    def init_network(self, generator=None, device=DEFAULT_DEVICE) -> nn.Module:
        """A pipelined network starts from its single-device twin's draw
        (its stage of the same chain, on every pipe rank), so a pipelined
        model and its twin start equal."""
        if self._net_kwargs["pipeline_stages"] == 1:
            return super().init_network(generator, device)
        chain = self.without_mesh().init_network(generator, "cpu")
        network = self.create_network()
        network.load_state_dict(chain.state_dict())
        return network.to(resolve_device(device))

    def create_network(self, decode: bool = False) -> nn.Module:
        kwargs = dict(self._net_kwargs)
        if decode:
            # Decoding is single-device serving: no mesh, no pipeline.
            kwargs.update(mesh=None, pipeline_stages=1)
        return _TransformerBCNet(
            action_size=self._action_size,
            pose_size=self._pose_size,
            decode=decode,
            **kwargs,
        )

    def create_streaming_policy(
        self,
        state_dict: Mapping[str, torch.Tensor],
        batch_size: int = 1,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
        graph: Optional[bool] = None,
    ) -> "StreamingBCPolicy":
        """Per-step serving over trained weights (KV-cache decode)."""
        return StreamingBCPolicy(
            self, state_dict, batch_size=batch_size, device=device, graph=graph
        )

    def model_train_fn(self, features, labels, inference_outputs, mode):
        del features, mode
        mse = torch.mean(
            torch.square(inference_outputs["inference_output"] - labels["action"])
        )
        metrics = {"loss/mse": mse}
        loss = mse
        if "moe_aux_loss" in inference_outputs:
            aux = inference_outputs["moe_aux_loss"]
            metrics["loss/moe_aux"] = aux
            loss = loss + self._moe_aux_weight * aux
        return loss, metrics

    def model_eval_fn(self, features, labels, inference_outputs):
        del features
        return {
            "eval/mse": torch.mean(
                torch.square(
                    inference_outputs["inference_output"] - labels["action"]
                )
            )
        }


class StreamingBCPolicy(StreamingStepRunner):
    """Stateful per-step serving for a trained TransformerBCModel.

    Each step() consumes ONE observation (image + proprioception) and
    returns that step's action: the conv embed runs on the single frame
    and attention reads the K/V cache, O(attention_window) per step when
    the model has one, never a full-episode recompute. On the card a step
    is one CUDA graph replay over static buffers for the image, the pose,
    the caches and the counters (StreamingStepRunner; `graph=False` steps
    eagerly, the yardstick); on the CPU it runs eagerly.

    Episodes are bounded by the model's capacity, max(episode_length, 8):
    steps past it overwrite the last cache slot. Call reset() between
    episodes.
    """

    def __init__(
        self,
        model: TransformerBCModel,
        state_dict: Mapping[str, torch.Tensor],
        batch_size: int = 1,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
        graph: Optional[bool] = None,
    ):
        network = model.create_network(decode=True)
        network.load_state_dict(state_dict)
        network.eval()
        super().__init__(
            network.decode_step, network.init_cache(batch_size), batch_size,
            tuple(model._image_size) + (3,), model._pose_size, device=device,
            graph=graph,
        )
        self.network = network.to(self.device)
