"""The module over the MoE op (ops/moe.py).

Port of tensor2robot_tpu/layers/moe.py. `MoEBlock` sits where a dense MLP
would (the feed-forward of layers/transformer.TransformerBlock):
[batch, seq, features] in and out, plus the router's load-balance aux
loss, which the caller folds into the training loss. Its parameters carry
the flax names and layouts (router [F, E], w_in [E, F, H],
w_out [E, H, F]), so utils/jax_params.py maps them as they are.

With a mesh whose `expert` dim is above 1 each rank computes only its
resident experts (ops/moe.py has the rule); the parameters stay whole.
Experts under a sequence-parallel encoder (a `sequence` dim above 1) are
refused, naming ROADMAP.md A9: the encoder's blocks see one shard of each
episode, so an episode's routing group, and its capacity, would be cut.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from tensor2robot_tpu_torch.ops import moe as moe_ops
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib


class MoEBlock(nn.Module):
    """Top-k routed expert MLP over [batch, seq, features]."""

    def __init__(
        self,
        features: int,
        num_experts: int,
        hidden_dim: int,
        num_selected: int = 2,
        capacity_factor: float = 2.0,
        group_size: Optional[int] = None,
        mesh: Optional[object] = None,
    ):
        super().__init__()
        if mesh_lib.axis_size(mesh, mesh_lib.SEQUENCE_AXIS) > 1:
            raise NotImplementedError(
                "experts under a sequence-parallel encoder (expert x sequence) "
                "are not ported yet (ROADMAP.md A9): each block sees one "
                "sequence shard, so an episode's routing group would be cut"
            )
        moe_ops.resident_experts(num_experts, mesh)  # E % expert raises now
        self.mesh = mesh
        self.num_selected = num_selected
        self.capacity_factor = capacity_factor
        # None: one routing group per batch element (seq tokens).
        self.group_size = group_size
        self.router = nn.Parameter(torch.empty(features, num_experts))
        self.w_in = nn.Parameter(torch.empty(num_experts, features, hidden_dim))
        self.w_out = nn.Parameter(torch.empty(num_experts, hidden_dim, features))

    def init_own_parameters(self, generator: torch.Generator) -> None:
        """flax's lecun_normal: a truncated normal of variance 1/fan_in,
        fan_in = every dim but the last (flax's in_axis=-2 times its
        receptive field, the expert dim here)."""
        with torch.no_grad():
            for weight in (self.router, self.w_in, self.w_out):
                fan_in = weight.numel() // weight.shape[-1]
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(
                    weight, std=std, a=-2.0 * std, b=2.0 * std,
                    generator=generator,
                )

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        batch, seq, features = x.shape
        y, aux_loss = moe_ops.moe_mlp(
            x.reshape(batch * seq, features), self.router, self.w_in,
            self.w_out, num_selected=self.num_selected,
            capacity_factor=self.capacity_factor,
            group_size=self.group_size or seq, mesh=self.mesh,
        )
        return y.reshape(batch, seq, features), aux_loss
