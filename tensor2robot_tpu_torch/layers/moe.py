"""The module over the MoE op (ops/moe.py).

Port of tensor2robot_tpu/layers/moe.py. `MoEBlock` sits where a dense MLP
would (the feed-forward of layers/transformer.TransformerBlock):
[batch, seq, features] in and out, plus the router's load-balance aux
loss, which the caller folds into the training loss. Its parameters carry
the flax names and layouts (router [F, E], w_in [E, F, H],
w_out [E, H, F]), so utils/jax_params.py maps them as they are.

With a mesh whose `expert` dim is above 1 each rank computes only its
resident experts (ops/moe.py has the rule); the parameters stay whole.

Under a sequence-parallel encoder (a `sequence` dim N above 1) the block
sees this rank's shard [B, S/N, F] of each episode. JAX's MoE block sees
the global tokens under GSPMD, its routing group `group_size or seq` the
whole episode, so here the shards are all_gathered (tiled on the sequence
axis) into [B, S, F] before routing, routed and dispatched with
group_size = S, and this rank's [B, S/N, F] is sliced back after the
combine; routing and every expert's capacity then see whole episodes, as
on one device. With an expert dim as well, the resident-expert rule
applies to the gathered tokens unchanged.

The gradient rule (layers/transformer.py states it for the encoder):
every sequence rank's backward carries N times its share of the
single-device gradient, and the trainer's pmean over the sequence ranks
turns that into the single-device gradient. Through the slice, this
rank's output shard receives N x its true cotangent, so the experts'
input cotangent is N x the true one on this shard's rows and zero
elsewhere; the aux loss, computed whole on every rank and entering the
loss as on one device, adds the single-device cotangent to every row on
every rank. The gather's backward sums the N ranks' cotangents of this
rank's rows (collectives.all_gather: psum_scatter), which gives N x the
true cotangent for both terms. A slice of the cotangent instead would
leave the aux term's share at 1 x, and the router and everything below it
would take the wrong gradient.

The redundancy: every sequence rank routes and computes every expert's
FFN for the whole episode (N times the single-device expert work over the
sequence ranks). Routing each rank's own tokens against capacities fixed
over the episode is the perf work ROADMAP.md holds for after the port.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from tensor2robot_tpu_torch.ops import moe as moe_ops
from tensor2robot_tpu_torch.parallel import collectives
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
        shards = mesh_lib.axis_size(self.mesh, mesh_lib.SEQUENCE_AXIS)
        if shards > 1:
            # Whole episodes for routing (module docstring).
            x = collectives.all_gather(x, self.mesh, mesh_lib.SEQUENCE_AXIS, axis=1)
        batch, seq, features = x.shape
        y, aux_loss = moe_ops.moe_mlp(
            x.reshape(batch * seq, features), self.router, self.w_in,
            self.w_out, num_selected=self.num_selected,
            capacity_factor=self.capacity_factor,
            group_size=self.group_size or seq, mesh=self.mesh,
        )
        y = y.reshape(batch, seq, features)
        if shards > 1:
            block = seq // shards
            me = collectives.axis_index(self.mesh, mesh_lib.SEQUENCE_AXIS)
            y = y[:, me * block:(me + 1) * block]
        return y, aux_loss
