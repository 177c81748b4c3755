"""Batch normalization with flax.linen.BatchNorm's semantics.

Port of tensor2robot_tpu/layers/batch_norm.py, which is numerically
flax's BatchNorm. It differs from torch.nn.BatchNorm2d where that matters
for parity with the JAX package:

  * the batch variance is the biased E[x^2] - E[x]^2, clamped at 0, with
    both moments in (at least) float32 whatever the input dtype;
  * the running statistics follow ra = momentum * ra + (1 - momentum) *
    batch (torch's `momentum` is the complement) and keep the biased
    variance (torch's running variance is unbiased);
  * normalization is (x - mean) * (rsqrt(var + eps) * scale) + bias;
  * whether the batch statistics are used (and the running ones updated)
    is the caller's `is_training`, as flax's use_running_average, not
    `module.training`.

Parameters are `weight` (flax `scale`, absent with use_scale=False) and
`bias`; the running statistics are the buffers `mean` and `var` (flax's
`batch_stats`), so they ride in the module's state dict. The JAX layer's
deferred `batch_stats_new` collection and its fused cross-layer update
exist to save small device copies on a TPU; the numbers they compute are
the same as the in-place update here, so they are not ported.

Over a mesh the train-mode moments are the global batch's, as in the JAX
trainer's default step (one program over the batch sharded by data x
fsdp, where the mean over axis 0 spans every shard): the trainer hands
its network's norms the mesh (`synchronize`), and each norm then sums
x and x^2 over its shard, adds the element count, and reduces those three
over the data x fsdp ranks in one call (collectives.psum_data_shards)
before it divides. The running statistics are then the same on every
rank. Eval mode and a single shard take the unsynchronized path,
unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib


def synchronize(network: nn.Module, mesh) -> None:
    """Points every BatchNorm of `network` at `mesh` (None: no mesh), so
    their train-mode moments span the mesh's data x fsdp shards. Over one
    shard the norms are left unsynchronized. The reference is a plain
    attribute, not state: a network built anew (an export, the EMA's eval
    copy) normalizes alone."""
    shards = 1 if mesh is None else mesh_lib.data_shard(mesh)[1]
    for module in network.modules():
        if isinstance(module, BatchNorm):
            module.mesh = mesh if shards > 1 else None


class BatchNorm(nn.Module):
    """Normalizes over every dim but `axis` (1: channels of NCHW or of a
    [B, C] matrix). The output has the input's dtype."""

    def __init__(
        self,
        features: int,
        momentum: float = 0.99,
        epsilon: float = 1e-5,
        use_scale: bool = True,
        use_bias: bool = True,
        axis: int = 1,
    ):
        super().__init__()
        self.features = features
        self.momentum = momentum
        self.epsilon = epsilon
        self.axis = axis
        self.weight: Optional[nn.Parameter] = (
            nn.Parameter(torch.ones(features)) if use_scale else None
        )
        self.bias: Optional[nn.Parameter] = (
            nn.Parameter(torch.zeros(features)) if use_bias else None
        )
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        # The mesh whose data x fsdp shards the train-mode moments span
        # (`synchronize`); None: this shard's.
        self.mesh = None

    def init_own_parameters(self, generator=None) -> None:
        """flax's initial values: scale 1, bias 0, mean 0, var 1."""
        del generator
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, is_training: bool) -> torch.Tensor:
        axis = self.axis % x.ndim
        reduce = tuple(d for d in range(x.ndim) if d != axis)
        shape = [1] * x.ndim
        shape[axis] = x.shape[axis]
        if is_training:
            x32 = x.to(torch.promote_types(x.dtype, torch.float32))
            if self.mesh is None:
                mean = x32.mean(dim=reduce)
                mean2 = torch.square(x32).mean(dim=reduce)
            else:
                mean, mean2 = self._global_moments(x32, reduce)
            var = torch.clamp_min(mean2 - torch.square(mean), 0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(
                    mean.detach() * (1.0 - self.momentum))
                self.var.mul_(self.momentum).add_(
                    var.detach() * (1.0 - self.momentum))
        else:
            mean, var = self.mean, self.var
        y = x - mean.reshape(shape)
        mul = torch.rsqrt(var + self.epsilon)
        if self.weight is not None:
            mul = mul * self.weight
        y = y * mul.reshape(shape)
        if self.bias is not None:
            y = y + self.bias.reshape(shape)
        return y.to(x.dtype)

    def _global_moments(self, x32: torch.Tensor, reduce):
        """E[x] and E[x^2] over every data x fsdp shard's batch."""
        count = x32.new_full((1,), x32.numel() // self.features)
        sums = collectives.psum_data_shards(
            torch.cat([x32.sum(dim=reduce), torch.square(x32).sum(dim=reduce), count]),
            self.mesh)
        total = sums[-1]
        return sums[:self.features] / total, sums[self.features:-1] / total

    def extra_repr(self) -> str:
        return (f"{self.features}, momentum={self.momentum}, "
                f"epsilon={self.epsilon}, use_scale={self.weight is not None}")
