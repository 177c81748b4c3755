"""Parameters sharded over the fsdp and model dims: the trainer's
sharded_params regime, per rank.

The JAX package has no such module: its CompiledModel places every
parameter by mesh.param_sharding and GSPMD partitions the step, inserting
the per-layer collectives. The port is one process per rank with no
partitioner, so this module does that partitioner's work on the
nn.Module the trainer holds:

  * `shard_network` turns each parameter the rule shards
    (mesh.param_sharding: the column split of a kernel's output dim over
    model, ZeRO-3 over fsdp on its largest other divisible dim) into an
    nn.Parameter of this rank's shard, under its own name: real memory,
    so the optimizer's moments and the EMA exist for the shard only. The
    returned layout is {name: (model dim, fsdp dim)}, torch dims.
  * A Linear or Conv whose weight's model dim is its output dim computes
    its rank's output channels from the whole input and gathers them
    (collectives.gather_from, Megatron's g: its backward is this rank's
    slice of the cotangent, which every model rank holds whole), its
    input passing through collectives.copy_to (Megatron's f: the backward
    sums the partial input cotangents over model). The weight's fsdp
    shards are gathered first. Its bias is added after the gather, whole:
    a bias sliced before it would get no gradient from the other ranks'
    columns.
  * Every other sharded parameter is gathered on use, in its own module's
    forward: over fsdp by collectives.all_gather, whose backward
    reduce-scatters (each fsdp rank's cotangent comes from its own batch
    shard, and the gradient is their sum), then over model by
    gather_from (the transformer's pos_embedding [T, E], split on E).
    The gathered tensor shadows the parameter in the module's __dict__
    for that forward only (a remat recompute gathers again); a parameter
    read outside its module's forward would be read as its shard.
  * `full_tensor` gathers one sharded entry whole (the trainer's
    checkpoint_state gathers every parameter, moment and EMA entry with
    it, for the checkpoint and for rank 0's exports and hooks),
    `full_grads` a network's gradients, and `local_tensor` cuts a whole
    entry to this rank's shard (a resume); `whole_shape` is a shard's
    whole shape.

Attention runs over all heads on every model rank: the fused qkv [3E, E]
splits its 3E outputs, which do not fall on head boundaries, and the
gathered output feeds the whole attention (the sequence-parallel ring or
Ulysses over this rank's tokens, where the mesh has a sequence dim).
Splitting heads over the model ranks is not ported (ROADMAP.md A9.4c).
Beside pipeline stages (a pipe dim above 1) the stages' blocks stay whole
on every rank of their stage, and only the entries outside the stages
(the embed, the positional table, the head) are sharded.

A network whose forward takes its parameters functionally
(`takes_sharded_params = False`: MAML, whose inner loop runs
torch.func.functional_call of the base network on adapted tensors) gets
its shards and no forward hooks and never the column split: its forward
reads `gathered_parameters`, every sharded leaf gathered whole once by
the same differentiable gather as a gather on use, and runs on whole
tensors. The outer gradient comes back to the shards through the
gather's backward (psum_scatter over fsdp, this rank's slice over
model), so the trainer reduces it as it reduces any sharded leaf's. The
JAX package writes no mesh code for MAML: GSPMD gathers its placed
leaves inside the inner loop.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib

#: {state-dict name: (model dim, fsdp dim)} of the sharded parameters.
Layout = Dict[str, Tuple[Optional[int], Optional[int]]]

_COLUMN_LAYERS = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)


def _cuts(dims: Tuple[Optional[int], Optional[int]]):
    """[(mesh dim, tensor dim)] of a leaf's cuts, fsdp first."""
    model_dim, fsdp_dim = dims
    cuts = []
    if fsdp_dim is not None:
        cuts.append((mesh_lib.FSDP_AXIS, fsdp_dim))
    if model_dim is not None:
        cuts.append((mesh_lib.MODEL_AXIS, model_dim))
    return cuts


def local_tensor(whole: torch.Tensor, dims, mesh) -> torch.Tensor:
    """This rank's shard of a whole leaf (a view): chunk i of each cut
    dim, i this rank's index along the mesh dim that cuts it."""
    for axis_name, axis in _cuts(dims):
        size = mesh_lib.axis_size(mesh, axis_name)
        index = collectives.axis_index(mesh, axis_name)
        width = whole.shape[axis] // size
        whole = whole.narrow(axis, index * width, width)
    return whole


def whole_shape(shard: torch.Tensor, dims, mesh) -> Tuple[int, ...]:
    """The whole leaf's shape, from its shard's."""
    shape = list(shard.shape)
    for axis_name, axis in _cuts(dims):
        shape[axis] *= mesh_lib.axis_size(mesh, axis_name)
    return tuple(shape)


def full_tensor(shard: torch.Tensor, dims, mesh) -> torch.Tensor:
    """The whole leaf from every rank's shard (a collective; no autograd)."""
    return collectives.gather_dims(shard, mesh, _cuts(dims))


def _gathered(shard: torch.Tensor, dims, mesh) -> torch.Tensor:
    """The whole leaf for a forward, differentiable: gathered over fsdp
    (backward: psum_scatter) and over model (backward: this rank's
    slice)."""
    model_dim, fsdp_dim = dims
    whole = shard
    if fsdp_dim is not None:
        whole = collectives.all_gather(whole, mesh, mesh_lib.FSDP_AXIS, axis=fsdp_dim)
    if model_dim is not None:
        whole = collectives.gather_from(whole, mesh, mesh_lib.MODEL_AXIS, axis=model_dim)
    return whole


def _column_split(module: nn.Module, mesh, leaves: Layout) -> None:
    """A Linear or Conv's forward over its rank's output channels
    (module docstring)."""
    weight_fsdp = leaves["weight"][1]
    bias_dims = leaves.get("bias")
    channels = -1 if isinstance(module, nn.Linear) else 1

    def forward(x: torch.Tensor) -> torch.Tensor:
        weight = module._parameters["weight"]
        if weight_fsdp is not None:
            weight = collectives.all_gather(weight, mesh, mesh_lib.FSDP_AXIS,
                                            axis=weight_fsdp)
        x = collectives.copy_to(x, mesh, mesh_lib.MODEL_AXIS)
        if isinstance(module, nn.Linear):
            y = F.linear(x, weight)
        else:
            y = module._conv_forward(x, weight, None)
        y = collectives.gather_from(y, mesh, mesh_lib.MODEL_AXIS, axis=channels)
        bias = module._parameters.get("bias")
        if bias is None:
            return y
        if bias_dims is not None:
            bias = _gathered(bias, bias_dims, mesh)
        return y + (bias if channels == -1 else bias.view((-1,) + (1,) * (y.ndim - 2)))

    module.forward = forward


def _gather_on_use(module: nn.Module, mesh, leaves: Layout) -> None:
    """The module's sharded parameters whole for each of its forwards."""

    def gather(mod, args):
        for leaf, dims in leaves.items():
            mod.__dict__[leaf] = _gathered(mod._parameters[leaf], dims, mesh)

    def release(mod, args, output):
        for leaf in leaves:
            mod.__dict__.pop(leaf, None)

    module.register_forward_pre_hook(gather)
    module.register_forward_hook(release, always_call=True)


def shard_network(network: nn.Module, mesh,
                  min_weight_size: int = mesh_lib.MIN_WEIGHT_SIZE) -> Layout:
    """Shards `network` in place over the mesh's fsdp and model dims
    (module docstring), leaves under `min_weight_size` elements whole (the
    trainer's param_min_shard_size); returns the layout ({} on a mesh
    whose fsdp and model dims are 1: the network is left as it is). Over a pipe dim above
    1 a stage entry stays whole (mesh.pipe_stage_param_rule: JAX places
    the stacked stage leaves over pipe and nothing else), so a pipeline
    stage's blocks run as on a mesh without fsdp or model."""
    rule = mesh_lib.pipe_stage_param_rule(mesh,
                                          mesh_lib.param_sharding(mesh, min_weight_size))
    layout: Layout = {}
    for name, p in network.named_parameters():
        dims = rule(name, p)
        if dims not in (mesh_lib.PIPE_AXIS, (None, None)):
            layout[name] = dims
    if not layout:
        return layout
    modules = dict(network.named_modules())
    owners: Dict[str, Layout] = {}
    for name, dims in layout.items():
        owner, _, leaf = name.rpartition(".")
        module = modules[owner]
        whole = module._parameters[leaf]
        module._parameters[leaf] = nn.Parameter(
            local_tensor(whole.detach(), dims, mesh).clone(),
            requires_grad=whole.requires_grad)
        owners.setdefault(owner, {})[leaf] = dims
    if not getattr(network, "takes_sharded_params", True):
        for owner, leaves in owners.items():
            modules[owner]._sharded_leaves = (leaves, mesh)
        return layout
    for owner, leaves in owners.items():
        module = modules[owner]
        weight = leaves.get("weight")
        if type(module) in _COLUMN_LAYERS and weight is not None and weight[0] == 0:
            _column_split(module, mesh, leaves)
        else:
            _gather_on_use(module, mesh, leaves)
    return layout


def gathered_parameters(module: nn.Module) -> Dict[str, torch.Tensor]:
    """{name: parameter} of `module` (a network that takes its parameters
    functionally, or a submodule of one), every leaf shard_network cut
    gathered whole by the differentiable gather (module docstring): a
    collective wherever a leaf is cut. Whole leaves are the parameters
    themselves."""
    out = {}
    for name, p in module.named_parameters():
        owner, _, leaf = name.rpartition(".")
        leaves, mesh = getattr(module.get_submodule(owner), "_sharded_leaves", ({}, None))
        out[name] = _gathered(p, leaves[leaf], mesh) if leaf in leaves else p
    return out


def full_grads(network: nn.Module, layout: Layout, mesh) -> Dict[str, torch.Tensor]:
    """{parameter name: its gradient, whole} (a collective): a sharded
    parameter's gradient shards gathered. None stays None."""
    return {name: None if p.grad is None else
            full_tensor(p.grad, layout[name], mesh) if name in layout else p.grad.detach()
            for name, p in network.named_parameters()}
