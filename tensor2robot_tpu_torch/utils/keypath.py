"""Flax-style variable paths of a torch module's parameters.

Port of tensor2robot_tpu/utils/keypath.py. The JAX package addresses a
parameter by the '/'-joined path of its flax params tree
('pose_net/pose_fc0/kernel'); MAML's `var_scope` and the learned inner
learning rates are keyed by that path, so one gin string selects the same
parameters in both packages. The port names its modules as the flax modules
are named, so the path is the torch name with '/' for '.' and the flax leaf
name for torch's: a Linear or Conv weight is flax's `kernel`, a norm's
weight its `scale` (the inverse of utils/jax_params.py's rules).
"""

from __future__ import annotations

from typing import Dict, Iterable

from torch import nn

from tensor2robot_tpu_torch.layers.batch_norm import BatchNorm
from tensor2robot_tpu_torch.layers.s2d_conv import SpaceToDepthConv
from tensor2robot_tpu_torch.research.dql_grasping_lib.tf_modules import FlaxLayerNorm

_KERNEL_OWNERS = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d, SpaceToDepthConv)
_SCALE_OWNERS = (FlaxLayerNorm, BatchNorm, nn.LayerNorm)


def path_string(parts: Iterable) -> str:
    """'/'-joins path entries: ('params', 'dense', 'kernel') ->
    'params/dense/kernel'."""
    return "/".join(str(part) for part in parts)


def flax_parameter_paths(module: nn.Module) -> Dict[str, str]:
    """{torch parameter name: flax path} for every parameter of `module`,
    in named_parameters order."""
    paths = {}
    for name, _ in module.named_parameters():
        *owner_path, leaf = name.split(".")
        owner = module.get_submodule(".".join(owner_path))
        if leaf == "weight" and isinstance(owner, _KERNEL_OWNERS):
            leaf = "kernel"
        elif leaf == "weight" and isinstance(owner, _SCALE_OWNERS):
            leaf = "scale"
        paths[name] = path_string(owner_path + [leaf])
    return paths
