"""TrainState and checkpoints: the complete training snapshot.

Port of tensor2robot_tpu/train/state.py. A TrainState holds the step, the
network (its parameters), the optimizer bound to them and — when the
model asks for moving-average parameters — an EMA copy of the parameters
(the JAX package's replacement for the swapping saver). Checkpoints keep
both raw and averaged parameters; serving and eval select the EMA.

Checkpoints live where the JAX trainer keeps them, under
`<model_dir>/checkpoints/`, one file `<step>.pt` per saved step holding
{step, params, ema_params, optimizer}; `params` is the network's state
dict, buffers (batch-norm statistics) included, and `ema_params` covers
the parameters only. Each is written under a temporary name, fsynced,
renamed into place and the directory fsynced, so a crash leaves either
the whole file under its final name or none; the directory is pruned to
the newest `keep_checkpoint_max` (each with its durability manifest,
`<step>.durable.json`, train/durability.py). Readers take durable steps
only: a copy or a disk can tear a file after it was written.

Two trainer regimes keep the EMA flat, as the JAX package does: one
vector of the parameters raveled in `named_parameters` order
(flatten_optimizer_update; one fused update a step), or that vector
padded to the quantized ZeRO-2 step's block layout (the padded tail never
moves). Such a checkpoint stores the flat vector with `ema_names`, the
parameters it ravels; `ema_as_tree` and `checkpoint_ema` give every
reader (eval, export, predictors, warm starts) the tree back. Over a pipe
dim the flat vector holds the rank's stage entries and the shared ones
(`ema_as_tree` cuts it by that rank's parameters), and the checkpoint
holds it as a tree, its stage entries stacked over pipe. The
quantized ZeRO-2 regime's checkpoints also hold its error-feedback
residuals (`collective_residual`).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import torch
from torch import nn

CHECKPOINT_SUBDIR = "checkpoints"
_CHECKPOINT = re.compile(r"^(\d+)\.pt$")
MANIFEST_SUFFIX = ".durable.json"


def init_ema(network: nn.Module) -> Dict[str, torch.Tensor]:
    """The EMA's starting point: a copy of the network's parameters."""
    return {
        name: p.detach().clone() for name, p in network.named_parameters()
    }


EMA = Union[Dict[str, torch.Tensor], torch.Tensor]


def ema_as_tree(ema: Optional[EMA], template) -> Optional[Dict[str, torch.Tensor]]:
    """The EMA as {parameter name: tensor}, whatever its stored layout. A
    flat EMA (a 1-D tensor) is cut in the order and the shapes of
    `template` (a network's parameters, or a mapping of them); a tail past
    their total is the block layout's padding and is dropped. A tree EMA
    passes as it is."""
    if not isinstance(ema, torch.Tensor):
        return ema
    if isinstance(template, nn.Module):
        template = dict(template.named_parameters())
    out, offset = {}, 0
    for name, leaf in template.items():
        out[name] = ema[offset:offset + leaf.numel()].view(leaf.shape)
        offset += leaf.numel()
    if offset > ema.numel():
        raise ValueError(f"flat EMA of {ema.numel()} elements cannot hold "
                         f"the {offset} of its parameters")
    return out


def checkpoint_ema(checkpoint: Mapping[str, Any]) -> Optional[Dict[str, torch.Tensor]]:
    """A checkpoint's EMA as a tree: a flat one is cut by its `ema_names`
    in the shapes of those entries of `params`."""
    ema = checkpoint.get("ema_params")
    if not isinstance(ema, torch.Tensor):
        return ema
    params = checkpoint["params"]
    return ema_as_tree(ema, {name: params[name] for name in checkpoint["ema_names"]})


def update_ema(ema_params: EMA, new_params: Union[Mapping[str, torch.Tensor], torch.Tensor],
               decay: float) -> EMA:
    """One EMA step: e * decay + p * (1 - decay), the JAX package's
    formula, leaf by leaf, or as one fused update of a flat EMA (then
    `new_params` is the flat parameter vector). Returns new tensors; the
    inputs are not changed."""
    with torch.no_grad():
        if isinstance(ema_params, torch.Tensor):
            return ema_params * decay + new_params.detach().to(ema_params.dtype) * (1.0 - decay)
        return {
            name: e * decay + new_params[name].detach().to(e.dtype) * (1.0 - decay)
            for name, e in ema_params.items()
        }


@dataclasses.dataclass
class TrainState:
    step: int
    network: nn.Module
    optimizer: torch.optim.Optimizer
    #: {name: tensor}, or one flat vector (module docstring).
    ema_params: Optional[EMA] = None
    #: The quantized ZeRO-2 step's error-feedback residuals: {"grad":
    #: [1, padded] (this rank's untransmitted gradient remainder), "update":
    #: [shard_len] (its shard's untransmitted update remainder)}; None in
    #: every other regime.
    collective_residual: Optional[Dict[str, torch.Tensor]] = None
    #: How the optimizer's parameters map onto the network's in the flat
    #: and ZeRO-2 regimes (train/train_eval.py); None: they are the same.
    weight_update: Any = None

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.network.named_parameters())

    def export_state_dict(self, use_ema: bool = False) -> Dict[str, torch.Tensor]:
        """The network's state dict to serve or evaluate: EMA parameters
        when present and requested (a flat EMA cut into the tree), the raw
        ones otherwise."""
        state = {k: v.detach() for k, v in self.network.state_dict().items()}
        if use_ema and self.ema_params is not None:
            state.update(ema_as_tree(self.ema_params, self.network))
        return state

    def restore(self, checkpoint: Mapping[str, Any]) -> None:
        """Loads a checkpoint written by save_checkpoint in place (one
        saved without an optimizer state leaves the optimizer's as is). A
        flat EMA on disk restores into a tree EMA (ema_names); a flat live
        EMA takes a flat one only, and a state with residuals takes a
        checkpoint that has them only: those layouts do not interchange
        with the tree's."""
        self.network.load_state_dict(checkpoint["params"])
        if checkpoint.get("optimizer") is not None:
            self.optimizer.load_state_dict(checkpoint["optimizer"])
        ema = checkpoint.get("ema_params")
        if (ema is None) != (self.ema_params is None):
            raise ValueError(
                "checkpoint and model disagree on use_avg_model_params"
            )
        if isinstance(self.ema_params, torch.Tensor):
            if not isinstance(ema, torch.Tensor):
                raise ValueError("a flat EMA cannot restore from a checkpoint "
                                 "whose EMA is a tree")
            self.ema_params = ema.to(self.ema_params.device)
        elif ema is not None:
            device = next(iter(self.ema_params.values())).device
            self.ema_params = {k: v.to(device)
                               for k, v in checkpoint_ema(checkpoint).items()}
        if self.collective_residual is not None:
            residual = checkpoint.get("collective_residual")
            if residual is None:
                raise ValueError(
                    "the quantized ZeRO-2 state restores from a checkpoint of "
                    "the same regime only (it holds no collective_residual)")
            self.collective_residual = {
                k: v.to(self.collective_residual[k].device) for k, v in residual.items()}
        self.step = int(checkpoint["step"])


# -- checkpoint files -----------------------------------------------------------


def checkpoint_dir(model_dir: str) -> str:
    return os.path.join(model_dir, CHECKPOINT_SUBDIR)


def checkpoint_path(model_dir: str, step: int) -> str:
    return os.path.join(checkpoint_dir(model_dir), f"{int(step)}.pt")


def manifest_path(model_dir: str, step: int) -> str:
    """Where train/durability.py publishes the step's manifest."""
    return os.path.join(checkpoint_dir(model_dir), f"{int(step)}{MANIFEST_SUFFIX}")


def checkpoint_steps(model_dir: str) -> List[int]:
    """The steps with a checkpoint under model_dir, ascending."""
    directory = checkpoint_dir(model_dir)
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(match.group(1))
        for match in map(_CHECKPOINT.match, os.listdir(directory))
        if match
    )


def latest_checkpoint_step(model_dir: str) -> Optional[int]:
    steps = checkpoint_steps(model_dir)
    return steps[-1] if steps else None


def _fsync_dir(directory: str) -> None:
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_checkpoint(
    model_dir: str,
    step: int,
    params: Mapping[str, torch.Tensor],
    ema_params: Optional[Mapping[str, torch.Tensor]] = None,
    optimizer: Optional[Mapping[str, Any]] = None,
    keep_checkpoint_max: Optional[int] = None,
    ema_names: Optional[Sequence[str]] = None,
    collective_residual: Optional[Mapping[str, torch.Tensor]] = None,
) -> str:
    """Writes `<model_dir>/checkpoints/<step>.pt` through a temporary name,
    fsynced before an atomic rename and the directory fsynced after it,
    then removes all but the newest `keep_checkpoint_max` checkpoints
    (None keeps all). A flat `ema_params` (a tensor) needs `ema_names`,
    the parameters it ravels; `collective_residual` is the quantized
    ZeRO-2 step's. Returns the path."""
    os.makedirs(checkpoint_dir(model_dir), exist_ok=True)
    path = checkpoint_path(model_dir, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    flat = isinstance(ema_params, torch.Tensor)
    if flat and ema_names is None:
        raise ValueError("a flat EMA is saved with ema_names")
    record = {
        "step": int(step),
        "params": dict(params),
        "ema_params": ema_params if ema_params is None or flat else dict(ema_params),
        "optimizer": optimizer,
    }
    if flat:
        record["ema_names"] = list(ema_names)
    if collective_residual is not None:
        record["collective_residual"] = dict(collective_residual)
    with open(tmp, "wb") as f:
        torch.save(record, f)
        f.flush()
        os.fsync(f.fileno())
    # A manifest left by an earlier file of this step would not describe
    # this one (train/durability.py publishes the new file's).
    if os.path.exists(manifest_path(model_dir, step)):
        os.remove(manifest_path(model_dir, step))
    os.replace(tmp, path)
    _fsync_dir(checkpoint_dir(model_dir))
    if keep_checkpoint_max is not None:
        for old in checkpoint_steps(model_dir)[:-keep_checkpoint_max]:
            if os.path.exists(manifest_path(model_dir, old)):
                os.remove(manifest_path(model_dir, old))
            os.remove(checkpoint_path(model_dir, old))
    return path


def load_checkpoint(
    model_dir: str, step: Optional[int] = None, map_location: Any = "cpu"
) -> Dict[str, Any]:
    """Reads the checkpoint of `step` (the newest when None)."""
    if step is None:
        step = latest_checkpoint_step(model_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {checkpoint_dir(model_dir)}")
    return torch.load(
        checkpoint_path(model_dir, step), map_location=map_location,
        weights_only=True,
    )
