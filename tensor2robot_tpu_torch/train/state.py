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
the newest `keep_checkpoint_max`. Readers still skip a final name that
does not load (predictors/checkpoint_predictor.py): a copy or a disk
can tear a file after it was written. The JAX package's manifests and
quarantine sweep (train/durability.py there) are not ported.

The flat (one concatenated vector) EMA layout of the JAX package's
flatten_optimizer_update regime is not ported (ROADMAP.md A9).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, List, Mapping, Optional

import torch
from torch import nn

CHECKPOINT_SUBDIR = "checkpoints"
_CHECKPOINT = re.compile(r"^(\d+)\.pt$")


def init_ema(network: nn.Module) -> Dict[str, torch.Tensor]:
    """The EMA's starting point: a copy of the network's parameters."""
    return {
        name: p.detach().clone() for name, p in network.named_parameters()
    }


def update_ema(
    ema_params: Mapping[str, torch.Tensor],
    new_params: Mapping[str, torch.Tensor],
    decay: float,
) -> Dict[str, torch.Tensor]:
    """One EMA step, leaf by leaf: e * decay + p * (1 - decay), the JAX
    package's formula. Returns new tensors; the inputs are not changed."""
    with torch.no_grad():
        return {
            name: e * decay + new_params[name].detach().to(e.dtype) * (1.0 - decay)
            for name, e in ema_params.items()
        }


@dataclasses.dataclass
class TrainState:
    step: int
    network: nn.Module
    optimizer: torch.optim.Optimizer
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.network.named_parameters())

    def export_state_dict(self, use_ema: bool = False) -> Dict[str, torch.Tensor]:
        """The network's state dict to serve or evaluate: EMA parameters
        when present and requested, the raw ones otherwise."""
        state = {k: v.detach() for k, v in self.network.state_dict().items()}
        if use_ema and self.ema_params is not None:
            state.update(self.ema_params)
        return state

    def restore(self, checkpoint: Mapping[str, Any]) -> None:
        """Loads a checkpoint written by save_checkpoint in place."""
        self.network.load_state_dict(checkpoint["params"])
        self.optimizer.load_state_dict(checkpoint["optimizer"])
        ema = checkpoint.get("ema_params")
        if (ema is None) != (self.ema_params is None):
            raise ValueError(
                "checkpoint and model disagree on use_avg_model_params"
            )
        if ema is not None:
            device = next(iter(self.ema_params.values())).device
            self.ema_params = {k: v.to(device) for k, v in ema.items()}
        self.step = int(checkpoint["step"])


# -- checkpoint files -----------------------------------------------------------


def checkpoint_dir(model_dir: str) -> str:
    return os.path.join(model_dir, CHECKPOINT_SUBDIR)


def checkpoint_path(model_dir: str, step: int) -> str:
    return os.path.join(checkpoint_dir(model_dir), f"{int(step)}.pt")


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
) -> str:
    """Writes `<model_dir>/checkpoints/<step>.pt` through a temporary name,
    fsynced before an atomic rename and the directory fsynced after it,
    then removes all but the newest `keep_checkpoint_max` checkpoints
    (None keeps all). Returns the path."""
    os.makedirs(checkpoint_dir(model_dir), exist_ok=True)
    path = checkpoint_path(model_dir, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        torch.save(
            {
                "step": int(step),
                "params": dict(params),
                "ema_params": None if ema_params is None else dict(ema_params),
                "optimizer": optimizer,
            },
            f,
        )
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(checkpoint_dir(model_dir))
    if keep_checkpoint_max is not None:
        for old in checkpoint_steps(model_dir)[:-keep_checkpoint_max]:
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
