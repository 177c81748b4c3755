"""Default warm start: a partial restore from another model's checkpoint.

Port of tensor2robot_tpu/models/checkpoint_init.py over the port's
checkpoints (`<model_dir>/checkpoints/<step>.pt`, train/state.py):

    model = MyModel(init_from_checkpoint_fn=default_init_from_checkpoint_fn(
        "/path/to/other/model_dir",
        assignment_map={"encoder.": "tower."},  # dest prefix -> src prefix
        allow_partial_restore=True,
    ))

Entries are matched by state-dict key (`Dense_0.weight`,
`BatchNorm_0.mean`; buffers included). Entries present in both (after the
prefix rewrite) with matching shapes are taken from the checkpoint, cast
to the destination dtype; everything else keeps its fresh initialization.
A missing entry raises unless allow_partial_restore; a shape mismatch
always raises (keeping a mis-shaped entry would corrupt the warm start).
The checkpoint is read durable only (train/durability.py).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from tensor2robot_tpu_torch.train import durability
from tensor2robot_tpu_torch.train import state as state_lib


def _model_dir_and_step(checkpoint_path: str, step: Optional[int]) -> Tuple[str, int]:
    """Accepts a model_dir, its checkpoints directory, or a `<step>.pt`."""
    path = os.path.abspath(checkpoint_path)
    if os.path.isfile(path):
        base, ext = os.path.splitext(os.path.basename(path))
        if ext != ".pt" or not base.isdigit():
            raise FileNotFoundError(f"{checkpoint_path!r} is not a <step>.pt checkpoint")
        if step is not None and step != int(base):
            raise FileNotFoundError(
                f"Requested step {step} but {checkpoint_path!r} is step {base}.")
        return os.path.dirname(os.path.dirname(path)), int(base)
    if os.path.basename(path) == state_lib.CHECKPOINT_SUBDIR:
        path = os.path.dirname(path)
    steps = durability.durable_steps(path)
    if not steps:
        raise FileNotFoundError(f"No durable checkpoint under {checkpoint_path!r}")
    if step is None:
        return path, steps[-1]
    if step not in steps:
        raise FileNotFoundError(
            f"Step {step} not in {steps} under {checkpoint_path!r}")
    return path, step


def load_checkpoint_variables(
    checkpoint_path: str, step: Optional[int] = None, use_ema: bool = False,
) -> Dict[str, torch.Tensor]:
    """A checkpoint's network state dict (parameters and buffers). use_ema
    swaps the averaged parameters in (warm starts then take the averaged
    weights, as the swapping saver did)."""
    model_dir, resolved = _model_dir_and_step(checkpoint_path, step)
    checkpoint = durability.load_durable(model_dir, resolved)
    variables = dict(checkpoint["params"])
    if use_ema:
        if checkpoint.get("ema_params") is None:
            raise ValueError(
                f"use_ema=True but checkpoint {checkpoint_path!r} holds no "
                "ema_params (trained without use_avg_model_params).")
        variables.update(checkpoint["ema_params"])
    return variables


def _rewrite(path: str, assignment_map: Optional[Mapping[str, Optional[str]]]) -> Optional[str]:
    """Maps a destination key to its source key by the longest matching
    prefix; a prefix mapped to None keeps the fresh init."""
    if not assignment_map:
        return path
    for dest_prefix in sorted(assignment_map, key=len, reverse=True):
        if path.startswith(dest_prefix):
            src_prefix = assignment_map[dest_prefix]
            if src_prefix is None:
                return None
            return src_prefix + path[len(dest_prefix):]
    return path


def default_init_from_checkpoint_fn(
    checkpoint_path: str,
    step: Optional[int] = None,
    assignment_map: Optional[Mapping[str, Optional[str]]] = None,
    filter_restorables_fn: Optional[Callable[[str], bool]] = None,
    allow_partial_restore: bool = False,
    use_ema: bool = False,
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Builds an init_from_checkpoint_fn for AbstractT2RModel.

    Args:
      checkpoint_path: another model_dir, its checkpoints dir or a step file.
      step: a specific step (default: the newest durable one).
      assignment_map: destination-prefix -> source-prefix rewrites of
        state-dict keys; a None source keeps that subtree's fresh init.
      filter_restorables_fn: key -> bool; False keeps the fresh init.
      allow_partial_restore: tolerate entries missing from the checkpoint.
      use_ema: restore the averaged parameters.
    """

    def init_fn(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        source = load_checkpoint_variables(checkpoint_path, step=step, use_ema=use_ema)
        out, missing = {}, []
        for path, leaf in state_dict.items():
            out[path] = leaf
            if filter_restorables_fn is not None and not filter_restorables_fn(path):
                continue
            source_path = _rewrite(path, assignment_map)
            if source_path is None:
                continue
            if source_path not in source:
                missing.append(f"{path} (from {source_path})")
                continue
            value = source[source_path]
            if tuple(value.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"Warm-start shape mismatch for {path!r}: checkpoint "
                    f"{tuple(value.shape)} vs model {tuple(leaf.shape)}")
            out[path] = value.to(dtype=leaf.dtype, device=leaf.device)
        if missing and not allow_partial_restore:
            raise KeyError(
                "Warm-start entries missing from checkpoint (pass "
                f"allow_partial_restore=True to keep their init): {missing[:10]}")
        return out

    return init_fn
