"""Continuous evaluation: a standalone process tailing a trainer's output.

Port of tensor2robot_tpu/train/continuous_eval.py. The learner and the
eval job are two processes that share only model_dir:
`wait_for_new_checkpoint` polls the trainer's `checkpoints/` for durable
steps (train/durability.py: a `.tmp` in flight or a torn file is never
taken); each new step is copied with its manifest into
`current_eval_checkpoint/` and verified there (with retries: the trainer's
keep_checkpoint_max GC can delete a step mid-copy), restored onto this
process's device, evaluated on every named eval set (per-name metric
streams under eval_<name>/) and handed to the exporters.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Any, Callable, Dict, Optional, Union

import torch

from tensor2robot_tpu_torch.models.abstract_model import MODE_EVAL
from tensor2robot_tpu_torch.train import durability
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train.metrics import MetricsWriter
from tensor2robot_tpu_torch.train.state import TrainState
from tensor2robot_tpu_torch.train.train_eval import (
    Trainer,
    eval_dir_name,
    maybe_wrap_for_tpu,
    normalize_eval_generators,
    run_named_evals,
)
from tensor2robot_tpu_torch.utils.device import DEFAULT_DEVICE

BACKUP_NAME = "current_eval_checkpoint"

def wait_for_new_checkpoint(
    model_dir: str,
    last_step: Optional[int] = None,
    timeout: float = 600.0,
    poll_interval: float = 2.0,
) -> Optional[int]:
    """Blocks until a durable checkpoint newer than last_step exists;
    returns the newest such step, or None on timeout."""
    deadline = time.time() + timeout
    while True:
        fresh = [s for s in durability.durable_steps(model_dir)
                 if last_step is None or s > last_step]
        if fresh:
            return fresh[-1]
        if time.time() >= deadline:
            return None
        time.sleep(poll_interval)


def backup_checkpoint_for_eval(
    model_dir: str,
    step: int,
    backup_name: str = BACKUP_NAME,
    retries: int = 3,
) -> Optional[str]:
    """Copies checkpoint `step` (with its manifest) into
    model_dir/<backup_name>/checkpoints/ and verifies the copy.

    Returns the backup root (a model_dir holding exactly this step), or
    None when the checkpoint vanished or kept failing to verify (the GC
    won the race): callers move on to a newer step."""
    source = state_lib.checkpoint_path(model_dir, step)
    source_manifest = state_lib.manifest_path(model_dir, step)
    backup_root = os.path.join(os.path.abspath(model_dir), backup_name)
    dest_dir = state_lib.checkpoint_dir(backup_root)
    for attempt in range(retries):
        if not os.path.isfile(source):
            return None
        shutil.rmtree(dest_dir, ignore_errors=True)  # one backup at a time
        os.makedirs(dest_dir)
        try:
            if os.path.exists(source_manifest):
                shutil.copyfile(source_manifest,
                                state_lib.manifest_path(backup_root, step))
            shutil.copyfile(source, state_lib.checkpoint_path(backup_root, step))
            durability.read_verified(backup_root, step)
            return backup_root
        except (OSError, durability.TornCheckpoint) as err:
            logging.warning("Backup of step %d failed (attempt %d): %s",
                            step, attempt + 1, err)
            time.sleep(0.5 * (attempt + 1))
    shutil.rmtree(dest_dir, ignore_errors=True)
    return None


def restore_state_from_backup(backup_root: str, step: int, trainer: Trainer) -> TrainState:
    """A TrainState restored from a backed-up checkpoint root."""
    state = trainer.init_state()
    state.restore(durability.load_durable(backup_root, step, map_location=trainer.device))
    return state


def continuous_eval(
    t2r_model,
    model_dir: str,
    input_generator_eval: Union[Any, Dict[str, Any], None] = None,
    eval_steps: Optional[int] = 100,
    max_train_steps: Optional[int] = None,
    create_exporters_fn: Optional[Callable] = None,
    timeout: float = 600.0,
    poll_interval: float = 2.0,
    mesh=None,
    use_ema_for_eval: Optional[bool] = None,
    use_backup: bool = True,
    device: Union[str, torch.device] = DEFAULT_DEVICE,
) -> Dict[str, float]:
    """Tails model_dir's checkpoints, evaluating (and exporting) each one.

    Runs until the evaluated step reaches max_train_steps or no new
    checkpoint appears within `timeout`. Returns the last eval metrics.
    `input_generator_eval` may be a {name: generator} map: each name gets
    its own metric stream under model_dir/eval_<name>/."""
    model = maybe_wrap_for_tpu(t2r_model)
    trainer = Trainer(model, device=device, mesh=mesh)
    if use_ema_for_eval is None:
        use_ema_for_eval = model.use_avg_model_params
    eval_generators = normalize_eval_generators(input_generator_eval)
    if not eval_generators:
        raise ValueError("continuous_eval requires at least one eval generator.")
    for generator in eval_generators.values():
        generator.set_specification_from_model(model, MODE_EVAL)
    writers = {
        name: MetricsWriter(os.path.join(model_dir, eval_dir_name(name)))
        for name in eval_generators
    }
    exporters = (
        create_exporters_fn(model) if create_exporters_fn is not None else []
    )
    last_step: Optional[int] = None
    last_metrics: Dict[str, float] = {}
    try:
        while True:
            print(f"continuous_eval: waiting for a checkpoint newer than "
                  f"{last_step} under {model_dir}", flush=True)
            step = wait_for_new_checkpoint(
                model_dir, last_step, timeout=timeout, poll_interval=poll_interval
            )
            if step is None:
                break  # the trainer stopped producing checkpoints
            if use_backup:
                restore_root = backup_checkpoint_for_eval(model_dir, step)
                if restore_root is None:
                    last_step = step  # the GC won the race; wait for a newer one
                    continue
            else:
                restore_root = model_dir
            try:
                state = restore_state_from_backup(restore_root, step, trainer)
            except durability.TornCheckpoint as err:
                logging.warning("Skipping step %d: %s", step, err)
                last_step = step
                continue
            metrics = run_named_evals(
                trainer, state, eval_generators, eval_steps=eval_steps,
                use_ema=use_ema_for_eval, step=step, writers=writers,
            )
            for exporter in exporters:
                exporter.maybe_export(
                    step=step, state=state, eval_metrics=metrics,
                    compiled=trainer, model_dir=model_dir,
                )
            print(f"continuous_eval: step {step}: {metrics}", flush=True)
            last_metrics = metrics
            last_step = step
            if max_train_steps is not None and step >= max_train_steps:
                break
    finally:
        for writer in writers.values():
            writer.close()
    return last_metrics
