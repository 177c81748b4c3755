"""Golden-value capture: the regression harness over tagged tensors.

Port of tensor2robot_tpu/hooks/golden_values_hook_builder.py. Models tag
tensors by putting them into their train metrics under `golden/<name>`
(`add_golden_tensor`); the hook copies them to the host every step and
writes `golden_values.npy` at train end. Under grad_accum_steps the
trainer concatenates a golden tensor's microbatch slices back into the
full batch.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List

import numpy as np
import torch

from tensor2robot_tpu_torch.config import configurable
from tensor2robot_tpu_torch.hooks.hook_builder import Hook, HookBuilder
from tensor2robot_tpu_torch.train.metrics import GOLDEN_PREFIX

GOLDEN_VALUES_FILENAME = "golden_values.npy"


def add_golden_tensor(metrics: Dict[str, Any], tensor, name: str) -> None:
    """Tags `tensor` for golden capture; call from model_train_fn on its
    metrics dict."""
    metrics[GOLDEN_PREFIX + name] = tensor


class GoldenValuesHook(Hook):
    """Records tagged tensors every step and saves golden_values.npy at
    the end. Reads the device every step: a test harness, not a
    production hook."""

    def __init__(self, log_directory: str):
        self._log_directory = log_directory
        self._measurements: List[Dict[str, np.ndarray]] = []

    def after_step(self, ctx) -> None:
        if not ctx.device_metrics:
            return
        golden = {
            key[len(GOLDEN_PREFIX):]: _host(value)
            for key, value in ctx.device_metrics.items()
            if key.startswith(GOLDEN_PREFIX)
        }
        if golden:
            self._measurements.append(golden)

    def on_train_end(self, ctx) -> None:
        directory = self._log_directory or ctx.model_dir
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, GOLDEN_VALUES_FILENAME)
        np.save(path, np.asarray(self._measurements, dtype=object))
        logging.info(
            "Saved %d golden-value steps to %s", len(self._measurements), path
        )


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()
    return np.asarray(value)


def load_golden_values(log_directory: str) -> List[Dict[str, np.ndarray]]:
    """Loads the measurements list written by GoldenValuesHook."""
    path = os.path.join(log_directory, GOLDEN_VALUES_FILENAME)
    return list(np.load(path, allow_pickle=True))


@configurable("GoldenValuesHookBuilder")
class GoldenValuesHookBuilder(HookBuilder):
    """Golden values into `log_directory` (model_dir when empty)."""

    def __init__(self, log_directory: str = ""):
        self._log_directory = log_directory

    def create_hooks(self, t2r_model, trainer=None) -> List[Hook]:
        return [GoldenValuesHook(self._log_directory)]
