"""Assertions and the gin-config smoke harness for trainer outputs.

Port of tensor2robot_tpu/utils/train_eval_test_utils.py: every shipped
gin config must run for a few steps and leave the standard artifacts.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

from tensor2robot_tpu_torch import config as cfg


def assert_output_files(model_dir: str,
                        expected_output_filename_patterns: Optional[Sequence[str]] = None
                        ) -> None:
    """Asserts the trainer's artifacts exist: checkpoints, the operative
    config and the train metric stream by default."""
    if expected_output_filename_patterns is None:
        expected_output_filename_patterns = [
            "checkpoints/*", "operative_config.gin", "train/metrics.jsonl"]
    for pattern in expected_output_filename_patterns:
        matches = glob.glob(os.path.join(model_dir, pattern))
        assert matches, (
            f"No files match {pattern!r} under {model_dir}; contents: "
            f"{sorted(glob.glob(os.path.join(model_dir, '**'), recursive=True))}")


def test_train_eval_gin(model_dir: str, full_gin_path: str, max_train_steps: int = 3,
                        eval_steps: int = 2, gin_overwrites_fn=None,
                        assert_train_output_files: bool = True) -> None:
    """Runs a shipped gin config for a few steps (the port's defaults are
    registered first, as the configs' own import line does)."""
    import tensor2robot_tpu_torch.config.defaults  # noqa: F401

    cfg.clear_config()
    try:
        cfg.parse_config_files_and_bindings([full_gin_path], [])
        if gin_overwrites_fn is not None:
            gin_overwrites_fn()
        cfg.bind_parameter("train_eval_model.model_dir", model_dir)
        cfg.bind_parameter("train_eval_model.max_train_steps", max_train_steps)
        cfg.bind_parameter("train_eval_model.eval_steps", eval_steps)
        cfg.get_configurable("train_eval_model")()
        if assert_train_output_files:
            assert_output_files(model_dir)
    finally:
        cfg.clear_config()
