"""Test fixture running the port's real trainer on tiny workloads.

Port of tensor2robot_tpu/utils/t2r_test_fixture.py: `random_train`,
`recordio_train` and `random_predict` run `train_eval_model` and
`predict_from_model` for a couple of steps at a tiny batch;
`train_and_check_golden_predictions` trains on fixed records and compares
the golden values it captured against a stored file, so a change between
the data and the checkpoint shows. Everything runs on `device` (the card
by default; tests pass "cpu").
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from tensor2robot_tpu_torch.data.input_generators import (
    DefaultRandomInputGenerator,
    DefaultRecordInputGenerator,
)
from tensor2robot_tpu_torch.hooks.golden_values_hook_builder import (
    GoldenValuesHookBuilder,
    load_golden_values,
)
from tensor2robot_tpu_torch.train import train_eval
from tensor2robot_tpu_torch.utils.device import DEFAULT_DEVICE

TRAIN_STEPS = 2
BATCH_SIZE = 2


class T2RModelFixture:
    """Runs models through the real trainer."""

    def __init__(self, test_case=None, use_tpu: bool = False,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self._test_case = test_case
        self._use_tpu = use_tpu
        self._device = device

    def random_train(self, model, model_dir: str, train_steps: int = TRAIN_STEPS,
                     batch_size: int = BATCH_SIZE, **kwargs) -> Dict[str, float]:
        """Trains on spec-conforming random data."""
        return train_eval.train_eval_model(
            t2r_model=model,
            input_generator_train=DefaultRandomInputGenerator(batch_size=batch_size),
            model_dir=model_dir,
            max_train_steps=train_steps,
            save_checkpoints_steps=max(train_steps, 1),
            log_every_steps=1,
            device=self._device,
            **kwargs,
        )

    def recordio_train(self, model, model_dir: str, file_patterns: Sequence[str],
                       train_steps: int = TRAIN_STEPS, batch_size: int = BATCH_SIZE,
                       **kwargs) -> Dict[str, float]:
        """Trains on record files, shuffled from a fixed seed (golden values
        need the same data order in every run)."""
        return train_eval.train_eval_model(
            t2r_model=model,
            input_generator_train=DefaultRecordInputGenerator(
                file_patterns=list(file_patterns), batch_size=batch_size, seed=0),
            model_dir=model_dir,
            max_train_steps=train_steps,
            save_checkpoints_steps=max(train_steps, 1),
            log_every_steps=1,
            device=self._device,
            **kwargs,
        )

    def random_predict(self, model, model_dir: str, batch_size: int = BATCH_SIZE):
        """One prediction pass over random inputs from the newest checkpoint."""
        generator = DefaultRandomInputGenerator(batch_size=batch_size)
        return next(iter(train_eval.predict_from_model(
            t2r_model=model, input_generator=generator, model_dir=model_dir,
            device=self._device)))

    def train_and_check_golden_predictions(
        self,
        model,
        model_dir: str,
        file_patterns: Sequence[str],
        golden_data_path: str,
        train_steps: int = TRAIN_STEPS,
        batch_size: int = BATCH_SIZE,
        update_golden: bool = False,
        decimal: int = 5,
    ) -> List[Dict[str, np.ndarray]]:
        """Trains while recording golden tensors, then compares them with
        the stored golden file; writes the file instead when it is missing
        or update_golden is set."""
        self.recordio_train(model, model_dir, file_patterns, train_steps=train_steps,
                            batch_size=batch_size,
                            hook_builders=[GoldenValuesHookBuilder(model_dir)])
        values = load_golden_values(model_dir)
        if update_golden or not os.path.exists(golden_data_path):
            os.makedirs(os.path.dirname(golden_data_path), exist_ok=True)
            np.save(golden_data_path, np.asarray(values, dtype=object))
            return values
        golden = np.load(golden_data_path, allow_pickle=True)
        assert len(golden) == len(values), (
            f"Golden has {len(golden)} steps, run produced {len(values)}.")
        for step_index, (expected, actual) in enumerate(zip(golden, values)):
            assert set(expected.keys()) == set(actual.keys()), (
                f"Step {step_index}: keys {set(actual.keys())} != golden "
                f"{set(expected.keys())}")
            for key in expected:
                np.testing.assert_almost_equal(
                    actual[key], expected[key], decimal=decimal,
                    err_msg=f"step {step_index} tensor {key!r}")
        return values
