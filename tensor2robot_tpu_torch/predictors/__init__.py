"""Predictors: load weights and serve predict(features)."""

from tensor2robot_tpu_torch.predictors.abstract_predictor import AbstractPredictor
from tensor2robot_tpu_torch.predictors.checkpoint_predictor import (
    CheckpointPredictor,
    latest_checkpoint_step,
    save_checkpoint,
)
