"""Predictors: load weights and serve predict(features)."""

from tensor2robot_tpu_torch.predictors.abstract_predictor import AbstractPredictor
from tensor2robot_tpu_torch.predictors.checkpoint_predictor import (
    CheckpointPredictor,
)
from tensor2robot_tpu_torch.train.state import (
    latest_checkpoint_step,
    save_checkpoint,
)
