"""Preprocessors: validated transforms between parsed data and the model."""

from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
    AbstractPreprocessor,
    NoOpPreprocessor,
    SpecTransformationPreprocessor,
)
