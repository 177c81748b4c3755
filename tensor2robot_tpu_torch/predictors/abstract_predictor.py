"""AbstractPredictor: model loading + predict(features) for robot processes.

A predictor loads the newest weights the learner produced, exposes the
input contract via get_feature_specification, and serves predict().
Port of tensor2robot_tpu/predictors/abstract_predictor.py.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Mapping, Optional, Tuple

from tensor2robot_tpu_torch.specs import TensorSpecStruct


class AbstractPredictor(abc.ABC):
    """predict/restore lifecycle contract."""

    @abc.abstractmethod
    def predict(self, features: Mapping[str, Any]) -> Dict[str, Any]:
        """Runs the serving fn on spec-conforming numpy features."""

    def predict_versioned(
        self, features: Mapping[str, Any]
    ) -> Tuple[Dict[str, Any], int]:
        """(outputs, model_version that computed them). Predictors whose
        weights can change under a running call override this to read
        both as one atomic pair."""
        version = self.model_version
        return self.predict(features), version

    @abc.abstractmethod
    def get_feature_specification(self) -> TensorSpecStruct:
        """The raw input contract callers pack observations against."""

    def get_label_specification(self) -> Optional[TensorSpecStruct]:
        return None

    @abc.abstractmethod
    def restore(self, is_async: bool = False) -> bool:
        """Loads the newest available weights; returns success."""

    def init_randomly(self, generator=None) -> None:
        """Random-weight initialization for tests and bring-up."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support random initialization."
        )

    def close(self) -> None:
        pass

    @property
    @abc.abstractmethod
    def model_version(self) -> int:
        """Monotonic version of the loaded weights (-1 when unloaded)."""

    @property
    @abc.abstractmethod
    def global_step(self) -> int:
        """Training global step of the loaded weights (-1 when unknown)."""

    @property
    @abc.abstractmethod
    def model_path(self) -> Optional[str]:
        """Filesystem path the weights came from."""

    def assert_is_loaded(self) -> None:
        if self.model_version < 0:
            raise ValueError(
                f"{type(self).__name__} has no model loaded; call restore() "
                "or init_randomly() first."
            )

    def __enter__(self) -> "AbstractPredictor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
