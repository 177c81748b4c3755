"""CheckpointPredictor: serve straight from training checkpoints.

Rebuilds the network from model code and loads the newest checkpoint in a
model directory — the robot-side view of a learner that checkpoints but
has not exported. Port of tensor2robot_tpu/predictors/checkpoint_predictor.py.

A checkpoint is a torch state dict saved as `<model_dir>/<step>.pt`
(`save_checkpoint` writes one atomically, so a reader never sees a torn
file under a final name). Weights can also come from `init_randomly`
(a seeded generator) or `load_state_dict` (e.g. flax params converted by
utils/jax_params.py).
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from tensor2robot_tpu_torch.models.abstract_model import MODE_PREDICT
from tensor2robot_tpu_torch.predictors.abstract_predictor import (
    AbstractPredictor,
)
from tensor2robot_tpu_torch.specs import (
    TensorSpecStruct,
    filter_required_flat_tensor_spec,
    flatten_spec_structure,
)
from tensor2robot_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

_CHECKPOINT = re.compile(r"^(\d+)\.pt$")


def latest_checkpoint_step(model_dir: str) -> Optional[int]:
    """The largest step with a `<step>.pt` file in model_dir (None if none)."""
    if not os.path.isdir(model_dir):
        return None
    steps = [
        int(match.group(1))
        for match in map(_CHECKPOINT.match, os.listdir(model_dir))
        if match
    ]
    return max(steps) if steps else None


def save_checkpoint(
    model_dir: str, step: int, state_dict: Mapping[str, torch.Tensor]
) -> str:
    """Writes `<model_dir>/<step>.pt` through a temporary name and an atomic
    rename; returns the final path."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, f"{int(step)}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(dict(state_dict), tmp)
    os.replace(tmp, path)
    return path


class CheckpointPredictor(AbstractPredictor):
    """Serves a T2RModel from the newest checkpoint under model_dir, on
    `device` (the card by default)."""

    def __init__(
        self,
        t2r_model,
        checkpoint_dir: Optional[str] = None,
        timeout: int = 600,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
    ):
        """Args:
        t2r_model: the model whose predict path to serve.
        checkpoint_dir: the directory of `<step>.pt` checkpoints. Optional
          when weights come from init_randomly or load_state_dict.
        timeout: seconds restore() waits for a first checkpoint.
        device: where the network runs; 'cuda' raises without a card.
        """
        self._model = t2r_model
        self._device = resolve_device(device)
        self._preprocessor = t2r_model.preprocessor
        self._feature_spec = self._preprocessor.get_in_feature_specification(
            MODE_PREDICT
        )
        self._checkpoint_dir = checkpoint_dir
        self._timeout = timeout
        self._lock = threading.Lock()
        self._network: Optional[torch.nn.Module] = None
        self._version = -1

    @property
    def device(self) -> torch.device:
        return self._device

    def _install(self, network: torch.nn.Module, version: int) -> None:
        network.eval()
        with self._lock:
            self._network, self._version = network, int(version)

    # -- weights ---------------------------------------------------------------

    def restore(self, is_async: bool = False) -> bool:
        del is_async  # Loading a state dict is fast; always synchronous.
        if self._checkpoint_dir is None:
            raise ValueError("CheckpointPredictor needs checkpoint_dir to restore.")
        start = time.monotonic()
        while True:
            step = latest_checkpoint_step(self._checkpoint_dir)
            if step is not None:
                if step != self._version:
                    path = os.path.join(self._checkpoint_dir, f"{step}.pt")
                    state = torch.load(
                        path, map_location=self._device, weights_only=True
                    )
                    self.load_state_dict(state, version=step)
                return True
            if time.monotonic() - start > self._timeout:
                return False
            time.sleep(0.5)

    def init_randomly(self, generator: Optional[torch.Generator] = None) -> None:
        """Random weights drawn from `generator` (seed 0 when None)."""
        self._install(self._model.init_network(generator, self._device), 0)

    def load_state_dict(
        self, state_dict: Mapping[str, torch.Tensor], version: int = 0
    ) -> None:
        """Serves the given weights (all keys must match the network)."""
        network = self._model.create_network()
        network.load_state_dict(state_dict)
        self._install(network.to(self._device), version)

    # -- predict ---------------------------------------------------------------

    def predict_versioned(self, features: Mapping[str, Any]):
        with self._lock:
            network, version = self._network, self._version
        if network is None:
            self.assert_is_loaded()
        tensors = TensorSpecStruct()
        for key, value in flatten_spec_structure(features).items():
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.asarray(value))
            tensors[key] = value.to(self._device)
        with torch.inference_mode():
            preprocessed, _ = self._preprocessor.preprocess(
                tensors, None, mode=MODE_PREDICT
            )
            packed, _, outputs, _ = self._model.packed_inference(
                network, preprocessed, MODE_PREDICT
            )
            outputs = self._model.create_export_outputs_fn(packed, outputs)
            result = {
                key: value.cpu().numpy()
                for key, value in flatten_spec_structure(outputs).items()
            }
        return result, version

    def predict(self, features: Mapping[str, Any]) -> Dict[str, Any]:
        return self.predict_versioned(features)[0]

    # -- introspection ---------------------------------------------------------

    def get_feature_specification(self) -> TensorSpecStruct:
        """The client-facing input contract: the preprocessor's raw
        in-spec, filtered to required tensors."""
        return filter_required_flat_tensor_spec(self._feature_spec)

    @property
    def model_version(self) -> int:
        return self._version

    @property
    def global_step(self) -> int:
        return self._version

    @property
    def model_path(self) -> Optional[str]:
        if self._checkpoint_dir is None or self._version < 0:
            return None
        return os.path.join(self._checkpoint_dir, f"{self._version}.pt")
