"""CheckpointPredictor: serve straight from training checkpoints.

Rebuilds the network from model code and polls the trainer's checkpoint
directory, `<model_dir>/checkpoints/` (train/state.py), for new steps —
the robot-side view of a learner that checkpoints but has not exported.
Port of tensor2robot_tpu/predictors/checkpoint_predictor.py: it serves the
EMA parameters when `use_ema` asks for them, by default when the model
keeps them (`use_avg_model_params`). Weights can also come from
`init_randomly` (a seeded generator) or `load_state_dict` (e.g. flax
params converted by utils/jax_params.py).

A restore reads durable steps only, as the JAX predictor does
(`latest_durable_step_in`): it walks the steps newest first and skips,
with a warning naming the file, any that does not verify against its
durability manifest or does not load (train/durability.py). It serves the
newest step that does, or keeps the version it serves when none newer
does.
"""

from __future__ import annotations

import logging
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
from tensor2robot_tpu_torch.train import durability
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


class CheckpointPredictor(AbstractPredictor):
    """Serves a T2RModel from the newest checkpoint under model_dir, on
    `device` (the card by default)."""

    def __init__(
        self,
        t2r_model,
        checkpoint_dir: Optional[str] = None,
        timeout: int = 600,
        use_ema: Optional[bool] = None,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
    ):
        """Args:
        t2r_model: the model whose predict path to serve.
        checkpoint_dir: the trainer's model_dir (its checkpoints/ subdir
          is polled). Optional when weights come from init_randomly or
          load_state_dict.
        timeout: seconds restore() waits for a first checkpoint.
        use_ema: serve averaged params; defaults to the model's
          use_avg_model_params.
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
        self._use_ema = (
            use_ema if use_ema is not None
            else getattr(t2r_model, "use_avg_model_params", False)
        )
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
            if self._restore_newest_durable():
                return True
            if time.monotonic() - start > self._timeout:
                return False
            time.sleep(0.5)

    def _restore_newest_durable(self) -> bool:
        """Serves the newest step that loads; True when one is served
        (or the one served is still the newest that loads), False when
        no step loads."""
        for step in reversed(state_lib.checkpoint_steps(self._checkpoint_dir)):
            if step == self._version:
                return True
            reason = durability.validate(self._checkpoint_dir, step)
            if reason is None:
                try:
                    checkpoint = durability.load_durable(self._checkpoint_dir, step)
                    params = checkpoint["params"]
                except (durability.TornCheckpoint, KeyError) as err:
                    reason = f"{type(err).__name__}: {err}"
            if reason is not None:
                # A torn step is never served, never raised on.
                logging.warning(
                    "Skipping torn checkpoint %s: %s",
                    state_lib.checkpoint_path(self._checkpoint_dir, step), reason,
                )
                continue
            if self._use_ema and checkpoint["ema_params"] is not None:
                params = {**params, **state_lib.checkpoint_ema(checkpoint)}
            self.load_state_dict(params, version=step)
            return True
        return False

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
        return state_lib.checkpoint_path(self._checkpoint_dir, self._version)
