"""The SavedModel-v2 predictor family over one export version: model code
or the exported program, explicitly.

Port of tensor2robot_tpu/predictors/saved_model_v2_predictor.py:

  * SavedModelCodePredictor — model code + the export's variables; the
    model object is in charge;
  * SavedModelSignaturePredictor — strictly the exported program; no
    model code, what a robot fleet runs.

Both load one pinned version (a version dir, or the newest under a root
at restore). Polling and async restore live in
ExportedSavedModelPredictor.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from tensor2robot_tpu_torch.export.export_generators import DefaultExportGenerator
from tensor2robot_tpu_torch.export.saved_model import (
    ExportedModel,
    is_valid_export_dir,
    latest_export_dir,
)
from tensor2robot_tpu_torch.predictors.abstract_predictor import AbstractPredictor
from tensor2robot_tpu_torch.specs import TensorSpecStruct, flatten_spec_structure
from tensor2robot_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def build_model_code_serving_fn(
    t2r_model,
    loaded: Optional[ExportedModel] = None,
    device: Union[str, torch.device] = DEFAULT_DEVICE,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Callable[[Dict[str, Any]], Dict[str, np.ndarray]], DefaultExportGenerator]:
    """(serving fn, export generator) from model code, with the variables
    of `loaded` when given, else freshly initialized from `generator`
    (seed 0 when None). Host numpy in, host numpy out."""
    device = resolve_device(device)
    export_generator = DefaultExportGenerator()
    export_generator.set_specification_from_model(t2r_model)
    if loaded is not None:
        variables = loaded.load_variables()
    else:
        variables = t2r_model.init_network(generator, "cpu").state_dict()
    module = export_generator.create_serving_fn(variables, device=device)
    spec = flatten_spec_structure(export_generator.serving_input_spec())

    def predict_fn(flat_features: Dict[str, Any]) -> Dict[str, np.ndarray]:
        tensors = {
            key: torch.as_tensor(np.asarray(flat_features[key])).to(device)
            for key in spec
        }
        with torch.no_grad():
            out = module(tensors)
        return {key: value.cpu().numpy() for key, value in out.items()}

    return predict_fn, export_generator


def make_random_loaded(generator: DefaultExportGenerator):
    """A stand-in for ExportedModel carrying randomly initialized serving
    state: what init_randomly predictors report as their artifact."""

    class _RandomLoaded:
        export_dir = "<random-init>"
        global_step = 0
        feature_spec = generator.serving_input_spec()
        label_spec = generator.label_spec
        metadata: Dict[str, Any] = {}

    return _RandomLoaded()


def _resolve_export_dir(saved_model_path: str) -> Optional[str]:
    """A version dir passes through; a root resolves to its newest version."""
    if is_valid_export_dir(saved_model_path):
        return saved_model_path
    return latest_export_dir(saved_model_path)


def version_of(loaded) -> int:
    """An export's version: its directory's timestamp (-1 unloaded, 0 for
    a random init)."""
    if loaded is None:
        return -1
    base = os.path.basename(loaded.export_dir.rstrip("/"))
    return int(base) if base.isdigit() else 0


class SavedModelPredictorBase(AbstractPredictor):
    """Loading and introspection over one export version."""

    def __init__(self, saved_model_path: str,
                 device: Union[str, torch.device] = DEFAULT_DEVICE,
                 quant_regime: Optional[str] = None):
        self._saved_model_path = saved_model_path
        self._device = resolve_device(device)
        # The serving regime; None reads T2R_SERVE_QUANT at restore.
        self._quant_regime = quant_regime
        self._loaded = None
        self._predict_fn: Optional[Callable] = None

    def _build_predict_fn(self, loaded: ExportedModel) -> Callable:
        raise NotImplementedError

    def restore(self, is_async: bool = False) -> bool:
        del is_async  # one-shot load; fleets use ExportedSavedModelPredictor
        path = _resolve_export_dir(self._saved_model_path)
        if path is None:
            return False
        loaded = ExportedModel(path, device=self._device,
                               quant_regime=self._quant_regime)
        self._predict_fn = self._build_predict_fn(loaded)
        self._loaded = loaded
        return True

    def init_randomly(self) -> None:
        raise ValueError(
            f"{type(self).__name__} serves a fixed artifact; random init is "
            "only meaningful for model-code predictors (CheckpointPredictor "
            "or SavedModelCodePredictor)."
        )

    def predict(self, features: Mapping[str, Any]) -> Dict[str, Any]:
        self.assert_is_loaded()
        flat = dict(flatten_spec_structure(features).items())
        return dict(self._predict_fn(flat))

    def get_feature_specification(self) -> TensorSpecStruct:
        self.assert_is_loaded()
        return self._loaded.feature_spec

    def get_label_specification(self) -> Optional[TensorSpecStruct]:
        self.assert_is_loaded()
        return self._loaded.label_spec

    @property
    def model_version(self) -> int:
        return version_of(self._loaded)

    @property
    def global_step(self) -> int:
        return -1 if self._loaded is None else int(self._loaded.global_step)

    @property
    def model_path(self) -> Optional[str]:
        return None if self._loaded is None else self._loaded.export_dir

    @property
    def quant_regime(self) -> str:
        """The loaded version's serving regime ('none' before restore)."""
        return getattr(self._loaded, "quant_regime", "none") if self._loaded else "none"


class SavedModelCodePredictor(SavedModelPredictorBase):
    """Model-object serving: the export's variables in `t2r_model`'s
    network."""

    def __init__(self, saved_model_path: str, t2r_model,
                 device: Union[str, torch.device] = DEFAULT_DEVICE,
                 quant_regime: Optional[str] = None):
        super().__init__(saved_model_path, device=device, quant_regime=quant_regime)
        self._t2r_model = t2r_model

    def _build_predict_fn(self, loaded: ExportedModel) -> Callable:
        if loaded.quant_regime != "none":
            # Model code serves the f32 variables: it cannot honor a regime.
            raise ValueError(
                f"SavedModelCodePredictor serves fp32 model code and cannot "
                f"honor quant regime {loaded.quant_regime!r}; serve the "
                "export's quantized program with ExportedSavedModelPredictor or "
                "SavedModelSignaturePredictor, or set T2R_SERVE_QUANT=none.")
        predict_fn, _ = build_model_code_serving_fn(
            self._t2r_model, loaded, device=self._device
        )
        return predict_fn

    def init_randomly(self, generator: Optional[torch.Generator] = None) -> None:
        predict_fn, export_generator = build_model_code_serving_fn(
            self._t2r_model, device=self._device, generator=generator
        )
        self._loaded = make_random_loaded(export_generator)
        self._predict_fn = predict_fn


class SavedModelSignaturePredictor(SavedModelPredictorBase):
    """Program-only serving: the exported program, no model code."""

    def _build_predict_fn(self, loaded: ExportedModel) -> Callable:
        if not loaded.has_program:
            raise ValueError(
                f"Export {loaded.export_dir} carries no program "
                f"({loaded.metadata.get('program_error')}); serve it with "
                "SavedModelCodePredictor instead."
            )
        return loaded.predict
