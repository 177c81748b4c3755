"""Export generators: the serving interfaces of an exported model.

Port of tensor2robot_tpu/export/export_generators.py (without the
serve-quant and eager calibration functions, ROADMAP.md A10):

  * numpy interface — `create_serving_fn` is an nn.Module taking the raw
    spec-conforming features as a flat dict and returning the flat export
    outputs; the predict-mode preprocessor runs inside it (and so inside
    the exported program) unless `export_raw_receivers`;
  * tf.Example interface — a host-side parse function over the port's
    SpecParser, serialized records -> the numpy interface;
  * warmup requests — one spec-conforming random batch per bucket of the
    ladder, written as tf.Example records (data/encoder.py,
    data/tfrecord.py) that servers prewarm from.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch.data import encoder as encoder_lib
from tensor2robot_tpu_torch.data import tfrecord
from tensor2robot_tpu_torch.data.parser import SpecParser
from tensor2robot_tpu_torch.export import quantization
from tensor2robot_tpu_torch.models.abstract_model import MODE_PREDICT
from tensor2robot_tpu_torch.specs import (
    TensorSpecStruct,
    filter_required_flat_tensor_spec,
    flatten_spec_structure,
    make_constant_numpy,
    make_random_numpy,
)

WARMUP_DIR = "warmup"
WARMUP_FILENAME = "warmup_requests.tfrecord"


class ServingModule(nn.Module):
    """flat raw features -> flat export outputs: the predict-mode
    preprocessor (unless `raw`), then the network through the model's
    packed_inference and create_export_outputs_fn. Its network is its own
    copy, frozen (no parameter requires grad)."""

    def __init__(self, model, network: nn.Module, raw: bool = False):
        super().__init__()
        self.network = network
        self._model = model
        self._preprocessor = model.preprocessor
        self._raw = raw
        self.takes_gradients = model.forward_takes_gradients

    def forward(self, features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        features = TensorSpecStruct(dict(features))
        if not self._raw:
            features, _ = self._preprocessor.preprocess(
                features, None, mode=MODE_PREDICT
            )
        packed, _, outputs, _ = self._model.packed_inference(
            self.network, features, MODE_PREDICT
        )
        outputs = self._model.create_export_outputs_fn(packed, outputs)
        return dict(flatten_spec_structure(outputs).items())


class QuantizedServingModule(nn.Module):
    """A ServingModule whose large weights are held as int8 (or packed
    int4) buffers with their scales and dequantized in `forward`
    (torch.func.functional_call), so an exported program carries no f32
    copy of them. `quantized_variables` is the quantized state dict
    (export/quantization.py) the export stores as variables.pt."""

    def __init__(self, serving: ServingModule, variables: Mapping[str, torch.Tensor],
                 bits: int = 8):
        super().__init__()
        self.quantized_variables, _ = quantization.quantize_variables(
            {k: v.detach().cpu() for k, v in variables.items()}, bits=bits
        )
        self.quantize_bits = bits
        device = next(serving.network.parameters()).device
        self._layout = []
        for name, node in self.quantized_variables.items():
            if not quantization.is_quantized_node(node):
                continue
            values, scale, axis, shape = quantization.node_layout(node)
            index = len(self._layout)
            self.register_buffer(f"q{index}", values.to(device))
            self.register_buffer(f"scale{index}", scale.to(device))
            self._layout.append((name, axis, shape))
            owner, _, leaf = name.rpartition(".")
            module = serving.network.get_submodule(owner)
            # The f32 weight leaves the module; forward supplies it into the
            # parameter's slot, so named_parameters() lists it inside the
            # call (a MAML forward adapts every parameter it lists).
            module._parameters[leaf] = None
        self.serving = serving
        self.takes_gradients = serving.takes_gradients

    def forward(self, features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        weights = {
            f"network.{name}": quantization.dequantize(
                getattr(self, f"q{i}"), getattr(self, f"scale{i}"), axis, shape
            )
            for i, (name, axis, shape) in enumerate(self._layout)
        }
        return torch.func.functional_call(self.serving, weights, (features,))


class AbstractExportGenerator:
    """Holds the model's serving specs and derives serving callables."""

    def __init__(self, export_raw_receivers: bool = False):
        self._export_raw_receivers = export_raw_receivers
        self._feature_spec: Optional[TensorSpecStruct] = None
        self._label_spec: Optional[TensorSpecStruct] = None
        self._model_feature_spec: Optional[TensorSpecStruct] = None
        self._model = None

    def set_specification_from_model(self, model) -> None:
        """Takes the predict-mode raw in-specs off the model's
        preprocessor."""
        preprocessor = model.preprocessor
        self._model = model
        self._feature_spec = preprocessor.get_in_feature_specification(MODE_PREDICT)
        self._label_spec = preprocessor.get_in_label_specification(MODE_PREDICT)
        self._model_feature_spec = preprocessor.get_out_feature_specification(
            MODE_PREDICT
        )

    @property
    def feature_spec(self) -> TensorSpecStruct:
        if self._feature_spec is None:
            raise ValueError("set_specification_from_model must be called before use.")
        return self._feature_spec

    @property
    def label_spec(self) -> Optional[TensorSpecStruct]:
        return self._label_spec

    def serving_input_spec(self) -> TensorSpecStruct:
        """The flat, required-only raw input contract."""
        spec = (
            self._model_feature_spec if self._export_raw_receivers
            else self.feature_spec
        )
        return filter_required_flat_tensor_spec(spec)

    def create_serving_fn(
        self,
        variables: Mapping[str, torch.Tensor],
        device: Optional[torch.device] = None,
        quantize_weights: bool = False,
        quantize_bits: int = 8,
    ) -> nn.Module:
        """The serving module over a fresh network loaded with `variables`
        (a state dict), on `device` (that of the variables by default).
        With quantize_weights, a QuantizedServingModule."""
        if device is None:
            device = next(iter(variables.values())).device
        network = self._model.create_network()
        network.load_state_dict(dict(variables))
        network = network.to(device).eval().requires_grad_(False)
        serving = ServingModule(self._model, network, raw=self._export_raw_receivers)
        if quantize_weights:
            return QuantizedServingModule(serving, variables, bits=quantize_bits)
        return serving

    def create_example_features(self, batch_size: int = 2) -> Dict[str, np.ndarray]:
        """Zero exemplars of the serving inputs to trace from."""
        flat = make_constant_numpy(self.serving_input_spec(), batch_size=batch_size)
        return dict(flat.items())

    def create_tf_example_parse_fn(self) -> Callable[[Sequence[bytes]], Dict[str, np.ndarray]]:
        """Host-side parser: serialized tf.Example bytes -> flat numpy batch."""
        parser = SpecParser(self.serving_input_spec())

        def parse_fn(serialized: Sequence[bytes]) -> Dict[str, np.ndarray]:
            if isinstance(serialized, bytes):
                serialized = [serialized]
            batch = parser.parse_batch(list(serialized))
            return dict(flatten_spec_structure(batch).items())

        return parse_fn

    def generate_warmup_batches(
        self, batch_sizes: Sequence[int]
    ) -> List[Dict[str, np.ndarray]]:
        """One flat spec-conforming random batch per size, in ladder order."""
        spec = self.serving_input_spec()
        return [
            dict(flatten_spec_structure(
                make_random_numpy(spec, batch_size=batch_size)
            ).items())
            for batch_size in batch_sizes
        ]

    def write_warmup_requests(
        self, batches: Sequence[Mapping[str, np.ndarray]], export_dir: str
    ) -> str:
        """Writes the batches as the tf.Example TFRecord servers prewarm
        from, one record per row in ladder order; returns the path."""
        spec = self.serving_input_spec()
        warmup_dir = os.path.join(export_dir, WARMUP_DIR)
        os.makedirs(warmup_dir, exist_ok=True)
        path = os.path.join(warmup_dir, WARMUP_FILENAME)
        records: List[bytes] = []
        for batch in batches:
            size = next(int(np.asarray(value).shape[0]) for value in batch.values())
            for i in range(size):
                row = TensorSpecStruct()
                for key, value in batch.items():
                    row[key] = np.asarray(value)[i]
                records.append(encoder_lib.encode_example(spec, row))
        tfrecord.write_tfrecords(path, records)
        return path

    def create_warmup_requests_numpy(
        self, batch_sizes: Sequence[int], export_dir: str
    ) -> str:
        return self.write_warmup_requests(
            self.generate_warmup_batches(batch_sizes), export_dir
        )


class DefaultExportGenerator(AbstractExportGenerator):
    """The stock generator: numpy + tf.Example interfaces over one program."""
