"""Export generators: the serving interfaces of an exported model.

Port of tensor2robot_tpu/export/export_generators.py:

  * numpy interface — `create_serving_fn` is an nn.Module taking the raw
    spec-conforming features as a flat dict and returning the flat export
    outputs; the predict-mode preprocessor runs inside it (and so inside
    the exported program) unless `export_raw_receivers`;
  * low-precision serving — `create_quant_serving_fn` is a
    QuantServingModule taking a regime's quantized payload beside the
    features (export/serve_quant.py), so the regime's program carries no
    weights; `create_eager_serving_fn` is the f32 forward the static
    activation calibration captures from;
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
from tensor2robot_tpu_torch.export import serve_quant as sq
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


class QuantServingModule(nn.Module):
    """`(payload, flat features) -> flat outputs` in one low-precision
    regime (export/serve_quant.py): the inputs fake-quantized against
    their calibrated clips, the blockwise leaves dequantized from the
    payload, the channel leaves contracted natively by the swapped modules
    of its own network copy, which holds no weights: every parameter and
    buffer comes from the payload argument at each call.

    Attributes (the export's bookkeeping, as the JAX package's serving fn
    carries them): quant_payload (the payload on the module's device),
    quant_layout, quant_regime, quant_block, quant_calibration,
    quant_native (the eligibility map it was built with), quant_attn,
    quant_static_scales (the consumable clips), quant_calib_mode and
    quant_native_fired (the keys the lowering actually ran, filled by any
    call)."""

    def __init__(self, serving: ServingModule, variables: Mapping[str, torch.Tensor],
                 regime: str, block: int, min_size: int,
                 calibration: Mapping[str, float], native: Optional[Sequence[str]],
                 static_scales: Optional[Mapping[str, float]], attn):
        super().__init__()
        network = serving.network
        self.device = next(iter(variables.values())).device
        tree = sq.flax_variables(variables, network)
        if native is None:
            native = sq.resolve_native_eligibility(tree, regime, min_size=min_size)
        native = tuple(sorted(native))
        if regime not in sq.NATIVE_DOT_REGIMES:
            # A cast regime has no native contraction to calibrate or lower.
            attn, static_scales = (), None
        static_scales = dict(static_scales or {})
        attn_spec = sq.resolve_native_attention(attn)
        payload, layout = sq.quantize_tree(tree, regime, block=block,
                                           min_size=min_size, native=native)
        self.quant_payload = sq.payload_to(payload, self.device)
        self.quant_layout = layout
        self.quant_regime = regime
        self.quant_block = block
        self.quant_calibration = dict(calibration)
        self.quant_native = native
        self.quant_attn = attn_spec
        self.quant_native_fired: set = set()
        self._lowering = sq.native_lowering(
            network, layout, regime, fired=self.quant_native_fired,
            static_scales=static_scales, attn=attn_spec)
        # The recorded clips are the consumable ones: a kernel of the map
        # or an operand of an eligible attention module.
        native_set = set(native)

        def consumable(key: str) -> bool:
            if not key.startswith("attn/"):
                return key in native_set
            if attn_spec == ():
                return False
            module_path = key.rsplit(":", 1)[0][len("attn/"):].split("/")
            return sq._attention_eligible(attn_spec, module_path)

        self.quant_static_scales = {k: v for k, v in static_scales.items()
                                    if consumable(k)}
        if regime not in sq.NATIVE_DOT_REGIMES or (not native and attn_spec == ()):
            self.quant_calib_mode = None
        else:
            self.quant_calib_mode = "static" if self.quant_static_scales else "dynamic"
        lowered = set(self._lowering.lowered)
        self._entries = [
            (f"network.{name}", path, dims)
            for name, path, dims in sq.variable_entries(network)
            if name in variables and path not in lowered
        ]
        # The network keeps its slots (named as the state dict) and no
        # tensor: forward supplies every one from the payload.
        for name in [n for n, _ in network.named_parameters()]:
            owner, _, leaf = name.rpartition(".")
            network.get_submodule(owner)._parameters[leaf] = None
        for name in [n for n, _ in network.named_buffers()]:
            owner, _, leaf = name.rpartition(".")
            network.get_submodule(owner)._buffers[leaf] = None
        self.serving = serving
        self.takes_gradients = serving.takes_gradients

    def forward(self, payload: Dict[str, Any],
                features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        features = sq.fake_quant_activations(dict(features), self.quant_calibration,
                                             self.quant_regime)
        leaves = dict(sq._flat_items(payload))
        bound = {}
        for name, path, dims in self._entries:
            leaf = leaves[path]
            if sq._is_payload_node(leaf):
                leaf = sq._dequantize_node(leaf, self.quant_layout[path],
                                           self.quant_regime)
            bound[name] = leaf.permute(dims) if leaf.ndim > 1 else leaf
        with self._lowering.bind(payload):
            return torch.func.functional_call(self.serving, bound, (features,))


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

    def create_eager_serving_fn(
        self,
        variables: Mapping[str, torch.Tensor],
        device: Optional[torch.device] = None,
    ) -> ServingModule:
        """The f32 serving module, run eagerly: what the static activation
        calibration captures from (serve_quant.capture_activations over its
        `network`). Torch runs every module eagerly, so this is the module
        create_serving_fn returns, unquantized."""
        return self.create_serving_fn(variables, device=device)

    def create_quant_serving_fn(
        self,
        variables: Mapping[str, torch.Tensor],
        regime: str,
        block: Optional[int] = None,
        min_size: Optional[int] = None,
        calibration: Optional[Mapping[str, float]] = None,
        native: Optional[Sequence[str]] = None,
        static_scales: Optional[Mapping[str, float]] = None,
        attn=None,
        device: Optional[torch.device] = None,
    ) -> QuantServingModule:
        """The serving module of one low-precision regime over `variables`
        (a state dict, on `device`, that of the variables by default).

        `native` is the eligibility map of native contractions (None: the
        default map after T2R_SERVE_NATIVE_LAYERS; (): the dequant path
        alone); `static_scales` the export-calibrated activation clips
        (serve_quant.resolve_static_scales; None: every contraction
        dynamic); `attn` the attention eligibility (None reads
        T2R_SERVE_NATIVE_ATTN; () lowers no attention)."""
        if device is None:
            device = next(iter(variables.values())).device
        variables = {k: v.to(device) for k, v in variables.items()}
        serving = self.create_serving_fn(variables, device=device)
        return QuantServingModule(
            serving, variables, regime,
            block=sq.DEFAULT_BLOCK if block is None else int(block),
            min_size=sq.DEFAULT_MIN_SIZE if min_size is None else int(min_size),
            calibration=dict(calibration or {}), native=native,
            static_scales=static_scales, attn=attn,
        )

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
