"""The export directory: what a learner publishes and a robot serves.

Port of tensor2robot_tpu/export/saved_model.py (without its serve-quant
regimes and AOT executables, ROADMAP.md A10), in the port's own format:

    <export_root>/<unix_seconds>/
        t2r_metadata.json              global step, exporter, eval metrics,
                                       warmup ladder, program status,
                                       torch version, trace device
        variables.pt                   the serving state dict (torch.save;
                                       read with weights_only=True), int8
                                       or int4 nodes when quantized
        assets.extra/t2r_assets.pbtxt  the feature/label spec contract
        program/predict_fn.pt2         torch.export.save of preprocess +
                                       network in predict mode, weights
                                       inside, the batch dim dynamic
        warmup/warmup_requests.tfrecord  (exporters) one batch per bucket

A version is written under `temp-<ts>` and renamed, so pollers never see
a partial export. The program is best-effort as in the JAX package: a
module that does not export is recorded in `program_error` and the
version still lands; a predictor then needs model code.

The program holds flash attention's no-gradient forward as the operator
`t2r_torch::flash_fwd` (ops/flash_attention.py), so a program traced on
either device launches the kernel B2 on the card. It is traced under
torch.no_grad() from a batch of EXAMPLE_BATCH (a batch of 1 would pin
the dim to 1). A program traced on one device is moved to another on
load (torch.export.passes.move_to_device_pass). Python-side state read in
`forward` is frozen in at trace time; the BC and critic forwards read no
`T2R_*` flag (T2R_STEM_S2D is read when the critic's network is built,
T2R_POOL_BACKWARD only by gradients).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from tensor2robot_tpu_torch.export import quantization
from tensor2robot_tpu_torch.specs import (
    ExtendedTensorSpec,
    TensorSpecStruct,
    flatten_spec_structure,
    numpy_dtype,
)
from tensor2robot_tpu_torch.specs.proto_io import read_t2r_assets, write_t2r_assets
from tensor2robot_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

TMP_DIR_PREFIX = "temp-"
METADATA_FILENAME = "t2r_metadata.json"
VARIABLES_FILENAME = "variables.pt"
PROGRAM_DIR = "program"
PROGRAM_FILENAME = "predict_fn.pt2"
FORMAT_VERSION = 1
#: The batch the program is traced from, and the least largest batch it
#: serves (the JAX exports are batch-polymorphic without a bound).
EXAMPLE_BATCH = 2
DEFAULT_MAX_BATCH = 64


def program_path(export_dir: str) -> str:
    return os.path.join(export_dir, PROGRAM_DIR, PROGRAM_FILENAME)


def is_valid_export_dir(path: str) -> bool:
    """A completed, timestamp-named export directory."""
    base = os.path.basename(path.rstrip("/"))
    if not base.isdigit():
        return False
    return os.path.exists(os.path.join(path, METADATA_FILENAME)) and os.path.exists(
        os.path.join(path, VARIABLES_FILENAME)
    )


def list_export_dirs(export_root: str) -> List[str]:
    """All valid export dirs under root, oldest -> newest."""
    if not os.path.isdir(export_root):
        return []
    dirs = [
        os.path.join(export_root, d) for d in os.listdir(export_root) if d.isdigit()
    ]
    return sorted(
        [d for d in dirs if is_valid_export_dir(d)],
        key=lambda d: int(os.path.basename(d)),
    )


def latest_export_dir(export_root: str) -> Optional[str]:
    dirs = list_export_dirs(export_root)
    return dirs[-1] if dirs else None


def _unique_timestamp_dir(export_root: str) -> str:
    ts = int(time.time())
    while os.path.exists(os.path.join(export_root, str(ts))) or os.path.exists(
        os.path.join(export_root, TMP_DIR_PREFIX + str(ts))
    ):
        ts += 1
    return str(ts)


def _host_variables(variables: Mapping[str, Any]) -> Dict[str, Any]:
    """Tensors (and quantized nodes' tensors) detached onto the host."""
    out: Dict[str, Any] = {}
    for key, value in variables.items():
        if isinstance(value, Mapping):
            out[key] = _host_variables(value)
        else:
            out[key] = value.detach().cpu().contiguous()
    return out


def module_device(module: torch.nn.Module) -> torch.device:
    for tensor in list(module.parameters()) + list(module.buffers()):
        return tensor.device
    return torch.device("cpu")


#: torch.export sets torch.compiler's is_compiling flag, one for the whole
#: process, while it traces, and eager code on every thread reads it: an
#: optimizer step that sees it flip mid-step passes a list of tensors where
#: scalars go and raises; nn.Module calls and torch.utils.checkpoint take
#: their traced paths. Tracing holds this lock, and so does eager work that
#: may run beside an export on another thread (the trainer's steps beside
#: AsyncExportHook's worker).
TRACE_LOCK = threading.RLock()


def export_program(
    module: torch.nn.Module,
    example_features: Mapping[str, Any],
    max_batch: int = DEFAULT_MAX_BATCH,
) -> torch.export.ExportedProgram:
    """torch.export of `module(features) -> outputs` over the example
    features (batch EXAMPLE_BATCH), the leading dim of every input one
    dynamic `batch` in [1, max_batch], under torch.no_grad()."""
    device = module_device(module)
    examples = {
        key: torch.as_tensor(np.asarray(value)).to(device)
        for key, value in example_features.items()
    }
    for key, value in examples.items():
        if value.ndim < 1:
            raise ValueError(
                f"Serving input {key!r} must have a leading batch dim, got "
                f"{tuple(value.shape)}."
            )
    batch = torch.export.Dim("batch", min=1, max=max(max_batch, EXAMPLE_BATCH))
    with TRACE_LOCK, torch.no_grad():
        return torch.export.export(
            module, (examples,),
            dynamic_shapes=({key: {0: batch} for key in examples},),
        )


def save_exported_model(
    export_root: str,
    variables: Mapping[str, torch.Tensor],
    feature_spec: TensorSpecStruct,
    label_spec: Optional[TensorSpecStruct] = None,
    global_step: int = 0,
    serving_module: Optional[torch.nn.Module] = None,
    example_features: Optional[Mapping[str, Any]] = None,
    export_program_file: bool = True,
    metadata: Optional[Dict[str, Any]] = None,
    quantize_weights: bool = False,
    quantize_bits: int = 8,
    max_batch: int = DEFAULT_MAX_BATCH,
) -> str:
    """Writes one export version; returns its final path.

    Args:
      export_root: parent directory of the timestamped versions.
      variables: the serving state dict (EMA parameters where the model
        keeps them).
      feature_spec: the raw input contract robots pack against.
      label_spec: optional label contract for the sidecar.
      global_step: training step of the exported weights.
      serving_module: `flat features -> flat outputs`
        (export_generators.create_serving_fn); needed for the program.
        One built with quantize_weights carries `quantized_variables`,
        which is stored as variables.pt (so the file and the program hold
        the same int8/int4 weights).
      example_features: flat {key: array} of batch EXAMPLE_BATCH to trace.
      export_program_file: False skips the program (predictors then need
        model code).
      metadata: extra JSON entries for t2r_metadata.json.
      quantize_weights / quantize_bits: store variables.pt weight-only
        quantized (export/quantization.py).
      max_batch: the program's largest batch.
    """
    quantization.check_bits(quantize_bits)
    in_module = getattr(serving_module, "quantized_variables", None)
    if in_module is not None:
        stored = in_module
        quantize_weights = True
        quantize_bits = serving_module.quantize_bits
    elif quantize_weights:
        stored, _ = quantization.quantize_variables(
            _host_variables(variables), bits=quantize_bits
        )
    else:
        stored = variables

    os.makedirs(export_root, exist_ok=True)
    final_name = _unique_timestamp_dir(export_root)
    tmp_path = os.path.join(export_root, TMP_DIR_PREFIX + final_name)
    final_path = os.path.join(export_root, final_name)
    if os.path.exists(tmp_path):
        shutil.rmtree(tmp_path)
    os.makedirs(tmp_path)
    write_t2r_assets(
        tmp_path, feature_spec, label_spec=label_spec, global_step=global_step
    )
    torch.save(_host_variables(stored), os.path.join(tmp_path, VARIABLES_FILENAME))

    program_ok, program_error, traced_on = False, None, None
    if export_program_file and serving_module is not None and example_features is not None:
        try:
            program = export_program(serving_module, example_features, max_batch)
            # The example batch would ride in the file (100 MB for a
            # full-width BC episode pair); the program does not need it.
            program.example_inputs = None
            os.makedirs(os.path.join(tmp_path, PROGRAM_DIR))
            torch.export.save(program, program_path(tmp_path))
            program_ok = True
            traced_on = str(module_device(serving_module))
        except Exception as err:  # noqa: BLE001 — the program is best-effort;
            # variables + assets always land, so record why and move on.
            program_error = f"{type(err).__name__}: {err}"

    meta = {
        "global_step": int(global_step),
        "timestamp": int(final_name),
        "program": program_ok,
        "program_error": program_error,
        "program_device": traced_on,
        "weights_int8": bool(quantize_weights),
        **({"weights_quantize_bits": int(quantize_bits)} if quantize_weights else {}),
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
    }
    if metadata:
        meta.update(metadata)
    with open(os.path.join(tmp_path, METADATA_FILENAME), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    os.replace(tmp_path, final_path)
    return final_path


def read_metadata(export_dir: str) -> Dict[str, Any]:
    with open(os.path.join(export_dir, METADATA_FILENAME)) as f:
        return json.load(f)


class ExportedModel:
    """A loaded export version: specs, metadata, variables and, when the
    export has one, its program moved to `device` (the card by default)."""

    def __init__(self, export_dir: str, device: Union[str, torch.device] = DEFAULT_DEVICE):
        self.export_dir = export_dir
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.metadata = read_metadata(export_dir)
        self.feature_spec, self.label_spec, self.global_step = read_t2r_assets(
            export_dir
        )
        self._inputs = [
            (key, numpy_dtype(spec.dtype))
            for key, spec in flatten_spec_structure(self.feature_spec).items()
            if isinstance(spec, ExtendedTensorSpec) and not spec.is_optional
        ]
        self._module = self._load_program() if self.metadata.get("program") else None

    def _load_program(self) -> torch.nn.Module:
        # Registers t2r_torch::flash_fwd, which the program may call.
        import torch.export.passes

        from tensor2robot_tpu_torch.ops import flash_attention  # noqa: F401

        program = torch.export.load(program_path(self.export_dir))
        if self.metadata.get("program_device") != str(self.device):
            program = torch.export.passes.move_to_device_pass(program, self.device)
        return program.module()

    @property
    def has_program(self) -> bool:
        return self._module is not None

    def traced_predict(self, features: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The program on tensors already on `device` (no host copies), so
        a caller can keep a loop on the card."""
        if self._module is None:
            raise RuntimeError(
                f"Export {self.export_dir} has no program; serving it needs "
                f"model code ({self.metadata.get('program_error')})."
            )
        with torch.no_grad():
            return dict(self._module({key: features[key] for key, _ in self._inputs}))

    def predict(self, flat_features: Mapping[str, Any]) -> Dict[str, np.ndarray]:
        """Host numpy in, host numpy out (each input cast to its spec's
        dtype and copied to `device`)."""
        if self._module is None:
            return self.traced_predict({})  # raises, naming why
        tensors = {
            key: torch.from_numpy(
                np.ascontiguousarray(np.asarray(flat_features[key], dtype=dtype))
            ).to(self.device)
            for key, dtype in self._inputs
        }
        out = self.traced_predict(tensors)
        return {key: value.cpu().numpy() for key, value in out.items()}

    def load_variables(self) -> Dict[str, torch.Tensor]:
        """variables.pt as a state dict on the host; int8/int4 exports
        (metadata `weights_int8`) are dequantized."""
        variables = torch.load(
            os.path.join(self.export_dir, VARIABLES_FILENAME),
            map_location="cpu", weights_only=True,
        )
        if self.metadata.get("weights_int8"):
            variables = quantization.dequantize_variables(variables)
        return variables
