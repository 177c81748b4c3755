"""The export directory: what a learner publishes and a robot serves.

Port of tensor2robot_tpu/export/saved_model.py, in the port's own format:

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
        program/predict_fn_b<N>.pt2    or, for a forward that takes
                                       gradients (MAML), one program per
                                       static batch N (`program_batches`)
        warmup/warmup_requests.tfrecord  (exporters) one batch per bucket
        quant/params_<regime>.pt       a low-precision regime's payload
                                       (export/serve_quant.py; torch.save)
        program/predict_fn_<regime>.pt2  its program: (payload, features)
                                       -> outputs, the batch dim dynamic,
                                       no weights inside
        aot/exec_<regime>_b<n>.bin     (aot_executables) one AOTInductor
                                       package a (regime, warmup bucket),
                                       in export/aot.py's keyed envelope

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

A regime passes its parity gate against the f32 serving module over the
warmup corpus before any directory exists, or the export raises
QuantParityError and writes nothing. `ExportedModel(quant_regime=)` serves
a regime (None reads T2R_SERVE_QUANT; "none" is the f32 path): its
program and its payload, loaded onto the device once.

A MAML forward adapts the weights with an inner gradient
(`torch.func.grad` under `torch.func.vmap` over tasks), which
`torch.export` cannot trace: it refuses `autograd.grad`, and vmap's
batching rules pin the batch dim. Such a serving module says so
(`takes_gradients`); it is traced with `make_fx`, which records the
forward and its inner backward as plain aten ops, at each batch of a
ladder, and each graph is saved as a program with no autograd left in it.
A request is served by the program of its batch, or padded up to the
next one (rows are independent: a MAML task adapts on its own data) and
cut back.

With `aot_executables` (None reads T2R_AOT_EXPORT, 0 by default) every
program is also compiled per warmup bucket into an AOTInductor package
(export/aot.py): the f32 program, each regime's program, and each static
program at its own batch. `ExportedModel` serves a bucket from its
package when T2R_SERVE_AOT is on and the package's integrity, artifact
fingerprint, device topology and torch/CUDA versions all match; every
other batch runs the exported program (`fresh_trace_calls` counts them),
and every declared bucket that could not load is a logged fallback with
its reason in `aot_fallbacks`. T2R_AOT_REQUIRE=1 makes such a restore
raise AOTError. The metadata's `flax_variables` table maps each entry of
variables.pt to its JAX flat path and layout, so tools without model code
(export/artifact_store.py) see the weights as the JAX package does.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from tensor2robot_tpu_torch import flags
from tensor2robot_tpu_torch.export import aot as aot_lib
from tensor2robot_tpu_torch.export import quantization
from tensor2robot_tpu_torch.export import serve_quant as sq
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
#: The batches of a static program set when the exporter names none.
STATIC_BATCHES = (1, 2, 4, 8)
QUANT_DIR = "quant"


def quant_payload_relpath(regime: str) -> str:
    """Export-relative path of a regime's payload."""
    return os.path.join(QUANT_DIR, f"params_{regime}.pt")


def quant_program_relpath(regime: str) -> str:
    """Export-relative path of a regime's program (payload as argument)."""
    return os.path.join(PROGRAM_DIR, f"predict_fn_{regime}.pt2")


def program_path(export_dir: str) -> str:
    return os.path.join(export_dir, PROGRAM_DIR, PROGRAM_FILENAME)


def static_program_path(export_dir: str, batch: int) -> str:
    return os.path.join(export_dir, PROGRAM_DIR, f"predict_fn_b{int(batch)}.pt2")


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


def export_static_program(
    module: torch.nn.Module,
    example_features: Mapping[str, Any],
    batch: int,
) -> torch.export.ExportedProgram:
    """A program of `module(features) -> outputs` at one static batch, for
    a forward that takes gradients: make_fx records it (the inner backward
    as aten ops) from the first example row repeated `batch` times, and
    torch.export saves the graph."""
    from torch.fx.experimental.proxy_tensor import make_fx

    device = module_device(module)
    examples = {
        key: torch.as_tensor(np.repeat(np.asarray(value)[:1], batch, axis=0)).to(device)
        for key, value in example_features.items()
    }
    with TRACE_LOCK, torch.no_grad():
        graph = make_fx(module, tracing_mode="fake", _allow_non_fake_inputs=True)(examples)
        return torch.export.export(graph, (examples,))


def export_quant_program(
    module: torch.nn.Module,
    example_features: Mapping[str, Any],
    max_batch: int = DEFAULT_MAX_BATCH,
) -> torch.export.ExportedProgram:
    """torch.export of a QuantServingModule's `(payload, features) ->
    outputs`, the payload an argument (so the program holds no weights)
    and the leading dim of every feature one dynamic `batch`."""
    if getattr(module, "takes_gradients", False):
        raise ValueError(
            "a serve-quant program of a forward that takes gradients (MAML) "
            "is not exported: its static program set has no payload argument")
    device = module.device
    examples = {
        key: torch.as_tensor(np.asarray(value)).to(device)
        for key, value in example_features.items()
    }
    payload = module.quant_payload
    batch = torch.export.Dim("batch", min=1, max=max(max_batch, EXAMPLE_BATCH))
    dynamic = (torch.utils._pytree.tree_map(lambda _: None, payload),
               {key: {0: batch} for key in examples})
    with TRACE_LOCK, torch.no_grad():
        return torch.export.export(module, (payload, examples),
                                   dynamic_shapes=dynamic)


def run_batch(module: torch.nn.Module, batch: Mapping[str, Any], device,
               payload=None) -> Dict[str, np.ndarray]:
    """One eager call of a serving module on a host batch; host outputs.
    Under TRACE_LOCK: exports in other threads may be tracing."""
    inputs = {key: torch.as_tensor(np.asarray(value)).to(device)
              for key, value in batch.items()}
    with TRACE_LOCK, torch.no_grad():
        out = module(inputs) if payload is None else module(payload, inputs)
    return {key: value.detach().cpu().numpy() for key, value in out.items()}


def _serve_quant_record(serve_quant_fns, fp32_run, calibration_batches,
                        quant_parity_tol) -> Dict[str, Any]:
    """Runs every regime's parity gate (QuantParityError on the first that
    fails, before anything is written) and returns the metadata's
    serve_quant block, in the JAX package's keys."""
    tolerance = dict(sq.DEFAULT_PARITY_TOL)
    tolerance.update(dict(quant_parity_tol or {}))
    fp32_outputs = None
    meta: Dict[str, Any] = {
        "regimes": sorted(serve_quant_fns), "block": {}, "calibration": {},
        "layout": {}, "parity": {}, "payload_bytes": {}, "stablehlo": {},
        "native": {}, "granularity": {}, "calib": {},
    }
    for regime in sorted(serve_quant_fns):
        fn = serve_quant_fns[regime]
        divergence = getattr(fn, "quant_measured_divergence", None)
        if divergence is None:
            if fp32_outputs is None:
                fp32_outputs = [fp32_run(batch) for batch in calibration_batches]
            quant_outputs = [run_batch(fn, batch, fn.device, fn.quant_payload)
                             for batch in calibration_batches]
            divergence = sq.measure_parity(fp32_outputs, quant_outputs)
        sq.check_parity(regime, divergence, tolerance[regime])
        meta["block"][regime] = int(fn.quant_block)
        meta["calibration"][regime] = {k: float(v) for k, v in fn.quant_calibration.items()}
        meta["layout"][regime] = fn.quant_layout
        meta["parity"][regime] = {
            "tolerance": float(tolerance[regime]),
            "max_divergence": {k: float(v) for k, v in sorted(divergence.items())},
        }
        meta["payload_bytes"][regime] = sq.payload_nbytes(fn.quant_payload)
        # Claimed vs fired: what the program executes natively, and the
        # claimed kernels the lowering never ran, apart.
        claimed = list(fn.quant_native or ())
        fired = set(fn.quant_native_fired or ())
        attn_spec = fn.quant_attn
        native_entry = {
            "layers": [path for path in claimed if path in fired],
            "demoted": bool(getattr(fn, "quant_native_demoted", False)),
            "attention": sorted(key for key in fired if key.startswith("attn/")),
            "attention_eligibility": "auto" if attn_spec == "auto" else list(attn_spec),
        }
        unlowered = [path for path in claimed if path not in fired]
        if unlowered:
            logging.warning(
                "export: serve-quant %s eligibility claimed %d layer(s) the "
                "native lowering never ran (%s); they serve on the dequant path",
                regime, len(unlowered), ", ".join(unlowered))
            native_entry["unlowered"] = unlowered
        meta["native"][regime] = native_entry
        granularity = {"channel": 0, "block": 0}
        for entry in fn.quant_layout.values():
            granularity[entry.get("granularity", "block")] += 1
        meta["granularity"][regime] = granularity
        # The recorded clips and mode are those the program consumes.
        fired_scales = {
            key: float(value)
            for key, value in sorted((fn.quant_static_scales or {}).items())
            if (key.rsplit(":", 1)[0] in fired if key.startswith("attn/")
                else key in fired)
        }
        if not (native_entry["layers"] or native_entry["attention"]):
            fired_mode = None
        else:
            fired_mode = "static" if fired_scales else "dynamic"
        meta["calib"][regime] = {
            "mode": fired_mode,
            "static_scales": fired_scales,
            "demoted_to_dynamic": {
                key: float(value) for key, value in sorted(
                    (getattr(fn, "quant_static_demoted", None) or {}).items())
            },
        }
        layer_calibration = getattr(fn, "quant_layer_calibration", None)
        if layer_calibration and "layer_calibration" not in meta:
            meta["layer_calibration"] = {
                key: {stat: int(value) if stat == "samples" else float(value)
                      for stat, value in entry.items()}
                for key, entry in sorted(layer_calibration.items())
            }
    return meta


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
    program_batches: Optional[Sequence[int]] = None,
    serve_quant_fns: Optional[Mapping[str, torch.nn.Module]] = None,
    quant_parity_tol: Optional[Mapping[str, float]] = None,
    calibration_batches: Optional[Sequence[Mapping[str, Any]]] = None,
    aot_executables: Optional[bool] = None,
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
      program_batches: the static batches of a serving module that takes
        gradients (STATIC_BATCHES when None); ignored otherwise.
      serve_quant_fns: {regime: QuantServingModule}
        (export_generators.create_quant_serving_fn). Each regime must pass
        its parity gate against `serving_module` over
        `calibration_batches`, or this call raises QuantParityError and
        writes nothing; each adds quant/params_<regime>.pt and its program.
      quant_parity_tol: per-regime gate overrides of
        serve_quant.DEFAULT_PARITY_TOL.
      calibration_batches: the warmup corpus (flat numpy batches) the
        gates replay; required with serve_quant_fns. With AOT packages
        each batch is a bucket.
      aot_executables: compile an AOTInductor package per (regime,
        calibration batch) into aot/ (export/aot.py); None reads
        T2R_AOT_EXPORT (0 by default).
    """
    quantization.check_bits(quantize_bits)
    in_module = getattr(serving_module, "quantized_variables", None)
    serve_quant_meta = None
    if serve_quant_fns:
        if in_module is not None or quantize_weights:
            raise ValueError(
                "serve_quant_fns cannot combine with quantize_weights: the "
                "parity gate needs the fp32 forward as its baseline.")
        if serving_module is None:
            raise ValueError(
                "serve-quant export requires serving_module (the fp32 forward "
                "is the parity baseline).")
        if not calibration_batches:
            raise ValueError(
                "serve-quant export requires calibration_batches: the "
                "artifact's own warmup corpus is the calibration and parity "
                "contract (the exporter's warmup_batch_sizes).")
        f32_device = module_device(serving_module)
        serve_quant_meta = _serve_quant_record(
            serve_quant_fns, lambda batch: run_batch(serving_module, batch, f32_device),
            calibration_batches, quant_parity_tol)
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

    program_ok, program_error, traced_on, static = False, None, None, None
    programs: Dict[Optional[int], torch.export.ExportedProgram] = {}
    if export_program_file and serving_module is not None and example_features is not None:
        try:
            os.makedirs(os.path.join(tmp_path, PROGRAM_DIR))
            if getattr(serving_module, "takes_gradients", False):
                static = sorted({int(b) for b in (program_batches or STATIC_BATCHES)})
                programs = {b: export_static_program(serving_module, example_features, b)
                            for b in static}
            else:
                programs = {None: export_program(serving_module, example_features,
                                                 max_batch)}
            for batch, program in programs.items():
                # The example batch would ride in the file (100 MB for a
                # full-width BC episode pair); the program does not need it.
                program.example_inputs = None
                torch.export.save(program, program_path(tmp_path) if batch is None
                                  else static_program_path(tmp_path, batch))
            program_ok = True
            traced_on = str(module_device(serving_module))
        except Exception as err:  # noqa: BLE001 — the program is best-effort;
            # variables + assets always land, so record why and move on.
            program_error = f"{type(err).__name__}: {err}"
    if serve_quant_meta is not None:
        baseline = programs.get(None) if program_ok else None
        _write_serve_quant(tmp_path, serve_quant_fns, serve_quant_meta,
                           example_features if export_program_file else None,
                           max_batch, baseline)

    if aot_executables is None:
        aot_executables = flags.get_bool("T2R_AOT_EXPORT")
    quant_programs = sorted(
        regime for regime, ok in ((serve_quant_meta or {}).get("stablehlo") or {}).items()
        if ok)
    aot_meta = None
    if aot_executables and calibration_batches and (program_ok or quant_programs):
        # Every saved program gets its packages: a failed f32 program must
        # not drop the regimes' (and vice versa); a skipped regime is
        # recorded under the block's errors.
        device = (module_device(serving_module) if serving_module is not None
                  else next(iter(serve_quant_fns.values())).device)
        aot_meta = _export_aot_executables(
            tmp_path, feature_spec, program_ok=program_ok, static=static,
            quant_programs=quant_programs, calibration_batches=calibration_batches,
            device=device)

    meta = {
        "global_step": int(global_step),
        "timestamp": int(final_name),
        "program": program_ok,
        "program_error": program_error,
        "program_device": traced_on,
        "program_batches": static if program_ok else None,
        "weights_int8": bool(quantize_weights),
        **({"weights_quantize_bits": int(quantize_bits)} if quantize_weights else {}),
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
    }
    table = _flax_table(serving_module, stored)
    if table:
        meta["flax_variables"] = table
    if serve_quant_meta is not None:
        meta["serve_quant"] = serve_quant_meta
    if aot_meta is not None:
        meta["aot"] = aot_meta
    if metadata:
        meta.update(metadata)
    with open(os.path.join(tmp_path, METADATA_FILENAME), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    os.replace(tmp_path, final_path)
    return final_path


def _flax_table(serving_module, stored) -> Dict[str, List[Any]]:
    """{state-dict name: [JAX flat path, dims]} of every tensor entry of
    variables.pt the serving network names (the torch leaf is its flax
    leaf permuted by dims), or {} without a network that maps."""
    network = getattr(serving_module, "network", None)
    if not isinstance(network, torch.nn.Module):
        return {}
    try:
        entries = sq.variable_entries(network)
    except Exception:  # noqa: BLE001 — a network the flax view cannot map
        # leaves the table out; readers fall back to the torch layout.
        return {}
    return {name: [path, [int(d) for d in dims]] for name, path, dims in entries
            if isinstance(stored.get(name), torch.Tensor)}


def serving_inputs(feature_spec: TensorSpecStruct) -> List[Any]:
    """(key, numpy dtype) of every input a program takes, in call order."""
    return [
        (key, numpy_dtype(spec.dtype))
        for key, spec in flatten_spec_structure(feature_spec).items()
        if isinstance(spec, ExtendedTensorSpec) and not spec.is_optional
    ]


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _export_aot_executables(tmp_path: str, feature_spec: TensorSpecStruct, *,
                            program_ok: bool, static: Optional[List[int]],
                            quant_programs: Sequence[str],
                            calibration_batches: Sequence[Mapping[str, Any]],
                            device: torch.device) -> Optional[Dict[str, Any]]:
    """Writes one AOTInductor package a (regime, warmup bucket) into
    `<tmp>/aot/`, a regime's buckets built side by side; returns the
    metadata block (None when nothing was attempted).

    A static program set's buckets are its program batches that have a
    warmup batch. A regime one of whose buckets fails to build, load or
    agree with its program (aot.build_bucket_executables) writes no
    package and records why under `errors`; the export still lands."""
    start = time.monotonic()
    inputs = serving_inputs(feature_spec)
    # Each bucket's call as ExportedModel.predict makes it: the spec's
    # inputs in its order, cast to its dtypes.
    batches = [{key: np.asarray(batch[key], dtype) for key, dtype in inputs}
               for batch in calibration_batches]
    meta: Dict[str, Any] = {
        "format_version": aot_lib.AOT_FORMAT_VERSION,
        "topology": aot_lib.device_topology(device),
        "fingerprint": {},
        "buckets": {},
        "nbytes": {},
    }
    regimes: Dict[str, Dict[str, Any]] = {}
    if program_ok and static:
        programs = {b: _read(static_program_path(tmp_path, b)) for b in static}
        regimes["none"] = dict(
            programs=programs, prefix=(),
            digests=[aot_lib.digest(programs[b]) for b in sorted(programs)],
            batches=[b for b in batches if aot_lib.bucket_of(b) in programs])
    elif program_ok:
        program = _read(program_path(tmp_path))
        regimes["none"] = dict(programs=program, prefix=(),
                               digests=[aot_lib.digest(program)], batches=batches)
    else:
        meta.setdefault("errors", {})["none"] = (
            "no serving program (the program export failed; see program_error)")
    for regime in quant_programs:
        program = _read(os.path.join(tmp_path, quant_program_relpath(regime)))
        payload = _read(os.path.join(tmp_path, quant_payload_relpath(regime)))
        regimes[regime] = dict(
            programs=program,
            prefix=(torch.load(io.BytesIO(payload), map_location="cpu", weights_only=True),),
            digests=[aot_lib.digest(program), aot_lib.digest(payload)], batches=batches)
    for regime, entry in regimes.items():
        fingerprint = aot_lib.artifact_fingerprint(regime, entry["digests"])
        compile_ms: Dict[int, float] = {}
        parity: Dict[int, float] = {}
        try:
            if not entry["batches"]:
                raise aot_lib.AOTError("no warmup batch matches a program batch")
            blobs = aot_lib.build_bucket_executables(
                entry["programs"], entry["batches"], regime, fingerprint,
                prefix_args=entry["prefix"], timings_ms=compile_ms, parity=parity,
                device=device)
        except Exception as err:  # noqa: BLE001 — best effort, recorded;
            # the restore ladder handles the absence.
            logging.warning("export: AOT packages for regime %r skipped (%s: %s)",
                            regime, type(err).__name__, err)
            meta.setdefault("errors", {})[regime] = f"{type(err).__name__}: {err}"
            continue
        os.makedirs(os.path.join(tmp_path, aot_lib.AOT_DIR), exist_ok=True)
        for bucket, blob in sorted(blobs.items()):
            with open(os.path.join(tmp_path, aot_lib.aot_relpath(regime, bucket)), "wb") as f:
                f.write(blob)
        meta["fingerprint"][regime] = fingerprint
        meta["buckets"][regime] = sorted(blobs)
        meta["nbytes"][regime] = int(sum(len(b) for b in blobs.values()))
        # The builds overlap, so a regime's publish cost is ~ the max.
        meta.setdefault("compile_ms", {})[regime] = {
            str(bucket): compile_ms[bucket] for bucket in sorted(compile_ms)}
        # Port-only: each package's largest |package - program| / (1 +
        # |program|) on its warmup batch (aot.PACKAGE_PARITY_TOL).
        meta.setdefault("parity", {})[regime] = {
            str(bucket): parity[bucket] for bucket in sorted(parity)}
    # Port-only: the pass's wall clock, builds, loads and checks included.
    meta["wall_ms"] = round((time.monotonic() - start) * 1e3, 3)
    return meta


def _write_serve_quant(tmp_path, serve_quant_fns, meta, example_features,
                       max_batch, baseline) -> None:
    """Each regime's payload, and its program with the dot and reduce
    audits of its graph (best-effort like the f32 program: a failure is
    recorded under stablehlo_error, the version still lands)."""
    os.makedirs(os.path.join(tmp_path, QUANT_DIR), exist_ok=True)
    for regime in sorted(serve_quant_fns):
        fn = serve_quant_fns[regime]
        sq.save_payload(fn.quant_payload,
                        os.path.join(tmp_path, quant_payload_relpath(regime)))
        if example_features is None:
            meta["stablehlo"][regime] = False
            continue
        try:
            program = export_quant_program(fn, example_features, max_batch)
            program.example_inputs = None
            os.makedirs(os.path.join(tmp_path, PROGRAM_DIR), exist_ok=True)
            torch.export.save(program, os.path.join(tmp_path, quant_program_relpath(regime)))
        except Exception as err:  # noqa: BLE001 — best-effort, recorded
            meta["stablehlo"][regime] = False
            meta.setdefault("stablehlo_error", {})[regime] = f"{type(err).__name__}: {err}"
            continue
        meta["stablehlo"][regime] = True
        meta.setdefault("dot_audit", {})[regime] = sq.audit_dot_dtypes(program)
        meta.setdefault("reduce_audit", {})[regime] = sq.audit_quant_reduces(
            program, baseline=baseline)


def read_metadata(export_dir: str) -> Dict[str, Any]:
    with open(os.path.join(export_dir, METADATA_FILENAME)) as f:
        return json.load(f)


class ExportedModel:
    """A loaded export version: specs, metadata, variables and, when the
    export has one, its program moved to `device` (the card by default).

    quant_regime selects the serving regime: "fp16", "int8", "fp8_e4m3" or
    "fp8_e5m2" load that regime's program and payload (the payload onto
    `device` once); None reads T2R_SERVE_QUANT; "none" is the f32 loader.
    A regime the export was not made with raises, naming the flag: a fleet
    never falls back to f32 silently.

    AOT restore (T2R_SERVE_AOT, on by default): each bucket the metadata's
    `aot` block declares for the regime is loaded from its package in
    aot/ after the integrity, fingerprint, topology and version checks
    (export/aot.py). A bucket that cannot load falls back LOUDLY to the
    exported program: logged, its reason in `aot_fallbacks`, counted by
    the policy server. With the flag off (or no aot/) this class serves
    as it did before the packages existed."""

    def __init__(self, export_dir: str, device: Union[str, torch.device] = DEFAULT_DEVICE,
                 quant_regime: Optional[str] = None):
        self.export_dir = export_dir
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.metadata = read_metadata(export_dir)
        self.feature_spec, self.label_spec, self.global_step = read_t2r_assets(
            export_dir
        )
        self._inputs = serving_inputs(self.feature_spec)
        if quant_regime is None:
            quant_regime = flags.get_enum("T2R_SERVE_QUANT")
        self.quant_regime = quant_regime
        #: {None: the dynamic-batch program} or {batch: static program}.
        self._modules: Dict[Optional[int], torch.nn.Module] = {}
        #: sha256 of each loaded program file, keyed as _modules.
        self._program_digests: Dict[Optional[int], bytes] = {}
        #: The regime's payload on `device` (None for "none").
        self._payload = None
        if quant_regime != "none":
            quant_meta = self.metadata.get("serve_quant") or {}
            if quant_regime not in (quant_meta.get("regimes") or ()):
                raise ValueError(
                    f"T2R_SERVE_QUANT={quant_regime} but export {export_dir} "
                    f"carries regimes {quant_meta.get('regimes') or []}; re-export "
                    f"with serve_quant=({quant_regime!r},) or serve it with "
                    "T2R_SERVE_QUANT=none.")
            if (quant_meta.get("stablehlo") or {}).get(quant_regime):
                self._modules = {None: self._load_program(
                    os.path.join(export_dir, quant_program_relpath(quant_regime)))}
                self._payload = sq.load_payload(
                    os.path.join(export_dir, quant_payload_relpath(quant_regime)),
                    self.device)
        elif self.metadata.get("program"):
            batches = self.metadata.get("program_batches")
            paths = ({None: program_path(export_dir)} if not batches else
                     {int(b): static_program_path(export_dir, b) for b in batches})
            self._modules = {b: self._load_program(path, b) for b, path in paths.items()}
        # -- AOT packages (tier 1 of the restore ladder) ----------------------
        self.aot_enabled = flags.get_bool("T2R_SERVE_AOT")
        self.aot_executables: Dict[int, Any] = {}
        self.aot_headers: Dict[int, Dict[str, Any]] = {}
        self.aot_fallbacks: Dict[int, str] = {}
        #: Batches the exported program ran because their bucket had no
        #: package: an AOT-hit boot finishes its prewarm with 0 here.
        self.fresh_trace_calls = 0
        aot_meta = self.metadata.get("aot") or {}
        declared = (aot_meta.get("buckets") or {}).get(self.quant_regime) or []
        self.aot_declared = tuple(sorted(int(b) for b in declared))
        if self.aot_enabled and self.aot_declared and self._modules:
            self._load_aot(aot_meta)
        if flags.get_bool("T2R_AOT_REQUIRE"):
            if not self.aot_enabled:
                # A contradictory flag pair names itself, not the artifact.
                raise aot_lib.AOTError(
                    "T2R_AOT_REQUIRE=1 conflicts with T2R_SERVE_AOT=0: "
                    "strict AOT boots cannot be required while AOT "
                    "restore is disabled; unset one of the two flags.")
            if not self.aot_covered:
                raise aot_lib.AOTError(
                    f"T2R_AOT_REQUIRE=1 but export {export_dir} cannot "
                    f"serve every warmup bucket from AOT packages for "
                    f"regime {self.quant_regime!r}: "
                    f"declared={list(self.aot_declared)}, "
                    f"loaded={sorted(self.aot_executables)}, "
                    f"fallbacks={self.aot_fallbacks}, "
                    f"warmup={self.metadata.get('warmup_batch_sizes')}")

    def _load_program(self, path: str, key: Optional[int] = None) -> torch.nn.Module:
        # Registers t2r_torch::flash_fwd, which the program may call.
        import torch.export.passes

        from tensor2robot_tpu_torch.ops import flash_attention  # noqa: F401

        data = _read(path)
        # The program's digest feeds the AOT fingerprint check.
        self._program_digests[key] = hashlib.sha256(data).digest()
        program = aot_lib.load_exported(io.BytesIO(data))
        if self.metadata.get("program_device") != str(self.device):
            program = torch.export.passes.move_to_device_pass(program, self.device)
        return program.module()

    def _expected_aot_fingerprint(self) -> str:
        """Recomputed from THIS artifact's own files: a transplanted or
        stale aot/ can never pass it."""
        digests = [self._program_digests[key] for key in sorted(
            self._program_digests, key=lambda k: -1 if k is None else k)]
        if self.quant_regime != "none":
            digests.append(hashlib.sha256(_read(os.path.join(
                self.export_dir, quant_payload_relpath(self.quant_regime)))).digest())
        return aot_lib.artifact_fingerprint(self.quant_regime, digests)

    def _load_aot(self, aot_meta: Mapping[str, Any]) -> None:
        topology = aot_lib.device_topology(self.device)
        recorded = aot_meta.get("topology") or {}
        if dict(recorded) != topology:
            # Built for another device: one loud line for the artifact,
            # every bucket counted as a fallback, nothing loaded.
            logging.warning(
                "AOT restore: export %s was compiled for topology %s but "
                "this host is %s; falling back to the exported program for "
                "all %d buckets", self.export_dir, recorded, topology,
                len(self.aot_declared))
            for bucket in self.aot_declared:
                self.aot_fallbacks[bucket] = "topology_mismatch"
            return
        expected = self._expected_aot_fingerprint()
        for bucket in self.aot_declared:
            path = os.path.join(self.export_dir, aot_lib.aot_relpath(self.quant_regime, bucket))
            try:
                blob = _read(path)
            except OSError as err:
                logging.warning("AOT restore: bucket %d package unreadable (%s); "
                                "falling back", bucket, err)
                self.aot_fallbacks[bucket] = "missing"
                continue
            try:
                runner, header = aot_lib.load_executable(
                    blob, expect_fingerprint=expected, expect_topology=topology)
                if (int(header.get("bucket", -1)) != bucket
                        or header.get("regime") != self.quant_regime):
                    raise aot_lib.AOTKeyMismatch(
                        f"file is keyed ({header.get('regime')!r}, "
                        f"{header.get('bucket')}), wanted "
                        f"({self.quant_regime!r}, {bucket})")
            except aot_lib.AOTError as err:
                logging.warning("AOT restore: bucket %d falls back to the exported "
                                "program (%s: %s)", bucket, type(err).__name__, err)
                self.aot_fallbacks[bucket] = type(err).__name__
                continue
            self.aot_executables[bucket] = runner
            self.aot_headers[bucket] = header

    @property
    def aot_covered(self) -> bool:
        """True when every warmup bucket of the artifact's ladder serves
        from a loaded package: a boot that runs no eager program."""
        sizes = self.metadata.get("warmup_batch_sizes") or []
        return bool(sizes) and all(int(size) in self.aot_executables for size in sizes)

    def _aot_runner(self, inputs: Dict[str, torch.Tensor]):
        """The package for exactly this batch's signature, or None (a
        novel shape or dtype is the exported program's, not an error)."""
        if not self.aot_executables or not inputs:
            return None
        batch = int(next(iter(inputs.values())).shape[0])
        runner = self.aot_executables.get(batch)
        if runner is None:
            return None
        header = self.aot_headers[batch]
        if list(inputs) != header.get("feature_keys") or aot_lib.feature_signature(
                inputs) != header.get("features"):
            return None
        return runner

    @property
    def has_program(self) -> bool:
        return bool(self._modules)

    def _quant_entry(self, block: str) -> Dict[str, Any]:
        if self.quant_regime == "none":
            return {}
        entries = (self.metadata.get("serve_quant") or {}).get(block) or {}
        return entries.get(self.quant_regime) or {}

    @property
    def native_dot_layers(self) -> tuple:
        """Flat kernel paths the loaded regime's program contracts natively
        in the storage dtype (empty for "none", fp16, or a demoted map)."""
        return tuple(self._quant_entry("native").get("layers") or ())

    @property
    def native_attention(self) -> tuple:
        """Attention modules whose QK^T and PV the loaded regime's program
        runs on quantized operands (empty for flash heads)."""
        return tuple(self._quant_entry("native").get("attention") or ())

    @property
    def calib_mode(self) -> Optional[str]:
        """'static', 'dynamic' or None (no native contraction)."""
        return self._quant_entry("calib").get("mode")

    @property
    def quant_reduce_audit(self) -> Optional[Dict[str, Any]]:
        """The export's reduce audit of the loaded regime's program;
        activation_quant_reduces == 0 proves static calibration."""
        return self._quant_entry("reduce_audit") or None

    @property
    def program_batches(self) -> Optional[List[int]]:
        """The static batches of a program set (None for one dynamic
        program or none)."""
        return sorted(self._modules) if self._modules and None not in self._modules else None

    def _run(self, key: Optional[int], inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The bucket's package when one loaded for this signature, else
        the exported program `key` (counted in fresh_trace_calls)."""
        runner = self._aot_runner(inputs)
        module = self._modules[key] if runner is None else runner
        if runner is None:
            self.fresh_trace_calls += 1
        if self._payload is not None:
            return dict(module(self._payload, inputs))
        return dict(module(inputs))

    def _run_static(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        batch = next(iter(inputs.values())).shape[0]
        fits = [b for b in sorted(self._modules) if b >= batch]
        if not fits:
            raise ValueError(f"batch {batch} exceeds the export's program batches "
                             f"{sorted(self._modules)}")
        size = fits[0]
        if size != batch:
            inputs = {key: torch.cat([value] + [value[-1:]] * (size - batch))
                      for key, value in inputs.items()}
        out = self._run(size, inputs)
        return {key: value[:batch] for key, value in out.items()}

    def traced_predict(self, features: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The program on tensors already on `device` (no host copies), so
        a caller can keep a loop on the card. A batch whose signature has a
        loaded package runs the package; any other runs the program."""
        if not self._modules:
            if self.quant_regime != "none":
                errors = (self.metadata.get("serve_quant") or {}).get("stablehlo_error")
                raise RuntimeError(
                    f"Export {self.export_dir} has no program for quant regime "
                    f"{self.quant_regime!r} ({(errors or {}).get(self.quant_regime)}).")
            raise RuntimeError(
                f"Export {self.export_dir} has no program; serving it needs "
                f"model code ({self.metadata.get('program_error')})."
            )
        inputs = {key: features[key] for key, _ in self._inputs}
        with torch.no_grad():
            if None in self._modules:
                return self._run(None, inputs)
            return self._run_static(inputs)

    def predict(self, flat_features: Mapping[str, Any]) -> Dict[str, np.ndarray]:
        """Host numpy in, host numpy out (each input cast to its spec's
        dtype and copied to `device`)."""
        if not self._modules:
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
