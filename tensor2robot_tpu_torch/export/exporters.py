"""Train-time exporters: Latest and Best export policies and version GC.

Port of tensor2robot_tpu/export/exporters.py. LatestExporter writes every eval's weights;
BestExporter gates on a metric compare fn and persists its best value in
`best_metrics.json`, so a resumed run keeps the gate. Old versions are
collected oldest first. Exports land under
`<model_dir>/export/<name>/<unix_seconds>/` (export/saved_model.py).

With `serve_quant` regimes each export also carries, per regime, a
quantized payload and its program (export/serve_quant.py): the inputs
calibrated over the export's own warmup corpus, the static per-layer
activation clips captured from the f32 forward over the same corpus
(T2R_SERVE_CALIB), each regime's native contractions triaged against the
f32 outputs (a regime that misses its tolerance natively is demoted
wholesale to the dequant path) and then gated in save_exported_model.

With `aot_executables` (None reads T2R_AOT_EXPORT at export time) each
export also carries one AOTInductor package per regime and warmup bucket
(export/aot.py); an explicit request needs the warmup ladder and the
programs, checked here at config time as the JAX package does.

The trainer calls `exporter.maybe_export(step=, state=, eval_metrics=,
compiled=, model_dir=)` after each evaluation; `compiled` is the
train/train_eval.py Trainer, whose model and device the export takes.
The EMA parameters are exported when the model keeps them.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Callable, Dict, List, Optional, Sequence

from tensor2robot_tpu_torch.export import quantization
from tensor2robot_tpu_torch.export import serve_quant as sq
from tensor2robot_tpu_torch.export.export_generators import (
    AbstractExportGenerator,
    DefaultExportGenerator,
)
from tensor2robot_tpu_torch.export.saved_model import (
    DEFAULT_MAX_BATCH,
    list_export_dirs,
    module_device,
    run_batch,
    save_exported_model,
)

DEFAULT_METRIC = "loss"


def _native_pre_gate(fn, rebuild_dequant: Callable, fp32_outputs, warmup_batches,
                     tolerance: float):
    """Parity triage of a regime's native contractions: a serving module
    that misses the regime's tolerance on the warmup corpus is rebuilt on
    the dequant path (blockwise payload, f32 contractions) and gated again
    in save_exported_model. Returns (fn, demoted); a demoted module carries
    `quant_native_demoted = True`, a passing one its measurement."""
    quant_outputs = [run_batch(fn, batch, fn.device, fn.quant_payload)
                     for batch in warmup_batches]
    divergence = sq.measure_parity(fp32_outputs, quant_outputs)
    if all(value <= tolerance for value in divergence.values()):
        fn.quant_measured_divergence = divergence
        return fn, False
    demoted = rebuild_dequant()
    demoted.quant_native_demoted = True
    return demoted, True


def create_valid_result_smaller(metric_key: str = DEFAULT_METRIC):
    """Best = strictly smaller metric."""

    def compare_fn(best: Optional[Dict[str, float]], current: Dict[str, float]) -> bool:
        if metric_key not in current:
            return False
        if best is None or metric_key not in best:
            return True
        return current[metric_key] < best[metric_key]

    return compare_fn


def create_valid_result_larger(metric_key: str = DEFAULT_METRIC):
    """Best = strictly larger metric."""

    def compare_fn(best: Optional[Dict[str, float]], current: Dict[str, float]) -> bool:
        if metric_key not in current:
            return False
        if best is None or metric_key not in best:
            return True
        return current[metric_key] > best[metric_key]

    return compare_fn


class DirectoryVersionGC:
    """Keeps the newest `keep` timestamped versions under a root."""

    def __init__(self, keep: int):
        self._keep = keep

    def collect(self, export_root: str) -> List[str]:
        removed = []
        if self._keep <= 0:
            return removed
        dirs = list_export_dirs(export_root)
        while len(dirs) > self._keep:
            victim = dirs.pop(0)
            shutil.rmtree(victim, ignore_errors=True)
            removed.append(victim)
        return removed


class Exporter:
    """Base exporter: owns an export generator, a destination and a GC."""

    def __init__(
        self,
        name: str,
        export_generator: Optional[AbstractExportGenerator] = None,
        exports_to_keep: int = 5,
        export_program: Optional[bool] = None,
        warmup_batch_sizes: Sequence[int] = (),
        quantize_weights: bool = False,
        quantize_bits: int = 8,
        serve_quant: Sequence[str] = (),
        quant_block: Optional[int] = None,
        quant_min_size: Optional[int] = None,
        quant_parity_tol: Optional[Dict[str, float]] = None,
        serve_calib: Optional[str] = None,
        aot_executables: Optional[bool] = None,
        serialize_stablehlo: Optional[bool] = None,
    ):
        """`serialize_stablehlo` is the JAX package's name of
        `export_program` (whether the export carries its programs); either
        name may be given, both only when they agree. The serve-quant
        keywords are the JAX package's and are checked here, at config
        time."""
        if (export_program is not None and serialize_stablehlo is not None
                and bool(export_program) != bool(serialize_stablehlo)):
            raise ValueError(
                f"export_program={export_program} and serialize_stablehlo="
                f"{serialize_stablehlo} disagree (one name of one switch)")
        self.name = name
        self._export_generator = export_generator or DefaultExportGenerator()
        self._gc = DirectoryVersionGC(exports_to_keep)
        self._export_program = next(
            (bool(v) for v in (export_program, serialize_stablehlo) if v is not None), True)
        self._warmup_batch_sizes = tuple(int(b) for b in warmup_batch_sizes)
        # Fail at config time, not on the first export tick mid-run.
        self._quantize_bits = quantization.check_bits(quantize_bits)
        self._quantize_weights = quantize_weights
        self._serve_quant = tuple(serve_quant)
        for regime in self._serve_quant:
            if regime not in sq.SERVE_QUANT_REGIMES:
                raise ValueError(
                    f"serve_quant regimes must be among {sq.SERVE_QUANT_REGIMES}, "
                    f"got {regime!r}")
        if self._serve_quant and not self._warmup_batch_sizes:
            raise ValueError(
                "serve_quant exports need warmup_batch_sizes: the warmup "
                "corpus is the calibration set and the parity-gate corpus.")
        if self._serve_quant and quantize_weights:
            raise ValueError(
                "serve_quant cannot combine with quantize_weights: the "
                "parity gate needs the fp32 forward as its baseline.")
        if self._serve_quant and not self._export_program:
            raise ValueError(
                "serve_quant requires serialize_stablehlo=True (export_program): "
                "without the per-regime programs the quantized payloads can "
                "never be served.")
        self._quant_block = quant_block
        self._quant_min_size = quant_min_size
        self._quant_parity_tol = dict(quant_parity_tol or {})
        if serve_calib is not None:
            sq.resolve_calib_mode(serve_calib)
        self._serve_calib = serve_calib
        # AOT packages per warmup bucket (export/aot.py): None defers to
        # T2R_AOT_EXPORT at export time. An explicit request without a
        # ladder or without programs has nothing to compile and fails here.
        if aot_executables and not self._warmup_batch_sizes:
            raise ValueError(
                "aot_executables=True needs warmup_batch_sizes: the "
                "warmup ladder is the set of batch shapes the AOT "
                "packages are compiled for.")
        if aot_executables and not self._export_program:
            raise ValueError(
                "aot_executables=True requires serialize_stablehlo=True "
                "(export_program): each package is compiled from the saved "
                "serving program.")
        self._aot_executables = aot_executables

    def export_root(self, model_dir: str) -> str:
        return os.path.join(model_dir, "export", self.name)

    def _should_export(self, step, eval_metrics, export_root) -> bool:
        return True

    def maybe_export(
        self,
        step: int,
        state,
        eval_metrics: Dict[str, float],
        compiled,
        model_dir: str,
    ) -> Optional[str]:
        """Exports `state`'s weights if the policy approves; returns the
        export path (or None)."""
        model = compiled.model
        root = self.export_root(model_dir)
        if not self._should_export(step, eval_metrics, root):
            return None
        generator = self._export_generator
        generator.set_specification_from_model(model)
        variables = state.export_state_dict(
            use_ema=getattr(model, "use_avg_model_params", False)
        )
        serving_module = generator.create_serving_fn(
            variables, device=compiled.device,
            quantize_weights=self._quantize_weights,
            quantize_bits=self._quantize_bits,
        )
        # The warmup corpus is generated before the export, so the
        # calibration and the parity gates run over the batches the
        # artifact ships as its warmup requests.
        warmup_batches = (generator.generate_warmup_batches(self._warmup_batch_sizes)
                          if self._warmup_batch_sizes else [])
        serve_quant_fns = None
        if self._serve_quant:
            serve_quant_fns = self._quant_serving_fns(
                generator, variables, compiled.device, serving_module, warmup_batches)
        path = save_exported_model(
            root,
            variables=variables,
            feature_spec=generator.serving_input_spec(),
            label_spec=generator.label_spec,
            global_step=step,
            serving_module=serving_module,
            example_features=generator.create_example_features(),
            export_program_file=self._export_program,
            metadata={
                "exporter": self.name,
                "eval_metrics": eval_metrics,
                # The serving bucket contract: the policy server pads every
                # batch to one of these prewarmed sizes.
                "warmup_batch_sizes": list(self._warmup_batch_sizes),
            },
            quantize_weights=self._quantize_weights,
            quantize_bits=self._quantize_bits,
            max_batch=max(self._warmup_batch_sizes + (DEFAULT_MAX_BATCH,)),
            program_batches=self._warmup_batch_sizes or None,
            serve_quant_fns=serve_quant_fns,
            quant_parity_tol=self._quant_parity_tol,
            calibration_batches=warmup_batches,
            aot_executables=self._aot_executables,
        )
        if warmup_batches:
            generator.write_warmup_requests(warmup_batches, path)
        self._after_export(step, eval_metrics, root, path)
        self._gc.collect(root)
        return path

    def _quant_serving_fns(self, generator, variables, device, serving_module,
                           warmup_batches) -> Dict[str, object]:
        """{regime: QuantServingModule}: the input clips, the static layer
        clips (with their demotions) when calibration is static and some
        native contraction can consume them, and each native regime
        triaged against the f32 outputs, computed once."""
        calibration = sq.calibrate_activations(warmup_batches)
        calib_mode = sq.resolve_calib_mode(self._serve_calib)
        min_size = (sq.DEFAULT_MIN_SIZE if self._quant_min_size is None
                    else int(self._quant_min_size))
        native_regimes = tuple(r for r in self._serve_quant if r in sq.NATIVE_DOT_REGIMES)
        static_scales: Dict[str, float] = {}
        static_demoted: Dict[str, float] = {}
        layer_calibration: Dict[str, Dict[str, float]] = {}
        if calib_mode == "static" and native_regimes:
            tree = sq.flax_variables(variables, serving_module.network)
            capture_can_pay_off = any(
                sq.resolve_native_eligibility(tree, regime, min_size=min_size)
                for regime in native_regimes
            ) or sq.resolve_native_attention(None) != ()
            if capture_can_pay_off:
                eager = generator.create_eager_serving_fn(variables, device=device)
                records: Dict[str, list] = {}
                with sq.capture_activations(records, eager.network):
                    for batch in warmup_batches:
                        run_batch(eager, batch, device)
                del eager
                layer_calibration = sq.calibrate_layer_activations(records)
                static_scales, static_demoted = sq.resolve_static_scales(
                    layer_calibration)
        tolerance = dict(sq.DEFAULT_PARITY_TOL)
        tolerance.update(self._quant_parity_tol)
        capture_saw_attention = any(k.startswith("attn/") for k in layer_calibration)
        fns: Dict[str, object] = {}
        fp32_outputs = None
        f32_device = module_device(serving_module)
        for regime in self._serve_quant:

            def make(native=None, attn=None, static=True, regime=regime):
                return generator.create_quant_serving_fn(
                    variables, regime=regime, block=self._quant_block,
                    min_size=self._quant_min_size, calibration=calibration,
                    native=native, static_scales=static_scales if static else None,
                    attn=attn, device=device)

            fn = make()
            if fn.quant_native or (fn.quant_attn != () and capture_saw_attention):
                if fp32_outputs is None:
                    fp32_outputs = [run_batch(serving_module, batch, f32_device)
                                    for batch in warmup_batches]
                fn, _ = _native_pre_gate(
                    fn, lambda make=make: make(native=(), attn=(), static=False),
                    fp32_outputs, warmup_batches, tolerance[regime])
            if regime in sq.NATIVE_DOT_REGIMES:
                fn.quant_static_demoted = dict(static_demoted)
                fn.quant_layer_calibration = layer_calibration
            fns[regime] = fn
        return fns

    def _after_export(self, step, eval_metrics, export_root, path) -> None:
        pass


class LatestExporter(Exporter):
    """Exports after every eval."""


class BestExporter(Exporter):
    """Exports only when `compare_fn(best, current)` approves; the best
    metrics persist in best_metrics.json so a resume keeps the gate."""

    def __init__(self, name: str = "best", compare_fn: Optional[Callable] = None,
                 **kwargs):
        super().__init__(name=name, **kwargs)
        self._compare_fn = compare_fn or create_valid_result_smaller()

    def _best_path(self, export_root: str) -> str:
        return os.path.join(export_root, "best_metrics.json")

    def _read_best(self, export_root: str) -> Optional[Dict[str, float]]:
        try:
            with open(self._best_path(export_root)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _should_export(self, step, eval_metrics, export_root) -> bool:
        if not eval_metrics:
            return False
        return self._compare_fn(self._read_best(export_root), eval_metrics)

    def _after_export(self, step, eval_metrics, export_root, path) -> None:
        os.makedirs(export_root, exist_ok=True)
        tmp = self._best_path(export_root) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dict(eval_metrics), f)
        os.replace(tmp, self._best_path(export_root))


def create_default_exporters(
    t2r_model,
    export_generator: Optional[AbstractExportGenerator] = None,
    compare_fn: Optional[Callable] = None,
    exports_to_keep: int = 5,
    export_program: Optional[bool] = None,
    warmup_batch_sizes: Sequence[int] = (),
    quantize_weights: bool = False,
    quantize_bits: int = 8,
    serve_quant: Sequence[str] = (),
    quant_parity_tol: Optional[Dict[str, float]] = None,
    serve_calib: Optional[str] = None,
    aot_executables: Optional[bool] = None,
    serialize_stablehlo: Optional[bool] = None,
) -> List[Exporter]:
    """The latest + best exporter pair (serialize_stablehlo is
    export_program's JAX name)."""
    del t2r_model  # Specs are bound at export time from the trained model.
    make_gen = (lambda: export_generator) if export_generator else DefaultExportGenerator
    kwargs = dict(
        exports_to_keep=exports_to_keep, export_program=export_program,
        warmup_batch_sizes=warmup_batch_sizes,
        quantize_weights=quantize_weights, quantize_bits=quantize_bits,
        serve_quant=serve_quant, quant_parity_tol=quant_parity_tol,
        serve_calib=serve_calib, aot_executables=aot_executables,
        serialize_stablehlo=serialize_stablehlo,
    )
    return [
        LatestExporter(name="latest", export_generator=make_gen(), **kwargs),
        BestExporter(name="best", export_generator=make_gen(),
                     compare_fn=compare_fn, **kwargs),
    ]
