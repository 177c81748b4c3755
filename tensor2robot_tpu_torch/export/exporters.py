"""Train-time exporters: Latest and Best export policies and version GC.

Port of tensor2robot_tpu/export/exporters.py (without its serve-quant
regimes and AOT executables, ROADMAP.md A10). LatestExporter writes every
eval's weights; BestExporter gates on a metric compare fn and persists
its best value in `best_metrics.json`, so a resumed run keeps the gate.
Old versions are collected oldest first. Exports land under
`<model_dir>/export/<name>/<unix_seconds>/` (export/saved_model.py).

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
from tensor2robot_tpu_torch.export.export_generators import (
    AbstractExportGenerator,
    DefaultExportGenerator,
)
from tensor2robot_tpu_torch.export.saved_model import (
    DEFAULT_MAX_BATCH,
    list_export_dirs,
    save_exported_model,
)

DEFAULT_METRIC = "loss"


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
        export_program: bool = True,
        warmup_batch_sizes: Sequence[int] = (),
        quantize_weights: bool = False,
        quantize_bits: int = 8,
        serve_quant: Sequence[str] = (),
        aot_executables: Optional[bool] = None,
    ):
        if serve_quant or aot_executables:
            raise NotImplementedError(
                "serve_quant regimes and aot_executables are not ported yet "
                "(ROADMAP.md A10)"
            )
        self.name = name
        self._export_generator = export_generator or DefaultExportGenerator()
        self._gc = DirectoryVersionGC(exports_to_keep)
        self._export_program = export_program
        self._warmup_batch_sizes = tuple(int(b) for b in warmup_batch_sizes)
        # Fail at config time, not on the first export tick mid-run.
        self._quantize_bits = quantization.check_bits(quantize_bits)
        self._quantize_weights = quantize_weights

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
        )
        if self._warmup_batch_sizes:
            generator.write_warmup_requests(
                generator.generate_warmup_batches(self._warmup_batch_sizes), path
            )
        self._after_export(step, eval_metrics, root, path)
        self._gc.collect(root)
        return path

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
    export_program: bool = True,
    warmup_batch_sizes: Sequence[int] = (),
    quantize_weights: bool = False,
    quantize_bits: int = 8,
    serve_quant: Sequence[str] = (),
    aot_executables: Optional[bool] = None,
) -> List[Exporter]:
    """The latest + best exporter pair."""
    del t2r_model  # Specs are bound at export time from the trained model.
    make_gen = (lambda: export_generator) if export_generator else DefaultExportGenerator
    kwargs = dict(
        exports_to_keep=exports_to_keep, export_program=export_program,
        warmup_batch_sizes=warmup_batch_sizes,
        quantize_weights=quantize_weights, quantize_bits=quantize_bits,
        serve_quant=serve_quant, aot_executables=aot_executables,
    )
    return [
        LatestExporter(name="latest", export_generator=make_gen(), **kwargs),
        BestExporter(name="best", export_generator=make_gen(),
                     compare_fn=compare_fn, **kwargs),
    ]
