"""Timer-based export during training, off the host loop.

Port of tensor2robot_tpu/hooks/async_export_hook_builder.py: every
`save_secs` the current weights are exported as a serving artifact (the
port's export directory, export/saved_model.py) on one worker thread. If
the previous export is still running the tick is skipped, not queued, so
a slow filesystem never builds a backlog. At train end the terminal
weights are exported synchronously.

JAX arrays are immutable, so the JAX hook hands the worker the state as
it is. The optimizer here writes parameters in place, so the hook clones
the serving state dict on the main thread after the step, where the copy
is ordered on the device stream after the step's update and before the
next step's; the worker only ever reads that snapshot. While the worker
traces (torch.export), the trainer's next step waits: tracing sets a flag
that eager code on every thread reads (export/saved_model.TRACE_LOCK).
Writing the files runs beside training.
"""

from __future__ import annotations

import concurrent.futures
import logging
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from tensor2robot_tpu_torch.config import configurable
from tensor2robot_tpu_torch.export.export_generators import DefaultExportGenerator
from tensor2robot_tpu_torch.export.saved_model import (
    DEFAULT_MAX_BATCH,
    save_exported_model,
)
from tensor2robot_tpu_torch.hooks.checkpoint_hooks import CheckpointExportListener
from tensor2robot_tpu_torch.hooks.hook_builder import Hook, HookBuilder


def default_create_export_fn(
    model,
    trainer,
    export_generator=None,
    warmup_batch_sizes: Sequence[int] = (),
    quantize_weights: bool = False,
    quantize_bits: int = 8,
) -> Callable:
    """Builds fn(variables, export_dir, global_step) -> path, exporting a
    serving state dict with the t2r-assets spec contract on the trainer's
    device. quantize_weights stores int8 (or int4) weight-only variables
    (export/quantization.py)."""
    generator = export_generator or DefaultExportGenerator()
    generator.set_specification_from_model(model)
    sizes = tuple(int(b) for b in warmup_batch_sizes)

    def export_fn(variables, export_dir: str, global_step: int) -> str:
        serving_module = generator.create_serving_fn(
            variables, device=trainer.device, quantize_weights=quantize_weights,
            quantize_bits=quantize_bits,
        )
        path = save_exported_model(
            export_dir,
            variables=variables,
            feature_spec=generator.serving_input_spec(),
            label_spec=generator.label_spec,
            global_step=global_step,
            serving_module=serving_module,
            example_features=generator.create_example_features(),
            # The bucket contract of the policy server (serving/buckets.py).
            metadata={"warmup_batch_sizes": list(sizes)},
            quantize_weights=quantize_weights,
            quantize_bits=quantize_bits,
            max_batch=max(sizes + (DEFAULT_MAX_BATCH,)),
            program_batches=sizes or None,
        )
        if sizes:
            generator.write_warmup_requests(
                generator.generate_warmup_batches(sizes), path)
        return path

    return export_fn


def serving_snapshot(model, state) -> Dict[str, torch.Tensor]:
    """A copy of the state's serving weights (the EMA where the model
    keeps one), enqueued after the step that produced them."""
    use_ema = getattr(model, "use_avg_model_params", False)
    return {k: v.detach().clone()
            for k, v in state.export_state_dict(use_ema=use_ema).items()}


class AsyncExportHook(Hook):
    """Exports every `save_secs` seconds via a listener, off the host loop."""

    def __init__(
        self,
        listener: CheckpointExportListener,
        state_export_fn: Callable,
        save_secs: float,
        model,
    ):
        self._listener = listener
        self._state_export_fn = state_export_fn
        self._save_secs = save_secs
        self._model = model
        self._last_export_time: Optional[float] = None
        self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[concurrent.futures.Future] = None

    def _submit(self, state, step: int) -> None:
        if self._pending is not None and not self._pending.done():
            logging.warning(
                "Skipping export at step %d: previous export still running.",
                step,
            )
            return
        if self._pending is not None:
            exc = self._pending.exception()
            if exc is not None:
                logging.error("Previous async export failed: %s", exc)
        self._state_export_fn.variables = serving_snapshot(self._model, state)
        self._pending = self._executor.submit(self._listener.after_save, step)

    def on_train_begin(self, ctx) -> None:
        self._last_export_time = time.time()

    def after_step(self, ctx) -> None:
        now = time.time()
        if (
            self._last_export_time is None
            or now - self._last_export_time >= self._save_secs
        ):
            self._last_export_time = now
            self._submit(ctx.state, ctx.step)

    def on_train_end(self, ctx) -> None:
        # Final synchronous export with the terminal weights.
        if self._pending is not None:
            concurrent.futures.wait([self._pending])
            exc = self._pending.exception()
            if exc is not None:
                logging.error("Previous async export failed: %s", exc)
        self._executor.shutdown(wait=True)
        if ctx.state is not None:
            self._state_export_fn.variables = serving_snapshot(self._model, ctx.state)
            self._listener.after_save(ctx.step)


@configurable("AsyncExportHookBuilder")
class AsyncExportHookBuilder(HookBuilder):
    """Periodic export off the host loop into `export_dir`."""

    def __init__(
        self,
        export_dir: str,
        save_secs: float = 90.0,
        num_versions: Optional[int] = 3,
        export_generator=None,
        warmup_batch_sizes: Sequence[int] = (),
        quantize_weights: bool = False,
    ):
        self._export_dir = export_dir
        self._save_secs = save_secs
        self._num_versions = num_versions
        self._export_generator = export_generator
        self._warmup_batch_sizes = tuple(warmup_batch_sizes)
        self._quantize_weights = quantize_weights

    def _make_state_export_fn(self, t2r_model, trainer):
        export_fn = default_create_export_fn(
            t2r_model,
            trainer,
            export_generator=self._export_generator,
            warmup_batch_sizes=self._warmup_batch_sizes,
            quantize_weights=self._quantize_weights,
        )

        def state_export_fn(export_dir: str, global_step: int) -> str:
            return export_fn(state_export_fn.variables, export_dir, global_step)

        state_export_fn.variables = None
        return state_export_fn

    def _hook(self, listener, state_export_fn, t2r_model) -> AsyncExportHook:
        return AsyncExportHook(listener, state_export_fn, self._save_secs, t2r_model)

    def create_hooks(self, t2r_model, trainer=None):
        if not self._export_dir:
            return []
        state_export_fn = self._make_state_export_fn(t2r_model, trainer)
        listener = CheckpointExportListener(
            export_fn=state_export_fn,
            export_dir=self._export_dir,
            num_versions=self._num_versions,
        )
        return [self._hook(listener, state_export_fn, t2r_model)]
