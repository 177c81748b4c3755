"""Profiling hooks: torch.profiler traces, synced step timing and MFU.

Port of tensor2robot_tpu/hooks/profiling_hook_builder.py:

  * ProfilerHookBuilder captures a torch.profiler trace (CPU and, on the
    card, CUDA activity: every kernel by name, the flash kernels
    included) of the steps [start_step, start_step + num_steps) into
    `model_dir/profiling/trace_<first>_<last>.json` (Chrome trace format).
  * StepTimingHookBuilder times steps on the host clock anchored by a
    device sync every `sync_every` steps (the loop never waits on the card
    otherwise, so raw host timestamps would measure dispatch), and writes
    steps/s, plus MFU when `flops_per_step` and `peak_flops` are given,
    as JSON lines into model_dir/profiling/step_timing.jsonl.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import torch

from tensor2robot_tpu_torch.config import configurable
from tensor2robot_tpu_torch.hooks.hook_builder import Hook, HookBuilder, HookContext


def _in_model_dir(path: str, ctx: HookContext) -> str:
    if not os.path.isabs(path) and ctx.model_dir:
        return os.path.join(ctx.model_dir, path)
    return path


def _sync(ctx: HookContext) -> None:
    """Waits for the step's device work: a host read of its loss."""
    loss = (ctx.device_metrics or {}).get("loss")
    if isinstance(loss, torch.Tensor):
        float(loss)


def _drain() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class ProfilerHook(Hook):
    def __init__(self, log_dir: str, start_step: int, num_steps: int):
        self._log_dir = log_dir
        self._start = start_step
        self._stop = start_step + num_steps
        self._profiler: Optional[torch.profiler.profile] = None
        self._first_step = None
        self._done = False
        self.trace_path: Optional[str] = None

    def before_step(self, ctx: HookContext) -> None:
        # >= (not a range check): under iterations_per_loop ctx.step
        # advances by K and may never land inside the window.
        if self._profiler is None and not self._done and ctx.step >= self._start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            _drain()
            self._first_step = ctx.step
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()

    def after_step(self, ctx: HookContext) -> None:
        if self._profiler is not None and ctx.step >= self._stop:
            self._finish(ctx)

    def _finish(self, ctx: HookContext) -> None:
        _drain()  # the trace holds whole steps
        self._profiler.stop()
        log_dir = _in_model_dir(self._log_dir, ctx)
        os.makedirs(log_dir, exist_ok=True)
        self.trace_path = os.path.join(
            log_dir, f"trace_{self._first_step + 1}_{ctx.step}.json")
        self._profiler.export_chrome_trace(self.trace_path)
        self._profiler = None
        self._done = True

    def on_train_end(self, ctx: HookContext) -> None:
        if self._profiler is not None:
            self._finish(ctx)


@configurable("ProfilerHookBuilder")
class ProfilerHookBuilder(HookBuilder):
    """Traces steps [start_step, start_step + num_steps) into
    model_dir/profiling/ (or an explicit log_dir)."""

    def __init__(
        self,
        start_step: int = 10,
        num_steps: int = 5,
        log_dir: Optional[str] = None,
    ):
        self._start_step = start_step
        self._num_steps = num_steps
        self._log_dir = log_dir
        self.hook: Optional[ProfilerHook] = None

    def create_hooks(self, t2r_model, trainer=None) -> List[Hook]:
        del t2r_model, trainer
        self.hook = ProfilerHook(
            self._log_dir or "profiling", self._start_step, self._num_steps)
        return [self.hook]


class StepTimingHook(Hook):
    def __init__(
        self,
        sync_every: int,
        flops_per_step: Optional[float],
        peak_flops: Optional[float],
        output_path: Optional[str],
    ):
        self._sync_every = sync_every
        self._flops = flops_per_step
        self._peak = peak_flops
        self._path = output_path
        self._t_anchor: Optional[float] = None
        self._anchor_step: Optional[int] = None
        self._rows: List[Dict[str, Any]] = []

    def after_step(self, ctx: HookContext) -> None:
        # Steps since the anchor (not step % N == 0): under
        # iterations_per_loop ctx.step advances by K and may never hit an
        # exact multiple of sync_every.
        if (
            self._anchor_step is not None
            and ctx.step - self._anchor_step < self._sync_every
        ):
            return
        _sync(ctx)
        now = time.perf_counter()
        if self._t_anchor is not None and ctx.step > self._anchor_step:
            steps = ctx.step - self._anchor_step
            steps_per_sec = steps / max(now - self._t_anchor, 1e-9)
            row: Dict[str, Any] = {"step": ctx.step, "steps_per_sec": steps_per_sec}
            if self._flops:
                row["model_flops_per_sec"] = self._flops * steps_per_sec
                if self._peak:
                    row["mfu"] = self._flops * steps_per_sec / self._peak
            self._rows.append(row)
            if self._path is not None:
                path = _in_model_dir(self._path, ctx)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "a") as f:
                    f.write(json.dumps(row) + "\n")
        self._t_anchor = now
        self._anchor_step = ctx.step

    @property
    def rows(self) -> List[Dict[str, Any]]:
        return self._rows


@configurable("StepTimingHookBuilder")
class StepTimingHookBuilder(HookBuilder):
    """Synced steps/s (+ MFU when the FLOPs are known) into
    model_dir/profiling/step_timing.jsonl."""

    def __init__(
        self,
        sync_every: int = 50,
        flops_per_step: Optional[float] = None,
        peak_flops: Optional[float] = None,
        output_path: Optional[str] = "profiling/step_timing.jsonl",
    ):
        self._sync_every = sync_every
        self._flops = flops_per_step
        self._peak = peak_flops
        self._output_path = output_path
        self.hook: Optional[StepTimingHook] = None

    def create_hooks(self, t2r_model, trainer=None) -> List[Hook]:
        del t2r_model, trainer
        self.hook = StepTimingHook(
            self._sync_every, self._flops, self._peak, self._output_path
        )
        return [self.hook]
