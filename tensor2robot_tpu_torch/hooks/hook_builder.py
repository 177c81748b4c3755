"""Hook protocol: side-channel behaviors on the host training loop.

Port of tensor2robot_tpu/hooks/hook_builder.py. The trainer is an explicit
host loop, so hooks are plain callbacks, called in this order by
train/train_eval.train_eval_model:

  on_train_begin(ctx)            once, after state creation or restore
  before_step(ctx)               each host loop iteration
  after_step(ctx)                each iteration; ctx.metrics set on log steps
  after_checkpoint_saved(ctx)    after every checkpoint write
  after_eval(ctx)                after each evaluation (ctx.eval_metrics)
  on_train_end(ctx)              once

Under iterations_per_loop = K an iteration is K steps and the hooks see
the last step's metrics. A HookBuilder creates hooks given the model and
the trainer, so configs can inject hook sets.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class HookContext:
    """Mutable view of the training loop passed to every hook call."""

    model: Any = None
    model_dir: Optional[str] = None
    step: int = 0
    state: Any = None  # the live TrainState: its tensors change in place
    metrics: Optional[Dict[str, float]] = None  # host floats, log steps only
    device_metrics: Optional[Dict[str, Any]] = None  # every step, on device
    eval_metrics: Optional[Dict[str, float]] = None
    checkpoint_path: Optional[str] = None
    eval_name: Optional[str] = None


class Hook:
    def on_train_begin(self, ctx: HookContext) -> None:
        pass

    def before_step(self, ctx: HookContext) -> None:
        pass

    def after_step(self, ctx: HookContext) -> None:
        pass

    def after_checkpoint_saved(self, ctx: HookContext) -> None:
        pass

    def after_eval(self, ctx: HookContext) -> None:
        pass

    def on_train_end(self, ctx: HookContext) -> None:
        pass


class HookBuilder(abc.ABC):
    """Creates hooks for a (model, trainer) pair."""

    @abc.abstractmethod
    def create_hooks(self, t2r_model, trainer=None) -> List[Hook]:
        ...
