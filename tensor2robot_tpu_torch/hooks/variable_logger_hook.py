"""Variable statistics logging.

Port of tensor2robot_tpu/hooks/variable_logger_hook.py: on every
multiple of `every_steps` (a host read of every parameter would throttle
the device loop if done each step) logs each parameter's shape, mean and
standard deviation, and optionally its values. Under iterations_per_loop
the step advances by K, so the hook logs at the iteration that crosses a
multiple.
"""

from __future__ import annotations

import logging
from typing import List

from tensor2robot_tpu_torch.config import configurable
from tensor2robot_tpu_torch.hooks.hook_builder import Hook, HookBuilder


class VariableLoggerHook(Hook):
    """Logs mean/std (optionally values) of all parameters."""

    def __init__(self, log_values: bool = False, every_steps: int = 100):
        self._log_values = log_values
        self._every_steps = max(1, every_steps)
        self._seen_step = 0

    def on_train_begin(self, ctx) -> None:
        self._seen_step = ctx.step

    def after_step(self, ctx) -> None:
        crossed = ctx.step // self._every_steps > self._seen_step // self._every_steps
        self._seen_step = ctx.step
        if not crossed or ctx.state is None:
            return
        for name, param in ctx.state.network.named_parameters():
            array = param.detach().double().cpu().numpy()
            message = (
                f"step={ctx.step} var={name} shape={array.shape} "
                f"mean={array.mean():.6f} std={array.std():.6f}"
            )
            if self._log_values:
                message += f" values={array!r}"
            logging.info("%s", message)


@configurable("VariableLoggerHookBuilder")
class VariableLoggerHookBuilder(HookBuilder):
    def __init__(self, log_values: bool = False, every_steps: int = 100):
        self._log_values = log_values
        self._every_steps = every_steps

    def create_hooks(self, t2r_model, trainer=None) -> List[Hook]:
        return [
            VariableLoggerHook(
                log_values=self._log_values, every_steps=self._every_steps
            )
        ]
