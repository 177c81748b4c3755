"""Operative-config logging hook.

Port of tensor2robot_tpu/hooks/gin_config_hook_builder.py: logs the
operative config once at train begin. The trainer itself writes
`operative_config.gin` into model_dir at start and at exit.
"""

from __future__ import annotations

import logging
from typing import List

from tensor2robot_tpu_torch import config as cfg
from tensor2robot_tpu_torch.config import configurable
from tensor2robot_tpu_torch.hooks.hook_builder import Hook, HookBuilder


class ConfigLoggerHook(Hook):
    """Logs the operative config once at train begin."""

    def __init__(self):
        self._logged = False

    def on_train_begin(self, ctx) -> None:
        if self._logged:
            return
        self._logged = True
        logging.info("Operative config:\n%s", cfg.operative_config_str())


@configurable("ConfigLoggerHookBuilder")
class ConfigLoggerHookBuilder(HookBuilder):
    def create_hooks(self, t2r_model, trainer=None) -> List[Hook]:
        return [ConfigLoggerHook()]
