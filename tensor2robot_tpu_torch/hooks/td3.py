"""TD3 export hooks: latest and lagged serving directories.

Port of tensor2robot_tpu/hooks/td3.py (`TD3Hooks`): the periodic async
export also keeps a `lagged_export_dir` one version behind — the target
network of TD3 (arXiv:1802.09477) as a pair of export directories robots
poll.
"""

from __future__ import annotations

from typing import Optional, Sequence

from tensor2robot_tpu_torch.config import configurable
from tensor2robot_tpu_torch.hooks.async_export_hook_builder import (
    AsyncExportHookBuilder,
)
from tensor2robot_tpu_torch.hooks.checkpoint_hooks import LaggedCheckpointListener


@configurable("TD3Hooks")
class TD3Hooks(AsyncExportHookBuilder):
    """Periodic export into the (latest, lagged) directory pair."""

    def __init__(
        self,
        export_dir: str,
        lagged_export_dir: str,
        save_secs: float = 90.0,
        num_versions: Optional[int] = 3,
        export_generator=None,
        warmup_batch_sizes: Sequence[int] = (),
    ):
        super().__init__(
            export_dir=export_dir,
            save_secs=save_secs,
            num_versions=num_versions,
            export_generator=export_generator,
            warmup_batch_sizes=warmup_batch_sizes,
        )
        self._lagged_export_dir = lagged_export_dir

    def create_hooks(self, t2r_model, trainer=None):
        if not self._export_dir and not self._lagged_export_dir:
            return []
        state_export_fn = self._make_state_export_fn(t2r_model, trainer)
        listener = LaggedCheckpointListener(
            export_fn=state_export_fn,
            export_dir=self._export_dir,
            lagged_export_dir=self._lagged_export_dir,
            num_versions=self._num_versions,
        )
        return [self._hook(listener, state_export_fn, t2r_model)]
