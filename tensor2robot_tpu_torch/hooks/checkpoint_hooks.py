"""Export listeners and the lagged (TD3) variant.

Port of tensor2robot_tpu/hooks/checkpoint_hooks.py.
`CheckpointExportListener` exports a serving artifact on every call of
`after_save`, keeping the newest `num_versions` (the versions already on
disk count). `LaggedCheckpointListener` also keeps a second directory
holding the model one export behind — the TD3 target network at the level
of export directories — and re-syncs the two at startup when they are out
of step.
"""

from __future__ import annotations

import collections
import logging
import os
import shutil
from typing import Callable, List, Optional


class _DirectoryVersionGC:
    """Observes a stream of directories and removes the oldest beyond
    num_versions."""

    def __init__(self, num_versions: int):
        self._queue: collections.deque = collections.deque()
        self._num_versions = num_versions

    def observe(self, directory: str) -> None:
        self._queue.append(directory)
        self._remove_if_necessary()

    def observe_multiple(self, directory_list: List[str]) -> None:
        self._queue.extend(directory_list)
        self._remove_if_necessary()

    def _remove_if_necessary(self) -> None:
        while len(self._queue) > self._num_versions:
            shutil.rmtree(self._queue.popleft(), ignore_errors=True)


class CheckpointExportListener:
    """Exports the model on every `after_save`.

    Args:
      export_fn: fn(export_dir, global_step) -> exported path.
      export_dir: root of the timestamped exports.
      num_versions: exports to keep (None keeps all).
    """

    def __init__(
        self,
        export_fn: Callable[[str, int], str],
        export_dir: str,
        num_versions: Optional[int] = None,
    ):
        self._export_fn = export_fn
        self._export_dir = export_dir
        os.makedirs(self._export_dir, exist_ok=True)
        self._gc: Optional[_DirectoryVersionGC] = None
        if num_versions:
            self._gc = _DirectoryVersionGC(num_versions)
            self._gc.observe_multiple(
                [
                    os.path.join(self._export_dir, name)
                    for name in sorted(os.listdir(self._export_dir))
                ]
            )

    def after_save(self, global_step: int) -> str:
        logging.info("Exporting model at global_step %d", global_step)
        exported_path = self._export_fn(self._export_dir, global_step)
        logging.info("Saved model to %s", exported_path)
        if self._gc:
            self._gc.observe(exported_path)
        return exported_path


class LaggedCheckpointListener(CheckpointExportListener):
    """Also keeps `lagged_export_dir` one version behind `export_dir`,
    re-syncing at startup."""

    def __init__(
        self,
        export_fn: Callable[[str, int], str],
        export_dir: str,
        lagged_export_dir: str,
        num_versions: Optional[int] = None,
    ):
        super().__init__(export_fn, export_dir, num_versions)
        self._lagged_export_dir = lagged_export_dir
        self._current_model_dir: Optional[str] = None
        self._lagged_model_dir: Optional[str] = None
        self._lagged_gc: Optional[_DirectoryVersionGC] = None
        if num_versions:
            self._lagged_gc = _DirectoryVersionGC(num_versions)
        os.makedirs(self._lagged_export_dir, exist_ok=True)

        export_dir_contents = sorted(os.listdir(self._export_dir))
        lagged_contents = sorted(os.listdir(self._lagged_export_dir))
        if self._lagged_gc:
            self._lagged_gc.observe_multiple(
                [
                    os.path.join(self._lagged_export_dir, name)
                    for name in lagged_contents
                ]
            )
        # Startup re-sync: the lagged dir holds the second-newest export
        # (or mirrors a lone export).
        if len(export_dir_contents) == 1:
            self._current_model_dir = os.path.join(
                self._export_dir, export_dir_contents[0]
            )
            if export_dir_contents == lagged_contents:
                self._lagged_model_dir = os.path.join(
                    self._lagged_export_dir, lagged_contents[0]
                )
            else:
                self._lagged_model_dir = self._copy_savedmodel(
                    self._current_model_dir, self._lagged_export_dir
                )
        elif len(export_dir_contents) > 1:
            second_last = export_dir_contents[-2]
            self._current_model_dir = os.path.join(
                self._export_dir, export_dir_contents[-1]
            )
            if not lagged_contents or second_last != lagged_contents[-1]:
                self._lagged_model_dir = self._copy_savedmodel(
                    os.path.join(self._export_dir, second_last),
                    self._lagged_export_dir,
                )
            else:
                self._lagged_model_dir = os.path.join(
                    self._lagged_export_dir, lagged_contents[-1]
                )

    def _copy_savedmodel(self, source_dir: str, destination: str) -> str:
        basename = os.path.basename(source_dir.rstrip("/"))
        dest = os.path.join(destination, basename)
        if not os.path.exists(dest):
            shutil.copytree(source_dir, dest)
        return dest

    def _copy_lagged_model(self, source_dir: str) -> str:
        destination_path = self._copy_savedmodel(
            source_dir, self._lagged_export_dir
        )
        if self._lagged_gc:
            self._lagged_gc.observe(destination_path)
        return destination_path

    def after_save(self, global_step: int) -> str:
        """Exports the latest, then advances the lagged dir to the
        previous latest."""
        export_dir = super().after_save(global_step)
        if not self._current_model_dir:
            self._lagged_model_dir = self._copy_lagged_model(export_dir)
        elif self._lagged_model_dir and os.path.basename(
            self._current_model_dir
        ) == os.path.basename(self._lagged_model_dir):
            pass  # Lagged already up to date with current.
        else:
            self._lagged_model_dir = self._copy_lagged_model(
                self._current_model_dir
            )
        self._current_model_dir = export_dir
        return export_dir
