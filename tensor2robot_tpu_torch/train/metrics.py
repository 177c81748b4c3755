"""Metrics writing: one JSON object per logged step.

Port of tensor2robot_tpu/train/metrics.py. The JAX package writes
TensorBoard events beside `metrics.jsonl` when asked (`use_tensorboard`)
and flax's TensorFlow writer imports, and otherwise keeps `metrics.jsonl`
alone. The port never imports TensorBoard, so it takes `use_tensorboard`
and always keeps `metrics.jsonl` alone: the JAX package's behaviour
without TensorFlow. The trainer reads the step's scalars to the host only
on log steps.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

#: Train metrics under these prefixes carry a leading batch dimension:
#: `golden/` tags tensors for golden capture (add_golden_tensor), and
#: grad-accum concatenates both back to the full batch.
GOLDEN_PREFIX = "golden/"
PER_EXAMPLE_PREFIX = "per_example/"
BATCH_CARRYING_METRIC_PREFIXES = (GOLDEN_PREFIX, PER_EXAMPLE_PREFIX)


def collective_record(
    bytes_pre: float,
    bytes_post: float,
    wall_ms: Optional[float] = None,
) -> Dict[str, float]:
    """The gradient exchange's metric keys: f32 and wire bytes a rank a
    step and their ratio, and (when measured) the exchange's wall time.
    The trainer merges them into every train log record."""
    record = {
        "collective/bytes_pre": float(bytes_pre),
        "collective/bytes_post": float(bytes_post),
        "collective/compression": float(bytes_pre) / float(bytes_post),
    }
    if wall_ms is not None:
        record["collective/wall_ms"] = float(wall_ms)
    return record


class MetricsWriter:
    """Appends {step, wall_time, metrics...} lines to <log_dir>/<filename>.
    `use_tensorboard` is accepted as the JAX package's writer takes it and
    writes nothing more (module docstring)."""

    def __init__(self, log_dir: str, filename: str = "metrics.jsonl",
                 use_tensorboard: bool = False):
        del use_tensorboard  # no TensorBoard in the port: metrics.jsonl alone
        os.makedirs(log_dir, exist_ok=True)
        self._file = open(os.path.join(log_dir, filename), "a")

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        record = {"step": int(step), "wall_time": time.time()}
        for key, value in metrics.items():
            record[key] = float(value)
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def close(self) -> None:
        self._file.close()


def read_metrics(log_dir: str, filename: str = "metrics.jsonl") -> List[dict]:
    path = os.path.join(log_dir, filename)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
