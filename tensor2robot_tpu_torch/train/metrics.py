"""Metrics writing: one JSON object per logged step.

Port of tensor2robot_tpu/train/metrics.py (its JSONL channel; TensorBoard
events are not ported). The trainer reads the step's scalars to the host
only on log steps.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List

#: Train metrics under these prefixes carry a leading batch dimension:
#: `golden/` tags tensors for golden capture (add_golden_tensor), and
#: grad-accum concatenates both back to the full batch.
GOLDEN_PREFIX = "golden/"
PER_EXAMPLE_PREFIX = "per_example/"
BATCH_CARRYING_METRIC_PREFIXES = (GOLDEN_PREFIX, PER_EXAMPLE_PREFIX)


class MetricsWriter:
    """Appends {step, wall_time, metrics...} lines to <log_dir>/<filename>."""

    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
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
