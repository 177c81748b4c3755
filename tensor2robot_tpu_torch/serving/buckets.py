"""Batch-size bucket discipline for the policy server.

The server only ever hands the predictor batches at the sizes of a small
ladder, padding every dispatch up to the smallest fitting bucket, so the
set of served shapes is closed over what the server prewarmed at start
(cuDNN algorithm choice, allocator pools, kernel builds all happen before
traffic).

Resolution order for the ladder: explicit constructor argument >
`T2R_SERVE_BUCKETS` > `(1,)`. Port of tensor2robot_tpu/serving/buckets.py;
the ladder and warmup batches an export publishes wait for the export
slice (ROADMAP.md A2).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from tensor2robot_tpu_torch import flags as t2r_flags

__all__ = ["resolve_buckets", "pick_bucket", "pad_feature_batch"]


def _normalize(sizes: Sequence[int], source: str) -> Tuple[int, ...]:
    out = sorted({int(s) for s in sizes})
    if not out or any(s < 1 for s in out):
        raise ValueError(
            f"bucket ladder from {source} must be positive ints, got {sizes!r}"
        )
    return tuple(out)


def _flag_buckets() -> Optional[Tuple[int, ...]]:
    raw = t2r_flags.get_str("T2R_SERVE_BUCKETS")
    if raw is None or not raw.strip():
        return None
    try:
        sizes = [int(part) for part in raw.split(",") if part.strip()]
    except ValueError as err:
        raise ValueError(
            f"T2R_SERVE_BUCKETS must be comma-separated ints, got {raw!r}"
        ) from err
    return _normalize(sizes, "T2R_SERVE_BUCKETS")


def resolve_buckets(explicit: Optional[Sequence[int]]) -> Tuple[int, ...]:
    if explicit is not None:
        return _normalize(explicit, "batch_buckets argument")
    from_flag = _flag_buckets()
    if from_flag is not None:
        return from_flag
    return (1,)


def pick_bucket(buckets: Tuple[int, ...], n: int) -> int:
    """Smallest bucket that fits n requests."""
    for bucket in buckets:
        if bucket >= n:
            return bucket
    raise ValueError(
        f"batch of {n} exceeds the max bucket {buckets[-1]}; dispatch at "
        "most max-bucket requests per batch"
    )


def pad_feature_batch(
    rows: List[Mapping[str, np.ndarray]], bucket: int
) -> Dict[str, np.ndarray]:
    """Stacks per-request flat feature rows into one batch padded to
    `bucket` by repeating the last real row. Padding rows are compute
    filler: the dispatcher never returns their outputs."""
    if not rows:
        raise ValueError("cannot pad an empty batch")
    if len(rows) > bucket:
        raise ValueError(f"{len(rows)} rows do not fit bucket {bucket}")
    pad = bucket - len(rows)
    out: Dict[str, np.ndarray] = {}
    for key in rows[0]:
        values = [np.asarray(row[key]) for row in rows]
        values.extend([values[-1]] * pad)
        out[key] = np.stack(values)
    return out
