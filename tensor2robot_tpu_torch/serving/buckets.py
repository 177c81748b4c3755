"""Batch-size bucket discipline for the policy server.

The server only ever hands the predictor batches at the sizes of a small
ladder, padding every dispatch up to the smallest fitting bucket, so the
set of served shapes is closed over what the server prewarmed at start
(cuDNN algorithm choice, allocator pools, kernel builds all happen before
traffic).

Resolution order for the ladder: explicit constructor argument >
`T2R_SERVE_BUCKETS` > the loaded export's `warmup_batch_sizes`
(t2r_metadata.json) > `(1,)`. Port of tensor2robot_tpu/serving/buckets.py.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from tensor2robot_tpu_torch import flags as t2r_flags

__all__ = [
    "buckets_from_metadata",
    "resolve_buckets",
    "pick_bucket",
    "pad_feature_batch",
    "load_warmup_batches",
]


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


def buckets_from_metadata(metadata: Optional[Mapping]) -> Optional[Tuple[int, ...]]:
    """The exporter-published ladder (t2r_metadata.json
    `warmup_batch_sizes`, else the batches of a static program set), or
    None when the export has neither."""
    sizes = metadata.get("warmup_batch_sizes") if metadata else None
    if not sizes and metadata:
        sizes = metadata.get("program_batches")
    if not sizes:
        return None
    return _normalize(sizes, "t2r_metadata.json warmup_batch_sizes")


def resolve_buckets(
    explicit: Optional[Sequence[int]],
    metadata: Optional[Mapping] = None,
) -> Tuple[int, ...]:
    if explicit is not None:
        return _normalize(explicit, "batch_buckets argument")
    from_flag = _flag_buckets()
    if from_flag is not None:
        return from_flag
    from_meta = buckets_from_metadata(metadata)
    if from_meta is not None:
        return from_meta
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


def load_warmup_batches(
    export_dir: str, feature_spec, metadata: Optional[Mapping]
) -> Dict[int, Dict[str, np.ndarray]]:
    """Parses `warmup/warmup_requests.tfrecord` back into per-bucket
    batches, re-chunked by the published `warmup_batch_sizes` (rows are
    written in ladder order). A missing or foreign warmup file gives {}
    and the caller synthesizes random batches."""
    import os

    from tensor2robot_tpu_torch.data.parser import SpecParser
    from tensor2robot_tpu_torch.data.tfrecord import read_tfrecords
    from tensor2robot_tpu_torch.export.export_generators import (
        WARMUP_DIR,
        WARMUP_FILENAME,
    )
    from tensor2robot_tpu_torch.specs import flatten_spec_structure

    path = os.path.join(export_dir, WARMUP_DIR, WARMUP_FILENAME)
    sizes = metadata.get("warmup_batch_sizes") if metadata else None
    if not sizes or not os.path.exists(path):
        return {}
    records = list(read_tfrecords(path))
    if len(records) != sum(sizes):
        return {}  # foreign layout; let the caller synthesize
    parser = SpecParser(feature_spec)
    batches: Dict[int, Dict[str, np.ndarray]] = {}
    offset = 0
    for size in sizes:
        batch = parser.parse_batch(records[offset:offset + size])
        batches[int(size)] = dict(flatten_spec_structure(batch).items())
        offset += size
    return batches
