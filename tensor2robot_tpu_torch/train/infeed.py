"""Device infeed: host numpy batches onto the card, `depth` batches ahead.

Port of tensor2robot_tpu/train/infeed.py's `resolve_depth` and
`device_prefetch`. On the card each batch is copied into pinned host
memory and from there to the device with non_blocking copies on a side
stream, so the transfer of batch N+1 runs while step N computes; the
consumer's stream waits on the copy's event before it reads the batch.
Multi-step batch stacking (iterations_per_loop) is not ported
(ROADMAP.md A9).
"""

from __future__ import annotations

import collections
from typing import Iterator, Optional, Union

import numpy as np
import torch

from tensor2robot_tpu_torch import flags
from tensor2robot_tpu_torch.specs import TensorSpecStruct


def resolve_depth(depth: Optional[int] = None) -> int:
    """Prefetch depth: an explicit argument wins; None reads the
    T2R_INFEED_DEPTH gate (default 2 = double buffering)."""
    if depth is not None:
        return depth
    return flags.get_int("T2R_INFEED_DEPTH")


def to_device(batch, device: Union[str, torch.device]) -> TensorSpecStruct:
    """A batch of numpy arrays (or tensors) as tensors on `device`,
    copied synchronously."""
    out = TensorSpecStruct()
    for key, value in batch.items():
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.asarray(value))
        out[key] = value.to(device)
    return out


def device_prefetch(
    batches: Iterator,
    device: Union[str, torch.device],
    depth: int = 2,
) -> Iterator[TensorSpecStruct]:
    """Yields the batches as device tensors, keeping `depth` transfers in
    flight ahead of the consumer. Off the card the copies are synchronous."""
    device = torch.device(device)
    it = iter(batches)
    if device.type != "cuda":
        for batch in it:
            yield to_device(batch, device)
        return
    copy_stream = torch.cuda.Stream(device)

    def start(batch):
        pinned = {
            key: torch.from_numpy(np.asarray(value)).pin_memory()
            for key, value in batch.items()
        }
        out = TensorSpecStruct()
        with torch.cuda.stream(copy_stream):
            for key, value in pinned.items():
                out[key] = value.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy_stream)
        # The pinned buffers must outlive their copies: kept until the
        # consumer has waited on `done`.
        return out, done, pinned

    pending: collections.deque = collections.deque()
    for batch in it:
        pending.append(start(batch))
        if len(pending) >= depth:
            break
    while pending:
        out, done, _ = pending.popleft()
        for batch in it:
            pending.append(start(batch))
            break
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for value in out.values():
            # Allocated on the copy stream, read on the consumer's.
            value.record_stream(consumer)
        yield out
