"""Device infeed: host numpy batches onto the card, `depth` batches ahead.

Port of tensor2robot_tpu/train/infeed.py's `resolve_depth` and
`device_prefetch`. On the card each batch goes to the device from pinned
host memory with non_blocking copies on a side stream, so the transfer
of batch N+1 runs while step N computes; the consumer's stream waits on
the copy's event before it reads the batch. A tensor that is already
pinned (a record dataset parses uint8 images into a `PinnedRing`) is
copied as it is; anything else is first copied into fresh pinned memory.
dtypes are kept: uint8 images stay uint8 until the card. The trainer's
iterations_per_loop regime reads these batches one by one: eager steps
gain nothing from a stacked [K, B, ...] copy.
"""

from __future__ import annotations

import collections
import math
import threading
import weakref
from typing import Iterator, List, Optional, Tuple, Union

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


class _Slot:
    """One pinned buffer of a PinnedRing: free once the tensor handed out
    over it is gone and the last copy out of it has completed."""

    __slots__ = ("buffer", "user", "copied")

    def __init__(self, nbytes: int):
        self.buffer = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        self.user: Optional[weakref.ref] = None
        self.copied: Optional[torch.cuda.Event] = None

    def free(self) -> bool:
        if self.user is not None and self.user() is not None:
            return False
        return self.copied is None or self.copied.query()


class PinnedRing:
    """Pinned host buffers for batch arrays, reused once free.

    `alloc(shape)` hands out a uint8 tensor over a free buffer of at least
    that size (growing the ring when none is free, so a consumer that
    keeps batches never blocks the parser). `device_prefetch` records the
    event of each copy out of such a tensor; a buffer is reused only after
    that event has completed and the tensor handed out over it (and every
    numpy view of it) is gone.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._slots: List[_Slot] = []

    def __len__(self) -> int:
        return len(self._slots)

    def alloc(self, shape: Tuple[int, ...]) -> torch.Tensor:
        nbytes = math.prod(shape)
        with self._lock:
            slot = next((s for s in self._slots
                         if s.buffer.numel() >= nbytes and s.free()), None)
            if slot is None:
                slot = _Slot(nbytes)
                self._slots.append(slot)
            tensor = slot.buffer[:nbytes].view(shape)
            slot.user = weakref.ref(tensor)
            slot.copied = None
        tensor._t2r_slot = slot
        return tensor


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

    def pinned(value) -> torch.Tensor:
        if isinstance(value, torch.Tensor) and value.is_pinned():
            return value
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.asarray(value))
        return value.pin_memory()

    def start(batch):
        sources = {key: pinned(value) for key, value in batch.items()}
        out = TensorSpecStruct()
        with torch.cuda.stream(copy_stream):
            for key, value in sources.items():
                out[key] = value.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy_stream)
        for value in sources.values():
            slot = getattr(value, "_t2r_slot", None)
            if slot is not None:
                slot.copied = done
        # The host buffers must outlive their copies: kept until the
        # consumer has waited on `done`.
        return out, done, sources

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
