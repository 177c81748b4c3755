"""Activation checkpointing by segment: the trainer's remat regime.

A network marks its segments: a conv stage, a transformer block, a slice
of frames through a per-frame embed. While `segments()` is on (the
trainer's remat=True) and autograd records, each marked segment runs
under torch.utils.checkpoint (non-reentrant): the forward keeps only the
segment's inputs, and the backward recomputes one segment's activations
at a time. The peak then holds one segment's activations, not the
network's. Otherwise a segment is a plain call.

The recompute runs the segment's forward again, so a batch norm inside it
updates its running statistics a second time; the trainer restores them
after the backward. Segments draw no random numbers.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator

import torch
from torch.utils.checkpoint import checkpoint

_STATE = threading.local()


@contextlib.contextmanager
def segments(enabled: bool = True) -> Iterator[None]:
    """Marked segments are checkpointed in this thread while enabled."""
    previous = getattr(_STATE, "enabled", False)
    _STATE.enabled = enabled
    try:
        yield
    finally:
        _STATE.enabled = previous


def _active() -> bool:
    return getattr(_STATE, "enabled", False) and torch.is_grad_enabled()


def segment(fn: Callable, *args):
    """fn(*args), as one checkpointed segment under `segments()`."""
    if _active():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def segments_over_batch(fn: Callable, x: torch.Tensor, rows: int, *args) -> torch.Tensor:
    """fn(x, *args) for an fn that treats the rows of x independently:
    one call, or under `segments()` one checkpointed segment per `rows`
    rows, concatenated."""
    if not _active() or x.shape[0] <= rows:
        return segment(fn, x, *args)
    return torch.cat([checkpoint(fn, piece, *args, use_reentrant=False)
                      for piece in x.split(rows)])
