"""Device resolution for the port's entry points.

Entry points take an explicit `device` and default to the card. A request
for CUDA on a host without one raises: the port never carries on silently
on the CPU, because every number it reports is meant to be a device number.
"""

from __future__ import annotations

import os
from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device] = DEFAULT_DEVICE) -> torch.device:
    """Returns `device` as a torch.device; raises RuntimeError when it names
    CUDA and no card is visible."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the host"
        )
    return device


def rank_device(device: Union[str, torch.device] = DEFAULT_DEVICE) -> torch.device:
    """This rank's device, explicit. "cuda" without an index is
    cuda:LOCAL_RANK (the environment variable a launcher sets, else 0):
    each rank owns a card. A device with an index is kept as it is, so
    ranks asked to share one card pass "cuda:0"; "cpu" only when asked.
    Raises as resolve_device does."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return resolve_device(device)
