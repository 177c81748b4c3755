"""Schedules of the global step usable as any scalar hyperparameter.

Port of tensor2robot_tpu/utils/global_step_functions.py: each factory
returns a pure function step -> float32 tensor, registered under the JAX
package's names for gin configs.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from tensor2robot_tpu_torch.config import configurable


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """jnp.interp's formula: fp[i-1] + (x - xp[i-1]) / dx * df, clamped to
    fp[0] and fp[-1] outside [xp[0], xp[-1]]."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    epsilon = np.spacing(np.finfo(np.float32).eps)
    dx0 = torch.abs(dx) <= epsilon
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


@configurable("piecewise_linear")
def piecewise_linear(boundaries: Sequence[float], values: Sequence[float]) -> Callable:
    """Linear interpolation through the (boundaries, values) knots, held at
    values[0] before the first boundary and values[-1] after the last."""
    boundaries = np.asarray(boundaries, np.float32)
    values = np.asarray(values, np.float32)
    if boundaries.size == 0 or values.size == 0:
        raise ValueError("Need more than 0 boundaries/values.")
    if boundaries.size != values.size:
        raise ValueError("boundaries and values must be of same size.")
    if np.any(np.diff(boundaries) <= 0):
        raise ValueError("boundaries must be strictly increasing.")
    xp, fp = torch.from_numpy(boundaries), torch.from_numpy(values)

    def schedule(step) -> torch.Tensor:
        x = torch.as_tensor(step, dtype=torch.float32)
        return _interp(x.reshape(-1), xp.to(x.device), fp.to(x.device)).reshape(x.shape)

    return schedule


@configurable("exponential_decay_value")
def exponential_decay(
    initial_value: float = 0.0001,
    decay_steps: int = 10000,
    decay_rate: float = 0.9,
    staircase: bool = True,
) -> Callable:
    """initial_value * decay_rate ** (step / decay_steps), the exponent
    floored with staircase."""

    def schedule(step) -> torch.Tensor:
        exponent = torch.as_tensor(step, dtype=torch.float32) / decay_steps
        if staircase:
            exponent = torch.floor(exponent)
        rate = torch.tensor(decay_rate, dtype=torch.float32, device=exponent.device)
        return initial_value * torch.pow(rate, exponent)

    return schedule
