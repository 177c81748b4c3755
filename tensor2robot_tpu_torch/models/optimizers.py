"""Optimizer and learning-rate factories.

Port of tensor2robot_tpu/models/optimizers.py, whose factories return
optax transformations. Here a factory returns an `OptimizerFactory`: a
callable that binds a torch optimizer to a network's parameters. The
updates are optax's:

  * learning rates are schedules of the update count, counted from 0 as
    optax counts (constant, exponential decay with `staircase`); the
    count lives in each param group, so it is saved with the optimizer;
  * Adam, SGD, momentum and Nesterov are torch.optim's, whose updates are
    optax's;
  * RMSProp is written out, because optax's differs from torch's: eps
    inside the square root and the second moment starting at 0;
  * clipping is written out as optax's `clip` then `clip_by_global_norm`
    (g * max / ||g|| when ||g|| >= max; torch's clip_grad_norm_ adds 1e-6
    to the norm).

Moving-average ("swapping saver") parameters are the trainer's EMA
(train/state.py).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Tuple, Union

import torch

Schedule = Callable[[int], float]
ScalarOrSchedule = Union[float, Schedule]
OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]


def _as_schedule(learning_rate: ScalarOrSchedule) -> Schedule:
    if callable(learning_rate):
        return learning_rate
    return lambda count: learning_rate


def create_constant_learning_rate(learning_rate: float = 1e-3) -> Schedule:
    return lambda count: learning_rate


def create_exponential_decay_learning_rate(
    initial_learning_rate: float = 1e-3,
    decay_steps: int = 10000,
    decay_rate: float = 0.9,
    staircase: bool = True,
) -> Schedule:
    """optax.exponential_decay: init * rate ** (count / steps), the
    exponent floored when `staircase`; constant for a non-positive
    `decay_steps` or a zero `decay_rate`."""
    if decay_steps <= 0 or decay_rate == 0:
        return lambda count: initial_learning_rate

    def schedule(count: int) -> float:
        if count <= 0:
            return initial_learning_rate
        p = count / decay_steps
        if staircase:
            p = math.floor(p)
        return initial_learning_rate * decay_rate ** p

    return schedule


class _OptaxStep:
    """Mixin of the port's optimizers. Before each update it clips the
    gradients when `clipping` is set (with_gradient_clipping), and takes
    the learning rate from the schedule at the update count, which each
    param group keeps under 'count'."""

    _schedule: Schedule
    clipping: Optional[Tuple[Optional[float], Optional[float]]] = None

    def _start_schedule(self, learning_rate: ScalarOrSchedule) -> None:
        self._schedule = _as_schedule(learning_rate)
        for group in self.param_groups:
            group.setdefault("count", 0)

    def step(self, closure=None):
        if self.clipping is not None:
            clip_gradients_(self, *self.clipping)
        for group in self.param_groups:
            group["lr"] = float(self._schedule(group["count"]))
        loss = super().step(closure)
        for group in self.param_groups:
            group["count"] += 1
        return loss


class Adam(_OptaxStep, torch.optim.Adam):
    def __init__(self, params, learning_rate: ScalarOrSchedule = 1e-3,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8):
        super().__init__(params, lr=_as_schedule(learning_rate)(0),
                         betas=(beta1, beta2), eps=epsilon)
        self._start_schedule(learning_rate)


class SGD(_OptaxStep, torch.optim.SGD):
    """Plain, momentum or Nesterov SGD; torch's momentum buffer is optax's
    trace (g + momentum * trace, first value g)."""

    def __init__(self, params, learning_rate: ScalarOrSchedule = 1e-2,
                 momentum: float = 0.0, nesterov: bool = False):
        super().__init__(params, lr=_as_schedule(learning_rate)(0),
                         momentum=momentum, nesterov=nesterov)
        self._start_schedule(learning_rate)


class _RMSPropUpdate(torch.optim.Optimizer):
    """optax.rmsprop's update (uncentered): nu = decay * nu +
    (1 - decay) * g^2 from nu = 0, u = -lr * g / sqrt(nu + eps), then
    optax's trace of u with `momentum` (u + momentum * trace)."""

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            decay, momentum = group["decay"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    if momentum:
                        state["trace"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.copy_((1 - decay) * g * g + decay * nu)
                update = g * torch.rsqrt(nu + group["eps"]) * -group["lr"]
                if momentum:
                    trace = state["trace"]
                    trace.copy_(update + momentum * trace)
                    update = trace
                p.add_(update)
        return loss


class RMSProp(_OptaxStep, _RMSPropUpdate):
    def __init__(self, params, learning_rate: ScalarOrSchedule = 1e-3,
                 decay: float = 0.9, momentum: float = 0.0,
                 epsilon: float = 1e-10):
        defaults = dict(lr=_as_schedule(learning_rate)(0), decay=decay,
                        momentum=momentum, eps=epsilon)
        super().__init__(params, defaults)
        self._start_schedule(learning_rate)


def create_adam_optimizer(
    learning_rate: ScalarOrSchedule = 1e-3,
    beta1: float = 0.9,
    beta2: float = 0.999,
    epsilon: float = 1e-8,
) -> OptimizerFactory:
    return lambda params: Adam(params, learning_rate, beta1, beta2, epsilon)


def create_sgd_optimizer(
    learning_rate: ScalarOrSchedule = 1e-2,
) -> OptimizerFactory:
    return lambda params: SGD(params, learning_rate)


def create_momentum_optimizer(
    learning_rate: ScalarOrSchedule = 1e-2,
    momentum: float = 0.9,
    nesterov: bool = False,
) -> OptimizerFactory:
    return lambda params: SGD(params, learning_rate, momentum, nesterov)


def create_rms_prop_optimizer(
    learning_rate: ScalarOrSchedule = 1e-3,
    decay: float = 0.9,
    momentum: float = 0.0,
    epsilon: float = 1e-10,
) -> OptimizerFactory:
    return lambda params: RMSProp(params, learning_rate, decay, momentum, epsilon)


def clip_gradients_(
    optimizer: torch.optim.Optimizer,
    max_global_norm: Optional[float] = None,
    max_abs_value: Optional[float] = None,
) -> None:
    """Clips the gradients of an optimizer's parameters in place: first
    each element to [-max_abs_value, max_abs_value] (optax.clip), then the
    whole set to global norm max_global_norm (optax.clip_by_global_norm).
    Stays on the device: no host sync."""
    grads = [
        p.grad for group in optimizer.param_groups for p in group["params"]
        if p.grad is not None
    ]
    if not grads:
        return
    if max_abs_value is not None:
        for g in grads:
            g.clamp_(-max_abs_value, max_abs_value)
    if max_global_norm is not None:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < max_global_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * max_global_norm))


def with_gradient_clipping(
    optimizer: OptimizerFactory,
    max_global_norm: Optional[float] = None,
    max_abs_value: Optional[float] = None,
) -> OptimizerFactory:
    """Clips gradients before every update of the optimizer the factory
    builds (clip_gradients_; optax.chain(clip, clip_by_global_norm, opt))."""

    def factory(params):
        bound = optimizer(params)
        if not isinstance(bound, _OptaxStep):
            raise TypeError(
                f"{type(bound).__name__} is not an optimizer of this module"
            )
        bound.clipping = (max_global_norm, max_abs_value)
        return bound

    return factory
