"""The cross-entropy method as torch ops that a CUDA graph can capture.

Port of tensor2robot_tpu/ops/cem.py (`cross_entropy_maximize`, a
`lax.fori_loop` in plain JAX, no Pallas). The JAX package jits the whole
loop around the exported critic into one program; the port records it
as one CUDA graph (policies.JitCEMPolicy), which replays as one launch
per action selection. The loop is split in two so the graph holds no
random draw:

  * `draw_noise` fills ONE [num_iterations, num_samples, *action]
    standard-normal buffer from an explicit torch.Generator, before a
    replay;
  * `cem_iterations` is the pure loop over that buffer: sample -> clip ->
    score -> top-k -> smoothed refit -> best tracking, with no host sync
    (no `.item()`, no branch on a device value), so it can be captured;
    a test feeds it the JAX package's own noise.

Same proposal family and refit as the numpy engine
(utils/cross_entropy.py), in the dtype of `mean` (float32 on the card).
As in the JAX package there is no early termination: the iteration count
is fixed, so the graph is static.

`torch.topk` orders ties unspecified on CUDA where `lax.top_k` puts lower
indices first; only a tie at the elite boundary can make the two differ.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def draw_noise(
    generator: torch.Generator,
    num_iterations: int,
    num_samples: int,
    action_shape: Sequence[int],
    dtype: torch.dtype = torch.float32,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """All iterations' standard-normal draws in one call, into `out` when
    given (a graph's static buffer), on the generator's device."""
    shape = (num_iterations, num_samples) + tuple(action_shape)
    if out is not None:
        return torch.randn(shape, generator=generator, out=out)
    return torch.randn(
        shape, generator=generator, dtype=dtype, device=generator.device
    )


def cem_iterations(
    objective_fn: Callable[[torch.Tensor], torch.Tensor],
    mean: torch.Tensor,
    stddev: torch.Tensor,
    noise: torch.Tensor,
    *,
    elite_fraction: float = 0.1,
    low: Optional[float] = None,
    high: Optional[float] = None,
    min_stddev: float = 1e-6,
    smoothing: float = 0.3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Maximizes objective_fn over a diagonal-Gaussian proposal.

    Args:
      objective_fn: [num_samples, *action] -> [num_samples] scores.
      mean/stddev: initial proposal, shape [*action].
      noise: [num_iterations, num_samples, *action] standard normals;
        iteration i samples mean + stddev * noise[i].
      elite_fraction: top fraction refit each round (>= 1 elite).
      low/high: optional box bounds; samples are clipped BEFORE scoring
        so the elites refit on the actions actually scored.
      min_stddev: floor keeping later iterations samplable.
      smoothing: new = (1 - a) * elite statistic + a * old
        (JAX ops/cem.py and utils/cross_entropy.py say why).

    Returns (mean, stddev, best_action, best_score): the best over ALL
    iterations' populations. The best starts as `mean` with score -inf,
    and a NaN score never improves it (NaN > best is false).
    """
    num_iterations, num_samples = noise.shape[0], noise.shape[1]
    num_elites = max(1, int(num_samples * elite_fraction))
    best_action = mean
    best_score = torch.full((), float("-inf"), dtype=mean.dtype, device=mean.device)
    for index in range(num_iterations):
        samples = mean[None, ...] + stddev[None, ...] * noise[index]
        if low is not None or high is not None:
            samples = torch.clamp(samples, low, high)
        scores = objective_fn(samples)
        top_scores, top_idx = torch.topk(scores, num_elites)
        elites = samples[top_idx]
        new_mean = (1.0 - smoothing) * elites.mean(dim=0) + smoothing * mean
        new_stddev = torch.clamp_min(
            (1.0 - smoothing) * elites.std(dim=0, correction=0)
            + smoothing * stddev,
            min_stddev,
        )
        improved = top_scores[0] > best_score
        best_action = torch.where(improved, elites[0], best_action)
        best_score = torch.where(improved, top_scores[0], best_score)
        mean, stddev = new_mean, new_stddev
    return mean, stddev, best_action, best_score

