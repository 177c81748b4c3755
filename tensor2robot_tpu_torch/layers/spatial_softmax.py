"""Spatial softmax: expected (x, y) image coordinates per feature map.

Port of tensor2robot_tpu/layers/spatial_softmax.py. Input is NHWC, as in
the JAX package; output ordering is [x1..xN, y1..yN] with coordinates
normalized to [-1, 1]. With a `generator`, locations are sampled: Gumbel
noise drawn from it is added to logits / temperature (the JAX version's
gumbel_rng mode).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _coordinate_grids(
    num_rows: int, num_cols: int, dtype: torch.dtype, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattened x/y position grids in [-1, 1], row-major. A singleton
    dim sits at the center (0)."""
    cols = torch.arange(num_cols, dtype=dtype, device=device)
    rows = torch.arange(num_rows, dtype=dtype, device=device)
    x = 2.0 * cols / (num_cols - 1.0) - 1.0 if num_cols > 1 else cols * 0
    y = 2.0 * rows / (num_rows - 1.0) - 1.0 if num_rows > 1 else rows * 0
    x_pos = x[None, :].expand(num_rows, num_cols).reshape(-1)
    y_pos = y[:, None].expand(num_rows, num_cols).reshape(-1)
    return x_pos, y_pos


def draw_gumbel(generator: torch.Generator, shape, dtype: torch.dtype,
                device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform on [tiny, 1)."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(dtype).tiny)))


def spatial_softmax(
    features: torch.Tensor,
    temperature: float = 1.0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expected feature-point coordinates via a spatial softmax.

    Args:
      features: [batch, num_rows, num_cols, num_features] activations.
      temperature: Softmax temperature (logits are divided by it).
      generator: If given, sample locations stochastically: Gumbel noise
        of the logits' [batch * num_features, num_rows * num_cols] layout
        (draw_gumbel) is added to logits / temperature.

    Returns:
      (expected_feature_points [batch, 2*num_features] ordered
       [x1..xN, y1..yN], softmax [batch, num_rows, num_cols, num_features]).
    """
    if features.ndim != 4:
        raise ValueError(f"Expected rank-4 features, got {tuple(features.shape)}")
    batch, num_rows, num_cols, num_features = features.shape
    x_pos, y_pos = _coordinate_grids(
        num_rows, num_cols, features.dtype, features.device
    )
    # [B, H, W, C] -> [B*C, H*W]: one batched softmax over positions.
    logits = features.permute(0, 3, 1, 2).reshape(
        batch * num_features, num_rows * num_cols
    )
    logits = logits / temperature
    if generator is not None:
        logits = logits + draw_gumbel(generator, logits.shape, logits.dtype,
                                      logits.device)
    softmax = torch.softmax(logits, dim=-1)
    x_out = (softmax * x_pos).sum(dim=1).reshape(batch, num_features)
    y_out = (softmax * y_pos).sum(dim=1).reshape(batch, num_features)
    points = torch.cat([x_out, y_out], dim=1)
    maps = softmax.reshape(batch, num_features, num_rows, num_cols).permute(
        0, 2, 3, 1
    )
    return points, maps
