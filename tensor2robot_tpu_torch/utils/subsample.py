"""Fixed-length random subsampling of padded sequences.

Port of tensor2robot_tpu/utils/subsample.py. Sampling always keeps the
first and last valid frame; middle frames are drawn without replacement
when the sequence is long enough, with replacement otherwise;
`min_length == 1` picks one random frame.

As in the JAX package the draws are branchless and batched over the
sequences: both candidate sets are drawn for every sequence and a mask
picks one. Draws come from an explicit `torch.Generator`, so they are
reproducible but not jax.random's bits; the distribution is the same.
"""

from __future__ import annotations

from typing import Optional

import torch


def _as_lengths(sequence_lengths) -> torch.Tensor:
    return torch.as_tensor(sequence_lengths).to(torch.int64).reshape(-1)


def _uniform(shape, generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device)


def _indices(lengths: torch.Tensor, min_length: int, max_sequence_length: int,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """[B] lengths -> [B, min_length] indices into each sequence."""
    batch, device = lengths.shape[0], lengths.device
    if min_length == 1:
        u = _uniform((batch, 1), generator, device)
        return torch.floor(u * lengths[:, None]).to(torch.int64)
    num_middle = min_length - 2
    if num_middle > max_sequence_length:
        raise ValueError(f"min_length {min_length} exceeds max_sequence_length "
                         f"{max_sequence_length} + 2")

    # Without replacement: the num_middle smallest-keyed positions of
    # [1, length - 1), padding positions keyed +inf.
    positions = torch.arange(1, max_sequence_length + 1, device=device)
    valid = positions[None, :] < (lengths - 1)[:, None]
    keys = torch.where(valid, _uniform((batch, max_sequence_length), generator, device),
                       torch.tensor(float("inf"), device=device))
    order = torch.argsort(keys, dim=1)[:, :num_middle]
    middle_wo = torch.sort(positions[order], dim=1).values

    # With replacement: uniform draws over [0, length).
    u = _uniform((batch, num_middle), generator, device)
    middle_w = torch.sort(torch.floor(u * lengths[:, None]).to(torch.int64), dim=1).values

    middle = torch.where((lengths >= min_length)[:, None], middle_wo, middle_w)
    first = torch.zeros((batch, 1), dtype=torch.int64, device=device)
    last = torch.clamp(lengths - 1, min=0)[:, None]
    return torch.cat([first, middle, last], dim=1)


def get_subsample_indices(
    sequence_lengths,
    min_length: int,
    max_sequence_length: int = 512,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """[B] lengths -> [B, min_length] int64 subsample indices.

    Args:
      sequence_lengths: [B] valid lengths (tensors are padded beyond them).
      min_length: output frames per sequence; first/last always kept.
      max_sequence_length: bound on sequence length (the width of the
        candidate buffer).
      generator: the source of the draws (torch's default one when None).
    """
    return _indices(_as_lengths(sequence_lengths), min_length, max_sequence_length,
                    generator)


def get_subsample_indices_randomized_boundary(
    sequence_lengths,
    min_length: int,
    min_delta_t: int,
    max_delta_t: int,
    max_sequence_length: int = 512,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Like get_subsample_indices, over a random window [start, start + dt)
    of each sequence, dt uniform in [min_delta_t, max_delta_t] and cut to
    the sequence's length."""
    lengths = _as_lengths(sequence_lengths)
    batch, device = lengths.shape[0], lengths.device
    span = max_delta_t + 1 - min_delta_t
    delta_t = min_delta_t + torch.floor(
        _uniform((batch,), generator, device) * span).to(torch.int64)
    delta_t = torch.minimum(delta_t, lengths)
    starts = torch.clamp(lengths - delta_t + 1, min=1)
    start = torch.floor(_uniform((batch,), generator, device) * starts).to(torch.int64)
    window = _indices(delta_t, min_length, max_sequence_length, generator)
    return start[:, None] + window
