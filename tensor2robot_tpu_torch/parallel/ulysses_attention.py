"""Ulysses all-to-all sequence parallelism (DeepSpeed-Ulysses).

Port of tensor2robot_tpu/parallel/ulysses_attention.py. The second
strategy beside the ring: instead of rotating K/V, two tiled all_to_alls
re-shard the problem so each rank attends the FULL sequence for a group of
heads:

    [B, S/N, H, D]  --all_to_all-->  [B, S, H/N, D]
    local attention over the head group
    [B, S, H/N, D]  --all_to_all-->  [B, S/N, H, D]

Local attention is the port's `flash_attention` (B1 forward and B3 + B4
backward under autograd, B2 without) or `reference_attention` (the
einsum path). Gradients flow through the all_to_alls (each one's rule is
the inverse all_to_all, parallel/collectives.py), so no custom backward is
needed. Needs heads % N == 0.

As for the ring, `ulysses_attention` and `ulysses_attention_manual` run the
same per-rank code on this rank's local shards; the manual entry always
takes the einsum path.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from tensor2robot_tpu_torch.ops import flash_attention as flash_lib
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel.mesh import SEQUENCE_AXIS, axis_size


def _ulysses_local(q, k, v, *, mesh, axis_name, causal, scale, use_flash,
                   window=None):
    """Per-rank body: sequence-sharded in, sequence-sharded out."""
    def scatter_heads(x):  # [B, S/N, H, D] -> [B, S, H/N, D]
        return collectives.all_to_all(x, mesh, axis_name, 2, 1)

    def gather_heads(x):  # [B, S, H/N, D] -> [B, S/N, H, D]
        return collectives.all_to_all(x, mesh, axis_name, 1, 2)

    q_local, k_local, v_local = scatter_heads(q), scatter_heads(k), scatter_heads(v)
    attend = flash_lib.flash_attention if use_flash else flash_lib.reference_attention
    # The einsum tiles never take the serving contraction override
    # (export/serve_quant.py): only a single-device head lowers.
    with flash_lib.attention_contraction_override(None):
        out = attend(q_local, k_local, v_local, causal=causal, scale=scale,
                     window=window)
    return gather_heads(out)


def _check(q, mesh, axis_name) -> int:
    if q.ndim != 4:
        raise ValueError(f"Expected [B, S_local, H, D], got {tuple(q.shape)}")
    if mesh is None:
        raise ValueError("Ulysses attention needs the mesh")
    n = axis_size(mesh, axis_name)
    heads = q.shape[2]
    if heads % n != 0:
        raise ValueError(
            f"Ulysses all-to-all needs heads ({heads}) divisible by the "
            f"{axis_name!r} axis size ({n}); use ring_attention for head counts "
            "that do not split."
        )
    return n


def ulysses_attention_manual(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: DeviceMesh,
    axis_name: str = SEQUENCE_AXIS,
    causal: bool = False,
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """JAX's manual entry point: here the same per-rank code,
    `ulysses_attention` with the einsum (reference) attention."""
    return ulysses_attention(q, k, v, mesh, axis_name, causal, scale,
                             use_flash=False, window=window)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: DeviceMesh,
    axis_name: str = SEQUENCE_AXIS,
    causal: bool = False,
    scale: Optional[float] = None,
    use_flash: Optional[bool] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Sequence-parallel attention via head-scatter all_to_all on this
    rank's shards [B, S/N, H, D]; returns this rank's output shard.

    use_flash: None = JAX's policy on the FULL length S (the local
    attention runs over the whole gathered sequence): flash at S >=
    FLASH_AUTO_SEQ. True/False force either path.
    """
    n = _check(q, mesh, axis_name)
    flash_lib._check_window(window, causal)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if use_flash is None:
        use_flash = q.shape[1] * n >= flash_lib.FLASH_AUTO_SEQ
    return _ulysses_local(q, k, v, mesh=mesh, axis_name=axis_name,
                          causal=causal, scale=scale, use_flash=use_flash,
                          window=window)
