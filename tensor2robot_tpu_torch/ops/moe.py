"""Mixture-of-experts feed-forward: top-k routing and the expert MLP.

Port of tensor2robot_tpu/ops/moe.py (GShard-style dense dispatch): a
top-k routed expert MLP whose dispatch and combine are dense einsums over
a [tokens, experts, capacity] one-hot tensor, with static shapes and no
gather or scatter. Tokens past an expert's capacity are dropped (they
contribute zero). The JAX package computes all of this outside any Pallas
kernel, so here it stays torch ops.

Routing runs over any leading group dims: `router_logits` is [..., T, E]
and every result keeps those dims, so `moe_mlp` routes its [G, g, E]
groups in one call where the JAX package vmaps over them.

Ties among router probabilities go to the lower expert index, as
`jax.lax.top_k` breaks them (`torch.topk` does not): the top k come from a
stable descending sort.

Pure functions; `layers.moe.MoEBlock` is the module around them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class Routing(NamedTuple):
    """Dense dispatch/combine for [T] tokens, [E] experts, [C] capacity
    (each with the logits' leading dims in front)."""

    dispatch: torch.Tensor  # [..., T, E, C] 0/1: token t holds slot c of expert e
    combine: torch.Tensor  # [..., T, E, C] gate-weighted dispatch
    aux_loss: torch.Tensor  # [...] load-balance loss (Switch eq. 4 style)


def _one_hot(index: torch.Tensor, size: int, dtype: torch.dtype) -> torch.Tensor:
    """jax.nn.one_hot: an index outside [0, size) gives a row of zeros.
    (F.one_hot raises for one and would check its range on the host.)"""
    return (index[..., None] == torch.arange(size, device=index.device)).to(dtype)


def top_k_routing(
    router_logits: torch.Tensor,
    num_selected: int,
    capacity: int,
) -> Routing:
    """Builds dispatch/combine tensors from router logits [..., T, E].

    Top-k gating over the softmax, the selected gates renormalized to sum
    to 1 for k > 1 (top-1 keeps the raw probability, so the router stays in
    the task loss's gradient). Per-expert slots are assigned in token order
    (cumsum ranking), selection-major: all k = 0 picks rank before any
    k = 1 pick, so a token's primary expert wins capacity over another's
    secondary. Picks ranked past `capacity` are dropped. The aux loss is
    E * sum_e(load_e * importance_e), load the fraction of top-1 picks and
    importance the mean router probability: 1.0 at uniform routing.
    """
    return route_probabilities(
        torch.softmax(router_logits, dim=-1), num_selected, capacity
    )


def route_probabilities(
    probs: torch.Tensor,
    num_selected: int,
    capacity: int,
) -> Routing:
    """top_k_routing from the router's probabilities [..., T, E] (the
    softmax of its logits)."""
    num_experts = probs.shape[-1]
    sorted_probs, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_values = sorted_probs[..., :num_selected]
    expert_ids = order[..., :num_selected]
    if num_selected > 1:
        gate_values = gate_values / torch.clamp_min(
            gate_values.sum(dim=-1, keepdim=True), 1e-9
        )

    shape = probs.shape + (capacity,)
    dispatch = torch.zeros(shape, dtype=probs.dtype, device=probs.device)
    combine = torch.zeros(shape, dtype=probs.dtype, device=probs.device)
    slots_used = torch.zeros(
        probs.shape[:-2] + (num_experts,), dtype=torch.int64, device=probs.device
    )
    for k in range(num_selected):
        onehot = _one_hot(expert_ids[..., k], num_experts, torch.int64)  # [..., T, E]
        rank = torch.cumsum(onehot, dim=-2) - 1 + slots_used[..., None, :]
        position = (rank * onehot).sum(dim=-1)  # [..., T] slot within its expert
        kept = position < capacity
        # Counts KEPT assignments only: a true slots-filled count.
        slots_used = slots_used + (onehot * kept[..., None]).sum(dim=-2)
        contribution = (
            onehot.to(probs.dtype)[..., :, None]
            * _one_hot(position, capacity, probs.dtype)[..., None, :]
        ) * kept.to(probs.dtype)[..., None, None]
        dispatch = dispatch + contribution
        combine = combine + contribution * gate_values[..., k, None, None]

    top1 = _one_hot(expert_ids[..., 0], num_experts, probs.dtype)
    load = top1.mean(dim=-2)
    importance = probs.mean(dim=-2)
    aux_loss = num_experts * (load * importance).sum(dim=-1)
    return Routing(dispatch=dispatch, combine=combine, aux_loss=aux_loss)


def expert_capacity(
    tokens: int,
    num_experts: int,
    num_selected: int,
    capacity_factor: float,
) -> int:
    """Slots per expert: ceil(k*T/E * factor), floored at num_selected so
    toy shapes keep at least one slot per selection."""
    raw = num_selected * tokens * capacity_factor / num_experts
    return max(int(-(-raw // 1)), num_selected)


def moe_mlp(
    x: torch.Tensor,
    router_kernel: torch.Tensor,
    w_in: torch.Tensor,
    w_out: torch.Tensor,
    *,
    num_selected: int = 2,
    capacity_factor: float = 2.0,
    group_size: Optional[int] = None,
    mesh: Optional[object] = None,
):
    """Expert-routed MLP over [T, F] tokens.

    Args:
      x: [T, F] tokens (batch and sequence flattened upstream).
      router_kernel: [F, E].
      w_in: [E, F, H] per-expert up-projection; w_out: [E, H, F].
      group_size: tokens are routed in independent groups of this size
        (it must divide T), with capacity computed PER GROUP, so the dense
        dispatch tensors ([G, g, E, C_g], C_g ~ g/E) grow linearly in T.
        None = one group of all tokens.
      mesh: expert parallelism over a mesh is not ported (ROADMAP.md A9).

    Returns (y [T, F], aux_loss: the mean over groups).
    """
    if mesh is not None:
        raise NotImplementedError(
            "expert-parallel MoE over a mesh is not ported yet (ROADMAP.md A9)"
        )
    tokens, features = x.shape
    num_experts = w_in.shape[0]
    if group_size is None:
        group_size = tokens
    if tokens % group_size != 0:
        raise ValueError(
            f"group_size {group_size} does not divide token count {tokens}"
        )
    groups = tokens // group_size
    capacity = expert_capacity(
        group_size, num_experts, num_selected, capacity_factor
    )

    xg = x.reshape(groups, group_size, features)
    logits = torch.einsum("gtf,fe->gte", xg, router_kernel)
    routing = top_k_routing(logits, num_selected, capacity)
    expert_inputs = torch.einsum("gtec,gtf->gecf", routing.dispatch, xg)
    hidden = F.gelu(
        torch.einsum("gecf,efh->gech", expert_inputs, w_in), approximate="tanh"
    )
    expert_outputs = torch.einsum("gech,ehf->gecf", hidden, w_out)
    y = torch.einsum("gtec,gecf->gtf", routing.combine, expert_outputs)
    return y.reshape(tokens, features), routing.aux_loss.mean()
