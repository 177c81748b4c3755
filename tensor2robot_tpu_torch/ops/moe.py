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

Expert parallelism (a mesh whose `expert` dim X is above 1; JAX's
sharding constraint on the expert inputs, under which GSPMD "computes
only its resident experts' FFNs"): expert rank j holds experts
[j E/X, (j+1) E/X) and computes only their FFN, from its slice of the
dispatch and of w_in/w_out; a tiled all_gather over the expert dim puts
the E experts' outputs together for the combine. Expert ranks share their
batch, as sequence ranks do (JAX splits the batch over data x fsdp only),
so every expert rank routes the same tokens the same way, and no token
all_to_all is needed. Parameters stay replicated: the checkpoint has the
single-device layout, as JAX's param_sharding leaves experts unsharded.

The gradient rule: every expert rank computes the same loss from the same
gathered outputs. The all_gather's backward is psum_scatter, so rank j's
resident outputs receive the sum of the X equal cotangents: X times the
single-device cotangent. Rank j's gradient is then X times the
single-device gradient for its resident experts' w_in/w_out and zero for
the other experts'; for any other parameter it is A + X B_j, where A is
the part that passes through no expert's FFN (the router's through the
combine weights, the residual stream), the same on every expert rank, and
B_j the part through rank j's resident experts. The trainer's one flat
pmean over the ranks averages the X expert ranks: (X g + 0 (X - 1)) / X
= g for an expert's weights and A + sum_j B_j for the others, the
single-device gradient in both cases; the pmean over data x fsdp then
averages the data shards' means into the global batch mean.

Pure functions; `layers.moe.MoEBlock` is the module around them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib


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


def resident_experts(num_experts: int, mesh: Optional[object]) -> range:
    """The experts this rank computes: all of them without an expert dim,
    else expert rank j's block of E / X. E % X != 0 raises ValueError."""
    experts = mesh_lib.axis_size(mesh, mesh_lib.EXPERT_AXIS)
    if num_experts % experts:
        raise ValueError(
            f"{num_experts} experts do not split over an expert dim of {experts}"
        )
    per_rank = num_experts // experts
    start = collectives.axis_index(mesh, mesh_lib.EXPERT_AXIS) * per_rank if experts > 1 else 0
    return range(start, start + per_rank)


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
      mesh: with an `expert` dim above 1, this rank computes only its
        resident experts' FFN (module docstring); x is the same on every
        expert rank.

    Returns (y [T, F], aux_loss: the mean over groups).
    """
    tokens, features = x.shape
    num_experts = w_in.shape[0]
    resident = resident_experts(num_experts, mesh)
    sharded = len(resident) < num_experts
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
    dispatch = routing.dispatch
    if sharded:
        mine = slice(resident.start, resident.stop)
        dispatch, w_in, w_out = dispatch[:, :, mine], w_in[mine], w_out[mine]
    expert_inputs = torch.einsum("gtec,gtf->gecf", dispatch, xg)
    hidden = F.gelu(
        torch.einsum("gecf,efh->gech", expert_inputs, w_in), approximate="tanh"
    )
    expert_outputs = torch.einsum("gech,ehf->gecf", hidden, w_out)
    if sharded:
        expert_outputs = collectives.all_gather(
            expert_outputs, mesh, mesh_lib.EXPERT_AXIS, axis=1)
    y = torch.einsum("gtec,gecf->gtf", routing.combine, expert_outputs)
    return y.reshape(tokens, features), routing.aux_loss.mean()
