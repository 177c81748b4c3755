"""PCGrad: gradient surgery for multi-task learning.

Port of tensor2robot_tpu/research/qtopt/pcgrad.py. Given per-task
gradients, each task gradient is projected off every task gradient it
conflicts with (a negative inner product) before the tasks are summed
(Yu et al., arXiv:2001.06782). The projection runs against the ORIGINAL
task gradients, its own among them (whose coefficient clamps to 0).
Variables take part by fnmatch allow/deny lists over their flax paths;
the others get the plain sum of the task gradients.

Gradients are dicts of tensors keyed by the flax path of each parameter
('conv1_1/kernel', utils/keypath.py), so one gin string selects the same
variables in both packages. The two variants of the JAX package stay:
per-variable projection and one projection over all masked variables
flattened together (in sorted path order, as jax flattens a dict).
"""

from __future__ import annotations

import fnmatch
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

Grads = Dict[str, torch.Tensor]

_EPS = 1e-5


def make_surgery_mask(params: Mapping[str, torch.Tensor],
                      allowlist: Optional[Sequence[str]] = None,
                      denylist: Optional[Sequence[str]] = None) -> Dict[str, bool]:
    """{path: True where PCGrad applies}: a path matching an allowlist
    wildcard and no denylist wildcard."""
    allow = list(allowlist) if allowlist is not None else ["*"]
    deny = list(denylist) if denylist is not None else []
    return {
        path: any(fnmatch.fnmatchcase(path, w) for w in allow)
        and not any(fnmatch.fnmatchcase(path, w) for w in deny)
        for path in params
    }


def _project_stacked(stacked: torch.Tensor) -> torch.Tensor:
    """[T, D] task gradients -> [D]: each projected off each original task
    gradient it conflicts with, in task order, then summed."""
    sq_norms = torch.sum(stacked * stacked, dim=-1)
    projected = stacked
    for k in range(stacked.shape[0]):
        inner = torch.sum(projected * stacked[k], dim=-1)
        coeff = torch.clamp(inner / (sq_norms[k] + _EPS), max=0.0)
        projected = projected - coeff[:, None] * stacked[k]
    return torch.sum(projected, dim=0)


def project_task_gradients(task_grads: Sequence[Grads],
                           mask: Optional[Mapping[str, bool]] = None,
                           per_variable: bool = True) -> Grads:
    """Combines per-task gradient dicts into one PCGrad gradient dict.

    Args:
      task_grads: one gradient dict per task, all with the same keys.
      mask: optional {path: bool} from make_surgery_mask; unmasked entries
        get the plain task sum.
      per_variable: inner products per variable; otherwise over all masked
        variables flattened into one vector.
    """
    if len(task_grads) == 1:
        return dict(task_grads[0])
    paths = sorted(task_grads[0])
    stacked = {p: torch.stack([g[p] for g in task_grads]) for p in paths}
    summed = {p: torch.sum(s, dim=0) for p, s in stacked.items()}
    picked = [p for p in paths if mask is None or mask[p]]
    if per_variable:
        out = dict(summed)
        for p in picked:
            s = stacked[p]
            out[p] = _project_stacked(s.reshape(s.shape[0], -1)).reshape(s.shape[1:])
        return out
    if not picked:
        return summed
    flat = torch.cat([stacked[p].reshape(len(task_grads), -1) for p in picked], dim=1)
    projected = _project_stacked(flat)
    out, start = dict(summed), 0
    for p in picked:
        size = stacked[p][0].numel()
        out[p] = projected[start:start + size].reshape(stacked[p].shape[1:])
        start += size
    return out


def task_permutation(num_tasks: int, generator: torch.Generator) -> List[int]:
    """The task order pcgrad_gradients takes from `generator`."""
    return torch.randperm(num_tasks, generator=generator).tolist()


def pcgrad_gradients(
    task_loss_fns: Sequence[Callable[[Grads], torch.Tensor]],
    params: Mapping[str, torch.Tensor],
    allowlist: Optional[Sequence[str]] = None,
    denylist: Optional[Sequence[str]] = None,
    per_variable: bool = True,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Grads]:
    """Per-task gradients (torch.autograd.grad of each loss over the params
    dict, 0 for a parameter a loss does not reach; a loss may update
    buffers in place, as train-mode batch norms do), the task order
    permuted when a generator is given (the projection depends on the
    order for more than two tasks), projected and combined. Returns (the
    summed loss, the combined gradients)."""
    grads, losses = [], []
    for fn in task_loss_fns:
        leaves = {path: value.detach().requires_grad_(True) for path, value in params.items()}
        with torch.enable_grad():
            loss = fn(leaves)
            found = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads.append({path: torch.zeros_like(leaf) if g is None else g
                      for (path, leaf), g in zip(leaves.items(), found)})
        losses.append(loss.detach())
    if generator is not None and len(grads) > 1:
        grads = [grads[i] for i in task_permutation(len(grads), generator)]
    mask = (make_surgery_mask(params, allowlist, denylist)
            if allowlist is not None or denylist is not None else None)
    combined = project_task_gradients(grads, mask, per_variable=per_variable)
    return torch.sum(torch.stack(losses)), combined
