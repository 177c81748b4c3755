"""Pipeline parallelism: GPipe microbatch scheduling over the pipe dim.

Port of tensor2robot_tpu/parallel/pipeline.py. S stages live on the mesh's
`pipe` dim, one stage a pipe rank: with M microbatches, stage 0 injects
them one by one, each stage applies itself to the microbatch it holds and
sends the result down the chain with `collectives.ppermute`, and the last
stage's outputs are broadcast to every pipe rank, as JAX's masked `psum`
replicates them.

The JAX package runs the schedule as ONE jitted program: a `lax.scan` over
M + S - 1 clock ticks on every device, ppermute differentiated by its
transpose. The port runs it per rank, multi-controller, with the same
chain of ticks, and its backward is written out (`_GPipe`, a
torch.autograd.Function): autograd through per-tick ppermutes would
misroute, since stage 0 never uses what its first ppermutes deliver, so
their backward never runs and the next stage's cotangent finds no
receiver. `_GPipe`'s forward runs the stage on each of its microbatches
and keeps that microbatch's stage graph (from a detached input); its
backward walks the microbatches in reverse: the output cotangent comes
from stage s + 1 (the last stage takes its own), `torch.autograd.grad`
runs over the stage's graph, and the input cotangent goes to stage s - 1.
Every rank issues the same point-to-point calls in the same order. The
stage's parameter gradients come back as gradients of the parameters
passed in, and stage 0's input cotangent is broadcast to every pipe rank
(JAX sums the cotangent of an input replicated over pipe: only stage 0's
is not zero).

A stated divergence in launches, not in results: JAX's scan runs every
stage on every tick, on zeros while the pipeline fills and on the last
microbatch again past M (`_pipeline_shard`'s garbage ticks, never read).
Here a stage computes only on the M ticks that hold a real microbatch,
so a stage's kernels launch M times a step (no stage has batch
statistics or draws, so the outputs and gradients are the same).

Ported layout: JAX stacks S per-stage parameter trees into [S, ...]
leaves sharded dim 0 over pipe (`stack_stage_params`, `stage_sharding`);
here a rank holds only its stage's slice (`stage_sharding` takes it), and
`pipeline_apply` takes that slice.

Usage, on every rank of the mesh:
    params  = [stage_init(i) for i in range(S)]       # same tree per stage
    local   = stage_sharding(mesh, stack_stage_params(params))
    out     = pipeline_apply(stage_fn, local, x_local, mesh=mesh,
                             num_microbatches=M)
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel.mesh import PIPE_AXIS, PIPE_STAGES_KEY, axis_size


def stack_stage_params(stage_params: Sequence[Any]):
    """Stacks S per-stage parameter trees into one tree of [S, ...] leaves
    (every stage shares one tree structure)."""
    leaves, specs = zip(*(pytree.tree_flatten(p) for p in stage_params))
    if any(spec != specs[0] for spec in specs):
        raise ValueError("every stage must share one parameter tree structure")
    return pytree.tree_unflatten([torch.stack(group) for group in zip(*leaves)],
                                 specs[0])


def stage_sharding(mesh, stacked_params):
    """This rank's stage of stacked [S, ...] parameters (dim 0 over `pipe`,
    as the JAX sharding places them): each leaf's slice at this rank's pipe
    index, a leaf of its own."""
    stage = collectives.axis_index(mesh, PIPE_AXIS)
    return pytree.tree_map(lambda leaf: leaf[stage].detach().clone(), stacked_params)


# A stacked stage entry: (what precedes `pipe_stages.`, its block, the rest).
_STAGE_ENTRY = re.compile(rf"^(.*?){PIPE_STAGES_KEY}\.block_(\d+)\.(.+)$")


def unstack_stages(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A state dict whose stage entries are stacked ([S, ...] under
    `<head>pipe_stages.block_<b>.`, the trainer's checkpoint layout) as
    the chain's: stage s's block b becomes `<head>block_<s * n + b>.`, n
    the blocks of a stage. Other entries pass as they are."""
    matches = {key: _STAGE_ENTRY.match(key) for key in tensors}
    per_stage: Dict[str, int] = {}
    for match in filter(None, matches.values()):
        per_stage[match[1]] = max(per_stage.get(match[1], 0), int(match[2]) + 1)
    out = {}
    for key, value in tensors.items():
        match = matches[key]
        if match is None:
            out[key] = value
            continue
        head, block, rest = match[1], int(match[2]), match[3]
        for s in range(value.shape[0]):
            out[f"{head}block_{s * per_stage[head] + block}.{rest}"] = value[s]
    return out


class _Schedule:
    """One rank's GPipe schedule: its stage `stage` of `stages`, over
    `num_microbatches` microbatches of the local batch."""

    def __init__(self, stage_fn, spec, mesh, axis_name, stages, num_microbatches):
        self.stage_fn, self.spec, self.mesh = stage_fn, spec, mesh
        self.axis_name, self.stages, self.micro = axis_name, stages, num_microbatches
        self.stage = collectives.axis_index(mesh, axis_name)

    def _forward_micro(self, tick: int, stage: int) -> Optional[int]:
        m = tick - stage
        return m if 0 <= m < self.micro else None

    def _backward_micro(self, tick: int, stage: int) -> Optional[int]:
        m = self.micro - 1 - (tick - (self.stages - 1 - stage))
        return m if 0 <= m < self.micro else None

    def _shift(self, value, like, tick: int, forward: bool):
        """The tick's ppermute down the chain (forward) or up it: only the
        pairs whose sender holds a real microbatch this tick."""
        if forward:
            perm = [(i, i + 1) for i in range(self.stages - 1)
                    if self._forward_micro(tick, i) is not None]
        else:
            perm = [(i, i - 1) for i in range(1, self.stages)
                    if self._backward_micro(tick, i) is not None]
        if not any(self.stage in pair for pair in perm):
            return None  # this rank neither sends nor receives this tick
        send = torch.zeros_like(like) if value is None else value.detach().to(like.dtype)
        return collectives.ppermute(send, self.mesh, self.axis_name, perm)

    def forward(self, x: torch.Tensor, params: List[torch.Tensor], keep_graph: bool):
        """The forward ticks; returns (the outputs broadcast from the last
        stage, the stage's (input, output) graph per microbatch)."""
        tree = pytree.tree_unflatten(params, self.spec)
        micro = x.chunk(self.micro)
        last = self.stage == self.stages - 1
        outs: List[Optional[torch.Tensor]] = [None] * self.micro
        graphs: List[Any] = [None] * self.micro
        resident = None
        for tick in range(self.micro + self.stages - 1):
            m = self._forward_micro(tick, self.stage)
            y = None
            if m is not None:
                inp = micro[m] if self.stage == 0 else resident
                if keep_graph:
                    inp = inp.detach().requires_grad_(self.stage > 0 or x.requires_grad)
                    with torch.enable_grad():
                        y = self.stage_fn(tree, inp)
                    graphs[m] = (inp, y)
                else:
                    y = self.stage_fn(tree, inp)
                if last:
                    outs[m] = y.detach().to(x.dtype)
            received = self._shift(y, micro[0], tick, forward=True)
            if received is not None:
                resident = received
        out = torch.cat(outs) if last else torch.zeros_like(x)
        return collectives.broadcast(out, self.mesh, self.axis_name, self.stages - 1), graphs

    def backward(self, graphs, dout: torch.Tensor, params: List[torch.Tensor],
                 needs_input_grad: bool):
        """The backward ticks in reverse; returns (the input's cotangent
        broadcast from stage 0 or None, each parameter's gradient or
        None)."""
        wanted = [i for i, p in enumerate(params) if p.requires_grad]
        grads: List[Optional[torch.Tensor]] = [None] * len(params)
        douts = dout.chunk(self.micro)
        dx: List[Optional[torch.Tensor]] = [None] * self.micro
        incoming = None
        for tick in range(self.micro + self.stages - 1):
            m = self._backward_micro(tick, self.stage)
            dinp = None
            if m is not None:
                inp, y = graphs[m]
                graphs[m] = None
                cotangent = douts[m] if self.stage == self.stages - 1 else incoming
                wrt = ([inp] if inp.requires_grad else []) + [params[i] for i in wanted]
                got = torch.autograd.grad(y, wrt, grad_outputs=cotangent.to(y.dtype),
                                          allow_unused=True)
                if inp.requires_grad:
                    dinp, got = got[0], got[1:]
                for i, g in zip(wanted, got):
                    if g is not None:
                        grads[i] = g if grads[i] is None else grads[i] + g
                if self.stage == 0:
                    dx[m] = dinp
            received = self._shift(dinp, douts[0], tick, forward=False)
            if received is not None:
                incoming = received
        if not needs_input_grad:
            return None, grads
        if self.stage == 0:
            local = torch.cat([torch.zeros_like(douts[0]) if d is None else d.to(dout.dtype)
                               for d in dx])
        else:
            local = torch.zeros_like(dout)
        return collectives.broadcast(local, self.mesh, self.axis_name, 0), grads


class _GPipe(torch.autograd.Function):
    """The schedule with its backward written out (module docstring).
    Once-differentiable."""

    @staticmethod
    def forward(ctx, schedule: _Schedule, x, *params):
        out, graphs = schedule.forward(x, list(params), keep_graph=True)
        ctx.schedule, ctx.graphs, ctx.params = schedule, graphs, params
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        dx, grads = ctx.schedule.backward(ctx.graphs, dout.contiguous(),
                                          list(ctx.params), ctx.needs_input_grad[1])
        ctx.graphs = ctx.params = None
        return (None, dx) + tuple(grads)


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params,
    x: torch.Tensor,
    *,
    mesh,
    num_microbatches: int,
    axis_name: str = PIPE_AXIS,
    batch_axis: Optional[str] = None,
    sequence_axis: Optional[str] = None,
) -> torch.Tensor:
    """Runs this rank's x through the S chained stages with GPipe
    microbatch overlap.

    Args:
      stage_fn: (stage_params, microbatch [mb, ...]) -> [mb, ...], every
        stage's program (chainable: input and output shapes match).
      stage_params: this rank's stage's parameters (`stage_sharding` of
        the stacked tree); stage_fn receives them as given, and their
        gradients flow back to them.
      x: this rank's [batch, ...]: the local batch shard over
        `batch_axis` and, over `sequence_axis`, the local sequence shard
        in dim 1 (stage_fn then runs the manual ring or Ulysses over it).
        The same on every pipe rank; only stage 0 reads it.
      mesh: the mesh; its `axis_name` dim has size S.
      batch_axis: the dim (or dims) the batch is sharded over.
      num_microbatches: M; the global batch (the local batch times the
        `batch_axis` size) must divide by it and each global microbatch
        by the `batch_axis` size, as in JAX.

    Returns this rank's [batch, ...]: stage_{S-1}(...stage_0(x)), the same
    on every pipe rank. With one stage no collective runs: stage_fn over
    the microbatches in turn.
    """
    stages = axis_size(mesh, axis_name)
    batch_axes = () if batch_axis is None else (
        (batch_axis,) if isinstance(batch_axis, str) else tuple(batch_axis))
    data_size = math.prod(axis_size(mesh, axis) for axis in batch_axes)
    batch = x.shape[0] * data_size
    if batch % num_microbatches != 0:
        raise ValueError(
            f"batch {batch} not divisible by microbatches {num_microbatches}"
        )
    if batch_axis is not None and (batch // num_microbatches) % data_size != 0:
        raise ValueError(
            f"microbatch size {batch // num_microbatches} not divisible "
            f"by {batch_axis} axis size {data_size}"
        )
    if sequence_axis is not None:
        seq_size = axis_size(mesh, sequence_axis)
        if x.ndim < 2:
            raise ValueError(
                f"sequence dim None not divisible by {sequence_axis} axis "
                f"size {seq_size}"
            )
    params, spec = pytree.tree_flatten(stage_params)
    if stages == 1:
        return torch.cat([stage_fn(stage_params, mb) for mb in x.chunk(num_microbatches)])
    schedule = _Schedule(stage_fn, spec, mesh, axis_name, stages, num_microbatches)
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
        return _GPipe.apply(schedule, x, *params)
    out, _ = schedule.forward(x, params, keep_graph=False)
    return out
