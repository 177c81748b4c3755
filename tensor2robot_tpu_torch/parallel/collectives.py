"""Collectives over one dim of the mesh, each with its autograd rule.

Port of the manual-collective spellings of tensor2robot_tpu/parallel/
collectives.py (`psum`, `pmean`, `ppermute`, `all_to_all`, `all_gather`,
`psum_scatter`, `axis_index`). Where a JAX function names a mesh axis, the
port takes (mesh, axis name): the collective runs over that dim's process
group, among the ranks that share every other coordinate. Each is
differentiable with the rule JAX transposes it by:

  * psum   <-> identity (pmean: the cotangent over the dim's size),
  * ppermute(perm) <-> ppermute(inverse perm),
  * all_to_all(split, concat) <-> all_to_all(concat, split),
  * all_gather <-> psum_scatter, and psum_scatter <-> all_gather.

all_to_all, all_gather and psum_scatter are JAX's tiled forms (the only
ones the JAX package calls).

Two have no JAX spelling and no autograd rule, for code that runs its own
schedule (parallel/pipeline.py) and for checkpoints: `broadcast` (one
rank's tensor to every rank of the dim) and `stack_over` (every rank's
tensor stacked on a new dim 0 in the dim's order).

One collective has no JAX spelling: `psum_data_shards`, the sum over the
data x fsdp ranks of the batch norms' moment sums, whose backward SUMS the
cotangent over the same ranks (torch.nn.SyncBatchNorm's rule), where
psum's passes it unchanged. The rules differ because the programs do:
JAX differentiates one program over the global batch, in which psum's
transpose is the identity, while here each rank differentiates its own
shard's loss and the trainer averages the ranks' gradients afterwards
(`Trainer.average_over_ranks`). The global moments reach every shard's
loss, so each rank's moment sums need the sum of every rank's cotangent:
with the identity, every gradient upstream of a norm would miss the
other shards' terms.

A dim of size 1 needs no communication: each collective is then its
identity. Ranks of a gloo group move CPU tensors only, so for gloo a CUDA
tensor is staged explicitly: copied into a pinned host buffer, moved by
gloo, and copied back to its device. `staged_bytes()` counts the bytes
those copies move (both ways); nothing is computed on the host, and a
failed collective raises.

The block-scaled ZeRO-2 codecs of the JAX module (GradientCollective,
FlatShardLayout and the registry around them) are not ported: each of
their names raises naming ROADMAP.md A9.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tensor2robot_tpu_torch.parallel import mesh as mesh_lib

__all__ = [
    "all_gather",
    "all_gather_data_shards",
    "all_reduce_mean_flat",
    "all_to_all",
    "axis_index",
    "broadcast",
    "pmean",
    "ppermute",
    "psum",
    "psum_data_shards",
    "psum_scatter",
    "reset_staged_bytes",
    "stack_over",
    "staged_bytes",
    # not ported (ROADMAP.md A9): each raises
    "FlatShardLayout",
    "GradientCollective",
    "available_collectives",
    "get_collective",
    "register_collective",
    "wire_summary",
]

_STAGED = [0]


def staged_bytes() -> int:
    """Bytes copied between the card and pinned host buffers for gloo
    since the last reset_staged_bytes (both directions)."""
    return _STAGED[0]


def reset_staged_bytes() -> None:
    _STAGED[0] = 0


class _Dim:
    """A group as a collective sees it (one mesh dim's, or the world's):
    the group, its size, this rank's index in it, and whether CUDA tensors
    are staged through the host."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index
        self.staged = size > 1 and dist.get_backend(group) == "gloo"

    @classmethod
    def of(cls, mesh: DeviceMesh, axis: str) -> "_Dim":
        size = mesh_lib.axis_size(mesh, axis)
        if size == 1:
            return cls(None, 1, 0)
        return cls(mesh.get_group(axis), size, mesh.get_local_rank(axis))

    @classmethod
    def data_shards(cls, mesh: DeviceMesh) -> "_Dim":
        """The data x fsdp ranks of this rank's batch (mesh.data_group)."""
        index, count = mesh_lib.data_shard(mesh)
        if count == 1:
            return cls(None, 1, 0)
        return cls(mesh_lib.data_group(mesh), count, index)

    @classmethod
    def world(cls) -> "_Dim":
        return cls(None, dist.get_world_size(), dist.get_rank())

    def global_rank(self, index: int) -> int:
        return dist.get_global_rank(self.group, index)

    def to_wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if not (self.staged and t.is_cuda):
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        _STAGED[0] += t.numel() * t.element_size()
        return host

    def wire_buffer(self, like: torch.Tensor) -> torch.Tensor:
        """A buffer for what arrives in place of `like`: pinned host
        memory when staged."""
        if self.staged and like.is_cuda:
            return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        return torch.empty(like.shape, dtype=like.dtype, device=like.device)

    def from_wire(self, t: torch.Tensor, device: torch.device) -> torch.Tensor:
        if t.device == device:
            return t
        _STAGED[0] += t.numel() * t.element_size()
        return t.to(device)


# -- the collectives' bodies (no autograd) -------------------------------------


def _psum(x: torch.Tensor, dim: _Dim) -> torch.Tensor:
    wire = dim.to_wire(x)
    if wire is x:
        wire = x.clone()
    dist.all_reduce(wire, group=dim.group)
    return dim.from_wire(wire, x.device)


def _ppermute(x: torch.Tensor, dim: _Dim, perm: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
    """x moves along each (source, destination) pair of perm; a rank that
    no pair sends to receives zeros (lax.ppermute)."""
    dest = {s: d for s, d in perm}
    source = {d: s for s, d in perm}
    me = dim.index
    if dest.get(me) == me and source.get(me) == me:
        return x.clone()
    ops: List[dist.P2POp] = []
    received = None
    if me in dest:
        wire = dim.to_wire(x)
        ops.append(dist.P2POp(dist.isend, wire, dim.global_rank(dest[me]), dim.group))
    if me in source:
        received = dim.wire_buffer(x)
        ops.append(dist.P2POp(dist.irecv, received, dim.global_rank(source[me]), dim.group))
    if ops:
        for request in dist.batch_isend_irecv(ops):
            request.wait()
    if received is None:
        return torch.zeros_like(x)
    return dim.from_wire(received, x.device)


def _broadcast(x: torch.Tensor, dim: _Dim, root: int) -> torch.Tensor:
    """Rank `root`'s x on every rank of the dim (x gives the others its
    shape and dtype); a new tensor, x is left as it was. Only the root
    stages what it sends, only the others what they receive."""
    if dim.index == root:
        wire = dim.to_wire(x)
        dist.broadcast(wire, src=dim.global_rank(root), group=dim.group)
        return x.clone()
    wire = dim.wire_buffer(x)
    dist.broadcast(wire, src=dim.global_rank(root), group=dim.group)
    return dim.from_wire(wire, x.device)


def _all_to_all(x: torch.Tensor, dim: _Dim, split_axis: int, concat_axis: int) -> torch.Tensor:
    """Tiled all_to_all: chunk j of split_axis goes to rank j; the chunks
    received are concatenated along concat_axis in rank order."""
    send = torch.stack(x.chunk(dim.size, dim=split_axis))
    wire = dim.to_wire(send)
    received = dim.wire_buffer(send)
    dist.all_to_all_single(received, wire, group=dim.group)
    received = dim.from_wire(received, x.device)
    return torch.cat(received.unbind(0), dim=concat_axis)


def _all_gather(x: torch.Tensor, dim: _Dim, axis: int) -> torch.Tensor:
    """Tiled all_gather: every rank's x concatenated along `axis`."""
    wire = dim.to_wire(x)
    parts = [dim.wire_buffer(x) for _ in range(dim.size)]
    dist.all_gather(parts, wire, group=dim.group)
    return torch.cat([dim.from_wire(p, x.device) for p in parts], dim=axis)


def _psum_scatter(x: torch.Tensor, dim: _Dim, axis: int) -> torch.Tensor:
    """Tiled psum_scatter: the sum over ranks, this rank's chunk of `axis`.
    NCCL reduce-scatters; gloo (no reduce_scatter) sums and keeps the
    chunk."""
    if x.shape[axis] % dim.size:
        raise ValueError(
            f"psum_scatter: dim {axis} of {tuple(x.shape)} does not split "
            f"{dim.size} ways"
        )
    if dist.get_backend(dim.group) != "nccl":
        return _psum(x, dim).chunk(dim.size, dim=axis)[dim.index].contiguous()
    send = x.movedim(axis, 0).contiguous()
    out = torch.empty((send.shape[0] // dim.size,) + tuple(send.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, send, group=dim.group)
    return out.movedim(0, axis).contiguous()


# -- autograd ---------------------------------------------------------------------


def _inverse(perm) -> Tuple[Tuple[int, int], ...]:
    return tuple((d, s) for s, d in perm)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        return _psum(x, dim)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PSumBoth(torch.autograd.Function):
    """Sum over the ranks, and the cotangent summed over them too."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _psum(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _psum(g.contiguous(), ctx.dim), None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, perm):
        ctx.dim, ctx.perm = dim, perm
        return _ppermute(x, dim, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g.contiguous(), ctx.dim, _inverse(ctx.perm)), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, split_axis, concat_axis):
        ctx.args = (dim, concat_axis, split_axis)
        return _all_to_all(x, dim, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _psum_scatter(g, ctx.dim, ctx.axis), None, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _psum_scatter(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.dim, ctx.axis), None, None


# -- the sanctioned spellings -------------------------------------------------------


def psum(x: torch.Tensor, mesh: DeviceMesh, axis_name: str) -> torch.Tensor:
    """Sum over the dim's ranks; its cotangent passes unchanged."""
    dim = _Dim.of(mesh, axis_name)
    return x if dim.size == 1 else _PSum.apply(x, dim)


def pmean(x: torch.Tensor, mesh: DeviceMesh, axis_name: str) -> torch.Tensor:
    dim = _Dim.of(mesh, axis_name)
    return x if dim.size == 1 else _PSum.apply(x, dim) / dim.size


def all_gather_data_shards(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every data x fsdp shard's x concatenated along dim 0 in shard order:
    a loss that spans the batch (a contrastive loss) sees the global
    batch. Its backward is all_gather's, psum_scatter: every rank computes
    the same global loss, so each shard's rows receive N times their
    cotangent, and the trainer's pmean over the ranks divides the N back
    out (layers/transformer.py's rule)."""
    dim = _Dim.data_shards(mesh)
    return x if dim.size == 1 else _AllGather.apply(x, dim, 0)


def psum_data_shards(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Sum over this rank's data x fsdp shards (every shard of the global
    batch); the cotangent is summed over them as well (module docstring).
    For the batch norms' moment sums: a norm fuses its sum, sum of squares
    and count into one x, so it makes one call."""
    dim = _Dim.data_shards(mesh)
    return x if dim.size == 1 else _PSumBoth.apply(x, dim)


def ppermute(x: torch.Tensor, mesh: DeviceMesh, axis_name: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Sends x along (source index, destination index) pairs of the dim."""
    dim = _Dim.of(mesh, axis_name)
    perm = tuple((int(s), int(d)) for s, d in perm)
    if dim.size == 1:
        return x
    return _PPermute.apply(x, dim, perm)


def all_to_all(x: torch.Tensor, mesh: DeviceMesh, axis_name: str,
               split_axis: int, concat_axis: int) -> torch.Tensor:
    """lax.all_to_all(..., tiled=True): split_axis shrinks by the dim's
    size and concat_axis grows by it."""
    dim = _Dim.of(mesh, axis_name)
    if dim.size == 1:
        return x
    if x.shape[split_axis] % dim.size:
        raise ValueError(
            f"all_to_all: dim {split_axis} of {tuple(x.shape)} does not split "
            f"{dim.size} ways"
        )
    return _AllToAll.apply(x, dim, split_axis, concat_axis)


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis_name: str, *,
               axis: int = 0) -> torch.Tensor:
    """lax.all_gather(..., tiled=True): every rank's x along `axis`."""
    dim = _Dim.of(mesh, axis_name)
    return x if dim.size == 1 else _AllGather.apply(x, dim, axis)


def psum_scatter(x: torch.Tensor, mesh: DeviceMesh, axis_name: str, *,
                 scatter_dimension: int = 0) -> torch.Tensor:
    """lax.psum_scatter(..., tiled=True): the sum over the dim's ranks,
    this rank's chunk of `scatter_dimension`."""
    dim = _Dim.of(mesh, axis_name)
    return x if dim.size == 1 else _PSumScatter.apply(x, dim, scatter_dimension)


def broadcast(x: torch.Tensor, mesh: DeviceMesh, axis_name: str, root: int) -> torch.Tensor:
    """The dim's rank `root`'s x on every rank of the dim (every rank
    passes a tensor of the same shape and dtype). No autograd rule: call
    it on tensors that need none."""
    dim = _Dim.of(mesh, axis_name)
    return x if dim.size == 1 else _broadcast(x.detach(), dim, root)


def stack_over(x: torch.Tensor, mesh: DeviceMesh, axis_name: str) -> torch.Tensor:
    """Every rank's x stacked on a new leading dim in the dim's order
    ([size, *x.shape] on every rank). No autograd rule."""
    dim = _Dim.of(mesh, axis_name)
    x = x.detach()[None]
    return x.clone() if dim.size == 1 else _all_gather(x, dim, 0)


def axis_index(mesh: DeviceMesh, axis_name: str) -> int:
    """This rank's index along the dim."""
    return _Dim.of(mesh, axis_name).index


def all_reduce_mean_flat(tensors: Sequence[torch.Tensor], group_size: int,
                         group=None) -> List[torch.Tensor]:
    """The mean over the `group_size` ranks of `group` (None: the world) of
    each tensor, as ONE flat all_reduce of their concatenation (the
    trainer's gradient bucket)."""
    if group_size == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    world = _Dim.world() if group is None else _Dim(group, group_size, 0)
    wire = world.to_wire(flat)  # the bucket itself where nothing is staged
    dist.all_reduce(wire, group=world.group)
    flat = world.from_wire(wire, flat.device) / group_size
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].view(t.shape).to(t.dtype))
        offset += t.numel()
    return out


def _unported(name: str):
    def codec(*args, **kwargs):
        raise NotImplementedError(
            f"{name}: the block-scaled ZeRO-2 gradient collectives are not "
            "ported yet (ROADMAP.md A9)"
        )
    codec.__name__ = name
    return codec


GradientCollective = _unported("GradientCollective")
FlatShardLayout = _unported("FlatShardLayout")
available_collectives = _unported("available_collectives")
get_collective = _unported("get_collective")
register_collective = _unported("register_collective")
wire_summary = _unported("wire_summary")
