"""Collectives over dims of the mesh, each with its autograd rule.

Port of the manual-collective spellings of tensor2robot_tpu/parallel/
collectives.py (`psum`, `pmean`, `ppermute`, `all_to_all`, `all_gather`,
`psum_scatter`, `axis_index`). Where a JAX function names a mesh axis, the
port takes (mesh, axis name): the collective runs over that dim's process
group, among the ranks that share every other coordinate. A tuple of
names, as JAX's tuple of axes, runs over the group of those dims together
(mesh.dims_group: the ranks that differ only along them, indexed
row-major in the mesh's order), as the ZeRO-2 exchange does over a
product of replica dims. Each is differentiable with the rule JAX
transposes it by:

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

Two more have no JAX spelling, because GSPMD inserts them where the JAX
package column-splits a layer over the model dim (parallel/
sharded_params.py): Megatron's pair. `copy_to` is the identity whose
backward sums the cotangent over the dim (a column-split layer's input:
each model rank's partial cotangent holds its own columns' terms), and
`gather_from` is a tiled all_gather whose backward is this rank's slice
of the cotangent (a column-split layer's output, and any leaf gathered
over model: every model rank holds the same cotangent). all_gather's
backward, psum_scatter, would sum those equal cotangents, a gradient
`model` times too large. `psum_dims` sums a tensor over several named
dims with no autograd rule (the squared norms of sharded gradients, for
clipping by a global norm), and `gather_dims` gathers a shard over the
named dims it is cut along, also without one (a checkpoint's whole
leaves).

A dim of size 1 needs no communication: each collective is then its
identity. Ranks of a gloo group move CPU tensors only, so for gloo a CUDA
tensor is staged explicitly: copied into a pinned host buffer, moved by
gloo, and copied back to its device. `staged_bytes()` counts the bytes
those copies move (both ways); nothing is computed on the host, and a
failed collective raises.

The block-scaled codecs of the ZeRO-2 gradient exchange are here too, as
in the JAX module: a registry of `GradientCollective`s (`none`, exact f32
over psum_scatter and all_gather; `fp16`, `int8`, `fp8_e4m3` and
`fp8_e5m2`, each value scaled by its block's max-abs) selected by
T2R_COLLECTIVE_QUANT and T2R_COLLECTIVE_BLOCK, `FlatShardLayout` (the
padding of the raveled parameter vector into equal per-rank shards) and
`wire_summary`. Their `{"q", "s"}` payloads are JAX's bit for bit on the
same vector. They run in plain torch on the tensors' device, as JAX
computes them in jnp outside any kernel; on the wire a payload travels as
its bytes (a uint8 view, since gloo moves no fp8 dtype) and the scales as
f32, staged for gloo like every other CUDA tensor here. Both quantized
collectives also return the dequantized copy of what was sent, so the
caller can carry `sent - intended` as the error-feedback residual.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tensor2robot_tpu_torch import flags
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib

__all__ = [
    "all_gather",
    "all_gather_data_shards",
    "all_reduce_mean_flat",
    "all_to_all",
    "axis_index",
    "broadcast",
    "copy_to",
    "gather_dims",
    "gather_from",
    "pmean",
    "ppermute",
    "psum",
    "psum_data_shards",
    "psum_dims",
    "psum_scatter",
    "reset_staged_bytes",
    "stack_over",
    "staged_bytes",
    # the ZeRO-2 gradient codecs
    "FlatShardLayout",
    "GradientCollective",
    "available_collectives",
    "get_collective",
    "register_collective",
    "wire_summary",
]

#: One mesh dim's name, or a tuple of them (their group: module docstring).
AxisName = Union[str, Tuple[str, ...]]

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
    def of(cls, mesh: DeviceMesh, axis) -> "_Dim":
        """One dim's group (`axis` a name), or the group of several (a
        tuple of names: mesh.dims_group)."""
        if not isinstance(axis, str):
            group, size, index = mesh_lib.dims_group(mesh, axis)
            return cls(group, size, index)
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


class _CopyTo(torch.autograd.Function):
    """The identity; the cotangent summed over the dim's ranks."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g.contiguous(), ctx.dim), None


class _GatherFrom(torch.autograd.Function):
    """Tiled all_gather; the cotangent's chunk of this rank."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.dim.size, dim=ctx.axis)[ctx.dim.index].contiguous(), None, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _psum_scatter(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.dim, ctx.axis), None, None


# -- the sanctioned spellings -------------------------------------------------------


def psum(x: torch.Tensor, mesh: DeviceMesh, axis_name: AxisName) -> torch.Tensor:
    """Sum over the dim's ranks; its cotangent passes unchanged."""
    dim = _Dim.of(mesh, axis_name)
    return x if dim.size == 1 else _PSum.apply(x, dim)


def pmean(x: torch.Tensor, mesh: DeviceMesh, axis_name: AxisName) -> torch.Tensor:
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


def ppermute(x: torch.Tensor, mesh: DeviceMesh, axis_name: AxisName,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Sends x along (source index, destination index) pairs of the dim."""
    dim = _Dim.of(mesh, axis_name)
    perm = tuple((int(s), int(d)) for s, d in perm)
    if dim.size == 1:
        return x
    return _PPermute.apply(x, dim, perm)


def all_to_all(x: torch.Tensor, mesh: DeviceMesh, axis_name: AxisName,
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


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis_name: AxisName, *,
               axis: int = 0) -> torch.Tensor:
    """lax.all_gather(..., tiled=True): every rank's x along `axis`."""
    dim = _Dim.of(mesh, axis_name)
    return x if dim.size == 1 else _AllGather.apply(x, dim, axis)


def psum_scatter(x: torch.Tensor, mesh: DeviceMesh, axis_name: AxisName, *,
                 scatter_dimension: int = 0) -> torch.Tensor:
    """lax.psum_scatter(..., tiled=True): the sum over the dim's ranks,
    this rank's chunk of `scatter_dimension`."""
    dim = _Dim.of(mesh, axis_name)
    return x if dim.size == 1 else _PSumScatter.apply(x, dim, scatter_dimension)


def copy_to(x: torch.Tensor, mesh: DeviceMesh, axis_name: AxisName) -> torch.Tensor:
    """Megatron's f: x as it is, the cotangent summed over the dim's ranks
    (module docstring)."""
    dim = _Dim.of(mesh, axis_name)
    return x if dim.size == 1 else _CopyTo.apply(x, dim)


def gather_from(x: torch.Tensor, mesh: DeviceMesh, axis_name: AxisName, *,
                axis: int = 0) -> torch.Tensor:
    """Megatron's g: every rank's x along `axis` (all_gather's forward),
    the cotangent's chunk of this rank in the backward (module
    docstring)."""
    dim = _Dim.of(mesh, axis_name)
    return x if dim.size == 1 else _GatherFrom.apply(x, dim, axis)


def psum_dims(x: torch.Tensor, mesh: DeviceMesh, axis_names: Sequence[str]) -> torch.Tensor:
    """The sum of x over the ranks that differ from this one only along
    the dims `axis_names` (one psum a dim). No autograd rule."""
    x = x.detach()
    for axis_name in axis_names:
        dim = _Dim.of(mesh, axis_name)
        if dim.size > 1:
            x = _psum(x, dim)
    return x


def gather_dims(shard: torch.Tensor, mesh: DeviceMesh,
                cuts: Sequence[Tuple[str, int]]) -> torch.Tensor:
    """The whole of a tensor cut along the tensor dim d over the mesh dim
    a for each (a, d) of `cuts` (this rank holds chunk i of d, i its index
    along a): every rank's shard gathered, the same on every rank. No
    autograd rule."""
    whole = shard.detach()
    for axis_name, axis in cuts:
        dim = _Dim.of(mesh, axis_name)
        if dim.size > 1:
            whole = _all_gather(whole, dim, axis)
    return whole


def broadcast(x: torch.Tensor, mesh: DeviceMesh, axis_name: AxisName, root: int) -> torch.Tensor:
    """The dim's rank `root`'s x on every rank of the dim (every rank
    passes a tensor of the same shape and dtype). No autograd rule: call
    it on tensors that need none."""
    dim = _Dim.of(mesh, axis_name)
    return x if dim.size == 1 else _broadcast(x.detach(), dim, root)


def stack_over(x: torch.Tensor, mesh: DeviceMesh, axis_name: AxisName) -> torch.Tensor:
    """Every rank's x stacked on a new leading dim in the dim's order
    ([size, *x.shape] on every rank). No autograd rule."""
    dim = _Dim.of(mesh, axis_name)
    x = x.detach()[None]
    return x.clone() if dim.size == 1 else _all_gather(x, dim, 0)


def axis_index(mesh: DeviceMesh, axis_name: AxisName) -> int:
    """This rank's index along the dim."""
    return _Dim.of(mesh, axis_name).index


def all_reduce_mean_flat(tensors: Sequence[torch.Tensor], group_size: int,
                         group=None, count: Optional[int] = None) -> List[torch.Tensor]:
    """The mean over the `group_size` ranks of `group` (None: the world) of
    each tensor, as ONE flat all_reduce of their concatenation (the
    trainer's gradient bucket). With `count` the sum over the group is
    divided by count instead (tensors that already hold a sum of
    count // group_size terms each)."""
    count = group_size if count is None else count
    if (group_size == 1 and count == 1) or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    if group_size > 1:
        world = _Dim.world() if group is None else _Dim(group, group_size, 0)
        wire = world.to_wire(flat)  # the bucket itself where nothing is staged
        dist.all_reduce(wire, group=world.group)
        flat = world.from_wire(wire, flat.device)
    flat = flat / count
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].view(t.shape).to(t.dtype))
        offset += t.numel()
    return out


# -- the ZeRO-2 gradient codecs -------------------------------------------------


def _block_view(x: torch.Tensor, block: int) -> torch.Tensor:
    """[..., L] -> [..., L // block, block]; L must divide by block (the
    FlatShardLayout guarantees it for the trainer's payloads)."""
    if x.shape[-1] % block != 0:
        raise ValueError(f"last dim {x.shape[-1]} not divisible by block {block}")
    return x.reshape(tuple(x.shape[:-1]) + (x.shape[-1] // block, block))


def _block_scales(blocks: torch.Tensor) -> torch.Tensor:
    """Each block's max-abs, a zero block's 1 (its payload is zeros either
    way; 1 keeps the decode free of NaN)."""
    scale = blocks.abs().amax(dim=-1)
    return torch.where(scale > 0, scale, torch.ones_like(scale))


def _exchanged(payload: Dict[str, torch.Tensor], move) -> Dict[str, torch.Tensor]:
    """`move` (an all_to_all or all_gather along dim 0) applied to each
    tensor of a payload as the wire carries it: f32 scales as they are,
    values as their bytes (uint8: gloo moves no fp8 dtype), viewed back in
    their dtype on arrival."""
    out = {}
    for key, t in payload.items():
        if t.dtype == torch.float32:
            out[key] = move(t)
        else:
            out[key] = move(t.contiguous().view(torch.uint8)).view(t.dtype)
    return out


@dataclasses.dataclass(frozen=True)
class GradientCollective:
    """One wire format of the ZeRO-2 gradient exchange over a mesh dim.

    `decode(encode(x))` is what the receivers reconstruct, so
    `x - decode(encode(x))` is the error-feedback residual. Subclasses
    give encode, decode and wire_bytes; the exact one also its own
    collectives (psum_scatter and all_gather instead of an all_to_all of
    payloads)."""

    name: str
    block: int

    def encode(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def decode(self, payload: Dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def wire_bytes(self, n_elements: int) -> int:
        """Payload bytes for n f32 elements (values and per-block scales)."""
        raise NotImplementedError

    def reduce_scatter(self, rows: torch.Tensor, mesh: DeviceMesh,
                       axis: AxisName) -> Tuple[torch.Tensor, torch.Tensor]:
        """Reduce-scatter over the dim `axis` of `mesh`. `rows` [N, L] is
        this rank's gradient in one chunk a peer (N the dim's size): chunk
        j is encoded and sent to peer j (an all_to_all), and each rank
        decodes the N chunks it receives and sums them in f32. Returns
        (reduced [L]: this rank's shard of the sum of every peer's
        dequantized chunks, sent [N, L]: the dequantized copy of what this
        rank sent)."""
        dim = _Dim.of(mesh, axis)
        payload = self.encode(rows)
        received = payload if dim.size == 1 else _exchanged(
            payload, lambda t: _all_to_all(t, dim, 0, 0))
        reduced = self.decode(received).float().sum(dim=0)
        return reduced, self.decode(payload).float()

    def all_gather_shard(self, shard: torch.Tensor, mesh: DeviceMesh,
                         axis: AxisName) -> Tuple[torch.Tensor, torch.Tensor]:
        """All-gather of this rank's [L] shard. Returns (full [N * L]:
        every peer's dequantized shard in the dim's order, the same on
        every rank, sent [L]: the dequantized copy of this rank's own)."""
        dim = _Dim.of(mesh, axis)
        payload = self.encode(shard)
        gathered = payload if dim.size == 1 else _exchanged(
            payload, lambda t: _all_gather(t, dim, 0))
        return self.decode(gathered).float(), self.decode(payload).float()


class ExactCollective(GradientCollective):
    """f32 as it is: psum_scatter and all_gather, and no error channel."""

    def encode(self, x):
        return {"v": x}

    def decode(self, payload):
        return payload["v"]

    def wire_bytes(self, n_elements: int) -> int:
        return 4 * n_elements

    def reduce_scatter(self, rows, mesh, axis):
        dim = _Dim.of(mesh, axis)
        reduced = rows[0] if dim.size == 1 else _psum_scatter(rows, dim, 0)[0]
        return reduced, rows

    def all_gather_shard(self, shard, mesh, axis):
        dim = _Dim.of(mesh, axis)
        return (shard if dim.size == 1 else _all_gather(shard, dim, 0)), shard


class BlockScaledCollective(GradientCollective):
    """The decode of the `{"q": values, "s": per-block scales}` format
    that every quantized collective shares: each block cast to f32 and
    multiplied by its scale."""

    def decode(self, payload):
        q, scales = payload["q"], payload["s"]
        blocks = _block_view(q.float(), self.block)
        return (blocks * scales[..., None]).reshape(q.shape)


class Fp16Collective(BlockScaledCollective):
    """Each block divided by its max-abs into [-1, 1], then cast to fp16:
    no block can overflow, small blocks keep their relative precision.
    2 bytes an element and 4 a block."""

    def encode(self, x):
        blocks = _block_view(x, self.block)
        scales = _block_scales(blocks)
        values = (blocks / scales[..., None]).to(torch.float16)
        return {"q": values.reshape(x.shape), "s": scales}

    def wire_bytes(self, n_elements: int) -> int:
        return 2 * n_elements + 4 * (n_elements // self.block)


class Int8Collective(BlockScaledCollective):
    """Symmetric int8 a block: scale = max-abs / 127, rounded half to even,
    clipped to +-127. 1 byte an element and 4 a block."""

    def encode(self, x):
        blocks = _block_view(x, self.block)
        scales = _block_scales(blocks) / 127.0
        values = torch.clamp(torch.round(blocks / scales[..., None]), -127, 127)
        return {"q": values.to(torch.int8).reshape(x.shape), "s": scales}

    def wire_bytes(self, n_elements: int) -> int:
        return n_elements + 4 * (n_elements // self.block)


class Fp8Collective(BlockScaledCollective):
    """Each block scaled so its max-abs maps to the format's largest
    finite value, clipped to +-that value, then cast. The clip comes
    before the cast: a value past the format's range must not reach it.
    Same wire cost as int8; the rounding is relative to each element."""

    _DTYPE: torch.dtype = None  # subclass: the fp8 storage dtype
    _MAX = 0.0  # subclass: the format's largest finite value

    def encode(self, x):
        blocks = _block_view(x, self.block)
        scales = _block_scales(blocks) / self._MAX
        values = torch.clamp(blocks / scales[..., None], -self._MAX, self._MAX)
        return {"q": values.to(self._DTYPE).reshape(x.shape), "s": scales}

    def wire_bytes(self, n_elements: int) -> int:
        return n_elements + 4 * (n_elements // self.block)


class Fp8E4M3Collective(Fp8Collective):
    """fp8 e4m3 (3 mantissa bits, max 448)."""

    _DTYPE = torch.float8_e4m3fn
    _MAX = 448.0


class Fp8E5M2Collective(Fp8Collective):
    """fp8 e5m2 (2 mantissa bits, max 57344)."""

    _DTYPE = torch.float8_e5m2
    _MAX = 57344.0


_REGISTRY: Dict[str, Callable[[int], GradientCollective]] = {}


def register_collective(name: str):
    """Registers a factory(block) -> GradientCollective under `name`."""

    def deco(factory):
        if name in _REGISTRY:
            raise ValueError(f"collective {name!r} registered twice")
        _REGISTRY[name] = factory
        return factory

    return deco


register_collective("none")(lambda block: ExactCollective("none", block))
register_collective("fp16")(lambda block: Fp16Collective("fp16", block))
register_collective("int8")(lambda block: Int8Collective("int8", block))
register_collective("fp8_e4m3")(lambda block: Fp8E4M3Collective("fp8_e4m3", block))
register_collective("fp8_e5m2")(lambda block: Fp8E5M2Collective("fp8_e5m2", block))


def available_collectives() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_collective(name: Optional[str] = None,
                   block: Optional[int] = None) -> GradientCollective:
    """The collective `name` with blocks of `block`; None reads
    T2R_COLLECTIVE_QUANT and T2R_COLLECTIVE_BLOCK."""
    if name is None:
        name = flags.get_enum("T2R_COLLECTIVE_QUANT")
    if block is None:
        block = flags.get_int("T2R_COLLECTIVE_BLOCK")
    factory = _REGISTRY.get(name)
    if factory is None:
        raise KeyError(
            f"unknown collective {name!r}; available regimes: "
            f"{', '.join(available_collectives())} "
            "(selected by T2R_COLLECTIVE_QUANT, block size by "
            "T2R_COLLECTIVE_BLOCK)"
        )
    return factory(block)


class FlatShardLayout:
    """The raveled parameter vector as equal per-rank shards: num_params
    elements padded with zeros to padded = num_shards * shard_len, where
    shard_len divides by the block. The padded tail has a zero gradient
    forever, so an elementwise optimizer keeps it at zero."""

    def __init__(self, num_params: int, num_shards: int, block: int):
        if num_params < 1:
            raise ValueError("empty parameter vector")
        if num_shards < 1 or block < 1:
            raise ValueError(f"bad layout: shards={num_shards} block={block}")
        shard_len = -(-num_params // num_shards)
        shard_len = -(-shard_len // block) * block
        self.num_params = num_params
        self.num_shards = num_shards
        self.block = block
        self.shard_len = shard_len
        self.padded = shard_len * num_shards

    def pad(self, flat: torch.Tensor) -> torch.Tensor:
        if tuple(flat.shape) != (self.num_params,):
            raise ValueError(
                f"expected [{self.num_params}] vector, got {tuple(flat.shape)}")
        return torch.nn.functional.pad(flat, (0, self.padded - self.num_params))

    def rows(self, flat_padded: torch.Tensor) -> torch.Tensor:
        return flat_padded.reshape(self.num_shards, self.shard_len)

    def unpad(self, flat_padded: torch.Tensor) -> torch.Tensor:
        return flat_padded[: self.num_params]


def wire_summary(collective: GradientCollective, n_elements: int) -> Tuple[int, int]:
    """(f32 bytes, wire bytes) a rank a step of the ZeRO-2 exchange: one
    reduce-scatter of the gradient and one all-gather of the update, each
    of n_elements in the collective's format (train.metrics.
    collective_record names them)."""
    return 2 * 4 * n_elements, 2 * collective.wire_bytes(n_elements)
