"""The device mesh: six named dims over the ranks of a process group.

Port of tensor2robot_tpu/parallel/mesh.py. The JAX package is
single-controller: one process owns a `jax.sharding.Mesh` of devices and
places global arrays on it. The port is multi-controller: one process per
rank, a `torch.distributed` process group over the ranks, and a
`torch.distributed.device_mesh.DeviceMesh` over that group with the JAX
package's six named dims (data, fsdp, model, sequence, pipe, expert). Every
function of the port runs on its rank's local shards, so placing a batch
(`shard_batch`) means taking this rank's slice of it.

The backend is NCCL when each rank owns a card and gloo when asked for (the
CPU, or several ranks sharing one card: a card holds one NCCL rank at
most). `parallel/collectives.py` stages CUDA tensors through pinned host
buffers for gloo.

What a mesh runs: the batch split over data x fsdp, the parameters
sharded over fsdp and model where either is above 1 (`param_sharding`,
the rule of the trainer's sharded_params regime: ZeRO-3 over fsdp and the
Megatron column split over model, decided on each parameter's flax layout
as the JAX package decides it; parallel/sharded_params.py holds the
shards), the sequence dim's ring or Ulysses attention, the pipe dim's
GPipe stages (parallel/pipeline.py: each pipe rank holds one stage's
blocks, the entries that `pipe_stage_param_rule` names) and the expert
dim's resident experts (ops/moe.py). `weight_update_sharding` is the
ZeRO-2 rule of the trainer's shard_weight_update regime: which dim of a
leaf's optimizer moments (and EMA) a rank of the replica group (the
product of the weight-update dims) keeps its slice of, decided on the
leaf's flax layout as JAX decides it (`weight_update_dim`). Both rules layer
under `pipe_stage_param_rule`, as the JAX trainer's `place` layers them:
over a pipe dim above 1 a stage entry is its stage's, whole on every rank
of the stage, whatever the base rule says. Every dim composes with every
other; `dims_group` is the process group of any set of dims.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
MODEL_AXIS = "model"
SEQUENCE_AXIS = "sequence"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"
AXES = (DATA_AXIS, FSDP_AXIS, MODEL_AXIS, SEQUENCE_AXIS, PIPE_AXIS, EXPERT_AXIS)

#: The module name under which a pipelined encoder keeps its stage's blocks
#: (layers/transformer.py), as the flax param key of the JAX package's
#: stacked [S, ...] stage parameters: a state entry with this name among
#: its components is stage-local (pipe_stage_param_rule).
PIPE_STAGES_KEY = "pipe_stages"

#: Leaves with fewer elements stay replicated under the sharding rules:
#: sharding a bias buys nothing and costs a collective.
MIN_WEIGHT_SIZE = 2 ** 14

#: Seconds a collective may wait for its peers before it raises: a hung or
#: dead rank fails the run instead of blocking it.
COLLECTIVE_TIMEOUT_S = 300


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Joins this process to the world's process group; a no-op for a world
    of 1 and when the group already exists.

    Arguments default from the standard torch environment (WORLD_SIZE,
    RANK, and MASTER_ADDR/MASTER_PORT through init_method "env://"), the
    counterpart of jax.distributed's coordinator variables. The backend
    defaults to NCCL where there is a card, gloo otherwise; with NCCL the
    rank binds cuda:LOCAL_RANK. Collectives time out after
    COLLECTIVE_TIMEOUT_S.
    """
    if dist.is_initialized():
        return
    world_size = int(world_size if world_size is not None
                     else os.environ.get("WORLD_SIZE", 1))
    if world_size == 1:
        return
    rank = int(rank if rank is not None else os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
    )


def make_mesh(
    data: Optional[int] = None,
    fsdp: int = 1,
    model: int = 1,
    sequence: int = 1,
    pipe: int = 1,
    expert: int = 1,
) -> DeviceMesh:
    """A DeviceMesh over every rank of the world with dims (data, fsdp,
    model, sequence, pipe, expert). `data=None` absorbs the ranks left;
    the sizes must multiply to the world size. Ranks enumerate row-major,
    so the fastest-varying dims (sequence, pipe, expert) hold neighbouring
    ranks, as jax.devices() order puts them on ICI neighbours.

    Without a process group a mesh of one rank is made over an in-process
    group of one (no network, no peers)."""
    if not dist.is_initialized():
        if (data or 1) * fsdp * model * sequence * pipe * expert != 1:
            raise ValueError(
                "a mesh of more than one rank needs the process group: call "
                "initialize_distributed first"
            )
        dist.init_process_group(
            "gloo", store=dist.HashStore(), world_size=1, rank=0
        )
    n = dist.get_world_size()
    fixed = fsdp * model * sequence * pipe * expert
    if data is None:
        if n % fixed != 0:
            raise ValueError(
                f"{n} devices not divisible by "
                f"fsdp*model*sequence*pipe*expert={fixed}"
            )
        data = n // fixed
    if data * fixed != n:
        raise ValueError(
            f"Mesh {data}x{fsdp}x{model}x{sequence}x{pipe}x{expert} "
            f"!= {n} devices"
        )
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(n).reshape(data, fsdp, model, sequence, pipe, expert)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def check_mesh(mesh) -> DeviceMesh:
    """Returns `mesh` when it is a DeviceMesh with the six named dims;
    raises TypeError naming the type the port wants otherwise."""
    if not isinstance(mesh, DeviceMesh) or tuple(mesh.mesh_dim_names or ()) != AXES:
        raise TypeError(
            "mesh must be a torch.distributed.device_mesh.DeviceMesh with "
            f"dims {AXES} (parallel.mesh.make_mesh), got {type(mesh).__name__}"
        )
    return mesh


def mesh_shape(mesh: Optional[DeviceMesh]) -> Dict[str, int]:
    """{dim name: size}; every dim 1 for no mesh (as dict(jax_mesh.shape))."""
    if mesh is None:
        return {axis: 1 for axis in AXES}
    return dict(zip(AXES, check_mesh(mesh).shape))


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    return mesh_shape(mesh)[axis]


def data_shard(mesh: DeviceMesh) -> Tuple[int, int]:
    """(this rank's index, the count) of the batch shards: data x fsdp,
    fsdp varying fastest."""
    shape = mesh_shape(mesh)
    index = (mesh.get_local_rank(DATA_AXIS) * shape[FSDP_AXIS]
             + mesh.get_local_rank(FSDP_AXIS))
    return index, shape[DATA_AXIS] * shape[FSDP_AXIS]


# (id(mesh), dims) -> (the mesh, this rank's group, its index): made once.
_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Tuple[DeviceMesh, Any, int]] = {}


def complement(axes: Sequence[str]) -> Tuple[str, ...]:
    """The mesh dims not in `axes`, in the mesh's order."""
    return tuple(axis for axis in AXES if axis not in axes)


def dims_group(mesh: DeviceMesh, axes: Sequence[str]) -> Tuple[Any, int, int]:
    """(the process group, its size, this rank's index in it) of the ranks
    that differ from this rank only along the mesh dims `axes`: they share
    every other coordinate. The index runs row-major over `axes` in the
    mesh's order (the group's own rank order). The group is None, the
    world's default group, where `axes` span every rank, and for a mesh
    of one rank without a process group. The first call for a mesh and a
    set of dims creates the group of every coordinate of the other dims
    (dist.new_group; a group of 1 too), so every rank makes it, in the
    same order: the trainer does when it is built."""
    axes = tuple(axis for axis in AXES if axis in set(axes))
    shape = mesh_shape(mesh)
    size = int(np.prod([shape[axis] for axis in axes]))
    if mesh is None:
        return None, 1, 0
    if size == dist.get_world_size():
        return None, size, dist.get_rank()
    key = (id(mesh), axes)
    cached = _GROUPS.get(key)
    if cached is None or cached[0] is not mesh:
        me, mine, index = dist.get_rank(), None, 0
        order = [AXES.index(axis) for axis in complement(axes) + axes]
        for ranks in mesh.mesh.permute(order).reshape(-1, size).tolist():
            group = dist.new_group(ranks)
            if me in ranks:
                mine, index = group, ranks.index(me)
        cached = _GROUPS[key] = (mesh, mine, index)
    return cached[1], size, cached[2]


def data_group(mesh: DeviceMesh):
    """The process group of this rank's data x fsdp shards: the ranks that
    share its model, sequence, pipe and expert coordinates, whose shards
    together are one global batch (the batch norms' moments and the
    trainer's draws are over it). None means the world's default group
    (every rank is a data x fsdp shard). Ranks enumerate in data_shard
    order (dims_group, which makes it)."""
    return dims_group(mesh, (DATA_AXIS, FSDP_AXIS))[0]


def pipe_group(mesh: DeviceMesh):
    """The process group of this rank's pipeline: the ranks that share
    every coordinate but pipe, in stage order (the pipe dim's group, over
    which activations and their cotangents travel). None for a pipe dim
    of 1."""
    if mesh_shape(mesh)[PIPE_AXIS] == 1:
        return None
    return mesh.get_group(PIPE_AXIS)


def stage_group(mesh: DeviceMesh) -> Tuple[Any, int]:
    """(the process group, its size) of the ranks that share this rank's
    pipe coordinate: the replicas of its stage, over which a stage-local
    gradient is averaged. The group is None (the world's default group)
    for a pipe dim of 1 (dims_group, which makes it)."""
    group, size, _ = dims_group(mesh, complement((PIPE_AXIS,)))
    return group, size


def is_stage_entry(name: str) -> bool:
    """Whether a state entry (a '.'-joined state-dict name, or a '/'-joined
    flax path) lies under a pipelined module's stages."""
    return PIPE_STAGES_KEY in name.replace("/", ".").split(".")


def pipe_stage_param_rule(mesh: Optional[DeviceMesh], base_rule=None):
    """The per-rank meaning of the JAX rule (which shards a stacked
    [S, ...] leaf under PIPE_STAGES_KEY dim 0 over `pipe` and nothing
    else): rule(name, tensor) is PIPE_AXIS for a stage-local entry of a
    mesh whose pipe dim is above 1 (this rank holds its own stage's slice
    of it, whole), else base_rule(name, tensor) (None: replicated, the
    entry is whole on every rank). The stage rule wins over the base rule
    (param_sharding's, weight_update_sharding's), as in JAX's `place`.
    Parameters, their gradients, optimizer moments and the EMA share the
    names, so one rule places them all."""
    pipes = mesh_shape(mesh)[PIPE_AXIS]

    def rule(name: str, tensor=None):
        if pipes > 1 and is_stage_entry(name):
            return PIPE_AXIS
        return None if base_rule is None else base_rule(name, tensor)

    return rule


def shard_batch(batch, mesh: DeviceMesh, microbatches: int = 1):
    """This rank's slice of a host batch: the leading axis split over
    data x fsdp (ranks on the same data and fsdp index get the same
    slice). With `microbatches` = K (the trainer's grad_accum_steps) the
    slice is this rank's share of each of the K microbatches in turn, so
    microbatch i over the ranks is microbatch i of the global batch, as
    the single-device step cuts it (a batch the shards split but the
    microbatches do not raises ValueError). A leaf whose leading dim does
    not divide over the shards (small predict batches, scalars) is kept
    whole, as the JAX package replicates it. Works on any mapping of
    numpy arrays or tensors; returns the same mapping type."""
    index, divisor = data_shard(mesh)
    out = type(batch)()
    for key, leaf in batch.items():
        leaf_shape = getattr(leaf, "shape", ())
        if len(leaf_shape) >= 1 and leaf_shape[0] % divisor == 0:
            if leaf_shape[0] % (divisor * microbatches):
                raise ValueError(
                    f"Leaf {key!r} batch {leaf_shape[0]} does not split into "
                    f"{microbatches} microbatches over {divisor} shards")
            size = leaf_shape[0] // (divisor * microbatches)
            parts = [leaf[(m * divisor + index) * size:(m * divisor + index + 1) * size]
                     for m in range(microbatches)]
            out[key] = parts[0] if microbatches == 1 else _concatenate(parts)
        else:
            out[key] = leaf
    return out


def _concatenate(parts):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return np.concatenate(parts)


def weight_update_dim(shape: Sequence[int], group_size: int,
                      min_weight_size: int = MIN_WEIGHT_SIZE,
                      name: Optional[str] = None) -> Optional[int]:
    """The dim of a leaf of `shape` that the ZeRO-2 rule shards over a
    replica group of `group_size`: the largest one the group's size
    divides (the first of equal ones), or None for a leaf under
    `min_weight_size` elements, a leaf no dim of which divides (nothing is
    padded), and a group of 1. With the state-dict entry's `name` the rule
    decides on the entry's flax layout (utils/jax_params.flax_dims), as
    the JAX package decides it, and returns the torch dim that holds the
    flax dim it picks: a square Linear weight [out, in] is sliced on `in`,
    the flax kernel's first dim."""
    shape = tuple(int(s) for s in shape)
    if group_size == 1 or not shape or int(np.prod(shape)) < min_weight_size:
        return None
    dims = tuple(range(len(shape)))
    if name is not None:
        # Imported here: utils/jax_params imports this module.
        from tensor2robot_tpu_torch.utils.jax_params import flax_dims

        dims = flax_dims(name, len(shape))
    flax_shape = [0] * len(shape)
    for i, j in enumerate(dims):
        flax_shape[j] = shape[i]
    for dim in sorted(range(len(shape)), key=lambda i: flax_shape[i], reverse=True):
        if flax_shape[dim] % group_size == 0:
            return dims.index(dim)
    return None


def weight_update_sharding(
    mesh: Optional[DeviceMesh],
    min_weight_size: int = MIN_WEIGHT_SIZE,
    axes: Tuple[str, ...] = (DATA_AXIS,),
):
    """The ZeRO-2 rule (cross-replica weight-update sharding, arXiv:
    2004.13336): parameters stay whole on every rank for the forward and
    backward, and each rank of the replica group (the product of `axes`)
    keeps the optimizer moments and the EMA of its slice of every leaf
    the rule shards. rule(tensor, name=None) is weight_update_dim of the
    tensor's shape over the group (decided on the flax layout of the
    state-dict entry `name` where it is given, as the trainer gives it)."""
    shape = mesh_shape(mesh)
    group_size = int(np.prod([shape[axis] for axis in axes]))

    def rule(tensor, name: Optional[str] = None) -> Optional[int]:
        return weight_update_dim(tuple(tensor.shape), group_size, min_weight_size, name)

    return rule


def flax_param_spec(shape: Sequence[int], fsdp: int, model: int,
                    min_weight_size: int = MIN_WEIGHT_SIZE) -> List[Optional[str]]:
    """The JAX package's param_sharding on a leaf of the flax `shape`, as
    its PartitionSpec entries (the dim's axis name or None), one a dim; []
    for a leaf no dim of which is sharded. A leaf under `min_weight_size`
    elements (the trainer's param_min_shard_size, JAX's default unless a
    plan or the caller sets it), or with fsdp and model both 1, stays
    replicated. Otherwise the last dim
    (a flax kernel's output dim) goes to `model` when the leaf has rank 2
    or more and model divides it; then the largest dim still unsharded
    that fsdp divides goes to `fsdp`, the first of equal ones (a stable
    sort, as JAX's _assign_largest_divisible_dim)."""
    shape = tuple(int(s) for s in shape)
    if (model == 1 and fsdp == 1) or int(np.prod(shape)) < min_weight_size:
        return []
    spec: List[Optional[str]] = [None] * len(shape)
    if model > 1 and len(shape) >= 2 and shape[-1] % model == 0:
        spec[-1] = MODEL_AXIS
    if fsdp > 1:
        for dim in sorted(range(len(shape)), key=lambda i: shape[i], reverse=True):
            if spec[dim] is None and shape[dim] % fsdp == 0:
                spec[dim] = FSDP_AXIS
                break
    return spec if any(axis is not None for axis in spec) else []


def param_dims(name: str, shape: Sequence[int], fsdp: int, model: int,
               min_weight_size: int = MIN_WEIGHT_SIZE) -> Tuple[Optional[int], Optional[int]]:
    """(the dim sharded over model, the dim sharded over fsdp) of the
    state-dict entry `name` of torch `shape`, each None when the leaf is
    whole over that dim: flax_param_spec decides on the entry's flax
    layout (utils/jax_params.flax_dims: a Linear weight [out, in] is the
    flax kernel [in, out], a Conv's OIHW its HWIO), and the dims it picks
    map back to the torch layout. Deciding on the torch shape would split
    another dim: a 3x3x64x64 conv's output channels over fsdp where JAX
    splits its input channels."""
    # Imported here: utils/jax_params imports this module.
    from tensor2robot_tpu_torch.utils.jax_params import flax_dims

    dims = flax_dims(name, len(shape))
    flax_shape = [0] * len(shape)
    for i, j in enumerate(dims):
        flax_shape[j] = int(shape[i])
    spec = flax_param_spec(flax_shape, fsdp, model, min_weight_size)
    if not spec:
        return None, None
    owner = {spec[j]: i for i, j in enumerate(dims) if spec[j] is not None}
    return owner.get(MODEL_AXIS), owner.get(FSDP_AXIS)


def param_sharding(mesh: Optional[DeviceMesh], min_weight_size: int = MIN_WEIGHT_SIZE):
    """The parameter sharding rule of the trainer's sharded_params regime
    (the JAX package's param_sharding, per rank): rule(name, tensor) is
    param_dims of the state-dict entry on this mesh's fsdp and model
    sizes, leaves under `min_weight_size` elements whole (JAX's
    param_min_shard_size), (None, None) for every entry without a mesh.
    Parameters, their gradients, the optimizer's moments and the EMA
    share names and shapes, so one rule places them all
    (parallel/sharded_params.py)."""
    shape = mesh_shape(mesh)
    fsdp, model = shape[FSDP_AXIS], shape[MODEL_AXIS]

    def rule(name: str, tensor) -> Tuple[Optional[int], Optional[int]]:
        return param_dims(name, tuple(tensor.shape), fsdp, model, min_weight_size)

    return rule
