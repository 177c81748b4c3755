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

The parameter sharding rules (param_sharding, weight_update_sharding,
pipe_stage_param_rule) are not ported: they raise naming ROADMAP.md A9.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Tuple

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


def check_ported_dims(mesh: Optional[DeviceMesh]) -> Dict[str, int]:
    """mesh_shape(mesh), after refusing the dims not ported yet: a model,
    pipe or expert dim above 1 (tensor, pipeline or expert parallelism)
    raises NotImplementedError naming ROADMAP.md A9."""
    shape = mesh_shape(mesh)
    wide = [axis for axis in (MODEL_AXIS, PIPE_AXIS, EXPERT_AXIS) if shape[axis] > 1]
    if wide:
        raise NotImplementedError(
            f"a mesh with {wide} above 1 (tensor, pipeline or expert "
            "parallelism) is not ported yet (ROADMAP.md A9)"
        )
    return shape


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    return mesh_shape(mesh)[axis]


def data_shard(mesh: DeviceMesh) -> Tuple[int, int]:
    """(this rank's index, the count) of the batch shards: data x fsdp,
    fsdp varying fastest."""
    shape = mesh_shape(mesh)
    index = (mesh.get_local_rank(DATA_AXIS) * shape[FSDP_AXIS]
             + mesh.get_local_rank(FSDP_AXIS))
    return index, shape[DATA_AXIS] * shape[FSDP_AXIS]


def shard_batch(batch, mesh: DeviceMesh):
    """This rank's slice of a host batch: the leading axis split over
    data x fsdp (ranks on the same data and fsdp index get the same
    slice). A leaf whose leading dim does not divide (small predict
    batches, scalars) is kept whole, as the JAX package replicates it.
    Works on any mapping of numpy arrays or tensors; returns the same
    mapping type."""
    index, divisor = data_shard(mesh)
    out = type(batch)()
    for key, leaf in batch.items():
        leaf_shape = getattr(leaf, "shape", ())
        if len(leaf_shape) >= 1 and leaf_shape[0] % divisor == 0:
            size = leaf_shape[0] // divisor
            out[key] = leaf[index * size:(index + 1) * size]
        else:
            out[key] = leaf
    return out


def _unported(name: str):
    def rule(*args, **kwargs):
        raise NotImplementedError(
            f"{name} (parameter and optimizer-state sharding) is not ported "
            "yet (ROADMAP.md A9)"
        )
    rule.__name__ = name
    return rule


param_sharding = _unported("param_sharding")
weight_update_sharding = _unported("weight_update_sharding")
pipe_stage_param_rule = _unported("pipe_stage_param_rule")
