"""The rank side of the composed-regime parity tests
(tests/test_torch_composed_regimes.py).

Each function runs on every rank of a LocalWorld of 4 (or 8) gloo
processes on the CPU and returns numpy arrays for the test to hold
against the JAX package. No JAX here: spawned ranks import this.

A mesh is named by its sizes in the mesh's dim order, (data, fsdp, model,
sequence, pipe, expert).
"""

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.train import durability
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train import train_eval

_MESHES = {}

#: The controls, each a mechanism of the composed step broken on purpose:
#: zero2's slice summed over the data ranks alone (the other sequence
#: ranks' tokens dropped), sharded_params' whole leaves averaged over data
#: x fsdp alone (which drops the other sequence ranks' tokens), and the
#: stage entries left un-averaged over their stage's ranks.
CONTROLS = ("slice_over_data", "whole_over_data_fsdp", "stages_unaveraged")


def mesh(shape):
    """This rank's mesh of `shape` (data, fsdp, model, sequence, pipe,
    expert), made once per rank process."""
    shape = tuple(shape)
    if shape not in _MESHES:
        _MESHES[shape] = mesh_lib.make_mesh(**dict(zip(mesh_lib.AXES, shape)))
    return _MESHES[shape]


def _numpy(tensors: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


def _struct(batch: dict):
    return TensorSpecStruct({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})


def bc_model(model_kwargs: dict, m, clip=None, use_ema: bool = False):
    """Small BC on the CPU (the kernels' plain versions) built with the
    mesh `m` (pipelined over its pipe dim where that is above 1), Adam,
    clipped to global norm `clip` when given."""
    from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel

    create = None
    if clip is not None:
        create = lambda: optimizers.with_gradient_clipping(  # noqa: E731
            optimizers.create_adam_optimizer(), max_global_norm=clip)
    pipes = mesh_lib.axis_size(m, mesh_lib.PIPE_AXIS)
    extra = dict(pipeline_stages=pipes) if pipes > 1 else {}
    return TransformerBCModel(device_type="cpu", create_optimizer_fn=create, mesh=m,
                              use_avg_model_params=use_ema, avg_model_params_decay=0.9,
                              **extra, **model_kwargs)


def _data_only_scatter(x, m, axis_name, scatter_dimension=0):
    """psum_scatter over the replica group with the sum taken over the
    data ranks alone: this rank's chunk of a sum that misses the other
    sequence ranks' terms."""
    _, size, index = mesh_lib.dims_group(m, axis_name)
    summed = collectives.psum(x, m, mesh_lib.DATA_AXIS)
    return summed.chunk(size, dim=scatter_dimension)[index]


@contextlib.contextmanager
def _control(name, trainer):
    """The control `name` (CONTROLS) in force inside; nothing for None."""
    saved_scatter, saved_stage = collectives.psum_scatter, mesh_lib.stage_group
    if name == "slice_over_data":
        collectives.psum_scatter = _data_only_scatter
    elif name == "whole_over_data_fsdp":
        trainer.mean_axes = (mesh_lib.DATA_AXIS, mesh_lib.FSDP_AXIS)
    elif name == "stages_unaveraged":
        mesh_lib.stage_group = lambda m: (None, 1)
    elif name is not None:
        raise ValueError(f"unknown control {name!r}")
    try:
        yield
    finally:
        collectives.psum_scatter, mesh_lib.stage_group = saved_scatter, saved_stage


def _moments(trainer, state, saved) -> dict:
    """{name: (exp_avg, exp_avg_sq)} of a checkpoint_state, whole (stage
    entries stacked)."""
    names = [n for n, _ in state.network.named_parameters()]
    return {names[i]: (e["exp_avg"].numpy().copy(), e["exp_avg_sq"].numpy().copy())
            for i, e in saved["optimizer"]["state"].items()}


def _bytes(state) -> tuple:
    """This rank's parameter bytes and Adam-moment bytes."""
    params = sum(p.numel() * p.element_size() for p in state.network.parameters())
    moments = sum(t.numel() * t.element_size()
                  for entry in state.optimizer.state_dict()["state"].values()
                  for t in entry.values() if t.ndim)
    return params, moments


def step(shape, model_kwargs: dict, weights: dict, batch: dict, kwargs=None,
         control=None, clip=None, steps: int = 1) -> dict:
    """`steps` train steps of small BC on the mesh `shape` from `weights`
    on this rank's shard of `batch`, with the trainer's `kwargs` and the
    control `control` (CONTROLS) in force. Returns the losses, the
    regime, the parameters and Adam moments after the steps (gathered
    whole, stage entries stacked), this rank's parameter and moment bytes
    and the clip factor."""
    m = mesh(shape)
    trainer = train_eval.Trainer(bc_model(model_kwargs, m, clip), device="cpu", mesh=m,
                                 **(kwargs or {}))
    state = trainer.init_state(params={k: torch.from_numpy(v) for k, v in weights.items()})
    local = _struct(mesh_lib.shard_batch(batch, m))
    losses = []
    with _control(control, trainer):
        for _ in range(steps):
            losses.append(float(trainer.train_step(state, local)["loss"]))
    param_bytes, opt_bytes = _bytes(state)
    saved = trainer.checkpoint_state(state)
    scale = state.optimizer.clip_scale
    return dict(losses=losses, loss=losses[0], regime=trainer.regime,
                params=_numpy(saved["params"]), moments=_moments(trainer, state, saved),
                param_bytes=param_bytes, opt_bytes=opt_bytes,
                clip_scale=None if scale is None else float(scale))


def resume_elsewhere(model_kwargs: dict, weights: dict, batch: dict, model_dir: str) -> dict:
    """Two EMA steps in zero2 on 2 data x 2 sequence over ("data",
    "sequence"), the checkpoint rank 0 writes (the replicated layout), and
    that checkpoint restored in sharded_params on 2 fsdp x 2 sequence: the
    restored state gathered whole (parameters, moments, EMA) and this
    rank's shard shapes, for the test to hold bit for bit."""
    first = mesh((2, 1, 1, 2, 1, 1))
    trainer = train_eval.Trainer(bc_model(model_kwargs, first, use_ema=True), device="cpu",
                                 mesh=first, shard_weight_update=True,
                                 weight_update_axes=(mesh_lib.DATA_AXIS,
                                                     mesh_lib.SEQUENCE_AXIS))
    state = trainer.init_state(params={k: torch.from_numpy(v) for k, v in weights.items()})
    local = _struct(mesh_lib.shard_batch(batch, first))
    for _ in range(2):
        trainer.train_step(state, local)
    saved = trainer.checkpoint_state(state)
    if dist.get_rank() == 0:
        state_lib.save_checkpoint(model_dir, saved["step"], saved["params"],
                                  saved["ema_params"], saved["optimizer"])
        durability.publish_durable(model_dir, saved["step"])
    dist.barrier()
    other = mesh((1, 2, 1, 2, 1, 1))
    fresh = train_eval.Trainer(bc_model(model_kwargs, other, use_ema=True), device="cpu",
                               mesh=other)
    restored = train_eval.restore_or_init_state(model_dir, fresh)
    again = fresh.checkpoint_state(restored)
    return dict(step=restored.step, regimes=(trainer.regime, fresh.regime),
                layout=dict(fresh.param_layout), params=_numpy(again["params"]),
                ema=_numpy(again["ema_params"]), moments=_moments(fresh, restored, again),
                shard_shapes={n: tuple(p.shape) for n, p in restored.network.named_parameters()})


def flat_pipe_checkpoint(model_kwargs: dict, weights: dict, batch: dict) -> dict:
    """The flat update on 2 data x 2 pipe with an EMA: two steps, its
    checkpoint_state (one entry a parameter, stage entries stacked), that
    checkpoint restored by a fresh flat trainer on the mesh and by the
    per-leaf trainer on it, each gathered again."""
    m = mesh((2, 1, 1, 1, 2, 1))
    local = _struct(mesh_lib.shard_batch(batch, m))
    out = {}
    trainer = train_eval.Trainer(bc_model(model_kwargs, m, use_ema=True), device="cpu",
                                 mesh=m, flatten_optimizer_update=True)
    state = trainer.init_state(params={k: torch.from_numpy(v) for k, v in weights.items()})
    for _ in range(2):
        trainer.train_step(state, local)
    saved = trainer.checkpoint_state(state)
    out["saved"] = dict(params=_numpy(saved["params"]), ema=_numpy(saved["ema_params"]),
                        moments=_moments(trainer, state, saved),
                        ema_names="ema_names" in saved)
    for flat in (True, False):
        fresh = train_eval.Trainer(bc_model(model_kwargs, m, use_ema=True), device="cpu",
                                   mesh=m, flatten_optimizer_update=flat)
        restored = fresh.init_state()
        restored.restore(fresh.local_checkpoint(saved, restored.network))
        again = fresh.checkpoint_state(restored)
        out["flat" if flat else "leaf"] = dict(
            params=_numpy(again["params"]), ema=_numpy(again["ema_params"]),
            moments=_moments(fresh, restored, again))
    return out
