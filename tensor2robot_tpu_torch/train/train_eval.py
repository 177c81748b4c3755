"""The trainer: train, evaluate, checkpoint and predict a T2RModel.

Port of tensor2robot_tpu/train/train_eval.py. `Trainer` is
the counterpart of the JAX package's CompiledModel: the model's hooks as
train, eval and predict steps over a TrainState, in the same order
(preprocess, packed inference, model_train_fn, backward, optimizer, EMA).
Each train step preprocesses with its own generator on the device,
seeded from (seed, step) as the JAX step folds the step into its key, so
random crops and distortions differ per step and repeat on a resume; a
second generator of the step is the network's (JAX's rng_net: sampled
actions), handed to networks whose forward takes `generator`.
Batch-norm running statistics are buffers of the network: they change in
a train-mode forward, ride in the checkpoint's `params`, and are not
averaged (the EMA covers parameters only, as the JAX export_variables).
PyTorch runs eagerly, so nothing is compiled; on the card the transformer's
attention runs the flash kernels (B1 forward and B3+B4 backward under
autograd, B2 under inference_mode in eval and predict).

The memory regimes, as the JAX CompiledModel has them:
  * remat: the network's marked segments (layers/remat.py: the BC
    embed in slices of frames and each transformer block, the Grasping44
    tower's conv stages) run under torch.utils.checkpoint
    (non-reentrant), so the backward recomputes one segment's
    activations at a time (B1 runs again in each block's recompute). A
    network that marks none trains as without remat. Preprocessing stays
    outside, once per step: the checkpoint restores only the default
    generators, and the step's own generator would draw another crop in a
    recompute.
  * grad_accum_steps = K: the preprocessed batch is split into K
    microbatches, each backward adds 1/K of its gradient, and the metrics
    are recombined by key (`golden/` and `per_example/` concatenate, other
    floats average, integers sum). Every microbatch sees the step-start
    batch-norm statistics and the last one's update is kept, as in JAX.
    The buffers are restored around every extra forward (the next
    microbatch, the recompute), so they never move twice.
  * iterations_per_loop = K (train_eval_model): K train steps per loop
    with no host sync between them; loops end at checkpoint steps, and
    hooks see the loop's first step (before_step) and last (after_step).
    Batches stream from device_prefetch one by one, as at K = 1: PyTorch
    launches each step from the host anyway, so a stacked [K, B, ...]
    copy would only add host work.

`train_eval_model` is the entry point: it wraps a model whose device_type
is "tpu" in the bf16 policy (maybe_wrap_for_tpu), prints the specs,
writes `operative_config.gin` at start and at exit, quarantines torn
checkpoints (train/durability.py) and resumes from the newest durable one
under `<model_dir>/checkpoints/` (skipping the batches the restored steps
consumed), logs scalars to `<model_dir>/train/metrics.jsonl`, checkpoints
every `save_checkpoints_steps` with a durability manifest, and evaluates
each named eval set into `<model_dir>/eval[_<name>]/metrics.jsonl`. With
`create_exporters_fn`, each exporter it returns (export/exporters.py) is
asked to export after every eval, with that eval's metrics, under
`<model_dir>/export/<name>/`. Hooks (hooks/hook_builder.py) are called in
the JAX package's order.

The mesh (parallel/mesh.py: data x fsdp x model x sequence x pipe x
expert; one process per rank, each running this trainer on its own
shard): every rank feeds its slice of the batch (infeed.shard_batches),
the network runs sequence-parallel and with its resident experts where
the model was built with the same mesh, and after the backward every
gradient, with the step's scalar metrics, is averaged over all ranks in
ONE flat all_reduce (the pmean over the mesh that turns the ranks'
gradients into the single-device gradient of the global batch;
layers/transformer.py and ops/moe.py have the rule). Outside the
sharded_params regime parameters stay replicated, so every rank's
optimizer takes the same step; in every regime but the quantized one the
checkpoint has the single-device layout. Eval totals are averaged over the ranks the same way. Rank 0
alone writes checkpoints, manifests, metrics.jsonl and
operative_config.gin, and alone builds and runs the exporters and hooks,
over the model without its mesh (an export serves on one card); the
others wait at a barrier, and a resume reads the same durable checkpoint
on every rank.

Over more than one data x fsdp shard the step keeps the global batch's
semantics, as the JAX trainer's default step does by jitting over sharded
arrays: the network's batch norms take their train-mode moments over
every shard (layers/batch_norm.py; their running statistics stay equal on
every rank), and with grad_accum_steps = K rank r's shard holds its share
of each global microbatch, so microbatch i's statistics are the global
microbatch's. Random draws follow JAX's manual step instead
(`train_eval.py` quant_train_step, which folds the shard index into
rng_pre and rng_net): each data x fsdp shard draws from its own
`step_generator` stream, and one shard's stream is the single-device one.
A draw of one value for the whole batch, such as VRGripper's mixup
weight, is therefore one value per shard, where JAX's default step draws
one for the global batch. Sequence and expert ranks share their batch and
their draws.

Over a pipe dim above 1 (a model pipelined over it, layers/transformer.py)
each pipe rank holds one stage's blocks, and with them their optimizer
moments and EMA: the entries `mesh.pipe_stage_param_rule` names
stage-local. The bucket averages a stage-local gradient only over the
ranks that share the rank's pipe coordinate (`mesh.stage_group`; each
holds its stage's whole gradient) and every other over all ranks (every
pipe rank holds the same whole gradient: parallel/pipeline.py). The
checkpoint stacks the stage-local entries over the pipe ranks ([S, ...],
the JAX tree's `pipe_stages` layout; `Trainer.checkpoint_state`, a
collective) and a resume gives each rank its stage back
(`Trainer.local_checkpoint`). Rank 0's exporters and hooks see the
single-device twin holding the whole chain (`Trainer.export_view`). Eval
runs over the pipe mesh. Clipping by a global norm sums the stages'
squared norms over the pipe ranks.

The weight-update regimes, resolved as the JAX package's
ShardingPlan.regime() resolves them (quant_zero2 where a codec engages,
else sharded_params over an fsdp or model dim above 1, else zero2 with
shard_weight_update over a replica group above 1, else replicated). Each
composes with the sequence, pipe and expert dims; over a pipe dim the
stage rule wins, as in JAX's `place`: a stage entry, its moments and its
EMA are whole on every rank of their stage, whatever the regime's rule.
  * sharded_params (an fsdp or model dim above 1, whatever
    shard_weight_update and the codec say, as in JAX): the network's
    parameters outside a pipeline's stages become this rank's shards as
    mesh.param_sharding lays them out (parallel/sharded_params.py: ZeRO-3
    over fsdp, the Megatron column split over model, gathered on use),
    and the optimizer, its moments and the EMA hold and step the shards
    only. The step sums a leaf cut over fsdp over the data, sequence,
    pipe and expert ranks (its gather's backward already summed it over
    fsdp) and averages the whole leaves over every dim but model
    (`Trainer.mean_axes`); nothing is averaged over model, whose ranks
    hold the same batch. Rank 0 writes the replicated layout (every shard
    gathered) and a resume cuts it again, on any mesh or one device. A
    network that takes its parameters functionally (MAML) gathers its
    shards whole before its inner loop (sharded_params.gathered_parameters).
  * flatten_optimizer_update (optax.flatten): the optimizer steps one
    flat vector of the parameters, which are views of it
    (models/optimizers.FlatParameters), and the EMA is stored flat
    (train/state.py unravels it for eval, export and readers). Over a
    pipe dim the vector holds the rank's stage entries and the shared
    ones, and the checkpoint holds them one a parameter, stacked over
    pipe like the per-leaf step's. The batch norms' running statistics
    update in place, as in every other regime: JAX's
    fuse_batch_stats_update computes the same numbers in one pass to
    save small device copies on a TPU, and is not ported. Refused with an
    fsdp or model dim above 1 and with shard_weight_update (ValueError,
    JAX's).
  * zero2 (shard_weight_update where the product of the
    weight_update_axes dims, ("data",) by default, is above 1; the codec
    "none" or off a pure data mesh): each rank of the replica group (the
    ranks that differ only along those dims) keeps the optimizer moments
    and the EMA of its slice of every leaf mesh.weight_update_sharding
    shards over the group (a stage entry stays whole), and the step
    reduce-scatters those leaves' gradients over the group, sums the
    slice over the other dims' ranks, steps the optimizer on the slices,
    all-gathers them, and all-reduces the rest as the replicated step
    does: the replicated step's arithmetic. Rank 0 writes the replicated
    trainer's checkpoint (moments and EMA gathered), and a resume cuts it
    again, so the layouts interchange.
  * quant_zero2 (shard_weight_update on a pure data mesh, data above 1,
    and collective_quant, or T2R_COLLECTIVE_QUANT, other than "none"):
    JAX's quant_train_step, the flat block-padded parameter vector
    sharded over the data ranks and the gradient and update exchanged
    through a block-scaled codec (parallel/collectives.py) with
    error-feedback residuals carried in the state. As in JAX the batch
    norms are local in this regime: each rank's train-mode moments are its
    shard's (the norms are not synchronized) and their running statistics
    are averaged over the data ranks after the step, the local-BN caveat.
    The checkpoint holds the flat optimizer state, the flat EMA and both
    residuals gathered in data-rank order; like JAX's, it does not
    interchange with the tree layout. The flag is inert outside a pure
    data mesh with shard_weight_update, as in JAX. The port ravels in
    named_parameters order and torch layouts where JAX ravels flax's tree,
    so block boundaries differ and a quantized step agrees with JAX's
    within the quantization's tolerance, not bit for bit.
Clipping by a global norm sees the global gradient in every regime but
the quantized one, as optax's under GSPMD: where the optimizer steps
shards (a sharded_params shard, a zero2 slice, a pipe stage's entries,
the stage runs of the flat vector) each squared norm is summed over the
mesh dims that cut it, once (models/optimizers.py's global_norm_squared).
With quantized collectives it is refused, as JAX refuses it there.

A plan (parallel/planner.py's ShardingPlan; `Trainer(plan=...)`, or
`train_eval_model` under T2R_PLAN) is the single source of the mesh and
the regime, as for the JAX CompiledModel: the mesh comes from
plan.build_mesh() where none is given (one that disagrees with the plan
raises), the model must be built to match it (its mesh's dims and its
pipeline stages), shard_weight_update, weight_update_axes, the codec and
param_min_shard_size come from the plan (the env flags are not read),
and init_state's placement is audited entry by entry against the plan's
prediction (planner.audit_state_layout): a mismatch raises. Without a plan
the trainer distills one from its arguments (`layout`), whose regime()
is the regime, as JAX's CompiledModel does.
"""

from __future__ import annotations

import hashlib
import itertools
import logging
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn

from tensor2robot_tpu_torch import config as config_lib
from tensor2robot_tpu_torch import flags
from tensor2robot_tpu_torch.export.saved_model import TRACE_LOCK
from tensor2robot_tpu_torch.layers import batch_norm as batch_norm_lib
from tensor2robot_tpu_torch.layers import remat as remat_lib
from tensor2robot_tpu_torch.hooks.hook_builder import Hook, HookContext
from tensor2robot_tpu_torch.models.abstract_model import (
    MODE_EVAL,
    MODE_PREDICT,
    MODE_TRAIN,
)
from tensor2robot_tpu_torch.models.optimizers import FlatParameters
from tensor2robot_tpu_torch.models.tpu_model_wrapper import BFloat16ModelWrapper
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.parallel import pipeline as pipeline_lib
from tensor2robot_tpu_torch.parallel import planner as planner_lib
from tensor2robot_tpu_torch.parallel import sharded_params
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.train import durability, infeed
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train.metrics import (
    BATCH_CARRYING_METRIC_PREFIXES,
    MetricsWriter,
    collective_record,
)
from tensor2robot_tpu_torch.train.state import TrainState, init_ema, update_ema
from tensor2robot_tpu_torch.utils.device import (
    DEFAULT_DEVICE,
    rank_device,
    resolve_device,
)


def _resolve_layout(mesh, shard_weight_update: bool, flatten_optimizer_update: bool,
                    collective_quant: Optional[str], collective_block: Optional[int],
                    weight_update_axes: Sequence[str], param_min_shard_size: int,
                    name: str = "adhoc") -> tuple:
    """(the plan this trainer runs, the quantized collective or None), as
    the JAX CompiledModel distills its `_layout`: a ShardingPlan of the
    mesh's dims and the resolved arguments, whose regime() is the
    trainer's regime (quant_zero2 where a codec engages, which is only
    with shard_weight_update on a pure data mesh whose data dim is above
    1; else sharded_params over an fsdp or model dim above 1; else zero2
    with shard_weight_update where the product of the weight_update_axes
    dims is above 1; else replicated), after the flat update's refusal
    (JAX's ValueError)."""
    shape = mesh_lib.mesh_shape(mesh)
    unknown = [axis for axis in weight_update_axes if axis not in mesh_lib.AXES]
    if unknown:
        raise ValueError(f"weight_update_axes {tuple(weight_update_axes)} name no mesh "
                         f"dims {unknown}; the dims are {mesh_lib.AXES}")
    sharding = shape[mesh_lib.FSDP_AXIS] > 1 or shape[mesh_lib.MODEL_AXIS] > 1
    if flatten_optimizer_update and (sharding or shard_weight_update):
        raise ValueError(
            "flatten_optimizer_update concatenates all parameters into one "
            "replicated vector, which defeats fsdp/tensor-parallel parameter "
            "sharding and ZeRO-2 weight-update sharding; use it only in "
            "replicated-parameter regimes.")
    quant = collective_quant if collective_quant is not None else flags.get_enum(
        "T2R_COLLECTIVE_QUANT")
    block = collective_block if collective_block is not None else flags.get_int(
        "T2R_COLLECTIVE_BLOCK")
    pure_data = all(shape[axis] == 1 for axis in mesh_lib.complement((mesh_lib.DATA_AXIS,)))
    collective = None
    if (quant != "none" and shard_weight_update and pure_data
            and shape[mesh_lib.DATA_AXIS] > 1):
        collective = collectives.get_collective(quant, block)
    layout = planner_lib.ShardingPlan(
        name=name, **shape, shard_weight_update=bool(shard_weight_update),
        weight_update_axes=tuple(weight_update_axes),
        collective_quant="none" if collective is None else collective.name,
        collective_block=block if collective is None else collective.block,
        param_min_shard_size=int(param_min_shard_size))
    return layout, collective


def _check_trainer_mesh(model, shape: Dict[str, int], plan=None) -> None:
    """The trainer's mesh regimes on its dims `shape`: a model built with
    a mesh of the same sequence, pipe and expert sizes (1 without one;
    the JAX trainer's _validate_model_matches_plan: a mismatch would train
    silently without sequence or expert parallelism or pipelining, or run
    the model's collectives with no gradient reduction), and of the same
    data x fsdp sizes where its loss spans the batch (else each shard
    would take its own negatives); with a plan over a pipe dim, a model
    built with the plan's pipeline stages (a plan cannot retrofit stages
    onto a built model)."""
    candidates = [model, getattr(model, "_model", None)]
    model_mesh = next((getattr(m, "_mesh") for m in candidates
                       if getattr(m, "_mesh", None) is not None), None)
    axes = [(mesh_lib.SEQUENCE_AXIS, "attention runs sequence-parallel"),
            (mesh_lib.PIPE_AXIS, "its stages run as one pipeline"),
            (mesh_lib.EXPERT_AXIS, "each rank runs its resident experts")]
    if any(getattr(m, "loss_spans_the_batch", False) for m in candidates if m is not None):
        axes += [(axis, "its loss gathers every shard's examples")
                 for axis in (mesh_lib.DATA_AXIS, mesh_lib.FSDP_AXIS)]
    for axis, what in axes:
        got, want = mesh_lib.axis_size(model_mesh, axis), shape[axis]
        if got != want:
            raise ValueError(
                f"the trainer's mesh shards the {axis} {want}-way but the "
                f"model's mesh carries {axis} axis {got}; construct the model "
                f"with the trainer's mesh so {what}"
            )
    if plan is not None and plan.pipe > 1:
        stages = planner_lib.pipeline_stages(model)
        if stages != plan.pipe:
            raise ValueError(
                f"plan {plan.name!r} runs {plan.pipe} pipeline stages but "
                f"the model was built with pipeline_stages={stages}; "
                "construct the model with plan.model_kwargs() (and the "
                "plan's mesh)"
            )


def maybe_wrap_for_tpu(model):
    """The bf16 policy for a model whose device_type is "tpu", as the JAX
    trainer wraps it in TPUT2RModelWrapper."""
    if model.is_device_tpu and not isinstance(model, BFloat16ModelWrapper):
        return BFloat16ModelWrapper(model)
    return model


def print_specification(model) -> None:
    """The startup spec dump."""
    for mode in (MODE_TRAIN, MODE_EVAL):
        print(f"*** Specifications for mode={mode} ***")
        for name, spec_fn in (
            ("features", model.get_feature_specification),
            ("labels", model.get_label_specification),
        ):
            for key, spec in spec_fn(mode).items():
                print(f"  {name}/{key}: {spec}")


def _batch_labels(batch):
    """The batch's labels subtree, or None for label-less models."""
    try:
        return batch["labels"]
    except KeyError:
        return None


def step_generator(seed: int, step: int, device, stream: str = "pre",
                   shard: int = 0, shards: int = 1,
                   microbatch: Optional[int] = None) -> torch.Generator:
    """A generator of train step `step`, on `device`, seeded from (seed,
    step, stream) alone, as the JAX trainer draws step `step`'s keys from
    fold_in(rng, step): stream "pre" is the preprocessing's (rng_pre:
    random crops, distortions), "net" the network's (rng_net: sampled
    actions). A resumed run draws what the uninterrupted run drew at the
    same step. Over `shards` > 1 data x fsdp shards the shard index is
    folded in, and a microbatch index of grad accumulation likewise (JAX's
    fold_in(rng_net, index)); one shard, no microbatch, is the
    single-device stream."""
    key = f"{seed}:{step}:{stream}"
    if shards > 1:
        key += f":shard{shard}"
    if microbatch is not None:
        key += f":micro{microbatch}"
    digest = hashlib.blake2b(key.encode(), digest_size=8)
    generator = torch.Generator(device=device)
    generator.manual_seed(int.from_bytes(digest.digest(), "little"))
    return generator


def microbatch(tree, index: int, count: int):
    """Microbatch `index` of `count` of every leaf of `tree` (None passes):
    leaves whose leading dim `count` divides are sliced; 0-d and
    unit-leading leaves go whole into every microbatch; any other leaf is
    a batch that cannot split, and raises."""
    if tree is None:
        return None
    out = TensorSpecStruct()
    for key, leaf in tree.items():
        if leaf.ndim == 0 or leaf.shape[0] == 1:
            out[key] = leaf
            continue
        if leaf.shape[0] % count:
            raise ValueError(
                f"Leaf {key!r} batch {leaf.shape[0]} not divisible by "
                f"grad_accum_steps={count}"
            )
        size = leaf.shape[0] // count
        out[key] = leaf.narrow(0, index * size, size)
    return out


def combine_microbatch_metrics(metrics: List[Dict[str, torch.Tensor]]):
    """Per-microbatch metrics recombined by KEY, not shape (a fixed-size
    vector metric could coincide with B/K): keys under the `golden/` or
    `per_example/` prefixes concatenate back to the full batch; other
    floats average (the mean of per-microbatch means is the full-batch
    mean), integer counts sum."""
    out = {}
    for key in metrics[0]:
        stacked = torch.stack([m[key] for m in metrics])
        if key.startswith(BATCH_CARRYING_METRIC_PREFIXES) and stacked.ndim >= 2:
            out[key] = stacked.reshape((-1,) + tuple(stacked.shape[2:]))
        elif stacked.is_floating_point():
            out[key] = stacked.mean(dim=0)
        else:
            out[key] = stacked.sum(dim=0)
    return out


def _restore_buffers(buffers, values) -> None:
    with torch.no_grad():
        for buffer, value in zip(buffers, values):
            buffer.copy_(value)


class Trainer:
    """The model's hooks as steps over a TrainState on one device, or on
    this rank's device of a mesh (module docstring). Train steps
    preprocess with `step_generator(seed, step)`; `remat` and
    `grad_accum_steps` are the memory regimes; shard_weight_update,
    weight_update_axes, flatten_optimizer_update, collective_quant and
    collective_block are the JAX CompiledModel's weight-update regimes
    (module docstring). The zero2 regime shards, over the product of the
    weight_update_axes dims (None: ("data",)), the leaves
    mesh.weight_update_sharding shards, and sharded_params the leaves
    mesh.param_sharding shards, those of param_min_shard_size elements or
    more (JAX's, mesh.MIN_WEIGHT_SIZE by default) outside a pipeline's
    stages. `plan` (a planner.ShardingPlan) sets the mesh where none is
    given and the regime's arguments, and audits init_state's placement
    (module docstring)."""

    def __init__(
        self,
        model,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
        seed: int = 0,
        mesh=None,
        plan: Optional[planner_lib.ShardingPlan] = None,
        remat: bool = False,
        grad_accum_steps: int = 1,
        shard_weight_update: bool = False,
        flatten_optimizer_update: bool = False,
        collective_quant: Optional[str] = None,
        collective_block: Optional[int] = None,
        weight_update_axes: Optional[Sequence[str]] = None,
        param_min_shard_size: int = mesh_lib.MIN_WEIGHT_SIZE,
    ):
        if int(grad_accum_steps) < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
        if plan is not None:
            if not isinstance(plan, planner_lib.ShardingPlan):
                raise TypeError("plan must be a parallel.planner.ShardingPlan, got "
                                f"{type(plan).__name__}")
            if mesh is None:
                mesh = plan.build_mesh()
            elif not plan.matches_mesh(mesh):
                raise ValueError(f"mesh axes {mesh_lib.mesh_shape(mesh)} disagree with plan "
                                 f"{plan.name!r} axes {plan.axes_dict()}")
            shard_weight_update = plan.shard_weight_update
            weight_update_axes = plan.weight_update_axes
            collective_quant = plan.collective_quant
            collective_block = plan.collective_block
            param_min_shard_size = plan.param_min_shard_size
        _check_trainer_mesh(model, mesh_lib.mesh_shape(mesh), plan)
        self.plan = plan
        self.weight_update_axes = tuple(
            (mesh_lib.DATA_AXIS,) if weight_update_axes is None else weight_update_axes)
        self.param_min_shard_size = int(param_min_shard_size)
        # The plan this trainer runs (the given one's name), whose regime
        # is the trainer's.
        self.layout, self.collective = _resolve_layout(
            mesh, shard_weight_update, flatten_optimizer_update, collective_quant,
            collective_block, self.weight_update_axes, self.param_min_shard_size,
            name="adhoc" if plan is None else plan.name)
        self.regime = self.layout.regime()
        self.flatten_optimizer_update = bool(flatten_optimizer_update)
        # zero2's rule (name, tensor) -> the dim sliced over the replica
        # group (decided on the flax layout), or PIPE_AXIS for a stage
        # entry (whole on its stage).
        wu_rule = mesh_lib.weight_update_sharding(mesh, self.param_min_shard_size,
                                                  axes=self.weight_update_axes)
        self.weight_update_rule = mesh_lib.pipe_stage_param_rule(mesh, lambda name, tensor:
                                                                 wu_rule(tensor, name))
        # The dims over whose ranks a whole leaf's gradient (outside a
        # pipeline's stages) and the metrics are averaged: every dim but
        # model in the sharded_params regime (model ranks hold the same
        # batch, and equal gradients), else every dim.
        self.mean_axes = (mesh_lib.complement((mesh_lib.MODEL_AXIS,))
                          if self.regime == "sharded_params" else mesh_lib.AXES)
        # The sharded_params regime's layout ({name: (model dim, fsdp
        # dim)}), set by init_state.
        self.param_layout: sharded_params.Layout = {}
        # The quantized regime's layout, set by init_state.
        self._flat_layout: Optional[collectives.FlatShardLayout] = None
        self.model = model
        self.mesh = mesh
        # Ranks of the mesh, all of the world (make_mesh covers it).
        self.ranks = 1 if mesh is None else dist.get_world_size()
        self.shard, self.data_shards = (
            (0, 1) if mesh is None else mesh_lib.data_shard(mesh))
        self.pipes = mesh_lib.axis_size(mesh, mesh_lib.PIPE_AXIS)
        # Which state entries are this rank's stage's (pipe dim above 1).
        self.stage_local = mesh_lib.pipe_stage_param_rule(mesh)
        if mesh is not None:
            # The groups the steps reduce over, made here on every rank
            # together (dist.new_group).
            groups = [(mesh_lib.DATA_AXIS, mesh_lib.FSDP_AXIS), self.mean_axes,
                      mesh_lib.complement((mesh_lib.PIPE_AXIS,))]
            if self.regime == "sharded_params":
                groups.append(mesh_lib.complement((mesh_lib.MODEL_AXIS, mesh_lib.FSDP_AXIS)))
            if self.regime == "zero2":
                groups += [self.weight_update_axes,
                           mesh_lib.complement(self.weight_update_axes)]
            for axes in groups:
                mesh_lib.dims_group(mesh, axes)
        self._twin_network: Optional[torch.nn.Module] = None
        self.is_chief = mesh is None or dist.get_rank() == 0
        self.device = resolve_device(device) if mesh is None else rank_device(device)
        self.seed = seed
        self.remat = bool(remat)
        self.grad_accum_steps = int(grad_accum_steps)
        self.preprocessor = model.preprocessor
        self.optimizer_factory = model.create_optimizer()
        self._ema_network: Optional[torch.nn.Module] = None

    def init_state(
        self,
        generator: Optional[torch.Generator] = None,
        params: Optional[Dict[str, torch.Tensor]] = None,
    ) -> TrainState:
        """A fresh TrainState: weights drawn from `generator` (seed 0 when
        None) and passed through the model's warm start
        (maybe_init_from_checkpoint), or the given state dict (e.g.
        converted flax params)."""
        if params is None:
            network = self.model.init_network(generator, self.device)
            fresh = dict(network.state_dict())
            warm = self.model.maybe_init_from_checkpoint(fresh)
            if warm is not fresh:
                network.load_state_dict(warm)
        else:
            network = self.model.create_network()
            network.load_state_dict(params)
            network = network.to(self.device)
        # The quantized regime's batch norms are local (module docstring).
        batch_norm_lib.synchronize(
            network, None if self.regime == "quant_zero2" else self.mesh)
        update = None
        if self.regime == "sharded_params":
            self.param_layout = sharded_params.shard_network(network, self.mesh,
                                                             self.param_min_shard_size)
            update = _ShardedParams(network, self.param_layout, self.mesh)
        elif self.regime == "quant_zero2":
            update = _QuantizedUpdate(network, self.collective, self.mesh)
            self._flat_layout = update.layout
        elif self.regime == "zero2":
            update = _ShardedUpdate(network, self._shard_dims(network), self.mesh,
                                    self.weight_update_axes)
        elif self.flatten_optimizer_update:
            update = _FlatUpdate(network, self.stage_local)
        optimizer = self.optimizer_factory(
            network.parameters() if update is None else update.optimizer_params())
        clipping = getattr(optimizer, "clipping", None)
        if clipping is not None and clipping[0] is not None:
            if self.regime == "quant_zero2":
                raise NotImplementedError(
                    "clipping by a global norm is unsupported with quantized "
                    "collectives, as in the JAX package: the quantized ZeRO-2 step "
                    "updates each rank's shard of the flat parameter vector, and a "
                    "tree-structure-aware transform there sees one shard")
            self._sum_norms_over_shards(
                optimizer, network.named_parameters() if update is None
                else update.named_optimizer_params(),
                update.dims if self.regime == "zero2" else (),
                update.stage_segments() if isinstance(update, _FlatUpdate) else None)
        ema = None
        if self.model.use_avg_model_params:
            ema = init_ema(network) if update is None else update.init_ema()
        state = TrainState(
            step=0, network=network, optimizer=optimizer, ema_params=ema,
            collective_residual=(update.init_residual()
                                 if self.regime == "quant_zero2" else None),
            weight_update=update)
        if self.plan is not None:
            audit = planner_lib.audit_state_layout(self.layout, self.mesh, state)
            if audit["mismatches"]:
                raise RuntimeError(
                    f"plan {self.plan.name!r} layout audit failed on "
                    f"{len(audit['mismatches'])} of {audit['leaves']} entries: "
                    f"{audit['mismatches'][:5]}")
        return state

    def _sum_norms_over_shards(self, optimizer, named, sliced, flat_segments=None) -> None:
        """Points clip_by_global_norm at the global gradient where the
        optimizer steps shards of it: each parameter's squared norm is
        summed over the mesh dims its shards are cut along (a
        sharded_params shard over fsdp and model, a zero2 slice, named
        in `sliced`, over the weight-update dims, a pipe stage's entry
        over pipe), a whole one counts once. The flat update's one vector
        over a pipe dim (`flat_segments`: its stage entries' and its other
        entries' (offset, size) runs) sums its stage runs' squares over
        pipe and counts the rest once."""
        axes_of = {}
        for name, p in named:
            if name in self.param_layout:
                axes_of[id(p)] = tuple(
                    axis for axis, d in zip((mesh_lib.MODEL_AXIS, mesh_lib.FSDP_AXIS),
                                            self.param_layout[name]) if d is not None)
            elif name in sliced:
                axes_of[id(p)] = self.weight_update_axes
            elif self.stage_local(name):
                axes_of[id(p)] = (mesh_lib.PIPE_AXIS,)
        if flat_segments is not None and flat_segments[0]:
            split_id = id(named[0][1])
        elif axes_of:
            split_id = None
        else:
            return
        groups = sorted(set(axes_of.values()) | {()}
                        | ({(mesh_lib.PIPE_AXIS,)} if split_id is not None else set()))
        mesh = self.mesh

        def runs_square(grad, runs):
            return sum((grad[o:o + n].square().sum() for o, n in runs),
                       torch.zeros((), device=grad.device))

        def global_norm_squared(params, squares):
            parts = {axes: [] for axes in groups}
            for p, square in zip(params, squares):
                if id(p) == split_id:
                    parts[(mesh_lib.PIPE_AXIS,)].append(runs_square(p.grad, flat_segments[0]))
                    parts[()].append(runs_square(p.grad, flat_segments[1]))
                else:
                    parts[axes_of.get(id(p), ())].append(square)
            total = None
            for axes in groups:
                part = sum(parts[axes], torch.zeros((), device=self.device))
                part = collectives.psum_dims(part, mesh, axes)
                total = part if total is None else total + part
            return total

        optimizer.global_norm_squared = global_norm_squared

    def _shard_dims(self, network: nn.Module) -> Dict[str, int]:
        """{parameter name: the dim a rank of the replica group keeps a
        slice of} of the zero2 regime (mesh.weight_update_sharding over
        the weight-update dims; a stage entry stays whole)."""
        dims = {}
        for name, p in network.named_parameters():
            dim = self.weight_update_rule(name, p)
            if dim is not None and dim != mesh_lib.PIPE_AXIS:
                dims[name] = dim
        return dims

    @property
    def views_state(self) -> bool:
        """Whether a rank's live state is not the whole model's (a pipe
        stage, a ZeRO-2 rank's EMA shard, the sharded_params regime's
        shards): rank 0's exporters and hooks then see export_view of a
        gathered checkpoint."""
        return self.pipes > 1 or self.regime == "sharded_params" or (
            self.regime in _SHARDED_REGIMES and self.model.use_avg_model_params)

    def collective_log_record(self, measure: bool = True) -> Dict[str, float]:
        """The gradient exchange's bytes a rank a step before and after
        the codec (train.metrics.collective_record) and, with `measure`,
        the median wall time of one exchange (a collective: every rank
        calls it). {} outside the quantized regime, and before its
        init_state."""
        if self.collective is None or self._flat_layout is None:
            return {}
        pre, post = collectives.wire_summary(self.collective, self._flat_layout.padded)
        wall_ms = self.measure_collective_ms() if measure else None
        return collective_record(pre, post, wall_ms)

    def measure_collective_ms(self, repeats: int = 5) -> float:
        """Median wall time in ms of one gradient exchange (the codec's
        reduce-scatter and update all-gather) on a zero payload of the real
        layout, after one untimed exchange; every rank calls it."""
        coll, layout, axis = self.collective, self._flat_layout, mesh_lib.DATA_AXIS
        payload = torch.zeros(layout.padded, device=self.device)

        def exchange():
            reduced, _ = coll.reduce_scatter(layout.rows(payload), self.mesh, axis)
            coll.all_gather_shard(reduced / layout.num_shards, self.mesh, axis)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        exchange()
        times = []
        for _ in range(repeats):
            start = time.perf_counter()
            exchange()
            times.append((time.perf_counter() - start) * 1000.0)
        return sorted(times)[len(times) // 2]

    def preprocess_train(self, batch, generator=None):
        """(features, labels) of a device batch in train mode; random crops
        and distortions draw from `generator` (None: none)."""
        return self.preprocessor.preprocess(
            batch["features"], _batch_labels(batch), mode=MODE_TRAIN,
            generator=generator,
        )

    def step_generator(self, step: int, stream: str = "pre",
                       microbatch: Optional[int] = None) -> torch.Generator:
        """This rank's generator of train step `step` (module
        step_generator with this rank's data x fsdp shard folded in)."""
        return step_generator(self.seed, step, self.device, stream, self.shard,
                              self.data_shards, microbatch)

    def network_loss(self, network, features, labels, generator=None):
        """(loss, train metrics) of preprocessed features: the network and
        the loss; a network that samples draws from `generator`."""
        f, l, outputs, _ = self.model.packed_inference(
            network, features, MODE_TRAIN, labels=labels, generator=generator
        )
        return self.model.model_train_fn(f, l, outputs, MODE_TRAIN)

    def forward_loss(self, network, batch, generator=None):
        """(loss, train metrics) of a device batch in train mode;
        preprocessing draws from `generator` (None: no random crop or
        distortion)."""
        features, labels = self.preprocess_train(batch, generator)
        return self.network_loss(network, features, labels)

    def backward(self, network, features, labels, step: Optional[int] = None):
        """Adds the gradient of the loss on preprocessed (features, labels)
        into the parameters' .grad under this trainer's regimes; returns
        the loss and the train metrics, detached. With `step` the network
        draws from the step's "net" generators (one a microbatch), else
        from none."""
        count = self.grad_accum_steps
        # The state a train-mode forward changes (batch-norm statistics).
        buffers = list(network.buffers()) if count > 1 or self.remat else []
        step_start = [b.clone() for b in buffers] if count > 1 else None
        loss_total, per_micro = None, []
        for index in range(count):
            if count > 1:
                if index:
                    _restore_buffers(buffers, step_start)
                f, l = microbatch(features, index, count), microbatch(labels, index, count)
            else:
                f, l = features, labels
            net_generator = None if step is None else self.step_generator(
                step, "net", index if count > 1 else None)
            with remat_lib.segments(self.remat):
                loss, metrics = self.network_loss(network, f, l, net_generator)
            if self.remat:
                after_forward = [b.clone() for b in buffers]
            (loss / count if count > 1 else loss).backward()
            if self.remat:
                _restore_buffers(buffers, after_forward)
            loss = loss.detach()
            if count == 1:
                loss_total = loss
            else:  # JAX's order: acc + loss / K, from the first microbatch
                loss_total = loss / count if loss_total is None else loss_total + loss / count
            per_micro.append({k: v.detach() for k, v in metrics.items()})
        if count == 1:
            return loss_total, per_micro[0]
        return loss_total, combine_microbatch_metrics(per_micro)

    def train_step(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """One update of `state` in place from a device batch; returns the
        step's metrics as device tensors (no host sync)."""
        state.network.train()
        features, labels = self.preprocess_train(
            batch, self.step_generator(state.step))
        state.network.zero_grad(set_to_none=True)
        state.optimizer.zero_grad(set_to_none=True)
        loss, train_metrics = self.backward(state.network, features, labels,
                                            step=state.step)
        if state.weight_update is not None:
            loss, train_metrics = state.weight_update.step(self, state, loss, train_metrics)
        else:
            if self.ranks > 1:
                loss, train_metrics = self.average_over_ranks(
                    state.network, loss, train_metrics)
            state.optimizer.step()
            if state.ema_params is not None:
                state.ema_params = update_ema(
                    state.ema_params, state.params(),
                    self.model.avg_model_params_decay,
                )
        state.step += 1
        metrics = {"loss": loss}
        metrics.update(train_metrics)
        return metrics

    def single_device(self) -> "Trainer":
        """This trainer over the model without its mesh, on the same
        device: what rank 0 alone exports and runs hooks with, so neither
        issues a collective the other ranks never join."""
        if self.mesh is None:
            return self
        return Trainer(self.model.without_mesh(), device=self.device, seed=self.seed)

    def average_over_ranks(self, network, loss, metrics, skip=()):
        """pmean of each gradient and each scalar float metric over the
        ranks of the `mean_axes` dims (every rank; every rank but the other
        model ranks in the sharded_params regime, whose ranks hold the same
        batch and equal gradients), in one flat all_reduce, and of a
        stage-local gradient over its stage's ranks, in a second one;
        returns the averaged loss and metrics. A parameter without a
        gradient joins as zeros, so every rank's bucket has the same
        layout; the parameters named in `skip` (zero2's sliced leaves,
        sharded_params' leaves cut over fsdp) stay out."""
        named = [(n, p) for n, p in network.named_parameters()
                 if p.requires_grad and n not in skip]
        staged = [p for n, p in named if self.stage_local(n)]
        params = [p for n, p in named if not self.stage_local(n)]

        def grads(ps):
            return [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]

        scalars = [k for k, v in metrics.items()
                   if v.ndim == 0 and v.is_floating_point()]
        values = [loss] + [metrics[k] for k in scalars]
        group, size, _ = mesh_lib.dims_group(self.mesh, self.mean_axes)
        averaged = collectives.all_reduce_mean_flat(grads(params) + values, size, group)
        if staged:
            group, size = mesh_lib.stage_group(self.mesh)
            for p, g in zip(staged, collectives.all_reduce_mean_flat(
                    grads(staged), size, group)):
                p.grad = g
        for p, g in zip(params, averaged):
            p.grad = g
        metrics = dict(metrics)
        metrics.update(zip(scalars, averaged[len(params) + 1:]))
        return averaged[len(params)], metrics

    def reduce_gradients(self, state: TrainState, loss, metrics):
        """A train step's gradient exchange alone, in the replicated and
        sharded_params regimes: every rank's gradients (and the loss and
        scalar metrics) become the global batch's, with no optimizer
        step; returns the averaged loss and metrics. The ZeRO-2 regimes
        exchange gradients inside their step."""
        if self.regime == "sharded_params":
            return state.weight_update.reduce(self, state, loss, metrics)
        if self.regime in _ZERO2_REGIMES:
            raise ValueError(f"the {self.regime} regime exchanges gradients in its step")
        return self.average_over_ranks(state.network, loss, metrics)

    def _stack_stages(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: collectives.stack_over(v, self.mesh, mesh_lib.PIPE_AXIS)
                if self.stage_local(k) else v for k, v in tensors.items()}

    def checkpoint_state(self, state: TrainState, optimizer: bool = True) -> Dict[str, Any]:
        """{step, params, ema_params, optimizer} as the checkpoint holds
        them: the network's state dict, the EMA and the optimizer's state
        dict (None with optimizer=False), with `ema_names` for a flat EMA
        and the quantized regime's `collective_residual`. In the zero2
        regime every slice is gathered over the replica group (the
        quantized one's rows over the data ranks), in the sharded_params
        regime every sharded parameter, its moments and its EMA over fsdp
        and model, and the flat update over a pipe dim is cut into one
        entry a parameter; then, over a pipe dim above 1, every
        stage-local entry is stacked over the pipe ranks ([S, ...]): a
        collective, which every rank calls. Every regime but the quantized
        one saves the replicated trainer's layout."""
        params = {k: v.detach() for k, v in state.network.state_dict().items()}
        saved = dict(step=state.step, params=params, ema_params=state.ema_params,
                     optimizer=state.optimizer.state_dict() if optimizer else None)
        if state.collective_residual is not None:
            saved["collective_residual"] = state.collective_residual
        if state.weight_update is not None:
            state.weight_update.gather(saved)
        if self.pipes == 1:
            return saved
        ema, opt = saved["ema_params"], saved["optimizer"]
        params = self._stack_stages(saved["params"])
        ema = None if ema is None else self._stack_stages(ema)
        if opt is not None:
            names = [n for n, _ in state.network.named_parameters()]
            opt = dict(opt, state={
                i: ({k: collectives.stack_over(v, self.mesh, mesh_lib.PIPE_AXIS)
                     for k, v in opt["state"][i].items()}
                    if self.stage_local(names[i]) else opt["state"][i])
                for i in sorted(opt["state"])})
        return dict(step=state.step, params=params, ema_params=ema, optimizer=opt)

    def local_checkpoint(self, checkpoint: Dict[str, Any],
                         network: torch.nn.Module) -> Dict[str, Any]:
        """A checkpoint as this rank's `network` restores it: over a pipe
        dim above 1 each stacked stage-local entry is this rank's stage's
        slice; then in the zero2 regime each gathered moment and EMA entry
        is this rank's slice of it over the weight-update dims, in the
        quantized one this data rank's rows, in the sharded_params regime
        each sharded parameter, its moments and its EMA this rank's shard,
        and with the flat update the entries are raveled into its one
        vector."""
        checkpoint = self._stage_slice(checkpoint, network)
        if self.regime == "sharded_params":
            return _ShardedParams.local(checkpoint, network, self.param_layout, self.mesh)
        if self.regime == "zero2":
            _, size, index = mesh_lib.dims_group(self.mesh, self.weight_update_axes)
            return _ShardedUpdate.local(checkpoint, network, self._shard_dims(network),
                                        index, size)
        if self.regime == "quant_zero2":
            layout = collectives.FlatShardLayout(
                sum(p.numel() for p in network.parameters()),
                mesh_lib.axis_size(self.mesh, mesh_lib.DATA_AXIS), self.collective.block)
            return _QuantizedUpdate.local(
                checkpoint, layout, collectives.axis_index(self.mesh, mesh_lib.DATA_AXIS))
        if self.flatten_optimizer_update:
            return _FlatUpdate.local(checkpoint, network)
        return checkpoint

    def _stage_slice(self, checkpoint: Dict[str, Any],
                     network: torch.nn.Module) -> Dict[str, Any]:
        """Over a pipe dim above 1, the checkpoint with each stacked
        stage-local entry (parameter, EMA, moment) cut to this rank's
        stage; the checkpoint as it is otherwise."""
        if self.pipes == 1:
            return checkpoint
        stage = collectives.axis_index(self.mesh, mesh_lib.PIPE_AXIS)

        def pick(tensors):
            return None if tensors is None else {
                k: v[stage] if self.stage_local(k) else v for k, v in tensors.items()}

        out = dict(checkpoint, params=pick(checkpoint["params"]),
                   ema_params=pick(state_lib.checkpoint_ema(checkpoint)))
        out.pop("ema_names", None)
        opt = checkpoint.get("optimizer")
        if opt is not None:
            names = [n for n, _ in network.named_parameters()]
            out["optimizer"] = dict(opt, state={
                i: ({k: v[stage] for k, v in entry.items()}
                    if self.stage_local(names[i]) else entry)
                for i, entry in opt["state"].items()})
        return out

    def export_view(self, checkpoint: Dict[str, Any]) -> TrainState:
        """What rank 0's exporters and hooks see of a state that
        `views_state`: a TrainState of the single-device twin
        (single_device) holding the whole model from a checkpoint_state
        (stacked stages relabelled as its blocks, the EMA gathered and as
        a tree), with no optimizer. Otherwise there is nothing to view:
        the caller passes the live state."""
        if self._twin_network is None:
            self._twin_network = self.single_device().model.create_network().to(self.device)
        self._twin_network.load_state_dict(checkpoint["params"])
        ema = state_lib.checkpoint_ema(checkpoint)
        if ema is not None:
            ema = {k: v.to(self.device)
                   for k, v in pipeline_lib.unstack_stages(ema).items()}
        return TrainState(step=checkpoint["step"], network=self._twin_network,
                          optimizer=None, ema_params=ema)

    def _eval_network(self, state: TrainState, use_ema: bool):
        if not use_ema or state.ema_params is None:
            return state.network
        if self._ema_network is None:
            self._ema_network = self.model.create_network().to(self.device)
            if self.regime == "sharded_params":  # sharded as the live network
                sharded_params.shard_network(self._ema_network, self.mesh,
                                             self.param_min_shard_size)
        if self.regime == "sharded_params":
            self._ema_network.load_state_dict(state.export_state_dict(use_ema=True))
        elif self.regime in _ZERO2_REGIMES:  # the EMA is sharded: gather it
            saved = self.checkpoint_state(state, optimizer=False)
            self._ema_network.load_state_dict(
                {**saved["params"], **state_lib.checkpoint_ema(saved)})
        else:
            self._ema_network.load_state_dict(state.export_state_dict(use_ema=True))
        return self._ema_network

    def eval_step(self, state: TrainState, batch, use_ema: bool = False):
        """model_eval_fn on a device batch, under inference_mode (so the
        attention takes the forward without residuals, as the JAX primal
        does)."""
        with torch.inference_mode():
            features, labels = self.preprocessor.preprocess(
                batch["features"], _batch_labels(batch), mode=MODE_EVAL
            )
            network = self._eval_network(state, use_ema)
            network.eval()
            f, l, outputs, _ = self.model.packed_inference(
                network, features, MODE_EVAL, labels=labels
            )
            return self.model.model_eval_fn(f, l, outputs)

    def predict_step(self, network, features):
        """Export outputs of preprocessed device features."""
        with torch.inference_mode():
            network.eval()
            f, _, outputs, _ = self.model.packed_inference(
                network, features, MODE_PREDICT
            )
            return self.model.create_export_outputs_fn(f, outputs)


# -- the weight-update regimes -------------------------------------------------------

#: The regimes whose ranks hold shards of the optimizer state and the EMA:
#: ZeRO-2's (whole parameters), and sharded_params (sharded ones too).
_ZERO2_REGIMES = ("zero2", "quant_zero2")
_SHARDED_REGIMES = _ZERO2_REGIMES + ("sharded_params",)


def _grad(p: torch.Tensor) -> torch.Tensor:
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _slice(t: torch.Tensor, dim: int, index: int, count: int) -> torch.Tensor:
    """Slice `index` of `count` of t's dim `dim` (a view)."""
    size = t.shape[dim] // count
    return t.narrow(dim, index * size, size)


def _unrow(row: torch.Tensor, shape, dim: int) -> torch.Tensor:
    """A tensor of `shape` from its elements in the order
    t.movedim(dim, 0).reshape(-1) gives them."""
    rest = tuple(s for i, s in enumerate(shape) if i != dim)
    return row.reshape((shape[dim],) + rest).movedim(0, dim)


class _FlatUpdate:
    """flatten_optimizer_update: the optimizer steps one flat vector of
    the parameters (models/optimizers.FlatParameters), and the EMA is one
    flat vector updated in one pass. Over a pipe dim above 1 the vector
    holds this rank's entries, its stage's and the shared ones, averaged
    as the per-leaf step averages them; its checkpoint holds them as the
    per-leaf trainer's does (the EMA a tree, one optimizer entry a
    parameter), so the stage entries stack over pipe, and `local` ravels
    them back."""

    def __init__(self, network: nn.Module, stage_local):
        self.flat = FlatParameters(network)
        self.stage_local = stage_local
        self.staged = any(stage_local(name) for name in self.flat.names)

    def optimizer_params(self):
        return [self.flat.flat]

    def named_optimizer_params(self):
        return [("flat", self.flat.flat)]

    def stage_segments(self):
        """([(offset, size)] of the vector's stage entries, the same of
        its other entries), for clipping by a global norm."""
        stage, other, offset = [], [], 0
        for name, p in zip(self.flat.names, self.flat.params):
            (stage if self.stage_local(name) else other).append((offset, p.numel()))
            offset += p.numel()
        return stage, other

    def init_ema(self) -> torch.Tensor:
        return self.flat.flat.detach().clone()

    def step(self, trainer: "Trainer", state: TrainState, loss, metrics):
        if trainer.ranks > 1:
            loss, metrics = trainer.average_over_ranks(state.network, loss, metrics)
        self.flat.gather_grad()
        state.optimizer.step()
        if state.ema_params is not None:
            state.ema_params = update_ema(state.ema_params, self.flat.flat,
                                          trainer.model.avg_model_params_decay)
        return loss, metrics

    def gather(self, saved: Dict[str, Any]) -> None:
        """The saved EMA named (ema_names), or, over a pipe dim above 1,
        the EMA and the optimizer's entries cut into one a parameter."""
        if not self.staged:
            if saved["ema_params"] is not None:
                saved["ema_names"] = list(self.flat.names)
            return
        template = dict(zip(self.flat.names, self.flat.params))
        if saved["ema_params"] is not None:
            saved["ema_params"] = {k: v.clone() for k, v in state_lib.ema_as_tree(
                saved["ema_params"], template).items()}
        opt = saved["optimizer"]
        if opt is not None:
            entry = opt["state"].get(0, {})
            cut = {k: (state_lib.ema_as_tree(v, template) if v.ndim else None)
                   for k, v in entry.items()}
            saved["optimizer"] = dict(
                opt, param_groups=[dict(group, params=list(range(len(template))))
                                   for group in opt["param_groups"]],
                state={i: {k: v.clone() if cut[k] is None else cut[k][name].clone()
                           for k, v in entry.items()}
                       for i, name in enumerate(self.flat.names)} if entry else {})

    @staticmethod
    def local(checkpoint: Dict[str, Any], network: nn.Module) -> Dict[str, Any]:
        """A checkpoint whose EMA and optimizer entries are one a
        parameter, raveled into the flat vector's layout (a flat
        checkpoint passes as it is)."""
        names = [n for n, _ in network.named_parameters()]
        out = dict(checkpoint)
        ema = checkpoint.get("ema_params")
        if isinstance(ema, dict):
            out["ema_params"] = torch.cat([ema[n].reshape(-1) for n in names])
            out["ema_names"] = names
        opt = checkpoint.get("optimizer")
        if opt is not None and len(opt["param_groups"][0]["params"]) > 1:
            entries = [opt["state"][i] for i in range(len(names))] if opt["state"] else []
            state = {0: {k: torch.cat([e[k].reshape(-1) for e in entries]) if v.ndim else v
                         for k, v in entries[0].items()}} if entries else {}
            out["optimizer"] = dict(opt, state=state, param_groups=[
                dict(group, params=[0]) for group in opt["param_groups"]])
        return out


class _ShardedUpdate:
    """zero2: every leaf that mesh.weight_update_sharding shards (`dims`,
    name -> dim; a pipeline's stage entries stay whole) is stepped by the
    optimizer as this rank's slice of it over the replica group, the
    ranks that differ only along the weight-update dims `axes`; a view of
    the parameter, whose moments and EMA exist for that slice only. A
    step reduce-scatters those leaves' gradients over the group (one
    bucket), sums the slice over the complement's ranks (every other dim:
    the replica group's copies of this slice on the other data, sequence,
    pipe and expert coordinates) and divides by the number of ranks, so
    the slice is the replicated step's mean over every rank; it
    all-reduces the other leaves with the metrics as the replicated step
    does (a stage entry over its stage's ranks), steps the optimizer, and
    all-gathers the updated slices into the parameters over the group
    (one bucket)."""

    def __init__(self, network: nn.Module, dims: Dict[str, int], mesh, axes: Sequence[str]):
        self.mesh, self.dims, self.axes = mesh, dims, tuple(axes)
        self.rest = mesh_lib.complement(self.axes)
        _, self.size, self.index = mesh_lib.dims_group(mesh, self.axes)
        self.full: Dict[str, nn.Parameter] = {}
        self.views: Dict[str, torch.Tensor] = {}
        for name, p in network.named_parameters():
            if name in dims:
                self.full[name] = p
                self.views[name] = nn.Parameter(
                    _slice(p.data, dims[name], self.index, self.size))
            else:
                self.views[name] = p

    def optimizer_params(self):
        return list(self.views.values())

    def named_optimizer_params(self):
        return list(self.views.items())

    def init_ema(self) -> Dict[str, torch.Tensor]:
        return {name: v.detach().clone() for name, v in self.views.items()}

    def step(self, trainer: "Trainer", state: TrainState, loss, metrics):
        with torch.no_grad():
            if self.full:
                rows = torch.cat([_grad(p).movedim(self.dims[n], 0).reshape(self.size, -1)
                                  for n, p in self.full.items()], dim=1)
                mine = collectives.psum_scatter(rows, self.mesh, self.axes)[0]
                mine = collectives.psum(mine, self.mesh, self.rest) / trainer.ranks
                offset = 0
                for name, p in self.full.items():
                    view = self.views[name]
                    view.grad = _unrow(mine[offset:offset + view.numel()], view.shape,
                                       self.dims[name])
                    p.grad = None
                    offset += view.numel()
        loss, metrics = trainer.average_over_ranks(state.network, loss, metrics,
                                                   skip=self.full)
        state.optimizer.step()
        with torch.no_grad():
            if self.full:
                mine = torch.cat([self.views[n].detach().movedim(self.dims[n], 0).reshape(-1)
                                  for n in self.full])
                rows = collectives.all_gather(mine, self.mesh, self.axes)
                rows = rows.view(self.size, -1)
                offset = 0
                for name, p in self.full.items():
                    width = self.views[name].numel()
                    p.copy_(_unrow(rows[:, offset:offset + width], p.shape, self.dims[name]))
                    offset += width
        if state.ema_params is not None:
            state.ema_params = update_ema(state.ema_params, self.views,
                                          trainer.model.avg_model_params_decay)
        return loss, metrics

    def gather(self, saved: Dict[str, Any]) -> None:
        """The saved state as the replicated trainer's: each sliced
        leaf's moments and EMA gathered over the replica group."""

        def whole(name, t):
            if name not in self.dims or t.shape != self.views[name].shape:
                return t
            return collectives.all_gather(t.detach(), self.mesh, self.axes,
                                          axis=self.dims[name])

        if saved["ema_params"] is not None:
            saved["ema_params"] = {n: whole(n, t) for n, t in saved["ema_params"].items()}
        opt = saved["optimizer"]
        if opt is not None:
            names = list(self.views)
            saved["optimizer"] = dict(opt, state={
                i: {k: whole(names[i], v) for k, v in entry.items()}
                for i, entry in opt["state"].items()})

    @staticmethod
    def local(checkpoint: Dict[str, Any], network: nn.Module, dims: Dict[str, int],
              index: int, size: int) -> Dict[str, Any]:
        """A replicated-layout checkpoint as this rank of the replica
        group (`index` of `size`) restores it: each sliced leaf's moments
        and EMA cut to its slice."""
        shapes = {n: p.shape for n, p in network.named_parameters()}

        def mine(name, t):
            if name not in dims or t.shape != shapes[name]:
                return t
            return _slice(t, dims[name], index, size).clone()

        out = dict(checkpoint)
        if checkpoint.get("ema_params") is not None:
            out["ema_params"] = {n: mine(n, t)
                                 for n, t in state_lib.checkpoint_ema(checkpoint).items()}
        opt = checkpoint.get("optimizer")
        if opt is not None:
            names = list(shapes)
            out["optimizer"] = dict(opt, state={
                i: {k: mine(names[i], v) for k, v in entry.items()}
                for i, entry in opt["state"].items()})
        return out


class _ShardedParams:
    """sharded_params: the network's parameters are this rank's shards
    (parallel/sharded_params.py; `layout` names the sharded ones, never a
    pipeline's stage entries), and the optimizer, its moments and the EMA
    step them. After the backward a leaf cut over fsdp already holds the
    sum over the fsdp ranks of their batch shards' terms (its gather's
    backward reduce-scatters), so a step sums it over the ranks of the
    trainer's `mean_axes` dims but fsdp (data, sequence, pipe and expert)
    and divides by the count of the `mean_axes` ranks (one bucket); every
    other leaf (whole, or cut over model alone: a kernel none of whose
    other dims fsdp divides) and the metrics are averaged over the
    `mean_axes` ranks (average_over_ranks), which share this rank's model
    index and so its model shard, and a stage entry over its stage's
    ranks. Nothing is averaged over model: a model rank's shard of a
    column-split kernel has its own columns' gradient, and a whole leaf
    the same gradient on every model rank."""

    def __init__(self, network: nn.Module, layout: sharded_params.Layout, mesh):
        self.layout, self.mesh = layout, mesh
        self.params = dict(network.named_parameters())
        self.fsdp_cut = {name for name, (_, fsdp_dim) in layout.items()
                         if fsdp_dim is not None}

    def optimizer_params(self):
        return list(self.params.values())

    def named_optimizer_params(self):
        return list(self.params.items())

    def init_ema(self) -> Dict[str, torch.Tensor]:
        return {name: p.detach().clone() for name, p in self.params.items()}

    def reduce(self, trainer: "Trainer", state: TrainState, loss, metrics):
        """The step's gradient exchange (class docstring); returns the
        averaged loss and metrics."""
        axes = trainer.mean_axes
        group, size, _ = mesh_lib.dims_group(
            self.mesh, [axis for axis in axes if axis != mesh_lib.FSDP_AXIS])
        _, count, _ = mesh_lib.dims_group(self.mesh, axes)
        with torch.no_grad():
            sharded = [p for name, p in self.params.items()
                       if name in self.fsdp_cut and p.requires_grad]
            for p, g in zip(sharded, collectives.all_reduce_mean_flat(
                    [_grad(p) for p in sharded], size, group, count=count)):
                p.grad = g
        return trainer.average_over_ranks(state.network, loss, metrics, skip=self.fsdp_cut)

    def step(self, trainer: "Trainer", state: TrainState, loss, metrics):
        loss, metrics = self.reduce(trainer, state, loss, metrics)
        state.optimizer.step()
        if state.ema_params is not None:
            state.ema_params = update_ema(state.ema_params, self.params,
                                          trainer.model.avg_model_params_decay)
        return loss, metrics

    def gather(self, saved: Dict[str, Any]) -> None:
        """The saved state as the replicated trainer's: every sharded
        parameter, its moments and its EMA gathered whole."""

        def whole(name, t):
            if name not in self.layout or t.shape != self.params[name].shape:
                return t
            return sharded_params.full_tensor(t, self.layout[name], self.mesh)

        saved["params"] = {n: whole(n, t) for n, t in saved["params"].items()}
        if saved["ema_params"] is not None:
            saved["ema_params"] = {n: whole(n, t) for n, t in saved["ema_params"].items()}
        opt = saved["optimizer"]
        if opt is not None:
            names = list(self.params)
            saved["optimizer"] = dict(opt, state={
                i: {k: whole(names[i], v) for k, v in entry.items()}
                for i, entry in opt["state"].items()})

    @staticmethod
    def local(checkpoint: Dict[str, Any], network: nn.Module,
              layout: sharded_params.Layout, mesh) -> Dict[str, Any]:
        """A replicated-layout checkpoint as this rank restores it: each
        sharded parameter, its moments and its EMA cut to its shard."""
        names = [n for n, _ in network.named_parameters()]
        whole = {n: sharded_params.whole_shape(p, layout[n], mesh)
                 for n, p in network.named_parameters() if n in layout}

        def mine(name, t):
            if name not in whole or tuple(t.shape) != whole[name]:
                return t
            return sharded_params.local_tensor(t, layout[name], mesh).clone()

        out = dict(checkpoint, params={n: mine(n, t) for n, t in checkpoint["params"].items()})
        if checkpoint.get("ema_params") is not None:
            out["ema_params"] = {n: mine(n, t)
                                 for n, t in state_lib.checkpoint_ema(checkpoint).items()}
        opt = checkpoint.get("optimizer")
        if opt is not None:
            out["optimizer"] = dict(opt, state={
                i: {k: mine(names[i], v) for k, v in entry.items()}
                for i, entry in opt["state"].items()})
        return out


class _QuantizedUpdate:
    """quant_zero2, JAX's quant_train_step: the parameters raveled
    (named_parameters order) into FlatShardLayout rows, one contiguous
    shard a data rank. A step adds the gradient residual to this rank's
    raveled gradient, reduce-scatters it through the codec, steps the
    optimizer on its shard (the one parameter it is bound to), adds the
    update residual and all-gathers the update through the codec; every
    rank adds the same dequantized update to its parameters, and both
    residuals (what was not sent) carry to the next step. The EMA is this
    rank's flat shard, advanced by the parameters it sent. The batch
    norms' running statistics are averaged over the data ranks after the
    step, and the metrics recombine over them (batch-carrying ones
    gathered, floats averaged, integers summed)."""

    def __init__(self, network: nn.Module, collective, mesh):
        self.collective, self.mesh = collective, mesh
        self.size = mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS)
        self.index = collectives.axis_index(mesh, mesh_lib.DATA_AXIS)
        self.names = [n for n, _ in network.named_parameters()]
        self.params = [p for _, p in network.named_parameters()]
        self.layout = collectives.FlatShardLayout(
            sum(p.numel() for p in self.params), self.size, collective.block)
        self.shard = nn.Parameter(self.layout.rows(self._flat_params())[self.index].clone())
        self.stats = [t for m in network.modules() if isinstance(m, batch_norm_lib.BatchNorm)
                      for t in (m.mean, m.var)]

    def _flat_params(self) -> torch.Tensor:
        return self.layout.pad(torch.cat([p.detach().reshape(-1).float() for p in self.params]))

    def optimizer_params(self):
        return [self.shard]

    def init_ema(self) -> torch.Tensor:
        return self.shard.detach().clone()

    def init_residual(self) -> Dict[str, torch.Tensor]:
        return {"grad": self.shard.new_zeros((1, self.layout.padded)),
                "update": self.shard.new_zeros((self.layout.shard_len,))}

    def step(self, trainer: "Trainer", state: TrainState, loss, metrics):
        coll, layout, axis = self.collective, self.layout, mesh_lib.DATA_AXIS
        residual = state.collective_residual
        with torch.no_grad():
            flat_grads = torch.cat([_grad(p).reshape(-1).float() for p in self.params])
            rows = layout.rows(layout.pad(flat_grads) + residual["grad"][0])
            reduced, sent = coll.reduce_scatter(rows, self.mesh, axis)
            grad_residual = (rows - sent).reshape(1, layout.padded)
            flat_params = self._flat_params()
            param_shard = layout.rows(flat_params)[self.index]
            self.shard.copy_(param_shard)
            self.shard.grad = reduced / self.size
            for p in self.params:
                p.grad = None
        state.optimizer.step()
        with torch.no_grad():
            update = self.shard.detach() - param_shard + residual["update"]
            full_update, sent_update = coll.all_gather_shard(update, self.mesh, axis)
            flat = layout.unpad(flat_params + full_update)
            offset = 0
            for p in self.params:
                p.copy_(flat[offset:offset + p.numel()].view(p.shape))
                offset += p.numel()
            for t, mean in zip(self.stats, collectives.all_reduce_mean_flat(
                    self.stats, self.size)):
                t.copy_(mean)
            if state.ema_params is not None:
                decay = trainer.model.avg_model_params_decay
                state.ema_params = (state.ema_params * decay
                                    + (param_shard + sent_update) * (1.0 - decay))
            state.collective_residual = {"grad": grad_residual,
                                         "update": update - sent_update}
        return self._combine(loss, metrics)

    def _combine(self, loss, metrics):
        """(loss, metrics) over the data ranks: metrics under the
        batch-carrying prefixes (with a batch dim) gathered, floats
        averaged in one all_reduce, integers summed."""
        axis = mesh_lib.DATA_AXIS
        out = {"loss": loss, **metrics}
        carried = [k for k, v in out.items()
                   if k.startswith(BATCH_CARRYING_METRIC_PREFIXES) and v.ndim >= 1]
        floats = [k for k, v in out.items() if k not in carried and v.is_floating_point()]
        for key in carried:
            out[key] = collectives.all_gather(out[key], self.mesh, axis)
        out.update(zip(floats, collectives.all_reduce_mean_flat(
            [out[k] for k in floats], self.size)))
        for key in out:
            if key not in carried and key not in floats:
                out[key] = collectives.psum(out[key], self.mesh, axis)
        loss = out.pop("loss")
        return loss, out

    def gather(self, saved: Dict[str, Any]) -> None:
        """The saved state's flat shards gathered in data-rank order: the
        EMA [padded] (with its ema_names), the optimizer's moments
        [padded] and the residuals ({"grad": [N, padded], "update":
        [padded]})."""

        def whole(t):
            if t.ndim == 0:
                return t
            return collectives.all_gather(t.detach(), self.mesh, mesh_lib.DATA_AXIS)

        if saved["ema_params"] is not None:
            saved["ema_params"] = whole(saved["ema_params"])
            saved["ema_names"] = list(self.names)
        opt = saved["optimizer"]
        if opt is not None:
            saved["optimizer"] = dict(opt, state={
                i: {k: whole(v) for k, v in entry.items()}
                for i, entry in opt["state"].items()})
        saved["collective_residual"] = {
            k: whole(v) for k, v in saved["collective_residual"].items()}

    @staticmethod
    def local(checkpoint: Dict[str, Any], layout, index: int) -> Dict[str, Any]:
        """This data rank's rows of a quantized-regime checkpoint."""

        def mine(t):
            if t.ndim == 1 and t.numel() == layout.padded:
                return layout.rows(t)[index].clone()
            return t

        out = dict(checkpoint)
        if isinstance(checkpoint.get("ema_params"), torch.Tensor):
            out["ema_params"] = mine(checkpoint["ema_params"])
        opt = checkpoint.get("optimizer")
        if opt is not None:
            out["optimizer"] = dict(opt, state={
                i: {k: mine(v) for k, v in entry.items()}
                for i, entry in opt["state"].items()})
        residual = checkpoint.get("collective_residual")
        if residual is not None:
            out["collective_residual"] = {
                "grad": residual["grad"][index:index + 1].clone(),
                "update": mine(residual["update"])}
        return out


def restore_or_init_state(
    model_dir: str, trainer: Trainer, generator: Optional[torch.Generator] = None
) -> TrainState:
    """The newest durable checkpoint under model_dir (torn ones skipped,
    train/durability.py), or a fresh state (warm-started where the model
    asks for it)."""
    state = trainer.init_state(generator)
    checkpoint = durability.load_newest_durable(model_dir, map_location=trainer.device)
    if checkpoint is not None:
        state.restore(trainer.local_checkpoint(checkpoint, state.network))
    return state


# -- the measured plan-search probe (planner.measured_rerank's tier 2) --------------

#: Probes measure_plan_candidate has run (planner.last_search()'s
#: 'probe_compiles', JAX's key: the port compiles nothing).
_PLAN_PROBES = 0


def plan_probe_count() -> int:
    return _PLAN_PROBES


def _max_over_ranks(values: Sequence[float]) -> List[float]:
    """Each value's maximum over the world's ranks (as it is without a
    process group)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return list(values)
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor(list(values), dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def measure_plan_candidate(
    model,
    plan: planner_lib.ShardingPlan,
    example_batch,
    *,
    steps: int = 3,
    warmup: int = 1,
    device: Union[str, torch.device] = DEFAULT_DEVICE,
) -> Dict[str, Any]:
    """Measure probe for ONE shortlisted plan, on every rank of the world:
    builds the plan's mesh and Trainer(plan=...) on `device`, and times
    `steps` synced train steps (every rank starts each together) after
    `warmup`. The step time is the slowest rank's median, and the memory
    the largest peak of torch.cuda.max_memory_allocated over the probe
    (after a reset; None on the CPU), so every rank ranks alike. A plan
    the model cannot run, or a probe that fails, comes back as
    {'skipped': reason}: the search goes on."""
    global _PLAN_PROBES
    record: Dict[str, Any] = {"name": plan.name}
    try:
        _check_trainer_mesh(model, plan.axes_dict(), plan)
    except ValueError as err:
        record["skipped"] = str(err)
        return record
    error, times, peak = None, [], 0
    try:
        trainer = Trainer(model, device=device, mesh=plan.build_mesh(), plan=plan)
        cuda = trainer.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(trainer.device)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        batch = infeed.to_device(mesh_lib.shard_batch(example_batch, trainer.mesh),
                                 trainer.device)
        _PLAN_PROBES += 1
        for i in range(warmup + max(steps, 1)):
            if cuda:
                torch.cuda.synchronize(trainer.device)
            _barrier(trainer)
            start = time.perf_counter()
            trainer.train_step(state, batch)
            if cuda:
                torch.cuda.synchronize(trainer.device)
            if i >= warmup:
                times.append((time.perf_counter() - start) * 1e3)
        peak = torch.cuda.max_memory_allocated(trainer.device) if cuda else 0
    except Exception as err:  # noqa: BLE001 - recorded, the search goes on
        error = f"{type(err).__name__}: {err}"
    times.sort()
    # Every rank takes the same verdict: a failure on any rank skips the plan.
    step_ms, peak, failed = _max_over_ranks(
        [times[len(times) // 2] if times else 0.0, peak, float(error is not None)])
    if failed:
        record["skipped"] = error or "the probe failed on another rank"
        return record
    record["step_time_ms"] = step_ms
    record["steps_timed"] = len(times)
    record["memory_per_device_bytes"] = int(peak) if cuda else None
    return record


# -- evaluation -------------------------------------------------------------------


def normalize_eval_generators(input_generator_eval) -> Dict[str, Any]:
    """None -> {}; a bare generator -> {"": generator}; a mapping passes
    through (one named dataset per entry)."""
    if input_generator_eval is None:
        return {}
    if isinstance(input_generator_eval, dict):
        if "" in input_generator_eval and len(input_generator_eval) > 1:
            raise ValueError(
                "Multi-eval maps require every eval to be named (got an "
                "empty-string name alongside others)."
            )
        return dict(input_generator_eval)
    return {"": input_generator_eval}


def eval_dir_name(name: str) -> str:
    """'eval' for the unnamed eval, 'eval_<name>' per named dataset."""
    return "eval" if not name else f"eval_{name}"


def evaluate(
    trainer: Trainer,
    state: TrainState,
    eval_batches: Iterator,
    eval_steps: Optional[int] = None,
    use_ema: bool = False,
    presharded: bool = False,
) -> Dict[str, float]:
    """Averages model_eval_fn metrics over up to eval_steps batches; the
    sums stay on the device (f32) and are read once at the end. Over a
    mesh each rank evaluates its shard of every batch (`presharded`: the
    batches are already this rank's, shard_by_host) and the totals are
    averaged over the ranks, which must see as many batches."""
    if eval_steps is not None:
        eval_batches = itertools.islice(eval_batches, eval_steps)
    totals: Dict[str, torch.Tensor] = {}
    count = 0
    for batch in infeed.device_prefetch(
        infeed.shard_batches(eval_batches, trainer.mesh, presharded=presharded),
        trainer.device, depth=infeed.resolve_depth(),
    ):
        for key, value in trainer.eval_step(state, batch, use_ema).items():
            value = value.float()
            totals[key] = totals[key] + value if key in totals else value
        count += 1
    keys = sorted(totals)
    averaged = collectives.all_reduce_mean_flat(
        [totals[key] for key in keys], trainer.ranks)
    return {key: float(total) / count for key, total in zip(keys, averaged)}


def run_named_evals(
    trainer: Trainer,
    state: TrainState,
    eval_generators: Dict[str, Any],
    eval_steps: Optional[int],
    use_ema: bool,
    step: Optional[int] = None,
    writers: Optional[Dict[str, MetricsWriter]] = None,
) -> Dict[str, float]:
    """Evaluates every named dataset; returns merged metrics. The first
    entry's metrics keep unprefixed keys; every named eval's are also
    recorded under '<name>/<key>'."""
    merged: Dict[str, float] = {}
    for i, (name, generator) in enumerate(eval_generators.items()):
        metrics = evaluate(
            trainer, state, iter(generator.create_dataset(MODE_EVAL)),
            eval_steps=eval_steps, use_ema=use_ema,
            presharded=_reads_its_shard(generator, trainer.mesh),
        )
        if not metrics:
            continue
        if writers is not None and step is not None and name in writers:
            writers[name].write(step, metrics)
        if i == 0:
            merged.update(metrics)
        if name:
            merged.update({f"{name}/{k}": v for k, v in metrics.items()})
    return merged


def _reads_its_shard(generator, mesh) -> bool:
    """Whether `generator` streams this rank's data x fsdp shard itself
    (shard_by_host over a mesh)."""
    return mesh is not None and getattr(generator, "shard_by_host", False)


def shard_inputs(generators, mesh) -> None:
    """Points every shard_by_host generator at this rank's data x fsdp
    shard of `mesh` (data/dataset.py has the rule)."""
    if mesh is None:
        return
    index, count = mesh_lib.data_shard(mesh)
    for generator in generators:
        if getattr(generator, "shard_by_host", False):
            generator.set_data_shard(index, count)


# -- the entry point ----------------------------------------------------------------


def train_eval_model(
    t2r_model,
    input_generator_train=None,
    input_generator_eval=None,
    model_dir: str = "/tmp/t2r_torch_model",
    max_train_steps: int = 1000,
    eval_steps: Optional[int] = 100,
    save_checkpoints_steps: int = 500,
    keep_checkpoint_max: int = 5,
    log_every_steps: int = 100,
    create_exporters_fn=None,
    hook_builders=None,
    mesh=None,
    seed: int = 0,
    use_ema_for_eval: Optional[bool] = None,
    use_tensorboard: Optional[bool] = None,
    iterations_per_loop: int = 1,
    infeed_depth: Optional[int] = None,
    remat: bool = False,
    grad_accum_steps: int = 1,
    shard_weight_update: bool = False,
    flatten_optimizer_update: bool = False,
    plan=None,
    device: Union[str, torch.device] = DEFAULT_DEVICE,
    collective_quant: Optional[str] = None,
    collective_block: Optional[int] = None,
    weight_update_axes: Optional[Sequence[str]] = None,
) -> Dict[str, float]:
    """Trains, periodically checkpoints and evaluates the model; returns
    the final eval metrics ({} without an eval generator). Resumes from
    the newest durable checkpoint in model_dir if there is one.

    iterations_per_loop > 1 runs K steps per loop, and hooks then observe
    loop granularity. remat, grad_accum_steps and shard_weight_update are
    the memory levers, weight_update_axes the replica dims ZeRO-2 shards
    over (None: ("data",)), and flatten_optimizer_update,
    collective_quant, collective_block the other weight-update regimes
    (Trainer). In the quantized ZeRO-2 regime every metrics line carries
    the exchange's collective_log_record. use_tensorboard (None: the
    model's use_summaries) reaches the train metrics writer as in the JAX
    package, which writes metrics.jsonl alone here (train/metrics.py). With
    a mesh every rank of the world calls this with the same arguments
    (module docstring). `plan` (a planner.ShardingPlan) drives the trainer
    as Trainer(plan=...) does; without one the T2R_PLAN flag is resolved
    (planner.resolve_plan_from_flag: 'off' keeps the arguments, a preset
    names its plan, 'auto' searches with a first batch of the train
    generator, drawn from a stream of its own)."""
    if input_generator_train is None:
        raise ValueError("train_eval_model requires input_generator_train.")
    eval_generators = normalize_eval_generators(input_generator_eval)
    model = maybe_wrap_for_tpu(t2r_model)
    input_generator_train.set_specification_from_model(model, MODE_TRAIN)
    if plan is None:
        example = None
        if flags.get_str("T2R_PLAN") == "auto":
            example = next(iter(input_generator_train.create_dataset(MODE_TRAIN)))
        plan = planner_lib.resolve_plan_from_flag(model, example, device=device)
    trainer = Trainer(
        model, device=device, seed=seed, mesh=mesh, plan=plan,
        remat=remat, grad_accum_steps=grad_accum_steps,
        shard_weight_update=shard_weight_update,
        flatten_optimizer_update=flatten_optimizer_update,
        collective_quant=collective_quant, collective_block=collective_block,
        weight_update_axes=weight_update_axes,
    )
    chief = trainer.is_chief
    if chief:
        print_specification(model)
    os.makedirs(model_dir, exist_ok=True)
    if chief:
        _save_operative_config(model_dir)
    infeed_depth = infeed.resolve_depth(infeed_depth)
    if use_ema_for_eval is None:
        use_ema_for_eval = model.use_avg_model_params

    mesh = trainer.mesh
    shard_inputs([input_generator_train, *eval_generators.values()], mesh)
    host_batches = iter(input_generator_train.create_dataset(MODE_TRAIN))
    for generator in eval_generators.values():
        generator.set_specification_from_model(model, MODE_EVAL)

    # The writer's sweep, before anything reads the directory: torn files
    # move to quarantine/, so the replayed steps re-save cleanly.
    if chief:
        for torn_name, torn_reason in durability.sweep_torn_checkpoints(model_dir):
            print(f"Quarantined torn checkpoint {torn_name!r}: {torn_reason}",
                  flush=True)
    _barrier(trainer)
    state = restore_or_init_state(
        model_dir, trainer, torch.Generator().manual_seed(seed)
    )
    start_step = state.step
    if start_step > 0:
        # Step k of a resumed run sees the batch step k of an
        # uninterrupted run saw: deterministic generators restart their
        # stream from batch 0, so skip the batches already consumed.
        host_batches = itertools.islice(host_batches, start_step, None)
    host_batches = infeed.shard_batches(
        host_batches, trainer.mesh, trainer.grad_accum_steps,
        presharded=_reads_its_shard(input_generator_train, mesh))

    # The quantized exchange's bytes and measured wall time ride in every
    # metrics line ({} in the other regimes; a collective when measured).
    collective_info = trainer.collective_log_record()
    if use_tensorboard is None:
        use_tensorboard = model.use_summaries
    writer = (MetricsWriter(os.path.join(model_dir, "train"), use_tensorboard=use_tensorboard)
              if chief else None)
    eval_writers = {
        name: MetricsWriter(os.path.join(model_dir, eval_dir_name(name)),
                            use_tensorboard=False)
        for name in eval_generators
    } if chief else {}
    exporting = trainer.single_device()
    hooks: List[Hook] = []
    exporters = []
    if chief:
        for builder in hook_builders or []:
            hooks.extend(builder.create_hooks(exporting.model, trainer=exporting))
        if create_exporters_fn is not None:
            exporters = create_exporters_fn(exporting.model)
    # Where a rank's state is not the whole model's (a pipe stage, a
    # ZeRO-2 EMA shard) rank 0's hooks see the twin holding the whole
    # model, gathered whenever they run (a collective: every rank takes part).
    hooked = trainer.views_state and bool(hook_builders)

    def seen(checkpoint=None) -> TrainState:
        if not trainer.views_state:
            return state
        if checkpoint is None:
            checkpoint = trainer.checkpoint_state(state, optimizer=False)
        return trainer.export_view(checkpoint) if chief else state

    ctx = HookContext(model=exporting.model, model_dir=model_dir, step=start_step,
                      state=seen() if hooked else state)
    final_eval: Dict[str, float] = {}
    step = last_saved_step = last_log_step = start_step
    t_last = time.time()

    def log_metrics(metrics) -> Dict[str, float]:
        nonlocal t_last, last_log_step
        host = {k: float(v) for k, v in metrics.items() if v.ndim == 0}
        now = time.time()
        host["steps_per_sec"] = (step - last_log_step) / max(now - t_last, 1e-9)
        host.update(collective_info)
        t_last, last_log_step = now, step
        if writer is not None:
            writer.write(step, host)
        return host

    def after_steps(metrics, logged: bool) -> None:
        ctx.step, ctx.device_metrics = step, metrics
        ctx.state = seen() if hooked else state
        ctx.metrics = log_metrics(metrics) if logged else None
        for hook in hooks:
            hook.after_step(ctx)

    def checkpoint_and_eval() -> Dict[str, float]:
        nonlocal last_saved_step
        saved = trainer.checkpoint_state(state)
        if chief:
            state_lib.save_checkpoint(
                model_dir, step, saved["params"], saved["ema_params"],
                saved["optimizer"], keep_checkpoint_max,
                ema_names=saved.get("ema_names"),
                collective_residual=saved.get("collective_residual"),
            )
            durability.publish_durable(model_dir, step)
        _barrier(trainer)
        last_saved_step = step
        ctx.state = seen(saved)
        ctx.checkpoint_path = state_lib.checkpoint_path(model_dir, step)
        for hook in hooks:
            hook.after_checkpoint_saved(ctx)
        eval_metrics = run_named_evals(
            trainer, state, eval_generators, eval_steps=eval_steps,
            use_ema=use_ema_for_eval, step=step, writers=eval_writers,
        )
        for exporter in exporters:
            exporter.maybe_export(
                step=step, state=ctx.state, eval_metrics=eval_metrics,
                compiled=exporting, model_dir=model_dir,
            )
        ctx.eval_metrics = eval_metrics
        for hook in hooks:
            hook.after_eval(ctx)
        _barrier(trainer)  # the other ranks wait for rank 0's exports
        return eval_metrics

    try:
        for hook in hooks:
            hook.on_train_begin(ctx)
        loop_sizes = _loop_sizes(step, max_train_steps, iterations_per_loop,
                                 save_checkpoints_steps)
        size = left = 0
        for batch in infeed.device_prefetch(
            host_batches, trainer.device, depth=infeed_depth
        ):
            if step >= max_train_steps:
                break
            if not left:
                size = left = next(loop_sizes)
                ctx.step = step
                for hook in hooks:
                    hook.before_step(ctx)
            # Never beside an export's tracing on a hook's thread.
            with TRACE_LOCK:
                metrics = trainer.train_step(state, batch)
            step, left = state.step, left - 1
            if left:
                continue
            after_steps(metrics, step % log_every_steps < size
                        or step == max_train_steps)
            if step % save_checkpoints_steps == 0 or step == max_train_steps:
                with TRACE_LOCK:
                    final_eval = checkpoint_and_eval()
        if left:
            # Host data ran out mid-loop: the hooks see the loop's end.
            after_steps(metrics, True)
        if step > last_saved_step:
            # Host data ran out mid-interval: keep the trained steps.
            with TRACE_LOCK:
                final_eval = checkpoint_and_eval()
    finally:
        for hook in hooks:
            hook.on_train_end(ctx)
        if writer is not None:
            writer.close()
        for eval_writer in eval_writers.values():
            eval_writer.close()
        if chief:
            _save_operative_config(model_dir)
    _barrier(trainer)  # rank 0's last export and writes are done
    return final_eval


def _barrier(trainer: Trainer) -> None:
    """Every rank of a mesh run waits here for rank 0's writes."""
    if trainer.ranks > 1:
        dist.barrier()


def _loop_sizes(step: int, max_train_steps: int, iterations_per_loop: int,
                save_checkpoints_steps: int) -> Iterator[int]:
    """The steps of each loop from `step` on: iterations_per_loop, cut
    short at checkpoint steps so every checkpoint lands on its step."""
    while step < max_train_steps:
        boundary = min(max_train_steps,
                       (step // save_checkpoints_steps + 1) * save_checkpoints_steps)
        size = min(max(iterations_per_loop, 1), boundary - step)
        yield size
        step += size


def _save_operative_config(model_dir: str) -> None:
    """Writes `operative_config.gin`: what every configurable ran with."""
    try:
        config_lib.save_operative_config(model_dir)
    except OSError as err:
        logging.warning("Could not write operative config to %s: %s", model_dir, err)


def predict_from_model(
    t2r_model,
    input_generator,
    model_dir: str,
    mesh=None,
    device: Union[str, torch.device] = DEFAULT_DEVICE,
) -> Iterator[TensorSpecStruct]:
    """Restores the newest durable checkpoint (EMA parameters when the
    model keeps them) and yields each batch's export outputs as numpy.

    With a mesh (JAX's keyword) each rank predicts every batch whole on its
    own device (rank_device) from the replicated restore, through the
    model without its mesh: no collective, and the outputs JAX gathers
    from its data shards."""
    model = maybe_wrap_for_tpu(t2r_model)
    if mesh is not None:
        mesh_lib.check_mesh(mesh)
        model, device = model.without_mesh(), rank_device(device)
    trainer = Trainer(model, device=device)
    checkpoint = durability.load_newest_durable(model_dir)
    if checkpoint is None:
        raise FileNotFoundError(
            f"No checkpoint under {state_lib.checkpoint_dir(model_dir)!r} "
            "verifies; refusing to serve randomly initialized (or torn) "
            "weights. Use init_randomly on a predictor if that is intended."
        )
    input_generator.set_specification_from_model(model, MODE_PREDICT)
    params = checkpoint["params"]
    if model.use_avg_model_params and checkpoint["ema_params"] is not None:
        params = {**params, **state_lib.checkpoint_ema(checkpoint)}
    network = model.create_network()
    network.load_state_dict(params)
    network = network.to(trainer.device)
    for batch in infeed.device_prefetch(
        input_generator.create_dataset(MODE_PREDICT), trainer.device
    ):
        with torch.inference_mode():
            features, _ = trainer.preprocessor.preprocess(
                batch["features"], _batch_labels(batch), mode=MODE_PREDICT
            )
        outputs = trainer.predict_step(network, features)
        result = TensorSpecStruct()
        for key, value in outputs.items():
            result[key] = value.cpu().numpy()
        yield result
