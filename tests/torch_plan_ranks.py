"""The rank side of the planner's parity tests (tests/test_torch_planner.py
and tests/test_torch_plan_cache.py).

Each function runs on every rank of a LocalWorld of 4 gloo processes on
the CPU and returns plain values for the test to check. No JAX here:
spawned ranks import this.
"""

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.parallel import planner
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.train import durability
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train import train_eval


def _struct(batch: dict):
    return TensorSpecStruct({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})


def preset(name: str, min_size: int, block: int) -> planner.ShardingPlan:
    """The preset on the world's ranks, with the test's
    param_min_shard_size and codec block."""
    return dataclasses.replace(planner.resolve_preset(name), param_min_shard_size=min_size,
                               collective_block=block)


def bc(model_kwargs: dict, mesh=None, **extra) -> TransformerBCModel:
    return TransformerBCModel(device_type="cpu", mesh=mesh, **extra, **model_kwargs)


def _run(trainer, weights: dict, batch: dict, steps: int):
    state = trainer.init_state(params={k: torch.from_numpy(v) for k, v in weights.items()})
    local = _struct(mesh_lib.shard_batch(batch, trainer.mesh))
    losses = [trainer.train_step(state, local)["loss"].item() for _ in range(steps)]
    saved = trainer.checkpoint_state(state)
    return state, losses, saved


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def plan_step(name: str, min_size: int, block: int, model_kwargs: dict, weights: dict,
              batch: dict, steps: int = 2, flatten: bool = False) -> dict:
    """`steps` steps of small BC under the preset's plan (mesh from
    build_mesh, model from model_kwargs(), Trainer(plan=...)) and of the
    hand-wired trainer on the same dims, from the same weights on this
    rank's shard of `batch`. Returns the plan's regime, its audit (and
    the mismatches of the control's: the state audited against a plan of
    another regime), both losses and whether every gathered parameter, moment and EMA entry
    agrees bit for bit. With `flatten` both take the flat optimizer
    update."""
    plan = preset(name, min_size, block)
    model = bc(model_kwargs, plan.build_mesh(), use_avg_model_params=True,
               **plan.model_kwargs())
    planned = train_eval.Trainer(model, device="cpu", plan=plan,
                                 flatten_optimizer_update=flatten)
    state, losses, saved = _run(planned, weights, batch, steps)
    audit = planner.audit_state_layout(planned.layout, planned.mesh, state)
    # The control: the same state audited against a plan of another
    # layout (ZeRO-2 flipped, every leaf shardable, no codec, no stages).
    other = dataclasses.replace(planned.layout, param_min_shard_size=0, collective_quant="none",
                                shard_weight_update=not plan.shard_weight_update,
                                data=plan.data * plan.pipe, pipe=1)
    control = len(planner.audit_state_layout(other, planned.mesh, state)["mismatches"])
    hand_mesh = mesh_lib.make_mesh(**plan.axes_dict())
    hand = train_eval.Trainer(
        bc(model_kwargs, hand_mesh, use_avg_model_params=True, **plan.model_kwargs()),
        device="cpu", mesh=hand_mesh, shard_weight_update=plan.shard_weight_update,
        collective_quant=plan.collective_quant, collective_block=block,
        param_min_shard_size=min_size, flatten_optimizer_update=flatten)
    _, hand_losses, hand_saved = _run(hand, weights, batch, steps)
    opt = [(e, h) for e, h in zip(saved["optimizer"]["state"].values(),
                                   hand_saved["optimizer"]["state"].values())]
    return dict(regime=planned.regime, hand_regime=hand.regime, audit=audit, control=control,
                losses=losses, hand_losses=hand_losses,
                params_equal=_equal(saved["params"], hand_saved["params"]),
                ema_equal=(_equal(saved["ema_params"], hand_saved["ema_params"])
                           if isinstance(saved["ema_params"], dict)
                           else torch.equal(saved["ema_params"], hand_saved["ema_params"])),
                opt_equal=all(_equal(e, h) for e, h in opt),
                sliced=sorted(getattr(state.weight_update, "dims", {})))


def refusals(model_kwargs: dict) -> dict:
    """What a plan refuses, each case's error as "<type>: <message>": a
    mesh that disagrees with the plan, a model built without the plan's
    stages, a model without the plan's sequence mesh, a plan that is not
    a ShardingPlan, a world of other size than the plan's; and with
    T2R_COLLECTIVE_QUANT=int8 set, the codec each plan takes."""
    dp_pp = planner.resolve_preset("dp_pp")
    pipe_mesh = dp_pp.build_mesh()
    sp = planner.ShardingPlan(name="dp2_sp2", data=2, sequence=2)
    cases = {
        "mesh": lambda: train_eval.Trainer(bc(model_kwargs), device="cpu",
                                           mesh=mesh_lib.make_mesh(data=4), plan=dp_pp),
        "stages": lambda: train_eval.Trainer(bc(model_kwargs, pipe_mesh), device="cpu",
                                             plan=dp_pp),
        "sequence": lambda: train_eval.Trainer(bc(model_kwargs), device="cpu", plan=sp),
        "type": lambda: train_eval.Trainer(bc(model_kwargs), device="cpu", plan=object()),
        "world": lambda: planner.resolve_preset("sp_ring").build_mesh(),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = ""
        except (TypeError, ValueError) as err:
            out[name] = f"{type(err).__name__}: {err}"
    saved = os.environ.get("T2R_COLLECTIVE_QUANT")
    os.environ["T2R_COLLECTIVE_QUANT"] = "int8"
    try:
        exact = train_eval.Trainer(bc(model_kwargs), device="cpu",
                                   plan=planner.resolve_preset("dp_zero2"))
        fp8 = train_eval.Trainer(bc(model_kwargs), device="cpu",
                                 plan=planner.resolve_preset("dp_zero2_fp8_e5m2"))
        ambient = train_eval.Trainer(bc(model_kwargs), device="cpu",
                                     mesh=mesh_lib.make_mesh(data=4), shard_weight_update=True)
    finally:
        if saved is None:
            os.environ.pop("T2R_COLLECTIVE_QUANT")
        else:
            os.environ["T2R_COLLECTIVE_QUANT"] = saved
    out["codecs"] = (None if exact.collective is None else exact.collective.name,
                     fp8.collective.name, ambient.collective.name, exact.regime)
    return out


def quant_checkpoint(model_kwargs: dict, weights: dict, batch: dict, model_dir: str,
                     block: int) -> dict:
    """Two steps under dp_zero2_int8 (block `block`), its checkpoint
    written by rank 0, then: a fresh trainer on the same plan restored
    from it, both stepped twice more (the parameters compared bit for
    bit), and a trainer on dp_zero2 restoring it (its error)."""
    plan = dataclasses.replace(planner.resolve_preset("dp_zero2_int8"), collective_block=block)
    trainer = train_eval.Trainer(bc(model_kwargs), device="cpu", plan=plan)
    state, _, saved = _run(trainer, weights, batch, 2)
    if dist.get_rank() == 0:
        state_lib.save_checkpoint(model_dir, saved["step"], saved["params"],
                                  saved["ema_params"], saved["optimizer"],
                                  collective_residual=saved["collective_residual"])
        durability.publish_durable(model_dir, saved["step"])
    dist.barrier()
    fresh = train_eval.Trainer(bc(model_kwargs), device="cpu", plan=plan)
    restored = train_eval.restore_or_init_state(model_dir, fresh)
    local = _struct(mesh_lib.shard_batch(batch, trainer.mesh))
    for _ in range(2):
        trainer.train_step(state, local)
        fresh.train_step(restored, local)
    same = all(torch.equal(a, b) for a, b in zip(state.network.parameters(),
                                                  restored.network.parameters()))
    other = train_eval.Trainer(bc(model_kwargs), device="cpu",
                               plan=planner.resolve_preset("dp_zero2"))
    try:
        train_eval.restore_or_init_state(model_dir, other)
        error = ""
    except Exception as err:  # noqa: BLE001 - the test reads its type
        error = f"{type(err).__name__}: {err}"
    return dict(step=restored.step, same=same, error=error)


def auto_search(model_kwargs: dict, batch: dict, cache_dir: str) -> dict:
    """T2R_PLAN=auto with T2R_PLAN_MEASURE=shortlist-2 (1 timed step) and
    the cache in `cache_dir`: a cold search, then a warm one. Returns
    each one's last_search() and plan document."""
    flags_set = dict(T2R_PLAN="auto", T2R_PLAN_CACHE_DIR=cache_dir,
                     T2R_PLAN_MEASURE="shortlist-2", T2R_PLAN_MEASURE_STEPS="1")
    saved = {k: os.environ.get(k) for k in flags_set}
    os.environ.update(flags_set)
    try:
        model = bc(model_kwargs)
        host = _struct(batch)
        out = {}
        for run in ("cold", "warm"):
            plan = planner.resolve_plan_from_flag(model, host, device="cpu")
            out[run] = dict(stats=planner.last_search(), plan=plan.to_json())
        trainer = train_eval.Trainer(model, device="cpu", plan=plan)
        trainer.init_state()
        out["trained_regime"] = trainer.regime
        return out
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def train_under_flag(model_kwargs: dict, model_dir: str, flags_set: dict) -> dict:
    """train_eval_model of small BC (no mesh, no plan argument) for 2
    steps with `flags_set` in the environment (T2R_PLAN and its kin).
    Returns the plan, regime and mesh of the trainer train_eval_model
    built (read by a spy on init_state), the final eval, the newest
    checkpoint's step and last_search()."""
    from tensor2robot_tpu_torch.data.input_generators import DefaultRandomInputGenerator

    seen = []
    init_state = train_eval.Trainer.init_state

    def spy(self, *args, **kwargs):
        seen.append(dict(plan=None if self.plan is None else self.plan.name,
                         regime=self.regime, mesh=mesh_lib.mesh_shape(self.mesh)))
        return init_state(self, *args, **kwargs)

    saved = {k: os.environ.get(k) for k in flags_set}
    os.environ.update(flags_set)
    train_eval.Trainer.init_state = spy
    try:
        final = train_eval.train_eval_model(
            bc(model_kwargs), DefaultRandomInputGenerator(batch_size=8, seed=0),
            DefaultRandomInputGenerator(batch_size=8, seed=1), model_dir=model_dir,
            max_train_steps=2, save_checkpoints_steps=2, eval_steps=1, device="cpu")
    finally:
        train_eval.Trainer.init_state = init_state
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    return dict(trainer=seen[0], final=final,
                step=durability.load_newest_durable(model_dir)["step"],
                search=planner.last_search())
