"""Port parity: the sharding planner (parallel/planner.py).

Against the JAX package's planner on the CPU (its 8-device host mesh):

  * the ranked tables of small BC and of the critic (Grasping44 at 96x96)
    for topologies of 1, 2, 4 and 8 devices, with and without a memory
    budget that rejects some candidates: the same order, names,
    feasibility and reasons, `comm` byte for byte on every dim, `memory`'s
    params, grads, EMA and activations exactly. opt_state (and with it
    the total, each plan document's memory_bytes and the budget reasons'
    figure) differs by one allowance, derived from the two specs: the
    bytes of the optimizers' scalar step counters (torch's Adam keeps one
    a parameter, optax's one in all; torch's momentum SGD keeps none,
    optax's schedule one);
  * every preset's plan document at 4 and 8 devices, and its
    collective_schedule over BC's spec;
  * each preset's predicted layout (ShardingPlan.state_shardings), mapped
    to the flax layout through utils/jax_params.flax_dims, against JAX's
    state_shardings PartitionSpecs for the same state on its own mesh
    (parameters, Adam's mu and nu, the EMA; the quantized regimes' flat
    vectors and residuals);
  * on one LocalWorld of 4 gloo ranks: dp, dp_zero2, dp_zero2_int8, dp_pp
    and dp_pp_zero2 with JAX's tests' param_min_shard_size (0 for the
    ZeRO-2 plans, so that leaves shard) and codec block: the audit clean
    over every entry and failing for a plan of another regime (the
    control), two plan-driven steps equal to the hand-wired trainer's bit
    for bit (losses, parameters, moments, EMA), and the same for the flat
    optimizer update under dp_pp; a mesh or a model that
    disagrees with the plan, a plan that is not a ShardingPlan and a
    world of another size raise; the plan overrides
    T2R_COLLECTIVE_QUANT; a dp_zero2_int8 checkpoint restores bit for bit
    under its plan and raises under dp_zero2 (JAX's
    tests/test_planner.py:429-485); train_eval_model under
    T2R_PLAN=dp_zero2 takes the preset's mesh and regime.

The module runs in about 30 s on the CPU, most of it JAX's eval_shapes
and the ranks' steps.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.models.transformer_models import TransformerBCModel as JaxBC
from tensor2robot_tpu.parallel import collectives as jax_collectives
from tensor2robot_tpu.parallel import mesh as jax_mesh_lib
from tensor2robot_tpu.parallel import planner as jax_planner
from tensor2robot_tpu.research.qtopt.t2r_models import (
    Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom as JaxCritic,
)
from tensor2robot_tpu.specs import make_random_numpy
from tensor2robot_tpu.train.state import TrainState as JaxState
from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
from tensor2robot_tpu_torch.parallel import launch
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.parallel import planner
from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
    Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom as Critic,
)
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.utils.jax_params import flax_dims
from tests import torch_plan_ranks as ranks

SMALL = dict(action_size=7, pose_size=14, episode_length=16, image_size=(16, 16),
             d_model=32, num_layers=2, num_heads=4, head_dim=8)
CRITIC = dict(image_size=(96, 96), num_convs=(2, 2, 1))
BLOCK = 64
# (preset, param_min_shard_size) on the 4-rank world.
RANK_PLANS = [("dp", mesh_lib.MIN_WEIGHT_SIZE), ("dp_zero2", 0),
              ("dp_zero2_int8", mesh_lib.MIN_WEIGHT_SIZE), ("dp_pp", mesh_lib.MIN_WEIGHT_SIZE),
              ("dp_pp_zero2", 0)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def world():
    with launch.LocalWorld(4, threads=1) as w:
        yield w


def _batch(pre_or_model, seed: int = 0) -> dict:
    """One seeded host batch of 8 ({"features", "labels"} numpy dicts)."""
    pre = getattr(pre_or_model, "preprocessor", pre_or_model)
    return {"features": make_random_numpy(pre.get_in_feature_specification("train"),
                                          batch_size=8, seed=seed),
            "labels": make_random_numpy(pre.get_in_label_specification("train"),
                                        batch_size=8, seed=seed + 1)}


def _flat(batch: dict) -> dict:
    return {f"{part}/{key}": np.asarray(value) for part in ("features", "labels")
            for key, value in batch[part].items()}


@pytest.fixture(scope="module")
def specs():
    """{kind: (JAX's ModelSpec, the port's)} of small BC and the critic
    on the same batch."""
    out = {}
    for kind, jax_model, model in (
            ("bc", JaxBC(use_flash=False, device_type="cpu", **SMALL),
             TransformerBCModel(device_type="cpu", **SMALL)),
            ("critic", JaxCritic(device_type="cpu", **CRITIC), Critic(device_type="cpu",
                                                                      **CRITIC))):
        batch = _batch(jax_model)
        out[kind] = (jax_planner.ModelSpec.from_model(jax_model, batch),
                     planner.ModelSpec.from_model(model, TensorSpecStruct(_flat(batch))))
    return out


def _allowance(jax_spec, spec) -> int:
    """opt_state's bytes the port counts over JAX's: its scalar step
    counters' less optax's (every other entry agrees)."""
    ours = sum(leaf.itemsize for leaf in spec.opt_shapes.values() if not leaf.shape)
    theirs = sum(np.dtype(leaf.dtype).itemsize
                 for leaf in jax.tree_util.tree_leaves(jax_spec.opt_shapes)
                 if hasattr(leaf, "shape") and not leaf.shape)
    return ours - theirs


def test_specs_match_jax(specs):
    for jax_spec, spec in specs.values():
        assert spec.n_params == jax_spec.n_params
        assert spec.param_bytes == jax_spec.param_bytes
        assert spec.batch_bytes == jax_spec.batch_bytes
        assert (spec.batch_size, spec.seq_len, spec.num_heads, spec.head_dim, spec.num_layers,
                spec.d_model, spec.pipeline_capable, spec.has_ema) == (
            jax_spec.batch_size, jax_spec.seq_len, jax_spec.num_heads, jax_spec.head_dim,
            jax_spec.num_layers, jax_spec.d_model, jax_spec.pipeline_capable,
            jax_spec.has_ema)
        for key, leaf in spec.opt_shapes.items():
            if leaf.shape:  # a moment: its parameter's shape
                assert leaf.shape == spec.param_shapes[key.rpartition("/")[0]].shape
    assert _allowance(*specs["bc"]) == 4 * (len(specs["bc"][1].param_shapes) - 1)


def _budget(table) -> int:
    """A budget between two neighbouring memory estimates: rejects the
    candidates above it, keeps the rest."""
    totals = sorted({e["memory"]["total"] for e in table})
    low, high = totals[len(totals) // 2 - 1], totals[len(totals) // 2]
    return (low + high) // 2


def _held_to_jax(ours: dict, theirs: dict, allowance: int) -> None:
    """One ranked-table entry against JAX's (module docstring)."""
    plan = dict(ours["plan"], memory_bytes=ours["plan"]["memory_bytes"] - allowance)
    assert plan == theirs["plan"]
    assert ours["comm"] == theirs["comm"]
    memory = dict(ours["memory"])
    memory["opt_state"] -= allowance
    memory["total"] -= allowance
    assert memory == theirs["memory"]
    assert ours["feasible"] == theirs["feasible"]
    figure = f"memory estimate {ours['memory']['total']} B"
    assert [r.replace(figure, f"memory estimate {theirs['memory']['total']} B")
            for r in ours["reasons"]] == theirs["reasons"]


@pytest.mark.parametrize("kind,devices,budgeted", [
    (kind, n, budgeted) for kind in ("bc", "critic") for n in (1, 2, 4, 8)
    for budgeted in (False, True) if n > 1 or not budgeted])
def test_ranked_table_matches_jax(specs, kind, devices, budgeted):
    jax_spec, spec = specs[kind]
    allowance = _allowance(jax_spec, spec)
    budget = None
    if budgeted:
        budget = _budget(jax_planner.plan(jax_spec, jax_planner.Topology(devices)).table)
    theirs = jax_planner.plan(jax_spec, jax_planner.Topology(devices), memory_budget=budget)
    ours = planner.plan(spec, planner.Topology(devices), memory_budget=budget)
    assert len(ours.table) == len(theirs.table)
    for entry, jax_entry in zip(ours.table, theirs.table):
        _held_to_jax(entry, jax_entry, allowance)
    if budgeted:
        assert not all(e["feasible"] for e in ours.table)
        assert any("exceeds budget" in r for e in ours.table for r in e["reasons"])
    assert ours.best.name == theirs.best.name


@pytest.mark.parametrize("name", jax_planner.preset_names())
@pytest.mark.parametrize("devices", [4, 8])
def test_preset_documents_match_jax(specs, name, devices):
    jax_spec, spec = specs["bc"]
    ours, theirs = planner.resolve_preset(name, devices), jax_planner.resolve_preset(
        name, devices)
    assert ours.to_json() == theirs.to_json()
    assert planner.ShardingPlan.from_json(ours.to_json()) == ours
    assert ours.collective_schedule(spec) == theirs.collective_schedule(jax_spec)
    assert ours.compiled_kwargs() == theirs.compiled_kwargs()
    assert ours.model_kwargs() == theirs.model_kwargs()


def test_preset_and_measure_errors_match_jax():
    assert planner.preset_names() == jax_planner.preset_names()
    with pytest.raises(KeyError, match="T2R_PLAN"):
        planner.resolve_preset("dp_zero2_int4")
    for setting in ("off", "", None, "shortlist-1", "shortlist-8"):
        assert planner.parse_measure_setting(setting) == jax_planner.parse_measure_setting(
            setting)
    for bad in ("on", "shortlist-0", "shortlist-x", "shortlist-", "4"):
        with pytest.raises(ValueError, match="T2R_PLAN_MEASURE"):
            planner.parse_measure_setting(bad)
    doc = dict(planner.resolve_preset("dp", 4).to_json(), warp_factor=9)
    with pytest.raises(ValueError, match="warp_factor"):
        planner.ShardingPlan.from_json(doc)


# -- the predicted layouts ------------------------------------------------------------


def _jax_name(path) -> str:
    """The port's state-dict name of a flax params path."""
    keys = [str(getattr(k, "key", getattr(k, "name", k))) for k in path]
    if keys[-1] in ("kernel", "scale"):
        keys[-1] = "weight"
    return ".".join(keys)


def _padded(sharding, ndim: int) -> tuple:
    spec = tuple(sharding.spec)
    return spec + (None,) * (ndim - len(spec))


def _jax_state(plan):
    """JAX's TrainState of shapes for small BC (pipelined over the plan's
    pipe dim) with an EMA, in the plan's regime; and the JAX mesh."""
    jax_mesh = jax_mesh_lib.make_mesh(**plan.axes_dict(),
                                      devices=jax.devices()[:plan.num_devices])
    model = JaxBC(use_flash=False, device_type="cpu", use_avg_model_params=True,
                  mesh=jax_mesh if plan.pipe > 1 else None, pipeline_stages=plan.pipe,
                  **SMALL)
    spec = jax_planner.ModelSpec.from_model(model, _batch(model))
    params = spec.param_shapes
    f32 = jax.numpy.float32
    if plan.regime() == "quant_zero2":
        layout = jax_collectives.FlatShardLayout(spec.n_params, plan.data,
                                                 plan.collective_block)
        flat = jax.ShapeDtypeStruct((layout.padded,), f32)
        state = JaxState(
            step=jax.ShapeDtypeStruct((), jax.numpy.int32), variables={"params": params},
            opt_state=jax.eval_shape(model.create_optimizer().init, flat), ema_params=flat,
            collective_residual={"grad": jax.ShapeDtypeStruct((plan.data, layout.padded), f32),
                                 "update": jax.ShapeDtypeStruct((layout.padded,), f32)})
    else:
        state = JaxState(step=jax.ShapeDtypeStruct((), jax.numpy.int32),
                         variables={"params": params}, opt_state=spec.opt_shapes,
                         ema_params=params)
    return state, jax_mesh


def _torch_shape(name: str, flax_shape, stacked: bool) -> tuple:
    lead, rest = (tuple(flax_shape[:1]), tuple(flax_shape[1:])) if stacked else (
        (), tuple(flax_shape))
    return lead + tuple(rest[j] for j in flax_dims(name, len(rest)))


def _to_flax(name: str, spec: tuple, stacked: bool) -> tuple:
    lead, rest = (spec[:1], spec[1:]) if stacked else ((), spec)
    out = [None] * len(rest)
    for i, j in enumerate(flax_dims(name, len(rest))):
        out[j] = rest[i]
    return tuple(lead) + tuple(out)


@pytest.mark.parametrize("name", jax_planner.preset_names())
def test_predicted_layout_matches_jax(name):
    """The port's state_shardings, in the flax layout, against JAX's on the
    preset's own mesh (8 devices for the DP family), every leaf sharding
    it can: param_min_shard_size 0 and the codecs' block BLOCK."""
    jax_plan = dataclasses.replace(jax_planner.resolve_preset(name, 8),
                                   param_min_shard_size=0, collective_block=BLOCK)
    plan = planner.ShardingPlan.from_json(jax_plan.to_json())
    state, jax_mesh = _jax_state(jax_plan)
    predicted = jax_plan.state_shardings(jax_mesh, state)
    params = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(state.variables["params"]):
        params[_jax_name(path)] = leaf.shape
    stacked = {n: plan.pipe > 1 and mesh_lib.is_stage_entry(n) for n in params}
    ours = plan.state_shardings({n: _torch_shape(n, s, stacked[n]) for n, s in params.items()},
                                ema=True)
    want = {}
    for path, sharding in jax.tree_util.tree_leaves_with_path(predicted.variables["params"]):
        want[f"params/{_jax_name(path)}"] = _padded(sharding, len(params[_jax_name(path)]))
    if plan.regime() == "quant_zero2":
        opt = [_padded(s, leaf.ndim) for s, leaf in zip(
            jax.tree_util.tree_leaves(predicted.opt_state),
            jax.tree_util.tree_leaves(state.opt_state)) if leaf.ndim]
        assert opt and all(s == opt[0] for s in opt)
        want["opt/flat"] = opt[0]
        want["ema/flat"] = _padded(predicted.ema_params, 1)
        want["residual/grad"] = _padded(predicted.collective_residual["grad"], 2)
        want["residual/update"] = _padded(predicted.collective_residual["update"], 1)
        got = {k: v if not k.startswith("params/") else _to_flax(k[7:], v, stacked[k[7:]])
               for k, v in ours.items()}
    else:
        for moment in ("mu", "nu"):
            adam = next(s for s in jax.tree_util.tree_leaves(
                predicted.opt_state, is_leaf=lambda s: hasattr(s, moment))
                if hasattr(s, moment))
            for path, sharding in jax.tree_util.tree_leaves_with_path(getattr(adam, moment)):
                key = f"opt/{_jax_name(path)}"
                spec = _padded(sharding, len(params[_jax_name(path)]))
                assert want.setdefault(key, spec) == spec
        for path, sharding in jax.tree_util.tree_leaves_with_path(predicted.ema_params):
            want[f"ema/{_jax_name(path)}"] = _padded(sharding, len(params[_jax_name(path)]))
        got = {k: _to_flax(k.partition("/")[2], v, stacked[k.partition("/")[2]])
               for k, v in ours.items()}
    assert got == want
    if plan.regime() == "zero2":
        assert any(any(e is not None and e != "pipe" for e in v) for k, v in got.items()
                   if k.startswith("opt/"))


# -- on the ranks ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights_and_batch():
    model = TransformerBCModel(device_type="cpu", **SMALL)
    weights = {k: v.numpy() for k, v in
               model.init_network(torch.Generator().manual_seed(0), "cpu").state_dict().items()}
    return weights, _flat(_batch(JaxBC(use_flash=False, device_type="cpu", **SMALL)))


@pytest.mark.parametrize("name,min_size", RANK_PLANS)
def test_plan_driven_step_is_the_hand_wired_step(world, weights_and_batch, name, min_size):
    weights, batch = weights_and_batch
    results = world.run(ranks.plan_step, name, min_size, BLOCK, SMALL, weights, batch)
    regime = planner.resolve_preset(name, 4).regime()
    for r in results:
        assert r["regime"] == r["hand_regime"] == regime
        assert r["audit"]["leaves"] > 0 and not r["audit"]["mismatches"], r["audit"]
        assert r["losses"] == r["hand_losses"]
        assert r["params_equal"] and r["opt_equal"] and r["ema_equal"]
        assert r["control"] > 0
        if regime == "zero2":
            assert r["sliced"]


def test_plan_driven_flat_update_on_a_pipe_mesh(world, weights_and_batch):
    """The flat optimizer update under dp_pp: its one vector a stage's
    (the audit's "opt/flat" and "ema/flat" over pipe), the step the
    hand-wired flat step bit for bit."""
    weights, batch = weights_and_batch
    for r in world.run(ranks.plan_step, "dp_pp", mesh_lib.MIN_WEIGHT_SIZE, BLOCK, SMALL,
                       weights, batch, flatten=True):
        assert r["regime"] == "replicated"
        assert r["audit"]["leaves"] > 0 and not r["audit"]["mismatches"], r["audit"]
        assert r["losses"] == r["hand_losses"]
        assert r["params_equal"] and r["opt_equal"] and r["ema_equal"]
        assert r["control"] > 0


def test_train_eval_model_under_a_preset_flag(world, tmp_path):
    """T2R_PLAN=dp_zero2 with no mesh and no plan argument: the trainer
    takes the preset's 4-rank data mesh and zero2 from the flag, trains
    and checkpoints; every rank's final eval agrees."""
    results = world.run(ranks.train_under_flag, SMALL, str(tmp_path),
                        {"T2R_PLAN": "dp_zero2"})
    for r in results:
        assert r["trainer"] == dict(plan="dp_zero2", regime="zero2",
                                    mesh=dict(mesh_lib.mesh_shape(None), data=4))
        assert r["step"] == 2 and r["final"] == results[0]["final"]


def test_what_a_plan_refuses(world):
    for r in world.run(ranks.refusals, SMALL):
        assert r["mesh"].startswith("ValueError: ") and "disagree" in r["mesh"]
        assert r["stages"].startswith("ValueError: ") and "pipeline_stages=1" in r["stages"]
        assert r["sequence"].startswith("ValueError: ") and "sequence" in r["sequence"]
        assert r["type"].startswith("TypeError: ") and "ShardingPlan" in r["type"]
        assert r["world"].startswith("ValueError: ") and "8 ranks" in r["world"]
        assert "4" in r["world"]
        # dp_zero2 stays exact under an ambient int8; the hand-wired
        # trainer takes the flag.
        assert r["codecs"] == (None, "fp8_e5m2", "int8", "zero2")


def test_quantized_checkpoint_restores_under_its_plan_only(world, weights_and_batch, tmp_path):
    weights, batch = weights_and_batch
    for r in world.run(ranks.quant_checkpoint, SMALL, weights, batch, str(tmp_path), BLOCK):
        assert r["step"] == 4 and r["same"]
        assert r["error"].startswith("ValueError: ")
