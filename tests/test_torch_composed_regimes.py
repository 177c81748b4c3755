"""Port parity: ZeRO-2 and sharded parameters composed with the sequence,
pipe and expert dims, ZeRO-2 over a product of replica dims, and the flat
optimizer update over a pipe dim.

One LocalWorld of 4 gloo ranks for the module, and one of 8 for the
data x sequence x pipe mesh; JAX's CompiledModel (GSPMD) on the
conftest's 8 CPU devices is the oracle, at small BC width (d_model 128,
so that its kernels, embed and second conv reach mesh.MIN_WEIGHT_SIZE and
shard; use_flash, the kernels' plain versions here, JAX's Pallas in
interpret mode):

  * the regime: train_eval._resolve_layout against JAX's CompiledModel
    (ShardingPlan.regime()) for the mesh and flag combinations it covers,
    data 1 x sequence 2 over ("sequence",) among them;
  * one step on each composed mesh against JAX's step on the same mesh
    from the same weights: zero2 on 2 data x 2 sequence over ("data",
    "sequence") and over ("data",), zero2 on 2 data x 2 pipe, sharded
    parameters on 2 fsdp x 2 sequence and on 2 fsdp x 2 pipe, the flat
    update on 2 data x 2 pipe (held to JAX's zero2 step there: the regimes
    change where the optimizer runs, not what it computes), and MoE BC
    (4 experts) in zero2 on 2 data x 2 expert and sharded on 2 fsdp x 2
    expert. The loss 1e-5 rel; Adam's moments and the parameters within
    JAX's own rtol=1e-5, atol=1e-6, a parameter also allowed what Adam's
    first step makes of the two sides' gradient difference
    (tests/test_torch_sharded_params.py has the rule). Every rank's
    parameter and moment bytes equal JAX's device 0 shard bytes of the
    placed state (the flat update's vector holds the rank's stage only,
    where JAX's flat vector is replicated: its bytes are not JAX's);
  * a control for each mechanism, which must fail: zero2's slice summed
    over the data ranks alone, sharded parameters' whole leaves averaged
    over data x fsdp alone, the stage entries left un-averaged;
  * JAX's dp_sp_pp (2 data x 2 sequence x 2 pipe over ("data",
    "sequence")) on 8 ranks against JAX's step, and 6 steps against its
    ("data",) twin within JAX's atol=1e-4 (tests/test_planner.py);
  * a composed checkpoint (zero2 over data x sequence) resumed in
    sharded_params on 2 fsdp x 2 sequence and in one process, and the
    flat update's pipe checkpoint resumed flat and per leaf, bit for bit;
  * clipping by a global norm on the composed meshes: zero2 over data x
    sequence against optax's clipped step on one device, and the clip
    factor over the fsdp x pipe and the flat pipe layouts.

The module runs in about two minutes on the CPU, most of it JAX's
compiles.
"""

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.data import input_generators as jax_generators
from tensor2robot_tpu.models import optimizers as jax_optimizers
from tensor2robot_tpu.models import transformer_models as jax_models
from tensor2robot_tpu.parallel import mesh as jax_mesh_lib
from tensor2robot_tpu.train.train_eval import CompiledModel
from tensor2robot_tpu.utils.mocks import MockT2RModel as JaxMock
from tensor2robot_tpu_torch.parallel import launch
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train import train_eval
from tensor2robot_tpu_torch.utils.jax_params import flax_params_to_state_dict
from tests import torch_composed_ranks as ranks

SMALL = dict(action_size=7, pose_size=14, episode_length=16, image_size=(16, 16),
             d_model=128, num_layers=2, num_heads=4, head_dim=32)
MOE = dict(num_experts=4)
RTOL, ATOL = 1e-5, 1e-6
LOSS_TOL = 1e-5
TWIN_ATOL = 1e-4
# The BC model's Adam (models/optimizers.py's defaults).
ADAM = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8)
# Below the small BC step's gradient norm (~5.3), so every clipped step clips.
CLIP = 1.0
DATA_SEQUENCE = (mesh_lib.DATA_AXIS, mesh_lib.SEQUENCE_AXIS)

# (data, fsdp, model, sequence, pipe, expert) meshes of 4 ranks.
DP_SP = (2, 1, 1, 2, 1, 1)
DP_PP = (2, 1, 1, 1, 2, 1)
FSDP_SP = (1, 2, 1, 2, 1, 1)
FSDP_PP = (1, 2, 1, 1, 2, 1)
DP_EP = (2, 1, 1, 1, 1, 2)
FSDP_EP = (1, 2, 1, 1, 1, 2)
DP_SP_PP = (2, 1, 1, 2, 2, 1)

# case -> (mesh, model kwargs, trainer kwargs, regime, the JAX run it is
# held to).
CASES = {
    "zero2_data_x_sequence": (DP_SP, {}, dict(shard_weight_update=True,
                                              weight_update_axes=DATA_SEQUENCE),
                              "zero2", "dp_sp"),
    "zero2_data_of_data_x_sequence": (DP_SP, {}, dict(shard_weight_update=True), "zero2",
                                      "dp_sp"),
    "zero2_data_x_pipe": (DP_PP, {}, dict(shard_weight_update=True), "zero2", "dp_pp"),
    "sharded_fsdp_x_sequence": (FSDP_SP, {}, {}, "sharded_params", "fsdp_sp"),
    "sharded_fsdp_x_pipe": (FSDP_PP, {}, {}, "sharded_params", "fsdp_pp"),
    "flat_data_x_pipe": (DP_PP, {}, dict(flatten_optimizer_update=True), "replicated",
                         "dp_pp"),
    "moe_zero2_data_x_expert": (DP_EP, MOE, dict(shard_weight_update=True), "zero2",
                                "moe_dp_ep"),
    "moe_sharded_fsdp_x_expert": (FSDP_EP, MOE, {}, "sharded_params", "moe_fsdp_ep"),
}
# JAX run -> (mesh, model kwargs, CompiledModel kwargs).
JAX_RUNS = {
    "dp_sp": (DP_SP, {}, dict(shard_weight_update=True, weight_update_axes=DATA_SEQUENCE)),
    "dp_pp": (DP_PP, {}, dict(shard_weight_update=True)),
    "fsdp_sp": (FSDP_SP, {}, {}),
    "fsdp_pp": (FSDP_PP, {}, {}),
    "moe_dp_ep": (DP_EP, MOE, dict(shard_weight_update=True)),
    "moe_fsdp_ep": (FSDP_EP, MOE, {}),
    "dp_sp_pp": (DP_SP_PP, {}, dict(shard_weight_update=True,
                                    weight_update_axes=DATA_SEQUENCE)),
}


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


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _torch_layout(params) -> dict:
    return {k: v.numpy() for k, v in flax_params_to_state_dict(params).items()}


def _jax_mesh(shape):
    return jax_mesh_lib.make_mesh(**dict(zip(mesh_lib.AXES, shape)),
                                  devices=jax.devices()[:int(np.prod(shape))])


def _jax_bc(jax_mesh=None, extra=None, clip=None):
    """Small BC in JAX over `jax_mesh` (pipelined over its pipe dim), its
    init jitted (an eager init of a mesh model takes tens of seconds)."""
    create = None
    if clip is not None:
        create = lambda: jax_optimizers.with_gradient_clipping(  # noqa: E731
            jax_optimizers.create_adam_optimizer(), max_global_norm=clip)
    pipes = 1 if jax_mesh is None else jax_mesh.shape[jax_mesh_lib.PIPE_AXIS]
    model = jax_models.TransformerBCModel(
        use_flash=True, interpret=True, device_type="cpu", create_optimizer_fn=create,
        mesh=jax_mesh, pipeline_stages=pipes, **(extra or {}), **SMALL)
    model.init_variables = jax.jit(model.init_variables)
    return model


def _adam_state(opt_state):
    """The ScaleByAdamState of an optax chain's state."""
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))


def _device0_bytes(tree) -> int:
    return sum(leaf.addressable_shards[0].data.nbytes
               for leaf in jax.tree_util.tree_leaves(tree))


def _jax_step(model, jax_mesh, batch, **kwargs):
    """JAX's CompiledModel step: the initial and stepped parameters, the
    loss, Adam's mu and nu (torch layouts, stacked stages), and the bytes
    of device 0's shards of the parameters and of the moments as
    init_state places them."""
    compiled = CompiledModel(model, mesh=jax_mesh, donate_state=False, **kwargs)
    state0 = compiled.init_state(jax.random.PRNGKey(0), batch)
    state1, metrics = compiled.train_step(state0, compiled.shard_batch(batch),
                                          jax.random.PRNGKey(1))
    adam, placed = _adam_state(state1.opt_state), _adam_state(state0.opt_state)
    return dict(initial=_torch_layout(_host(state0.params)),
                stepped=_torch_layout(_host(state1.params)),
                loss=float(metrics["loss"]), regime=compiled._layout.regime(),
                mu=_torch_layout(_host(adam.mu)), nu=_torch_layout(_host(adam.nu)),
                param_bytes=_device0_bytes(state0.params),
                opt_bytes=_device0_bytes((placed.mu, placed.nu)),
                mu_tree=_host(adam.mu), jax_mesh=jax_mesh)


def _placed_moment_bytes(mu_tree, jax_mesh, axes) -> int:
    """Device 0's bytes of Adam's two moments placed as JAX's zero2 regime
    places them over `axes` (mesh.weight_update_sharding under the stage
    rule, as CompiledModel.init_state's `place`)."""
    rule = jax_mesh_lib.pipe_stage_param_rule(
        jax_mesh, jax_mesh_lib.weight_update_sharding(jax_mesh, axes=axes))
    placed = jax.tree_util.tree_map_with_path(
        lambda path, x: jax.device_put(x, rule(path, x)), mu_tree)
    return 2 * _device0_bytes(placed)


@pytest.fixture(scope="module")
def batch():
    """One seeded batch of 4 episodes: JAX's, and flat for the ranks."""
    model = _jax_bc()
    generator = jax_generators.DefaultRandomInputGenerator(batch_size=4, seed=0)
    generator.set_specification_from_model(model, "train")
    jax_batch = next(iter(generator.create_dataset("train")))
    flat = {f"{part}/{key}": np.asarray(value) for part in ("features", "labels")
            for key, value in jax_batch[part].items()}
    return jax_batch, flat


@pytest.fixture(scope="module")
def gspmd(batch):
    """JAX's step on each mesh of JAX_RUNS, and its clipped step on one
    device."""
    runs = {name: _jax_step(_jax_bc(_jax_mesh(shape), extra), _jax_mesh(shape), batch[0],
                            **kwargs)
            for name, (shape, extra, kwargs) in JAX_RUNS.items()}
    runs["clipped"] = _jax_step(_jax_bc(clip=CLIP), _jax_mesh((1,) * 6), batch[0])
    return runs


def _adam_allowance(g_got, g_want):
    """What Adam's first step makes of two gradients' difference, element
    by element (module docstring)."""
    lr, eps = ADAM["lr"], ADAM["eps"]
    return np.abs(lr * g_got / (np.abs(g_got) + eps) - lr * g_want / (np.abs(g_want) + eps))


def _held(got: dict, want: dict, got_mu=None, want_mu=None) -> list:
    """The names of the leaves of `got` outside RTOL/ATOL of `want` (plus
    the Adam allowance where both first moments are given)."""
    failed = []
    for name, value in want.items():
        limit = ATOL + RTOL * np.abs(value)
        if got_mu is not None:
            limit = limit + _adam_allowance(got_mu[name] / (1 - ADAM["beta1"]),
                                            want_mu[name] / (1 - ADAM["beta1"]))
        if not (np.abs(got[name] - value) <= limit).all():
            failed.append(name)
    return failed


def _check_step(out: dict, want: dict) -> list:
    """What one rank's step breaks of the gate against JAX's: the loss,
    Adam's moments, the parameters."""
    failures = []
    if not abs(out["loss"] - want["loss"]) <= LOSS_TOL * abs(want["loss"]):
        failures.append(f"loss {out['loss']} vs {want['loss']}")
    mu = {n: m[0] for n, m in out["moments"].items()}
    nu = {n: m[1] for n, m in out["moments"].items()}
    failures += [f"mu {n}" for n in _held(mu, want["mu"])]
    failures += [f"nu {n}" for n in _held(nu, want["nu"])]
    failures += [f"param {n}" for n in _held(out["params"], want["stepped"], mu, want["mu"])]
    return failures


# -- the regime ---------------------------------------------------------------------


@pytest.mark.parametrize("shape,swu,axes,quant", [
    ((1, 1, 1, 2, 1, 1), True, (mesh_lib.SEQUENCE_AXIS,), "none"),
    ((1, 1, 1, 2, 1, 1), True, None, "none"),
    ((2, 1, 1, 2, 1, 1), True, DATA_SEQUENCE, "none"),
    ((2, 1, 1, 2, 1, 1), True, None, "none"),
    ((2, 1, 1, 2, 1, 1), False, DATA_SEQUENCE, "none"),
    ((2, 1, 1, 1, 2, 1), True, None, "int8"),
    ((2, 1, 1, 1, 1, 2), True, None, "none"),
    ((4, 1, 1, 1, 1, 1), True, DATA_SEQUENCE, "int8"),
    ((1, 2, 1, 2, 1, 1), True, DATA_SEQUENCE, "none"),
    ((1, 2, 1, 1, 2, 1), False, None, "int8"),
    ((2, 1, 1, 2, 2, 1), True, DATA_SEQUENCE, "none"),
    ((1, 1, 1, 1, 2, 1), True, (mesh_lib.PIPE_AXIS,), "none"),
], ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) and isinstance(x[0], int)
   else str(x))
def test_regime_resolves_as_jaxs(monkeypatch, shape, swu, axes, quant):
    """_resolve_layout distills JAX's ShardingPlan as CompiledModel builds
    it (the same plan document), and its regime() is JAX's: quant_zero2
    only on a pure data mesh, sharded_params over fsdp or model whatever
    else, zero2 where the weight-update group is above 1 (a data 1 x
    sequence 2 mesh over ("sequence",) included)."""
    compiled = CompiledModel(JaxMock(device_type="cpu"), mesh=_jax_mesh(shape),
                             donate_state=False, shard_weight_update=swu,
                             weight_update_axes=axes, collective_quant=quant)
    sizes = dict(zip(mesh_lib.AXES, shape))
    monkeypatch.setattr(mesh_lib, "mesh_shape", lambda mesh: sizes)
    layout, _ = train_eval._resolve_layout(
        object(), swu, False, quant, None,
        (mesh_lib.DATA_AXIS,) if axes is None else axes, mesh_lib.MIN_WEIGHT_SIZE)
    assert layout.regime() == compiled._layout.regime()
    assert layout.to_json() == compiled._layout.to_json()


def test_unknown_weight_update_axes_raise():
    with pytest.raises(ValueError, match="weight_update_axes"):
        train_eval._resolve_layout(None, True, False, "none", None, ("replica",),
                                   mesh_lib.MIN_WEIGHT_SIZE)


# -- one step on each composed mesh against JAX's --------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_composed_step_matches_jax_gspmd(world, gspmd, batch, case):
    shape, extra, kwargs, regime, run = CASES[case]
    want = gspmd[run]
    results = world.run(ranks.step, shape, dict(SMALL, use_flash=True, **extra),
                        want["initial"], batch[1], kwargs)
    for out in results:
        assert out["regime"] == regime
        assert _check_step(out, want) == []
    for out in results[1:]:
        for name, value in results[0]["params"].items():
            np.testing.assert_array_equal(out["params"][name], value)
    # Every rank holds exactly JAX's device 0 bytes: parameters, and
    # Adam's moments (the regime's JAX placement where the port's layout
    # is JAX's; the flat update's vector is this rank's stage only).
    if case == "flat_data_x_pipe":
        want_opt = 2 * results[0]["param_bytes"]
    elif case == "zero2_data_of_data_x_sequence":
        want_opt = _placed_moment_bytes(want["mu_tree"], want["jax_mesh"],
                                        (mesh_lib.DATA_AXIS,))
    else:
        assert want["regime"] == regime
        want_opt = want["opt_bytes"]
    for out in results:
        assert out["param_bytes"] == want["param_bytes"]
        assert out["opt_bytes"] == want_opt


@pytest.mark.parametrize("control,case", [
    ("slice_over_data", "zero2_data_x_sequence"),
    ("whole_over_data_fsdp", "sharded_fsdp_x_sequence"),
    ("stages_unaveraged", "zero2_data_x_pipe"),
    ("stages_unaveraged", "sharded_fsdp_x_pipe"),
])
def test_each_control_fails_the_gate(world, gspmd, batch, control, case):
    """Each mechanism of the composed step, broken: the gate catches it
    on Adam's moments (the gradients, without Adam's amplification)."""
    shape, extra, kwargs, _, run = CASES[case]
    results = world.run(ranks.step, shape, dict(SMALL, use_flash=True, **extra),
                        gspmd[run]["initial"], batch[1], kwargs, control)
    for out in results:
        failures = _check_step(out, gspmd[run])
        assert any(f.startswith("mu ") for f in failures), failures


# -- data x sequence x pipe on 8 ranks ------------------------------------------------


def test_dp_sp_pp_on_eight_ranks(gspmd, batch):
    """JAX's dp_sp_pp preset: one step against JAX's on the same 8-device
    mesh (its bytes too), and 6 steps against the ("data",) twin within
    JAX's atol=1e-4 (tests/test_planner.py's twin), learning."""
    want = gspmd["dp_sp_pp"]
    model = dict(SMALL, use_flash=True)
    kwargs = dict(shard_weight_update=True, weight_update_axes=DATA_SEQUENCE)
    twin = dict(shard_weight_update=True)
    with launch.LocalWorld(8, threads=1) as eight:
        results = eight.run(ranks.step, DP_SP_PP, model, want["initial"], batch[1], kwargs)
        runs = eight.run(ranks.step, DP_SP_PP, model, want["initial"], batch[1], kwargs,
                         None, None, 6)
        twins = eight.run(ranks.step, DP_SP_PP, model, want["initial"], batch[1], twin,
                          None, None, 6)
    for out in results:
        assert out["regime"] == want["regime"] == "zero2"
        assert _check_step(out, want) == []
        assert out["param_bytes"] == want["param_bytes"]
        assert out["opt_bytes"] == want["opt_bytes"]
    losses, twin_losses = runs[0]["losses"], twins[0]["losses"]
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, twin_losses, atol=TWIN_ATOL)
    assert twins[0]["opt_bytes"] > runs[0]["opt_bytes"]


# -- checkpoints ------------------------------------------------------------------------


def test_composed_checkpoint_resumes_on_another_mesh_and_in_one_process(
        world, gspmd, batch, tmp_path):
    """Two EMA steps in zero2 over data x sequence; rank 0's checkpoint
    (the replicated layout) restored in sharded_params on fsdp x sequence
    and by the one-device trainer: every parameter, Adam moment and EMA
    entry bit for bit."""
    model_dir = str(tmp_path)
    model = dict(SMALL, use_flash=True)
    results = world.run(ranks.resume_elsewhere, model, gspmd["dp_sp"]["initial"], batch[1],
                        model_dir)
    checkpoint = state_lib.load_checkpoint(model_dir)
    network = ranks.bc_model(model, None).create_network()
    names = [n for n, _ in network.named_parameters()]
    written = {names[i]: (e["exp_avg"].numpy(), e["exp_avg_sq"].numpy())
               for i, e in checkpoint["optimizer"]["state"].items()}
    for out in results:
        assert out["step"] == 2 and out["regimes"] == ("zero2", "sharded_params")
        assert out["layout"]
        for name in out["layout"]:
            assert out["shard_shapes"][name] != tuple(checkpoint["params"][name].shape)
        for name, value in checkpoint["params"].items():
            np.testing.assert_array_equal(out["params"][name], value.numpy())
        for name, value in checkpoint["ema_params"].items():
            np.testing.assert_array_equal(out["ema"][name], value.numpy())
        for name, (mu, nu) in written.items():
            np.testing.assert_array_equal(out["moments"][name][0], mu)
            np.testing.assert_array_equal(out["moments"][name][1], nu)
    trainer = train_eval.Trainer(ranks.bc_model(model, None, use_ema=True), device="cpu")
    state = train_eval.restore_or_init_state(model_dir, trainer)
    assert state.step == 2
    for name, value in state.network.state_dict().items():
        assert torch.equal(value, checkpoint["params"][name]), name
    for name, value in state.ema_params.items():
        assert torch.equal(value, checkpoint["ema_params"][name]), name
    restored = state.optimizer.state_dict()["state"]
    for name, (mu, nu) in written.items():
        entry = restored[names.index(name)]
        np.testing.assert_array_equal(entry["exp_avg"].numpy(), mu)
        np.testing.assert_array_equal(entry["exp_avg_sq"].numpy(), nu)


def test_flat_pipe_checkpoint_is_the_stacked_per_leaf_layout(world, gspmd, batch):
    """The flat update over data x pipe saves one entry a parameter with
    the stage entries stacked (its EMA a tree); a fresh flat trainer and a
    per-leaf one restore it and save it again bit for bit."""
    results = world.run(ranks.flat_pipe_checkpoint, dict(SMALL, use_flash=True),
                        gspmd["dp_pp"]["initial"], batch[1])
    stacked = {n for n, v in gspmd["dp_pp"]["initial"].items() if "pipe_stages" in n}
    for out in results:
        saved = out["saved"]
        assert not saved["ema_names"]
        assert stacked and stacked <= set(saved["ema"]) and stacked <= set(saved["moments"])
        for name in stacked:
            assert saved["ema"][name].shape == gspmd["dp_pp"]["initial"][name].shape
        for again in (out["flat"], out["leaf"]):
            for key in ("params", "ema"):
                for name, value in saved[key].items():
                    np.testing.assert_array_equal(again[key][name], value)
            for name, (mu, nu) in saved["moments"].items():
                np.testing.assert_array_equal(again["moments"][name][0], mu)
                np.testing.assert_array_equal(again["moments"][name][1], nu)


# -- clipping by a global norm -----------------------------------------------------------


def _norm(mu: dict) -> float:
    """The global norm of the gradient whose Adam first moment is `mu`."""
    return np.sqrt(sum(float(np.sum((m.astype(np.float64) / (1 - ADAM["beta1"])) ** 2))
                       for m in mu.values()))


@pytest.mark.parametrize("case", ["zero2_data_x_sequence", "sharded_fsdp_x_pipe",
                                  "flat_data_x_pipe"])
def test_clipping_by_a_global_norm_on_composed_meshes(world, gspmd, batch, case):
    """One step clipped to CLIP: the port's norm sums every cut leaf's
    squares over the dims that cut it once (zero2 slices over data x
    sequence, fsdp shards, pipe stages, the flat vector's stage runs), so
    the clip factor is CLIP over the global gradient's norm (from JAX's
    unclipped first moment on the mesh) and the same on every rank; over
    data x sequence the step is optax's clipped step on one device."""
    shape, extra, kwargs, regime, run = CASES[case]
    results = world.run(ranks.step, shape, dict(SMALL, use_flash=True, **extra),
                        gspmd[run]["initial"], batch[1], kwargs, None, CLIP)
    norm = _norm(gspmd[run]["mu"])
    for out in results:
        assert out["regime"] == regime
        assert out["clip_scale"] == results[0]["clip_scale"] < 1
        assert abs(out["clip_scale"] - CLIP / norm) <= 1e-5 * CLIP / norm
        if case == "zero2_data_x_sequence":
            assert _check_step(out, gspmd["clipped"]) == []
