"""Port parity: parameter sharding over fsdp and the model dim (the
sharded_params regime), with clipping by a global norm across shards and
stages.

One LocalWorld of 4 gloo ranks for the module; the JAX package on 4 CPU
devices is the oracle:

  * the rule: mesh.flax_param_spec against JAX's param_sharding on
    tests/test_train_eval.py's shapes and the HWIO tie, and
    mesh.param_dims through the dim map (utils/jax_params.flax_dims)
    against JAX's spec of every leaf of small BC and of the small critic;
  * one step of small BC (d_model 128, so that its kernels, its embed
    and its second conv reach mesh.MIN_WEIGHT_SIZE and shard; use_flash,
    the kernels' plain versions here, JAX's Pallas in interpret mode)
    against JAX's CompiledModel (GSPMD) on data x fsdp x model meshes
    (1, 2, 2), (2, 2, 1) and (2, 1, 2): the loss 1e-5 rel; Adam's
    moments and the parameters within JAX's own rtol=1e-5, atol=1e-6
    (tests/test_train_eval.py). A parameter is also allowed what Adam's
    first step, lr g / (|g| + eps), makes of the difference between the
    two sides' own gradients: where |g| is within rounding of eps (one to
    three elements of a leaf here, first moments ~1e-9) that step turns
    a rounding-sized gradient difference into up to lr. The moments hold
    the gradients without that amplification, so a gradient doubled over
    the model dim (the control: the output gather's backward left as
    all_gather's psum_scatter) fails them. Every rank's parameter and
    moment bytes equal JAX's per-device shard bytes exactly;
  * a 1 x 2 x 2 checkpoint (replicated layout) resumed on 2 x 2 x 1 and in
    one process, bit for bit;
  * clipping by a global norm (below the gradient's) in sharded_params,
    zero2 and over two pipe stages against JAX's clipped step on one
    device (optax.clip_by_global_norm), the clip factor below 1 and the
    same on every rank;
  * the regimes as JAX's CompiledModel resolves them, the quant_zero2
    clipping refusal (JAX's own limit), the refusal that names ROADMAP.md
    A9.4c (MAML on shards) and the compositions it no longer refuses;
    Megatron's collective pair.

The module runs in about a minute on the CPU.
"""

import flax.linen as flax_nn
import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.data import input_generators as jax_generators
from tensor2robot_tpu.models import optimizers as jax_optimizers
from tensor2robot_tpu.models import transformer_models as jax_models
from tensor2robot_tpu.parallel import mesh as jax_mesh_lib
from tensor2robot_tpu.research.qtopt.t2r_models import (
    Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom as JaxCritic,
)
from tensor2robot_tpu.specs import ExtendedTensorSpec as JaxSpec
from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct
from tensor2robot_tpu.train.train_eval import CompiledModel
from tensor2robot_tpu.utils.mocks import MockT2RModel as JaxMock
from tensor2robot_tpu_torch.parallel import launch
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.specs import make_random_numpy
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train import train_eval
from tensor2robot_tpu_torch.utils.jax_params import flax_dims, flax_params_to_state_dict
from tests import torch_sharded_ranks as ranks

SMALL = dict(action_size=7, pose_size=14, episode_length=16, image_size=(16, 16),
             d_model=128, num_layers=2, num_heads=4, head_dim=32)
PORT_SMALL = dict(SMALL, use_flash=True)
MESHES = [(1, 2, 2), (2, 2, 1), (2, 1, 2)]
RTOL, ATOL = 1e-5, 1e-6
LOSS_TOL = 1e-5
# The BC model's Adam (models/optimizers.py's defaults).
ADAM = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8)
# Below the small BC step's gradient norm (~5.3), so every clipped step clips.
CLIP = 1.0


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
    data, fsdp, model = shape
    return jax_mesh_lib.make_mesh(data=data, fsdp=fsdp, model=model,
                                  devices=jax.devices()[:data * fsdp * model])


def _jax_bc(clip=None):
    create = None
    if clip is not None:
        create = lambda: jax_optimizers.with_gradient_clipping(  # noqa: E731
            jax_optimizers.create_adam_optimizer(), max_global_norm=clip)
    return jax_models.TransformerBCModel(use_flash=True, interpret=True, device_type="cpu",
                                         create_optimizer_fn=create, **SMALL)


def _adam_state(opt_state):
    """The ScaleByAdamState of an optax chain's state."""
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))


def _jax_step(model, mesh, batch):
    """JAX's CompiledModel step: the initial and stepped parameters, the
    loss, Adam's mu and nu (torch layouts), and the bytes of device 0's
    shards of the parameters and of the moments as init_state places
    them."""
    compiled = CompiledModel(model, mesh=mesh, donate_state=False)
    state0 = compiled.init_state(jax.random.PRNGKey(0), batch)
    state1, metrics = compiled.train_step(state0, compiled.shard_batch(batch),
                                          jax.random.PRNGKey(1))
    adam, placed = _adam_state(state1.opt_state), _adam_state(state0.opt_state)

    def device0_bytes(tree):
        return sum(leaf.addressable_shards[0].data.nbytes
                   for leaf in jax.tree_util.tree_leaves(tree))

    # The bytes of init_state's placement (param_sharding's layout): the
    # jitted step leaves its outputs where GSPMD's propagation puts them,
    # which shards some small leaves too.
    return dict(initial=_torch_layout(_host(state0.params)),
                stepped=_torch_layout(_host(state1.params)),
                loss=float(metrics["loss"]),
                mu=_torch_layout(_host(adam.mu)), nu=_torch_layout(_host(adam.nu)),
                param_bytes=device0_bytes(state0.params),
                opt_bytes=device0_bytes((placed.mu, placed.nu)))


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
    """JAX's step on each mesh of MESHES, and its clipped step on one
    device."""
    runs = {shape: _jax_step(_jax_bc(), _jax_mesh(shape), batch[0]) for shape in MESHES}
    runs["clipped"] = _jax_step(_jax_bc(CLIP), _jax_mesh((1, 1, 1)), batch[0])
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


# -- the rule ---------------------------------------------------------------------------


def _jax_spec(sharding, ndim) -> list:
    """A NamedSharding's spec as flax_param_spec gives it ([] replicated)."""
    spec = list(sharding.spec) + [None] * (ndim - len(sharding.spec))
    return spec if any(s is not None for s in spec) else []


@pytest.mark.parametrize("fsdp,model,shape,min_size", [
    (1, 8, (64, 128), 16), (1, 8, (128,), 16), (1, 8, (2, 2), 16),
    (2, 4, (64, 128), 16), (2, 2, (3, 3, 64, 64), 2 ** 14),
    (2, 2, (3, 3, 32, 64), 2 ** 14), (4, 1, (3, 3, 64, 64), 2 ** 14),
    (2, 2, (16, 16), 2 ** 14), (2, 2, (142, 256), 2 ** 14),
    (4, 2, (1024, 256), 2 ** 14), (2, 2, (7, 100, 100), 16),
])
def test_rule_matches_jax_param_sharding(fsdp, model, shape, min_size):
    """flax_param_spec is JAX's param_sharding on a flax leaf: the shapes
    of tests/test_train_eval.py's TestParamSharding, and the HWIO tie
    (3x3x64x64: fsdp takes I, the first of the equal dims)."""
    jax_mesh = jax_mesh_lib.make_mesh(data=8 // (fsdp * model), fsdp=fsdp, model=model)
    want = jax_mesh_lib.param_sharding(jax_mesh, min_weight_size=min_size)(
        jax.ShapeDtypeStruct(shape, np.float32))
    assert mesh_lib.flax_param_spec(shape, fsdp, model, min_size) == _jax_spec(
        want, len(shape))


def _critic_shapes():
    from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
        Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom as Critic,
    )

    kwargs = dict(device_type="cpu", image_size=(96, 96), num_convs=(2, 2, 1))
    features = make_random_numpy(Critic(**kwargs).get_feature_specification("train"),
                                 batch_size=2, seed=0)
    model = JaxCritic(**kwargs)
    return jax.eval_shape(lambda: model.init_variables(
        jax.random.PRNGKey(0), JaxStruct(dict(features))))["params"]


def _bc_shapes():
    model = _jax_bc()
    generator = jax_generators.DefaultRandomInputGenerator(batch_size=2, seed=0)
    generator.set_specification_from_model(model, "train")
    features = next(iter(generator.create_dataset("train")))["features"]
    return jax.eval_shape(lambda: model.init_variables(jax.random.PRNGKey(0), features))[
        "params"]


@pytest.mark.parametrize("shape", MESHES + [(1, 1, 4), (1, 4, 1)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("family", ["bc", "critic"])
def test_rule_through_the_dim_map_on_every_leaf(family, shape):
    """param_dims of each torch entry, mapped back through flax_dims, is
    JAX's spec of its flax leaf, leaf for leaf."""
    params = _bc_shapes() if family == "bc" else _critic_shapes()
    jax_rule = jax_mesh_lib.param_sharding(_jax_mesh(shape))
    torch_leaves = flax_params_to_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), params))
    flax_leaves = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        keys = [entry.key for entry in path]
        last = "weight" if keys[-1] in ("kernel", "scale") else keys[-1]
        flax_leaves[".".join(keys[:-1] + [last])] = leaf
    assert set(flax_leaves) == set(torch_leaves)
    sharded = 0
    for name, tensor in torch_leaves.items():
        leaf = flax_leaves[name]
        want = _jax_spec(jax_rule(leaf), len(leaf.shape))
        model_dim, fsdp_dim = mesh_lib.param_dims(name, tensor.shape, shape[1], shape[2])
        got = [None] * len(leaf.shape)
        dims = flax_dims(name, tensor.ndim)
        if model_dim is not None:
            got[dims[model_dim]] = mesh_lib.MODEL_AXIS
        if fsdp_dim is not None:
            got[dims[fsdp_dim]] = mesh_lib.FSDP_AXIS
        assert (got if any(g is not None for g in got) else []) == want, name
        sharded += bool(want)
    assert sharded >= 4


def test_the_hwio_tie_takes_the_input_channels():
    """A 3x3x64x64 conv (torch OIHW): on 2 fsdp x 2 model, model takes O
    (torch dim 0) and fsdp the first of the equal remaining flax dims, I
    (torch dim 1); on fsdp alone fsdp takes I too, where a rule on the
    torch shape would take O. A Linear splits its output over model and
    its input over fsdp, a large bias over fsdp, the pos_embedding [T, E]
    E over model and T over fsdp; without a mesh nothing shards."""
    assert mesh_lib.param_dims("c.weight", (64, 64, 3, 3), 2, 2) == (0, 1)
    assert mesh_lib.param_dims("c.weight", (64, 64, 3, 3), 2, 1) == (None, 1)
    assert mesh_lib.param_dims("l.weight", (256, 142), 2, 2) == (0, 1)
    assert mesh_lib.param_dims("l.bias", (2 ** 15,), 2, 2) == (None, 0)
    assert mesh_lib.param_dims("e.pos_embedding", (1024, 256), 2, 2) == (1, 0)
    assert mesh_lib.param_sharding(None)("l.weight", torch.zeros(256, 256)) == (None, None)


# -- one step against JAX's GSPMD step -----------------------------------------------


def _ids(shape) -> str:
    return "x".join(map(str, shape))


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_sharded_step_matches_jax_gspmd(world, gspmd, batch, shape):
    want = gspmd[shape]
    results = world.run(ranks.bc_step, shape, PORT_SMALL, gspmd[MESHES[0]]["initial"],
                        batch[1])
    for out in results:
        assert out["regime"] == "sharded_params"
        assert _check_step(out, want) == []
    for out in results[1:]:
        for name, value in results[0]["params"].items():
            np.testing.assert_array_equal(out["params"][name], value)
    # Every rank holds exactly the parameter and Adam-moment bytes of
    # JAX's device 0 shards.
    for out in results:
        assert out["param_bytes"] == want["param_bytes"]
        assert out["opt_bytes"] == want["opt_bytes"]


class _WideJaxNetwork(flax_nn.Module):
    """tests/torch_sharded_ranks.py's _WideNetwork in flax."""

    @flax_nn.compact
    def __call__(self, features, mode: str):
        x = flax_nn.relu(flax_nn.Dense(4096)(features["x"]))
        out = JaxStruct()
        out["a_predicted"] = flax_nn.Dense(1)(x)
        return out


class _WideJaxMock(JaxMock):
    def create_network(self):
        return _WideJaxNetwork()

    def get_feature_specification(self, mode: str):
        spec = JaxStruct()
        spec["x"] = JaxSpec(shape=(ranks.WIDE_FEATURES,), dtype=np.float32,
                            name="measured_position")
        return spec


def test_a_kernel_cut_over_model_alone_averages_over_fsdp(world):
    """A Dense from 7 inputs to 4096 (flax [7, 4096]) on 1 x 2 x 2: model
    takes its 4096 outputs and fsdp divides no other dim, so it gets no
    fsdp gather and its gradient covers this rank's batch shard only. The
    step averages it over the data x fsdp shards, as GSPMD sums it over
    fsdp: the loss, Adam's moments and the parameters meet JAX's step."""
    shape = (1, 2, 2)
    model = _WideJaxMock(device_type="cpu")
    generator = jax_generators.DefaultRandomInputGenerator(batch_size=8, seed=0)
    generator.set_specification_from_model(model, "train")
    jax_batch = next(iter(generator.create_dataset("train")))
    flat = {f"{part}/{key}": np.asarray(value) for part in ("features", "labels")
            for key, value in jax_batch[part].items()}
    want = _jax_step(model, _jax_mesh(shape), jax_batch)
    results = world.run(ranks.wide_step, shape, want["initial"], flat)
    for out in results:
        assert out["layout"] == {"Dense_0.weight": (0, None)}
        assert _check_step(out, want) == []
        assert out["param_bytes"] == want["param_bytes"]


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_layout_shards_what_jax_shards(world, gspmd, shape):
    """shard_network's layout names every leaf whose JAX shard is smaller
    than the leaf, each rank's shard shapes multiply out to JAX's
    device 0 bytes, and the rank holds less than the whole model."""
    results = world.run(ranks.layout_of, shape, PORT_SMALL)
    full = {n: v.size for n, v in gspmd[shape]["initial"].items()}
    for out in results:
        local = sum(int(np.prod(s)) for s in out["shapes"].values())
        assert 4 * local == gspmd[shape]["param_bytes"]
        assert local < sum(full.values())
        assert {n for n, s in out["shapes"].items() if int(np.prod(s)) < full[n]} == set(
            out["layout"])


def test_a_doubled_model_gradient_fails_the_gate(world, gspmd, batch):
    """The control: the column split's output gather with all_gather's
    backward (psum_scatter over model) sums the model ranks' equal
    cotangents, and the step fails the gate on Adam's moments."""
    shape = (1, 2, 2)
    results = world.run(ranks.bc_step, shape, PORT_SMALL, gspmd[shape]["initial"], batch[1],
                        True)
    for out in results:
        failures = _check_step(out, gspmd[shape])
        assert any(f.startswith("mu ") for f in failures), failures


# -- checkpoints ----------------------------------------------------------------------


def test_checkpoint_resumes_on_another_mesh_and_in_one_process(world, gspmd, batch,
                                                              tmp_path):
    """Two EMA steps on 1 x 2 x 2, rank 0's checkpoint (the replicated
    layout), restored on 2 x 2 x 1 and by the one-device trainer: every
    parameter, Adam moment and EMA entry bit for bit."""
    model_dir = str(tmp_path)
    results = world.run(ranks.resume_elsewhere, PORT_SMALL, gspmd[MESHES[0]]["initial"],
                        batch[1], model_dir)
    checkpoint = state_lib.load_checkpoint(model_dir)
    names = [n for n, _ in ranks.bc_model(PORT_SMALL).create_network().named_parameters()]
    written = {names[i]: (e["exp_avg"].numpy(), e["exp_avg_sq"].numpy())
               for i, e in checkpoint["optimizer"]["state"].items()}
    for out in results:
        assert out["step"] == 2 and out["layout"]
        for name in out["layout"]:
            assert out["shard_shapes"][name] != tuple(checkpoint["params"][name].shape)
        for name, value in checkpoint["params"].items():
            np.testing.assert_array_equal(out["params"][name], value.numpy())
        for name, value in checkpoint["ema_params"].items():
            np.testing.assert_array_equal(out["ema"][name], value.numpy())
        for name, (mu, nu) in written.items():
            np.testing.assert_array_equal(out["moments"][name][0], mu)
            np.testing.assert_array_equal(out["moments"][name][1], nu)
    trainer = train_eval.Trainer(ranks.bc_model(PORT_SMALL, use_ema=True), device="cpu")
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


# -- clipping by a global norm ----------------------------------------------------------


@pytest.mark.parametrize("regime", ["sharded_params", "zero2", "pipe"])
def test_clipping_by_a_global_norm_matches_optax(world, gspmd, batch, regime):
    """One step clipped to CLIP against JAX's on one device: the port's
    norm sums every shard's squares (fsdp x model shards, zero2 slices
    over data, pipe stages), so its clip factor is CLIP over the global
    gradient's norm (from JAX's unclipped first moment) on every rank and
    the step is optax's."""
    want = gspmd["clipped"]
    weights = gspmd[MESHES[0]]["initial"]
    if regime == "pipe":
        results = world.run(ranks.pipe_clip_step, PORT_SMALL, weights, batch[1], CLIP)
    else:
        shape, kwargs = ((1, 2, 2), {}) if regime == "sharded_params" else (
            (4, 1, 1), dict(shard_weight_update=True))
        results = world.run(ranks.bc_step, shape, PORT_SMALL, weights, batch[1], False,
                            CLIP, kwargs)
    norm = np.sqrt(sum(float(np.sum((m.astype(np.float64) / (1 - ADAM["beta1"])) ** 2))
                       for m in gspmd[MESHES[0]]["mu"].values()))
    for out in results:
        assert out["regime"] == {"pipe": "replicated"}.get(regime, regime)
        assert out["clip_scale"] == results[0]["clip_scale"] < 1
        assert abs(out["clip_scale"] - CLIP / norm) <= 1e-5 * CLIP / norm
        assert abs(out["loss"] - want["loss"]) <= LOSS_TOL * abs(want["loss"])
        if regime == "pipe":
            # Adam's first step on the clipped gradient, g/|g| where |g|
            # >> eps: held within one step size where its moments are
            # not returned (tests/test_torch_pipelined_bc.py's rule).
            for name, value in want["stepped"].items():
                assert np.abs(out["params"][name] - value).max() <= ADAM["lr"], name
        else:
            assert _check_step(out, want) == []


# -- regimes and refusals ---------------------------------------------------------------


@pytest.fixture(scope="module")
def refusals(world):
    return world.run(ranks.refusals)


def _jax_regime(shape, shard_weight_update, collective_quant):
    compiled = CompiledModel(JaxMock(device_type="cpu"), mesh=_jax_mesh(shape),
                             donate_state=False, shard_weight_update=shard_weight_update,
                             collective_quant=collective_quant)
    return compiled._layout.regime()


@pytest.mark.parametrize("case,shape,swu,quant", [
    ("fsdp_model_with_zero2_flag", (1, 2, 2), True, "none"),
    ("fsdp_model_with_a_codec", (1, 2, 2), True, "int8"),
    ("data_with_a_codec", (4, 1, 1), True, "int8"),
    ("data_with_zero2", (4, 1, 1), True, "none"),
    ("data", (4, 1, 1), False, "none"),
])
def test_regimes_resolve_as_jaxs(refusals, case, shape, swu, quant):
    want = _jax_regime(shape, swu, quant)
    for out in refusals:
        assert out["regimes"][case] == want


def test_clipping_with_quantized_collectives_is_jaxs_limit(refusals):
    for out in refusals:
        message = out["errors"]["clipping_quant_zero2"]
        assert message.startswith("NotImplementedError: ")
        assert "unsupported with quantized collectives" in message
        assert "ROADMAP" not in message


# The pins A9.4c lifted, with the regime each resolves (None: an encoder,
# no trainer): part 1's compositions (tests/test_torch_composed_regimes.py
# holds their steps to JAX's) and part 2's MAML on shards
# (tests/test_torch_maml_sharded.py).
LIFTED = {"sharded_params_with_pipe": None, "trainer_on_fsdp_x_pipe": "sharded_params",
          "zero2_with_pipe": "zero2", "maml_on_fsdp": "sharded_params"}


@pytest.mark.parametrize("case", ["sharded_params_with_pipe", "trainer_on_fsdp_x_pipe",
                                  "zero2_with_pipe", "maml_on_fsdp"])
def test_what_stays_refused_names_a9_4c(refusals, case):
    """The cases once refused here, naming A9.4c (a pipelined encoder on
    fsdp x pipe, a trainer on it, zero2 on data x pipe, and MAML on fsdp x
    model), now build, in JAX's regimes (LIFTED)."""
    for out in refusals:
        assert case in LIFTED
        assert out["errors"][case] == ""
        assert out["regimes"].get(case) == LIFTED[case]


def test_the_flat_update_keeps_jaxs_value_error(refusals):
    for out in refusals:
        assert out["errors"]["flat_on_fsdp"].startswith("ValueError: ")
        assert "flatten_optimizer_update" in out["errors"]["flat_on_fsdp"]


def test_megatrons_pair_over_the_model_dim(world):
    """gather_from: every model rank's x along dim 1, its cotangent this
    rank's slice (not the model ranks' sum); copy_to: x as it is, its
    cotangent summed over model; psum_dims over fsdp x model."""
    results = world.run(ranks.collective_pair, (1, 2, 2))
    weight = np.arange(12, dtype=np.float32).reshape(2, 6)
    for rank, out in enumerate(results):
        np.testing.assert_array_equal(out["y"], np.concatenate(
            [np.full((2, 3), 1.0), np.full((2, 3), 2.0)], axis=1))
        index = out["index"]
        np.testing.assert_array_equal(out["x_grad"], weight[:, 3 * index:3 * index + 3])
        np.testing.assert_array_equal(out["z_grad"], np.full(3, 3.0))
        assert out["total"] == 6.0
