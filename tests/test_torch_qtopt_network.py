"""The port's QT-Opt critic pieces against the JAX package's.

tensor2robot_tpu_torch/research/qtopt/{networks,t2r_models,
optimizer_builder}.py, models/base_models.py and the bf16 wrappers
(models/tpu_model_wrapper.py, preprocessors/dtype_policy.py) vs their
tensor2robot_tpu counterparts, at 96x96 with num_convs=(2, 2, 1): the
Grasping44 forward in train mode (with its batch-statistics update) and
eval mode, flat and CEM-tiled, from the JAX init converted by
utils/jax_params.py; the bf16 autocast forward against the JAX f32 one
within the JAX bf16 test's 0.02; the critic's specs, preprocessor, loss
and learning rate. Inputs come from numpy seeds and cross as numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensor2robot_tpu.models import base_models as jax_base
from tensor2robot_tpu.research.qtopt import networks as jax_networks
from tensor2robot_tpu.research.qtopt import optimizer_builder as jax_opt
from tensor2robot_tpu.research.qtopt import t2r_models as jax_models
from tensor2robot_tpu_torch.models import base_models
from tensor2robot_tpu_torch.models.tpu_model_wrapper import BFloat16ModelWrapper
from tensor2robot_tpu_torch.research.qtopt import networks, optimizer_builder
from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
    Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom as Critic,
)
from tensor2robot_tpu_torch.specs import make_random_numpy
from tensor2robot_tpu_torch.utils import jax_params

# The train-step tolerance of tests/test_torch_qtopt.py, for one forward.
ATOL, RTOL = 1e-5, 1e-4
# The JAX package's own bf16-vs-f32 gate (tests/test_qtopt.py).
BF16_TOL = 0.02
SIZE = (96, 96)
CONVS = (2, 2, 1)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _inputs(batch=3, actions=None, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.rand(batch, *SIZE, 3).astype(np.float32)
    shape = (batch, 10) if actions is None else (batch, actions, 10)
    return images, rng.randn(*shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_tower():
    net = jax_networks.Grasping44(
        grasp_param_blocks=jax_networks.E2E_GRASP_PARAM_BLOCKS, num_convs=CONVS
    )
    images, params = _inputs()
    variables = net.init(jax.random.PRNGKey(0), jnp.asarray(images),
                         jnp.asarray(params), is_training=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    # One train-mode pass, so the running statistics are not the init's.
    _, mutated = net.apply(variables, *map(jnp.asarray, _inputs(seed=9)),
                           is_training=True, mutable=["batch_stats"])
    variables = {"params": variables["params"],
                 "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                       mutated["batch_stats"])}
    return net, variables


def _port_tower(variables):
    tower = networks.Grasping44(
        grasp_param_blocks=networks.E2E_GRASP_PARAM_BLOCKS, num_convs=CONVS,
        image_size=SIZE,
    )
    jax_params.load_flax_variables(tower, variables)
    return tower


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want),
                               rtol=rtol, atol=atol)


class TestGrasping44:
    @pytest.mark.parametrize("actions", [None, 4], ids=["flat", "cem_tiled"])
    @pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
    def test_forward_matches_jax(self, jax_tower, actions, training):
        net, variables = jax_tower
        images, params = _inputs(actions=actions, seed=1)
        kw = dict(is_training=training)
        if training:
            (want_logits, want_ep), mutated = net.apply(
                variables, jnp.asarray(images), jnp.asarray(params),
                mutable=["batch_stats"], **kw)
        else:
            want_logits, want_ep = net.apply(
                variables, jnp.asarray(images), jnp.asarray(params), **kw)
        tower = _port_tower(variables)
        with torch.no_grad():
            logits, ep = tower(torch.from_numpy(images), torch.from_numpy(params), **kw)
        _close(logits, want_logits)
        assert ep["predictions"].shape == want_ep["predictions"].shape
        _close(ep["predictions"], want_ep["predictions"])
        # Inner activations: a train-mode batch norm over few samples per
        # channel (12 at the final conv) scales rounding by 1 / std, so
        # these are held as the train-step state is, to 1e-4 of their
        # largest magnitude + 1e-6.
        for name in ("pool2", "fcgrasp", "final_conv"):
            want = np.asarray(want_ep[name])
            got = ep[name].numpy()
            if got.ndim == 4:
                got = np.moveaxis(got, 1, -1)
            _close(got, want, atol=1e-4 * np.abs(want).max() + 1e-6, rtol=0)
        if training:
            new = jax_params.flax_variables_to_state_dict(
                {"batch_stats": mutated["batch_stats"]})
            own = tower.state_dict()
            assert new.keys() <= own.keys() and len(new) == 2 * 10
            for key, value in new.items():
                _close(own[key], value, atol=1e-6, rtol=1e-5)

    def test_bf16_autocast_forward_matches_f32(self, jax_tower):
        """The JAX package's bf16 gate: bf16 predictions within 0.02 of the
        f32 ones on the same parameters, and an f32 logit head."""
        net, variables = jax_tower
        images, params = _inputs(batch=2, seed=2)
        _, want = net.apply(variables, jnp.asarray(images), jnp.asarray(params),
                            is_training=False)
        tower = _port_tower(variables)
        with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
            logits, ep = tower(torch.from_numpy(images).bfloat16(),
                               torch.from_numpy(params).bfloat16())
        assert logits.dtype == torch.float32
        assert ep["pool2"].dtype == torch.bfloat16
        assert tower.conv1_1.weight.dtype == torch.float32
        _close(ep["predictions"], want["predictions"], atol=BF16_TOL, rtol=0)

    def test_stem_s2d_raises_naming_its_item(self, monkeypatch):
        """T2R_STEM_S2D=1 builds the space-to-depth stem (A11 is ported and
        nothing raises); 0 and auto build the plain strided stem. Both hold
        the same `conv1_1.weight`."""
        from tensor2robot_tpu_torch.layers.s2d_conv import SpaceToDepthConv

        stems = {}
        for mode in ("1", "0", "auto"):
            monkeypatch.setenv("T2R_STEM_S2D", mode)
            stems[mode] = networks.Grasping44(image_size=SIZE, num_convs=CONVS).conv1_1
        assert isinstance(stems["1"], SpaceToDepthConv)
        for mode in ("0", "auto"):
            assert isinstance(stems[mode], networks._Conv)
            assert not isinstance(stems[mode], SpaceToDepthConv)
            assert stems[mode].weight.shape == stems["1"].weight.shape

    def test_converter_names_every_unmatched_key(self, jax_tower):
        _, variables = jax_tower
        params = dict(variables["params"])
        params.pop("fc1")
        tower = networks.Grasping44(image_size=SIZE, num_convs=CONVS,
                                    grasp_param_blocks=networks.E2E_GRASP_PARAM_BLOCKS)
        with pytest.raises(ValueError) as err:
            jax_params.load_flax_variables(
                tower, {"params": {**params, "extra": {"kernel": np.zeros((2, 2))}},
                        "batch_stats": variables["batch_stats"]})
        message = str(err.value)
        for key in ("not in the network: extra.weight",
                    "not in the variables: fc1.weight",
                    "not in the variables: fc1.bias"):
            assert key in message
        with pytest.raises(ValueError, match="collections"):
            jax_params.flax_variables_to_state_dict({"params": {}, "cache": {}})

    def test_concat_e2e_grasp_params_layout(self):
        rng = np.random.RandomState(3)
        action = {k: rng.randn(2, n).astype(np.float32) for k, n in zip(
            networks.E2E_ACTION_KEYS, (3, 2, 1, 1, 1, 1, 1))}
        got = networks.concat_e2e_grasp_params(
            {k: torch.from_numpy(v) for k, v in action.items()})
        want = jax_networks.concat_e2e_grasp_params(
            {k: jnp.asarray(v) for k, v in action.items()})
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_flatten_is_nhwc_so_fc0_is_the_jax_kernel(self, jax_tower):
        _, variables = jax_tower
        tower = _port_tower(variables)
        np.testing.assert_array_equal(
            tower.fc0.weight.detach().numpy(),
            np.asarray(variables["params"]["fc0"]["kernel"]).T)
        # 96 -> 48 -> 16 -> 6 -> 3, one VALID conv: 1x1; 472 -> 236 -> 79
        # -> 27 -> 14, three VALID convs: 8x8.
        assert networks.final_conv_area(SIZE, CONVS) == 1
        assert networks.final_conv_area((472, 472), (6, 6, 3)) == 8 * 8


class TestCriticModel:
    def test_specs_match_jax(self):
        for kw in (dict(), dict(action_batch_size=4)):
            port, ref = Critic(**kw), jax_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(device_type="cpu", **kw)
            for mode in ("train", "eval", "predict"):
                for getter in ("get_feature_specification", "get_label_specification"):
                    mine = getattr(port, getter)(mode)
                    theirs = getattr(ref, getter)(mode)
                    assert list(mine.keys()) == list(theirs.keys())
                    for key in mine.keys():
                        assert mine[key].shape == theirs[key].shape, key
                        assert mine[key].name == theirs[key].name, key
            packing = port.get_feature_specification_for_packing("predict")
            assert list(packing.keys()) == ["state/image"]
        in_spec = Critic().preprocessor.get_in_feature_specification("train")
        assert in_spec["state/image"].shape == (512, 640, 3)
        assert in_spec["state/image"].dtype == torch.uint8
        assert in_spec["state/image"].data_format == "jpeg"

    def test_eval_preprocess_is_the_jax_center_crop(self):
        port = Critic(image_size=SIZE, num_convs=CONVS)
        ref = jax_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
            device_type="cpu", image_size=SIZE, num_convs=CONVS)
        features = make_random_numpy(
            port.preprocessor.get_in_feature_specification("eval"), batch_size=2)
        want, _ = ref.preprocessor.preprocess(dict(features.items()), None, mode="eval")
        got, _ = port.preprocessor.preprocess(
            {k: torch.from_numpy(v) for k, v in features.items()}, None, mode="eval")
        assert got["state/image"].shape == (2, 96, 96, 3)
        np.testing.assert_array_equal(got["state/image"].numpy(),
                                      np.asarray(want["state/image"]))
        # A train-mode preprocess without a generator is the center crop too.
        same, _ = port.preprocessor.preprocess(
            {k: torch.from_numpy(v) for k, v in features.items()}, None, mode="train")
        assert torch.equal(same["state/image"], got["state/image"])

    def test_train_preprocess_at_full_width(self):
        pre = Critic().preprocessor
        features = make_random_numpy(pre.get_in_feature_specification("train"),
                                     batch_size=2)
        out, _ = pre.preprocess({k: torch.from_numpy(v) for k, v in features.items()},
                                None, mode="train",
                                generator=torch.Generator().manual_seed(0))
        image = out["state/image"]
        assert image.shape == (2, 472, 472, 3) and image.dtype == torch.float32
        assert 0.0 <= image.min() and image.max() <= 1.0

    def test_loss_and_eval_metrics_match_jax(self):
        rng = np.random.RandomState(4)
        q = rng.randn(6).astype(np.float32) * 3
        reward = (rng.rand(6, 1) > 0.5).astype(np.float32)
        port, ref = Critic(image_size=SIZE, num_convs=CONVS), jax_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(device_type="cpu", image_size=SIZE, num_convs=CONVS)
        loss, _ = port.model_train_fn(None, {"reward": torch.from_numpy(reward)},
                                      {"q_predicted": torch.from_numpy(q)}, "train")
        want, _ = ref.model_train_fn(None, {"reward": jnp.asarray(reward)},
                                     {"q_predicted": jnp.asarray(q)}, "train")
        _close(loss, want, atol=1e-7, rtol=1e-6)
        got = port.model_eval_fn(None, {"reward": torch.from_numpy(reward)},
                                 {"q_predicted": torch.from_numpy(q)})
        want = ref.model_eval_fn(None, {"reward": jnp.asarray(reward)},
                                 {"q_predicted": jnp.asarray(q)})
        assert got.keys() == want.keys()
        for key in got:
            _close(got[key], want[key], atol=1e-7, rtol=1e-6)

    def test_classification_and_regression_losses_match_jax(self):
        rng = np.random.RandomState(5)
        logits = rng.randn(5, 3).astype(np.float32) * 4
        targets = (rng.rand(5, 3) > 0.4).astype(np.float32)
        got = base_models.sigmoid_binary_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(targets))
        _close(got, optax.sigmoid_binary_cross_entropy(logits, targets),
               atol=1e-6, rtol=1e-6)

        class _Cls(base_models.ClassificationModel):
            def get_feature_specification(self, mode): ...
            def get_label_specification(self, mode): ...
            def create_network(self): ...

        class _JaxCls(jax_base.ClassificationModel):
            def get_feature_specification(self, mode): ...
            def get_label_specification(self, mode): ...
            def create_network(self): ...

        got = _Cls().model_eval_fn(None, {"a_target": torch.from_numpy(targets)},
                                   {"a_predicted": torch.from_numpy(logits)})
        want = _JaxCls(device_type="cpu").model_eval_fn(
            None, {"a_target": jnp.asarray(targets)},
            {"a_predicted": jnp.asarray(logits)})
        for key in want:
            _close(got[key], want[key], atol=1e-6, rtol=1e-6)

    def test_tile_actions_for_cem_matches_jax(self):
        rng = np.random.RandomState(6)
        state = {"image": rng.rand(2, 4, 4, 3).astype(np.float32)}
        actions = rng.randn(2, 5, 10).astype(np.float32)
        tiled, flat = base_models.tile_actions_for_cem(
            {k: torch.from_numpy(v) for k, v in state.items()}, torch.from_numpy(actions))
        want_tiled, want_flat = jax_base.tile_actions_for_cem(
            {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(actions))
        np.testing.assert_array_equal(flat.numpy(), np.asarray(want_flat))
        np.testing.assert_array_equal(tiled["image"].numpy(),
                                      np.asarray(want_tiled["image"]))


class TestOptimizerBuilder:
    def test_learning_rate_staircase_matches_optax(self):
        for hparams in (dict(), dict(batch_size=64, examples_per_epoch=6400,
                                     learning_rate_decay_factor=0.5)):
            mine = optimizer_builder.build_learning_rate(
                optimizer_builder.QtOptHParams(**hparams))
            theirs = jax_opt.build_learning_rate(jax_opt.QtOptHParams(**hparams))
            for count in (0, 1, 199, 200, 201, 187_499, 187_500, 400_000):
                # optax's f32 underflows to 0 where Python's double
                # does not (0.5 ** 2000).
                np.testing.assert_allclose(mine(count), float(theirs(count)),
                                           rtol=1e-6, atol=1e-30)

    @pytest.mark.parametrize("name", ["momentum", "rmsprop", "adam"])
    def test_build_opt_steps_like_optax(self, name):
        hp = dict(optimizer=name, learning_rate=0.1)
        rng = np.random.RandomState(7)
        init = rng.randn(4).astype(np.float32)
        grads = [rng.randn(4).astype(np.float32) for _ in range(3)]
        opt = jax_opt.build_opt(jax_opt.QtOptHParams(**hp))
        params = jnp.asarray(init)
        state = opt.init(params)
        for g in grads:
            updates, state = opt.update(jnp.asarray(g), state, params)
            params = optax.apply_updates(params, updates)
        p = torch.nn.Parameter(torch.from_numpy(init.copy()))
        bound = optimizer_builder.build_opt(optimizer_builder.QtOptHParams(**hp))([p])
        for g in grads:
            p.grad = torch.from_numpy(g)
            bound.step()
        _close(p.detach(), params, atol=1e-6, rtol=1e-5)

    def test_unknown_optimizer_raises(self):
        with pytest.raises(ValueError, match="Unknown optimizer"):
            optimizer_builder.build_opt(optimizer_builder.QtOptHParams(optimizer="sgd"))


class TestBFloat16Wrapper:
    def test_specs_preprocess_and_outputs(self, jax_tower):
        _, variables = jax_tower
        wrapped = BFloat16ModelWrapper(Critic(image_size=SIZE, num_convs=CONVS))
        assert wrapped.get_feature_specification("train")["state/image"].dtype == torch.bfloat16
        in_spec = wrapped.preprocessor.get_in_feature_specification("eval")
        assert in_spec["state/image"].dtype == torch.uint8
        features = make_random_numpy(in_spec, batch_size=2, seed=3)
        features, _ = wrapped.preprocessor.preprocess(
            {k: torch.from_numpy(v) for k, v in features.items()}, None, mode="eval")
        assert features["state/image"].dtype == torch.bfloat16
        network = wrapped.create_network()
        jax_params.load_flax_variables(network.grasping44, variables)
        assert network.grasping44.conv1_1.weight.dtype == torch.float32
        with torch.no_grad():
            _, _, outputs, _ = wrapped.packed_inference(network, features, "eval")
        export = wrapped.create_export_outputs_fn(features, outputs)
        assert export["q_predicted"].dtype == torch.float32
        f32 = Critic(image_size=SIZE, num_convs=CONVS)
        with torch.no_grad():
            _, _, ref, _ = f32.packed_inference(
                network, {k: v.float() for k, v in features.items()}, "eval")
        _close(export["q_probability"], ref["q_probability"], atol=BF16_TOL, rtol=0)
