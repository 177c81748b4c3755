"""The port's meta_learning/ against the JAX package's.

  * meta_tfdata's reshapes, the MAML and MetaExample specs, and
    MAMLPreprocessorV2 / FixedLenMetaExamplePreprocessor over the pose
    regression preprocessor: the same structures, names, shapes and dtypes,
    and the same values exactly.
  * The inner loop on the JAX tests' quadratic fixture (minimize
    (x * 0.25)^2 from x = 2), in the four {learn_inner_lr} x
    {use_second_order} cases: inner losses, adapted parameters and outputs
    within 1e-5 abs + rel; the outer gradient, the inner-rate leaves
    included, within 1e-4 * max|g| + 1e-7 of its leaf. var_scope leaves the
    other parameters at their values.
  * MAML over the mock model (JAX's variables through utils/jax_params.py,
    inner rates learned, with batch norm, and with var_scope selecting
    one layer by its flax path): every prediction, the loss and each
    gradient.
  * The four meta policies over one fake predictor: the same actions as
    JAX's before and after adapt().
  * make_meta_example over the port's Example bytes: the JAX package's
    protobuf parses them into the message JAX's make_meta_example builds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu import meta_learning as jax_meta
from tensor2robot_tpu.research import pose_env as jax_pose_env
from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct
from tensor2robot_tpu.utils import mocks as jax_mocks
from tensor2robot_tpu_torch import meta_learning
from tensor2robot_tpu_torch.meta_learning import meta_tfdata
from tensor2robot_tpu_torch.research import pose_env
from tensor2robot_tpu_torch.specs import TensorSpecStruct, flatten_spec_structure
from tensor2robot_tpu_torch.utils import jax_params, mocks

TOL = 1e-5
GRAD_TOL = 1e-4
LEARNING_RATE = 0.001
COEFF_A_VALUE = 0.25
X_INIT = 2.0


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _numpy(structure):
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in flatten_spec_structure(structure).items()}


def _assert_same_tree(got, want, exact=True):
    got, want = _numpy(got), {k: np.asarray(v) for k, v in want.items()}
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].shape == value.shape and got[key].dtype == value.dtype, key
        if exact:
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], value, atol=TOL, rtol=TOL, err_msg=key)


# -- meta_tfdata ----------------------------------------------------------------

_ARRAYS = {"a": np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5),
           "b": np.arange(6, dtype=np.int32).reshape(2, 3),
           "c": np.arange(4, dtype=np.float32)}
TFDATA_CASES = {
    "flatten_batch_examples": lambda m, s: m.flatten_batch_examples(s),
    "unflatten_batch_examples": lambda m, s: m.unflatten_batch_examples(
        m.flatten_batch_examples({"a": s["a"], "b": s["b"]}), 3),
    "merge_first_n_dims": lambda m, s: m.merge_first_n_dims({"a": s["a"]}, 3),
    "expand_batch_dims": lambda m, s: m.expand_batch_dims(
        m.merge_first_n_dims({"a": s["a"]}, 2), (2, 3)),
    "multi_batch_apply": lambda m, s: m.multi_batch_apply(
        lambda d: {"y": d["a"] * 2.0 + 1.0}, 2, {"a": s["a"]}),
    "split_train_val": lambda m, s: dict(zip(("train", "val"), m.split_train_val(
        {"a": s["a"], "b": s["b"]}, 2))),
    "tile_val_mode": lambda m, s: m.tile_val_mode({"a": s["a"], "b": s["b"]}, 3),
}


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = value
    return out


@pytest.mark.parametrize("case", sorted(TFDATA_CASES))
def test_meta_tfdata_matches_jax(case):
    want = _flat(TFDATA_CASES[case](jax_meta.meta_tfdata,
                                    {k: jnp.asarray(v) for k, v in _ARRAYS.items()}))
    got = _flat(TFDATA_CASES[case](meta_tfdata,
                                   {k: torch.from_numpy(v) for k, v in _ARRAYS.items()}))
    _assert_same_tree(got, want)
    # numpy arrays and TensorSpecStructs go through too.
    structure = TensorSpecStruct({"x": _ARRAYS["a"]})
    assert isinstance(meta_tfdata.flatten_batch_examples(structure), TensorSpecStruct)
    assert meta_tfdata.flatten_batch_examples(structure)["x"].shape == (6, 4, 5)


def test_multi_batch_apply_needs_an_array():
    with pytest.raises(ValueError, match="at least one array"):
        meta_tfdata.multi_batch_apply(lambda: None, 2)


# -- specs and preprocessors ----------------------------------------------------


def _spec_table(spec):
    return {key: (s.name, tuple(s.shape), np.dtype(s.dtype).name
                  if not isinstance(s.dtype, torch.dtype) else str(s.dtype).split(".")[-1],
                  s.is_optional, s.data_format)
            for key, s in spec.items()}


def _assert_same_specs(got, want):
    got, want = _spec_table(got), _spec_table(want)
    assert got == want


def _pose_models():
    return (jax_pose_env.PoseEnvRegressionModel(device_type="cpu"),
            pose_env.PoseEnvRegressionModel(device_type="cpu"))


@pytest.mark.parametrize("mode", ["train", "predict"])
def test_maml_and_meta_example_specs_match_jax(mode):
    jax_model, model = _pose_models()
    for name in ("create_maml_feature_spec", "create_maml_label_spec",
                 "create_metaexample_spec"):
        args = {
            "create_maml_feature_spec": lambda m: (m.get_feature_specification(mode),
                                                   m.get_label_specification(mode)),
            "create_maml_label_spec": lambda m: (m.get_label_specification(mode),),
            "create_metaexample_spec": lambda m: (m.get_feature_specification(mode), 3,
                                                  "condition"),
        }[name]
        _assert_same_specs(getattr(meta_learning, name)(*args(model)),
                           getattr(jax_meta, name)(*args(jax_model)))
    spec = meta_learning.create_maml_feature_spec(
        model.get_feature_specification(mode), model.get_label_specification(mode))
    assert spec["condition/features/state"].shape == (None, 64, 64, 3)
    assert spec["condition/labels/reward"].name == "condition_labels/reward"


def _raw_meta_batch(tasks, num_condition, num_inference, seed=0):
    rng = np.random.RandomState(seed)
    features, labels = JaxStruct(), JaxStruct()
    features["condition/features/state"] = rng.randint(
        0, 256, (tasks, num_condition, 64, 64, 3)).astype(np.uint8)
    features["condition/labels/target_pose"] = rng.uniform(
        -1, 1, (tasks, num_condition, 2)).astype(np.float32)
    features["condition/labels/reward"] = rng.rand(tasks, num_condition, 1).astype(np.float32)
    features["inference/features/state"] = rng.randint(
        0, 256, (tasks, num_inference, 64, 64, 3)).astype(np.uint8)
    labels["target_pose"] = rng.uniform(-1, 1, (tasks, num_inference, 2)).astype(np.float32)
    labels["reward"] = rng.rand(tasks, num_inference, 1).astype(np.float32)
    return features, labels


def _port(structure):
    return TensorSpecStruct({k: torch.from_numpy(np.asarray(v)) for k, v in structure.items()})


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_maml_preprocessor_matches_jax(mode):
    jax_model, model = _pose_models()
    jax_pre = jax_meta.MAMLPreprocessorV2(jax_model.preprocessor)
    pre = meta_learning.MAMLPreprocessorV2(model.preprocessor)
    for name in ("get_in_feature_specification", "get_in_label_specification",
                 "get_out_feature_specification", "get_out_label_specification"):
        _assert_same_specs(getattr(pre, name)(mode), getattr(jax_pre, name)(mode))
    features, labels = _raw_meta_batch(2, 3, 2)
    want = jax_pre.preprocess(features, labels, mode=mode, rng=jax.random.PRNGKey(0))
    got = pre.preprocess(_port(features), _port(labels), mode=mode,
                         generator=torch.Generator().manual_seed(0))
    for got_part, want_part in zip(got, want):
        _assert_same_tree(got_part, _numpy_jax(want_part))
    assert got[0]["condition/features/state"].shape == (2, 3, 64, 64, 3)
    assert got[1]["target_pose"].shape == (2, 2, 2)


def _numpy_jax(structure):
    return {k: np.asarray(v) for k, v in structure.items()}


def _episode_columns(features, labels, num_condition, num_inference):
    """The task batch as FixedLenMetaExamplePreprocessor's columns."""
    columns, label_columns = JaxStruct(), JaxStruct()
    for key, value in features.items():
        group, rest = key.split("/", 1)
        count = num_condition if group == "condition" else num_inference
        for i in range(count):
            columns[f"{group}/{rest}/{i}"] = value[:, i]
    for key, value in labels.items():
        for i in range(num_inference):
            label_columns[f"{key}/{i}"] = value[:, i]
    return columns, label_columns


def test_fixed_len_meta_example_preprocessor_matches_jax():
    jax_model, model = _pose_models()
    jax_pre = jax_meta.FixedLenMetaExamplePreprocessor(jax_model.preprocessor, 2, 1)
    pre = meta_learning.FixedLenMetaExamplePreprocessor(model.preprocessor, 2, 1)
    for name in ("get_in_feature_specification", "get_in_label_specification"):
        _assert_same_specs(getattr(pre, name)("train"), getattr(jax_pre, name)("train"))
    assert pre.get_in_feature_specification("train")[
        "condition/features/state/1"].name == "condition_ep1/state/image"
    features, labels = _raw_meta_batch(3, 2, 1, seed=1)
    columns, label_columns = _episode_columns(features, labels, 2, 1)
    want = jax_pre.preprocess(columns, label_columns, mode="train", rng=None)
    got = pre.preprocess(_port(columns), _port(label_columns), mode="train")
    for got_part, want_part in zip(got, want):
        _assert_same_tree(got_part, _numpy_jax(want_part))
    stacked = meta_learning.stack_intra_task_episodes(_port(label_columns), 1)
    assert stacked["target_pose"].shape == (3, 1, 2)


# -- the inner loop ---------------------------------------------------------------


def _quadratic(pkg, xp, **inner_kwargs):
    """The JAX tests' fixture, its params as outputs too (the adapted
    values are visible): minimize (x * coeff_a - 0)^2 from x = 2."""
    inner = pkg.MAMLInnerLoopGradientDescent(learning_rate=LEARNING_RATE, **inner_kwargs)

    def net_fn(variables, feats, mode, labels=None):
        x = variables["params"]["x"]
        return {"prediction": x * feats["coeff_a"], "x": x * 1.0}, {}

    def train_fn(feats, labs, outputs, mode):
        return xp.mean(xp.square(outputs["prediction"] - labs["target"]))

    return inner, net_fn, train_fn


def _jax_quadratic_run(learn_inner_lr, use_second_order):
    inner, net_fn, train_fn = _quadratic(jax_meta, jnp, learn_inner_lr=learn_inner_lr,
                                         use_second_order=use_second_order)
    params = {"x": jnp.asarray([X_INIT])}
    inputs = [({"coeff_a": jnp.asarray([COEFF_A_VALUE])}, {"target": jnp.asarray([0.0])})] * 3

    def run(params, lrs):
        return inner.inner_loop({"params": params}, inputs, net_fn, train_fn, "train",
                                inner_lrs=lrs or None)

    def outer(params, lrs):
        outputs, _, _ = run(params, lrs)
        return train_fn(*inputs[0], outputs[1], "train")

    lrs = inner.create_inner_lr_params(params)
    grads = jax.grad(outer, argnums=(0, 1))(params, lrs)
    return run(params, lrs), grads


@pytest.mark.parametrize("use_second_order", [False, True])
@pytest.mark.parametrize("learn_inner_lr", [False, True])
def test_inner_loop_on_the_quadratic_matches_jax(learn_inner_lr, use_second_order):
    (want_outputs, want_inner, want_losses), want_grads = _jax_quadratic_run(
        learn_inner_lr, use_second_order)
    inner, net_fn, train_fn = _quadratic(meta_learning, torch, learn_inner_lr=learn_inner_lr,
                                         use_second_order=use_second_order)
    x = torch.tensor([X_INIT], requires_grad=True)
    lrs = {k: v.requires_grad_() for k, v in inner.create_inner_lr_params({"x": x}).items()}
    assert set(lrs) == ({"x"} if learn_inner_lr else set())
    inputs = [({"coeff_a": torch.tensor([COEFF_A_VALUE])}, {"target": torch.tensor([0.0])})] * 3
    outputs, inner_outputs, inner_losses = inner.inner_loop(
        {"params": {"x": x}}, inputs, net_fn, train_fn, "train", inner_lrs=lrs or None)
    assert len(inner_losses) == len(inner_outputs) == 3
    got = {f"loss_{i}": v for i, v in enumerate(inner_losses)}
    want = {f"loss_{i}": v for i, v in enumerate(want_losses)}
    for name, (g, w) in {"uncond": (outputs[0], want_outputs[0]),
                         "cond": (outputs[1], want_outputs[1]),
                         **{f"inner_{i}": pair for i, pair in
                            enumerate(zip(inner_outputs, want_inner))}}.items():
        got.update({f"{name}/{k}": v for k, v in g.items()})
        want.update({f"{name}/{k}": v for k, v in w.items()})
    _assert_same_tree(got, {k: np.asarray(v) for k, v in want.items()}, exact=False)
    # The losses fall with every step and the adapted x moves toward 0.
    values = [float(v.detach()) for v in inner_losses]
    assert values[0] > values[1] > values[2]
    assert float(outputs[1]["x"].detach()) < X_INIT == float(outputs[0]["x"].detach())

    loss = train_fn(*inputs[0], outputs[1], "train")
    leaves = [x] + list(lrs.values())
    grads = torch.autograd.grad(loss, leaves)
    want_leaves = [want_grads[0]["x"]] + ([want_grads[1]["x"]] if learn_inner_lr else [])
    for got_grad, want_grad in zip(grads, want_leaves):
        want_grad = np.asarray(want_grad)
        scale = float(np.abs(want_grad).max())
        np.testing.assert_allclose(got_grad.numpy(), want_grad,
                                   atol=GRAD_TOL * scale + 1e-7, rtol=0)
        assert float(got_grad.abs().max()) > 0.0


def test_second_order_changes_the_meta_gradient():
    metas = {}
    for use_second_order in (False, True):
        inner, net_fn, train_fn = _quadratic(meta_learning, torch,
                                             use_second_order=use_second_order)
        x = torch.tensor([X_INIT], requires_grad=True)
        inputs = [({"coeff_a": torch.tensor([COEFF_A_VALUE])},
                   {"target": torch.tensor([0.0])})] * 3
        outputs, _, _ = inner.inner_loop({"params": {"x": x}}, inputs, net_fn, train_fn,
                                         "train")
        metas[use_second_order] = float(torch.autograd.grad(
            train_fn(*inputs[0], outputs[1], "train"), x)[0])
    assert metas[False] != metas[True]


def test_var_scope_leaves_the_other_parameters():
    inner = meta_learning.MAMLInnerLoopGradientDescent(learning_rate=0.1, var_scope="adapt")
    params = {"adapt": torch.ones(2), "frozen": torch.ones(2)}

    def net_fn(variables, feats, mode, labels=None):
        p = variables["params"]
        return {"prediction": (p["adapt"] + p["frozen"]) * feats["coeff_a"],
                "adapt": p["adapt"] * 1.0, "frozen": p["frozen"] * 1.0}, {}

    def train_fn(feats, labs, outputs, mode):
        return torch.mean(torch.square(outputs["prediction"] - labs["target"]))

    inputs = [({"coeff_a": torch.ones(2)}, {"target": torch.zeros(2)})] * 3
    (_, cond), _, losses = inner.inner_loop({"params": params}, inputs, net_fn, train_fn,
                                            "train", param_paths={"adapt": "adapt/kernel",
                                                                  "frozen": "frozen/kernel"})
    assert float(losses[-1]) < float(losses[0])
    assert torch.equal(cond["frozen"], params["frozen"])
    assert not torch.equal(cond["adapt"], params["adapt"])


# -- MAML over the mock model -----------------------------------------------------


class _JaxMockMAML(jax_meta.MAMLModel):
    def _select_inference_output(self, predictions):
        predictions["condition_output"] = predictions["full_condition_output/a_predicted"]
        predictions["inference_output"] = predictions["full_inference_output/a_predicted"]
        return predictions


class _MockMAML(meta_learning.MAMLModel):
    def _select_inference_output(self, predictions):
        predictions["condition_output"] = predictions["full_condition_output/a_predicted"]
        predictions["inference_output"] = predictions["full_inference_output/a_predicted"]
        return predictions


def _mock_meta_batch(tasks=2, num_condition=8, num_inference=8, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, size=(tasks, num_condition + num_inference, 3)).astype(np.float32)
    y = (x.sum(axis=-1, keepdims=True) > 0).astype(np.float32)
    features, labels = JaxStruct(), JaxStruct()
    features["condition/features/x"] = x[:, :num_condition]
    features["condition/labels/a_target"] = y[:, :num_condition]
    features["inference/features/x"] = x[:, num_condition:]
    labels["a_target"] = y[:, num_condition:]
    return features, labels


@pytest.mark.parametrize("use_batch_norm,var_scope", [(False, "Dense_1"), (True, None)])
def test_maml_over_the_mock_matches_jax(use_batch_norm, var_scope):
    """var_scope "Dense_1" adapts that layer alone, selected by its flax
    path in both packages."""
    kwargs = dict(num_inner_loop_steps=2, inner_learning_rate=0.1, learn_inner_lr=True,
                  var_scope=var_scope)
    jax_model = _JaxMockMAML(base_model=jax_mocks.MockT2RModel(use_batch_norm=use_batch_norm),
                             **kwargs)
    model = _MockMAML(base_model=mocks.MockT2RModel(use_batch_norm=use_batch_norm), **kwargs)
    features, labels = _mock_meta_batch()
    variables = jax.tree_util.tree_map(
        np.asarray, jax_model.init_variables(jax.random.PRNGKey(0), features))

    def loss_fn(params):
        outputs, _ = jax_model.inference_network_fn(dict(variables, params=params),
                                                    features, "train", labels=labels)
        loss, metrics = jax_model.model_train_fn(features, labels, outputs, "train")
        return loss, (outputs, metrics)

    (want_loss, (want_outputs, want_metrics)), want_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])

    network = model.create_network()
    jax_params.load_flax_variables(network, variables)
    # The rates sit at the flax paths of the parameters they step.
    assert network.inner_lr_keys["Dense_0.weight"] == "Dense_0/kernel"
    assert set(network.inner_lrs.keys()) == set(network.inner_lr_keys.values())
    buffers = {k: v.clone() for k, v in network.named_buffers()}
    outputs, updates = model.inference_network_fn(network, _port(features), "train",
                                                   labels=_port(labels))
    assert updates == {}
    _assert_same_tree(outputs, _numpy_jax(want_outputs), exact=False)
    loss, metrics = model.model_train_fn(_port(features), _port(labels), outputs, "train")
    assert set(metrics) == set(want_metrics) and "inner_loss_2" in metrics
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=TOL, rtol=TOL)
    loss.backward()
    want = jax_params.flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, want_grads))
    assert set(want) == {name for name, _ in network.named_parameters()}
    for name, param in network.named_parameters():
        # A rate of a layer outside var_scope takes no part: no gradient
        # (JAX's is 0).
        grad = torch.zeros_like(param) if param.grad is None else param.grad
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(grad.numpy(), want[name].numpy(),
                                   atol=GRAD_TOL * scale + 1e-7, rtol=0, err_msg=name)
    for name, value in network.named_buffers():
        assert torch.equal(value, buffers[name]), name
    for key, rate in network.inner_lrs.items():
        moved = rate.grad is not None and float(rate.grad.abs()) > 0
        assert moved == key.startswith(var_scope or ""), key


def test_missing_selection_keys_raise():
    class Bad(meta_learning.MAMLModel):
        def _select_inference_output(self, predictions):
            return predictions

    model = Bad(base_model=mocks.MockT2RModel(use_batch_norm=False))
    features, _ = _mock_meta_batch()
    with pytest.raises(ValueError, match="condition_output"):
        model.inference_network_fn(model.create_network(), _port(features), "train")


# -- MetaExample bytes ------------------------------------------------------------


@pytest.mark.parametrize("sequence", [False, True])
def test_make_meta_example_parses_as_jax_builds_it(sequence):
    from tensor2robot_tpu.proto import example_pb2
    from tensor2robot_tpu_torch.data.encoder import encode_example
    from tensor2robot_tpu_torch.specs import ExtendedTensorSpec

    spec = TensorSpecStruct()
    spec["x"] = ExtendedTensorSpec(shape=(3,), dtype=np.float32, name="measured_position",
                                   is_sequence=sequence)
    spec["n"] = ExtendedTensorSpec(shape=(2,), dtype=np.int64, name="count")
    message = example_pb2.SequenceExample if sequence else example_pb2.Example

    def episode(seed):
        rng = np.random.RandomState(seed)
        values = TensorSpecStruct()
        values["x"] = rng.rand(*((4, 3) if sequence else (3,))).astype(np.float32)
        values["n"] = rng.randint(0, 9, 2).astype(np.int64)
        return encode_example(spec, values)

    condition, inference = [episode(0), episode(1)], [episode(2)]
    got = meta_learning.meta_example.make_meta_example(condition, inference)
    want = jax_meta.meta_example.make_meta_example(
        [message.FromString(e) for e in condition], [message.FromString(e) for e in inference])
    assert message.FromString(got) == want
    keys = (message.FromString(got).context.feature if sequence
            else message.FromString(got).features.feature)
    assert sorted(keys) == sorted(f"{p}/{n}" for p in ("condition_ep0", "condition_ep1",
                                                      "inference_ep0")
                                  for n in (("count",) if sequence else
                                            ("count", "measured_position")))


# -- meta policies ----------------------------------------------------------------


class _FakePredictor:
    """A predictor of either package's spec types: a critic scoring each
    action by -|a - 0.3|^2 (shifted by the conditioning reward when one is
    fed), or a regression head returning the mean of each feature."""

    def __init__(self, specs, critic: bool, steps: int = 0):
        self._spec = specs.TensorSpecStruct()
        self._spec["state"] = specs.ExtendedTensorSpec(shape=(2,), dtype=np.float32,
                                                       name="state")
        if critic:
            self._spec["action"] = specs.ExtendedTensorSpec(shape=(5, 2), dtype=np.float32,
                                                            name="action")
        self._critic, self._steps = critic, steps
        self.global_step = 7

    def get_feature_specification(self):
        return self._spec

    def predict(self, batch):
        state = np.asarray(batch["state"], np.float32)
        if self._critic:
            actions = np.asarray(batch["action"], np.float32)
            shift = float(np.asarray(batch.get("reward", 0.0)).sum())
            return {"q_predicted": -np.square(actions - 0.3 - shift).sum(-1)}
        out = state.reshape(state.shape[0], -1).mean(-1)[:, None, None] + np.arange(
            2, dtype=np.float32)
        if self._steps:
            out = out[:, :, None, :] + np.arange(self._steps, dtype=np.float32)[:, None]
        return {"inference_output": out}


def _pack(state, episodes, timestep):
    packed = {"state": np.asarray(state, np.float32)}
    if episodes:
        packed["reward"] = np.asarray([len(episodes)], np.float32)
    return packed


@pytest.mark.parametrize("name", ["MAMLCEMPolicy", "MAMLRegressionPolicy",
                                  "ScheduledExplorationMAMLRegressionPolicy",
                                  "FixedLengthSequentialRegressionPolicy"])
def test_meta_policies_match_jax(name):
    """Each meta policy of both packages over the same fake predictor and
    seed gives the same actions before and after adapt(), and reset_task
    forgets the conditioning data."""
    from tensor2robot_tpu import specs as jax_specs
    from tensor2robot_tpu_torch import specs

    critic = name == "MAMLCEMPolicy"
    kwargs = dict(action_size=2, cem_samples=5, cem_iterations=2, seed=3) if critic else {}
    actions = []
    for pkg, spec_module in ((jax_meta, jax_specs), (meta_learning, specs)):
        predictor = _FakePredictor(spec_module, critic,
                                   steps=3 if name.startswith("FixedLength") else 0)
        policy = getattr(pkg, name)(predictor, pack_fn=_pack, **kwargs)
        policy.seed(5)
        state = np.array([0.25, -0.5], np.float32)
        got = [policy.SelectAction(state)]
        policy.adapt([["episode"]])
        got.append(policy.SelectAction(state))
        assert policy.prev_episode_data == [["episode"]]
        got.append(policy.sample_action(state, 0.0)[0])
        policy.reset_task()
        assert policy.prev_episode_data is None
        actions.append(got)
    for got, want in zip(actions[1], actions[0]):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
