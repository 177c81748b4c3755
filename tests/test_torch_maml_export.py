"""Exporting and serving MAML models (ROADMAP A8(f)) against the JAX package.

A MAML predict forward adapts the weights with an inner gradient, so its
export is a set of static-batch programs traced by make_fx with the inner
backward as aten ops (export/saved_model.py). Held here, on the CPU:

  * PoseEnvRegressionModelMAML and VRGripperEnvRegressionModelMAML from
    seeded JAX variables (utils/jax_params.py): every output of the
    exported program within TOL (the BC gate of
    tests/test_torch_pose_env_maml.py) of the JAX package's
    `create_serving_fn(compiled, variables)` under jax.jit, and within
    EXACT of the port's own eager serving module, on a request of 3 tasks
    served by the batch-4 program (padded, cut back) and on 1 task.
  * The bf16 wrapper, both models: the program within EXACT of the eager
    bf16 serving module, and its inference output within BF16_TOL of JAX's
    bf16 serving function (the JAX bf16 gate).
  * int8 weights (QuantizedServingModule), both models: the program within
    EXACT of the eager int8 module and within TOL of JAX's int8 serving
    function; for the pose model also within TOL of a float network
    loaded with the dequantized weights, so the inner step adapted the
    quantized weights as well.
  * Serving: ExportedSavedModelPredictor under PolicyServer with the
    export's warmup ladder (every bucket prewarmed), answers equal to a
    CheckpointPredictor's on the same weights; a hot swap to a second
    version; MAMLRegressionPolicy over the export acts as over the
    checkpoint, and run_meta_env's statistics agree.

Never the JAX AOT serving path (ROADMAP C-ref1).
"""

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.export import export_generators as jax_export
from tensor2robot_tpu.research import pose_env as jax_pose_env
from tensor2robot_tpu.research import vrgripper as jax_vrg
from tensor2robot_tpu.train.train_eval import CompiledModel
from tensor2robot_tpu.train.train_eval import maybe_wrap_for_tpu as jax_wrap
from tensor2robot_tpu_torch import meta_learning
from tensor2robot_tpu_torch.export import saved_model
from tensor2robot_tpu_torch.export.export_generators import DefaultExportGenerator
from tensor2robot_tpu_torch.export.quantization import dequantize_variables
from tensor2robot_tpu_torch.predictors import CheckpointPredictor, ExportedSavedModelPredictor
from tensor2robot_tpu_torch.research import pose_env, vrgripper
from tensor2robot_tpu_torch.serving.server import PolicyServer
from tensor2robot_tpu_torch.specs import make_random_numpy
from tensor2robot_tpu_torch.train.train_eval import maybe_wrap_for_tpu
from tensor2robot_tpu_torch.utils import jax_params
from tests.test_torch_resnet import seeded_variables

TOL = 1e-5
EXACT = 1e-6
BF16_TOL = 0.02
TASKS = 3
PROGRAMS = (1, 4)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _pose_models(device_type="cpu", **kwargs):
    jax_model = jax_pose_env.PoseEnvRegressionModelMAML(
        base_model=jax_pose_env.PoseEnvRegressionModel(device_type=device_type),
        num_inner_loop_steps=1, **kwargs)
    model = pose_env.PoseEnvRegressionModelMAML(
        base_model=pose_env.PoseEnvRegressionModel(device_type=device_type),
        num_inner_loop_steps=1, **kwargs)
    if device_type == "tpu":
        return jax_wrap(jax_model), maybe_wrap_for_tpu(model)
    return jax_model, model


def _vrgripper_models(device_type="cpu"):
    kwargs = dict(episode_length=4, image_size=(40, 40), device_type=device_type)
    maml = dict(num_inner_loop_steps=1, inner_learning_rate=0.05)
    jax_model = jax_vrg.VRGripperEnvRegressionModelMAML(
        base_model=jax_vrg.VRGripperRegressionModel(**kwargs), **maml)
    model = vrgripper.VRGripperEnvRegressionModelMAML(
        base_model=vrgripper.VRGripperRegressionModel(**kwargs), **maml)
    if device_type == "tpu":
        return jax_wrap(jax_model), maybe_wrap_for_tpu(model)
    return jax_model, model


def _variables(jax_model, features, seed=1):
    f, _ = jax_model.preprocessor.preprocess(features, None, mode="predict", rng=None)
    shapes = jax.eval_shape(lambda: jax_model.init_variables(jax.random.PRNGKey(0), f,
                                                             "predict"))
    return seeded_variables(dict(shapes), seed)


def _request(generator, tasks, seed=0):
    return dict(make_random_numpy(generator.serving_input_spec(), batch_size=tasks,
                                  seed=seed).items())


def _jax_outputs(jax_model, variables, request, quantize=False):
    generator = jax_export.DefaultExportGenerator()
    generator.set_specification_from_model(jax_model)
    compiled = CompiledModel(jax_model, donate_state=False)
    fn = generator.create_serving_fn(compiled, variables, quantize_weights=quantize)
    features = {k: np.asarray(v) for k, v in request.items()}
    if quantize:
        out = jax.jit(fn)(fn.variables_in_args, features)
    else:
        out = jax.jit(fn)(features)
    return {k: np.asarray(v) for k, v in out.items()}


def _export(model, state_dict, tmp_path, quantize=False, batches=PROGRAMS):
    generator = DefaultExportGenerator()
    generator.set_specification_from_model(model)
    serving = generator.create_serving_fn(state_dict, device=torch.device("cpu"),
                                          quantize_weights=quantize)
    assert serving.takes_gradients
    path = saved_model.save_exported_model(
        str(tmp_path), state_dict, generator.serving_input_spec(),
        serving_module=serving, example_features=generator.create_example_features(),
        quantize_weights=quantize, program_batches=batches)
    loaded = saved_model.ExportedModel(path, device="cpu")
    assert loaded.metadata["program"], loaded.metadata["program_error"]
    assert loaded.program_batches == sorted(batches)
    return generator, serving, loaded


def _eager(serving, request):
    with torch.no_grad():
        out = serving({k: torch.from_numpy(np.asarray(v)) for k, v in request.items()})
    return {k: v.float().numpy() for k, v in out.items()}


def _close(got, want, tol, keys=None):
    keys = keys or sorted(want)
    assert set(keys) <= set(got), sorted(set(keys) - set(got))
    for key in keys:
        np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                   np.asarray(want[key], np.float64), atol=tol, rtol=tol,
                                   err_msg=key)


def _raw_pose_features(tasks=TASKS, seed=0):
    generator = DefaultExportGenerator()
    generator.set_specification_from_model(_pose_models()[1])
    return _request(generator, tasks, seed)


@pytest.fixture(scope="module")
def pose_f32(tmp_path_factory):
    jax_model, model = _pose_models()
    request = _raw_pose_features()
    from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct
    variables = _variables(jax_model, JaxStruct(dict(request)))
    state_dict = jax_params.flax_variables_to_state_dict(variables)
    generator, serving, loaded = _export(model, state_dict, tmp_path_factory.mktemp("pose"))
    return dict(jax_model=jax_model, model=model, variables=variables,
                state_dict=state_dict, generator=generator, serving=serving,
                loaded=loaded, request=request)


def test_pose_export_matches_jax_and_the_eager_forward(pose_f32):
    request, loaded = pose_f32["request"], pose_f32["loaded"]
    got = loaded.predict(request)
    want = _jax_outputs(pose_f32["jax_model"], pose_f32["variables"], request)
    assert set(got) == set(want)
    _close(got, want, TOL)
    _close(got, _eager(pose_f32["serving"], request), EXACT)
    one = {k: v[:1] for k, v in request.items()}
    _close(loaded.predict(one), _eager(pose_f32["serving"], one), EXACT)
    _close(loaded.predict(one), {k: v[:1] for k, v in got.items()}, EXACT)
    with pytest.raises(ValueError, match="exceeds the export's program batches"):
        loaded.predict({k: np.concatenate([v, v]) for k, v in request.items()})


def test_the_program_holds_the_inner_backward_and_no_autograd(pose_f32):
    path = saved_model.static_program_path(pose_f32["loaded"].export_dir, 4)
    program = torch.export.load(path)
    targets = {str(node.target) for node in program.graph.nodes
               if node.op == "call_function"}
    assert any("convolution_backward" in t for t in targets), sorted(targets)[:40]
    assert not any("autograd" in t or "grad_and_value" in t for t in targets)


def test_pose_export_under_the_bf16_wrapper(pose_f32, tmp_path):
    jax_model, model = _pose_models(device_type="tpu")
    request = pose_f32["request"]
    _, serving, loaded = _export(model, pose_f32["state_dict"], tmp_path, batches=(4,))
    got = loaded.predict(request)
    _close(got, _eager(serving, request), EXACT)
    want = _jax_outputs(jax_model, pose_f32["variables"], request)
    _close(got, want, BF16_TOL, keys=["inference_output"])


def test_pose_export_with_int8_weights(pose_f32, tmp_path):
    request = pose_f32["request"]
    _, serving, loaded = _export(pose_f32["model"], pose_f32["state_dict"], tmp_path,
                                 quantize=True, batches=(4,))
    assert loaded.metadata["weights_int8"]
    got = loaded.predict(request)
    _close(got, _eager(serving, request), EXACT)
    want = _jax_outputs(pose_f32["jax_model"], pose_f32["variables"], request,
                        quantize=True)
    _close(got, want, TOL)
    generator = pose_f32["generator"]
    dequantized = generator.create_serving_fn(dequantize_variables(
        serving.quantized_variables), device=torch.device("cpu"))
    _close(got, _eager(dequantized, request), TOL)


@pytest.mark.parametrize("regime", ["f32", "bf16", "int8"])
def test_vrgripper_maml_export_matches_jax(regime, tmp_path):
    from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct

    jax_model, model = _vrgripper_models("tpu" if regime == "bf16" else "cpu")
    generator = DefaultExportGenerator()
    generator.set_specification_from_model(model)
    request = _request(generator, TASKS, seed=3)
    variables = _variables(_vrgripper_models()[0], JaxStruct(dict(request)), seed=2)
    state_dict = jax_params.flax_variables_to_state_dict(variables)
    _, serving, loaded = _export(model, state_dict, tmp_path, quantize=regime == "int8",
                                 batches=(4,))
    got = loaded.predict(request)
    _close(got, _eager(serving, request), EXACT)
    want = _jax_outputs(jax_model, variables, request, quantize=regime == "int8")
    assert set(got) == set(want)
    if regime == "bf16":
        _close(got, want, BF16_TOL, keys=["inference_output"])
    else:
        _close(got, want, TOL)


def _policy_models():
    cls = meta_learning.FixedLenMetaExamplePreprocessor
    return _pose_models(preprocessor_cls=cls)[1]


def _unbatched(pack_features):
    return lambda state, context, timestep: {
        key: value[0] for key, value in pack_features(state, context, timestep).items()}


def test_maml_policy_serves_from_the_export(pose_f32, tmp_path):
    """The export under PolicyServer (ladder prewarmed, a hot swap), and a
    MAMLRegressionPolicy over it acting as over the checkpoint."""
    model = _policy_models()
    weights = [pose_f32["state_dict"], {k: v * 1.01 if v.is_floating_point() else v
                                        for k, v in pose_f32["state_dict"].items()}]
    root = tmp_path / "export"
    generator = DefaultExportGenerator()
    generator.set_specification_from_model(model)

    def publish(state_dict, step):
        serving = generator.create_serving_fn(state_dict, device=torch.device("cpu"))
        path = saved_model.save_exported_model(
            str(root), state_dict, generator.serving_input_spec(), global_step=step,
            serving_module=serving, example_features=generator.create_example_features(),
            metadata={"warmup_batch_sizes": [1, 2]}, program_batches=(1, 2))
        generator.write_warmup_requests(generator.generate_warmup_batches((1, 2)), path)

    publish(weights[0], 10)
    predictor = ExportedSavedModelPredictor(str(root), timeout=0, device="cpu")
    assert predictor.restore() and predictor.loaded_model.program_batches == [1, 2]
    references = []
    for step, state_dict in zip((10, 20), weights):
        reference = CheckpointPredictor(model, device="cpu")
        reference.load_state_dict(state_dict, version=step)
        references.append(reference)
    request = _request(generator, 1, seed=4)
    example = {k: v[0] for k, v in request.items()}
    with PolicyServer(predictor, max_wait_ms=1).start() as server:
        snap = server.snapshot()
        first = server.call(example)
        publish(weights[1], 20)
        assert server.hot_swap(wait=True)
        second = server.call(example)
        assert server.snapshot()["counters"]["hot_swaps"] == 1
        assert predictor.global_step == 20
    assert snap["buckets"] == [1, 2]
    assert sorted(snap["prewarmed"].values()) == [[1, 2]]
    assert first.model_version < second.model_version
    for response, reference in ((first, references[0]), (second, references[1])):
        want = reference.predict(request)
        _close({k: np.asarray(v)[None] for k, v in response.outputs.items()}, want, EXACT,
               keys=["inference_output", "condition_output"])

    env = pose_env.PoseToyEnv(hidden_drift=True, seed=12)
    obs = env.reset()
    episode = [[(obs, np.array([0.1, -0.2], np.float32), 0.9, obs, True, {})]]
    actions = []
    for prediction in (predictor, references[1]):
        policy = meta_learning.MAMLRegressionPolicy(
            prediction, pack_fn=_unbatched(model.pack_features))
        policy.adapt(episode)
        actions.append(policy.sample_action(obs)[0])
    np.testing.assert_allclose(actions[0], actions[1], atol=EXACT, rtol=EXACT)
    stats = [meta_learning.run_meta_env(
        pose_env.PoseToyEnv(hidden_drift=True, seed=11),
        meta_learning.MAMLRegressionPolicy(prediction,
                                           pack_fn=_unbatched(model.pack_features)),
        num_tasks=1, num_adaptations_per_task=2, root_dir=str(tmp_path / name))
        for name, prediction in (("export", predictor), ("checkpoint", references[1]))]
    assert set(stats[0]) == set(stats[1])
    for key, value in stats[1].items():
        np.testing.assert_allclose(stats[0][key], value, atol=TOL, rtol=TOL, err_msg=key)
