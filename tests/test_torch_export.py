"""The port's export: directory, program, warmup records and exporters.

  * layout: a timestamped version with t2r_metadata.json, variables.pt,
    assets.extra/t2r_assets.pbtxt and program/predict_fn.pt2; `temp-`
    and partial dirs are invisible; the program serves batches 1, 3, 7;
  * the exported BC graph calls `t2r_torch.flash_fwd` (B2's operator) and
    holds no B1 (`flash_fwd_tile`) and no materialized attention;
  * export -> predict parity against the JAX package's ExportedModel on
    the same (converted) weights and raw features: the tiny BC model
    (1e-4 abs + rel; the JAX side runs the Pallas kernel in interpret
    mode) and the 96x96 critic with num_convs (2, 2, 1) (atol 1e-5, rtol
    1e-4). The JAX exports are made with T2R_AOT_EXPORT=0 and
    T2R_SERVE_AOT=0: its AOT path is not an oracle here (ROADMAP C-ref1);
  * warmup records: the port's file read by the JAX load_warmup_batches
    equals the port's own reading, and the reverse;
  * Latest, Best (its gate persisted across instances), version GC and
    the compare fns, as tests/test_export.py holds the JAX package's.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.export import saved_model as jax_saved_model
from tensor2robot_tpu.export.export_generators import (
    DefaultExportGenerator as JaxExportGenerator,
)
from tensor2robot_tpu.models import transformer_models as jax_models
from tensor2robot_tpu.research.qtopt import t2r_models as jax_qtopt
from tensor2robot_tpu.serving import buckets as jax_buckets
from tensor2robot_tpu.specs import make_random_numpy as jax_make_random_numpy
from tensor2robot_tpu.train.train_eval import CompiledModel
from tensor2robot_tpu_torch.export import (
    BestExporter,
    DefaultExportGenerator,
    DirectoryVersionGC,
    ExportedModel,
    LatestExporter,
    create_default_exporters,
    create_valid_result_larger,
    create_valid_result_smaller,
    latest_export_dir,
    list_export_dirs,
    save_exported_model,
)
from tensor2robot_tpu_torch.export import saved_model
from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
from tensor2robot_tpu_torch.research.qtopt import t2r_models
from tensor2robot_tpu_torch.serving import buckets
from tensor2robot_tpu_torch.specs import make_random_numpy
from tensor2robot_tpu_torch.train.train_eval import Trainer
from tensor2robot_tpu_torch.utils.jax_params import flax_variables_to_state_dict

BC = dict(episode_length=16, image_size=(16, 16), d_model=32, num_layers=2,
          num_heads=2, head_dim=16, use_flash=True)
CRITIC = dict(image_size=(96, 96), num_convs=(2, 2, 1))
BC_TOL = 1e-4
CRITIC_ATOL, CRITIC_RTOL = 1e-5, 1e-4
LADDER = (1, 2, 3)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _export(model, state_dict, root, **kwargs):
    generator = DefaultExportGenerator()
    generator.set_specification_from_model(model)
    module = generator.create_serving_fn(state_dict, device=torch.device("cpu"))
    return save_exported_model(
        root, variables=state_dict, feature_spec=generator.serving_input_spec(),
        label_spec=generator.label_spec, global_step=3, serving_module=module,
        example_features=generator.create_example_features(), **kwargs,
    )


def _jax_export(jax_model, variables, root):
    compiled = CompiledModel(jax_model, donate_state=False)
    generator = JaxExportGenerator()
    generator.set_specification_from_model(jax_model)
    return jax_saved_model.save_exported_model(
        root, variables=variables, feature_spec=generator.serving_input_spec(),
        label_spec=generator.label_spec, global_step=3,
        predict_fn=generator.create_serving_fn(compiled, variables),
        example_features=generator.create_example_features(),
    )


def _pair(kind):
    if kind == "bc":
        return (jax_models.TransformerBCModel(interpret=True, device_type="cpu", **BC),
                TransformerBCModel(**BC))
    name = "Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom"
    return getattr(jax_qtopt, name)(**CRITIC), getattr(t2r_models, name)(**CRITIC)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """Both packages' exports of the same initialized weights, per model."""
    out = {}
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("T2R_AOT_EXPORT", "0")
        patch.setenv("T2R_SERVE_AOT", "0")
        for kind in ("bc", "critic"):
            jax_model, model = _pair(kind)
            preprocessor = jax_model.preprocessor
            raw = jax_make_random_numpy(
                preprocessor.get_in_feature_specification("predict"),
                batch_size=2, seed=4)
            features, _ = preprocessor.preprocess(raw, None, mode="predict", rng=None)
            variables = jax.tree_util.tree_map(
                np.asarray,
                dict(jax_model.init_variables(jax.random.PRNGKey(0), features)))
            root = tmp_path_factory.mktemp(kind)
            jax_path = _jax_export(jax_model, variables, str(root / "jax"))
            jax_loaded = jax_saved_model.ExportedModel(jax_path, quant_regime="none")
            state = flax_variables_to_state_dict(variables)
            path = _export(model, state, str(root / "port"))
            out[kind] = dict(jax=jax_loaded, path=path, model=model, state=state,
                             loaded=ExportedModel(path, device="cpu"))
    return out


class TestArtifact:
    def test_layout_and_metadata(self, exports):
        path = exports["bc"]["path"]
        assert os.path.basename(path).isdigit()
        for rel in ("t2r_metadata.json", "variables.pt",
                    os.path.join("assets.extra", "t2r_assets.pbtxt"),
                    os.path.join("program", "predict_fn.pt2")):
            assert os.path.exists(os.path.join(path, rel)), rel
        with open(os.path.join(path, "t2r_metadata.json")) as f:
            meta = json.load(f)
        assert meta["program"] is True and meta["program_error"] is None
        assert meta["global_step"] == 3 and meta["timestamp"] == int(os.path.basename(path))
        assert meta["program_device"] == "cpu" and meta["torch_version"] == torch.__version__
        assert meta["weights_int8"] is False and meta["format_version"] == 1
        loaded = exports["bc"]["loaded"]
        assert loaded.global_step == 3 and loaded.label_spec is not None
        program = torch.export.load(saved_model.program_path(path))
        assert program.example_inputs is None  # no example batch in the file
        variables = loaded.load_variables()
        assert set(variables) == set(exports["bc"]["state"])
        for key, value in variables.items():
            assert torch.equal(value, exports["bc"]["state"][key]), key

    def test_temp_and_partial_dirs_are_invisible(self, exports, tmp_path):
        root = str(tmp_path / "export")
        path = _export(exports["bc"]["model"], exports["bc"]["state"], root)
        os.makedirs(os.path.join(root, "temp-99999999999"))
        os.makedirs(os.path.join(root, "99999999998"))  # no metadata: partial
        assert latest_export_dir(root) == path
        assert list_export_dirs(root) == [path]
        assert not [d for d in os.listdir(root) if d.startswith("temp-")][1:]

    @pytest.mark.parametrize("batch", [1, 3, 7])
    @pytest.mark.parametrize("kind", ["bc", "critic"])
    def test_program_is_batch_polymorphic(self, exports, kind, batch):
        loaded = exports[kind]["loaded"]
        features = make_random_numpy(loaded.feature_spec, batch_size=batch, seed=batch)
        outputs = loaded.predict(dict(features.items()))
        assert outputs and all(v.shape[0] == batch for v in outputs.values())

    def test_bc_graph_calls_b2_and_no_other_attention(self, exports):
        program = torch.export.load(saved_model.program_path(exports["bc"]["path"]))
        targets = [str(node.target) for node in program.graph.nodes
                   if node.op == "call_function"]
        assert targets.count("t2r_torch.flash_fwd.default") == BC["num_layers"]
        for banned in ("flash_fwd_tile", "bmm", "einsum", "matmul",
                       "scaled_dot_product"):
            assert not [t for t in targets if banned in t], banned

    def test_no_program_is_recorded_and_the_version_lands(self, exports, tmp_path):
        path = _export(exports["bc"]["model"], exports["bc"]["state"],
                       str(tmp_path), export_program_file=False)
        loaded = ExportedModel(path, device="cpu")
        assert not loaded.has_program and loaded.metadata["program"] is False
        with pytest.raises(RuntimeError, match="no program"):
            loaded.predict({})


@pytest.mark.parametrize("kind", ["bc", "critic"])
def test_predict_matches_jax_exported_model(exports, kind):
    entry = exports[kind]
    assert entry["jax"].has_stablehlo, entry["jax"].metadata.get("stablehlo_error")
    features = dict(make_random_numpy(
        entry["loaded"].feature_spec, batch_size=3, seed=11).items())
    want = entry["jax"].predict(features)
    got = entry["loaded"].predict(features)
    assert set(got) == set(want)
    atol, rtol = (BC_TOL, BC_TOL) if kind == "bc" else (CRITIC_ATOL, CRITIC_RTOL)
    for key in got:
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype
        np.testing.assert_allclose(got[key], want[key], atol=atol, rtol=rtol)


@pytest.mark.parametrize("kind", ["bc", "critic"])
def test_warmup_records_cross_read(exports, kind, tmp_path):
    jax_model, model = _pair(kind)
    generator, jax_generator = DefaultExportGenerator(), JaxExportGenerator()
    generator.set_specification_from_model(model)
    jax_generator.set_specification_from_model(jax_model)
    metadata = {"warmup_batch_sizes": list(LADDER)}
    batches = generator.generate_warmup_batches(LADDER)
    generator.write_warmup_requests(batches, str(tmp_path / "port"))
    if kind == "critic":
        jax_generator.create_warmup_requests_numpy(LADDER, str(tmp_path / "jax"))
    # The JAX encoder (PIL) refuses the BC model's float32 JPEG image spec,
    # so only the critic has a JAX-written warmup file.
    for directory in ("port", "jax") if kind == "critic" else ("port",):
        ours = buckets.load_warmup_batches(
            str(tmp_path / directory), generator.serving_input_spec(), metadata)
        theirs = jax_buckets.load_warmup_batches(
            str(tmp_path / directory), jax_generator.serving_input_spec(), metadata)
        assert sorted(ours) == sorted(theirs) == list(LADDER)
        for size in LADDER:
            assert set(ours[size]) == set(theirs[size])
            for key in ours[size]:
                np.testing.assert_array_equal(ours[size][key], theirs[size][key])
    spec = generator.serving_input_spec()
    own = buckets.load_warmup_batches(str(tmp_path / "port"), spec, metadata)
    for size, batch in zip(LADDER, batches):
        for key, value in batch.items():
            if spec[key].data_format is None:  # encoded images are lossy
                np.testing.assert_array_equal(own[size][key], value)
            assert own[size][key].shape == value.shape


@pytest.fixture(scope="module")
def trained():
    model = TransformerBCModel(**BC)
    trainer = Trainer(model, device="cpu")
    return trainer, trainer.init_state()


def _maybe(exporter, trained, model_dir, step, metrics):
    trainer, state = trained
    return exporter.maybe_export(step=step, state=state, eval_metrics=metrics,
                                 compiled=trainer, model_dir=str(model_dir))


class TestExporters:
    def test_latest_exporter_exports_every_eval(self, trained, tmp_path):
        exporter = LatestExporter(name="latest", exports_to_keep=2,
                                  export_program=False, warmup_batch_sizes=(1, 2))
        paths = [_maybe(exporter, trained, tmp_path, step, {"loss": 1.0})
                 for step in (1, 2, 3)]
        root = exporter.export_root(str(tmp_path))
        assert root == str(tmp_path / "export" / "latest")
        assert list_export_dirs(root) == paths[1:]  # GC kept the newest two
        meta = ExportedModel(paths[-1], device="cpu").metadata
        assert meta["warmup_batch_sizes"] == [1, 2] and meta["exporter"] == "latest"
        assert meta["global_step"] == 3 and meta["eval_metrics"] == {"loss": 1.0}
        assert os.path.exists(os.path.join(paths[-1], "warmup", "warmup_requests.tfrecord"))

    def test_best_exporter_gates_on_metric(self, trained, tmp_path):
        exporter = BestExporter(compare_fn=create_valid_result_smaller("loss"),
                                export_program=False)
        results = [_maybe(exporter, trained, tmp_path, step, {"loss": loss})
                   for step, loss in ((1, 1.0), (2, 2.0), (3, 0.5))]
        assert results[0] is not None and results[1] is None and results[2] is not None
        assert _maybe(exporter, trained, tmp_path, 4, {}) is None
        with open(tmp_path / "export" / "best" / "best_metrics.json") as f:
            assert json.load(f) == {"loss": 0.5}

    def test_best_exporter_persists_gate_across_instances(self, trained, tmp_path):
        def make():
            return BestExporter(name="best", export_program=False,
                                compare_fn=create_valid_result_smaller("loss"))

        assert _maybe(make(), trained, tmp_path, 1, {"loss": 1.0})
        # A fresh instance (a resume) still refuses a worse metric.
        assert _maybe(make(), trained, tmp_path, 2, {"loss": 1.5}) is None

    def test_compare_fns(self):
        smaller = create_valid_result_smaller("m")
        larger = create_valid_result_larger("m")
        assert smaller(None, {"m": 1.0})
        assert smaller({"m": 1.0}, {"m": 0.5})
        assert not smaller({"m": 1.0}, {"m": 1.0})
        assert larger({"m": 1.0}, {"m": 2.0})
        assert not larger({"m": 1.0}, {"m": 0.5})
        assert not smaller({"m": 1.0}, {})

    def test_create_default_exporters(self):
        exporters = create_default_exporters(TransformerBCModel(**BC))
        assert [e.name for e in exporters] == ["latest", "best"]
        with pytest.raises(NotImplementedError, match="A10"):
            create_default_exporters(None, aot_executables=True)

    def test_ema_weights_are_exported(self, tmp_path):
        model = t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
            **CRITIC)
        trainer = Trainer(model, device="cpu")
        state = trainer.init_state()
        state.ema_params = {k: v + 1.0 for k, v in state.ema_params.items()}
        path = LatestExporter("latest", export_program=False).maybe_export(
            step=5, state=state, eval_metrics={}, compiled=trainer,
            model_dir=str(tmp_path))
        variables = ExportedModel(path, device="cpu").load_variables()
        for key, value in state.export_state_dict(use_ema=True).items():
            assert torch.equal(variables[key], value), key

    def test_version_gc(self, tmp_path):
        for ts in (100, 200, 300, 400):
            d = tmp_path / str(ts)
            d.mkdir()
            (d / "t2r_metadata.json").write_text("{}")
            (d / "variables.pt").write_bytes(b"")
        removed = DirectoryVersionGC(keep=2).collect(str(tmp_path))
        assert [os.path.basename(r) for r in removed] == ["100", "200"]
        assert [os.path.basename(d) for d in list_export_dirs(str(tmp_path))] == [
            "300", "400"]


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_export_holds_no_f32_copy(exports, tmp_path, bits):
    entry = exports["bc"]
    generator = DefaultExportGenerator()
    generator.set_specification_from_model(entry["model"])
    module = generator.create_serving_fn(
        entry["state"], device=torch.device("cpu"), quantize_weights=True,
        quantize_bits=bits)
    path = save_exported_model(
        str(tmp_path), variables=entry["state"],
        feature_spec=generator.serving_input_spec(), serving_module=module,
        example_features=generator.create_example_features())
    loaded = ExportedModel(path, device="cpu")
    assert loaded.metadata["weights_int8"] and loaded.metadata["weights_quantize_bits"] == bits
    program = torch.export.load(saved_model.program_path(path))
    big = [k for k, v in entry["state"].items() if v.ndim >= 2 and v.numel() >= 1024]
    assert big
    for name, value in program.state_dict.items():
        assert not (value.is_floating_point() and value.numel() >= 1024), name
    features = dict(make_random_numpy(loaded.feature_spec, batch_size=2, seed=2).items())
    got = loaded.predict(features)["action"]
    # The program computes the model on the dequantized weights...
    dequantized = loaded.load_variables()
    for key in big:
        assert not torch.equal(dequantized[key], entry["state"][key])
    with torch.no_grad():
        want = generator.create_serving_fn(dequantized, device=torch.device("cpu"))(
            {k: torch.from_numpy(v) for k, v in features.items()})["action"]
    np.testing.assert_allclose(got, want.numpy(), atol=BC_TOL, rtol=BC_TOL)
    if bits == 8:
        # ...and int8 stays within tests/test_quantization.py's tolerance
        # of the f32 export.
        f32 = entry["loaded"].predict(features)["action"]
        np.testing.assert_allclose(got, f32, atol=0.05, rtol=0.05)


def test_bf16_wrapper_exports_its_autocast(tmp_path):
    """The bf16 dtype policy (models/tpu_model_wrapper.py) exports as a
    program that keeps its autocast region and computes what the wrapped
    model computes eagerly, not an f32 program."""
    from tensor2robot_tpu_torch.models.tpu_model_wrapper import BFloat16ModelWrapper

    model = BFloat16ModelWrapper(TransformerBCModel(**BC))
    state = model.init_network(torch.Generator().manual_seed(5), "cpu").state_dict()
    path = _export(model, state, str(tmp_path))
    loaded = ExportedModel(path, device="cpu")
    assert loaded.has_program, loaded.metadata["program_error"]
    program = torch.export.load(saved_model.program_path(path))
    assert "wrap_with_autocast" in {str(n.target) for n in program.graph.nodes}
    generator, plain = DefaultExportGenerator(), DefaultExportGenerator()
    generator.set_specification_from_model(model)
    plain.set_specification_from_model(TransformerBCModel(**BC))
    eager = generator.create_serving_fn(state, device=torch.device("cpu"))
    # The same weights without the policy.
    f32 = plain.create_serving_fn(state, device=torch.device("cpu"))
    features = dict(make_random_numpy(loaded.feature_spec, batch_size=2, seed=6).items())
    tensors = {k: torch.from_numpy(v) for k, v in features.items()}
    got = loaded.predict(features)["action"]
    with torch.no_grad():
        np.testing.assert_array_equal(got, eager(tensors)["action"].float().numpy())
        assert not np.allclose(got, f32(tensors)["action"].numpy(), atol=1e-6, rtol=0)


def test_tf_example_parse_fn_feeds_the_numpy_interface(exports):
    """Serialized tf.Examples parsed by the export generator's host-side
    parser serve the same actions as the numpy batch they encode."""
    from tensor2robot_tpu_torch.data.encoder import encode_example

    entry = exports["critic"]
    generator = DefaultExportGenerator()
    generator.set_specification_from_model(entry["model"])
    spec = generator.serving_input_spec()
    batch = dict(make_random_numpy(spec, batch_size=2, seed=8).items())
    serialized = [encode_example(spec, {k: v[i] for k, v in batch.items()})
                  for i in range(2)]
    parsed = generator.create_tf_example_parse_fn()(serialized)
    assert set(parsed) == set(batch)
    for key, value in batch.items():
        assert parsed[key].shape == value.shape and parsed[key].dtype == value.dtype
        if spec[key].data_format is None:
            np.testing.assert_array_equal(parsed[key], value)
    out = entry["loaded"].predict(parsed)
    assert out["q_predicted"].shape[0] == 2
