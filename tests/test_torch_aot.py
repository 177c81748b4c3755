"""AOT serving packages: artifact layout, the restore ladder and the
loud-fallback contract (the port's twin of tests/test_aot.py).

Five AOTInductor builds in all, made by one module fixture whose four
exports run side by side (each bucket compiles in its own spawned
process):

  * the mock at buckets (1, 2), the f32 program;
  * the mock's int8 regime at bucket 1, from an export whose f32 program
    fails to trace (so only the regime's program is built);
  * the tiny BC (2 layers, d_model 32) with flash heads at bucket 1: B2's
    operator runs inside the package, and the served action stays within
    the export tests' BC tolerance of the JAX package's program on the
    same converted weights (its export made with T2R_AOT_EXPORT=0 and read
    with T2R_SERVE_AOT=0: JAX's AOT path is no oracle, ROADMAP C-ref1);
  * one static program of MAML over the mock (batch 1).

Held, as tests/test_aot.py holds the JAX package's: an AOT hit serves
with zero eager calls (`fresh_trace_calls == 0`) within AOT_TOL (abs +
rel) of the eager exported program (not bit for bit as in JAX: Inductor
fuses the elementwise ops), and bit for bit across two boots; every
mismatch (artifact fingerprint, device topology, torch or CUDA version,
a truncated, bitflipped or foreign file from the JAX package's
analysis/corpus.py corruption family) is a typed, logged, counted
fallback that serves the right artifact's outputs; T2R_SERVE_AOT=0 (or
no aot/) is the pre-AOT path; T2R_AOT_REQUIRE raises as JAX's does. Every
corruption, key and server case copies the module's exports and builds
nothing. Not twinned: JAX's warm compile-cache build (an XLA
serialization fault with no Inductor counterpart) and its fp8_e4m3 AOT
case (a sixth build).
"""

import concurrent.futures
import json
import logging
import os
import shutil
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.analysis import corpus
from tensor2robot_tpu.export import saved_model as jax_saved_model
from tensor2robot_tpu.models import transformer_models as jax_models
from tensor2robot_tpu.specs import make_random_numpy as jax_make_random_numpy
from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct
from tensor2robot_tpu_torch import flags
from tensor2robot_tpu_torch.export import aot as aot_lib
from tensor2robot_tpu_torch.export import saved_model
from tensor2robot_tpu_torch.export.export_generators import DefaultExportGenerator
from tensor2robot_tpu_torch.export.exporters import LatestExporter
from tensor2robot_tpu_torch.export.saved_model import ExportedModel, latest_export_dir
from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
from tensor2robot_tpu_torch.ops import flash_attention as fa
from tensor2robot_tpu_torch.predictors import ExportedSavedModelPredictor
from tensor2robot_tpu_torch.serving import PolicyServer
from tensor2robot_tpu_torch.specs import make_random_numpy
from tensor2robot_tpu_torch.train.train_eval import Trainer
from tensor2robot_tpu_torch.utils import jax_params, mocks
from tests.test_torch_export import BC, BC_TOL, _jax_export
from tensor2robot_tpu.utils import mocks as jax_mocks
from tests.test_torch_maml_export import TOL as MAML_TOL
from tests.test_torch_maml_export import _jax_outputs, _request
from tests.test_torch_meta_learning import _JaxMockMAML, _MockMAML

BUCKETS = (1, 2)
#: An AOT hit against the eager exported program, abs + rel.
AOT_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def trained():
    model = mocks.MockT2RModel(device_type="cpu")
    trainer = Trainer(model, device="cpu")
    return trainer, trainer.init_state(torch.Generator().manual_seed(0))


def _export(trained, model_dir, *, step=1, state=None, ladder=BUCKETS, **kwargs):
    trainer, default_state = trained
    exporter = LatestExporter(name="latest", warmup_batch_sizes=ladder, **kwargs)
    exporter.maybe_export(step=step, state=default_state if state is None else state,
                          eval_metrics={"loss": 1.0}, compiled=trainer,
                          model_dir=str(model_dir))
    return exporter.export_root(str(model_dir))


class _Untraceable(torch.nn.Module):
    """A serving module whose f32 program cannot be traced (it still runs
    eagerly, so the serve-quant gate has its baseline)."""

    takes_gradients = False

    def __init__(self, inner):
        super().__init__()
        self.inner = inner
        self.network = inner.network

    def forward(self, features):
        if torch.compiler.is_compiling():
            raise RuntimeError("f32 lowering exploded")
        return self.inner(features)


class _NoF32Program(DefaultExportGenerator):
    """Serves its f32 program through _Untraceable; a regime's module keeps
    the plain one inside."""

    _inner = False

    def create_serving_fn(self, *args, **kwargs):
        module = super().create_serving_fn(*args, **kwargs)
        return module if self._inner else _Untraceable(module)

    def create_quant_serving_fn(self, *args, **kwargs):
        self._inner = True
        try:
            return super().create_quant_serving_fn(*args, **kwargs)
        finally:
            self._inner = False


def _bc_export(root):
    """The tiny flash BC of tests/test_torch_export.py from seed-0 JAX
    variables: the port's export with a package at bucket 1, JAX's without
    AOT, and a fresh bucket-1 request."""
    jax_model = jax_models.TransformerBCModel(interpret=True, device_type="cpu", **BC)
    model = TransformerBCModel(**BC)
    raw = jax_make_random_numpy(
        jax_model.preprocessor.get_in_feature_specification("predict"), batch_size=2,
        seed=4)
    features, _ = jax_model.preprocessor.preprocess(raw, None, mode="predict", rng=None)
    variables = jax.tree_util.tree_map(
        np.asarray, dict(jax_model.init_variables(jax.random.PRNGKey(0), features)))
    generator = DefaultExportGenerator()
    generator.set_specification_from_model(model)
    state = jax_params.flax_variables_to_state_dict(variables)
    module = generator.create_serving_fn(state, device=torch.device("cpu"))
    request = dict(make_random_numpy(generator.serving_input_spec(), batch_size=1,
                                     seed=11).items())
    path = saved_model.save_exported_model(
        str(root / "port"), variables=state, feature_spec=generator.serving_input_spec(),
        serving_module=module, example_features=generator.create_example_features(),
        calibration_batches=[request], aot_executables=True)
    return dict(path=path, request=request, jax_model=jax_model, variables=variables)


def _maml_export(root):
    """MAML over the mock (one inner step): its static program at batch 1
    with its package, from seed-0 JAX variables."""
    kwargs = dict(num_inner_loop_steps=1, inner_learning_rate=0.1)
    jax_model = _JaxMockMAML(base_model=jax_mocks.MockT2RModel(use_batch_norm=False),
                             **kwargs)
    model = _MockMAML(base_model=mocks.MockT2RModel(use_batch_norm=False), **kwargs)
    generator = DefaultExportGenerator()
    generator.set_specification_from_model(model)
    request = _request(generator, 1)
    features, _ = jax_model.preprocessor.preprocess(JaxStruct(dict(request)), None,
                                                    mode="predict", rng=None)
    variables = jax.tree_util.tree_map(
        np.asarray, dict(jax_model.init_variables(jax.random.PRNGKey(0), features,
                                                  "predict")))
    state = jax_params.flax_variables_to_state_dict(variables)
    serving = generator.create_serving_fn(state, device=torch.device("cpu"))
    assert serving.takes_gradients
    path = saved_model.save_exported_model(
        str(root), state, generator.serving_input_spec(), serving_module=serving,
        example_features=generator.create_example_features(), program_batches=(1,),
        calibration_batches=[request], aot_executables=True)
    return dict(path=path, request=request, jax_model=jax_model, variables=variables)


@pytest.fixture(scope="module")
def builds(trained, tmp_path_factory):
    """The module's five package builds, four exports at once; then the
    JAX package's BC export (no AOT) as the BC oracle."""
    root = tmp_path_factory.mktemp("aot")
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        f32 = pool.submit(_export, trained, root / "f32", aot_executables=True)
        int8 = pool.submit(_export, trained, root / "int8", ladder=(1,),
                           aot_executables=True, serve_quant=("int8",),
                           export_generator=_NoF32Program())
        bc = pool.submit(_bc_export, root / "bc")
        maml = pool.submit(_maml_export, root / "maml")
        out = dict(f32=f32.result(), int8=int8.result(), bc=bc.result(),
                   maml=maml.result())
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("T2R_AOT_EXPORT", "0")
        patch.setenv("T2R_SERVE_AOT", "0")
        bc = out["bc"]
        jax_path = _jax_export(bc["jax_model"], bc["variables"], str(root / "bc" / "jax"))
        bc["jax"] = jax_saved_model.ExportedModel(jax_path, quant_regime="none").predict(
            bc["request"])
    return out


@pytest.fixture
def export_root(builds):
    return builds["f32"]


def _meta(path):
    with open(os.path.join(path, "t2r_metadata.json")) as f:
        return json.load(f)


def _copy_export(export_root, tmp_path):
    """Private writable copy of the newest export dir (corruption tests
    must never mutate the module-scoped artifact)."""
    src = latest_export_dir(export_root)
    dst = os.path.join(str(tmp_path), os.path.basename(src))
    shutil.copytree(src, dst)
    return dst


def _example(n=2, seed=0):
    return {"x": np.random.RandomState(seed).uniform(-1, 1, (n, 3)).astype(np.float32)}


def _fresh_outputs(export_dir, features, monkeypatch, quant_regime="none"):
    """The eager twin: same artifact, T2R_SERVE_AOT=0."""
    monkeypatch.setenv("T2R_SERVE_AOT", "0")
    try:
        loaded = ExportedModel(export_dir, device="cpu", quant_regime=quant_regime)
        assert not loaded.aot_executables
        return loaded.predict(features)
    finally:
        monkeypatch.delenv("T2R_SERVE_AOT")


def _close(got, want, tol=AOT_TOL):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=tol, rtol=tol, err_msg=key)


def _same(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


class TestArtifactLayout:
    def test_aot_dir_and_metadata_contract(self, export_root):
        path = latest_export_dir(export_root)
        aot = _meta(path)["aot"]
        assert aot["format_version"] == aot_lib.AOT_FORMAT_VERSION
        assert aot["topology"] == aot_lib.device_topology("cpu")
        assert aot["buckets"]["none"] == list(BUCKETS)
        assert aot["nbytes"]["none"] > 0
        assert len(aot["fingerprint"]["none"]) == 64
        assert sorted(aot["compile_ms"]["none"]) == [str(b) for b in BUCKETS]
        # Each package was held against its program on its warmup batch.
        assert sorted(aot["parity"]["none"]) == [str(b) for b in BUCKETS]
        assert all(v <= aot_lib.PACKAGE_PARITY_TOL for v in aot["parity"]["none"].values())
        assert "errors" not in aot
        for bucket in BUCKETS:
            target = os.path.join(path, aot_lib.aot_relpath("none", bucket))
            with open(target, "rb") as f:
                header, _ = aot_lib._unpack(f.read())
            assert header["bucket"] == bucket and header["regime"] == "none"
            assert header["features"] == {"x": {"shape": [bucket, 3], "dtype": "float32"}}
            assert header["torch"] == torch.__version__

    def test_quant_regimes_get_their_own_executables(self, builds):
        path = latest_export_dir(builds["int8"])
        aot = _meta(path)["aot"]
        assert aot["buckets"]["int8"] == [1]
        assert (aot["fingerprint"]["int8"]
                != _meta(latest_export_dir(builds["f32"]))["aot"]["fingerprint"]["none"])
        assert os.path.exists(os.path.join(path, aot_lib.aot_relpath("int8", 1)))

    @pytest.mark.parametrize("flag", ["0", None], ids=["off", "default"])
    def test_export_flag_off_writes_pre_aot_layout(self, trained, tmp_path, monkeypatch,
                                                    flag):
        # The port's T2R_AOT_EXPORT defaults to 0 (JAX's to 1).
        if flag is None:
            monkeypatch.delenv("T2R_AOT_EXPORT", raising=False)
        else:
            monkeypatch.setenv("T2R_AOT_EXPORT", flag)
        path = latest_export_dir(_export(trained, tmp_path))
        assert not os.path.exists(os.path.join(path, aot_lib.AOT_DIR))
        assert "aot" not in _meta(path)
        loaded = ExportedModel(path, device="cpu")
        assert loaded.aot_declared == ()
        assert not loaded.aot_executables
        assert loaded.predict(_example())["a_predicted"].shape[0] == 2

    def test_failed_default_program_still_exports_quant_executables(self, builds):
        path = latest_export_dir(builds["int8"])
        meta = _meta(path)
        assert meta["program"] is False and "f32 lowering exploded" in meta["program_error"]
        aot = meta["aot"]
        assert aot["buckets"]["int8"] == [1]
        assert "none" not in aot["buckets"]
        assert "no serving program" in aot["errors"]["none"]
        loaded = ExportedModel(path, device="cpu", quant_regime="int8")
        assert sorted(loaded.aot_executables) == [1]

    def test_failed_build_is_recorded_and_the_version_lands(self, trained, tmp_path,
                                                           monkeypatch):
        monkeypatch.setattr(aot_lib, "build_packages",
                            lambda jobs, device: [RuntimeError("no compiler")] * len(jobs))
        path = latest_export_dir(_export(trained, tmp_path, aot_executables=True))
        aot = _meta(path)["aot"]
        assert aot["errors"] == {"none": "RuntimeError: no compiler"}
        assert aot["buckets"] == {} and not os.path.exists(os.path.join(path, "aot"))
        assert ExportedModel(path, device="cpu").predict(_example())["a_predicted"].shape == (2, 1)

    def test_package_gate_refuses_a_package_off_its_program(self):
        """A package must compute its program on its bucket's warmup batch
        (aot.check_package, run at export; a refusal fails the regime)."""
        batch = {"x": np.ones((2, 3), np.float32)}

        def program(features):
            return {"a": features["x"] * 2.0}

        def near(features):
            return {"a": features["x"] * 2.0 + 1e-6}

        def off(features):
            return {"a": features["x"] * 2.0 + 1e-3}

        assert 0 < aot_lib.check_package(near, program, batch, None, "cpu") < 1e-6
        with pytest.raises(aot_lib.AOTError, match="diverges from its program"):
            aot_lib.check_package(off, program, batch, None, "cpu")
        assert aot_lib.check_package(off, program, batch, None, "cpu", tolerance=1e-3) > 0

    def test_exporter_config_validation(self):
        with pytest.raises(ValueError, match="warmup_batch_sizes"):
            LatestExporter(name="latest", aot_executables=True)
        with pytest.raises(ValueError, match="serialize_stablehlo"):
            LatestExporter(name="latest", warmup_batch_sizes=BUCKETS,
                           aot_executables=True, serialize_stablehlo=False)


class TestRestoreLadder:
    def test_aot_hit_is_bitwise_equal_to_fresh_compile(self, export_root, monkeypatch):
        """The port's terms: within AOT_TOL of the eager program, never
        calling it, and bit for bit across two boots."""
        path = latest_export_dir(export_root)
        loaded = ExportedModel(path, device="cpu")
        assert sorted(loaded.aot_executables) == list(BUCKETS)
        assert loaded.aot_fallbacks == {}
        features = _example()
        got = loaded.predict(features)
        assert loaded.fresh_trace_calls == 0  # never touched the eager program
        _close(got, _fresh_outputs(path, features, monkeypatch))
        _same(ExportedModel(path, device="cpu").predict(features), got)

    @pytest.mark.parametrize("regime", ["int8"])
    def test_quant_regime_aot_hit_bitwise(self, builds, monkeypatch, regime):
        path = latest_export_dir(builds["int8"])
        loaded = ExportedModel(path, device="cpu", quant_regime=regime)
        assert sorted(loaded.aot_executables) == [1]
        # The regime is NATIVE: its program carries int8 contractions.
        assert loaded.native_dot_layers, loaded.metadata["serve_quant"]
        assert loaded.metadata["serve_quant"]["dot_audit"][regime].get("i8", 0) >= 1
        features = _example(n=1, seed=5)
        got = loaded.predict(features)
        assert loaded.fresh_trace_calls == 0
        _close(got, _fresh_outputs(path, features, monkeypatch, quant_regime=regime))
        _same(ExportedModel(path, device="cpu", quant_regime=regime).predict(features), got)

    def test_serve_aot_off_reproduces_the_pre_aot_path(self, export_root, monkeypatch):
        monkeypatch.setenv("T2R_SERVE_AOT", "0")
        loaded = ExportedModel(latest_export_dir(export_root), device="cpu")
        assert not loaded.aot_enabled
        assert not loaded.aot_executables
        assert not loaded.aot_fallbacks  # off is a choice, not a fallback
        out = loaded.predict(_example())
        assert loaded.fresh_trace_calls > 0  # the exported program served it
        assert out["a_predicted"].shape[0] == 2

    def test_novel_batch_size_rides_the_fresh_path(self, export_root, monkeypatch):
        path = latest_export_dir(export_root)
        loaded = ExportedModel(path, device="cpu")
        features = _example(n=3)  # 3 is not a bucket
        got = loaded.predict(features)
        assert loaded.fresh_trace_calls == 1
        _same(got, _fresh_outputs(path, features, monkeypatch))

    def test_transplanted_aot_dir_never_serves_stale_weights(self, trained, export_root,
                                                             tmp_path, monkeypatch, caplog):
        """aot/ of artifact A (with its metadata's declaration) spliced into
        artifact B (other weights) falls back on every bucket, and the
        fallback serves B's outputs, not A's packages."""
        trainer, _ = trained
        other_state = trainer.init_state(torch.Generator().manual_seed(7))
        other_root = _export(trained, tmp_path / "other", step=2, state=other_state,
                             aot_executables=False)
        victim = _copy_export(other_root, tmp_path)
        stale = latest_export_dir(export_root)
        shutil.copytree(os.path.join(stale, aot_lib.AOT_DIR),
                        os.path.join(victim, aot_lib.AOT_DIR))
        meta = _meta(victim)
        meta["aot"] = _meta(stale)["aot"]
        with open(os.path.join(victim, "t2r_metadata.json"), "w") as f:
            json.dump(meta, f)
        with caplog.at_level(logging.WARNING):
            loaded = ExportedModel(victim, device="cpu")
        assert loaded.aot_executables == {}
        assert set(loaded.aot_fallbacks) == set(BUCKETS)
        assert all(reason == "AOTKeyMismatch" for reason in loaded.aot_fallbacks.values())
        assert any("fingerprint" in r.message for r in caplog.records)
        features = _example()
        got = loaded.predict(features)
        _same(got, _fresh_outputs(victim, features, monkeypatch))
        stale_out = ExportedModel(stale, device="cpu").predict(features)
        assert not np.allclose(got["a_predicted"], stale_out["a_predicted"])

    def test_topology_mismatch_never_loads_silently(self, export_root, tmp_path,
                                                    monkeypatch, caplog):
        """A package built for another device never loads: one loud line,
        every bucket counted, the exported program serves."""
        path = _copy_export(export_root, tmp_path)
        real = aot_lib.device_topology("cpu")
        monkeypatch.setattr(aot_lib, "device_topology",
                            lambda device=None: {**real, "device_count": 9})
        with caplog.at_level(logging.WARNING):
            loaded = ExportedModel(path, device="cpu")
        assert loaded.aot_executables == {}
        assert all(r == "topology_mismatch" for r in loaded.aot_fallbacks.values())
        assert set(loaded.aot_fallbacks) == set(BUCKETS)
        assert any("topology" in r.message for r in caplog.records)
        assert loaded.predict(_example())["a_predicted"].shape[0] == 2
        assert loaded.fresh_trace_calls > 0

    def test_per_file_topology_key_is_checked(self, export_root, tmp_path):
        """Even with a lying metadata block, the file's own key refuses a
        package built for another device."""
        path = _copy_export(export_root, tmp_path)
        target = os.path.join(path, aot_lib.aot_relpath("none", 1))
        with open(target, "rb") as f:
            header, payload = aot_lib._unpack(f.read())
        header["topology"] = {**header["topology"], "platform": "cuda",
                              "device_name": "NVIDIA H100 80GB HBM3"}
        with open(target, "wb") as f:
            f.write(aot_lib._pack(header, payload))
        with open(target, "rb") as f:
            blob = f.read()
        with pytest.raises(aot_lib.AOTKeyMismatch, match="topology"):
            aot_lib.load_executable(blob, expect_topology=aot_lib.device_topology("cpu"))
        loaded = ExportedModel(path, device="cpu")
        assert 1 not in loaded.aot_executables
        assert loaded.aot_fallbacks == {1: "AOTKeyMismatch"}
        assert sorted(loaded.aot_executables) == [2]  # its sibling intact

    @pytest.mark.parametrize("key", ["torch", "cuda"])
    def test_jax_version_mismatch_is_a_typed_fallback(self, export_root, tmp_path, key):
        # The port keys the torch and CUDA versions where JAX keys jax's.
        path = _copy_export(export_root, tmp_path)
        target = os.path.join(path, aot_lib.aot_relpath("none", 2))
        with open(target, "rb") as f:
            header, payload = aot_lib._unpack(f.read())
        header[key] = "0.0.0-foreign"
        with open(target, "wb") as f:
            f.write(aot_lib._pack(header, payload))
        loaded = ExportedModel(path, device="cpu")
        assert loaded.aot_fallbacks == {2: "AOTKeyMismatch"}
        assert sorted(loaded.aot_executables) == [1]

    def test_every_corruption_variant_is_typed_never_partial(self, export_root):
        """analysis/corpus.py's frame family over the envelope: each
        truncation, seeded bitflip, forged length and bad magic raises
        AOTCorrupt, at integrity, before any key check or load."""
        path = latest_export_dir(export_root)
        with open(os.path.join(path, aot_lib.aot_relpath("none", 1)), "rb") as f:
            blob = f.read()
        variants = corpus.corrupt_frame_variants(blob)
        assert len(variants) >= 15
        for name, bad in variants.items():
            with pytest.raises(aot_lib.AOTCorrupt):
                aot_lib.load_executable(bad)
            with pytest.raises(aot_lib.AOTCorrupt):
                aot_lib.load_executable(bad, expect_fingerprint="0" * 64,
                                        expect_topology=aot_lib.device_topology("cpu"))

    @pytest.mark.parametrize("variant", ["frame_trunc", "frame_bitflip", "frame_bad_magic"])
    def test_corrupt_file_falls_back_and_serves_correctly(self, export_root, tmp_path,
                                                          monkeypatch, caplog, variant):
        path = _copy_export(export_root, tmp_path)
        target = os.path.join(path, aot_lib.aot_relpath("none", 1))
        with open(target, "rb") as f:
            blob = f.read()
        name, bad = next((n, b) for n, b in sorted(corpus.corrupt_frame_variants(blob).items())
                         if n.startswith(variant))
        with open(target, "wb") as f:
            f.write(bad)
        with caplog.at_level(logging.WARNING):
            loaded = ExportedModel(path, device="cpu")
        assert loaded.aot_fallbacks == {1: "AOTCorrupt"}, name
        assert sorted(loaded.aot_executables) == [2]
        features = _example(n=1, seed=3)
        got = loaded.predict(features)  # bucket 1 -> the exported program
        assert loaded.fresh_trace_calls == 1
        _same(got, _fresh_outputs(path, features, monkeypatch))

    def test_missing_file_is_a_counted_fallback(self, export_root, tmp_path):
        path = _copy_export(export_root, tmp_path)
        os.remove(os.path.join(path, aot_lib.aot_relpath("none", 2)))
        loaded = ExportedModel(path, device="cpu")
        assert loaded.aot_fallbacks == {2: "missing"}
        assert not loaded.aot_covered

    def test_require_mode_fails_loudly_instead_of_falling_back(self, export_root, tmp_path,
                                                               monkeypatch):
        path = _copy_export(export_root, tmp_path)
        monkeypatch.setenv("T2R_AOT_REQUIRE", "1")
        assert ExportedModel(path, device="cpu").aot_covered  # clean artifact boots
        os.remove(os.path.join(path, aot_lib.aot_relpath("none", 2)))
        with pytest.raises(aot_lib.AOTError, match="T2R_AOT_REQUIRE"):
            ExportedModel(path, device="cpu")

    def test_require_with_serve_aot_off_names_the_flag_conflict(self, export_root,
                                                                monkeypatch):
        monkeypatch.setenv("T2R_AOT_REQUIRE", "1")
        monkeypatch.setenv("T2R_SERVE_AOT", "0")
        with pytest.raises(aot_lib.AOTError, match="conflicts with"):
            ExportedModel(latest_export_dir(export_root), device="cpu")


class TestPrograms:
    """The packages of the flash BC and of a MAML static program."""

    def test_bc_package_runs_b2_and_matches_jax(self, builds, monkeypatch):
        bc = builds["bc"]
        calls = []
        plain = fa.flash_attention_plain

        def counted(*args, **kwargs):
            calls.append(1)
            return plain(*args, **kwargs)

        monkeypatch.setattr(fa, "flash_attention_plain", counted)
        loaded = ExportedModel(bc["path"], device="cpu")
        assert sorted(loaded.aot_executables) == [1]
        got = loaded.predict(bc["request"])
        assert loaded.fresh_trace_calls == 0
        # B2's operator, called from the package through the proxy
        # executor, once a layer.
        assert len(calls) == BC["num_layers"]
        _close(got, _fresh_outputs(bc["path"], bc["request"], monkeypatch))
        want = bc["jax"]
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], atol=BC_TOL, rtol=BC_TOL,
                                       err_msg=key)

    def test_maml_static_program_package(self, builds, monkeypatch):
        maml = builds["maml"]
        loaded = ExportedModel(maml["path"], device="cpu")
        assert loaded.program_batches == [1]
        assert sorted(loaded.aot_executables) == [1]
        got = loaded.predict(maml["request"])
        assert loaded.fresh_trace_calls == 0
        _close(got, _fresh_outputs(maml["path"], maml["request"], monkeypatch))
        want = _jax_outputs(maml["jax_model"], maml["variables"], maml["request"])
        for key in want:
            np.testing.assert_allclose(got[key], want[key], atol=MAML_TOL, rtol=MAML_TOL,
                                       err_msg=key)
        _same(ExportedModel(maml["path"], device="cpu").predict(maml["request"]), got)


class _RecordingPredictor:
    """Served-batch-size recorder (the test_serving discipline)."""

    def __init__(self, inner):
        self._inner = inner
        self.batch_sizes = []

    def _record(self, features):
        sizes = {int(np.asarray(v).shape[0]) for v in features.values()}
        assert len(sizes) == 1, f"ragged batch: {sizes}"
        self.batch_sizes.append(sizes.pop())

    def predict(self, features):
        self._record(features)
        return self._inner.predict(features)

    def predict_versioned(self, features):
        self._record(features)
        return self._inner.predict_versioned(features)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _root_with(export_root, tmp_path, versions=(1,)):
    """A served root holding copies of the export as the given versions."""
    root = os.path.join(str(tmp_path), "root")
    src = latest_export_dir(export_root)
    for version in versions:
        shutil.copytree(src, os.path.join(root, str(version)))
    return root


class TestServerIntegration:
    def test_aot_boot_prewarm_source_and_zero_fresh_compiles(self, export_root):
        inner = ExportedSavedModelPredictor(export_dir=export_root, device="cpu")
        assert inner.restore()
        predictor = _RecordingPredictor(inner)
        with PolicyServer(predictor, max_wait_ms=1).start() as server:
            response = server.call({"x": np.zeros((3,), np.float32)}, timeout=30)
            snap = server.snapshot()
        assert sorted(set(predictor.batch_sizes)) == list(BUCKETS)
        assert snap["prewarm_source"] == {str(b): "aot" for b in BUCKETS}
        assert snap["counters"]["aot_hits"] == len(BUCKETS)
        assert snap["counters"]["aot_misses"] == 0
        assert "aot_fallbacks" not in snap
        assert snap["model_fingerprint"] == _meta(
            latest_export_dir(export_root))["aot"]["fingerprint"]["none"]
        assert inner.loaded_model.fresh_trace_calls == 0
        assert response.outputs["a_predicted"].shape == (1,)

    def test_fallback_bucket_is_counted_and_surfaced(self, export_root, tmp_path):
        root = _root_with(export_root, tmp_path)
        target = os.path.join(latest_export_dir(root), aot_lib.aot_relpath("none", 2))
        with open(target, "rb") as f:
            blob = f.read()
        with open(target, "wb") as f:
            f.write(blob[: len(blob) // 2])  # torn mid-payload
        predictor = ExportedSavedModelPredictor(export_dir=root, device="cpu")
        assert predictor.restore()
        with PolicyServer(predictor, max_wait_ms=1).start() as server:
            snap = server.snapshot()
        assert snap["prewarm_source"]["1"] == "aot"
        assert snap["prewarm_source"]["2"] in ("cache", "compile")
        assert snap["counters"]["aot_hits"] == 1
        assert snap["counters"]["aot_misses"] == 1
        assert snap["aot_fallbacks"] == {"2": "AOTCorrupt"}

    def test_failed_swap_prewarm_keeps_serving_version_sources(self, export_root):
        """A swap aborted by a failed prewarm keeps the OLD version's
        record and counters."""
        predictor = ExportedSavedModelPredictor(export_dir=export_root, device="cpu")
        assert predictor.restore()
        with PolicyServer(predictor, max_wait_ms=1).start() as server:
            before = server.snapshot()
            assert before["prewarm_source"] == {str(b): "aot" for b in BUCKETS}

            class _IncomingWithoutAOT:
                aot_executables = {}
                aot_enabled = True

            def broken_serve_fn(batch):
                raise RuntimeError("incoming version cannot serve")

            with pytest.raises(RuntimeError, match="cannot serve"):
                server._prewarm_restored(_IncomingWithoutAOT(), broken_serve_fn)
            after = server.snapshot()
        assert after["prewarm_source"] == before["prewarm_source"]
        assert after["counters"]["aot_hits"] == before["counters"]["aot_hits"]
        assert after["counters"]["aot_misses"] == before["counters"]["aot_misses"]

    def test_hot_swap_records_incoming_version_sources(self, export_root, tmp_path):
        root = _root_with(export_root, tmp_path, versions=(1,))
        predictor = ExportedSavedModelPredictor(export_dir=root, device="cpu")
        assert predictor.restore()
        with PolicyServer(predictor, max_wait_ms=1).start() as server:
            v1 = predictor.model_version
            shutil.copytree(latest_export_dir(export_root), os.path.join(root, "2"))
            assert server.hot_swap(wait=True)
            assert predictor.model_version > v1
            response = server.call({"x": np.zeros((3,), np.float32)}, timeout=30)
            snap = server.snapshot()
        assert snap["prewarm_source"] == {str(b): "aot" for b in BUCKETS}
        assert snap["counters"]["aot_hits"] == 2 * len(BUCKETS)
        assert predictor.loaded_model.fresh_trace_calls == 0
        assert response.model_version > v1


class _SlowTrace(torch.nn.Module):
    """Signals once torch.export is tracing it, then holds the trace open
    a while."""

    def __init__(self):
        super().__init__()
        self.tracing = threading.Event()

    def forward(self, features):
        self.tracing.set()
        time.sleep(0.5)
        return {"y": features["x"] * 2.0}


class _EagerOnly(torch.nn.Module):
    def forward(self, features):
        if torch.compiler.is_compiling():
            raise RuntimeError("an eager call ran inside another thread's trace")
        return {"y": features["x"] * 2.0}


class TestTraceLock:
    """The export path's eager runs wait for an export tracing on another
    thread (exports side by side): torch.export's tracing state is the
    whole process's, so an eager call made during it is routed through
    the other thread's tracer."""

    @pytest.mark.parametrize("eager_run", ["run_batch", "check_package"])
    def test_eager_run_waits_for_a_trace_on_another_thread(self, eager_run):
        slow = _SlowTrace()
        example = {"x": np.ones((2, 3), np.float32)}
        tracer = threading.Thread(
            target=saved_model.export_program, args=(slow, example))
        tracer.start()
        try:
            assert slow.tracing.wait(timeout=60)
            eager = _EagerOnly()
            if eager_run == "run_batch":
                out = saved_model.run_batch(eager, example, "cpu")
                np.testing.assert_array_equal(out["y"], example["x"] * 2.0)
            else:
                assert aot_lib.check_package(eager, eager, example, None, "cpu") == 0.0
        finally:
            tracer.join(timeout=60)
        assert not tracer.is_alive()


class TestBuildLock:
    """Builds that could write the same files in Inductor's cache take one
    lock: equal code needs equal device and feature shapes and dtypes."""

    @staticmethod
    def _path(device, **features):
        batch = {key: aot_lib.meta_tensor(shape, dtype)
                 for key, (shape, dtype) in features.items()}
        return aot_lib._build_lock(batch, device).lock_file

    def test_same_signature_same_lock(self):
        a = self._path("cpu", x=((1, 3), np.float32), y=((1, 2), np.int32))
        b = self._path("cpu", y=((1, 2), np.int32), x=((1, 3), np.float32))
        assert a == b
        assert os.path.dirname(a).endswith("locks")

    @pytest.mark.parametrize("device, shape, dtype", [
        ("cpu", (2, 3), np.float32),
        ("cpu", (1, 3), np.float16),
        ("cuda", (1, 3), np.float32),
    ])
    def test_other_signature_other_lock(self, device, shape, dtype):
        assert (self._path("cpu", x=((1, 3), np.float32))
                != self._path(device, x=(shape, dtype)))


class TestFlagsDeclared:
    def test_aot_flags_in_registry(self):
        assert flags.get_flag("T2R_SERVE_AOT").kind == "bool"
        assert flags.get_flag("T2R_AOT_EXPORT").kind == "bool"
        assert flags.get_flag("T2R_AOT_REQUIRE").kind == "bool"
        assert flags.get_bool("T2R_SERVE_AOT") is True
        # The port's one stated divergence from JAX's defaults.
        assert flags.get_bool("T2R_AOT_EXPORT") is False
        assert flags.get_bool("T2R_AOT_REQUIRE") is False
