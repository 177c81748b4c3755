"""ExportedSavedModelPredictor and the SavedModel-v2 family of the port,
as tests/test_predictors.py holds the JAX package's: codeless restore,
the model-code fallback, the restore timeout, new versions, async
restore without a duplicate thread, the restore prewarm (before the
swap; a failed one keeps the old version), action tiling and random init.

Exports are made once (a version with a program, one without) and copied
into fresh roots under chosen version names.
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from tensor2robot_tpu_torch.export import DefaultExportGenerator, save_exported_model
from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
from tensor2robot_tpu_torch.predictors import (
    CheckpointPredictor,
    ExportedSavedModelPredictor,
    SavedModelCodePredictor,
    SavedModelSignaturePredictor,
)
from tensor2robot_tpu_torch.specs import (
    ExtendedTensorSpec,
    TensorSpecStruct,
    make_random_numpy,
)

BC = dict(episode_length=16, image_size=(16, 16), d_model=32, num_layers=2,
          num_heads=2, head_dim=16, use_flash=True)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """{'program': dir, 'code': dir without a program}, the weights, and a
    reference predictor over them."""
    model = TransformerBCModel(**BC)
    state = model.init_network(torch.Generator().manual_seed(3), "cpu").state_dict()
    generator = DefaultExportGenerator()
    generator.set_specification_from_model(model)
    root = tmp_path_factory.mktemp("exports")
    dirs = {}
    for name, program in (("program", True), ("code", False)):
        dirs[name] = save_exported_model(
            str(root / name), variables=state,
            feature_spec=generator.serving_input_spec(),
            label_spec=generator.label_spec, global_step=3,
            serving_module=generator.create_serving_fn(state, device=torch.device("cpu")),
            example_features=generator.create_example_features(),
            export_program_file=program,
            metadata={"warmup_batch_sizes": [1, 2]},
        )
    reference = CheckpointPredictor(TransformerBCModel(**BC), device="cpu")
    reference.load_state_dict(state)
    return dirs, reference


def _place(exported, root, version, kind="program"):
    """Copies an export into `root` as version `version`, atomically."""
    dirs, _ = exported
    tmp = os.path.join(root, f"temp-{version}")
    shutil.copytree(dirs[kind], tmp)
    os.replace(tmp, os.path.join(root, str(version)))
    return os.path.join(root, str(version))


def _features(batch=2, seed=0):
    spec = TensorSpecStruct(
        image=ExtendedTensorSpec(shape=(16, 16, 16, 3), dtype=np.float32),
        gripper_pose=ExtendedTensorSpec(shape=(16, 14), dtype=np.float32))
    return dict(make_random_numpy(spec, batch_size=batch, seed=seed).items())


@pytest.fixture(autouse=True)
def _fast_polls(monkeypatch):
    from tensor2robot_tpu_torch.predictors import exported_savedmodel_predictor

    monkeypatch.setattr(exported_savedmodel_predictor, "POLL_SECONDS", 0.05)


def _predictor(root, **kwargs):
    return ExportedSavedModelPredictor(export_dir=str(root), device="cpu", **kwargs)


class TestExportedSavedModelPredictor:
    def test_codeless_restore_and_predict(self, exported, tmp_path):
        _place(exported, tmp_path, 100)
        predictor = _predictor(tmp_path)
        assert predictor.restore()
        assert predictor.loaded_model.has_program
        features = _features()
        out = predictor.predict(features)
        want = exported[1].predict(features)
        assert set(out) == {"inference_output", "action"}
        np.testing.assert_allclose(out["action"], want["action"], atol=TOL, rtol=TOL)
        assert predictor.global_step == 3 and predictor.model_version == 100
        assert predictor.model_path == str(tmp_path / "100")
        assert "image" in predictor.get_feature_specification()
        assert predictor.get_label_specification() is not None

    def test_restore_without_program_needs_model(self, exported, tmp_path):
        _place(exported, tmp_path, 100, "code")
        with pytest.raises(ValueError, match="no program"):
            _predictor(tmp_path).restore()

    def test_restore_without_program_model_fallback(self, exported, tmp_path):
        _place(exported, tmp_path, 100, "code")
        predictor = _predictor(tmp_path, t2r_model=TransformerBCModel(**BC))
        assert predictor.restore()
        assert not predictor.loaded_model.has_program
        features = _features(seed=1)
        np.testing.assert_allclose(
            predictor.predict(features)["action"],
            exported[1].predict(features)["action"], atol=TOL, rtol=TOL)

    def test_restore_times_out_on_empty_dir(self, tmp_path):
        start = time.monotonic()
        assert not _predictor(tmp_path / "nothing", timeout=0.2).restore()
        assert time.monotonic() - start < 5

    def test_restore_picks_up_new_version(self, exported, tmp_path):
        _place(exported, tmp_path, 100)
        predictor = _predictor(tmp_path)
        assert predictor.restore() and predictor.model_version == 100
        _place(exported, tmp_path, 200)
        assert predictor.restore() and predictor.model_version == 200

    def test_async_restore_waits_for_a_first_export(self, exported, tmp_path):
        predictor = _predictor(tmp_path, timeout=30)
        assert predictor.restore(is_async=True)
        time.sleep(0.2)
        assert predictor.model_version == -1
        _place(exported, tmp_path, 100)
        deadline = time.monotonic() + 30
        while predictor.model_version < 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert predictor.model_version == 100
        predictor.close()
        assert not predictor.restore_thread_leaked

    def test_restore_prewarm_runs_before_swap(self, exported, tmp_path):
        _place(exported, tmp_path, 100)
        predictor = _predictor(tmp_path)
        assert predictor.restore()
        seen = []

        def prewarm(loaded, serve):
            # The old version is still the live one while this runs.
            seen.append((predictor.model_version, loaded.export_dir,
                         serve(_features(batch=1))))

        predictor.set_restore_prewarm(prewarm)
        path = _place(exported, tmp_path, 200)
        assert predictor.restore() and predictor.model_version == 200
        assert len(seen) == 1
        live, prewarmed_dir, outputs = seen[0]
        assert live == 100 and prewarmed_dir == path
        assert outputs["action"].shape == (1, 16, 7)

    def test_restore_prewarm_failure_keeps_old_version(self, exported, tmp_path):
        _place(exported, tmp_path, 100)
        predictor = _predictor(tmp_path, timeout=0)
        assert predictor.restore()

        def broken(loaded, serve):
            raise RuntimeError("cannot prewarm")

        predictor.set_restore_prewarm(broken)
        _place(exported, tmp_path, 200)
        assert not predictor.restore()
        assert predictor.model_version == 100
        assert predictor.predict(_features(batch=1))["action"].shape == (1, 16, 7)

    def test_async_restore_no_duplicate_thread(self, tmp_path):
        started, release = threading.Event(), threading.Event()
        calls = []

        class _Gated(ExportedSavedModelPredictor):
            def _restore_sync(self):
                calls.append(1)
                started.set()
                release.wait(30)
                return False

        predictor = _Gated(export_dir=str(tmp_path / "none"), timeout=0, device="cpu")
        try:
            for _ in range(5):
                assert predictor.restore(is_async=True)
            assert started.wait(10)
            assert predictor._restore_in_flight and len(calls) == 1
            alive = [t for t in threading.enumerate()
                     if t.name == "t2r-async-restore" and t.is_alive()]
            assert len(alive) == 1
        finally:
            release.set()
        predictor.close()
        deadline = time.monotonic() + 10
        while predictor._restore_in_flight and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not predictor._restore_in_flight
        assert not predictor.restore_thread_leaked

    def test_close_surfaces_leaked_restore_thread(self, tmp_path, caplog):
        import logging

        predictor = _predictor(tmp_path / "none", timeout=1.0)
        assert predictor.restore(is_async=True)
        with caplog.at_level(logging.WARNING):
            predictor.close(join_timeout=0.05)
        assert predictor.restore_thread_leaked
        assert any("restore thread still alive" in r.message for r in caplog.records)
        predictor._restore_thread.join(timeout=30)

    def test_predict_versioned_is_one_pair(self, exported, tmp_path):
        _place(exported, tmp_path, 100)
        predictor = _predictor(tmp_path)
        predictor.restore()
        outputs, version = predictor.predict_versioned(_features(batch=1))
        assert version == 100 and outputs["action"].shape == (1, 16, 7)

    def test_action_tiling_expands_missing_dims(self, exported):
        predictor = _predictor("/nonexistent")
        spec = TensorSpecStruct(
            action=ExtendedTensorSpec(shape=(4, 3), dtype=np.float32),
            state=ExtendedTensorSpec(shape=(2,), dtype=np.float32))
        flat = predictor._maybe_expand_dims(spec, {
            "action": np.ones((5, 3), np.float32),
            "state": np.ones((5, 2), np.float32)})
        assert flat["action"].shape == (5, 4, 3) and flat["state"].shape == (5, 2)

    def test_init_randomly(self):
        predictor = _predictor("/nonexistent", t2r_model=TransformerBCModel(**BC))
        predictor.init_randomly()
        assert predictor.model_version == 0
        assert predictor.predict(_features())["action"].shape == (2, 16, 7)
        with pytest.raises(ValueError, match="t2r_model"):
            _predictor("/nonexistent").init_randomly()

    def test_predict_before_restore_raises(self, tmp_path):
        with pytest.raises(ValueError, match="no model loaded"):
            _predictor(tmp_path).predict(_features())

    def test_cuda_is_the_default_and_raises_without_a_card(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is visible")
        with pytest.raises(RuntimeError, match="cuda"):
            ExportedSavedModelPredictor(export_dir=str(tmp_path))


class TestSavedModelV2Family:
    def test_signature_predictor_serves_the_program(self, exported, tmp_path):
        path = _place(exported, tmp_path, 100)
        predictor = SavedModelSignaturePredictor(path, device="cpu")
        assert predictor.restore() and predictor.model_version == 100
        features = _features(seed=2)
        np.testing.assert_allclose(
            predictor.predict(features)["action"],
            exported[1].predict(features)["action"], atol=TOL, rtol=TOL)

    def test_signature_predictor_resolves_latest_from_root(self, exported, tmp_path):
        _place(exported, tmp_path, 100)
        _place(exported, tmp_path, 200)
        predictor = SavedModelSignaturePredictor(str(tmp_path), device="cpu")
        assert predictor.restore() and predictor.model_version == 200

    def test_signature_predictor_rejects_codeless_export(self, exported, tmp_path):
        path = _place(exported, tmp_path, 100, "code")
        with pytest.raises(ValueError, match="no program"):
            SavedModelSignaturePredictor(path, device="cpu").restore()

    def test_code_predictor_matches_signature_predictor(self, exported, tmp_path):
        path = _place(exported, tmp_path, 100)
        code = SavedModelCodePredictor(path, TransformerBCModel(**BC), device="cpu")
        signature = SavedModelSignaturePredictor(path, device="cpu")
        assert code.restore() and signature.restore()
        features = _features(seed=3)
        np.testing.assert_allclose(
            code.predict(features)["action"], signature.predict(features)["action"],
            atol=TOL, rtol=TOL)

    def test_code_predictor_serves_codeless_export(self, exported, tmp_path):
        path = _place(exported, tmp_path, 100, "code")
        predictor = SavedModelCodePredictor(path, TransformerBCModel(**BC), device="cpu")
        assert predictor.restore()
        assert predictor.predict(_features())["action"].shape == (2, 16, 7)

    def test_code_predictor_init_randomly(self):
        predictor = SavedModelCodePredictor("/nonexistent", TransformerBCModel(**BC),
                                            device="cpu")
        predictor.init_randomly()
        assert predictor.model_version == 0
        assert predictor.predict(_features())["action"].shape == (2, 16, 7)
        with pytest.raises(ValueError, match="fixed artifact"):
            SavedModelSignaturePredictor("/nonexistent", device="cpu").init_randomly()

    def test_signature_predictor_restore_false_on_missing(self, tmp_path):
        assert not SavedModelSignaturePredictor(
            str(tmp_path / "missing"), device="cpu").restore()
