"""The port's hooks (tensor2robot_tpu_torch/hooks/): the counterparts of
tests/test_hooks.py — export listeners and their version GC, the lagged
TD3 pair and its startup re-sync, golden values, async and TD3 exports,
variable and config logging, step timing and the profiler, also under
iterations_per_loop; and no train step beside an export's tracing.

Golden values are held against the JAX package: the JAX mock's first
train step's logits (its init variables on the first batch) against the
port's, warm-started from those variables converted (utils/jax_params.py)
and saved as a port checkpoint, within 1e-5.
"""

import json
import logging
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu_torch.export.saved_model import TRACE_LOCK
from tensor2robot_tpu_torch.hooks import (
    AsyncExportHookBuilder,
    CheckpointExportListener,
    ConfigLoggerHookBuilder,
    GoldenValuesHookBuilder,
    Hook,
    HookBuilder,
    LaggedCheckpointListener,
    ProfilerHookBuilder,
    StepTimingHookBuilder,
    TD3Hooks,
    VariableLoggerHookBuilder,
    add_golden_tensor,
    load_golden_values,
)
from tensor2robot_tpu_torch.models.checkpoint_init import default_init_from_checkpoint_fn
from tensor2robot_tpu_torch.predictors import ExportedSavedModelPredictor
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train import train_eval
from tensor2robot_tpu_torch.utils import jax_params
from tensor2robot_tpu_torch.utils.mocks import MockInputGenerator, MockT2RModel

GOLDEN_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _fake_export_fn(counter):
    """Creates versioned dirs like the real export fn."""

    def export_fn(export_dir, global_step):
        counter["n"] += 1
        path = os.path.join(export_dir, f"{counter['n']:010d}")
        os.makedirs(path)
        with open(os.path.join(path, "model.txt"), "w") as f:
            f.write(str(global_step))
        return path

    return export_fn


def _train(model_dir, steps, hook_builders, model=None, batch_size=4, **kw):
    kw.setdefault("save_checkpoints_steps", steps)
    kw.setdefault("log_every_steps", 1)
    return train_eval.train_eval_model(
        t2r_model=model or MockT2RModel(device_type="cpu"),
        input_generator_train=MockInputGenerator(batch_size=batch_size),
        model_dir=str(model_dir), max_train_steps=steps,
        hook_builders=hook_builders, device="cpu", **kw)


class TestCheckpointExportListener:
    def test_export_and_gc(self, tmp_path):
        counter = {"n": 0}
        listener = CheckpointExportListener(
            _fake_export_fn(counter), str(tmp_path / "export"), num_versions=2
        )
        for step in range(4):
            listener.after_save(step)
        versions = sorted(os.listdir(tmp_path / "export"))
        assert versions == ["0000000003", "0000000004"]

    def test_preexisting_dirs_counted_by_gc(self, tmp_path):
        export_dir = tmp_path / "export"
        os.makedirs(export_dir / "0000000001")
        counter = {"n": 1}
        listener = CheckpointExportListener(
            _fake_export_fn(counter), str(export_dir), num_versions=2
        )
        listener.after_save(1)
        listener.after_save(2)
        versions = sorted(os.listdir(export_dir))
        assert versions == ["0000000002", "0000000003"]


class TestLaggedCheckpointListener:
    def make(self, tmp_path, counter=None):
        counter = counter or {"n": 0}
        return LaggedCheckpointListener(
            _fake_export_fn(counter),
            str(tmp_path / "latest"),
            str(tmp_path / "lagged"),
            num_versions=3,
        ), counter

    def test_lagged_stays_one_behind(self, tmp_path):
        listener, _ = self.make(tmp_path)
        listener.after_save(1)
        # First export: lagged mirrors it (nothing older exists).
        assert sorted(os.listdir(tmp_path / "latest")) == ["0000000001"]
        assert sorted(os.listdir(tmp_path / "lagged")) == ["0000000001"]
        listener.after_save(2)
        assert sorted(os.listdir(tmp_path / "latest")) == ["0000000001", "0000000002"]
        assert sorted(os.listdir(tmp_path / "lagged")) == ["0000000001"]
        listener.after_save(3)
        assert sorted(os.listdir(tmp_path / "lagged")) == ["0000000001", "0000000002"]

    def test_startup_resync(self, tmp_path):
        # Two prior exports, an empty lagged dir: startup copies the
        # second-newest into lagged.
        os.makedirs(tmp_path / "latest" / "0000000001")
        os.makedirs(tmp_path / "latest" / "0000000002")
        listener, _ = self.make(tmp_path, {"n": 2})
        assert sorted(os.listdir(tmp_path / "lagged")) == ["0000000001"]
        listener.after_save(3)
        assert sorted(os.listdir(tmp_path / "lagged")) == ["0000000001", "0000000002"]


class _GoldenMockModel(MockT2RModel):
    def model_train_fn(self, features, labels, inference_outputs, mode):
        loss, metrics = super().model_train_fn(features, labels, inference_outputs, mode)
        add_golden_tensor(metrics, inference_outputs["a_predicted"], "logits")
        return loss, metrics


@pytest.fixture(scope="module")
def jax_golden(tmp_path_factory):
    """The JAX mock's train_eval_model run with golden capture, and the
    init variables it started from (its own rng_init on its first batch)."""
    from tensor2robot_tpu.hooks import (
        GoldenValuesHookBuilder as JaxGolden,
        add_golden_tensor as jax_add_golden,
        load_golden_values as jax_load_golden,
    )
    from tensor2robot_tpu.train import train_eval as jax_train_eval
    from tensor2robot_tpu.utils.mocks import (
        MockInputGenerator as JaxMockInput,
        MockT2RModel as JaxMock,
    )

    class JaxGoldenMock(JaxMock):
        def model_train_fn(self, features, labels, inference_outputs, mode):
            loss, metrics = super().model_train_fn(features, labels, inference_outputs, mode)
            jax_add_golden(metrics, inference_outputs["a_predicted"], "logits")
            return loss, metrics

    model_dir = str(tmp_path_factory.mktemp("jax_golden"))
    model = JaxGoldenMock(device_type="cpu")
    jax_train_eval.train_eval_model(
        t2r_model=model, input_generator_train=JaxMockInput(batch_size=4),
        model_dir=model_dir, max_train_steps=5, save_checkpoints_steps=5,
        log_every_steps=1, hook_builders=[JaxGolden(model_dir)])
    generator = JaxMockInput(batch_size=4)
    generator.set_specification_from_model(model, "train")
    batch = next(iter(generator.create_dataset("train")))
    compiled = jax_train_eval.CompiledModel(model, donate_state=False)
    rng_init, _ = jax.random.split(jax.random.PRNGKey(0))
    state = compiled.init_state(rng_init, batch)
    variables = jax.tree_util.tree_map(np.asarray, dict(state.variables))
    return jax_load_golden(model_dir), variables


class TestGoldenValuesHook:
    def test_capture_through_training(self, tmp_path, jax_golden):
        jax_values, jax_variables = jax_golden
        donor = str(tmp_path / "donor")
        state_lib.save_checkpoint(
            donor, 0, jax_params.flax_variables_to_state_dict(jax_variables))
        model_dir = str(tmp_path / "run")
        model = _GoldenMockModel(
            device_type="cpu", init_from_checkpoint_fn=default_init_from_checkpoint_fn(donor))
        _train(model_dir, 5, [GoldenValuesHookBuilder(model_dir)], model=model)
        values = load_golden_values(model_dir)
        assert len(values) == len(jax_values) == 5
        assert values[0]["logits"].shape == (4, 1)
        # Values evolve as training progresses.
        assert not np.allclose(values[0]["logits"], values[-1]["logits"])
        # Step 1 is the forward of the shared init on the shared batch.
        np.testing.assert_allclose(values[0]["logits"], jax_values[0]["logits"],
                                   rtol=GOLDEN_TOL, atol=GOLDEN_TOL)


class TestAsyncExportHooks:
    def test_periodic_export_and_reload(self, tmp_path):
        export_dir = str(tmp_path / "export")
        builder = AsyncExportHookBuilder(export_dir=export_dir, save_secs=0.0, num_versions=3)
        _train(tmp_path / "run", 4, [builder], log_every_steps=2)
        versions = sorted(os.listdir(export_dir))
        assert versions, "No exports produced"
        assert len(versions) <= 3
        predictor = ExportedSavedModelPredictor(export_dir=export_dir, device="cpu")
        assert predictor.restore()
        # The last export is the terminal weights, exported at train end.
        assert predictor.global_step == 4
        outputs = predictor.predict({"x": np.zeros((2, 3), np.float32)})
        assert outputs["a_predicted"].shape == (2, 1)

    def test_td3_lagged_dirs(self, tmp_path):
        export_dir = str(tmp_path / "export")
        lagged_dir = str(tmp_path / "lagged")
        builder = TD3Hooks(export_dir=export_dir, lagged_export_dir=lagged_dir,
                           save_secs=0.0, num_versions=5)
        _train(tmp_path / "run", 4, [builder], save_checkpoints_steps=2,
               log_every_steps=2)
        latest_versions = sorted(os.listdir(export_dir))
        lagged_versions = sorted(os.listdir(lagged_dir))
        assert len(latest_versions) >= 2 and lagged_versions
        # Lagged holds one version behind the newest.
        assert lagged_versions[-1] == latest_versions[-2]
        lagged_predictor = ExportedSavedModelPredictor(export_dir=lagged_dir, device="cpu")
        assert lagged_predictor.restore()


    def test_train_steps_wait_for_an_export_trace(self, tmp_path, monkeypatch):
        """torch.export sets torch.compiler's process-wide is_compiling
        flag while it traces, and an optimizer step that sees it flip
        mid-step raises: no train step starts while an export traces on
        a hook's thread (TRACE_LOCK)."""
        seen, threads = [], []
        step = train_eval.Trainer.train_step

        def recorded(self, state, batch):
            seen.append(torch.compiler.is_compiling())
            return step(self, state, batch)

        monkeypatch.setattr(train_eval.Trainer, "train_step", recorded)

        class Tracing(Hook):
            """What an export does on its worker thread while it traces."""

            def after_step(self, ctx):
                tracing = threading.Event()

                def trace():
                    with TRACE_LOCK:
                        torch.compiler._is_compiling_flag = True
                        tracing.set()
                        time.sleep(0.2)
                        torch.compiler._is_compiling_flag = False

                threads.append(threading.Thread(target=trace))
                threads[-1].start()
                tracing.wait()

        class Builder(HookBuilder):
            def create_hooks(self, t2r_model, trainer=None):
                return [Tracing()]

        try:
            _train(tmp_path / "run", 3, [Builder()])
        finally:
            for thread in threads:
                thread.join()
        assert seen == [False, False, False]
        assert not torch.compiler.is_compiling()


class TestMiscHooks:
    def test_variable_logger_and_config_logger_run(self, tmp_path, caplog):
        caplog.set_level(logging.INFO)
        _train(tmp_path / "run", 2, [VariableLoggerHookBuilder(every_steps=1),
                                     ConfigLoggerHookBuilder()])
        messages = " ".join(r.message for r in caplog.records)
        assert "mean=" in messages and "var=Dense_0.weight" in messages
        assert "Operative config" in messages
        assert os.path.exists(tmp_path / "run" / "operative_config.gin")


class TestProfilingHooks:
    def test_step_timing_hook_reports_steps_per_sec(self, tmp_path):
        builder = StepTimingHookBuilder(sync_every=10, flops_per_step=1e6, peak_flops=1e12)
        model_dir = tmp_path / "run"
        _train(model_dir, 30, [builder], batch_size=8, log_every_steps=10)
        rows = builder.hook.rows
        assert len(rows) >= 2
        assert all(r["steps_per_sec"] > 0 for r in rows)
        assert all(0 < r["mfu"] for r in rows)
        jsonl = model_dir / "profiling" / "step_timing.jsonl"
        assert [json.loads(line) for line in jsonl.read_text().splitlines()] == rows

    def test_profiler_hook_writes_trace(self, tmp_path):
        builder = ProfilerHookBuilder(start_step=2, num_steps=3)
        model_dir = tmp_path / "run"
        _train(model_dir, 6, [builder], batch_size=8, log_every_steps=6)
        assert builder.hook.trace_path == str(model_dir / "profiling" / "trace_3_5.json")
        with open(builder.hook.trace_path) as f:
            trace = json.load(f)
        names = {event.get("name") for event in trace["traceEvents"]}
        assert "aten::addmm" in names

    def test_profiling_hooks_fire_in_multistep_regime(self, tmp_path):
        """ctx.step advances by iterations_per_loop; windows and gates must
        not need exact step multiples."""
        timing = StepTimingHookBuilder(sync_every=7, flops_per_step=1e6)
        profiler = ProfilerHookBuilder(start_step=10, num_steps=5)
        model_dir = tmp_path / "run"
        _train(model_dir, 48, [timing, profiler], batch_size=8, log_every_steps=16,
               iterations_per_loop=16)
        assert [row["step"] for row in timing.hook.rows] == [32, 48]
        # The window starts at the first loop at or past step 10.
        assert profiler.hook.trace_path == str(model_dir / "profiling" / "trace_17_32.json")
