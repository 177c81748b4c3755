"""The port's continuous eval (train/continuous_eval.py) and multi-eval
wiring: the counterparts of tests/test_continuous_eval.py. The trainer
and the eval job share only model_dir; here the trainer runs in a thread
while continuous_eval tails its durable checkpoints.

And against the JAX package: one eval of the same mock weights (the JAX
mock's init variables, converted by utils/jax_params.py and saved as a
port checkpoint) on the same eval batches, through the port's
continuous_eval and the JAX package's run_named_evals, within 1e-5.
"""

import os
import shutil
import threading

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu_torch.export.exporters import LatestExporter
from tensor2robot_tpu_torch.train import continuous_eval as ce
from tensor2robot_tpu_torch.train import durability
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train import train_eval
from tensor2robot_tpu_torch.train.metrics import read_metrics
from tensor2robot_tpu_torch.utils import jax_params
from tensor2robot_tpu_torch.utils.mocks import MockInputGenerator, MockT2RModel

BATCH_SIZE = 16
EVAL_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _train(model_dir, steps, **kw):
    kw.setdefault("save_checkpoints_steps", steps)
    kw.setdefault("log_every_steps", steps)
    return train_eval.train_eval_model(
        t2r_model=MockT2RModel(device_type="cpu"),
        input_generator_train=MockInputGenerator(batch_size=BATCH_SIZE),
        model_dir=str(model_dir), max_train_steps=steps, device="cpu", **kw)


class TestMultiEvalInLoop:
    def test_named_eval_streams_and_merged_metrics(self, tmp_path):
        model_dir = str(tmp_path / "run")
        final = _train(
            model_dir, 40, save_checkpoints_steps=20, eval_steps=4,
            log_every_steps=20,
            input_generator_eval={
                "seen": MockInputGenerator(batch_size=BATCH_SIZE, seed=3),
                "unseen": MockInputGenerator(batch_size=BATCH_SIZE, seed=9),
            })
        seen = read_metrics(os.path.join(model_dir, "eval_seen"))
        unseen = read_metrics(os.path.join(model_dir, "eval_unseen"))
        assert [row["step"] for row in seen] == [20, 40]
        assert [row["step"] for row in unseen] == [20, 40]
        # The primary (first) eval unprefixed, plus per-name copies.
        assert "loss" in final
        assert "seen/loss" in final and "unseen/loss" in final
        assert final["loss"] == final["seen/loss"]


class TestCheckpointBackup:
    def test_backup_survives_source_gc(self, tmp_path):
        model_dir = str(tmp_path / "run")
        _train(model_dir, 20)
        backup_root = ce.backup_checkpoint_for_eval(model_dir, 20)
        assert backup_root is not None
        # The trainer's GC deletes the source; the backup still restores.
        os.remove(state_lib.checkpoint_path(model_dir, 20))
        os.remove(state_lib.manifest_path(model_dir, 20))
        trainer = train_eval.Trainer(MockT2RModel(device_type="cpu"), device="cpu")
        state = ce.restore_state_from_backup(backup_root, 20, trainer)
        assert state.step == 20
        # The copy carries the manifest and verifies against it.
        assert os.path.exists(state_lib.manifest_path(backup_root, 20))
        assert durability.validate(backup_root, 20) is None

    def test_backup_missing_step_returns_none(self, tmp_path):
        model_dir = str(tmp_path / "run")
        os.makedirs(os.path.join(model_dir, "checkpoints"))
        assert ce.backup_checkpoint_for_eval(model_dir, 999) is None

    def test_backup_of_a_torn_step_returns_none(self, tmp_path):
        model_dir = str(tmp_path / "run")
        _train(model_dir, 4)
        path = state_lib.checkpoint_path(model_dir, 4)
        with open(path, "r+b") as f:
            f.seek(100)
            f.write(b"\0" * 64)  # same size, another digest
        assert durability.validate(model_dir, 4) is None  # the size agrees
        assert ce.backup_checkpoint_for_eval(model_dir, 4, retries=1) is None

    def test_wait_timeout_returns_none(self, tmp_path):
        assert ce.wait_for_new_checkpoint(
            str(tmp_path), timeout=0.2, poll_interval=0.05) is None

    def test_wait_skips_uncommitted_and_torn_steps(self, tmp_path):
        model_dir = str(tmp_path / "run")
        _train(model_dir, 2)
        directory = state_lib.checkpoint_dir(model_dir)
        shutil.copyfile(state_lib.checkpoint_path(model_dir, 2),
                        os.path.join(directory, "4.pt.123.tmp"))
        with open(state_lib.checkpoint_path(model_dir, 3), "wb") as f:
            f.write(b"PK\x03\x04 not a whole archive")
        assert ce.wait_for_new_checkpoint(model_dir, timeout=0.0) == 2
        assert ce.wait_for_new_checkpoint(model_dir, 2, timeout=0.1,
                                          poll_interval=0.05) is None


class TestContinuousEvalTailsTraining:
    def test_eval_job_follows_trainer(self, tmp_path):
        model_dir = str(tmp_path / "run")
        max_steps = 60
        errors = []

        def train():
            try:
                _train(model_dir, max_steps, save_checkpoints_steps=20,
                       log_every_steps=20, keep_checkpoint_max=2)
            except Exception as err:  # noqa: BLE001 — reported below
                errors.append(err)

        trainer = threading.Thread(target=train, daemon=True)
        trainer.start()
        final = ce.continuous_eval(
            t2r_model=MockT2RModel(device_type="cpu"),
            model_dir=model_dir,
            input_generator_eval={
                "a": MockInputGenerator(batch_size=BATCH_SIZE, seed=3),
                "b": MockInputGenerator(batch_size=BATCH_SIZE, seed=9),
            },
            eval_steps=2,
            max_train_steps=max_steps,
            create_exporters_fn=lambda model: [LatestExporter(name="latest")],
            timeout=120.0,
            poll_interval=0.2,
            device="cpu",
        )
        trainer.join(timeout=300)
        assert not trainer.is_alive() and not errors
        assert final and "a/loss" in final and "b/loss" in final
        for name in ("a", "b"):
            rows = read_metrics(os.path.join(model_dir, f"eval_{name}"))
            assert rows, f"no metrics for eval_{name}"
            assert rows[-1]["step"] == max_steps
        export_root = os.path.join(model_dir, "export", "latest")
        assert os.path.isdir(export_root) and os.listdir(export_root)


def test_eval_of_carried_weights_matches_jax(tmp_path):
    from tensor2robot_tpu.train import train_eval as jax_train_eval
    from tensor2robot_tpu.utils.mocks import (
        MockInputGenerator as JaxMockInput,
        MockT2RModel as JaxMock,
    )

    model = JaxMock(device_type="cpu")
    generator = JaxMockInput(batch_size=BATCH_SIZE, seed=3)
    jax_train_eval.provide_input_generator_with_model_information(generator, model, "eval")
    compiled = jax_train_eval.CompiledModel(model, donate_state=False)
    state = compiled.init_state(jax.random.PRNGKey(4),
                                next(iter(generator.create_dataset("eval"))))
    want = jax_train_eval.run_named_evals(compiled, state, {"": generator}, 3, False)
    variables = jax.tree_util.tree_map(np.asarray, dict(state.variables))
    model_dir = str(tmp_path / "run")
    state_lib.save_checkpoint(model_dir, 7, jax_params.flax_variables_to_state_dict(variables))
    got = ce.continuous_eval(
        MockT2RModel(device_type="cpu"), model_dir,
        MockInputGenerator(batch_size=BATCH_SIZE, seed=3), eval_steps=3,
        max_train_steps=7, timeout=0.0, device="cpu")
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=EVAL_TOL, atol=EVAL_TOL, err_msg=key)
    assert [row["step"] for row in read_metrics(os.path.join(model_dir, "eval"))] == [7]
