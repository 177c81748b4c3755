"""Torn checkpoints: the writer syncs, the reader never serves a torn file.

The JAX CheckpointPredictor restores durable steps only
(`train/durability.latest_durable_step_in`): it walks the steps newest
first, skips (and logs) any that does not validate, and serves the newest
that does, or keeps polling. The port's `CheckpointPredictor.restore` does
the same over `<model_dir>/checkpoints/<step>.pt`, where a file that does
not load is torn; `save_checkpoint` fsyncs the file before its rename and
the directory after it.
"""

import logging
import os
import stat

import numpy as np
import pytest
import torch

from tensor2robot_tpu_torch.predictors import CheckpointPredictor
from tensor2robot_tpu_torch.research.pose_env import PoseEnvRegressionModel
from tensor2robot_tpu_torch.train import state as state_lib


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _params(seed):
    model = PoseEnvRegressionModel()
    return model.init_network(torch.Generator().manual_seed(seed), "cpu").state_dict()


def _image():
    return {"state": np.random.RandomState(0).randint(0, 256, (2, 64, 64, 3), np.uint8)}


def _tear(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)


def _served(params):
    reference = CheckpointPredictor(PoseEnvRegressionModel(), device="cpu")
    reference.load_state_dict(params, version=1)
    return reference.predict(_image())["inference_output"]


@pytest.fixture
def two_checkpoints(tmp_path):
    params = {step: _params(step) for step in (1, 2)}
    for step, state in params.items():
        state_lib.save_checkpoint(str(tmp_path), step, state)
    return str(tmp_path), params


def test_truncated_newest_is_skipped_and_the_older_step_served(two_checkpoints, caplog):
    model_dir, params = two_checkpoints
    torn = state_lib.checkpoint_path(model_dir, 2)
    _tear(torn)
    predictor = CheckpointPredictor(PoseEnvRegressionModel(), checkpoint_dir=model_dir,
                                    timeout=0, device="cpu")
    with caplog.at_level(logging.WARNING):
        assert predictor.restore()
    assert predictor.model_version == 1 and predictor.global_step == 1
    assert any(torn in record.getMessage() for record in caplog.records)
    np.testing.assert_array_equal(
        predictor.predict(_image())["inference_output"], _served(params[1]))


def test_torn_newest_keeps_the_version_served(two_checkpoints):
    model_dir, params = two_checkpoints
    predictor = CheckpointPredictor(PoseEnvRegressionModel(), checkpoint_dir=model_dir,
                                    timeout=0, device="cpu")
    assert predictor.restore() and predictor.model_version == 2
    state_lib.save_checkpoint(model_dir, 3, _params(3))
    _tear(state_lib.checkpoint_path(model_dir, 3))
    assert predictor.restore() and predictor.model_version == 2
    np.testing.assert_array_equal(
        predictor.predict(_image())["inference_output"], _served(params[2]))
    # Once the step lands whole, the next poll serves it.
    state_lib.save_checkpoint(model_dir, 3, _params(3))
    assert predictor.restore() and predictor.model_version == 3


def test_nothing_loadable_is_not_restored(tmp_path):
    state_lib.save_checkpoint(str(tmp_path), 5, _params(5))
    _tear(state_lib.checkpoint_path(str(tmp_path), 5))
    predictor = CheckpointPredictor(PoseEnvRegressionModel(), checkpoint_dir=str(tmp_path),
                                    timeout=0, device="cpu")
    assert not predictor.restore()
    assert predictor.model_version == -1


def test_save_checkpoint_fsyncs_file_and_directory(tmp_path, monkeypatch):
    synced = []
    real_fsync = os.fsync

    def fsync(fd):
        synced.append(stat.S_ISDIR(os.fstat(fd).st_mode))
        real_fsync(fd)

    monkeypatch.setattr(os, "fsync", fsync)
    path = state_lib.save_checkpoint(str(tmp_path), 7, _params(7))
    assert synced == [False, True]  # the file before the rename, then its dir
    assert os.path.basename(path) == "7.pt"
    assert not [name for name in os.listdir(os.path.dirname(path)) if name.endswith(".tmp")]
    restored = state_lib.load_checkpoint(str(tmp_path))
    assert restored["step"] == 7
