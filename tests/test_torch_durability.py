"""Crash-consistent checkpoints in the port (train/durability.py): the
counterparts of tests/test_crash_consistency.py in the port's layout.

  1. A SIGKILL mid-save (in a child trainer, no cleanup handlers) never
     costs the durable past: the next run quarantines what the crash left,
     resumes from the last durable step, and (the host batch stream
     realigned to the restored step) replays to parameters, optimizer
     state and EMA bit-identical to a run that never crashed.
  2. A torn final-named file (a short copy, a flipped block) is caught by
     its manifest, skipped by every reader and quarantined by the owning
     trainer; it is never loaded.

The manifest holds the file's size and SHA-256; a manifest-less file is
judged by its structure (a whole torch.save archive), the JAX package's
four-way verdict.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from tensor2robot_tpu_torch.train import durability
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train import train_eval
from tensor2robot_tpu_torch.utils.mocks import MockInputGenerator, MockT2RModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One trainer program for every leg: the batch-normed mock with an EMA,
# a checkpoint every 5 steps. KILL names where the process SIGKILLs
# itself on its n-th save: "tmp" half way through writing the file (a
# .tmp is left), "manifest" after the rename and before the manifest.
_TRAINER = r"""
import io, os, signal, sys
import torch
torch.set_num_threads(1)
from tensor2robot_tpu_torch.train import durability
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train import train_eval
from tensor2robot_tpu_torch.utils.mocks import MockInputGenerator, MockT2RModel

model_dir, max_steps, kill = sys.argv[1], int(sys.argv[2]), sys.argv[3]
print("DURABLE_BEFORE", durability.durable_steps(model_dir), flush=True)
if kill != "none":
    where, nth = kill.split(":")
    calls = [0]
    if where == "tmp":
        real_save = torch.save

        def save(obj, f, *args, **kwargs):
            calls[0] += 1
            if calls[0] == int(nth):
                buffer = io.BytesIO()
                real_save(obj, buffer)
                data = buffer.getvalue()
                f.write(data[: len(data) // 2])
                f.flush()
                os.fsync(f.fileno())
                os.kill(os.getpid(), signal.SIGKILL)
            return real_save(obj, f, *args, **kwargs)

        torch.save = save
    else:
        real_publish = durability.publish_durable

        def publish(model_dir, step):
            calls[0] += 1
            if calls[0] == int(nth):
                os.kill(os.getpid(), signal.SIGKILL)
            return real_publish(model_dir, step)

        durability.publish_durable = publish
train_eval.train_eval_model(
    MockT2RModel(device_type="cpu", use_avg_model_params=True, avg_model_params_decay=0.9),
    MockInputGenerator(batch_size=8, seed=7), model_dir=model_dir,
    max_train_steps=max_steps, save_checkpoints_steps=5, log_every_steps=5,
    seed=31, device="cpu")
print("TRAINING_DONE", flush=True)
"""


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _run_trainer(model_dir, max_steps, kill="none", check=True):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _TRAINER, str(model_dir), str(max_steps), kill],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    if check:
        assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def _assert_same_state(a, b):
    assert a["step"] == b["step"]
    for group in ("params", "ema_params"):
        assert a[group].keys() == b[group].keys()
        for key in a[group]:
            assert torch.equal(a[group][key], b[group][key]), (group, key)
    for (i, x), (j, y) in zip(a["optimizer"]["state"].items(),
                              b["optimizer"]["state"].items()):
        assert i == j
        for key in x:
            assert torch.equal(torch.as_tensor(x[key]), torch.as_tensor(y[key])), (i, key)
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    model_dir = tmp_path_factory.mktemp("straight")
    _run_trainer(model_dir, 15)
    return state_lib.load_checkpoint(str(model_dir), 15)


@pytest.mark.parametrize("kill,durable,resumed_from", [
    ("tmp:2", [5], 5),         # SIGKILL half way through writing step 10
    ("manifest:2", [5, 10], 10),  # after step 10's rename, before its manifest
])
def test_sigkill_mid_save_then_resume_bitwise(tmp_path, reference_run, kill, durable,
                                              resumed_from):
    proc = _run_trainer(tmp_path, 15, kill=kill, check=False)
    assert proc.returncode == -9, proc.stderr[-2000:]
    assert "TRAINING_DONE" not in proc.stdout
    assert durability.durable_steps(str(tmp_path)) == durable
    resumed = _run_trainer(tmp_path, 15)
    assert f"DURABLE_BEFORE {durable}" in resumed.stdout
    swept = os.listdir(durability.quarantine_root(str(tmp_path))) if kill.startswith(
        "tmp") else []
    assert [name.split(".pt.")[0] for name in swept] == (["10"] if swept else [])
    assert durability.durable_steps(str(tmp_path)) == [5, 10, 15]
    _assert_same_state(state_lib.load_checkpoint(str(tmp_path), 15), reference_run)
    rows = [json.loads(line) for line in open(tmp_path / "train" / "metrics.jsonl")]
    assert [r["step"] for r in rows][-(15 - resumed_from) // 5:] == list(
        range(resumed_from + 5, 16, 5))


def test_torn_final_named_file_quarantined_never_loaded(tmp_path, reference_run):
    _run_trainer(tmp_path, 10)
    path = state_lib.checkpoint_path(str(tmp_path), 10)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    assert durability.durable_steps(str(tmp_path)) == [5]
    resumed = _run_trainer(tmp_path, 15)
    assert "DURABLE_BEFORE [5]" in resumed.stdout
    quarantined = sorted(os.listdir(durability.quarantine_root(str(tmp_path))))
    assert [name.split(".")[0] for name in quarantined] == ["10", "10"]  # file + manifest
    _assert_same_state(state_lib.load_checkpoint(str(tmp_path), 15), reference_run)


# -- the module ------------------------------------------------------------------


def _params(seed=0):
    network = MockT2RModel().init_network(torch.Generator().manual_seed(seed), "cpu")
    return network.state_dict()


def _write_raw(model_dir, step, data):
    path = state_lib.checkpoint_path(str(model_dir), step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def _saved(model_dir, step, publish=True):
    state_lib.save_checkpoint(str(model_dir), step, _params(step))
    if publish:
        assert durability.publish_durable(str(model_dir), step)


class TestDurabilityModule:
    def test_manifest_roundtrip_validates(self, tmp_path):
        _saved(tmp_path, 3)
        manifest = json.load(open(state_lib.manifest_path(str(tmp_path), 3)))
        assert manifest["file"] == "3.pt"
        assert manifest["size"] == os.path.getsize(state_lib.checkpoint_path(str(tmp_path), 3))
        assert len(manifest["sha256"]) == 64
        assert durability.validate(str(tmp_path), 3) is None
        loaded = durability.load_durable(str(tmp_path), 3)
        for key, value in _params(3).items():
            assert torch.equal(loaded["params"][key], value)

    def test_truncated_file_fails_manifest(self, tmp_path):
        _saved(tmp_path, 3)
        path = state_lib.checkpoint_path(str(tmp_path), 3)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 1)
        assert "size mismatch" in durability.validate(str(tmp_path), 3)
        assert durability.durable_steps(str(tmp_path)) == []

    def test_same_size_damage_fails_the_digest(self, tmp_path):
        _saved(tmp_path, 3)
        path = state_lib.checkpoint_path(str(tmp_path), 3)
        with open(path, "r+b") as f:
            f.seek(200)
            f.write(b"\xff" * 16)
        assert durability.validate(str(tmp_path), 3) is None  # sizes agree
        with pytest.raises(durability.TornCheckpoint, match="digest"):
            durability.load_durable(str(tmp_path), 3)
        assert durability.load_newest_durable(str(tmp_path)) is None

    def test_missing_file_fails_manifest(self, tmp_path):
        _saved(tmp_path, 3)
        os.remove(state_lib.checkpoint_path(str(tmp_path), 3))
        assert durability.validate(str(tmp_path), 3) == "checkpoint file missing"

    def test_structural_fallback_without_manifest(self, tmp_path):
        _saved(tmp_path, 3, publish=False)
        assert durability.validate(str(tmp_path), 3) is None
        _write_raw(tmp_path, 4, b"not an archive")
        assert "torch.save archive" in durability.validate(str(tmp_path), 4)
        assert durability.durable_steps(str(tmp_path)) == [3]

    def test_sweep_quarantines_and_preserves(self, tmp_path):
        _saved(tmp_path, 3)
        _saved(tmp_path, 6)
        directory = state_lib.checkpoint_dir(str(tmp_path))
        with open(os.path.join(directory, "9.pt.77.tmp"), "wb") as f:
            f.write(b"partial")
        path = state_lib.checkpoint_path(str(tmp_path), 6)
        with open(path, "r+b") as f:
            f.truncate(10)
        report = durability.sweep_torn_checkpoints(str(tmp_path))
        assert sorted(name for name, _ in report) == ["6.durable.json", "6.pt", "9.pt.77.tmp"]
        assert sorted(os.listdir(directory)) == ["3.durable.json", "3.pt"]
        quarantined = os.listdir(durability.quarantine_root(str(tmp_path)))
        assert len(quarantined) == 3  # moved, never deleted
        assert durability.sweep_torn_checkpoints(str(tmp_path)) == []

    def test_publish_durable_refuses_torn_and_is_idempotent(self, tmp_path):
        assert not durability.publish_durable(str(tmp_path), 5)  # no file
        _write_raw(tmp_path, 5, b"PK torn")
        assert not durability.publish_durable(str(tmp_path), 5)
        assert not os.path.exists(state_lib.manifest_path(str(tmp_path), 5))
        _saved(tmp_path, 6)
        before = open(state_lib.manifest_path(str(tmp_path), 6)).read()
        assert durability.publish_durable(str(tmp_path), 6)
        assert open(state_lib.manifest_path(str(tmp_path), 6)).read() == before

    def test_gc_removes_manifests_with_their_files(self, tmp_path):
        for step in (1, 2, 3):
            state_lib.save_checkpoint(str(tmp_path), step, _params(step),
                                      keep_checkpoint_max=2)
            durability.publish_durable(str(tmp_path), step)
        assert sorted(os.listdir(state_lib.checkpoint_dir(str(tmp_path)))) == [
            "2.durable.json", "2.pt", "3.durable.json", "3.pt"]

    def test_restore_skips_torn_latest(self, tmp_path):
        trainer = train_eval.Trainer(MockT2RModel(device_type="cpu"), device="cpu")
        for step in (2, 4):
            state = trainer.init_state(torch.Generator().manual_seed(step))
            state.step = step
            state_lib.save_checkpoint(str(tmp_path), step, state.network.state_dict(),
                                      None, state.optimizer.state_dict())
            durability.publish_durable(str(tmp_path), step)
        path = state_lib.checkpoint_path(str(tmp_path), 4)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        restored = train_eval.restore_or_init_state(str(tmp_path), trainer)
        assert restored.step == 2

    def test_predict_from_model_refuses_torn_only_dir(self, tmp_path):
        _write_raw(tmp_path, 5, b"torn")
        generator = MockInputGenerator(batch_size=2)
        with pytest.raises(FileNotFoundError, match="No checkpoint"):
            next(train_eval.predict_from_model(
                MockT2RModel(device_type="cpu"), generator, str(tmp_path), device="cpu"))


def test_a_resave_drops_the_old_manifest(tmp_path):
    _saved(tmp_path, 3)
    state_lib.save_checkpoint(str(tmp_path), 3, _params(9))
    assert not os.path.exists(state_lib.manifest_path(str(tmp_path), 3))
    assert durability.publish_durable(str(tmp_path), 3)
    loaded = durability.load_durable(str(tmp_path), 3)
    for key, value in _params(9).items():
        assert torch.equal(loaded["params"][key], value)
