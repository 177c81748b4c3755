"""The port's warm start (models/checkpoint_init.py): the counterparts of
tests/test_checkpoint_init.py over port checkpoints — a full restore,
missing entries, a partial restore, restorables filtering, shape
mismatches and a warm-started run through the trainer. The prefix
rewrite is held to the JAX package's own `_rewrite` on the same maps.
"""


import pytest
import torch

from tensor2robot_tpu_torch.models import checkpoint_init
from tensor2robot_tpu_torch.models.checkpoint_init import (
    default_init_from_checkpoint_fn,
    load_checkpoint_variables,
)
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train import train_eval
from tensor2robot_tpu_torch.train.metrics import read_metrics
from tensor2robot_tpu_torch.utils.mocks import MockInputGenerator, MockT2RModel

BATCH_SIZE = 16


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _train(model_dir, steps, model=None):
    train_eval.train_eval_model(
        t2r_model=model or MockT2RModel(device_type="cpu"),
        input_generator_train=MockInputGenerator(batch_size=BATCH_SIZE),
        model_dir=str(model_dir), max_train_steps=steps,
        save_checkpoints_steps=steps, log_every_steps=1, device="cpu")


@pytest.fixture(scope="module")
def trained_model_dir(tmp_path_factory):
    model_dir = str(tmp_path_factory.mktemp("donor") / "run")
    _train(model_dir, 30)
    return model_dir


def _fresh(seed=1):
    network = MockT2RModel(device_type="cpu").init_network(
        torch.Generator().manual_seed(seed), "cpu")
    return {k: v.clone() for k, v in network.state_dict().items()}


class TestDefaultWarmStart:
    def test_full_restore_matches_checkpoint(self, trained_model_dir):
        model = MockT2RModel(
            device_type="cpu",
            init_from_checkpoint_fn=default_init_from_checkpoint_fn(trained_model_dir))
        warm = model.maybe_init_from_checkpoint(_fresh())
        source = load_checkpoint_variables(trained_model_dir)
        assert set(warm) == set(source)
        for key, value in warm.items():
            assert torch.equal(value, source[key]), key
        # The trainer's fresh state takes the warm start.
        state = train_eval.Trainer(model, device="cpu").init_state()
        for key, value in state.network.state_dict().items():
            assert torch.equal(value, source[key]), key

    def test_missing_leaf_raises_without_partial(self, trained_model_dir):
        init_fn = default_init_from_checkpoint_fn(
            trained_model_dir, assignment_map={"Dense_0.": "Nonexistent."})
        with pytest.raises(KeyError, match="missing from checkpoint"):
            init_fn(_fresh())

    def test_partial_restore_keeps_fresh_init(self, trained_model_dir):
        fresh = _fresh()
        init_fn = default_init_from_checkpoint_fn(
            trained_model_dir,
            assignment_map={"Dense_0.": None, "Dense_2.": "Nonexistent."},
            allow_partial_restore=True)
        warm = init_fn(fresh)
        source = load_checkpoint_variables(trained_model_dir)
        for key in warm:
            expected = fresh[key] if key.startswith(("Dense_0.", "Dense_2.")) else source[key]
            assert torch.equal(warm[key], expected), key

    def test_filter_restorables_fn(self, trained_model_dir):
        fresh = _fresh()
        init_fn = default_init_from_checkpoint_fn(
            trained_model_dir, filter_restorables_fn=lambda key: key.endswith(".weight"))
        warm = init_fn(fresh)
        source = load_checkpoint_variables(trained_model_dir)
        weights = [k for k in warm if k.endswith(".weight")]
        others = [k for k in warm if not k.endswith(".weight")]
        assert weights and others
        for key in weights:
            assert torch.equal(warm[key], source[key]), key
        for key in others:
            assert torch.equal(warm[key], fresh[key]), key

    def test_shape_mismatch_raises(self, trained_model_dir):
        fresh = _fresh()
        fresh["Dense_1.weight"] = torch.zeros(101, 100)
        init_fn = default_init_from_checkpoint_fn(trained_model_dir)
        with pytest.raises(ValueError, match="shape mismatch"):
            init_fn(fresh)

    def test_end_to_end_warm_start_through_trainer(self, trained_model_dir, tmp_path):
        """Warm-started training resumes from the donor's loss level."""
        model = MockT2RModel(
            device_type="cpu",
            init_from_checkpoint_fn=default_init_from_checkpoint_fn(trained_model_dir))
        _train(tmp_path / "warm", 10, model=model)
        _train(tmp_path / "fresh", 10)
        rows = read_metrics(str(tmp_path / "warm" / "train"))
        fresh_rows = read_metrics(str(tmp_path / "fresh" / "train"))
        assert rows[0]["loss"] < fresh_rows[0]["loss"] * 0.8


def test_sources_and_ema(trained_model_dir, tmp_path):
    """A step file or the checkpoints dir names the same step; use_ema
    needs a checkpoint that keeps one."""
    path = state_lib.checkpoint_path(trained_model_dir, 30)
    for source in (path, state_lib.checkpoint_dir(trained_model_dir)):
        got = load_checkpoint_variables(source)
        for key, value in load_checkpoint_variables(trained_model_dir, step=30).items():
            assert torch.equal(got[key], value), key
    with pytest.raises(ValueError, match="no ema_params"):
        load_checkpoint_variables(trained_model_dir, use_ema=True)
    with pytest.raises(FileNotFoundError):
        load_checkpoint_variables(str(tmp_path))
    ema_dir = str(tmp_path / "ema")
    _train(ema_dir, 2, model=MockT2RModel(device_type="cpu", use_avg_model_params=True,
                                          avg_model_params_decay=0.5))
    checkpoint = state_lib.load_checkpoint(ema_dir)
    got = load_checkpoint_variables(ema_dir, use_ema=True)
    for key, value in checkpoint["ema_params"].items():
        assert torch.equal(got[key], value), key
    assert torch.equal(got["BatchNorm_0.mean"], checkpoint["params"]["BatchNorm_0.mean"])


@pytest.mark.parametrize("assignment_map", [
    None, {"a.": "b."}, {"a.": "b.", "a.c.": "d."}, {"a.": None}, {"": "p."},
])
def test_rewrite_matches_the_jax_package(assignment_map):
    from tensor2robot_tpu.models.checkpoint_init import _rewrite as jax_rewrite

    for path in ("a.c.x", "a.y", "b.z", "q"):
        assert checkpoint_init._rewrite(path, assignment_map) == jax_rewrite(
            path, assignment_map), (path, assignment_map)
