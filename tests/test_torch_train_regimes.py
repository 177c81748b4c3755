"""The trainer's memory regimes against the JAX package's CompiledModel.

remat (the network's segments under torch.utils.checkpoint) and
grad_accum_steps=2 (two microbatches, the gradients averaged, the metrics
recombined by key) against CompiledModel(remat=True) and
CompiledModel(grad_accum_steps=2), one train step each from the same
weights on the same batch:

  * small transformer BC (T=16, 16x16 images, d_model 32, 2 layers, 2
    heads of 16, use_flash=True; the JAX side runs the Pallas kernels in
    interpret mode): the step's loss within 1e-6 relative, every
    parameter after the Adam step within 5e-5 (tests/test_torch_train.py's
    tolerances);
  * the 96x96 QT-Opt critic (num_convs (2, 2, 1), batch 4, the golden
    record; the JAX side with T2R_POOL_BACKWARD=native, ROADMAP.md
    C-ref5): loss and the concatenated golden q_predicted within 1e-5 abs
    + 1e-4 rel, and every parameter, EMA parameter and batch-norm
    statistic within 1e-4 * max|x| + 1e-6 of the JAX state
    (tests/test_torch_qtopt.py's tolerances). A double update of the
    batch-norm statistics (the recompute's, or K microbatches compounding)
    misses that.

The BC conv embed in slices of frames (remat's segments) against the
same JAX step. Then the port alone: remat keeping a fraction of the
activations, key-driven metric recombination, the batches and K that
raise, the launch counts of the kernels' plain versions under remat
and grad-accum, the second derivative that must still raise, and
iterations_per_loop=3 bit-equal to 1 (checkpoint steps, hooks at loop
granularity, a resume).
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_qtopt import (
    STEP_KEY,
    _GoldenCritic,
    _port_record_batches,
    jax_step_draws,
)
from tensor2robot_tpu_torch.data.input_generators import DefaultRandomInputGenerator
from tensor2robot_tpu_torch.hooks import Hook
from tensor2robot_tpu_torch.layers import remat
from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
from tensor2robot_tpu_torch.ops import flash_attention as fa
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train import train_eval
from tensor2robot_tpu_torch.train.infeed import to_device
from tensor2robot_tpu_torch.utils import jax_params
from tensor2robot_tpu_torch.utils.mocks import MockInputGenerator, MockT2RModel

SMALL = dict(
    action_size=7, pose_size=14, episode_length=16, image_size=(16, 16),
    d_model=32, num_layers=2, num_heads=2, head_dim=16, use_flash=True,
)
BC_BATCH = 4
LOSS_RTOL = 1e-6
PARAM_TOL = 5e-5
ATOL, RTOL = 1e-5, 1e-4
STATE_TOL = 1e-4
REGIMES = {"remat": dict(remat=True), "grad_accum": dict(grad_accum_steps=2)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


# -- transformer BC ------------------------------------------------------------------


@pytest.fixture(scope="module")
def bc_jax():
    from tensor2robot_tpu.data import input_generators as jax_generators
    from tensor2robot_tpu.models import transformer_models as jax_models
    from tensor2robot_tpu.train.train_eval import CompiledModel

    model = jax_models.TransformerBCModel(interpret=True, device_type="cpu", **SMALL)
    generator = jax_generators.DefaultRandomInputGenerator(batch_size=BC_BATCH, seed=0)
    generator.set_specification_from_model(model, "train")
    batch = next(iter(generator.create_dataset("train")))
    out = {"batch": batch}
    for name, kw in REGIMES.items():
        compiled = CompiledModel(model, donate_state=False, **kw)
        state0 = compiled.init_state(jax.random.PRNGKey(0), batch)
        state1, metrics = compiled.train_step(
            state0, compiled.shard_batch(batch), jax.random.PRNGKey(1))
        out["init"] = _host(state0.params)
        out[name] = dict(loss=float(metrics["loss"]), params=_host(state1.params))
    return out


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_bc_step_matches_jax(bc_jax, regime):
    model = TransformerBCModel(**SMALL)
    trainer = train_eval.Trainer(model, device="cpu", **REGIMES[regime])
    state = trainer.init_state(params=jax_params.flax_params_to_state_dict(bc_jax["init"]))
    metrics = trainer.train_step(state, to_device(bc_jax["batch"], "cpu"))
    want = bc_jax[regime]
    np.testing.assert_allclose(float(metrics["loss"]), want["loss"], rtol=LOSS_RTOL)
    expected = jax_params.flax_params_to_state_dict(want["params"])
    own = state.network.state_dict()
    assert set(own) == set(expected)
    for name, value in own.items():
        np.testing.assert_allclose(value.numpy(), expected[name].numpy(),
                                   rtol=PARAM_TOL, atol=PARAM_TOL, err_msg=name)


def test_bc_remat_in_frame_slices_matches_jax(bc_jax, monkeypatch):
    """The conv embed checkpointed in slices of 16 frames (4 segments of
    the 64 frames) takes JAX's remat step within the same tolerances."""
    from tensor2robot_tpu_torch.models import transformer_models

    monkeypatch.setattr(transformer_models, "REMAT_FRAMES", 16)
    slices = []
    real = transformer_models._TransformerBCNet._embed_frames

    def embed(self, frames):
        slices.append(frames.shape[0])
        return real(self, frames)

    monkeypatch.setattr(transformer_models._TransformerBCNet, "_embed_frames", embed)
    model = TransformerBCModel(**SMALL)
    trainer = train_eval.Trainer(model, device="cpu", remat=True)
    state = trainer.init_state(params=jax_params.flax_params_to_state_dict(bc_jax["init"]))
    metrics = trainer.train_step(state, to_device(bc_jax["batch"], "cpu"))
    # Four slices forward, four again in the recompute.
    assert slices == [16] * 8
    np.testing.assert_allclose(float(metrics["loss"]), bc_jax["remat"]["loss"],
                               rtol=LOSS_RTOL)
    expected = jax_params.flax_params_to_state_dict(bc_jax["remat"]["params"])
    for name, value in state.network.state_dict().items():
        np.testing.assert_allclose(value.numpy(), expected[name].numpy(),
                                   rtol=PARAM_TOL, atol=PARAM_TOL, err_msg=name)


# -- the QT-Opt critic ---------------------------------------------------------------


@pytest.fixture(scope="module")
def critic_jax():
    with pytest.MonkeyPatch.context() as patch:
        # Read when CompiledModel traces its step (ROADMAP.md C-ref5).
        patch.setenv("T2R_POOL_BACKWARD", "native")
        return _critic_jax()


def _critic_jax():
    from tensor2robot_tpu.data.dataset import RecordDataset
    from tensor2robot_tpu.train.train_eval import CompiledModel
    from tools import make_qtopt_golden as golden

    model = golden.build_model()
    specs = {
        "features": model.preprocessor.get_in_feature_specification("train"),
        "labels": model.preprocessor.get_in_label_specification("train"),
    }
    dataset = RecordDataset(
        specs=specs, file_patterns=golden.RECORD_PATH, batch_size=golden.BATCH,
        mode="train", shuffle_buffer_size=0, seed=11, num_parse_workers=0,
        prefetch_depth=0,
    )
    raw = next(iter(dataset))
    batch = {group: {k: np.array(v) for k, v in raw[group].items()}
             for group in ("features", "labels")}
    out = {"batch": batch, "image_size": golden.IMAGE_SIZE,
           "num_convs": golden.NUM_CONVS}
    for name, kw in REGIMES.items():
        compiled = CompiledModel(model, donate_state=False, **kw)
        state = compiled.init_state(jax.random.PRNGKey(0), batch)
        out["init"] = _host(compiled.export_variables(state))
        state, metrics = compiled.train_step(
            state, compiled.shard_batch(batch), jax.random.PRNGKey(STEP_KEY))
        out[name] = dict(
            loss=np.asarray(metrics["loss"]),
            q_predicted=np.asarray(metrics["golden/q_predicted"]),
            final=_host(compiled.export_variables(state)),
            ema=_host(state.ema_params),
        )
    return out


def _held(got, want, name):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=STATE_TOL * scale + 1e-6,
                               err_msg=name)


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_critic_step_matches_jax(critic_jax, regime):
    model = _GoldenCritic(image_size=critic_jax["image_size"],
                          num_convs=critic_jax["num_convs"])
    (batch,) = _port_record_batches(model, 1)
    trainer = train_eval.Trainer(model, device="cpu", **REGIMES[regime])
    state = trainer.init_state(
        params=jax_params.flax_variables_to_state_dict(critic_jax["init"]))
    source = model.preprocessor.get_in_feature_specification("train")["state/image"]
    draws = jax_step_draws(0, len(critic_jax["batch"]["labels"]["reward"]),
                           source.shape[:2], critic_jax["image_size"])
    trainer.preprocessor.draw = lambda generator, shape, device: draws
    metrics = trainer.train_step(state, to_device(batch, "cpu"))
    want = critic_jax[regime]
    np.testing.assert_allclose(metrics["loss"].numpy(), want["loss"], rtol=RTOL, atol=ATOL)
    # golden/ metrics concatenate back to the full batch under grad-accum.
    assert metrics["golden/q_predicted"].shape == want["q_predicted"].shape
    np.testing.assert_allclose(metrics["golden/q_predicted"].numpy(), want["q_predicted"],
                               rtol=RTOL, atol=ATOL)
    expected = jax_params.flax_variables_to_state_dict(want["final"])
    own = state.network.state_dict()
    assert own.keys() == expected.keys()
    stats = [k for k in own if k.endswith((".mean", ".var"))]
    assert stats
    for key, value in own.items():
        _held(value.numpy(), expected[key].numpy(), key)
    ema = jax_params.flax_params_to_state_dict(want["ema"])
    for key, value in state.ema_params.items():
        _held(value.numpy(), ema[key].numpy(), f"ema {key}")


# -- the port alone ------------------------------------------------------------------


def test_metrics_recombine_by_key():
    per_micro = [
        {"golden/q": torch.tensor([1.0, 2.0]), "per_example/w": torch.tensor([[1.0], [2.0]]),
         "loss": torch.tensor(1.0), "vector": torch.tensor([1.0, 3.0]),
         "count": torch.tensor(2)},
        {"golden/q": torch.tensor([3.0, 4.0]), "per_example/w": torch.tensor([[3.0], [4.0]]),
         "loss": torch.tensor(3.0), "vector": torch.tensor([5.0, 7.0]),
         "count": torch.tensor(3)},
    ]
    out = train_eval.combine_microbatch_metrics(per_micro)
    assert torch.equal(out["golden/q"], torch.tensor([1.0, 2.0, 3.0, 4.0]))
    assert torch.equal(out["per_example/w"], torch.tensor([[1.0], [2.0], [3.0], [4.0]]))
    assert torch.equal(out["loss"], torch.tensor(2.0))
    # A fixed-size vector as long as a microbatch still averages: by key.
    assert torch.equal(out["vector"], torch.tensor([3.0, 5.0]))
    assert torch.equal(out["count"], torch.tensor(5))


def test_indivisible_batch_and_k_below_one_raise(tmp_path):
    with pytest.raises(ValueError, match="grad_accum_steps must be >= 1"):
        train_eval.Trainer(MockT2RModel(), device="cpu", grad_accum_steps=0)
    with pytest.raises(ValueError, match="grad_accum_steps must be >= 1"):
        train_eval.train_eval_model(
            MockT2RModel(), MockInputGenerator(batch_size=4), model_dir=str(tmp_path),
            grad_accum_steps=0, device="cpu")
    trainer = train_eval.Trainer(MockT2RModel(), device="cpu", grad_accum_steps=3)
    state = trainer.init_state()
    generator = MockInputGenerator(batch_size=4)
    generator.set_specification_from_model(trainer.model, "train")
    batch = to_device(next(iter(generator.create_dataset("train"))), "cpu")
    with pytest.raises(ValueError, match="not divisible by grad_accum_steps=3"):
        trainer.train_step(state, batch)
    # 0-d and unit-leading leaves go whole into every microbatch.
    tree = TensorSpecStruct({"a": torch.arange(6.0).reshape(6, 1),
                             "b": torch.tensor(5.0), "c": torch.ones(1, 4)})
    part = train_eval.microbatch(tree, 2, 3)
    assert part["a"].tolist() == [[4.0], [5.0]]
    assert part["b"] is tree["b"] and part["c"] is tree["c"]


def test_remat_and_grad_accum_launches_and_second_derivative(monkeypatch):
    """B1's path runs twice per layer and microbatch under remat (the
    recompute takes FlashAttentionFunction again, not B2), the backward
    once; and a second derivative through the recompute still raises."""
    calls = {"tile": 0, "bwd": 0, "fwd": 0}
    for name, key in (("flash_attention_tile_plain", "tile"),
                      ("flash_attention_bwd_plain", "bwd"),
                      ("flash_attention_plain", "fwd")):
        real = getattr(fa, name)

        def counted(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(fa, name, counted)
    model = TransformerBCModel(**SMALL)
    trainer = train_eval.Trainer(model, device="cpu", remat=True, grad_accum_steps=2)
    state = trainer.init_state()
    generator = DefaultRandomInputGenerator(batch_size=BC_BATCH, seed=0)
    generator.set_specification_from_model(model, "train")
    batch = to_device(next(iter(generator.create_dataset("train"))), "cpu")
    features, labels = trainer.preprocess_train(batch)
    trainer.backward(state.network, features, labels)
    layers = SMALL["num_layers"]
    assert calls == {"tile": 2 * layers * 2, "bwd": layers * 2, "fwd": 0}
    with remat.segments():
        loss, _ = trainer.network_loss(state.network, features, labels)
    params = [p for p in state.network.parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, params, create_graph=True)
    total = sum(g.sum() for g in grads if g.requires_grad)
    with pytest.raises(RuntimeError, match="once-differentiable"):
        torch.autograd.grad(total, params, allow_unused=True)


def _saved_bytes(network_loss, enabled):
    """Bytes the forward saves for the backward, outside remat segments
    (a checkpointed segment keeps its own activations out of autograd's
    graph until its recompute)."""
    total = [0]

    def pack(tensor):
        total[0] += tensor.numel() * tensor.element_size()
        return tensor

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with remat.segments(enabled):
            network_loss()
    return total[0]


def _bc_network_loss():
    model = TransformerBCModel(**{**SMALL, "episode_length": 64, "image_size": (32, 32)})
    trainer = train_eval.Trainer(model, device="cpu")
    network = trainer.init_state().network
    generator = DefaultRandomInputGenerator(batch_size=BC_BATCH, seed=0)
    generator.set_specification_from_model(model, "train")
    features, labels = trainer.preprocess_train(
        to_device(next(iter(generator.create_dataset("train"))), "cpu"))
    return lambda: trainer.network_loss(network, features, labels)


def _critic_network_loss():
    model = _GoldenCritic(image_size=(96, 96), num_convs=(2, 2, 1))
    (batch,) = _port_record_batches(model, 1)
    trainer = train_eval.Trainer(model, device="cpu")
    network = trainer.init_state().network
    network.train()
    features, labels = trainer.preprocess_train(to_device(batch, "cpu"))
    return lambda: trainer.network_loss(network, features, labels)


@pytest.mark.parametrize("net", ["bc", "critic"])
def test_remat_keeps_a_fraction_of_the_activations(net, monkeypatch):
    """Under remat the forward keeps under a quarter of the bytes the
    plain forward keeps for the backward: the segments' activations wait
    for their recompute. (The whole network in one checkpoint would keep
    none, and recompute all of them at once.)"""
    from tensor2robot_tpu_torch.models import transformer_models

    monkeypatch.setattr(transformer_models, "REMAT_FRAMES", 64)
    network_loss = {"bc": _bc_network_loss, "critic": _critic_network_loss}[net]()
    plain, kept = _saved_bytes(network_loss, False), _saved_bytes(network_loss, True)
    assert 0 < kept < plain / 4, (kept, plain)


class _StepRecorder(Hook):
    def __init__(self):
        self.before, self.after, self.saved = [], [], []

    def before_step(self, ctx):
        self.before.append(ctx.step)

    def after_step(self, ctx):
        self.after.append((ctx.step, ctx.metrics is not None,
                           float(ctx.device_metrics["loss"])))

    def after_checkpoint_saved(self, ctx):
        self.saved.append(ctx.step)


class _Builder:
    def __init__(self):
        self.hook = _StepRecorder()

    def create_hooks(self, t2r_model, trainer=None):
        return [self.hook]


def _mock_run(model_dir, steps, ipl, builder=None):
    train_eval.train_eval_model(
        MockT2RModel(), MockInputGenerator(batch_size=8, seed=3), model_dir=str(model_dir),
        max_train_steps=steps, save_checkpoints_steps=4, log_every_steps=2,
        iterations_per_loop=ipl, device="cpu", seed=5,
        hook_builders=[builder] if builder else None)
    return state_lib.load_checkpoint(str(model_dir), steps)


def test_iterations_per_loop_is_bit_equal_to_single_steps(tmp_path):
    single, looped = _Builder(), _Builder()
    a = _mock_run(tmp_path / "k1", 7, 1, single)
    b = _mock_run(tmp_path / "k3", 7, 3, looped)
    assert state_lib.checkpoint_steps(str(tmp_path / "k3")) == [4, 7]
    for name in a["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name
    assert a["optimizer"]["param_groups"][0]["count"] == 7
    # Chunks end at the checkpoint step: 3, 1 (to 4), 3 (to 7).
    assert looped.hook.before == [0, 3, 4]
    assert [s for s, _, _ in looped.hook.after] == [3, 4, 7]
    assert looped.hook.saved == single.hook.saved == [4, 7]
    # Log steps 2, 4, 6 fall in every chunk; the hook sees the chunk's
    # last step's metrics, the single-step run's at the same step.
    assert [logged for _, logged, _ in looped.hook.after] == [True, True, True]
    losses = {s: loss for s, _, loss in single.hook.after}
    assert [loss for _, _, loss in looped.hook.after] == [losses[3], losses[4], losses[7]]
    # A resume from 4 replays the same batches and reaches the same bits.
    _mock_run(tmp_path / "resumed", 4, 3)
    c = _mock_run(tmp_path / "resumed", 7, 3)
    for name in a["params"]:
        assert torch.equal(a["params"][name], c["params"][name]), name
