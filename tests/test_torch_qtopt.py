"""Two QT-Opt critic train steps of the port against the JAX package's.

The JAX golden gate's run (tools/make_qtopt_golden.py: the 96x96 critic
with num_convs=(2, 2, 1), batch 4, two train steps of CompiledModel over
tests/golden/qtopt_train.tfrecord, init PRNGKey(0), step key
PRNGKey(123)) is made here once; its init variables go through the
converter (utils/jax_params.py) into the port's Trainer. The port reads
the same record through its own DefaultRecordInputGenerator (decode-time
ROI off, so the batches carry the full sources as the JAX run's do), its
batches must equal the JAX run's byte for byte, and it trains on them
with each step's preprocessing draws (the random
crop and the photometric distortion of JAX's rng_pre = split(fold_in(
PRNGKey(123), step))[0]) injected. Then:

  * q_predicted and the loss of each step within 1e-5 abs + 1e-4 rel of
    the JAX run's;
  * every parameter, EMA parameter and batch-norm statistic after step 2
    within 1e-4 * max|x| + 1e-6 of the JAX state;
  * q_predicted and the loss of step 1 against tests/golden/
    qtopt_golden_values.npy at decimal=5, the JAX gate's own tolerance.

The JAX run here takes T2R_POOL_BACKWARD=native. Under jit on the CPU the
JAX package's default pool backward (the equal-split custom VJP) gives
this model conv gradients 39% off its eager gradient, and a float64
finite difference sides with the eager one (ROADMAP.md C-ref5); with the
native backward jit agrees with eager to 3e-6. On these batches no window
holds a tied nonzero maximum, so the native and equal-split rules are the
same subgradient, and the port (equal split) is held to it. The golden
file was written by the faulty path: its step 0 (a forward) is held here,
its step 2 is not (its q_predicted is 3.6e-5 from the port's and the
native JAX run's). test_gradient_matches_finite_differences holds the
port's own gradient to a float64 finite difference.

And the port's own train -> checkpoint -> EMA eval -> restore path at the
same size on the CPU: per-step generators, batch-norm buffers in the
checkpoint, the EMA over parameters only, and a restored EMA eval equal
bit for bit to the live one.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_image_transformations import (
    jax_crop_draws,
    jax_photometric_draws,
)
from tensor2robot_tpu_torch.data.input_generators import (
    DefaultRandomInputGenerator,
    DefaultRecordInputGenerator,
)
from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
    Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom as Critic,
    ImageDraws,
)
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train import train_eval
from tensor2robot_tpu_torch.train.infeed import to_device
from tensor2robot_tpu_torch.utils import jax_params

ATOL, RTOL = 1e-5, 1e-4
STATE_TOL = 1e-4
STEP_KEY = 123


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def jax_run():
    with pytest.MonkeyPatch.context() as patch:
        # Read when CompiledModel traces its step (module docstring).
        patch.setenv("T2R_POOL_BACKWARD", "native")
        return _jax_run()


def _jax_run():
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
    compiled = CompiledModel(model, donate_state=False)
    it = iter(dataset)
    batches = []
    for _ in range(golden.STEPS):
        raw = next(it)
        batches.append({
            "features": {k: np.array(v) for k, v in raw["features"].items()},
            "labels": {k: np.array(v) for k, v in raw["labels"].items()},
        })
    state = compiled.init_state(jax.random.PRNGKey(0), batches[0])
    init = _host(compiled.export_variables(state))
    steps = []
    for batch in batches:
        state, metrics = compiled.train_step(
            state, compiled.shard_batch(batch), jax.random.PRNGKey(STEP_KEY))
        steps.append({"loss": np.asarray(metrics["loss"]),
                      "q_predicted": np.asarray(metrics["golden/q_predicted"])})
    return dict(
        batches=batches, init=init, steps=steps,
        final=_host(compiled.export_variables(state)),
        ema=_host(state.ema_params),
        golden=np.load(golden.VALUES_PATH, allow_pickle=True),
        image_size=golden.IMAGE_SIZE, num_convs=golden.NUM_CONVS,
    )


def jax_step_draws(step, batch, source_hw, target_hw):
    """The JAX train step's preprocessing draws: rng_pre of
    split(fold_in(PRNGKey(123), step)), split into crop and distortion
    keys as DefaultGrasping44ImagePreprocessor splits it."""
    step_rng = jax.random.fold_in(jax.random.PRNGKey(STEP_KEY), step)
    rng_pre, _ = jax.random.split(step_rng)
    rng_crop, rng_distort = jax.random.split(rng_pre)
    ys, xs = jax_crop_draws(rng_crop, batch, source_hw, target_hw)
    return ImageDraws(ys, xs, jax_photometric_draws(
        rng_distort, (batch,) + tuple(target_hw) + (3,)))


class _GoldenCritic(Critic):
    """Exposes the train forward's q_predicted, as the JAX golden model's
    add_golden_tensor does."""

    def model_train_fn(self, features, labels, outputs, mode):
        loss, metrics = super().model_train_fn(features, labels, outputs, mode)
        metrics["golden/q_predicted"] = outputs["q_predicted"]
        return loss, metrics


def _port_batch(batch):
    out = TensorSpecStruct()
    for group in ("features", "labels"):
        for key, value in batch[group].items():
            out[f"{group}/{key}"] = torch.from_numpy(value)
    return out


def _port_record_batches(model, count):
    """The golden record through the port's own record generator, as the
    JAX run reads it (seed 11, no shuffle buffer, synchronous parse), with
    decode-time ROI off so the batches carry the full sources."""
    from tools import make_qtopt_golden as golden

    generator = DefaultRecordInputGenerator(
        file_patterns=golden.RECORD_PATH, batch_size=golden.BATCH,
        shuffle_buffer_size=0, seed=11, num_parse_workers=0, prefetch_depth=0)
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("T2R_DECODE_ROI", "0")
        generator.set_specification_from_model(model, "train")
        batches = iter(generator.create_dataset("train"))
        return [next(batches) for _ in range(count)]


@pytest.fixture(scope="module")
def port_run(jax_run):
    model = _GoldenCritic(image_size=jax_run["image_size"],
                          num_convs=jax_run["num_convs"])
    batches = _port_record_batches(model, len(jax_run["batches"]))
    for got, want in zip(batches, jax_run["batches"]):
        assert set(got.keys()) == {f"{group}/{key}" for group in ("features", "labels")
                                   for key in want[group]}
        for group in ("features", "labels"):
            for key, value in want[group].items():
                np.testing.assert_array_equal(np.asarray(got[f"{group}/{key}"]), value,
                                              err_msg=key)
    trainer = train_eval.Trainer(model, device="cpu")
    state = trainer.init_state(
        params=jax_params.flax_variables_to_state_dict(jax_run["init"]))
    source = model.preprocessor.get_in_feature_specification("train")["state/image"]
    draws = iter([
        jax_step_draws(step, len(batch["labels"]["reward"]), source.shape[:2],
                       jax_run["image_size"])
        for step, batch in enumerate(jax_run["batches"])
    ])
    trainer.preprocessor.draw = lambda generator, shape, device: next(draws)
    steps = []
    for batch in batches:
        metrics = trainer.train_step(state, to_device(batch, "cpu"))
        steps.append({k: metrics[k].numpy() for k in ("loss", "golden/q_predicted")})
    return steps, state


def test_steps_match_the_jax_compiled_model(jax_run, port_run):
    steps, _ = port_run
    for step, (got, want) in enumerate(zip(steps, jax_run["steps"])):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL, atol=ATOL,
                                   err_msg=f"loss at step {step}")
        np.testing.assert_allclose(got["golden/q_predicted"], want["q_predicted"],
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"q_predicted at step {step}")


def _held(got, want, name):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=STATE_TOL * scale + 1e-6,
                               err_msg=name)


def test_state_after_two_steps_matches_jax(jax_run, port_run):
    _, state = port_run
    want = jax_params.flax_variables_to_state_dict(jax_run["final"])
    own = state.network.state_dict()
    assert own.keys() == want.keys()
    stats = [k for k in own if k.endswith((".mean", ".var"))]
    assert len(stats) == 2 * 10
    for key, value in own.items():
        _held(value.numpy(), want[key].numpy(), key)
    # The running statistics moved (momentum 0.9997 over two steps).
    assert not torch.equal(own["grasping44.bn1.var"], torch.ones(64))
    ema = jax_params.flax_params_to_state_dict(jax_run["ema"])
    assert ema.keys() == state.ema_params.keys()
    assert not any(k.endswith((".mean", ".var")) for k in ema)
    for key, value in state.ema_params.items():
        _held(value.numpy(), ema[key].numpy(), f"ema {key}")


def test_golden_values(jax_run, port_run):
    """The JAX gate's own fixture and tolerance (decimal=5), at the step
    the fixture computed right: step 1, the forward from the converted
    init (module docstring: step 2 came through ROADMAP.md C-ref5)."""
    steps, _ = port_run
    golden = jax_run["golden"]
    assert len(steps) == len(golden) == 2
    got, want = steps[0], golden[0]
    np.testing.assert_almost_equal(got["loss"], want["loss"], decimal=5)
    np.testing.assert_almost_equal(got["golden/q_predicted"], want["q_predicted"],
                                   decimal=5)
    np.testing.assert_almost_equal(jax_run["steps"][0]["q_predicted"],
                                   want["q_predicted"], decimal=5)


def test_gradient_matches_finite_differences(jax_run):
    """The port's train-mode gradient against a central difference of its
    own loss in float64, along a random direction of each conv kernel (an
    oracle shared with neither package's autodiff)."""
    model = Critic(image_size=jax_run["image_size"], num_convs=jax_run["num_convs"])
    network = model.create_network().double()
    jax_params.load_flax_variables(network, jax_run["init"])
    batch = _port_batch(jax_run["batches"][0])
    features, labels = model.preprocessor.preprocess(
        batch["features"], batch["labels"], mode="eval")
    features = TensorSpecStruct(
        {k: v.double() for k, v in features.items()})
    labels = TensorSpecStruct({"reward": labels["reward"].double()})
    stats = {k: v.clone() for k, v in network.state_dict().items()
             if k.endswith((".mean", ".var"))}

    def loss():
        out = network(features, "train")
        network.load_state_dict(stats, strict=False)  # train mode moved them
        return model.model_train_fn(features, labels, out, "train")[0]

    loss().backward()
    params = dict(network.named_parameters())
    rng = np.random.RandomState(0)
    for name in ("grasping44.conv1_1.weight", "grasping44.conv4.Conv_0.weight"):
        p = params[name]
        d = torch.from_numpy(rng.randn(*p.shape))
        d /= d.norm()
        # Small enough that no relu or pool argmax flips within it.
        eps = 1e-7
        with torch.no_grad():
            p += eps * d
            up = loss().item()
            p -= 2 * eps * d
            down = loss().item()
            p += eps * d
        fd = (up - down) / (2 * eps)
        np.testing.assert_allclose((p.grad * d).sum().item(), fd, rtol=1e-5,
                                   atol=1e-9, err_msg=name)


SMALL = dict(image_size=(96, 96), num_convs=(2, 2, 1))


class TestTrainEvalModel:
    def test_step_generators_are_per_step_and_reproducible(self):
        draws = [train_eval.step_generator(0, step, "cpu") for step in (0, 0, 1)]
        values = [torch.rand(4, generator=g) for g in draws]
        assert torch.equal(values[0], values[1])
        assert not torch.equal(values[0], values[2])
        other = torch.rand(4, generator=train_eval.step_generator(1, 0, "cpu"))
        assert not torch.equal(values[0], other)

    def test_train_steps_draw_random_crops(self):
        model = Critic(**SMALL)
        trainer = train_eval.Trainer(model, device="cpu")
        seen = []
        draw = trainer.preprocessor.draw
        trainer.preprocessor.draw = lambda *a: seen.append(draw(*a)) or seen[-1]
        state = trainer.init_state()
        generator = DefaultRandomInputGenerator(batch_size=8, seed=0)
        generator.set_specification_from_model(model, "train")
        batches = iter(generator.create_dataset("train"))
        for _ in range(2):
            trainer.train_step(state, to_device(next(batches), "cpu"))
        assert len(seen) == 2
        assert not torch.equal(seen[0].ys, seen[1].ys)
        # Offsets over the source's slack (136x264 for 96x96).
        assert seen[0].ys.max() <= 40 and seen[0].xs.max() <= 168

    def test_checkpoint_ema_eval_and_restore(self, tmp_path):
        model = Critic(**SMALL)
        final = train_eval.train_eval_model(
            model, DefaultRandomInputGenerator(batch_size=4, seed=0),
            DefaultRandomInputGenerator(batch_size=4, seed=1000),
            model_dir=str(tmp_path), max_train_steps=4, save_checkpoints_steps=2,
            eval_steps=1, log_every_steps=2, device="cpu",
        )
        assert state_lib.checkpoint_steps(str(tmp_path)) == [2, 4]
        assert set(final) == {"loss", "accuracy", "q_mean"}
        checkpoint = state_lib.load_checkpoint(str(tmp_path), 4)
        params, ema = checkpoint["params"], checkpoint["ema_params"]
        assert "grasping44.bn1.mean" in params and "grasping44.bn1.var" in params
        network = model.create_network()
        assert set(ema) == {n for n, _ in network.named_parameters()}
        # A restore of 4.pt evaluates to the same bits as the live run.
        trainer = train_eval.Trainer(model, device="cpu")
        restored = train_eval.restore_or_init_state(str(tmp_path), trainer)
        assert restored.step == 4
        eval_gen = DefaultRandomInputGenerator(batch_size=4, seed=1000)
        eval_gen.set_specification_from_model(model, "eval")
        again = train_eval.evaluate(trainer, restored,
                                    iter(eval_gen.create_dataset("eval")),
                                    eval_steps=1, use_ema=True)
        assert again == final
