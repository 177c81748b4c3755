"""Port parity: the trainer (tensor2robot_tpu_torch.train) vs the JAX
package's CompiledModel, and the port's train/eval/checkpoint loop.

A small TransformerBCModel (T=16, 16x16 images, d_model 32, 2 layers, 2
heads of 16, use_flash=True) starts from the JAX initialization converted
by utils/jax_params.py. The JAX side runs the Pallas flash kernels in
interpret mode, compiled once for the module; the port runs its
FlashAttentionFunction (plain B1, B3, B4 on the CPU). Both see the same
numpy batches.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.data import input_generators as jax_generators
from tensor2robot_tpu.models import transformer_models as jax_models
from tensor2robot_tpu.train import state as jax_state
from tensor2robot_tpu.train.train_eval import CompiledModel
from tensor2robot_tpu_torch import flags
from tensor2robot_tpu_torch.data.input_generators import (
    DefaultRandomInputGenerator,
)
from tensor2robot_tpu_torch.export import create_default_exporters
from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
from tensor2robot_tpu_torch.predictors import CheckpointPredictor
from tensor2robot_tpu_torch.specs import make_random_numpy
from tensor2robot_tpu_torch.train import infeed
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train import train_eval
from tensor2robot_tpu_torch.train.metrics import read_metrics
from tensor2robot_tpu_torch.utils.jax_params import (
    flax_params_to_state_dict,
    optax_adam_state_to_optimizer_state,
)

SMALL = dict(
    action_size=7, pose_size=14, episode_length=16, image_size=(16, 16),
    d_model=32, num_layers=2, num_heads=2, head_dim=16, use_flash=True,
)
# One forward: f32 on both sides, sums in another order.
LOSS_RTOL = 1e-6
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
# Adam's first steps are ~lr * sign(g): rounding on near-zero gradients
# is magnified to a fraction of lr = 1e-3.
PARAM_TOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    """Two JAX train steps, the gradients at the start, and the states."""
    model = jax_models.TransformerBCModel(interpret=True, device_type="cpu", **SMALL)
    generator = jax_generators.DefaultRandomInputGenerator(batch_size=2, seed=0)
    generator.set_specification_from_model(model, "train")
    batches = iter(generator.create_dataset("train"))
    batch0, batch1 = next(batches), next(batches)
    compiled = CompiledModel(model, donate_state=False)
    state0 = compiled.init_state(jax.random.PRNGKey(0), batch0)

    def loss_fn(params):
        variables = dict(state0.variables)
        variables["params"] = params
        f, l, outputs, _ = model.packed_inference(
            variables, batch0["features"], "train", labels=batch0["labels"]
        )
        return model.model_train_fn(f, l, outputs, "train")[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(state0.params)
    state1, metrics1 = compiled.train_step(
        state0, compiled.shard_batch(batch0), jax.random.PRNGKey(1)
    )
    state2, metrics2 = compiled.train_step(
        state1, compiled.shard_batch(batch1), jax.random.PRNGKey(1)
    )
    adam1 = state1.opt_state[0]
    return dict(
        batches=(batch0, batch1),
        params=[_numpy_tree(s.params) for s in (state0, state1, state2)],
        loss=float(loss),
        grads=flax_params_to_state_dict(_numpy_tree(grads)),
        step_losses=[float(m["loss"]) for m in (metrics1, metrics2)],
        adam1=(_numpy_tree(adam1.mu), _numpy_tree(adam1.nu), int(adam1.count)),
    )


def _trainer(**overrides):
    return train_eval.Trainer(TransformerBCModel(**{**SMALL, **overrides}), device="cpu")


def _assert_params_close(network, flax_params, tol):
    expected = flax_params_to_state_dict(flax_params)
    state = network.state_dict()
    assert set(state) == set(expected)
    for name, value in state.items():
        np.testing.assert_allclose(
            value.numpy(), expected[name].numpy(), rtol=tol, atol=tol,
            err_msg=name,
        )


class TestTrainStepMatchesJax:
    def test_loss_and_gradients(self, jax_run):
        trainer = _trainer()
        state = trainer.init_state(params=flax_params_to_state_dict(jax_run["params"][0]))
        batch = infeed.to_device(jax_run["batches"][0], "cpu")
        loss, metrics = trainer.forward_loss(state.network, batch)
        assert metrics["loss/mse"] is loss
        np.testing.assert_allclose(loss.item(), jax_run["loss"], rtol=LOSS_RTOL)
        loss.backward()
        grads = {n: p.grad for n, p in state.network.named_parameters()}
        assert set(grads) == set(jax_run["grads"])
        for name, grad in grads.items():
            np.testing.assert_allclose(
                grad.numpy(), jax_run["grads"][name].numpy(), rtol=GRAD_RTOL,
                atol=GRAD_ATOL, err_msg=name,
            )

    def test_two_adam_steps(self, jax_run):
        trainer = _trainer()
        state = trainer.init_state(params=flax_params_to_state_dict(jax_run["params"][0]))
        # Step 2's loss is taken at parameters that already differ by up
        # to PARAM_TOL-sized Adam rounding, hence 1e-5 there.
        for i, batch in enumerate(jax_run["batches"]):
            metrics = trainer.train_step(state, infeed.to_device(batch, "cpu"))
            np.testing.assert_allclose(
                float(metrics["loss"]), jax_run["step_losses"][i],
                rtol=(LOSS_RTOL, 1e-5)[i],
            )
        assert state.step == 2
        _assert_params_close(state.network, jax_run["params"][2], PARAM_TOL)

    def test_step_from_the_converted_jax_optimizer_state(self, jax_run):
        """JAX's state after step 1 (params and Adam moments) carried into
        the port gives JAX's step 2."""
        trainer = _trainer()
        state = trainer.init_state(params=flax_params_to_state_dict(jax_run["params"][1]))
        mu, nu, count = jax_run["adam1"]
        state.optimizer.load_state_dict(
            optax_adam_state_to_optimizer_state(mu, nu, count, state.optimizer, state.network)
        )
        state.step = count
        trainer.train_step(state, infeed.to_device(jax_run["batches"][1], "cpu"))
        _assert_params_close(state.network, jax_run["params"][2], PARAM_TOL)
        assert state.optimizer.state_dict()["param_groups"][0]["count"] == 2


class TestEma:
    def test_update_ema_matches_jax(self):
        rng = np.random.RandomState(0)
        ema = {"a": rng.randn(3, 2).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
        new = {k: rng.randn(*v.shape).astype(np.float32) for k, v in ema.items()}
        expected = jax_state.update_ema(ema, new, 0.9)
        got = state_lib.update_ema(
            {k: torch.from_numpy(v) for k, v in ema.items()},
            {k: torch.from_numpy(v) for k, v in new.items()}, 0.9,
        )
        for key in ema:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(expected[key]), rtol=1e-7, atol=1e-7)

    def test_train_step_applies_ema_after_the_update(self, jax_run):
        trainer = _trainer(use_avg_model_params=True, avg_model_params_decay=0.5)
        state = trainer.init_state(params=flax_params_to_state_dict(jax_run["params"][0]))
        start = {k: v.clone() for k, v in state.ema_params.items()}
        trainer.train_step(state, infeed.to_device(jax_run["batches"][0], "cpu"))
        for name, p in state.network.named_parameters():
            torch.testing.assert_close(
                state.ema_params[name], 0.5 * start[name] + 0.5 * p.detach()
            )
        exported = state.export_state_dict(use_ema=True)
        assert torch.equal(exported["embed.weight"], state.ema_params["embed.weight"])
        assert not torch.equal(
            state.export_state_dict()["embed.weight"], exported["embed.weight"]
        )


def _generators():
    return (DefaultRandomInputGenerator(batch_size=2, seed=0),
            DefaultRandomInputGenerator(batch_size=2, seed=1000))


def _train(model_dir, steps, **kw):
    model = TransformerBCModel(**{**SMALL, "device_type": "cpu", **kw.pop("model", {})})
    train, evaluate = _generators()
    result = train_eval.train_eval_model(
        model, train, evaluate, model_dir=str(model_dir), max_train_steps=steps,
        save_checkpoints_steps=2, eval_steps=1, log_every_steps=1,
        device="cpu", **kw,
    )
    return model, result


class TestTrainEvalModel:
    def test_resume_reaches_the_uninterrupted_params(self, tmp_path):
        _, straight = _train(tmp_path / "straight", 4)
        _train(tmp_path / "resumed", 2)
        _, resumed = _train(tmp_path / "resumed", 4)
        assert resumed == straight
        a = state_lib.load_checkpoint(str(tmp_path / "straight"), 4)
        b = state_lib.load_checkpoint(str(tmp_path / "resumed"), 4)
        assert a["step"] == b["step"] == 4
        for name in a["params"]:
            assert torch.equal(a["params"][name], b["params"][name]), name
        for group in (a, b):
            assert group["optimizer"]["param_groups"][0]["count"] == 4
        records = read_metrics(str(tmp_path / "resumed" / "train"))
        assert [r["step"] for r in records] == [1, 2, 3, 4]
        evals = read_metrics(str(tmp_path / "resumed" / "eval"))
        assert [r["step"] for r in evals] == [2, 4]
        assert set(evals[-1]) == {"step", "wall_time", "eval/mse"}

    def test_prunes_and_serves_the_ema(self, tmp_path):
        model, _ = _train(
            tmp_path, 4, keep_checkpoint_max=1,
            model=dict(use_avg_model_params=True),
        )
        assert state_lib.checkpoint_steps(str(tmp_path)) == [4]
        checkpoint = state_lib.load_checkpoint(str(tmp_path))
        assert checkpoint["ema_params"] is not None
        predictors = {
            use_ema: CheckpointPredictor(
                model, checkpoint_dir=str(tmp_path), use_ema=use_ema, device="cpu"
            )
            for use_ema in (None, True, False)
        }
        expected = {}
        for use_ema, params in ((True, {**checkpoint["params"], **checkpoint["ema_params"]}),
                                (False, checkpoint["params"])):
            reference = CheckpointPredictor(model, device="cpu")
            reference.load_state_dict(params, version=4)
            expected[use_ema] = reference
        episode = make_random_numpy(
            predictors[None].get_feature_specification(), batch_size=1, seed=4
        )
        for use_ema, predictor in predictors.items():
            assert predictor.restore()
            assert predictor.model_version == 4
            assert predictor.model_path == str(tmp_path / "checkpoints" / "4.pt")
            want = expected[True if use_ema is None else use_ema].predict(episode)
            np.testing.assert_array_equal(
                predictor.predict(episode)["action"], want["action"]
            )
        assert not np.array_equal(
            expected[True].predict(episode)["action"],
            expected[False].predict(episode)["action"],
        )

    def test_predict_from_model_serves_the_checkpoint(self, tmp_path):
        model, _ = _train(tmp_path, 2)
        generator = DefaultRandomInputGenerator(batch_size=2, seed=9)
        outputs = next(train_eval.predict_from_model(model, generator, str(tmp_path), device="cpu"))
        predictor = CheckpointPredictor(model, checkpoint_dir=str(tmp_path), device="cpu")
        predictor.restore()
        generator.set_specification_from_model(model, "predict")
        batch = next(iter(generator.create_dataset("predict")))
        want = predictor.predict(dict(batch["features"].items()))
        np.testing.assert_allclose(outputs["action"], want["action"], rtol=1e-6, atol=1e-6)
        with pytest.raises(FileNotFoundError, match="No checkpoint"):
            next(train_eval.predict_from_model(model, generator, str(tmp_path / "none"), device="cpu"))

    def test_eval_takes_the_forward_without_residuals(self, tmp_path, monkeypatch):
        """eval_step runs under inference_mode, so attention takes the
        normalized forward (B2's path), not FlashAttentionFunction."""
        from tensor2robot_tpu_torch.ops import flash_attention as fa

        calls = []
        real = fa.FlashAttentionFunction.apply
        monkeypatch.setattr(
            fa.FlashAttentionFunction, "apply",
            lambda *a: calls.append(1) or real(*a),
        )
        trainer = _trainer()
        state = trainer.init_state()
        generator = DefaultRandomInputGenerator(batch_size=2, seed=0)
        generator.set_specification_from_model(trainer.model, "eval")
        batch = infeed.to_device(next(iter(generator.create_dataset("eval"))), "cpu")
        metrics = trainer.eval_step(state, batch)
        assert set(metrics) == {"eval/mse"} and not calls
        trainer.train_step(state, batch)
        assert len(calls) == SMALL["num_layers"]


class TestExporters:
    def test_one_export_per_eval(self, tmp_path):
        """create_exporters_fn is called once; each exporter exports after
        every eval with that eval's metrics, and the exported program
        serves the checkpoint of its step."""
        from tensor2robot_tpu_torch.export import (
            ExportedModel,
            create_valid_result_smaller,
            list_export_dirs,
        )

        calls = []

        def exporters_fn(model):
            calls.append(model)
            return create_default_exporters(
                model, warmup_batch_sizes=(1, 2),
                compare_fn=create_valid_result_smaller("eval/mse"))

        model, final = _train(tmp_path, 4, create_exporters_fn=exporters_fn)
        assert len(calls) == 1 and calls[0] is model
        latest = list_export_dirs(str(tmp_path / "export" / "latest"))
        loaded = [ExportedModel(path, device="cpu") for path in latest]
        assert [e.global_step for e in loaded] == [2, 4]
        evals = read_metrics(str(tmp_path / "eval"))
        for export, record in zip(loaded, evals):
            assert export.metadata["eval_metrics"] == {"eval/mse": record["eval/mse"]}
            assert export.metadata["warmup_batch_sizes"] == [1, 2]
            assert export.has_program
        assert loaded[-1].metadata["eval_metrics"] == final
        best = list_export_dirs(str(tmp_path / "export" / "best"))
        assert 1 <= len(best) <= 2
        features = make_random_numpy(loaded[-1].feature_spec, batch_size=2, seed=1)
        reference = CheckpointPredictor(model, checkpoint_dir=str(tmp_path), device="cpu")
        assert reference.restore() and reference.model_version == 4
        np.testing.assert_allclose(
            loaded[-1].predict(dict(features.items()))["action"],
            reference.predict(dict(features.items()))["action"], atol=1e-5, rtol=1e-5)


class _NoHooks:
    def create_hooks(self, t2r_model, trainer=None):
        return []


class TestUnportedArguments:
    @pytest.mark.parametrize(
        "kw,item",
        [
            # A mesh is ported (A9 part 1) and so is the planner (A9.5):
            # an object that is not the port's DeviceMesh, or not its
            # ShardingPlan ("A9", the item that ported it), raises
            # TypeError naming the type it wants.
            (dict(mesh=object()), "TypeError"), (dict(plan=object()), "A9"),
            # serve_quant is ported (A10.1); AOT executables are not (A10.2).
            (dict(create_exporters_fn=lambda m: create_default_exporters(
                m, aot_executables=True)), "A10"),
        ],
        ids=lambda x: x if isinstance(x, str) else next(iter(x)),
    )
    def test_raise_naming_their_item(self, tmp_path, kw, item):
        train, _ = _generators()
        if item == "TypeError":
            error, item = TypeError, r"torch\.distributed\.device_mesh\.DeviceMesh"
        elif item == "A9":
            error, item = TypeError, r"parallel\.planner\.ShardingPlan"
        else:
            error = NotImplementedError
        with pytest.raises(error, match=item) as raised:
            train_eval.train_eval_model(
                TransformerBCModel(**SMALL), train, model_dir=str(tmp_path),
                device="cpu", **kw,
            )
        assert not os.path.exists(tmp_path / "checkpoints")
        if "plan" in kw:
            assert "got object" in str(raised.value)

    @pytest.mark.parametrize(
        "kw",
        [dict(remat=True), dict(grad_accum_steps=2), dict(iterations_per_loop=2),
         dict(hook_builders=[_NoHooks()]), dict(shard_weight_update=True),
         dict(flatten_optimizer_update=True),
         dict(weight_update_axes=("data", "sequence"), shard_weight_update=True)],
        ids=lambda x: next(iter(x)),
    )
    def test_ported_regimes_train(self, tmp_path, kw):
        """The regimes and hooks ported from A4 and A5 train and
        checkpoint (tests/test_torch_train_regimes.py holds them to JAX),
        and so do the weight-update regimes of A9.4 on one device
        (shard_weight_update over a weight-update group of 1, whatever
        its dims, is the replicated step, as JAX resolves it;
        tests/test_torch_zero2*.py and test_torch_composed_regimes.py hold
        them to JAX)."""
        train, _ = _generators()
        train_eval.train_eval_model(
            TransformerBCModel(**SMALL, device_type="cpu"), train,
            model_dir=str(tmp_path), max_train_steps=2, save_checkpoints_steps=2,
            device="cpu", **kw,
        )
        assert state_lib.checkpoint_steps(str(tmp_path)) == [2]
        if "weight_update_axes" in kw:
            trainer = train_eval.Trainer(TransformerBCModel(**SMALL, device_type="cpu"),
                                         device="cpu", **kw)
            assert trainer.regime == "replicated"

    def test_flat_update_refused_with_zero2(self, tmp_path):
        """flatten_optimizer_update beside shard_weight_update raises
        JAX's ValueError before anything is written."""
        train, _ = _generators()
        with pytest.raises(ValueError, match="flatten_optimizer_update"):
            train_eval.train_eval_model(
                TransformerBCModel(**SMALL, device_type="cpu"), train,
                model_dir=str(tmp_path), device="cpu", shard_weight_update=True,
                flatten_optimizer_update=True)
        assert not os.path.exists(tmp_path / "checkpoints")

    def test_needs_a_train_generator(self, tmp_path):
        with pytest.raises(ValueError, match="input_generator_train"):
            train_eval.train_eval_model(
                TransformerBCModel(**SMALL), model_dir=str(tmp_path), device="cpu"
            )


class TestPieces:
    def test_normalize_eval_generators(self):
        g = object()
        assert train_eval.normalize_eval_generators(None) == {}
        assert train_eval.normalize_eval_generators(g) == {"": g}
        assert train_eval.normalize_eval_generators({"a": g}) == {"a": g}
        with pytest.raises(ValueError, match="named"):
            train_eval.normalize_eval_generators({"": g, "a": g})
        assert train_eval.eval_dir_name("") == "eval"
        assert train_eval.eval_dir_name("sim") == "eval_sim"

    def test_named_evals(self, tmp_path):
        trainer = _trainer()
        state = trainer.init_state()
        named = {"sim": DefaultRandomInputGenerator(batch_size=2, seed=1),
                 "real": DefaultRandomInputGenerator(batch_size=2, seed=2)}
        for generator in named.values():
            generator.set_specification_from_model(trainer.model, "eval")
        merged = train_eval.run_named_evals(trainer, state, named, 1, False)
        assert set(merged) == {"eval/mse", "sim/eval/mse", "real/eval/mse"}
        assert merged["eval/mse"] == merged["sim/eval/mse"]

    def test_infeed_depth_flag(self, monkeypatch):
        assert infeed.resolve_depth(5) == 5
        assert infeed.resolve_depth() == 2
        monkeypatch.setenv("T2R_INFEED_DEPTH", "3")
        assert infeed.resolve_depth() == flags.get_int("T2R_INFEED_DEPTH") == 3

    def test_cpu_prefetch_yields_tensors_in_order(self):
        batches = [{"features/x": np.full((2,), i, np.float32)} for i in range(5)]
        out = list(infeed.device_prefetch(iter(batches), "cpu", depth=2))
        assert [float(b["features/x"][0]) for b in out] == [0, 1, 2, 3, 4]
        assert isinstance(out[0]["features/x"], torch.Tensor)

    def test_checkpoint_files_are_atomic_and_pruned(self, tmp_path):
        params = {"w": torch.ones(2)}
        for step in (1, 2, 3):
            state_lib.save_checkpoint(str(tmp_path), step, params, keep_checkpoint_max=2)
        (tmp_path / "checkpoints" / "9.pt.77.tmp").write_bytes(b"torn")
        assert state_lib.checkpoint_steps(str(tmp_path)) == [2, 3]
        assert state_lib.latest_checkpoint_step(str(tmp_path)) == 3
        assert state_lib.latest_checkpoint_step(str(tmp_path / "none")) is None
        loaded = state_lib.load_checkpoint(str(tmp_path))
        assert loaded["step"] == 3 and loaded["ema_params"] is None
        with pytest.raises(FileNotFoundError):
            state_lib.load_checkpoint(str(tmp_path / "none"))
