"""Port parity: the whole TransformerBCModel predict path vs the JAX model.

The JAX model runs with use_flash=True, interpret=True (the Pallas flash
kernel in interpret mode); its initialized params are converted into the
port's state dict and served by the port's CheckpointPredictor on the CPU.
Both see the same numpy episodes.
"""

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.models import transformer_models as jax_models
from tensor2robot_tpu.specs import make_random_numpy as jax_make_random_numpy
from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
from tensor2robot_tpu_torch.predictors import CheckpointPredictor
from tensor2robot_tpu_torch.specs import make_random_numpy
from tensor2robot_tpu_torch.utils.jax_params import flax_params_to_state_dict

# Whole-model outputs: conv, spatial softmax, two blocks and the head in
# f32 with sums taken in another order on each side.
TOL = 1e-4
SMALL = dict(
    action_size=7, pose_size=14, episode_length=16, image_size=(16, 16),
    d_model=32, num_layers=2, num_heads=2, head_dim=16,
)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _pair(**overrides):
    kw = {**SMALL, "use_flash": True, **overrides}
    jax_model = jax_models.TransformerBCModel(
        interpret=True, device_type="cpu", **kw
    )
    return jax_model, TransformerBCModel(**kw)


MODEL_CASES = {
    "flash": dict(),
    "flash_window5": dict(attention_window=5),
    "flash_gqa": dict(num_kv_heads=1),
    "einsum": dict(use_flash=False),
    "odd_image": dict(image_size=(15, 13)),
    "experts": dict(num_experts=4),
}


class TestPredictParity:
    @pytest.mark.parametrize(
        "overrides", list(MODEL_CASES.values()), ids=list(MODEL_CASES)
    )
    def test_predict_matches_jax_model(self, overrides):
        jax_model, model = _pair(**overrides)
        features = jax_make_random_numpy(
            jax_model.get_feature_specification("predict"), batch_size=2, seed=3
        )
        variables = jax_model.init_variables(jax.random.PRNGKey(0), features)
        expected, _ = jax_model.inference_network_fn(
            variables, features, "predict"
        )
        predictor = CheckpointPredictor(model, device="cpu")
        predictor.load_state_dict(
            flax_params_to_state_dict(
                jax.tree_util.tree_map(np.asarray, variables["params"])
            )
        )
        outputs = predictor.predict(dict(features.items()))
        assert set(outputs) == {"inference_output", "action"}
        for key in outputs:
            assert outputs[key].shape == (2, 16, 7)
            np.testing.assert_allclose(
                outputs[key], np.asarray(expected[key]), rtol=TOL, atol=TOL
            )


class TestModelContract:
    def test_specs_match_jax(self):
        jax_model, model = _pair()
        for getter in ("get_feature_specification", "get_label_specification"):
            ours = getattr(model, getter)("predict")
            theirs = getattr(jax_model, getter)("predict")
            assert list(ours) == list(theirs)
            for key in ours:
                assert ours[key].shape == theirs[key].shape
                assert ours[key].name == theirs[key].name
                assert ours[key].data_format == theirs[key].data_format

    def test_random_features_match_jax(self):
        jax_model, model = _pair()
        ours = make_random_numpy(model.get_feature_specification("predict"), seed=5)
        theirs = jax_make_random_numpy(
            jax_model.get_feature_specification("predict"), seed=5
        )
        for key in ours:
            np.testing.assert_array_equal(ours[key], theirs[key])

    def test_train_and_eval_fns(self):
        _, model = _pair()
        rng = np.random.RandomState(0)
        out = torch.from_numpy(rng.randn(2, 16, 7).astype(np.float32))
        labels = {"action": torch.from_numpy(rng.randn(2, 16, 7).astype(np.float32))}
        loss, metrics = model.model_train_fn(None, labels, {"inference_output": out}, "train")
        want = float(np.mean((out.numpy() - labels["action"].numpy()) ** 2))
        np.testing.assert_allclose(float(loss), want, rtol=1e-6)
        assert metrics["loss/mse"] is loss
        evals = model.model_eval_fn(None, labels, {"inference_output": out})
        np.testing.assert_allclose(float(evals["eval/mse"]), want, rtol=1e-6)

    def test_init_network_is_seeded(self):
        _, model = _pair()
        nets = [
            model.init_network(torch.Generator().manual_seed(seed), "cpu")
            for seed in (7, 7, 8)
        ]
        first, same, other = (n.state_dict() for n in nets)
        assert all(torch.equal(first[k], same[k]) for k in first)
        assert not torch.equal(first["embed.weight"], other["embed.weight"])
        assert torch.all(first["encoder.ln_final.weight"] == 1.0)
        assert torch.all(first["embed.bias"] == 0.0)
        std = float(first["encoder.pos_embedding"].std())
        assert 0.01 < std < 0.03


# One forward and backward with experts: f32 on both sides, sums in
# another order (test_torch_train.py's gate for the dense model).
MOE_LOSS_RTOL = 1e-6
MOE_GRAD_ATOL, MOE_GRAD_RTOL = 1e-5, 1e-4


def _jax_moe_train_step(jax_model, features, labels, variables):
    """JAX's train outputs, loss, metrics and gradients at `variables`."""

    def loss_fn(params):
        f, l, outputs, _ = jax_model.packed_inference(
            {"params": params}, features, "train", labels=labels
        )
        loss, metrics = jax_model.model_train_fn(f, l, outputs, "train")
        return loss, (outputs, metrics)

    (loss, (outputs, metrics)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"]
    )
    return float(loss), outputs, metrics, grads


class TestExperts:
    """TransformerBCModel with num_experts=4 (k=2) through the flash path:
    the router aux loss folded into the loss (loss = mse + 0.01 aux, as the
    JAX package's test_moe_variant_folds_aux_loss), the gradients of every
    parameter against JAX's, and no aux outside the train outputs."""

    def test_train_loss_and_gradients_match_jax(self):
        jax_model, model = _pair(num_experts=4)
        rng = np.random.RandomState(9)
        features = jax_make_random_numpy(
            jax_model.get_feature_specification("train"), batch_size=2, seed=6
        )
        labels = {"action": rng.randn(2, 16, 7).astype(np.float32)}
        variables = jax_model.init_variables(jax.random.PRNGKey(1), features)
        assert "moe_aux_loss" not in variables
        loss_want, outputs_want, metrics_want, grads_want = _jax_moe_train_step(
            jax_model, features, labels, variables
        )
        network = model.create_network()
        network.load_state_dict(
            flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, variables["params"]))
        )
        packed, packed_labels, outputs, updates = model.packed_inference(
            network, {k: torch.from_numpy(np.asarray(v)) for k, v in features.items()},
            "train", labels={"action": torch.from_numpy(labels["action"])},
        )
        assert updates == {}
        loss, metrics = model.model_train_fn(packed, packed_labels, outputs, "train")
        assert set(metrics) == {"loss/mse", "loss/moe_aux"} == set(metrics_want)
        assert metrics["loss/moe_aux"] is outputs["moe_aux_loss"]
        np.testing.assert_allclose(
            loss.item(),
            metrics["loss/mse"].item() + 0.01 * outputs["moe_aux_loss"].item(),
            rtol=1e-6,
        )
        np.testing.assert_allclose(
            outputs["moe_aux_loss"].item(), float(outputs_want["moe_aux_loss"]),
            rtol=MOE_LOSS_RTOL,
        )
        np.testing.assert_allclose(loss.item(), loss_want, rtol=MOE_LOSS_RTOL)
        loss.backward()
        want = flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads_want))
        grads = {n: p.grad for n, p in network.named_parameters()}
        assert set(grads) == set(want)
        assert {"encoder.block_0.moe.router", "encoder.block_1.moe.w_out"} <= set(grads)
        for name, grad in grads.items():
            np.testing.assert_allclose(
                grad.numpy(), want[name].numpy(), rtol=MOE_GRAD_RTOL,
                atol=MOE_GRAD_ATOL, err_msg=name,
            )

    def test_aux_stays_out_of_eval_outputs_and_checkpoints(self, tmp_path):
        from tensor2robot_tpu_torch.data.input_generators import DefaultRandomInputGenerator
        from tensor2robot_tpu_torch.train import state as state_lib
        from tensor2robot_tpu_torch.train.metrics import read_metrics
        from tensor2robot_tpu_torch.train.train_eval import train_eval_model

        model = TransformerBCModel(**{**SMALL, "num_experts": 4, "device_type": "cpu"})
        train_eval_model(
            model, DefaultRandomInputGenerator(batch_size=2, seed=0),
            DefaultRandomInputGenerator(batch_size=2, seed=1000),
            model_dir=str(tmp_path), max_train_steps=2,
            save_checkpoints_steps=2, eval_steps=1, log_every_steps=1,
            device="cpu",
        )
        records = read_metrics(str(tmp_path / "train"))
        assert all(np.isfinite(r["loss/moe_aux"]) for r in records)
        evals = read_metrics(str(tmp_path / "eval"))
        assert set(evals[-1]) == {"step", "wall_time", "eval/mse"}
        checkpoint = state_lib.load_checkpoint(str(tmp_path), 2)
        network = model.create_network()
        assert set(checkpoint["params"]) == set(network.state_dict())
        assert not any("aux" in name for name in checkpoint["params"])
        network.load_state_dict(checkpoint["params"])
        features = {
            k: torch.from_numpy(np.asarray(v)) for k, v in make_random_numpy(
                model.get_feature_specification("predict"), batch_size=1, seed=2
            ).items()
        }
        with torch.no_grad():
            for mode in ("eval", "predict"):
                assert set(network(features, mode)) == {"inference_output", "action"}
            assert "moe_aux_loss" in network(features, "train")
