"""Port parity: KV-cache streaming serving (StreamingBCPolicy and the
streaming export) vs the JAX package's.

The JAX TransformerBCModel is initialized from a fixed key, its params are
converted by utils/jax_params.py, and both packages' streaming policies
take the same numpy episode one step at a time on the CPU (the port's
policy steps eagerly there; on the card each step is one CUDA graph
replay, which chip_smoke.py's stream phase checks). Each streamed action
is held against JAX's streamed action, and against the port's own
full-episode forward.
"""

import json

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.models import transformer_models as jax_models
from tensor2robot_tpu.specs import make_random_numpy as jax_make_random_numpy
from tensor2robot_tpu_torch.export import (
    StreamingExportedPolicy,
    is_streaming_export,
    save_streaming_export,
)
from tensor2robot_tpu_torch.export.streaming import STREAM_METADATA_FILENAME
from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
from tensor2robot_tpu_torch.utils.jax_params import flax_params_to_state_dict

# Streamed actions vs JAX's: conv, spatial softmax, two blocks and the
# head in f32 with sums taken in another order on each side (the
# predict-path parity tolerance of test_torch_transformer_models.py).
TOL = 1e-4
# Streamed vs the port's own full forward: the JAX package's own gate for
# the same comparison (tests/test_transformer_models.py).
SELF_TOL = 2e-5
SMALL = dict(
    action_size=3, pose_size=14, episode_length=8, image_size=(16, 16),
    d_model=32, num_layers=2, num_heads=2, head_dim=16, use_flash=False,
)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _pair(**overrides):
    kw = {**SMALL, **overrides}
    jax_model = jax_models.TransformerBCModel(device_type="cpu", **kw)
    features = jax_make_random_numpy(
        jax_model.get_feature_specification("predict"), batch_size=1, seed=3
    )
    variables = jax_model.init_variables(jax.random.PRNGKey(0), features)
    state = flax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, variables["params"])
    )
    return jax_model, variables, TransformerBCModel(device_type="cpu", **kw), state, features


def _episode(features, steps):
    """`steps` observations: the episode, then its last step repeated."""
    images = np.asarray(features["image"])[0]
    poses = np.asarray(features["gripper_pose"])[0]
    index = [min(t, len(images) - 1) for t in range(steps)]
    return images[index], poses[index]


POLICY_CASES = {
    "full": dict(),
    "window3": dict(attention_window=3),
    "gqa_window3": dict(num_heads=4, head_dim=8, num_kv_heads=2, attention_window=3),
    "experts": dict(num_experts=4),
    "experts_gqa_window3": dict(num_experts=4, num_heads=4, head_dim=8,
                                num_kv_heads=2, attention_window=3),
}


class TestStreamingPolicy:
    @pytest.mark.parametrize(
        "overrides", list(POLICY_CASES.values()), ids=list(POLICY_CASES)
    )
    def test_streams_as_jax_past_capacity(self, overrides):
        """Every action of an 8-step episode and 3 steps past the capacity
        (the last cache slot and positional row clamp while the position
        keeps counting) equals JAX's streamed action."""
        jax_model, variables, model, state, features = _pair(**overrides)
        images, poses = _episode(features, 11)
        jax_policy = jax_model.create_streaming_policy(variables)
        policy = model.create_streaming_policy(state, device="cpu")
        for t in range(len(images)):
            want = jax_policy.step(images[t], poses[t])
            got = policy.step(images[t], poses[t])
            assert got.shape == (1, 3)
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=f"step {t}")
        assert policy.eager_steps == 11 and policy.graph_replays == 0

    @pytest.mark.parametrize("window", [None, 3])
    def test_matches_the_full_forward_and_resets(self, window):
        _, _, model, state, features = _pair(attention_window=window, num_experts=4)
        network = model.create_network()
        network.load_state_dict(state)
        with torch.no_grad():
            full = network(
                {k: torch.from_numpy(np.asarray(v)) for k, v in features.items()}, "eval"
            )["action"][0].numpy()
        policy = model.create_streaming_policy(state, device="cpu")
        images, poses = _episode(features, 8)
        streamed = np.stack([policy.step(images[t], poses[t])[0] for t in range(8)])
        np.testing.assert_allclose(streamed, full, rtol=SELF_TOL, atol=SELF_TOL)
        policy.reset()
        np.testing.assert_allclose(
            policy.step(images[0][None], poses[0][None])[0], full[0],
            rtol=SELF_TOL, atol=SELF_TOL,
        )

    def test_cache_layout_is_jax_cache_collection(self):
        jax_model, variables, model, state, _ = _pair(num_kv_heads=1, attention_window=3)
        net = jax_model.create_network(decode=True)
        dummy = {
            "image": np.zeros((1, 1, 16, 16, 3), np.float32),
            "gripper_pose": np.zeros((1, 1, 14), np.float32),
        }
        jax_cache = net.init(jax.random.PRNGKey(0), dummy, "predict")["cache"]
        flat = {
            "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jax_cache)[0]
        }
        cache = model.create_network(decode=True).init_cache(1)
        assert set(cache) == set(flat)
        for key, value in cache.items():
            assert tuple(value.shape) == flat[key].shape, key
            assert value.numpy().dtype == flat[key].dtype, key

    def test_batched_policy(self):
        _, _, model, state, features = _pair(attention_window=3)
        images, poses = _episode(features, 4)
        one = model.create_streaming_policy(state, device="cpu")
        two = model.create_streaming_policy(state, batch_size=2, device="cpu")
        for t in range(4):
            want = one.step(images[t], poses[t])
            got = two.step(np.stack([images[t]] * 2), np.stack([poses[t]] * 2))
            np.testing.assert_allclose(got, np.concatenate([want, want]), rtol=1e-6, atol=1e-6)

    def test_graph_needs_the_card(self):
        _, _, model, state, _ = _pair()
        with pytest.raises(ValueError, match="CUDA graph needs the card"):
            model.create_streaming_policy(state, device="cpu", graph=True)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                model.create_streaming_policy(state)


class TestStreamingExport:
    @pytest.mark.parametrize(
        "overrides",
        [dict(attention_window=3), dict(num_experts=4, num_kv_heads=1)],
        ids=["window3", "experts_gqa"],
    )
    def test_round_trip_streams_the_in_process_actions(self, tmp_path, overrides):
        jax_model, variables, model, state, features = _pair(**overrides)
        export_dir = str(tmp_path / "stream_export")
        save_streaming_export(export_dir, model, state)
        assert is_streaming_export(export_dir)
        assert not is_streaming_export(str(tmp_path))
        with open(f"{export_dir}/{STREAM_METADATA_FILENAME}") as f:
            metadata = json.load(f)
        assert {k: metadata[k] for k in (
            "batch_size", "image_shape", "pose_size", "episode_capacity",
            "attention_window")} == {
            "batch_size": 1, "image_shape": [16, 16, 3], "pose_size": 14,
            "episode_capacity": 8,
            "attention_window": overrides.get("attention_window"),
        }

        loaded = StreamingExportedPolicy(export_dir, device="cpu")
        in_process = model.create_streaming_policy(state, device="cpu")
        jax_policy = jax_model.create_streaming_policy(variables)
        images, poses = _episode(features, 10)
        for t in range(10):
            got = loaded.step(images[t], poses[t])
            np.testing.assert_allclose(
                got, in_process.step(images[t], poses[t]), rtol=1e-6, atol=1e-6
            )
            np.testing.assert_allclose(
                got, jax_policy.step(images[t], poses[t]), rtol=TOL, atol=TOL
            )
        # reset() replays the episode identically.
        loaded.reset()
        in_process.reset()
        np.testing.assert_allclose(
            loaded.step(images[0], poses[0]), in_process.step(images[0], poses[0]),
            rtol=1e-6, atol=1e-6,
        )
        assert loaded.eager_steps == 11

    def test_export_needs_no_model_code(self, tmp_path):
        """The program holds the weights and the whole step: the loaded
        policy builds no network."""
        _, _, model, state, _ = _pair()
        export_dir = str(tmp_path / "e")
        save_streaming_export(export_dir, model, state)
        loaded = StreamingExportedPolicy(export_dir, device="cpu")
        program = loaded._step_fn
        assert isinstance(program, torch.fx.GraphModule)
        targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
        assert "aten.index_copy.default" in targets
