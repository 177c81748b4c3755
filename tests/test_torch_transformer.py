"""Port parity: tensor2robot_tpu_torch.layers vs the JAX package's layers.

Each flax module is initialized from a fixed key, its params converted by
utils/jax_params.py, and both run on the same numpy input; the flax
attention runs the Pallas kernel in interpret mode (use_flash=True,
interpret=True) while the port's runs its plain flash recurrence on CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.layers.spatial_softmax import spatial_softmax as jax_spatial_softmax
from tensor2robot_tpu.layers import transformer as jax_transformer
from tensor2robot_tpu_torch.layers import spatial_softmax, transformer
from tensor2robot_tpu_torch.utils.jax_params import flax_params_to_state_dict

# Layer outputs after f32 matmuls taken in another order on each side.
TOL = 1e-4
FEATURES, HEADS, HEAD_DIM, SEQ = 32, 2, 16, 16


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def x():
    return np.random.RandomState(0).randn(2, SEQ, FEATURES).astype(np.float32)


def _flax_and_port(flax_module, port_module, x, seed=0):
    variables = flax_module.init(jax.random.PRNGKey(seed), x)
    expected = np.asarray(flax_module.apply(variables, x))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    port_module.load_state_dict(flax_params_to_state_dict(params))
    with torch.no_grad():
        got = port_module(torch.from_numpy(x))
    if isinstance(got, tuple):
        # Blocks and the encoder also return their MoE aux losses: none
        # without experts.
        got, aux = got
        assert not aux
    return got.numpy(), expected


ATTENTION_CASES = {
    "flash_causal": dict(causal=True, use_flash=True),
    "flash_full": dict(causal=False, use_flash=True),
    "flash_window5": dict(causal=True, use_flash=True, window=5),
    "flash_gqa": dict(causal=True, use_flash=True, num_kv_heads=1),
    "einsum_causal": dict(causal=True, use_flash=False),
    "einsum_window3": dict(causal=True, use_flash=False, window=3),
}


class TestMultiHeadAttention:
    @pytest.mark.parametrize(
        "kw", list(ATTENTION_CASES.values()), ids=list(ATTENTION_CASES)
    )
    def test_matches_flax(self, x, kw):
        jax_kw = dict(kw, interpret=True)
        flax_kv = jax_kw.pop("num_kv_heads", None)
        got, expected = _flax_and_port(
            jax_transformer.MultiHeadAttention(
                num_heads=HEADS, head_dim=HEAD_DIM, num_kv_heads=flax_kv,
                **jax_kw,
            ),
            transformer.MultiHeadAttention(FEATURES, HEADS, HEAD_DIM, **kw),
            x,
        )
        np.testing.assert_allclose(got, expected, rtol=TOL, atol=TOL)

    def test_auto_policy_takes_einsum_below_threshold(self, x, monkeypatch):
        """use_flash=None is the einsum path below FLASH_AUTO_SEQ."""
        from tensor2robot_tpu_torch.ops import flash_attention as flash

        calls = []
        monkeypatch.setattr(
            flash, "flash_attention", lambda *a, **k: calls.append(1)
        )
        mha = transformer.MultiHeadAttention(FEATURES, HEADS, HEAD_DIM)
        with torch.no_grad():
            mha(torch.from_numpy(x))
        assert calls == []

    def test_bad_kv_heads(self):
        with pytest.raises(ValueError, match="divisible"):
            transformer.MultiHeadAttention(FEATURES, 3, HEAD_DIM, num_kv_heads=2)


class TestBlocks:
    @pytest.mark.parametrize("use_flash", [True, False])
    def test_block_matches_flax(self, x, use_flash):
        got, expected = _flax_and_port(
            jax_transformer.TransformerBlock(
                num_heads=HEADS, head_dim=HEAD_DIM, use_flash=use_flash,
                interpret=True,
            ),
            transformer.TransformerBlock(
                FEATURES, HEADS, HEAD_DIM, use_flash=use_flash
            ),
            x,
        )
        np.testing.assert_allclose(got, expected, rtol=TOL, atol=TOL)

    @pytest.mark.parametrize("window", [None, 4])
    def test_encoder_matches_flax(self, x, window):
        got, expected = _flax_and_port(
            jax_transformer.TransformerEncoder(
                num_layers=2, num_heads=HEADS, head_dim=HEAD_DIM,
                max_seq_len=SEQ, use_flash=True, interpret=True, window=window,
            ),
            transformer.TransformerEncoder(
                FEATURES, 2, HEADS, HEAD_DIM, max_seq_len=SEQ, use_flash=True,
                window=window,
            ),
            x,
            seed=1,
        )
        np.testing.assert_allclose(got, expected, rtol=TOL, atol=TOL)

    def test_encoder_rejects_long_sequences(self):
        encoder = transformer.TransformerEncoder(FEATURES, 1, HEADS, HEAD_DIM, max_seq_len=4)
        with pytest.raises(ValueError, match="max_seq_len"):
            encoder(torch.zeros(1, 5, FEATURES))

    @pytest.mark.parametrize(
        "kw,error,match",
        [
            # A mesh is ported (A9 part 1): an object that is not the
            # port's DeviceMesh raises TypeError naming the type it wants.
            (dict(mesh=object()), TypeError, r"torch\.distributed\.device_mesh\.DeviceMesh"),
            # Pipelining is ported: a stack the stages do not divide
            # raises JAX's ValueError (tests/test_torch_pipelined_bc.py
            # pins the rest of its rules).
            (dict(pipeline_stages=2), ValueError,
             "num_layers=1 not divisible by pipeline_stages=2"),
            (dict(sequence_parallel_mode="rign"), ValueError, "'ring' or 'ulysses'"),
        ],
        ids=["mesh", "pipeline", "mode_typo"],
    )
    def test_unported_paths_name_their_roadmap_item(self, kw, error, match):
        with pytest.raises(error, match=match):
            transformer.TransformerEncoder(FEATURES, 1, HEADS, HEAD_DIM, **kw)


def _flax_decode(module, params, x):
    """Steps a decode-mode flax module over x [B, T, F] one step at a time
    from a zeroed cache (init runs a step, so its cache is zeroed, as the
    JAX package's StreamingBCPolicy does). Returns ([B, T, F], the cache)."""
    cache = module.init(jax.random.PRNGKey(0), x[:, :1])["cache"]
    cache = jax.tree_util.tree_map(jnp.zeros_like, cache)
    outs = []
    for t in range(x.shape[1]):
        y, mutated = module.apply(
            {"params": params, "cache": cache}, x[:, t:t + 1], mutable=["cache"]
        )
        cache = mutated["cache"]
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=1), cache


def _port_decode(module, cache, x):
    outs = []
    with torch.no_grad():
        for t in range(x.shape[1]):
            state = transformer.DecodeCache(dict(cache))
            y = module(torch.from_numpy(x[:, t:t + 1]), state)
            if isinstance(y, tuple):
                y = y[0]
            cache = state.tensors
            outs.append(y.numpy())
    return np.concatenate(outs, axis=1), cache


def _flat_cache(tree, prefix=""):
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if hasattr(value, "items"):
            flat.update(_flat_cache(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


# Decode vs JAX's decode, step by step: f32 attention over the cache in
# another order on each side.
DECODE_TOL = 1e-5
# (window, kv heads, capacity, steps): steps past the capacity clamp.
DECODE_CASES = {
    "full": (None, 4, 16, 12),
    "window3": (3, 4, 16, 12),
    "gqa_full": (None, 2, 16, 12),
    "gqa_window3": (3, 2, 16, 12),
    "past_capacity": (None, 2, 8, 11),
    "past_capacity_window3": (3, 2, 8, 11),
}


class TestDecode:
    @pytest.mark.parametrize("case", list(DECODE_CASES.values()), ids=list(DECODE_CASES))
    def test_attention_steps_match_flax(self, case):
        window, kv_heads, capacity, steps = case
        x = np.random.RandomState(11).randn(2, steps, FEATURES).astype(np.float32)
        flax_mha = jax_transformer.MultiHeadAttention(
            num_heads=4, head_dim=8, num_kv_heads=kv_heads, window=window,
            decode=True, decode_max_len=capacity,
        )
        params = flax_mha.init(jax.random.PRNGKey(2), x[:, :1])["params"]
        want, want_cache = _flax_decode(flax_mha, params, x)
        mha = transformer.MultiHeadAttention(
            FEATURES, 4, 8, num_kv_heads=kv_heads, window=window, decode=True,
            decode_max_len=capacity,
        )
        mha.load_state_dict(
            flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
        )
        cache = {}
        mha.init_cache(2, transformer.DecodeCache(cache), torch.float32, torch.device("cpu"))
        got, got_cache = _port_decode(mha, cache, x)
        np.testing.assert_allclose(got, want, rtol=DECODE_TOL, atol=DECODE_TOL)
        flat = _flat_cache(want_cache)
        assert set(got_cache) == set(flat)
        assert got_cache["cached_key"].shape == (2, capacity, kv_heads, 8)
        for key, value in flat.items():
            np.testing.assert_allclose(got_cache[key].numpy(), value, rtol=DECODE_TOL, atol=DECODE_TOL)

    @pytest.mark.parametrize("window", [None, 3])
    def test_decode_reproduces_the_full_forward(self, window):
        x = np.random.RandomState(12).randn(1, 10, FEATURES).astype(np.float32)
        full = transformer.MultiHeadAttention(FEATURES, 4, 8, num_kv_heads=2, window=window)
        step = transformer.MultiHeadAttention(
            FEATURES, 4, 8, num_kv_heads=2, window=window, decode=True, decode_max_len=10
        )
        step.load_state_dict(full.state_dict())
        cache = {}
        step.init_cache(1, transformer.DecodeCache(cache), torch.float32, torch.device("cpu"))
        got, _ = _port_decode(step, cache, x)
        with torch.no_grad():
            want = full(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=DECODE_TOL, atol=DECODE_TOL)

    @pytest.mark.parametrize("experts", [1, 4])
    def test_encoder_steps_match_flax(self, experts):
        capacity, steps = 8, 10  # two steps past the capacity
        x = np.random.RandomState(13).randn(2, steps, FEATURES).astype(np.float32)
        kw = dict(num_layers=2, num_heads=HEADS, head_dim=HEAD_DIM, max_seq_len=capacity,
                  window=3, num_kv_heads=1, num_experts=experts)
        flax_encoder = jax_transformer.TransformerEncoder(**kw)
        params = flax_encoder.init(jax.random.PRNGKey(4), x[:, :capacity])["params"]
        want, want_cache = _flax_decode(jax_transformer.TransformerEncoder(decode=True, **kw), params, x)
        encoder = transformer.TransformerEncoder(
            FEATURES, 2, HEADS, HEAD_DIM, max_seq_len=capacity, window=3,
            num_kv_heads=1, num_experts=experts, decode=True,
        )
        encoder.load_state_dict(
            flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
        )
        cache = {}
        encoder.init_cache(2, transformer.DecodeCache(cache), torch.float32, torch.device("cpu"))
        got, got_cache = _port_decode(encoder, cache, x)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        flat = _flat_cache(want_cache)
        assert set(got_cache) == set(flat)
        assert int(got_cache["position"]) == steps == int(flat["position"])
        assert int(got_cache["block_1/attention/cache_index"]) == steps

    def test_one_step_per_call_and_causal_only(self):
        mha = transformer.MultiHeadAttention(FEATURES, HEADS, HEAD_DIM, decode=True, decode_max_len=4)
        cache = {}
        mha.init_cache(1, transformer.DecodeCache(cache), torch.float32, torch.device("cpu"))
        with pytest.raises(ValueError, match="ONE step"):
            mha(torch.zeros(1, 2, FEATURES), transformer.DecodeCache(dict(cache)))
        with pytest.raises(ValueError, match="needs the decode cache"):
            mha(torch.zeros(1, 1, FEATURES))
        acausal = transformer.MultiHeadAttention(
            FEATURES, HEADS, HEAD_DIM, causal=False, decode=True, decode_max_len=4
        )
        with pytest.raises(ValueError, match="causal=True"):
            acausal(torch.zeros(1, 1, FEATURES), transformer.DecodeCache(dict(cache)))
        full = transformer.MultiHeadAttention(FEATURES, HEADS, HEAD_DIM)
        with pytest.raises(ValueError, match="not in decode mode"):
            full(torch.zeros(1, 1, FEATURES), transformer.DecodeCache(dict(cache)))


class TestSpatialSoftmax:
    @pytest.mark.parametrize("shape", [(2, 8, 8, 4), (3, 5, 7, 2), (1, 1, 6, 3)])
    def test_matches_jax(self, shape):
        feats = np.random.RandomState(2).randn(*shape).astype(np.float32)
        want_points, want_maps = jax_spatial_softmax(feats)
        points, maps = spatial_softmax(torch.from_numpy(feats))
        np.testing.assert_allclose(points.numpy(), np.asarray(want_points), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(maps.numpy(), np.asarray(want_maps), rtol=1e-5, atol=1e-6)

    def test_output_order_is_all_x_then_all_y(self):
        feats = torch.full((1, 3, 3, 2), -1e4)
        feats[0, 0, 2, 0] = 0.0  # feature 0 peaks at (row 0, col 2)
        feats[0, 2, 0, 1] = 0.0  # feature 1 peaks at (row 2, col 0)
        points, _ = spatial_softmax(feats)
        np.testing.assert_allclose(points.numpy(), [[1.0, -1.0, -1.0, 1.0]], atol=1e-6)


class TestJaxParams:
    def test_layouts(self):
        params = {
            "Conv_0": {"kernel": np.zeros((3, 3, 4, 8)), "bias": np.zeros(8)},
            "dense": {"kernel": np.zeros((5, 6))},
            "ln": {"scale": np.ones(6), "bias": np.zeros(6)},
            "pos_embedding": np.zeros((10, 6)),
        }
        state = flax_params_to_state_dict(params)
        assert state["Conv_0.weight"].shape == (8, 4, 3, 3)
        assert state["Conv_0.bias"].shape == (8,)
        assert state["dense.weight"].shape == (6, 5)
        assert state["ln.weight"].shape == (6,)
        assert state["pos_embedding"].shape == (10, 6)

    def test_rejects_unknown_kernel_rank(self):
        with pytest.raises(ValueError, match="rank 5"):
            flax_params_to_state_dict({"x": {"kernel": np.zeros((2, 2, 2, 2, 2))}})

    def test_conv1d_kernel_to_torch_layout(self):
        kernel = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)  # [k, in, out]
        weight = flax_params_to_state_dict({"c": {"kernel": kernel}})["c.weight"]
        np.testing.assert_array_equal(weight.numpy(), kernel.transpose(2, 1, 0))
