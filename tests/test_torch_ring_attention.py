"""Port parity: ring and Ulysses attention (parallel/ring_attention.py,
parallel/ulysses_attention.py) against the JAX package's.

The JAX side runs on the conftest's 8-device CPU mesh
(`make_mesh(data=1, sequence=4, devices=jax.devices()[:4])`): the einsum
ring and einsum Ulysses (use_flash=False), jitted and differentiated with
jax.vjp, plus one flash ring with its Pallas kernels in interpret mode.
The port's side runs on 4 gloo ranks (one LocalWorld for the module, every
case in it), each with its sequence shard [B, S/4, H, D]; its flash paths
run the kernels' plain versions at global offsets (B1 a hop forward, B3
and B4 a hop backward). Sizes: B=2, S=16, 4 heads of 8. Outputs and
gradients are f32 online-softmax sums against einsum softmaxes in
another order: 1e-5 abs + rel.
"""

import jax
import numpy as np
import pytest

from tensor2robot_tpu.layers import transformer as jax_transformer
from tensor2robot_tpu.parallel import mesh as jax_mesh_lib
from tensor2robot_tpu.parallel import ring_attention as jax_ring
from tensor2robot_tpu.parallel import ulysses_attention as jax_ulysses
from tensor2robot_tpu_torch.parallel import launch
from tensor2robot_tpu_torch.parallel.ring_attention import _ring_hops
from tensor2robot_tpu_torch.utils.jax_params import flax_params_to_state_dict
from tests import torch_parallel_ranks as ranks

TOL = 1e-5
SHAPE = (2, 16, 4, 8)  # B, S, H, D


@pytest.fixture(scope="module")
def world():
    with launch.LocalWorld(4, threads=1) as w:
        yield w


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_mesh_lib.make_mesh(data=1, sequence=4, devices=jax.devices()[:4])


def _inputs(seed: int):
    rng = np.random.RandomState(seed)
    return [rng.randn(*SHAPE).astype(np.float32) for _ in range(4)]


def _jax_vjp(fn, args, g):
    @jax.jit
    def run(*a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(g)

    out, grads = run(*args)
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, list(grads))


# (port entry, JAX entry, port kwargs, JAX kwargs). A window of 5 over
# shards of 4 truncates the ring to 2 of its 4 hops.
CASES = {
    "ring_flash_causal": ("ring", "ring", dict(causal=True, use_flash=True), {}),
    "ring_einsum_causal": ("ring", "ring", dict(causal=True, use_flash=False), {}),
    "ring_flash_full": ("ring", "ring", dict(causal=False, use_flash=True), {}),
    "ring_flash_window5": ("ring", "ring", dict(causal=True, use_flash=True, window=5), {}),
    "ring_einsum_window5": ("ring", "ring", dict(causal=True, use_flash=False, window=5), {}),
    "ring_manual_window5": ("ring_manual", "ring", dict(causal=True, window=5), {}),
    "ring_auto_is_einsum": ("ring", "ring", dict(causal=True), {}),
    "ulysses_flash_causal": ("ulysses", "ulysses", dict(causal=True, use_flash=True), {}),
    "ulysses_einsum_window5": ("ulysses", "ulysses",
                               dict(causal=True, use_flash=False, window=5), {}),
    "ulysses_manual_causal": ("ulysses_manual", "ulysses", dict(causal=True), {}),
    "ring_flash_window5_vs_interpret": (
        "ring", "ring", dict(causal=True, use_flash=True, window=5),
        dict(use_flash=True, interpret=True)),
}
JAX_ENTRIES = {"ring": jax_ring.ring_attention, "ulysses": jax_ulysses.ulysses_attention}


@pytest.mark.parametrize("case", list(CASES))
def test_attention_and_gradients_match_jax(world, jax_mesh, case):
    kind, jax_kind, kwargs, jax_extra = CASES[case]
    q, k, v, g = _inputs(len(case))
    jax_kwargs = dict(causal=kwargs["causal"], window=kwargs.get("window"),
                      use_flash=False)
    jax_kwargs.update(jax_extra)
    expected, expected_grads = _jax_vjp(
        lambda *a: JAX_ENTRIES[jax_kind](*a, jax_mesh, **jax_kwargs), (q, k, v), g)
    results = world.run(ranks.attention, kind, q, k, v, g, kwargs)
    for i, want in enumerate([expected] + expected_grads):
        got = np.concatenate([r[i] for r in results], axis=1)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=("out", "dq", "dk", "dv")[i])


LAYER_CASES = {
    "ring_gqa": dict(sequence_parallel_mode="ring", use_flash=True, num_kv_heads=2),
    "ring_gqa_window5": dict(sequence_parallel_mode="ring", use_flash=True,
                             num_kv_heads=1, window=5),
    "ulysses_gqa": dict(sequence_parallel_mode="ulysses", use_flash=True, num_kv_heads=2),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_attention_layer_on_the_mesh_matches_jax(world, jax_mesh, case):
    """MultiHeadAttention with a sequence mesh (grouped-query K/V expanded
    before the ring or the all_to_all): output, input gradient, and the
    parameter gradients summed over the ranks."""
    kwargs = dict(LAYER_CASES[case], num_heads=4, head_dim=8, causal=True)
    rng = np.random.RandomState(7)
    x = rng.randn(2, 16, 32).astype(np.float32)
    g = rng.randn(2, 16, 32).astype(np.float32)
    jax_kwargs = {k: v for k, v in kwargs.items() if k != "use_flash"}
    params = jax_transformer.MultiHeadAttention(**jax_kwargs).init(
        jax.random.PRNGKey(0), x)["params"]
    module = jax_transformer.MultiHeadAttention(mesh=jax_mesh, use_flash=False, **jax_kwargs)
    expected, (dparams, dx) = _jax_vjp(
        lambda p, t: module.apply({"params": p}, t), (params, x), g)
    state = {k: t.numpy() for k, t in flax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    results = world.run(ranks.attention_layer, state, x, g, kwargs)
    np.testing.assert_allclose(np.concatenate([r[0] for r in results], axis=1),
                               expected, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.concatenate([r[1] for r in results], axis=1),
                               dx, rtol=TOL, atol=TOL)
    want = flax_params_to_state_dict(dparams)
    for name, grad in want.items():
        got = sum(r[2][name] for r in results)
        np.testing.assert_allclose(got, grad.numpy(), rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize(
    "axis_size,block,causal,window",
    [(4, 4, True, None), (4, 4, False, 5), (4, 4, True, 1), (4, 4, True, 4),
     (4, 4, True, 5), (4, 4, True, 9), (4, 256, True, 300), (8, 128, True, 1000),
     (4, 256, True, 10_000)],
)
def test_ring_hops_match_jax(axis_size, block, causal, window):
    assert _ring_hops(axis_size, block, causal, window) == jax_ring._ring_hops(
        axis_size, block, causal, window)


def test_second_derivative_through_the_flash_ring_raises(world):
    for message in world.run(ranks.second_derivative_raises):
        assert "once-differentiable" in message


def test_ulysses_needs_heads_divisible_by_the_sequence_dim(world):
    for message in world.run(ranks.ulysses_heads_error):
        assert "heads (3) divisible by the 'sequence' axis size (4)" in message
