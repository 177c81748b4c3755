"""Port parity: the mixture-of-experts op and module vs the JAX package's.

tensor2robot_tpu_torch/ops/moe.py and layers/moe.py against
tensor2robot_tpu/ops/moe.py and layers/moe.py, and a TransformerBlock with
experts against flax's, on the same numpy inputs and weights (flax params
converted by utils/jax_params.py).

Routing: given the same router probabilities, dispatch, combine and the
aux loss are bit-equal to JAX's (`route_probabilities`). From logits the
two softmaxes differ in the last bit (XLA's exp and torch's round apart
on a few elements in a hundred), so `top_k_routing` holds dispatch
bit-equal and combine and aux within 1e-6 relative. Ties (zero logits)
are exact on both sides, and bit-equal end to end: ties go to the lower
expert index, as jax.lax.top_k breaks them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from tensor2robot_tpu.layers import moe as jax_moe_layers
from tensor2robot_tpu.layers import transformer as jax_transformer
from tensor2robot_tpu.ops import moe as jax_moe
from tensor2robot_tpu_torch.layers import moe as moe_layers
from tensor2robot_tpu_torch.layers import transformer
from tensor2robot_tpu_torch.models.abstract_model import init_parameters
from tensor2robot_tpu_torch.ops import moe
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.utils.jax_params import flax_params_to_state_dict

# Softmax from logits: XLA's and torch's exp differ by one ulp on some
# elements (measured up to 6e-8 absolute on gates in [0, 1]).
ROUTING_RTOL = 1e-6
# f32 einsums over the dense dispatch taken in another order on each side.
TOL = 1e-5
FEATURES, HIDDEN, EXPERTS = 16, 32, 4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


ROUTING_CASES = {
    # (tokens, experts, k, capacity): ample capacity, and capacities small
    # enough to drop primaries and secondaries.
    "k1_ample": (16, 4, 1, 16),
    "k1_drops": (12, 3, 1, 2),
    "k2_ample": (64, 4, 2, 64),
    "k2_drops": (16, 4, 2, 3),
    "k2_drops_8_experts": (32, 8, 2, 5),
}


def _jax_routing(logits, k, capacity):
    r = jax_moe.top_k_routing(jnp.asarray(logits), k, capacity)
    return [np.asarray(t) for t in (r.dispatch, r.combine, r.aux_loss)]


def _port_routing(routing):
    return [t.numpy() for t in (routing.dispatch, routing.combine, routing.aux_loss)]


class TestRouting:
    @pytest.mark.parametrize("case", list(ROUTING_CASES.values()), ids=list(ROUTING_CASES))
    def test_bit_equal_from_jax_probabilities(self, case):
        tokens, experts, k, capacity = case
        logits = np.random.RandomState(tokens + k).randn(tokens, experts).astype(np.float32)
        probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
        want = _jax_routing(logits, k, capacity)
        got = _port_routing(moe.route_probabilities(torch.from_numpy(probs), k, capacity))
        for name, g, w in zip(("dispatch", "combine", "aux"), got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)

    @pytest.mark.parametrize("case", list(ROUTING_CASES.values()), ids=list(ROUTING_CASES))
    def test_from_logits(self, case):
        tokens, experts, k, capacity = case
        logits = np.random.RandomState(tokens + k).randn(tokens, experts).astype(np.float32)
        want = _jax_routing(logits, k, capacity)
        got = _port_routing(moe.top_k_routing(torch.from_numpy(logits), k, capacity))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=ROUTING_RTOL, atol=0)
        np.testing.assert_allclose(got[2], want[2], rtol=ROUTING_RTOL, atol=0)
        if capacity < tokens * k // experts:
            assert want[0].sum() < tokens * k  # the case does drop

    @pytest.mark.parametrize(
        "tokens,experts,k,capacity",
        [(16, 4, 1, 16), (6, 8, 2, 4), (16, 4, 2, 3), (5, 3, 1, 2)],
        ids=["k1", "k2_wide", "k2_drops", "k1_drops"],
    )
    def test_ties_go_to_the_lower_index(self, tokens, experts, k, capacity):
        logits = np.zeros((tokens, experts), np.float32)
        want = _jax_routing(logits, k, capacity)
        got = _port_routing(moe.top_k_routing(torch.from_numpy(logits), k, capacity))
        for name, g, w in zip(("dispatch", "combine", "aux"), got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)
        # Every token's picks are experts 0..k-1 (jax.lax.top_k's order).
        picked = got[0].sum(axis=2)
        assert picked[:, k:].sum() == 0

    def test_aux_loss_uniform_is_one(self):
        routing = moe.top_k_routing(torch.zeros(16, 4), num_selected=1, capacity=16)
        assert float(routing.aux_loss) == 1.0

    def test_primary_picks_win_capacity_over_secondary(self):
        logits = torch.tensor([[1.0, 5.0, -9.0], [5.0, 1.0, -9.0], [5.0, 1.0, -9.0]])
        routing = moe.top_k_routing(logits, num_selected=2, capacity=2)
        np.testing.assert_array_equal(routing.dispatch[:, 0, :].sum(dim=1).numpy(), [0, 1, 1])

    def test_leading_group_dims_route_independently(self):
        logits = torch.from_numpy(np.random.RandomState(3).randn(3, 10, 4).astype(np.float32))
        batched = moe.top_k_routing(logits, 2, 4)
        for g in range(3):
            single = moe.top_k_routing(logits[g], 2, 4)
            for a, b in zip(batched, single):
                torch.testing.assert_close(a[g], b, rtol=0, atol=0)

    @pytest.mark.parametrize(
        "args", [(16, 4, 2, 2.0), (16, 4, 1, 1.25), (2, 8, 2, 1.0), (1, 4, 2, 2.0), (1024, 4, 2, 2.0)]
    )
    def test_expert_capacity_matches_jax(self, args):
        assert moe.expert_capacity(*args) == jax_moe.expert_capacity(*args)


def _weights(seed, features=FEATURES, hidden=HIDDEN, experts=EXPERTS):
    rng = np.random.RandomState(seed)
    return (
        (rng.randn(features, experts) * 0.5).astype(np.float32),
        (rng.randn(experts, features, hidden) / np.sqrt(features)).astype(np.float32),
        (rng.randn(experts, hidden, features) / np.sqrt(hidden)).astype(np.float32),
    )


class TestMoeMlp:
    @pytest.mark.parametrize(
        "group_size,k,factor",
        [(None, 2, 2.0), (8, 2, 2.0), (4, 1, 2.0), (16, 2, 0.5), (1, 2, 2.0)],
        ids=["one_group", "groups_of_8", "k1_groups_of_4", "drops", "one_token_groups"],
    )
    def test_forward_and_gradients_match_jax(self, group_size, k, factor):
        rng = np.random.RandomState(5)
        x = rng.randn(32, FEATURES).astype(np.float32)
        cotangent = rng.randn(32, FEATURES).astype(np.float32)
        weights = _weights(6)
        kw = dict(num_selected=k, capacity_factor=factor, group_size=group_size)

        def jax_loss(x, router, w_in, w_out):
            y, aux = jax_moe.moe_mlp(x, router, w_in, w_out, **kw)
            return jnp.sum(y * cotangent) + 0.5 * aux, (y, aux)

        (_, (want_y, want_aux)), want_grads = jax.value_and_grad(
            jax_loss, argnums=(0, 1, 2, 3), has_aux=True
        )(jnp.asarray(x), *map(jnp.asarray, weights))

        inputs = [torch.tensor(a, requires_grad=True) for a in (x,) + weights]
        y, aux = moe.moe_mlp(*inputs, **kw)
        (torch.sum(y * torch.from_numpy(cotangent)) + 0.5 * aux).backward()

        np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(aux.item(), float(want_aux), rtol=ROUTING_RTOL)
        for name, t, g in zip(("x", "router", "w_in", "w_out"), inputs, want_grads):
            g = np.asarray(g)
            np.testing.assert_allclose(
                t.grad.numpy(), g, rtol=TOL, atol=TOL * np.abs(g).max(), err_msg=name
            )

    def test_bad_group_size(self):
        weights = [torch.from_numpy(w) for w in _weights(0)]
        with pytest.raises(ValueError, match="does not divide"):
            moe.moe_mlp(torch.zeros(10, FEATURES), *weights, group_size=4)

    def test_mesh_names_its_roadmap_item(self):
        """Experts take a mesh (tests/test_torch_expert_parallel.py), and
        since A9 a sequence dim too: a MoEBlock over a sequence dim of 2
        builds (tests/test_torch_moe_sequence.py trains it against JAX).
        Anything but a DeviceMesh of the six dims is a TypeError; an expert
        dim that does not divide the experts a ValueError."""
        weights = [torch.from_numpy(w) for w in _weights(0)]
        with pytest.raises(TypeError, match="DeviceMesh"):
            moe.moe_mlp(torch.zeros(8, FEATURES), *weights, mesh=object())
        mesh_lib.make_mesh()  # the in-process group of one
        # Meshes made without their process groups: construction runs no
        # collective.
        sequence = DeviceMesh("cpu", torch.arange(2).reshape(1, 1, 1, 2, 1, 1),
                              mesh_dim_names=mesh_lib.AXES, _init_backend=False)
        block = moe_layers.MoEBlock(FEATURES, EXPERTS, HIDDEN, mesh=sequence)
        assert block.mesh is sequence
        experts = DeviceMesh("cpu", torch.arange(3).reshape(1, 1, 1, 1, 1, 3),
                             mesh_dim_names=mesh_lib.AXES, _init_backend=False)
        with pytest.raises(ValueError, match="do not split"):
            moe_layers.MoEBlock(FEATURES, EXPERTS, HIDDEN, mesh=experts)


def _flax_params(module, x, seed):
    variables = module.init(jax.random.PRNGKey(seed), x)
    return variables, flax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, variables["params"])
    )


class TestModules:
    @pytest.mark.parametrize("k", [1, 2])
    def test_moe_block_matches_flax(self, k):
        x = np.random.RandomState(7).randn(2, 8, FEATURES).astype(np.float32)
        flax_block = jax_moe_layers.MoEBlock(num_experts=EXPERTS, hidden_dim=HIDDEN, num_selected=k)
        variables, state = _flax_params(flax_block, x, seed=k)
        want_y, want_aux = flax_block.apply(variables, x)
        block = moe_layers.MoEBlock(FEATURES, EXPERTS, HIDDEN, num_selected=k)
        block.load_state_dict(state)
        with torch.no_grad():
            y, aux = block(torch.from_numpy(x))
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=ROUTING_RTOL)

    def test_jax_params_map_the_moe_subtree_raw(self):
        x = np.zeros((1, 4, FEATURES), np.float32)
        variables, state = _flax_params(
            jax_moe_layers.MoEBlock(num_experts=EXPERTS, hidden_dim=HIDDEN), x, seed=0
        )
        assert set(state) == {"router", "w_in", "w_out"}
        for name in state:
            np.testing.assert_array_equal(state[name].numpy(), np.asarray(variables["params"][name]))
        assert tuple(state["w_in"].shape) == (EXPERTS, FEATURES, HIDDEN)

    @pytest.mark.parametrize("use_flash", [True, False])
    def test_transformer_block_with_experts_matches_flax(self, use_flash):
        x = np.random.RandomState(8).randn(2, 16, 32).astype(np.float32)
        flax_block = jax_transformer.TransformerBlock(
            num_heads=2, head_dim=16, num_experts=EXPERTS, use_flash=use_flash, interpret=True
        )
        variables, state = _flax_params(flax_block, x, seed=3)
        # init sowed an aux value; apply appends to a sown collection.
        want, sown = flax_block.apply(
            {"params": variables["params"]}, x, mutable=["moe_aux_loss"]
        )
        block = transformer.TransformerBlock(32, 2, 16, num_experts=EXPERTS, use_flash=use_flash)
        assert sorted(n for n in state if n.startswith("moe.")) == ["moe.router", "moe.w_in", "moe.w_out"]
        block.load_state_dict(state)
        with torch.no_grad():
            got, aux = block(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
        (want_aux,) = jax.tree_util.tree_leaves(sown)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=ROUTING_RTOL)

    def test_dense_block_returns_no_aux(self):
        block = transformer.TransformerBlock(32, 2, 16)
        _, aux = block(torch.zeros(1, 4, 32))
        assert aux is None and not hasattr(block, "moe")

    def test_init_is_flax_lecun_normal(self):
        block = moe_layers.MoEBlock(64, 8, 256)
        init_parameters(block, torch.Generator().manual_seed(0))
        for weight in (block.router, block.w_in, block.w_out):
            fan_in = weight.numel() // weight.shape[-1]
            std = float(weight.detach().std())
            assert abs(std * np.sqrt(fan_in) - 1.0) < 0.05
            assert float(weight.detach().abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.8796 + 1e-6
