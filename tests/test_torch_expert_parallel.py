"""Port parity: expert parallelism. MoE BC trained over a 2 data x 2
expert mesh (ops/moe.py: each expert rank computes its resident experts'
FFN, a tiled all_gather puts the experts' outputs together, the trainer's
bucket averages the gradients) against the JAX package's BC train step on
a 2 x 2 data x expert CPU mesh (its MoE's sharding constraint on the
expert dim), on the same weights (utils/jax_params.py) and batch.

Sizes: T = 16, 16x16 images, d_model 32, 2 layers, 4 heads of 8, 4
experts (k = 2), batch 4, on 4 gloo ranks (one LocalWorld for the
module); the flash path runs the kernels' plain versions (B1 forward, B3
and B4 backward), the JAX side einsum attention. Gates: the BC gate, loss
1e-5 rel and each gradient 1e-4 of its max + 1e-7; the router aux loss
1e-6 rel (XLA's and torch's exp differ by an ulp, tests/test_torch_moe.py).
"""

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.data import input_generators as jax_generators
from tensor2robot_tpu.models import transformer_models as jax_models
from tensor2robot_tpu.parallel import mesh as jax_mesh_lib
from tensor2robot_tpu_torch.parallel import launch
from tensor2robot_tpu_torch.utils.jax_params import flax_params_to_state_dict
from tests import torch_parallel_ranks as ranks

SMALL = dict(action_size=7, pose_size=14, episode_length=16, image_size=(16, 16),
             d_model=32, num_layers=2, num_heads=4, head_dim=8, num_experts=4)
LOSS_TOL = 1e-5
AUX_TOL = 1e-6
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def world():
    with launch.LocalWorld(4, threads=1) as w:
        yield w


@pytest.fixture(scope="module")
def jax_step():
    """The JAX MoE BC model's initial variables (the mesh adds none), a
    batch of 4 episodes, and the loss, aux loss and gradients of the step
    on the 2 x 2 data x expert mesh."""
    model = jax_models.TransformerBCModel(use_flash=False, device_type="cpu", **SMALL)
    generator = jax_generators.DefaultRandomInputGenerator(batch_size=4, seed=0)
    generator.set_specification_from_model(model, "train")
    batch = next(iter(generator.create_dataset("train")))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init_variables)(
        jax.random.PRNGKey(0), batch["features"]))
    mesh = jax_mesh_lib.make_mesh(data=2, expert=2, devices=jax.devices()[:4])
    mesh_model = jax_models.TransformerBCModel(
        mesh=mesh, use_flash=False, device_type="cpu", **SMALL)

    def loss_fn(params):
        v = dict(variables, params=params)
        f, l, outputs, _ = mesh_model.packed_inference(
            v, batch["features"], "train", labels=batch["labels"])
        return mesh_model.model_train_fn(f, l, outputs, "train")

    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return dict(
        variables=variables, batch=batch, loss=float(loss),
        aux=float(metrics["loss/moe_aux"]),
        grads=flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads)))


@pytest.fixture(scope="module")
def port_steps(world, jax_step):
    state = {k: v.numpy()
             for k, v in flax_params_to_state_dict(jax_step["variables"]["params"]).items()}
    return {flash: world.run(ranks.moe_step, (2, 2), dict(SMALL, use_flash=flash), state,
                             dict(jax_step["batch"]))
            for flash in (True, False)}


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "einsum"])
def test_moe_bc_over_data_x_expert_matches_jax(jax_step, port_steps, use_flash):
    results = port_steps[use_flash]
    for loss, aux, _, grads, _ in results:
        assert abs(loss - jax_step["loss"]) <= LOSS_TOL * abs(jax_step["loss"])
        assert abs(aux - jax_step["aux"]) <= AUX_TOL * abs(jax_step["aux"])
        assert set(grads) == set(jax_step["grads"])
        for name, want in jax_step["grads"].items():
            want = want.numpy()
            err = np.abs(grads[name] - want).max()
            assert err <= GRAD_TOL * np.abs(want).max() + 1e-7, (name, err)
    for _, _, _, grads, _ in results[1:]:
        for name, g in grads.items():
            np.testing.assert_array_equal(g, results[0][3][name])


def test_each_expert_rank_computes_only_its_resident_experts(port_steps):
    """Before the trainer's bucket, rank r's own gradient of every expert
    weight is zero outside its two resident experts and nonzero inside:
    the other two experts' FFN never ran there. Ranks enumerate data-major
    (rank = 2 x data + expert)."""
    results = port_steps[True]
    assert [resident for *_, resident in results] == [(0, 2), (2, 4), (0, 2), (2, 4)]
    for _, _, own, _, (start, stop) in results:
        assert len(own) == 2 * SMALL["num_layers"]
        for name, grad in own.items():
            others = np.concatenate([grad[:start], grad[stop:]])
            assert not others.any(), name
            assert np.abs(grad[start:stop]).max() > 0, name


def test_an_expert_rank_does_half_the_expert_flops(world):
    """One MoEBlock forward over 2 episodes of 16 steps: on an expert dim
    of 2 each rank's FLOPs fall by exactly half of the expert FFN's and
    the dispatch einsum's (torch.utils.flop_counter); the router and the
    combine run whole."""
    x = np.random.RandomState(3).randn(2, 16, SMALL["d_model"]).astype(np.float32)
    alone = world.run(ranks.moe_forward_flops, SMALL, x, 1)
    split = world.run(ranks.moe_forward_flops, SMALL, x, 2)
    groups, tokens, experts, features = 2, 16, SMALL["num_experts"], SMALL["d_model"]
    hidden = 4 * features
    capacity = 16  # expert_capacity(16, 4, 2, 2.0)
    ffn = 2 * (2 * groups * experts * capacity * features * hidden)
    dispatch = 2 * groups * tokens * experts * capacity * features
    assert len(set(alone)) == 1 and len(set(split)) == 1
    assert alone[0] - split[0] == (ffn + dispatch) // 2


def test_what_experts_over_a_mesh_still_refuse(world):
    """Experts under a sequence dim, once refused here, now build
    (tests/test_torch_moe_sequence.py holds their step to JAX's); an expert
    dim that does not divide the experts keeps its ValueError."""
    for cases in world.run(ranks.moe_unported, SMALL):
        assert cases["expert_x_sequence"] == ""
        assert cases["experts_not_dividing"].startswith("ValueError")
