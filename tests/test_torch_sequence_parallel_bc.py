"""Port parity: the slice as a whole. Transformer BC trained over a mesh
(layers/transformer.py's sequence-parallel encoder, the trainer's gradient
bucket and data shards) against the JAX package's BC train step on the
same mesh.

The JAX side builds TransformerBCModel with a mesh from the conftest's
8-device CPU mesh (`make_mesh(data=1, sequence=4, ...)` and a 2 x 2 data x
sequence mesh), einsum attention (use_flash=False), and takes the loss
and gradients of one batch under jit. The port's side runs on 4 gloo
ranks (one LocalWorld for the module): each rank takes its data shard,
runs its sequence shard through the kernels' plain versions (B1 a ring hop
forward, B3 and B4 a hop backward) and averages the gradients over the
ranks in the trainer's bucket. Weights are JAX's, converted by
utils/jax_params.py into the mesh network unchanged (a mesh adds no
parameter). Sizes: T = 16, 16x16 images, d_model 32, 2 layers, 4 heads of
8, batch 4. The BC gate: loss 1e-5 rel, each gradient 1e-4 of its max
+ 1e-7.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.data import input_generators as jax_generators
from tensor2robot_tpu.models import transformer_models as jax_models
from tensor2robot_tpu.parallel import mesh as jax_mesh_lib
from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
from tensor2robot_tpu_torch.parallel import launch
from tensor2robot_tpu_torch.predictors import CheckpointPredictor
from tensor2robot_tpu_torch.specs import make_random_numpy
from tensor2robot_tpu_torch.train import durability
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train.metrics import read_metrics
from tensor2robot_tpu_torch.utils.jax_params import flax_params_to_state_dict
from tests import torch_parallel_ranks as ranks

SMALL = dict(action_size=7, pose_size=14, episode_length=16, image_size=(16, 16),
             d_model=32, num_layers=2, num_heads=4, head_dim=8)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def world():
    with launch.LocalWorld(4, threads=1) as w:
        yield w


@pytest.fixture(scope="module")
def jax_start():
    """The JAX model's initial variables (from the mesh-free model: the
    mesh adds no parameter) and one batch of 4 episodes."""
    model = jax_models.TransformerBCModel(use_flash=False, device_type="cpu", **SMALL)
    generator = jax_generators.DefaultRandomInputGenerator(batch_size=4, seed=0)
    generator.set_specification_from_model(model, "train")
    batch = next(iter(generator.create_dataset("train")))
    variables = jax.jit(model.init_variables)(jax.random.PRNGKey(0), batch["features"])
    return jax.tree_util.tree_map(np.asarray, variables), batch


@pytest.fixture(scope="module")
def jax_steps(jax_start):
    """The JAX BC loss and gradients on each mesh shape, computed once."""
    variables, batch = jax_start
    out = {}
    for shape in ((1, 4), (2, 2)):
        mesh = jax_mesh_lib.make_mesh(data=shape[0], sequence=shape[1],
                                      devices=jax.devices()[:4])
        model = jax_models.TransformerBCModel(
            mesh=mesh, use_flash=False, device_type="cpu", **SMALL)
        mesh_shapes = jax.eval_shape(
            lambda: model.init_variables(jax.random.PRNGKey(0), batch["features"]))
        assert (jax.tree_util.tree_structure(mesh_shapes)
                == jax.tree_util.tree_structure(variables))

        def loss_fn(params, model=model):
            v = dict(variables)
            v["params"] = params
            f, l, outputs, _ = model.packed_inference(
                v, batch["features"], "train", labels=batch["labels"])
            return model.model_train_fn(f, l, outputs, "train")[0]

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
        out[shape] = (float(loss), flax_params_to_state_dict(
            jax.tree_util.tree_map(np.asarray, grads)))
    return out


# (mesh shape, the port model's extra kwargs)
CASES = {
    "sequence4_ring_flash": ((1, 4), dict(use_flash=True)),
    "sequence4_ring_einsum": ((1, 4), dict(use_flash=False)),
    "sequence4_ulysses_flash": ((1, 4), dict(use_flash=True, sequence_parallel_mode="ulysses")),
    "data2_sequence2_ring_flash": ((2, 2), dict(use_flash=True)),
    "data2_sequence2_ulysses_flash": ((2, 2), dict(use_flash=True,
                                                   sequence_parallel_mode="ulysses")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bc_train_step_on_the_mesh_matches_jax(world, jax_start, jax_steps, case):
    shape, extra = CASES[case]
    variables, batch = jax_start
    want_loss, want_grads = jax_steps[shape]
    state = {k: v.numpy() for k, v in flax_params_to_state_dict(variables["params"]).items()}
    results = world.run(ranks.bc_step, shape, dict(SMALL, **extra), state, batch)
    for loss, grads in results:
        assert abs(loss - want_loss) <= LOSS_TOL * abs(want_loss)
        assert set(grads) == set(want_grads)
        for name, want in want_grads.items():
            want = want.numpy()
            err = np.abs(grads[name] - want).max()
            assert err <= GRAD_TOL * np.abs(want).max() + 1e-7, (name, err)
    # Every rank holds the same averaged gradient: replicas stay equal.
    for _, grads in results[1:]:
        for name, g in grads.items():
            np.testing.assert_array_equal(g, results[0][1][name])


def test_train_eval_model_on_a_2x2_mesh_writes_the_single_device_layout(world, tmp_path):
    """train_eval_model on data 2 x sequence 2: rank 0 alone writes the
    checkpoints, manifests, metrics and operative config; the checkpoint
    has the single-device layout and serves on one device; a second run
    resumes from it on every rank."""
    model_dir = str(tmp_path)
    kwargs = dict(SMALL, use_flash=True)
    results = world.run(ranks.bc_train_eval, (2, 2), kwargs, model_dir, 4, 2)
    finals = [final for final, _ in results]
    assert all(f == finals[0] for f in finals) and np.isfinite(finals[0]["eval/mse"])
    assert state_lib.checkpoint_steps(model_dir) == [2, 4]
    assert durability.latest_durable_step(model_dir) == 4
    assert [r["step"] for r in read_metrics(os.path.join(model_dir, "train"))] == [2, 4]
    assert os.path.exists(os.path.join(model_dir, "operative_config.gin"))
    single = TransformerBCModel(device_type="cpu", **kwargs)
    layout = {k: tuple(v.shape) for k, v in single.create_network().state_dict().items()}
    assert all(shapes == layout for _, shapes in results)
    checkpoint = state_lib.load_checkpoint(model_dir, 4)
    assert {k: tuple(v.shape) for k, v in checkpoint["params"].items()} == layout
    predictor = CheckpointPredictor(single, checkpoint_dir=model_dir, device="cpu")
    assert predictor.restore() and predictor.model_version == 4
    episodes = make_random_numpy(predictor.get_feature_specification(), batch_size=2, seed=1)
    action = predictor.predict(episodes)["action"]
    assert action.shape == (2, 16, 7) and np.all(np.isfinite(action))
    # Resume: every rank restores 4.pt and trains on to 6.
    resumed = world.run(ranks.bc_train_eval, (2, 2), kwargs, model_dir, 6, 2)
    assert state_lib.checkpoint_steps(model_dir) == [2, 4, 6]
    assert all(final == resumed[0][0] for final, _ in resumed)
    restored = state_lib.load_checkpoint(model_dir, 6)
    assert not all(torch.equal(restored["params"][k], checkpoint["params"][k])
                   for k in layout)


@pytest.fixture(scope="module")
def pins(world):
    return world.run(ranks.unported_pins)


# The pins A9.4c part 1 lifted: a model dim composed with a pipe dim, and
# shard_weight_update on a pipe mesh (tests/test_torch_composed_regimes.py
# holds the composed steps to JAX's); A9's decode over a mesh whose
# sequence dim is 1 (tests/test_torch_mesh_decode.py holds it to JAX's);
# and A9.5's plan, here the sequence x pipe mesh's own
# (tests/test_torch_planner.py holds the planner to JAX's).
LIFTED = ("model_dim", "trainer_shard_weight_update", "decode_over_a_data_mesh",
          "trainer_plan")
# JAX's own refusals, kept as its ValueErrors.
JAXS = {"decode_over_a_mesh": "decode mode is single-device"}


@pytest.mark.parametrize("case", ["model_dim", "decode_over_a_mesh", "trainer_plan",
                                  "trainer_shard_weight_update",
                                  "decode_over_a_data_mesh"])
def test_what_a_real_mesh_still_refuses_names_a9(pins, case):
    """Decoding over a sequence dim keeps JAX's ValueError (JAXS) on every
    rank of a real mesh; the model dim, shard_weight_update on a pipe
    mesh, decoding over a data mesh and a plan on the pipe mesh (A9.5),
    once refused here, now build (LIFTED), so nothing raises naming an
    item of A9 any more. Experts under a sequence dim:
    tests/test_torch_moe_sequence.py."""
    for rank_pins in pins:
        if case in LIFTED:
            assert rank_pins[case] == ""
        else:
            assert rank_pins[case].startswith("ValueError: ")
            assert JAXS[case] in rank_pins[case]


def test_pipelining_builds_on_a_real_mesh_and_refuses_moe(pins):
    """Pipelining left the refusals (tests/test_torch_pipelined_bc.py
    trains it): the encoder builds on a sequence x pipe mesh, and MoE
    inside the pipeline raises JAX's ValueError."""
    for rank_pins in pins:
        assert rank_pins["pipeline_stages"] == ""
        assert rank_pins["moe_in_a_pipeline"].startswith("ValueError: ")
        assert "does not compose with MoE" in rank_pins["moe_in_a_pipeline"]


def test_a_stateless_step_trains_over_data_shards(world):
    """A network without buffers whose preprocessing draws nothing steps
    on a data mesh of 4, every rank with the same averaged loss."""
    results = world.run(ranks.what_data_shards_train)
    assert all(r == dict(results[0]) for r in results)
    assert results[0]["data_shards"] == 4 and np.isfinite(results[0]["loss"])


def test_a_trainer_without_the_models_mesh_raises(world):
    for message in world.run(ranks.trainer_without_the_models_mesh):
        assert "shards the sequence 1-way but the model's mesh carries sequence axis 4" \
            in message
