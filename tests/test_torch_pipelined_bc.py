"""Port parity: the slice as a whole. Transformer BC with its encoder
pipelined over the pipe dim (layers/transformer.py's pipelined encoder,
parallel/pipeline.py's schedule, the trainer's bucket and stacked
checkpoint) against the JAX package's pipelined BC on the same mesh.

The JAX side builds TransformerBCModel with `pipeline_stages` on the
conftest's 8-device CPU mesh (4 devices of it: 2 data x 2 pipe, 1 x 4
pipe, and 2 sequence x 2 pipe in ring and Ulysses modes), einsum
attention (use_flash=False), and takes the loss and gradients of one
batch under jit; its CompiledModel takes one train step on 2 data x 2
pipe. The port's side runs on 4 gloo ranks (one LocalWorld for the
module): each rank holds its stage of JAX's stacked weights (the encoder
takes them from the stacked layout), runs its share of the batch through
the kernels' plain versions (counted as launches, as on the card), and
the trainer's bucket averages the gradients. Sizes: T = 16, 16x16 images,
d_model 32, 4 layers, 4 heads of 8, batch 4. The BC gate: loss 1e-5 rel,
each gradient 1e-4 of its max + 1e-7.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.data import input_generators as jax_generators
from tensor2robot_tpu.layers.transformer import TransformerEncoder as JaxEncoder
from tensor2robot_tpu.models import transformer_models as jax_models
from tensor2robot_tpu.parallel import mesh as jax_mesh_lib
from tensor2robot_tpu.train.train_eval import CompiledModel
from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
from tensor2robot_tpu_torch.parallel import launch
from tensor2robot_tpu_torch.predictors import CheckpointPredictor
from tensor2robot_tpu_torch.export.saved_model import VARIABLES_FILENAME, list_export_dirs
from tensor2robot_tpu_torch.train import durability
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.utils.jax_params import (
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)
from tests import torch_parallel_ranks as ranks

SMALL = dict(action_size=7, pose_size=14, episode_length=16, image_size=(16, 16),
             d_model=32, num_layers=4, num_heads=4, head_dim=8)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
SERVE_TOL = 1e-4
# The BC model's Adam learning rate (models/optimizers.py's default).
ADAM_LR = 1e-3
# (data, sequence, pipe) -> (mode, B1 = B3 = B4 launches a rank a step:
# blocks a stage x the default microbatches; none under a sequence dim,
# whose manual ring and Ulysses take the einsum tiles, as JAX's do).
MESHES = {
    "data2_pipe2": ((2, 1, 2), "ring", 2 * 2),
    "pipe4": ((1, 1, 4), "ring", 1 * 4),
    "sequence2_pipe2_ring": ((1, 2, 2), "ring", 0),
    "sequence2_pipe2_ulysses": ((1, 2, 2), "ulysses", 0),
}


@pytest.fixture(scope="module")
def world():
    with launch.LocalWorld(4, threads=1) as w:
        yield w


def _jax_mesh(shape):
    data, sequence, pipe = shape
    return jax_mesh_lib.make_mesh(data=data, sequence=sequence, pipe=pipe,
                                  devices=jax.devices()[:data * sequence * pipe])


def _jax_model(shape, mode="ring"):
    return jax_models.TransformerBCModel(
        mesh=_jax_mesh(shape), pipeline_stages=shape[2], sequence_parallel_mode=mode,
        use_flash=False, device_type="cpu", **SMALL)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def jax_run():
    """One batch of 4 episodes; JAX's CompiledModel on 2 data x 2 pipe:
    its initial variables (2 stacked stages) and one train step; and
    jitted initial variables of the 4-stage model."""
    model = _jax_model((2, 1, 2))
    generator = jax_generators.DefaultRandomInputGenerator(batch_size=4, seed=0)
    generator.set_specification_from_model(model, "train")
    batch = next(iter(generator.create_dataset("train")))
    compiled = CompiledModel(model, mesh=model._mesh, donate_state=False)
    state0 = compiled.init_state(jax.random.PRNGKey(0), batch)
    state1, metrics = compiled.train_step(state0, compiled.shard_batch(batch),
                                          jax.random.PRNGKey(1))
    pipe4 = _jax_model((1, 1, 4))
    variables4 = jax.jit(pipe4.init_variables)(jax.random.PRNGKey(0), batch["features"])
    return dict(batch=batch, params={2: _host(state0.params), 4: _host(variables4["params"])},
                stepped=_host(state1.params), step_loss=float(metrics["loss"]))


def _jax_loss_and_grads(shape, mode, params, batch):
    model = _jax_model(shape, mode)

    def loss_fn(p):
        f, l, outputs, _ = model.packed_inference(
            {"params": p}, batch["features"], "train", labels=batch["labels"])
        return model.model_train_fn(f, l, outputs, "train")[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), flax_params_to_state_dict(_host(grads))


def _state(params) -> dict:
    return {k: v.numpy() for k, v in flax_params_to_state_dict(params).items()}


def _check_step(results, want_loss, want_grads) -> None:
    """Every rank's loss, and its gradients: a stage entry against its
    stage's slice of JAX's stacked gradient, any other whole."""
    for loss, stage, grads, _ in results:
        assert abs(loss - want_loss) <= LOSS_TOL * abs(want_loss)
        assert {n.replace("pipe_stages.", "") for n in grads} <= {
            n.replace("pipe_stages.", "") for n in want_grads}
        for name, got in grads.items():
            want = want_grads[name].numpy()
            if ".pipe_stages." in name:
                want = want[stage]
            err = np.abs(got - want).max()
            assert err <= GRAD_TOL * np.abs(want).max() + 1e-7, (name, err)


@pytest.mark.parametrize("case", list(MESHES))
def test_pipelined_bc_step_matches_jax(world, jax_run, case):
    shape, mode, per_step = MESHES[case]
    params = jax_run["params"][shape[2]]
    want_loss, want_grads = _jax_loss_and_grads(shape, mode, params, jax_run["batch"])
    results = world.run(ranks.pipelined_bc_step, shape,
                        dict(SMALL, use_flash=True, sequence_parallel_mode=mode),
                        _state(params), jax_run["batch"], {})
    _check_step(results, want_loss, want_grads)
    assert sorted(r[1] for r in results) == sorted(
        p for _ in range(4 // shape[2]) for p in range(shape[2]))
    for *_, launches in results:
        assert launches == {"flash_fwd": 0, "flash_fwd_tile": per_step,
                            "flash_bwd_dq": per_step, "flash_bwd_dkv": per_step}


def test_remat_and_grad_accum_compose_with_the_pipeline(world, jax_run):
    """remat + grad_accum_steps=2 on 2 data x 2 pipe (JAX's
    test_pipeline_composes_with_grad_accum_and_remat, held to the plain
    step): each global microbatch of 2 (1 a data shard) through a
    one-microbatch pipeline, each block recomputed in the backward."""
    params = jax_run["params"][2]
    want_loss, want_grads = _jax_loss_and_grads((2, 1, 2), "ring", params, jax_run["batch"])
    results = world.run(ranks.pipelined_bc_step, (2, 1, 2), dict(SMALL, use_flash=True),
                        _state(params), jax_run["batch"],
                        dict(remat=True, grad_accum_steps=2))
    _check_step(results, want_loss, want_grads)
    for *_, launches in results:
        # 2 microbatches x 2 blocks, B1 again in each block's recompute.
        assert launches == {"flash_fwd": 0, "flash_fwd_tile": 8, "flash_bwd_dq": 4,
                            "flash_bwd_dkv": 4}


def test_trainer_step_writes_the_stacked_checkpoint_and_the_twin_serves_it(
        world, jax_run, tmp_path):
    """One trainer step on 2 data x 2 pipe from JAX's initial weights:
    rank 0's checkpoint holds the stages stacked as JAX's tree does, each
    leaf against JAX's CompiledModel step under the gradient gate; the
    single-device twin serves it through CheckpointPredictor, against
    JAX's pipelined forward on JAX's stepped weights."""
    model_dir = str(tmp_path)
    results = world.run(ranks.pipelined_bc_checkpoint, dict(SMALL, use_flash=True),
                        _state(jax_run["params"][2]), jax_run["batch"], model_dir)
    for loss, names in results:
        assert abs(loss - jax_run["step_loss"]) <= LOSS_TOL * abs(jax_run["step_loss"])
        assert all("block_" not in n or ".pipe_stages.block_" in n for n in names)
    assert durability.latest_durable_step(model_dir) == 1
    checkpoint = state_lib.load_checkpoint(model_dir, 1)
    got = state_dict_to_flax_params(checkpoint["params"])
    want = jax_run["stepped"]
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert got["encoder"]["pipe_stages"]["block_0"]["attention"]["qkv"]["kernel"].shape[0] == 2
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        keys = [entry.key for entry in path]
        mine = got
        for key in keys:
            mine = mine[key]
        err = np.abs(mine - leaf).max()
        if "pipe_stages" in keys:
            assert err <= GRAD_TOL * np.abs(leaf).max() + 1e-7, (keys, err)
        else:
            # Adam's first step moves an element by lr * g / (|g| + eps),
            # which swings where g is near eps (the embed's kernel): held
            # within one step size, their gradients are the step test's.
            assert err <= ADAM_LR, (keys, err)
    # Adam moments stacked with their stage.
    moments = checkpoint["optimizer"]["state"]
    assert {tuple(v["exp_avg"].shape[:1]) for v in moments.values()
            if v["exp_avg"].ndim == 3} == {(2,)}

    twin = TransformerBCModel(device_type="cpu", use_flash=True, **SMALL)
    predictor = CheckpointPredictor(twin, checkpoint_dir=model_dir, device="cpu")
    assert predictor.restore() and predictor.model_version == 1
    features = jax_run["batch"]["features"]
    served = predictor.predict({k: np.asarray(v) for k, v in features.items()})["action"]
    model = _jax_model((2, 1, 2))
    outputs, _ = jax.jit(lambda p: model.inference_network_fn(
        {"params": p}, features, "eval"))(want)
    expected = np.asarray(outputs["inference_output"])
    assert served.shape == expected.shape == (4, 16, 7)
    assert np.max(np.abs(served - expected) / (1 + np.abs(expected))) <= SERVE_TOL


def test_train_eval_model_exports_hooks_and_continuous_eval_on_a_pipe_mesh(
        world, tmp_path):
    """train_eval_model (EMA on) on 2 data x 2 pipe with an exporter and
    StepTimingHook, then continuous_eval over the mesh with an exporter:
    every rank sees the same evals; rank 0 alone hooks and exports, and
    each export holds the single-device twin's whole chain, the EMA
    parameters of the stacked checkpoint."""
    model_dir = str(tmp_path)
    results = world.run(ranks.pipelined_bc_train_eval, SMALL, model_dir, 2)
    assert all(r["final"] == results[0]["final"] and r["evaluated"] == results[0]["final"]
               for r in results)
    assert np.isfinite(results[0]["final"]["eval/mse"])
    assert [r["timed_rows"] is not None for r in results] == [True, False, False, False]
    checkpoint = state_lib.load_checkpoint(model_dir, 2)
    twin = TransformerBCModel(device_type="cpu", **SMALL).create_network()
    twin.load_state_dict({**checkpoint["params"], **checkpoint["ema_params"]})
    chain = twin.state_dict()
    for name in ("latest", "continuous"):
        (version,) = list_export_dirs(f"{model_dir}/export/{name}")
        exported = torch.load(os.path.join(version, VARIABLES_FILENAME), weights_only=True)
        assert set(exported) == set(chain)
        for key, value in chain.items():
            np.testing.assert_array_equal(exported[key].numpy(), value.numpy(), err_msg=key)


def test_flax_pipe_stages_convert_three_ways(jax_run):
    """utils/jax_params.py on JAX's stacked `pipe_stages` tree: stacked
    (the checkpoint layout), one rank's stage, the chain of the
    single-device twin (JAX's param surgery), and back. The twin loaded
    with the chain computes JAX's pipelined forward."""
    params = jax_run["params"][2]
    stacked = flax_params_to_state_dict(params)
    key = "encoder.pipe_stages.block_1.mlp_in.weight"
    for stage in (0, 1):
        one = flax_params_to_state_dict(params, pipe_stage=stage)
        assert set(one) == set(stacked)
        np.testing.assert_array_equal(one[key].numpy(), stacked[key][stage].numpy())
    chain = flax_params_to_state_dict(params, pipe_stage="chain")
    np.testing.assert_array_equal(chain["encoder.block_3.mlp_in.weight"].numpy(),
                                  stacked[key][1].numpy())
    back = state_dict_to_flax_params(stacked)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for (_, got), (_, want) in zip(jax.tree_util.tree_leaves_with_path(back),
                                   jax.tree_util.tree_leaves_with_path(params)):
        np.testing.assert_array_equal(got, want)
    twin = TransformerBCModel(device_type="cpu", use_flash=True, **SMALL)
    network = twin.create_network()
    network.load_state_dict(chain)
    features = jax_run["batch"]["features"]
    with torch.inference_mode():
        network.eval()
        got = twin.packed_inference(network, {k: torch.from_numpy(np.asarray(v))
                                              for k, v in features.items()},
                                    "eval")[2]["inference_output"].numpy()
    model = _jax_model((2, 1, 2))
    outputs, _ = jax.jit(lambda p: model.inference_network_fn(
        {"params": p}, features, "eval"))(params)
    want = np.asarray(outputs["inference_output"])
    assert np.max(np.abs(got - want) / (1 + np.abs(want))) <= SERVE_TOL


def test_bad_configs_raise_jaxs_value_errors(world):
    """Every composition rule of JAX's `_pipelined_blocks` raises the same
    ValueError on every rank (JAX's test_bad_configs_rejected and the
    rules past it)."""
    x = jnp.zeros((2, 8, 16))
    pipe = _jax_mesh((2, 1, 2))
    seq_pipe = _jax_mesh((1, 2, 2))
    jax_cases = {
        "layers_not_divisible": (dict(num_layers=3, mesh=pipe), x),
        "moe": (dict(mesh=pipe, num_experts=4), x),
        "no_mesh": (dict(), x),
        "pipe_size": (dict(mesh=pipe, pipeline_stages=4), x),
        "mode": (dict(mesh=seq_pipe, sequence_parallel_mode="bogus"), x),
        "ulysses_heads": (dict(mesh=seq_pipe, num_heads=3,
                               sequence_parallel_mode="ulysses"), x),
        "sequence": (dict(mesh=seq_pipe), jnp.zeros((2, 7, 16))),
    }
    want = {}
    for name, (kwargs, inputs) in jax_cases.items():
        kwargs = dict(dict(num_layers=4, num_heads=2, head_dim=8, use_flash=False,
                           pipeline_stages=2), **kwargs)
        with pytest.raises(ValueError) as err:
            JaxEncoder(**kwargs).init(jax.random.PRNGKey(0), inputs)
        want[name] = str(err.value)
    assert "requires a mesh" in want["no_mesh"] and "MoE" in want["moe"]
    for got in world.run(ranks.pipeline_config_errors, 16):
        assert got == want
