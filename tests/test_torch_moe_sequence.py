"""Port parity: experts under a sequence dim. MoE BC trained over 2 expert
x 2 sequence ranks (ring attention) and over 2 data x 2 sequence ranks
(Ulysses): each block's MoE gathers the episode's sequence shards before
routing and slices this rank's back after the combine (layers/moe.py),
against the JAX package's BC gradient on the same CPU mesh (GSPMD: its
MoE sees the global tokens) from the same weights and batch.

Sizes: T = 16, 16x16 images, d_model 32, 2 layers, 4 heads of 8, 4
experts (k = 2), batch 4, on 4 gloo ranks (one LocalWorld for the
module); the port's flash path runs the kernels' plain versions (B1 on
each ring hop, B3 and B4 in the backward), counted as the kernels would
be; the JAX side einsum attention. Gates: the loss, the router aux loss
and every gradient within JAX's own rtol=1e-5, atol=1e-6. The control
(the MoE gather's backward slicing the cotangent instead of summing it
over the sequence ranks) must miss the BC gate (1e-4 of a gradient's
max + 1e-7) by 100x or more.

The module runs in about 25 s on the CPU, most of it JAX's two compiles.
"""

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.data import input_generators as jax_generators
from tensor2robot_tpu.models import transformer_models as jax_models
from tensor2robot_tpu.parallel import mesh as jax_mesh_lib
from tensor2robot_tpu_torch.parallel import launch
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.utils.jax_params import flax_params_to_state_dict
from tests import torch_moe_maml_ranks as ranks

SMALL = dict(action_size=7, pose_size=14, episode_length=16, image_size=(16, 16),
             d_model=32, num_layers=2, num_heads=4, head_dim=8, num_experts=4)
RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-4
CONTROL_MARGIN = 100

# case -> (mesh (data, fsdp, model, sequence, pipe, expert), sequence mode).
CASES = {"expert_x_sequence_ring": ((1, 1, 1, 2, 1, 2), "ring"),
         "data_x_sequence_ulysses": ((2, 1, 1, 2, 1, 1), "ulysses")}


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
def jax_steps():
    """The JAX MoE BC model's initial parameters (torch layout), a batch of
    4 episodes (flat, for the ranks), and for each case the loss, aux loss
    and gradients of the step on its mesh."""
    model = jax_models.TransformerBCModel(use_flash=False, device_type="cpu", **SMALL)
    generator = jax_generators.DefaultRandomInputGenerator(batch_size=4, seed=0)
    generator.set_specification_from_model(model, "train")
    batch = next(iter(generator.create_dataset("train")))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init_variables)(
        jax.random.PRNGKey(0), batch["features"]))
    out = dict(weights={k: v.numpy() for k, v in
                        flax_params_to_state_dict(variables["params"]).items()},
               batch={f"{part}/{key}": np.asarray(value) for part in ("features", "labels")
                      for key, value in batch[part].items()})
    for case, (shape, mode) in CASES.items():
        mesh = jax_mesh_lib.make_mesh(**dict(zip(mesh_lib.AXES, shape)),
                                      devices=jax.devices()[:4])
        mesh_model = jax_models.TransformerBCModel(
            mesh=mesh, use_flash=False, device_type="cpu", sequence_parallel_mode=mode,
            **SMALL)

        def loss_fn(params, mesh_model=mesh_model):
            f, l, outputs, _ = mesh_model.packed_inference(
                dict(variables, params=params), batch["features"], "train",
                labels=batch["labels"])
            return mesh_model.model_train_fn(f, l, outputs, "train")

        (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])
        out[case] = dict(loss=float(loss), aux=float(metrics["loss/moe_aux"]),
                         grads={k: v.numpy() for k, v in flax_params_to_state_dict(
                             jax.tree_util.tree_map(np.asarray, grads)).items()})
    return out


def _run(world, jax_steps, case, control=False):
    shape, mode = CASES[case]
    return world.run(ranks.moe_sequence_step, shape,
                     dict(SMALL, use_flash=True, sequence_parallel_mode=mode),
                     jax_steps["weights"], jax_steps["batch"], control)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_under_a_sequence_dim_matches_jax_gspmd(world, jax_steps, case):
    """Loss, aux and every gradient of every rank within JAX's own
    tolerance; the ranks agree bit for bit; B1/B3/B4 run as on a dense
    encoder's sequence mesh (2 layers x the ring's 2 hops; one local flash
    a layer under Ulysses)."""
    want = jax_steps[case]
    results = _run(world, jax_steps, case)
    per_step = 2 * (2 if CASES[case][1] == "ring" else 1)
    for out in results:
        np.testing.assert_allclose(out["loss"], want["loss"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out["aux"], want["aux"], rtol=RTOL, atol=ATOL)
        assert set(out["grads"]) == set(want["grads"])
        for name, value in want["grads"].items():
            np.testing.assert_allclose(out["grads"][name], value, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        assert out["launches"] == {"flash_fwd": 0, "flash_fwd_tile": per_step,
                                   "flash_bwd_dq": per_step, "flash_bwd_dkv": per_step}
    for out in results[1:]:
        for name, g in out["grads"].items():
            np.testing.assert_array_equal(g, results[0]["grads"][name])


def test_a_slicing_moe_gather_fails_the_gate(world, jax_steps):
    """The control: with the MoE gather's backward slicing the cotangent,
    the aux loss's cotangent reaches each rank's tokens once where the
    rule needs it N times, and the router's and the layers' below
    gradients miss the BC gate by 100x or more; the loss is unchanged."""
    case = "expert_x_sequence_ring"
    want = jax_steps[case]
    for out in _run(world, jax_steps, case, control=True):
        np.testing.assert_allclose(out["loss"], want["loss"], rtol=RTOL, atol=ATOL)
        worst = max(np.abs(out["grads"][name] - value).max()
                    / (GRAD_TOL * np.abs(value).max() + 1e-7)
                    for name, value in want["grads"].items())
        assert worst >= CONTROL_MARGIN, worst


def test_moe_in_a_pipeline_keeps_jaxs_refusal():
    """MoE inside a pipeline raises JAX's ValueError before any
    collective (the encoder checks its composition first)."""
    from tensor2robot_tpu_torch.layers.transformer import TransformerEncoder

    with pytest.raises(ValueError, match="does not compose with MoE"):
        TransformerEncoder(32, 2, 4, 8, pipeline_stages=2, num_experts=4, mesh=object())
