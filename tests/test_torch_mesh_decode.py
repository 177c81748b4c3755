"""Port parity: decode and predict over a mesh (ROADMAP.md A9, items 2-3).

  * A decode-mode encoder on a 2-rank mesh whose sequence dim is 1 steps
    as the JAX package's decode on the same CPU mesh: on 2 data ranks
    (each rank decodes its batch shard) and, with 4 experts, on 2 expert
    ranks (each computes its resident experts' FFN): every step's output
    within 1e-4, as tests/test_torch_transformer.py holds one device's.
    Over a sequence dim decoding keeps JAX's ValueError.
  * predict_from_model(..., mesh=) of BC built on a 2-rank sequence mesh
    predicts on every rank from the replicated restore, through the model
    without its mesh: the outputs equal the no-mesh call's.

One LocalWorld of 2 gloo ranks; about 15 s on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.layers import transformer as jax_transformer
from tensor2robot_tpu.parallel import mesh as jax_mesh_lib
from tensor2robot_tpu_torch.data.input_generators import DefaultRandomInputGenerator
from tensor2robot_tpu_torch.layers import transformer
from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
from tensor2robot_tpu_torch.parallel import launch
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.train import train_eval
from tensor2robot_tpu_torch.utils.jax_params import flax_params_to_state_dict
from tests import torch_moe_maml_ranks as ranks

TOL = 1e-4
FEATURES, HEADS, HEAD_DIM = 32, 2, 16
# case -> (mesh (data, fsdp, model, sequence, pipe, expert), experts).
CASES = {"data": ((2, 1, 1, 1, 1, 1), 1), "expert": ((1, 1, 1, 1, 1, 2), 4)}
BC = dict(episode_length=8, image_size=(16, 16), d_model=32, num_layers=2, num_heads=2,
          head_dim=16, use_flash=True)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def world():
    with launch.LocalWorld(2, threads=1) as w:
        yield w


def _jax_mesh(shape):
    return jax_mesh_lib.make_mesh(**dict(zip(mesh_lib.AXES, shape)),
                                  devices=jax.devices()[:2])


@pytest.mark.parametrize("case", list(CASES))
def test_decode_over_a_mesh_matches_jax(world, case):
    shape, experts = CASES[case]
    capacity, steps = 8, 10  # two steps past the capacity
    x = np.random.RandomState(13).randn(2, steps, FEATURES).astype(np.float32)
    kw = dict(num_layers=2, num_heads=HEADS, head_dim=HEAD_DIM, max_seq_len=capacity,
              window=3, num_experts=experts)
    # Jitted: an eager flax init of the MoE encoder takes tens of seconds.
    params = jax.jit(jax_transformer.TransformerEncoder(**kw).init)(
        jax.random.PRNGKey(4), x[:, :capacity])["params"]
    module = jax_transformer.TransformerEncoder(decode=True, mesh=_jax_mesh(shape), **kw)
    cache = jax.tree_util.tree_map(
        jnp.zeros_like, jax.jit(module.init)(jax.random.PRNGKey(0), x[:, :1])["cache"])
    step = jax.jit(lambda cache, xt: module.apply({"params": params, "cache": cache}, xt,
                                                  mutable=["cache"]))
    want = []
    for t in range(steps):
        y, mutated = step(cache, x[:, t:t + 1])
        cache = mutated["cache"]
        want.append(np.asarray(y))
    want = np.concatenate(want, axis=1)
    state = {k: v.numpy() for k, v in flax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    port_kw = dict(features=FEATURES, num_layers=2, num_heads=HEADS, head_dim=HEAD_DIM,
                   max_seq_len=capacity, window=3, num_experts=experts)
    results = world.run(ranks.decode_steps, shape, port_kw, state, x)
    data = shape[0]
    for rank, got in enumerate(results):
        rows = want[rank * 2 // data:(rank + 1) * 2 // data] if data > 1 else want
        np.testing.assert_allclose(got, rows, rtol=TOL, atol=TOL)


def test_decode_over_a_sequence_dim_keeps_jaxs_refusal():
    """Construction runs no collective: a mesh made without its process
    groups is enough to show the ValueError."""
    from torch.distributed.device_mesh import DeviceMesh

    mesh_lib.make_mesh()  # the in-process group of one
    sequence = DeviceMesh("cpu", torch.arange(2).reshape(1, 1, 1, 2, 1, 1),
                          mesh_dim_names=mesh_lib.AXES, _init_backend=False)
    with pytest.raises(ValueError, match="decode mode is single-device"):
        transformer.TransformerEncoder(FEATURES, 2, HEADS, HEAD_DIM, mesh=sequence,
                                       decode=True)
    # The mesh's other dims decode (test_decode_over_a_mesh_matches_jax).
    data = DeviceMesh("cpu", torch.arange(2).reshape(2, 1, 1, 1, 1, 1),
                      mesh_dim_names=mesh_lib.AXES, _init_backend=False)
    transformer.TransformerEncoder(FEATURES, 2, HEADS, HEAD_DIM, mesh=data, decode=True)


def test_predict_from_model_over_a_mesh_equals_the_no_mesh_call(world, tmp_path):
    model_dir = str(tmp_path)
    train_eval.train_eval_model(
        TransformerBCModel(device_type="cpu", **BC),
        DefaultRandomInputGenerator(batch_size=2, seed=0), model_dir=model_dir,
        max_train_steps=2, save_checkpoints_steps=2, device="cpu")
    want = next(iter(train_eval.predict_from_model(
        TransformerBCModel(device_type="cpu", **BC),
        DefaultRandomInputGenerator(batch_size=2, seed=5), model_dir, device="cpu")))
    results = world.run(ranks.predict_over_a_mesh, (1, 1, 1, 2, 1, 1), BC, model_dir, 2)
    for got in results:
        assert set(got) == set(want.keys())
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value)
