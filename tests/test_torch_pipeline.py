"""Port parity: parallel/pipeline.py's GPipe schedule against the JAX
package's `pipeline_apply`.

The JAX side runs `pipeline_apply` on the conftest's 8-device CPU mesh (4
devices of it: pipe 4, or data 2 x pipe 2 with the batch over data) and
takes the forward and the gradients of <out, g> with respect to the
stacked stage parameters and the input under jit. The port's side runs on
4 gloo ranks (one LocalWorld for the module): each rank takes its data
shard of the input and its stage of the stacked parameters
(`stage_sharding`), runs the schedule and its written-out backward. Stage:
dense + tanh over 6 features, batch 8. Gate: 1e-5 of each quantity's max.
A stage's gradient is the sum of its data shards' (each rank's loss is
its shard's part of <out, g>).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tensor2robot_tpu.parallel import mesh as jax_mesh_lib
from tensor2robot_tpu.parallel import pipeline as jax_pipeline
from tensor2robot_tpu_torch.parallel import launch
from tests import torch_parallel_ranks as ranks

FEATURES, BATCH = 6, 8
TOL = 1e-5


@pytest.fixture(scope="module")
def world():
    with launch.LocalWorld(4, threads=1) as w:
        yield w


def _stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _inputs(stages: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    stacked = {"w": (rng.randn(stages, FEATURES, FEATURES) * 0.3).astype(np.float32),
               "b": (rng.randn(stages, FEATURES) * 0.1).astype(np.float32)}
    x = rng.randn(BATCH, FEATURES).astype(np.float32)
    g = rng.randn(BATCH, FEATURES).astype(np.float32)
    return stacked, x, g


def _jax_pipeline(data: int, pipe: int, micro: int, stacked, x, g):
    """(out, d stacked, dx) of <pipeline_apply(x), g> on the JAX mesh."""
    mesh = jax_mesh_lib.make_mesh(data=data, pipe=pipe, devices=jax.devices()[:data * pipe])

    def loss(params, x):
        out = jax_pipeline.pipeline_apply(
            _stage_fn, params, x, mesh=mesh, num_microbatches=micro,
            batch_axis=jax_mesh_lib.DATA_AXIS if data > 1 else None)
        return jnp.sum(out * g), out

    (_, out), (dparams, dx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        stacked, x)
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, dparams), np.asarray(dx)


def _close(got, want) -> None:
    err = np.abs(np.asarray(got) - want).max()
    assert err <= TOL * np.abs(want).max(), err


@pytest.mark.parametrize("stages", [2, 4])
@pytest.mark.parametrize("micro", [1, 2, 4])
def test_pipeline_apply_matches_jax(world, stages, micro):
    data = 4 // stages
    stacked, x, g = _inputs(stages)
    want_out, want_grads, want_dx = _jax_pipeline(data, stages, micro, stacked, x, g)
    results = world.run(ranks.pipeline_case, data, stages, micro, stacked, x, g)
    per = BATCH // data
    summed = {k: np.zeros_like(v) for k, v in want_grads.items()}
    for shard, stage, out, dx, grads, calls in results:
        # One ppermute a tick a rank takes part in, each way (M ticks at
        # the chain's ends, M + 1 inside it), and the two broadcasts.
        assert calls == 2 * (micro + (0 < stage < stages - 1)) + 2
        rows = slice(shard * per, (shard + 1) * per)
        _close(out, want_out[rows])  # every pipe rank holds the output
        _close(dx, want_dx[rows])  # stage 0's cotangent, broadcast
        for k, v in grads.items():
            summed[k][stage] += v
    for k, want in want_grads.items():
        _close(summed[k], want)


def test_batch_not_divisible_raises_jaxs_error(world):
    mesh = jax_mesh_lib.make_mesh(pipe=4, devices=jax.devices()[:4])
    stacked, _, _ = _inputs(4)
    with pytest.raises(ValueError, match="not divisible") as jax_err:
        jax_pipeline.pipeline_apply(_stage_fn, stacked, jnp.ones((10, FEATURES)),
                                    mesh=mesh, num_microbatches=3)
    for message in world.run(ranks.pipeline_not_divisible):
        assert message == str(jax_err.value) == "batch 10 not divisible by microbatches 3"


def test_single_stage_runs_no_collective(world):
    """One stage (data 4 x pipe 1): the stage over the microbatches in
    turn, as JAX's single-stage schedule computes, with no point-to-point
    call or broadcast."""
    stacked, x, g = _inputs(1, seed=3)
    want_out, want_grads, want_dx = _jax_pipeline(4, 1, 2, stacked, x, g)
    results = world.run(ranks.pipeline_case, 4, 1, 2, stacked, x, g)
    summed = {k: np.zeros_like(v) for k, v in want_grads.items()}
    for shard, stage, out, dx, grads, calls in results:
        assert stage == 0 and calls == 0
        rows = slice(shard * 2, (shard + 1) * 2)
        _close(out, want_out[rows])
        _close(dx, want_dx[rows])
        for k, v in grads.items():
            summed[k][0] += v
    for k, want in want_grads.items():
        _close(summed[k], want)


@pytest.mark.parametrize("shape", [(2, 1, 2), (1, 2, 2), (1, 1, 4)])
def test_pipe_and_stage_groups(world, shape):
    """mesh.pipe_group is a rank's chain of stages (every coordinate but
    pipe shared), mesh.stage_group the replicas of its stage (the pipe
    coordinate shared); ranks enumerate row-major, pipe fastest here."""
    pipes = shape[2]
    for r in world.run(ranks.pipe_groups, shape):
        first = r["rank"] - r["pipe"]
        assert r["chain"] == list(range(first, first + pipes))
        assert r["replicas"] == list(range(r["pipe"], 4, pipes))
        assert r["size"] == 4 // pipes
