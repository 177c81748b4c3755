"""Port parity: ZeRO-2 weight-update sharding and its gradient codecs.

One LocalWorld of 4 gloo ranks for the module, a 4-way data mesh, against
the JAX package on a 4-device data mesh of the CPU:

  * the codecs' reduce_scatter and all_gather_shard against JAX's under
    `smap`: what each rank sent (`sent`, the dequantized payload) bit for
    bit with JAX's eager encode and decode of the same rows, and with the
    smap program's for fp16, int8 and none (XLA compiles the fp8 codecs'
    division by the format's max as a multiplication by its reciprocal,
    which moves some scales by one ulp: those are held to one ulp of the
    block's scale); `reduced` and `full` within 1e-6 of their max;
  * the mock classifier's Trainer(shard_weight_update=True) against JAX's
    CompiledModel(shard_weight_update=True) on the same weights and batch
    (16 examples, 4 a rank): "none" (zero2) after 3 steps, on the mock at
    wider hidden widths (ranks.WIDE) so that one leaf has
    mesh.MIN_WEIGHT_SIZE elements or more and shards, loss 1e-5 rel and
    parameters 1e-5 of their max, and against the port's own replicated
    step to rounding; each codec (quant_zero2) after 10 steps
    within tests/test_collectives.py's tolerances, against JAX's quantized
    step and against JAX's exact one. The port ravels in its own order, so
    block boundaries differ from JAX's: a quantized step agrees within the
    quantization tolerance, not bit for bit;
  * the quantized state: the residuals' checkpoint round trip (a resumed
    run equal to the uninterrupted one bit for bit), the flat EMA mirror
    against JAX's, local batch norms averaged over the data ranks against
    JAX's, the flag inert outside ZeRO-2, T2R_COLLECTIVE_QUANT and
    T2R_COLLECTIVE_BLOCK selecting the codec, the refusals,
    grad-accum 2 against JAX's, collective_log_record's keys, and
    train_eval_model in int8 with a checkpoint and a resume.

The module runs in about a minute on the CPU.
"""

import flax.linen as flax_nn
import jax
import jax.flatten_util
import numpy as np
import pytest
import torch

from tensor2robot_tpu.parallel import collectives as jax_collectives
from tensor2robot_tpu.parallel import mesh as jax_mesh_lib
from tensor2robot_tpu.train import train_eval as jax_train_eval
from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct
from tensor2robot_tpu.train.state import ema_as_tree as jax_ema_as_tree
from tensor2robot_tpu.utils.mocks import (
    MockInputGenerator as JaxMockInput,
    MockT2RModel as JaxMock,
)
from jax.sharding import PartitionSpec as P
from tensor2robot_tpu_torch.parallel import launch
from tensor2robot_tpu_torch.parallel.mesh import MIN_WEIGHT_SIZE
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train.metrics import read_metrics
from tensor2robot_tpu_torch.utils.jax_params import (
    flax_params_to_state_dict,
    flax_variables_to_state_dict,
)
from tests import torch_zero2_ranks as ranks

N = 4
BLOCK = 64
L = 4 * BLOCK
LOSS_TOL = 1e-5
PARAM_TOL = 1e-5
# tests/test_collectives.py:266-296: (loss abs, params abs) after 10 steps.
QUANT_TOLS = {
    "fp16": (2e-4, 2e-3),
    "int8": (2e-3, 2e-2),
    "fp8_e4m3": (2e-3, 2e-2),
    "fp8_e5m2": (5e-3, 5e-2),
}
NAMES = ["none"] + sorted(QUANT_TOLS)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def world():
    with launch.LocalWorld(N, threads=1) as w:
        yield w


def _jax_mesh():
    return jax_mesh_lib.make_mesh(data=N, devices=jax.devices()[:N])


# -- the codecs over the ranks ------------------------------------------------------


def _rows(seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(N, N, L).astype(np.float32)


def _jax_collectives(coll, rows, shards):
    mesh = _jax_mesh()

    def local(r, s):
        reduced, sent = coll.reduce_scatter(r[0], "data")
        full, sent_shard = coll.all_gather_shard(s[0], "data")
        return reduced[None], sent[None], full[None], sent_shard[None]

    fn = jax_collectives.smap(local, mesh, (P("data"), P("data")), (P("data"),) * 4)
    return [np.asarray(x) for x in fn(rows, shards)]


@pytest.mark.parametrize("name", NAMES)
def test_codec_collectives_match_jax(world, name):
    rows, shards = _rows(1), _rows(2)[:, 0, :]
    got = world.run(ranks.codec_collectives, name, BLOCK, rows, shards)
    coll = jax_collectives.get_collective(name, BLOCK)
    reduced, sent, full, sent_shard = _jax_collectives(coll, rows, shards)
    for r, out in enumerate(got):
        eager_sent = np.asarray(coll.decode(coll.encode(rows[r])))
        np.testing.assert_array_equal(out["sent"], eager_sent)
        np.testing.assert_array_equal(
            out["sent_shard"], np.asarray(coll.decode(coll.encode(shards[r]))))
        if name.startswith("fp8"):
            # One ulp of a block's scale, and the f32 decode's own rounding.
            scale = np.abs(rows[r]).reshape(N, L // BLOCK, BLOCK).max(-1, keepdims=True)
            tol = np.broadcast_to(scale * 2.0 ** -22, (N, L // BLOCK, BLOCK)).reshape(N, L)
            assert (np.abs(out["sent"] - sent[r]) <= tol).all()
        else:
            np.testing.assert_array_equal(out["sent"], sent[r])
        for ours, theirs in ((out["reduced"], reduced[r]), (out["full"], full[r])):
            assert np.abs(ours - theirs).max() <= 1e-6 * np.abs(theirs).max()
    for out in got[1:]:
        np.testing.assert_array_equal(out["full"], got[0]["full"])


# -- the trainer ----------------------------------------------------------------------


class _JaxWideNetwork(flax_nn.Module):
    """The JAX mock's network at the hidden widths ranks.WIDE, without
    batch norms."""

    @flax_nn.compact
    def __call__(self, features, mode: str):
        x = features["x"]
        for width in ranks.WIDE:
            x = flax_nn.relu(flax_nn.Dense(width)(x))
        out = JaxStruct()
        out["a_predicted"] = flax_nn.Dense(1)(x)
        return out


class _JaxWideMock(JaxMock):
    def create_network(self):
        return _JaxWideNetwork()


def _jax_batch():
    model = JaxMock(device_type="cpu", use_batch_norm=False)
    generator = JaxMockInput(batch_size=16, seed=0)
    generator.set_specification_from_model(model, "train")
    return next(iter(generator.create_dataset("train")))


def _jax_run(steps: int, use_batch_norm: bool = False, use_ema: bool = False,
             wide: bool = False, **kwargs):
    """JAX's CompiledModel(shard_weight_update=True) on the 4-device data
    mesh, of the mock (the wide one with `wide`): (losses, final state,
    its initial variables)."""
    model = (_JaxWideMock if wide else JaxMock)(
        device_type="cpu", use_batch_norm=use_batch_norm,
        use_avg_model_params=use_ema, avg_model_params_decay=0.9)
    batch = _jax_batch()
    compiled = jax_train_eval.CompiledModel(
        model, mesh=_jax_mesh(), donate_state=False, shard_weight_update=True, **kwargs)
    state = compiled.init_state(jax.random.PRNGKey(0), batch)
    initial = jax.tree_util.tree_map(np.asarray, jax.device_get(dict(state.variables)))
    losses, rng = [], jax.random.PRNGKey(7)
    for _ in range(steps):
        state, metrics = compiled.train_step(state, compiled.shard_batch(batch), rng)
        losses.append(float(jax.device_get(metrics["loss"])))
    return losses, state, initial


def _weights(variables) -> dict:
    return {k: v.numpy() for k, v in flax_variables_to_state_dict(variables).items()}


def _port_batch() -> dict:
    batch = _jax_batch()
    return {"features/x": np.asarray(batch["features"]["x"]),
            "labels/a_target": np.asarray(batch["labels"]["a_target"])}


def _jax_params(state) -> dict:
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    return {k: v.numpy() for k, v in flax_params_to_state_dict(params).items()}


def _assert_params(got: dict, want: dict, rel: float = None, atol: float = None):
    for key, value in want.items():
        err = np.abs(got[key] - value).max()
        bound = atol if atol is not None else rel * np.abs(value).max() + 1e-12
        assert err <= bound, (key, err, bound)


@pytest.fixture(scope="module")
def exact_jax():
    return _jax_run(10)


@pytest.fixture(scope="module")
def wide_jax():
    return _jax_run(3, wide=True)


def test_zero2_matches_jax_and_the_replicated_step(world, wide_jax):
    losses, state3, initial = wide_jax
    weights, batch = _weights(initial), _port_batch()
    sharded = world.run(ranks.train_steps, dict(shard_weight_update=True),
                        weights, batch, 3, wide=True)
    replicated = world.run(ranks.train_steps, {}, weights, batch, 3, wide=True)
    head = sharded[0]
    assert head["regime"] == "zero2" and replicated[0]["regime"] == "replicated"
    for got, want in zip(head["losses"], losses):
        assert abs(got - want) <= LOSS_TOL * abs(want)
    _assert_params(head["params"], _jax_params(state3), rel=PARAM_TOL)
    _assert_params(head["params"], replicated[0]["params"], rel=1e-6)
    for r in sharded[1:]:
        for key, value in head["params"].items():
            np.testing.assert_array_equal(r["params"][key], value)
    # Adam's two moments exist for each rank's quarter of the leaves of
    # MIN_WEIGHT_SIZE elements or more (Dense_1.weight) only.
    sizes = [v.size for v in head["params"].values()]
    assert sum(n >= MIN_WEIGHT_SIZE for n in sizes) == 1
    assert head["opt_bytes"] == 8 * sum(n // N if n >= MIN_WEIGHT_SIZE else n for n in sizes)
    assert replicated[0]["opt_bytes"] == 8 * sum(sizes)


@pytest.mark.parametrize("quant", sorted(QUANT_TOLS))
def test_quantized_zero2_matches_jax(world, exact_jax, quant):
    loss_tol, param_tol = QUANT_TOLS[quant]
    exact_losses, exact_state, initial = exact_jax
    losses, state, _ = _jax_run(10, collective_quant=quant, collective_block=BLOCK)
    got = world.run(ranks.train_steps, dict(
        shard_weight_update=True, collective_quant=quant, collective_block=BLOCK),
        _weights(initial), _port_batch(), 10)
    head = got[0]
    assert head["regime"] == "quant_zero2" and head["collective"] == (quant, BLOCK)
    for want_losses, want_params in ((losses, _jax_params(state)),
                                     (exact_losses, _jax_params(exact_state))):
        assert abs(head["losses"][-1] - want_losses[-1]) < loss_tol
        _assert_params(head["params"], want_params, atol=param_tol)
    assert np.abs(head["residual"]["grad"]).max() > 0  # the residual is live
    for r in got[1:]:
        for key, value in head["params"].items():
            np.testing.assert_array_equal(r["params"][key], value)


@pytest.mark.parametrize("quant", ["int8", "fp8_e4m3"])
def test_checkpoint_roundtrip_of_the_residual(world, exact_jax, tmp_path, quant):
    kwargs = dict(shard_weight_update=True, collective_quant=quant, collective_block=BLOCK)
    got = world.run(ranks.resume, kwargs, _weights(exact_jax[2]), _port_batch(),
                    str(tmp_path), True)
    for r in got:
        assert r["step"] == 3
        assert {"collective_residual", "ema_names"} <= set(r["keys"])
        for key in ("grad", "update"):
            np.testing.assert_array_equal(r["residual_restored"][key],
                                          r["residual_saved"][key])
        for key, value in r["live"].items():
            np.testing.assert_array_equal(r["resumed"][key], value)
    shapes = {r["residual_saved"]["grad"].shape for r in got}
    assert len(shapes) == 1 and next(iter(shapes))[0] == 1


def test_zero2_checkpoint_is_the_replicated_layout(world, wide_jax, tmp_path):
    """zero2's checkpoint holds whole moments, so the replicated trainer
    resumes it (and zero2 resumes it bit for bit)."""
    got = world.run(ranks.resume, dict(shard_weight_update=True), _weights(wide_jax[2]),
                    _port_batch(), str(tmp_path), True, True)
    for key, value in got[0]["live"].items():
        np.testing.assert_array_equal(got[0]["resumed"][key], value)
    checkpoint = state_lib.load_checkpoint(str(tmp_path), 3)
    for key, value in checkpoint["params"].items():
        if key in checkpoint["ema_params"]:
            assert checkpoint["ema_params"][key].shape == value.shape
    moments = [entry["exp_avg"].shape for entry in checkpoint["optimizer"]["state"].values()]
    assert (ranks.WIDE[1], ranks.WIDE[0]) in moments


def test_ema_mirror_and_export(world, exact_jax):
    losses, state, _ = _jax_run(3, use_ema=True, collective_quant="int8",
                                collective_block=BLOCK)
    assert state.ema_params.ndim == 1
    jax_ema = jax_ema_as_tree(jax.device_get(state.ema_params), jax.device_get(state.params))
    want = {k: v.numpy() for k, v in flax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jax_ema)).items()}
    got = world.run(ranks.train_steps, dict(
        shard_weight_update=True, collective_quant="int8", collective_block=BLOCK),
        _weights(exact_jax[2]), _port_batch(), 3, use_ema=True)[0]
    assert set(got["ema"]) == set(want)
    _assert_params(got["ema"], want, atol=QUANT_TOLS["int8"][1])
    moved = max(np.abs(got["ema"][k] - got["params"][k]).max() for k in want)
    assert moved > 0


def test_local_batch_norms_averaged_over_the_data_ranks(world):
    """One step, so the statistics depend on the initial weights only:
    each rank's local moments, averaged over the ranks, as JAX's pmean."""
    losses, state, initial = _jax_run(1, use_batch_norm=True, collective_quant="fp16",
                                      collective_block=BLOCK)
    want = flax_variables_to_state_dict(
        {"batch_stats": jax.tree_util.tree_map(
            np.asarray, jax.device_get(state.variables["batch_stats"]))})
    got = world.run(ranks.train_steps, dict(
        shard_weight_update=True, collective_quant="fp16", collective_block=BLOCK),
        _weights(initial), _port_batch(), 1, use_batch_norm=True)
    stats = {k: v.numpy() for k, v in want.items()}
    _assert_params(got[0]["params"], stats, rel=1e-5)
    for r in got[1:]:
        for key in stats:
            np.testing.assert_array_equal(r["params"][key], got[0]["params"][key])
    moved = max(np.abs(got[0]["params"][k] - _weights(initial)[k]).max() for k in stats)
    assert moved > 0
    assert abs(got[0]["losses"][-1] - losses[-1]) < QUANT_TOLS["fp16"][0]


def test_env_flags_select_the_codec(world, exact_jax):
    got = world.run(ranks.train_steps, dict(shard_weight_update=True),
                    _weights(exact_jax[2]), _port_batch(), 1,
                    env={"T2R_COLLECTIVE_QUANT": "int8", "T2R_COLLECTIVE_BLOCK": "128"})
    assert got[0]["collective"] == ("int8", 128)
    assert got[0]["residual"] is not None


def test_refusals_and_inert_outside_zero2(world):
    """The flat update with shard_weight_update keeps JAX's ValueError;
    clipping by a global norm works in zero2 (its norm sums the slices
    over the data ranks: tests/test_torch_sharded_params.py holds it
    against optax) and is refused with a codec, as JAX refuses it there;
    a codec without shard_weight_update is inert."""
    out = world.run(ranks.refusals)[0]
    assert out["flat_with_zero2"].startswith("ValueError") and (
        "flatten_optimizer_update" in out["flat_with_zero2"])
    assert out["clipping_zero2"] == ""
    assert out["clipping_quant_zero2"].startswith("NotImplementedError") and (
        "unsupported with quantized collectives" in out["clipping_quant_zero2"])
    assert out["inert_regime"] == "replicated" and out["inert_record"] == {}


def test_grad_accum_composes(world, exact_jax):
    kwargs = dict(collective_quant="int8", collective_block=BLOCK, grad_accum_steps=2)
    losses, state, initial = _jax_run(2, **kwargs)
    got = world.run(ranks.train_steps, dict(shard_weight_update=True, **kwargs),
                    _weights(initial), _port_batch(), 2)[0]
    loss_tol, param_tol = QUANT_TOLS["int8"]
    assert abs(got["losses"][-1] - losses[-1]) < loss_tol
    _assert_params(got["params"], _jax_params(state), atol=param_tol)


def test_collective_log_record(world, exact_jax):
    weights, batch = _weights(exact_jax[2]), _port_batch()
    got = world.run(ranks.train_steps, dict(
        shard_weight_update=True, collective_quant="int8", collective_block=512),
        weights, batch, 1)[0]
    record = got["record"]
    assert set(record) == {"collective/bytes_pre", "collective/bytes_post",
                           "collective/compression"}
    assert record["collective/compression"] >= 3.5
    assert record["collective/bytes_post"] < record["collective/bytes_pre"]
    assert got["wall_ms"] > 0
    exact = world.run(ranks.train_steps, dict(shard_weight_update=True),
                      weights, batch, 1)[0]
    assert exact["record"] == {} and exact["wall_ms"] is None


def test_train_eval_model_in_int8_with_a_resume(world, tmp_path):
    env = {"T2R_COLLECTIVE_QUANT": "int8"}
    model_dir = str(tmp_path / "run")
    world.run(ranks.train_eval_run, model_dir, 30, env, dict(shard_weight_update=True))
    got = world.run(ranks.train_eval_run, model_dir, 60, env, dict(shard_weight_update=True))
    assert got[0]["final"]["accuracy"] > 0.7
    assert len({r["final"]["accuracy"] for r in got}) == 1
    assert state_lib.checkpoint_steps(model_dir) == [15, 30, 45, 60]
    checkpoint = state_lib.load_checkpoint(model_dir)
    assert checkpoint["collective_residual"]["grad"].shape[0] == N
    stream = read_metrics(str(tmp_path / "run" / "train"))
    assert [line["step"] for line in stream] == [15, 30, 45, 60]
    assert checkpoint["ema_params"].ndim == 1 and checkpoint["ema_names"]
    assert all(line["collective/compression"] > 3.5 and line["collective/wall_ms"] > 0
               for line in stream)
