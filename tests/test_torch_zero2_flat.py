"""Port parity: flatten_optimizer_update.

On one process: the mock classifier takes 3 steps with the optimizer on
one flat parameter vector (models/optimizers.FlatParameters; JAX's
optax.flatten) against the JAX CompiledModel's flatten_optimizer_update
step on the same weights and batch, loss 1e-5 rel and every parameter
within 1e-6 of the flat vector's max (the largest magnitude among them),
without batch norms (jax_flat says why); with them, one step's running
statistics, which the port updates in place, against JAX's fused update
(fuse_batch_stats_update, its default there) within 1e-6 of their max;
against the port's per-leaf step bit for bit (Adam is elementwise); the
flat EMA (decay 0.9) against JAX's unraveled one within 1e-6 of its max,
exported as a tree and through a checkpoint that CheckpointPredictor
serves; FlatParameters' views; and the refusals. About 15 s on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.train import train_eval as jax_train_eval
from tensor2robot_tpu.parallel import mesh as jax_mesh_lib
from tensor2robot_tpu.utils.mocks import (
    MockInputGenerator as JaxMockInput,
    MockT2RModel as JaxMock,
)
from tensor2robot_tpu_torch.models.optimizers import FlatParameters
from tensor2robot_tpu_torch.predictors import CheckpointPredictor
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train import train_eval
from tensor2robot_tpu_torch.utils.jax_params import (
    flax_params_to_state_dict,
    flax_variables_to_state_dict,
)
from tensor2robot_tpu_torch.utils.mocks import MockInputGenerator, MockT2RModel

TOL = 1e-6


def _jax(steps: int, use_batch_norm: bool, **kwargs):
    model = JaxMock(device_type="cpu", use_batch_norm=use_batch_norm,
                    use_avg_model_params=True, avg_model_params_decay=0.9)
    generator = JaxMockInput(batch_size=8, seed=0)
    generator.set_specification_from_model(model, "train")
    batch = next(iter(generator.create_dataset("train")))
    compiled = jax_train_eval.CompiledModel(
        model, mesh=jax_mesh_lib.make_mesh(data=1, devices=jax.devices()[:1]),
        donate_state=False, **kwargs)
    state = compiled.init_state(jax.random.PRNGKey(0), batch)
    initial = {k: v.numpy() for k, v in flax_variables_to_state_dict(
        compiled.export_variables(state)).items()}
    losses = []
    for _ in range(steps):
        state, metrics = compiled.train_step(state, compiled.shard_batch(batch),
                                             jax.random.PRNGKey(7))
        losses.append(float(metrics["loss"]))
    variables = jax.tree_util.tree_map(np.asarray, compiled.export_variables(state))
    final = {k: v.numpy() for k, v in flax_variables_to_state_dict(variables).items()}
    ema = jax.tree_util.tree_map(
        np.asarray, compiled.export_variables(state, use_ema=True)["params"])
    ema = {k: v.numpy() for k, v in flax_params_to_state_dict(ema).items()}
    batch = {"features/x": np.asarray(batch["features"]["x"]),
             "labels/a_target": np.asarray(batch["labels"]["a_target"])}
    return dict(losses=losses, initial=initial, final=final, ema=ema, batch=batch,
                flat_ema=np.asarray(state.ema_params))


@pytest.fixture(scope="module")
def jax_flat():
    """3 flat steps without batch norms: behind a norm, Dense_0's bias has
    a gradient of rounding noise only, which Adam scales up to +-lr, so
    no two implementations agree on it."""
    return _jax(3, False, flatten_optimizer_update=True)


@pytest.fixture(scope="module")
def jax_flat_norms():
    """One flat step with batch norms, whose statistics JAX updates in
    one fused pass: the statistics of one step depend on the initial
    weights only."""
    return _jax(1, True, flatten_optimizer_update=True)


def _port(weights, batch, steps, **kwargs):
    model = MockT2RModel(device_type="cpu", use_avg_model_params=True,
                         avg_model_params_decay=0.9,
                         use_batch_norm=any(k.startswith("BatchNorm") for k in weights))
    trainer = train_eval.Trainer(model, device="cpu", **kwargs)
    state = trainer.init_state(params={k: torch.from_numpy(v) for k, v in weights.items()})
    device_batch = TensorSpecStruct({k: torch.from_numpy(v) for k, v in batch.items()})
    losses = [float(trainer.train_step(state, device_batch)["loss"]) for _ in range(steps)]
    return trainer, state, losses


def _close(got, want, tol=TOL):
    """Every entry of `want` within tol of the largest magnitude among
    them all (optax.flatten's one vector's max)."""
    scale = max(float(np.abs(value).max()) for value in want.values())
    for key, value in want.items():
        got_value = got[key].detach().numpy() if isinstance(got[key], torch.Tensor) else got[key]
        err = np.abs(got_value - value).max()
        assert err <= tol * scale, (key, err, scale)


def test_flat_update_matches_optax_flatten(jax_flat):
    trainer, state, losses = _port(jax_flat["initial"], jax_flat["batch"], 3,
                                   flatten_optimizer_update=True)
    assert isinstance(state.ema_params, torch.Tensor) and state.ema_params.ndim == 1
    for got, want in zip(losses, jax_flat["losses"]):
        assert abs(got - want) <= 1e-5 * abs(want)
    _close(state.network.state_dict(), jax_flat["final"])
    # One flat vector: every parameter is a view of the optimizer's one.
    flat = state.weight_update.flat.flat
    assert [len(g["params"]) for g in state.optimizer.param_groups] == [1]
    assert all(p.data_ptr() >= flat.data_ptr() for p in state.network.parameters())


def test_flat_update_statistics_match_jax_fused_update(jax_flat_norms):
    _, state, losses = _port(jax_flat_norms["initial"], jax_flat_norms["batch"], 1,
                             flatten_optimizer_update=True)
    assert abs(losses[0] - jax_flat_norms["losses"][0]) <= 1e-5 * abs(losses[0])
    stats = {k: v for k, v in jax_flat_norms["final"].items() if k.endswith((".mean", ".var"))}
    _close(state.network.state_dict(), stats)


def test_flat_update_equals_the_per_leaf_step(jax_flat_norms):
    weights, batch = jax_flat_norms["initial"], jax_flat_norms["batch"]
    _, flat_state, flat_losses = _port(weights, batch, 3, flatten_optimizer_update=True)
    _, leaf_state, leaf_losses = _port(weights, batch, 3)
    assert flat_losses == leaf_losses
    moved = 0.0
    for key, value in leaf_state.network.state_dict().items():
        got = flat_state.network.state_dict()[key]
        assert torch.equal(got, value), key
        moved = max(moved, float((got - torch.from_numpy(weights[key])).abs().max()))
    assert moved > 0


def test_flat_parameters_are_views_of_one_vector():
    """A write into a parameter lands in the flat vector, a step of the
    flat vector moves the parameters, and gather_grad ravels the
    gradients in order with zeros where a parameter has none."""
    network = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.Linear(2, 1))
    flat = FlatParameters(network)
    assert flat.names == ["0.weight", "0.bias", "1.weight", "1.bias"]
    assert flat.flat.numel() == 6 + 2 + 2 + 1
    network.load_state_dict({k: torch.full_like(v, 2.0)
                             for k, v in network.state_dict().items()})
    assert torch.equal(flat.flat.detach(), torch.full((11,), 2.0))
    network(torch.ones(1, 3)).sum().backward()
    network[1].bias.grad = None
    flat.gather_grad()
    want = torch.cat([network[0].weight.grad.reshape(-1), network[0].bias.grad,
                      network[1].weight.grad.reshape(-1), torch.zeros(1)])
    assert torch.equal(flat.flat.grad, want)
    with torch.no_grad():
        flat.flat.sub_(flat.flat.grad)
    assert torch.equal(network[0].bias.detach(), 2.0 - want[6:8])


def test_flat_ema_exports_as_a_tree(jax_flat, tmp_path):
    trainer, state, _ = _port(jax_flat["initial"], jax_flat["batch"], 3,
                              flatten_optimizer_update=True)
    exported = state.export_state_dict(use_ema=True)
    _close(exported, jax_flat["ema"])
    restitched = torch.cat([exported[name].reshape(-1)
                            for name, _ in state.network.named_parameters()])
    assert torch.equal(restitched, state.ema_params)
    # Through a checkpoint: the flat EMA with its ema_names, served as a tree.
    saved = trainer.checkpoint_state(state)
    state_lib.save_checkpoint(str(tmp_path), 3, saved["params"], saved["ema_params"],
                              saved["optimizer"], ema_names=saved["ema_names"])
    checkpoint = state_lib.load_checkpoint(str(tmp_path), 3)
    assert checkpoint["ema_params"].ndim == 1
    _close(state_lib.checkpoint_ema(checkpoint), jax_flat["ema"])
    predictor = CheckpointPredictor(MockT2RModel(device_type="cpu", use_batch_norm=False,
                                                 use_avg_model_params=True),
                                    checkpoint_dir=str(tmp_path), device="cpu")
    assert predictor.restore()
    served = predictor._network.state_dict()
    _close(served, jax_flat["ema"])
    # A resume into the flat regime takes the flat EMA back as it was.
    fresh = trainer.init_state()
    fresh.restore(checkpoint)
    assert torch.equal(fresh.ema_params, state.ema_params)


def test_train_eval_model_with_the_flat_update(tmp_path):
    final = train_eval.train_eval_model(
        MockT2RModel(device_type="cpu", use_avg_model_params=True, avg_model_params_decay=0.9),
        MockInputGenerator(batch_size=32), MockInputGenerator(batch_size=64, seed=9),
        model_dir=str(tmp_path), max_train_steps=100, save_checkpoints_steps=50,
        eval_steps=2, log_every_steps=50, device="cpu", flatten_optimizer_update=True)
    assert final["accuracy"] > 0.8
    assert state_lib.checkpoint_steps(str(tmp_path)) == [50, 100]


def test_refusals():
    model = MockT2RModel(device_type="cpu")
    with pytest.raises(ValueError, match="flatten_optimizer_update"):
        train_eval.Trainer(model, device="cpu", shard_weight_update=True,
                           flatten_optimizer_update=True)
    # Flat parameters hold one dtype.
    mixed = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.Linear(2, 2).double())
    with pytest.raises(ValueError, match="one dtype"):
        FlatParameters(mixed)
