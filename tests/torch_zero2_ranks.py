"""The rank side of the ZeRO-2 parity tests (tests/test_torch_zero2_*.py).

Each function runs on every rank of a LocalWorld of 4 gloo processes on
the CPU (a 4-rank data mesh) and returns numpy arrays for the test to
hold against the JAX package. No JAX here: spawned ranks import this.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train import train_eval
from tensor2robot_tpu_torch.utils.mocks import MockInputGenerator, MockT2RModel

DATA = mesh_lib.DATA_AXIS
_MESHES = {}
# The wide mock's hidden widths: its middle kernel, 128 x 256 = 2^15
# elements, is over mesh.MIN_WEIGHT_SIZE, so zero2 shards it. Every leaf
# of the plain mock is under the threshold and stays replicated.
WIDE = (128, 256)


class _WideNetwork(nn.Module):
    """The mock's network (utils/mocks.py) at the hidden widths WIDE,
    without batch norms."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(3, WIDE[0])
        self.Dense_1 = nn.Linear(*WIDE)
        self.Dense_2 = nn.Linear(WIDE[1], 1)

    def forward(self, features, mode: str):
        x = F.relu(self.Dense_1(F.relu(self.Dense_0(features["x"].float()))))
        return {"a_predicted": self.Dense_2(x)}


class WideMock(MockT2RModel):
    """The mock classifier at the hidden widths WIDE, without batch norms."""

    def create_network(self):
        return _WideNetwork()


def data_mesh():
    """This rank's 4-way data mesh, made once per rank process."""
    if "data" not in _MESHES:
        _MESHES["data"] = mesh_lib.make_mesh(data=4)
    return _MESHES["data"]


def codec_collectives(name: str, block: int, rows: np.ndarray, shards: np.ndarray) -> dict:
    """The codec's reduce_scatter of rows[rank] ([N, L]) and all_gather_shard
    of shards[rank] ([L]) over the data dim."""
    mesh = data_mesh()
    me = collectives.axis_index(mesh, DATA)
    coll = collectives.get_collective(name, block)
    reduced, sent = coll.reduce_scatter(torch.from_numpy(rows[me]), mesh, DATA)
    full, sent_shard = coll.all_gather_shard(torch.from_numpy(shards[me]), mesh, DATA)
    return dict(reduced=reduced.numpy(), sent=sent.numpy(), full=full.numpy(),
                sent_shard=sent_shard.numpy())


def _trainer(kwargs: dict, use_batch_norm: bool, use_ema: bool, wide: bool = False):
    model = (WideMock if wide else MockT2RModel)(
        device_type="cpu", use_batch_norm=use_batch_norm,
        use_avg_model_params=use_ema, avg_model_params_decay=0.9)
    return train_eval.Trainer(model, device="cpu", mesh=data_mesh(), **kwargs)


def _host(batch: dict):
    out = TensorSpecStruct()
    for key, value in batch.items():
        out[key] = torch.from_numpy(np.asarray(value))
    return out


def _numpy(tensors):
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


def train_steps(kwargs: dict, weights: dict, batch: dict, steps: int,
                use_batch_norm: bool = False, use_ema: bool = False,
                env: dict = None, wide: bool = False) -> dict:
    """`steps` train steps of the mock (the wide one with `wide`) from
    `weights` on this rank's shard of `batch` under the Trainer kwargs
    (and the environment `env`).
    Returns each step's loss, the final state dict, the gathered EMA as a
    tree, the regime, its layout's bytes a rank, the optimizer's state
    bytes on this rank and the residuals."""
    saved_env = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        trainer = _trainer(kwargs, use_batch_norm, use_ema, wide)
    finally:
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    state = trainer.init_state(params={k: torch.from_numpy(v) for k, v in weights.items()})
    local = mesh_lib.shard_batch(_host(batch), data_mesh(),
                                 microbatches=trainer.grad_accum_steps)
    losses, metrics = [], None
    for _ in range(steps):
        metrics = trainer.train_step(state, local)
        losses.append(float(metrics["loss"]))
    saved = trainer.checkpoint_state(state)
    opt_bytes = sum(t.numel() * t.element_size()
                    for entry in state.optimizer.state_dict()["state"].values()
                    for t in entry.values() if t.ndim)
    residual = state.collective_residual
    return dict(
        losses=losses, params=_numpy(saved["params"]), regime=trainer.regime,
        collective=None if trainer.collective is None else (
            trainer.collective.name, trainer.collective.block),
        ema=None if saved["ema_params"] is None else _numpy(state_lib.checkpoint_ema(saved)),
        opt_bytes=opt_bytes,
        residual=None if residual is None else _numpy(residual),
        accuracy=float(metrics["accuracy"]) if "accuracy" in metrics else None,
        record=trainer.collective_log_record(measure=False),
        wall_ms=(trainer.measure_collective_ms(repeats=2)
                 if trainer.collective is not None else None))


def resume(kwargs: dict, weights: dict, batch: dict, model_dir: str,
           use_ema: bool = False, wide: bool = False) -> dict:
    """3 steps of the mock (the wide one with `wide`), a checkpoint written by rank 0 (the trainer's
    checkpoint_state), a fresh trainer restoring it, 3 more steps; and 6
    steps uninterrupted from the same weights. Returns both final states,
    the residual before the save and after the restore, and the keys of
    the file."""
    local = mesh_lib.shard_batch(_host(batch), data_mesh())
    trainer = _trainer(kwargs, False, use_ema, wide)
    start = {k: torch.from_numpy(v) for k, v in weights.items()}
    state = trainer.init_state(params=start)
    for _ in range(3):
        trainer.train_step(state, local)
    saved = trainer.checkpoint_state(state)
    if dist.get_rank() == 0:
        state_lib.save_checkpoint(model_dir, 3, saved["params"], saved["ema_params"],
                                  saved["optimizer"], ema_names=saved.get("ema_names"),
                                  collective_residual=saved.get("collective_residual"))
    dist.barrier()
    residual_saved = None if state.collective_residual is None else _numpy(
        state.collective_residual)
    fresh = _trainer(kwargs, False, use_ema, wide)
    restored = train_eval.restore_or_init_state(model_dir, fresh)
    restored_step = restored.step
    residual_restored = None if restored.collective_residual is None else _numpy(
        restored.collective_residual)
    for _ in range(3):
        trainer.train_step(state, local)
        fresh.train_step(restored, local)
    keys = sorted(state_lib.load_checkpoint(model_dir, 3))
    return dict(step=restored_step, keys=keys,
                live=_numpy(state.network.state_dict()),
                resumed=_numpy(restored.network.state_dict()),
                residual_saved=residual_saved, residual_restored=residual_restored)


def train_eval_run(model_dir: str, steps: int, env: dict, kwargs: dict) -> dict:
    """train_eval_model of the mock on the data mesh, the environment
    `env` set; returns the final eval and this rank's regime."""
    os.environ.update(env)
    try:
        final = train_eval.train_eval_model(
            MockT2RModel(device_type="cpu", use_batch_norm=False,
                         use_avg_model_params=True, avg_model_params_decay=0.9),
            MockInputGenerator(batch_size=16), MockInputGenerator(batch_size=16, seed=5),
            model_dir=model_dir, max_train_steps=steps, eval_steps=2,
            save_checkpoints_steps=15, log_every_steps=15,
            device="cpu", mesh=data_mesh(), **kwargs)
    finally:
        for key in env:
            os.environ.pop(key, None)
    return dict(final=final)


def refusals() -> dict:
    """What stays refused, works or is inert on the data mesh: the flat
    update with shard_weight_update, clipping by a global norm in zero2
    (works) and in quant_zero2 (refused), and a codec without
    shard_weight_update (inert)."""
    from tensor2robot_tpu_torch.models import optimizers

    def clipped(**kwargs):
        return train_eval.Trainer(
            MockT2RModel(device_type="cpu", create_optimizer_fn=lambda: (
                optimizers.with_gradient_clipping(optimizers.create_adam_optimizer(), 1.0))),
            device="cpu", mesh=data_mesh(), shard_weight_update=True, **kwargs).init_state()

    cases = {
        "flat_with_zero2": lambda: _trainer(dict(
            shard_weight_update=True, flatten_optimizer_update=True), False, False),
        "clipping_zero2": clipped,
        "clipping_quant_zero2": lambda: clipped(collective_quant="int8"),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = ""
        except (NotImplementedError, ValueError) as err:
            out[name] = f"{type(err).__name__}: {err}"
    inert = _trainer(dict(collective_quant="int8"), False, False)
    out["inert_regime"] = inert.regime
    out["inert_record"] = inert.collective_log_record()
    return out
