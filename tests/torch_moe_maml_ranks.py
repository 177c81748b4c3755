"""The rank side of the expert x sequence and sharded-MAML parity tests
(tests/test_torch_moe_sequence.py, tests/test_torch_maml_sharded.py).

Each function runs on every rank of a LocalWorld of 4 gloo processes on
the CPU and returns numpy arrays for the test to hold against the JAX
package. No JAX here: spawned ranks import this.

A mesh is named by its sizes in the mesh's dim order, (data, fsdp, model,
sequence, pipe, expert).
"""

import contextlib
import types

import numpy as np
import torch

from tensor2robot_tpu_torch.layers import moe as moe_layers
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.parallel import sharded_params
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.train import train_eval
from tests import torch_parallel_ranks

_MESHES = {}


def mesh(shape):
    """This rank's mesh of `shape`, made once per rank process."""
    shape = tuple(shape)
    if shape not in _MESHES:
        _MESHES[shape] = mesh_lib.make_mesh(**dict(zip(mesh_lib.AXES, shape)))
    return _MESHES[shape]


def _struct(batch: dict):
    return TensorSpecStruct({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})


@contextlib.contextmanager
def slicing_moe_gather():
    """The MoE control: the block's gather of the sequence shards takes
    this rank's slice of the cotangent in its backward (gather_from)
    instead of summing the sequence ranks' cotangents (all_gather's
    psum_scatter)."""
    saved = moe_layers.collectives
    moe_layers.collectives = types.SimpleNamespace(all_gather=collectives.gather_from,
                                                   axis_index=collectives.axis_index)
    try:
        yield
    finally:
        moe_layers.collectives = saved


@contextlib.contextmanager
def unreduced_over_fsdp():
    """The sharded-MAML control: a leaf cut over fsdp is gathered whole with
    a backward that keeps this rank's slice of its cotangent, so its
    gradient misses the other fsdp ranks' tasks."""
    saved = collectives.all_gather
    collectives.all_gather = collectives.gather_from
    try:
        yield
    finally:
        collectives.all_gather = saved


def moe_sequence_step(shape, model_kwargs: dict, weights: dict, batch: dict,
                      control: bool = False) -> dict:
    """One MoE BC backward on the mesh `shape` (built with the model's
    sequence_parallel_mode) from `weights` on this rank's shard of
    `batch`, the gradients averaged by the trainer's bucket; with
    `control`, slicing_moe_gather in force. Returns the loss, the aux loss,
    every gradient and the step's flash launches (the kernels' plain
    versions counted as the kernels would be)."""
    from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel

    torch_parallel_ranks._count_plain_versions()
    m = mesh(shape)
    model = TransformerBCModel(device_type="cpu", mesh=m, **model_kwargs)
    trainer = train_eval.Trainer(model, device="cpu", mesh=m)
    network = trainer.init_state(
        params={k: torch.from_numpy(v) for k, v in weights.items()}).network
    features, labels = trainer.preprocess_train(_struct(mesh_lib.shard_batch(batch, m)))
    network.train()
    torch_parallel_ranks._reset_launches()
    with slicing_moe_gather() if control else contextlib.nullcontext():
        loss, metrics = trainer.backward(network, features, labels)
    launches = torch_parallel_ranks._launches()
    loss, metrics = trainer.average_over_ranks(network, loss, metrics)
    return dict(loss=float(loss), aux=float(metrics["loss/moe_aux"]), launches=launches,
                grads={n: p.grad.numpy().copy() for n, p in network.named_parameters()})


def maml_model(family: str, second_order: bool = True, mesh=None, **base_kwargs):
    """The port's MAML model of `family`: "pose" (PoseEnvRegressionModelMAML,
    its base built with `mesh`: its loss's sums span the shards) or
    "vrgripper" (VRGripperEnvRegressionModelMAML over the regression base
    with `base_kwargs`), float32 on the CPU."""
    if family == "pose":
        from tensor2robot_tpu_torch.research.pose_env import (
            PoseEnvRegressionModel,
            PoseEnvRegressionModelMAML,
        )

        return PoseEnvRegressionModelMAML(
            base_model=PoseEnvRegressionModel(device_type="cpu", mesh=mesh),
            device_type="cpu", num_inner_loop_steps=1, use_second_order=second_order)
    from tensor2robot_tpu_torch.research import vrgripper

    base = vrgripper.VRGripperRegressionModel(device_type="cpu", **base_kwargs)
    return vrgripper.VRGripperEnvRegressionModelMAML(
        base_model=base, num_inner_loop_steps=1, inner_learning_rate=0.05,
        use_second_order=second_order)


def maml_step(shape, family: str, second_order: bool, base_kwargs: dict, weights: dict,
              batch: dict, min_size: int, control: bool = False) -> dict:
    """One MAML outer backward on the mesh `shape` in the trainer's
    regime, leaves of `min_size` elements or more sharded, from `weights`
    on this rank's task shard of `batch`, reduced as a step reduces it
    (unreduced_over_fsdp in force with `control`).
    Returns the regime, the layout, the loss, every gradient gathered
    whole, this rank's parameter and Adam-moment bytes (moments as the
    optimizer's first step makes them), and the stepped checkpoint_state:
    its parameters' shapes and whether each sharded one cuts back to this
    rank's shard."""
    m = mesh(shape)
    if family == "pose":
        base_kwargs = dict(base_kwargs, mesh=m)
    trainer = train_eval.Trainer(maml_model(family, second_order, **base_kwargs),
                                 device="cpu", mesh=m, param_min_shard_size=min_size)
    state = trainer.init_state(params={k: torch.from_numpy(v) for k, v in weights.items()})
    features, labels = trainer.preprocess_train(_struct(mesh_lib.shard_batch(batch, m)))
    with unreduced_over_fsdp() if control else contextlib.nullcontext():
        loss, metrics = trainer.backward(state.network, features, labels)
    loss, _ = trainer.reduce_gradients(state, loss, metrics)
    grads = sharded_params.full_grads(state.network, trainer.param_layout, m)
    state.optimizer.step()
    params = sum(p.numel() * p.element_size() for p in state.network.parameters())
    moments = sum(t.numel() * t.element_size()
                  for entry in state.optimizer.state_dict()["state"].values()
                  for t in entry.values() if t.ndim)
    saved = trainer.checkpoint_state(state)["params"]
    shards = dict(state.network.named_parameters())
    recut = {name: torch.equal(sharded_params.local_tensor(saved[name], dims, m), shards[name])
             for name, dims in trainer.param_layout.items()}
    return dict(regime=trainer.regime, layout=dict(trainer.param_layout), loss=float(loss),
                grads={n: g.numpy().copy() for n, g in grads.items()},
                param_bytes=params, opt_bytes=moments, recut=recut,
                saved_shapes={n: tuple(t.shape) for n, t in saved.items()})


def maml_bf16_step(shape, weights: dict, batch: dict, min_size: int) -> dict:
    """Pose MAML under the bf16 wrapper (device_type "tpu": the forward's
    conv and dense casts as a torch function mode) in the sharded_params
    regime on the mesh `shape`, and (every rank alone) on one device from
    the same weights: each outer step's loss and gradients (gathered
    whole on the mesh)."""
    from tensor2robot_tpu_torch.research.pose_env import (
        PoseEnvRegressionModel,
        PoseEnvRegressionModelMAML,
    )

    def model(m=None):
        return train_eval.maybe_wrap_for_tpu(PoseEnvRegressionModelMAML(
            base_model=PoseEnvRegressionModel(device_type="tpu", mesh=m),
            num_inner_loop_steps=1))

    out = {}
    m = mesh(shape)
    for name, trainer in (("mesh", train_eval.Trainer(model(m), device="cpu", mesh=m,
                                                      param_min_shard_size=min_size)),
                          ("one", train_eval.Trainer(model(), device="cpu"))):
        state = trainer.init_state(params={k: torch.from_numpy(v) for k, v in weights.items()})
        part = batch if name == "one" else mesh_lib.shard_batch(batch, m)
        features, labels = trainer.preprocess_train(_struct(part))
        loss, metrics = trainer.backward(state.network, features, labels)
        if name == "mesh":
            loss, _ = trainer.reduce_gradients(state, loss, metrics)
            grads = sharded_params.full_grads(state.network, trainer.param_layout, m)
        else:
            grads = {n: p.grad for n, p in state.network.named_parameters()}
        out[name] = dict(loss=float(loss), layout=dict(trainer.param_layout),
                         grads={n: g.numpy().copy() for n, g in grads.items()})
    return out


def decode_steps(shape, encoder_kwargs: dict, state: dict, x: np.ndarray) -> np.ndarray:
    """A decode-mode encoder built on the mesh `shape` (a sequence dim of
    1) stepped over this rank's rows of x [B, T, F] one step at a time
    from a zeroed cache: a data dim's rank decodes its batch shard, an
    expert dim's ranks decode the same rows (their MoE splits the
    experts). Returns the rank's [b, T, F] outputs."""
    from tensor2robot_tpu_torch.layers import transformer

    m = mesh(shape)
    encoder = transformer.TransformerEncoder(mesh=m, decode=True, **encoder_kwargs)
    encoder.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    rows = mesh_lib.shard_batch({"x": x}, m)["x"]
    cache = {}
    encoder.init_cache(rows.shape[0], transformer.DecodeCache(cache), torch.float32,
                       torch.device("cpu"))
    outs = []
    with torch.no_grad():
        for t in range(rows.shape[1]):
            step = transformer.DecodeCache(dict(cache))
            y, _ = encoder(torch.from_numpy(np.ascontiguousarray(rows[:, t:t + 1])), step)
            cache = step.tensors
            outs.append(y.numpy())
    return np.concatenate(outs, axis=1)


def predict_over_a_mesh(shape, model_kwargs: dict, model_dir: str, batch_size: int):
    """predict_from_model of BC built on the mesh `shape` with that mesh,
    on every rank: the first batch's outputs as numpy."""
    from tensor2robot_tpu_torch.data.input_generators import DefaultRandomInputGenerator
    from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel

    m = mesh(shape)
    model = TransformerBCModel(device_type="cpu", mesh=m, **model_kwargs)
    outputs = next(iter(train_eval.predict_from_model(
        model, DefaultRandomInputGenerator(batch_size=batch_size, seed=5), model_dir,
        mesh=m, device="cpu")))
    return dict(outputs.items())
