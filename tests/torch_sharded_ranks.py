"""The rank side of the parameter-sharding parity tests
(tests/test_torch_sharded_params.py).

Each function runs on every rank of a LocalWorld of 4 gloo processes on
the CPU and returns numpy arrays for the test to hold against the JAX
package. No JAX here: spawned ranks import this.
"""

import numpy as np
import torch
import torch.distributed as dist

from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.parallel import sharded_params
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train import train_eval

_MESHES = {}
# BC at the sizes of the refusal cases.
TINY = dict(episode_length=16, image_size=(16, 16), d_model=32, num_layers=2,
            num_heads=4, head_dim=8)


def mesh(shape=(1, 2, 2), pipe: int = 1):
    """This rank's data x fsdp x model mesh (x pipe), made once per rank
    process."""
    key = (tuple(shape), pipe)
    if key not in _MESHES:
        data, fsdp, model = shape
        _MESHES[key] = mesh_lib.make_mesh(data=data, fsdp=fsdp, model=model, pipe=pipe)
    return _MESHES[key]


def _numpy(tensors: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


def _struct(batch: dict):
    return TensorSpecStruct({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})


def bc_model(model_kwargs: dict, clip=None, pipe_mesh=None, use_ema: bool = False):
    """Small BC on the CPU (the kernels' plain versions), Adam, clipped to
    global norm `clip` when given; pipelined over `pipe_mesh`'s pipe dim
    when given."""
    from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel

    create = None
    if clip is not None:
        create = lambda: optimizers.with_gradient_clipping(  # noqa: E731
            optimizers.create_adam_optimizer(), max_global_norm=clip)
    extra = {} if pipe_mesh is None else dict(mesh=pipe_mesh, pipeline_stages=2)
    return TransformerBCModel(device_type="cpu", create_optimizer_fn=create,
                              use_avg_model_params=use_ema, avg_model_params_decay=0.9,
                              **extra, **model_kwargs)


def _moments(trainer, state) -> dict:
    """{name: (exp_avg, exp_avg_sq)} gathered whole (checkpoint_state, a
    collective)."""
    saved = trainer.checkpoint_state(state)
    names = [n for n, _ in state.network.named_parameters()]
    return saved, {names[i]: (e["exp_avg"].numpy().copy(), e["exp_avg_sq"].numpy().copy())
                   for i, e in saved["optimizer"]["state"].items()}


WIDE_FEATURES = 7


class _WideNetwork(torch.nn.Module):
    """Dense(4096) -> relu -> Dense(1) on a 7-vector: the first kernel,
    flax [7, 4096], reaches mesh.MIN_WEIGHT_SIZE, and on fsdp x model it
    is cut over model alone (fsdp divides none of its other dims)."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(WIDE_FEATURES, 4096)
        self.Dense_1 = torch.nn.Linear(4096, 1)

    def forward(self, features, mode: str):
        x = torch.relu(self.Dense_0(features["x"].float()))
        return {"a_predicted": self.Dense_1(x)}



def wide_model():
    """The mock classifier on _WideNetwork (tests/test_torch_sharded_params.py
    has its JAX twin)."""
    from tensor2robot_tpu_torch.specs import ExtendedTensorSpec
    from tensor2robot_tpu_torch.utils.mocks import MockT2RModel

    class WideMock(MockT2RModel):
        def create_network(self):
            return _WideNetwork()

        def get_feature_specification(self, mode):
            return TensorSpecStruct(x=ExtendedTensorSpec(
                shape=(WIDE_FEATURES,), dtype=np.float32, name="measured_position"))

    return WideMock(device_type="cpu")


def wide_step(shape, weights: dict, batch: dict) -> dict:
    """bc_step's step of the wide mock classifier."""
    return _step(wide_model(), shape, weights, batch)


def bc_step(shape, model_kwargs: dict, weights: dict, batch: dict, control: bool = False,
            clip=None, kwargs=None) -> dict:
    """One train step of small BC on the data x fsdp x model mesh `shape`
    from `weights` on this rank's shard of `batch`. `control` swaps the
    output gather's backward for all_gather's (psum_scatter: the model
    ranks' equal cotangents summed). Returns the loss, the regime, the
    gathered parameters and Adam moments after the step, this rank's
    parameter and moment bytes, the layout and the clip factor."""
    return _step(bc_model(model_kwargs, clip), shape, weights, batch, control, kwargs)


def _step(model, shape, weights: dict, batch: dict, control: bool = False,
          kwargs=None) -> dict:
    m = mesh(shape)
    trainer = train_eval.Trainer(model, device="cpu", mesh=m, **(kwargs or {}))
    state = trainer.init_state(params={k: torch.from_numpy(v) for k, v in weights.items()})
    saved_gather = collectives._GatherFrom
    if control:
        collectives._GatherFrom = collectives._AllGather
    try:
        metrics = trainer.train_step(state, _struct(mesh_lib.shard_batch(batch, m)))
    finally:
        collectives._GatherFrom = saved_gather
    saved, moments = _moments(trainer, state)
    opt_bytes = sum(t.numel() * t.element_size()
                    for entry in state.optimizer.state_dict()["state"].values()
                    for t in entry.values() if t.ndim)
    scale = state.optimizer.clip_scale
    return dict(loss=float(metrics["loss"]), regime=trainer.regime,
                params=_numpy(saved["params"]), moments=moments,
                param_bytes=sum(p.numel() * p.element_size()
                                for p in state.network.parameters()),
                opt_bytes=opt_bytes, layout=dict(trainer.param_layout),
                clip_scale=None if scale is None else float(scale))


def pipe_clip_step(model_kwargs: dict, weights: dict, batch: dict, clip: float) -> dict:
    """One clipped step of small BC pipelined over 2 data x 2 pipe from the
    chain `weights`: the loss, the clip factor and the parameters after
    the step as the chain (the checkpoint's stages unstacked)."""
    from tensor2robot_tpu_torch.parallel import pipeline as pipeline_lib

    m = mesh((2, 1, 1), pipe=2)
    trainer = train_eval.Trainer(bc_model(model_kwargs, clip, pipe_mesh=m), device="cpu",
                                 mesh=m)
    state = trainer.init_state(params={k: torch.from_numpy(v) for k, v in weights.items()})
    metrics = trainer.train_step(state, _struct(mesh_lib.shard_batch(batch, m)))
    saved = trainer.checkpoint_state(state, optimizer=False)
    return dict(loss=float(metrics["loss"]), regime=trainer.regime,
                clip_scale=float(state.optimizer.clip_scale),
                params=_numpy(pipeline_lib.unstack_stages(saved["params"])))


def resume_elsewhere(model_kwargs: dict, weights: dict, batch: dict, model_dir: str) -> dict:
    """Two steps with an EMA on 1 x 2 fsdp x 2 model, the checkpoint rank 0
    writes (the replicated layout), and that checkpoint restored on
    2 data x 2 fsdp: the gathered restored state (parameters, moments,
    EMA) and the written one, for the test to hold bit for bit."""
    from tensor2robot_tpu_torch.train import durability

    m = mesh((1, 2, 2))
    trainer = train_eval.Trainer(bc_model(model_kwargs, use_ema=True), device="cpu", mesh=m)
    state = trainer.init_state(params={k: torch.from_numpy(v) for k, v in weights.items()})
    local = _struct(mesh_lib.shard_batch(batch, m))
    for _ in range(2):
        trainer.train_step(state, local)
    saved = trainer.checkpoint_state(state)
    if dist.get_rank() == 0:
        state_lib.save_checkpoint(model_dir, saved["step"], saved["params"],
                                  saved["ema_params"], saved["optimizer"])
        durability.publish_durable(model_dir, saved["step"])
    dist.barrier()
    other = mesh((2, 2, 1))
    fresh = train_eval.Trainer(bc_model(model_kwargs, use_ema=True), device="cpu", mesh=other)
    restored = train_eval.restore_or_init_state(model_dir, fresh)
    again, moments = _moments(fresh, restored)
    return dict(step=restored.step, layout=dict(fresh.param_layout),
                params=_numpy(again["params"]), ema=_numpy(again["ema_params"]),
                moments=moments,
                shard_shapes={n: tuple(p.shape) for n, p in restored.network.named_parameters()})


def refusals() -> dict:
    """What the sharded and composed meshes refuse, each as "<type>:
    <message>" ("" when nothing was raised), and what they resolve."""
    from tensor2robot_tpu_torch.layers.transformer import TransformerEncoder
    from tensor2robot_tpu_torch.utils.mocks import MockT2RModel

    fsdp_model = mesh((1, 2, 2))
    data = mesh((4, 1, 1))
    fsdp_pipe = mesh((1, 2, 1), pipe=2)

    def clipped_mock():
        return MockT2RModel(device_type="cpu", create_optimizer_fn=lambda: (
            optimizers.with_gradient_clipping(optimizers.create_adam_optimizer(), 1.0)))

    trainers = {}

    def build(name, **kwargs):
        trainers[name] = train_eval.Trainer(**kwargs)
        return trainers[name]

    cases = {
        "clipping_quant_zero2": lambda: train_eval.Trainer(
            clipped_mock(), device="cpu", mesh=data, shard_weight_update=True,
            collective_quant="int8").init_state(),
        "flat_on_fsdp": lambda: train_eval.Trainer(
            MockT2RModel(device_type="cpu"), device="cpu", mesh=fsdp_model,
            flatten_optimizer_update=True),
        "sharded_params_with_pipe": lambda: TransformerEncoder(
            32, 2, 4, 8, mesh=fsdp_pipe, pipeline_stages=2),
        "trainer_on_fsdp_x_pipe": lambda: build(
            "trainer_on_fsdp_x_pipe", model=bc_model(TINY, pipe_mesh=fsdp_pipe),
            device="cpu", mesh=fsdp_pipe),
        "zero2_with_pipe": lambda: build(
            "zero2_with_pipe", model=bc_model(TINY, pipe_mesh=mesh((2, 1, 1), pipe=2)),
            device="cpu", mesh=mesh((2, 1, 1), pipe=2), shard_weight_update=True),
        "maml_on_fsdp": lambda: build("maml_on_fsdp", model=_maml_model(fsdp_model),
                                      device="cpu", mesh=fsdp_model).init_state(),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = ""
        except (NotImplementedError, ValueError) as err:
            out[name] = f"{type(err).__name__}: {err}"
    regimes = {name: trainer.regime for name, trainer in trainers.items()}
    regimes.update({
        "fsdp_model_with_zero2_flag": train_eval.Trainer(
            MockT2RModel(device_type="cpu"), device="cpu", mesh=fsdp_model,
            shard_weight_update=True).regime,
        "fsdp_model_with_a_codec": train_eval.Trainer(
            MockT2RModel(device_type="cpu"), device="cpu", mesh=fsdp_model,
            shard_weight_update=True, collective_quant="int8").regime,
        "data_with_a_codec": train_eval.Trainer(
            MockT2RModel(device_type="cpu"), device="cpu", mesh=data,
            shard_weight_update=True, collective_quant="int8").regime,
        "data_with_zero2": train_eval.Trainer(
            MockT2RModel(device_type="cpu"), device="cpu", mesh=data,
            shard_weight_update=True).regime,
        "data": train_eval.Trainer(MockT2RModel(device_type="cpu"), device="cpu",
                                   mesh=data).regime,
    })
    return dict(errors=out, regimes=regimes)


def _maml_model(m):
    """Pose MAML whose base is built with the mesh `m` (its loss's sums
    span the shards)."""
    from tensor2robot_tpu_torch.research.pose_env.pose_env_maml_models import (
        PoseEnvRegressionModelMAML,
    )
    from tensor2robot_tpu_torch.research.pose_env.pose_env_models import (
        PoseEnvRegressionModel,
    )

    return PoseEnvRegressionModelMAML(
        base_model=PoseEnvRegressionModel(device_type="cpu", mesh=m), device_type="cpu")


def collective_pair(shape) -> dict:
    """copy_to and gather_from over the model dim, and their backwards:
    this rank's x [2, 3] gathered along dim 1 to [2, 3 * model], whose
    cotangent is the same on every model rank; x's cotangent is its slice
    (gather_from) and y's through copy_to the sum over model."""
    m = mesh(shape)
    index = collectives.axis_index(m, mesh_lib.MODEL_AXIS)
    x = torch.full((2, 3), float(index + 1), requires_grad=True)
    y = collectives.gather_from(x, m, mesh_lib.MODEL_AXIS, axis=1)
    weight = torch.arange(y.numel(), dtype=torch.float32).view(y.shape)
    (y * weight).sum().backward()
    z = torch.ones(3, requires_grad=True)
    (collectives.copy_to(z, m, mesh_lib.MODEL_AXIS) * float(index + 1)).sum().backward()
    total = collectives.psum_dims(torch.tensor(float(dist.get_rank())), m,
                                  (mesh_lib.FSDP_AXIS, mesh_lib.MODEL_AXIS))
    return dict(y=y.detach().numpy(), x_grad=x.grad.numpy(), z_grad=z.grad.numpy(),
                index=index, total=float(total))


def layout_of(shape, model_kwargs: dict) -> dict:
    """The layout shard_network gives small BC on `shape` and the shard
    shapes of this rank."""
    network = bc_model(model_kwargs).create_network()
    layout = sharded_params.shard_network(network, mesh(shape))
    return dict(layout=layout,
                shapes={n: tuple(p.shape) for n, p in network.named_parameters()})
