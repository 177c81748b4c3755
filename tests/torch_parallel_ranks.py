"""The rank side of the port's parallel parity tests.

Each function runs on every rank of a LocalWorld (4 gloo processes on the
CPU, tensor2robot_tpu_torch/parallel/launch.py) and returns numpy arrays
for the test to assemble and hold against the JAX package. This module
imports no JAX: a spawned rank imports it, and JAX stays out of the ranks.
"""

import numpy as np
import torch

from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ring_attention_manual,
)
from tensor2robot_tpu_torch.parallel.ulysses_attention import (
    ulysses_attention,
    ulysses_attention_manual,
)

_MESHES = {}
SEQ = mesh_lib.SEQUENCE_AXIS


def mesh(data: int = 1, sequence: int = 4):
    """This rank's mesh of the shape, made once per rank process."""
    if (data, sequence) not in _MESHES:
        _MESHES[(data, sequence)] = mesh_lib.make_mesh(data=data, sequence=sequence)
    return _MESHES[(data, sequence)]


def _chunk(array: np.ndarray, index: int, count: int, axis: int = 0) -> np.ndarray:
    size = array.shape[axis] // count
    return np.take(array, range(index * size, (index + 1) * size), axis=axis)


# -- collectives -----------------------------------------------------------------


def mesh_facts(data: int, sequence: int) -> dict:
    """The mesh as this rank sees it."""
    m = mesh(data, sequence)
    return dict(shape=mesh_lib.mesh_shape(m), rank=torch.distributed.get_rank(),
                data=collectives.axis_index(m, mesh_lib.DATA_AXIS),
                sequence=collectives.axis_index(m, SEQ),
                data_shard=mesh_lib.data_shard(m))


def shard(batch: dict, data: int, sequence: int):
    """This rank's shard of a batch."""
    return mesh_lib.shard_batch(batch, mesh(data, sequence))


COLLECTIVES = {
    "psum": lambda x, m, **kw: collectives.psum(x, m, SEQ),
    "pmean": lambda x, m, **kw: collectives.pmean(x, m, SEQ),
    "ppermute": lambda x, m, perm: collectives.ppermute(x, m, SEQ, perm),
    "all_to_all": lambda x, m, split_axis, concat_axis: collectives.all_to_all(
        x, m, SEQ, split_axis, concat_axis),
    "all_gather": lambda x, m, axis: collectives.all_gather(x, m, SEQ, axis=axis),
    "psum_scatter": lambda x, m, axis: collectives.psum_scatter(
        x, m, SEQ, scatter_dimension=axis),
}


def collective(op: str, x: np.ndarray, g: np.ndarray, replicated: bool, kwargs: dict):
    """This rank's block of x (dim 0 over the sequence dim) through the
    collective, then the backward of <g's block, out> (g whole when the
    output is replicated). Returns (out, dx)."""
    m = mesh(1, 4)
    me = collectives.axis_index(m, SEQ)
    local = torch.tensor(_chunk(x, me, 4), requires_grad=True)
    out = COLLECTIVES[op](local, m, **kwargs)
    cotangent = g if replicated else _chunk(g, me, 4)
    out.backward(torch.from_numpy(np.ascontiguousarray(cotangent)))
    return out.detach().numpy(), local.grad.numpy()


# -- attention --------------------------------------------------------------------

ATTENTION = {
    "ring": ring_attention,
    "ulysses": ulysses_attention,
    "ring_manual": ring_attention_manual,
    "ulysses_manual": ulysses_attention_manual,
}


def attention(kind: str, q, k, v, g, kwargs: dict):
    """This rank's sequence shards of q, k, v [B, S, H, D] through the
    entry point; returns (out, dq, dk, dv) of this rank's shard."""
    m = mesh(1, 4)
    me = collectives.axis_index(m, SEQ)
    local = [torch.tensor(_chunk(t, me, 4, axis=1), requires_grad=True) for t in (q, k, v)]
    if kind.endswith("manual"):
        out = ATTENTION[kind](*local, mesh=m, **kwargs)
    else:
        out = ATTENTION[kind](*local, m, **kwargs)
    out.backward(torch.from_numpy(_chunk(g, me, 4, axis=1)))
    return (out.detach().numpy(),) + tuple(t.grad.numpy() for t in local)


def attention_layer(state: dict, x, g, kwargs: dict):
    """MultiHeadAttention over the mesh on this rank's sequence shard of x
    [B, S, F]: (out, dx) of the shard and this rank's parameter gradients
    (their sum over the ranks is the layer's gradient)."""
    from tensor2robot_tpu_torch.layers.transformer import MultiHeadAttention

    m = mesh(1, 4)
    me = collectives.axis_index(m, SEQ)
    layer = MultiHeadAttention(x.shape[-1], mesh=m, **kwargs)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    local = torch.tensor(_chunk(x, me, 4, axis=1), requires_grad=True)
    out = layer(local)
    out.backward(torch.from_numpy(_chunk(g, me, 4, axis=1)))
    grads = {name: p.grad.numpy() for name, p in layer.named_parameters()}
    return out.detach().numpy(), local.grad.numpy(), grads


def second_derivative_raises() -> str:
    """A second derivative through the flash ring raises on every rank."""
    m = mesh(1, 4)
    rng = np.random.RandomState(collectives.axis_index(m, SEQ))
    q, k, v = (torch.tensor(rng.randn(1, 4, 2, 8).astype(np.float32), requires_grad=True)
               for _ in range(3))
    out = ring_attention(q, k, v, m, causal=True, use_flash=True)
    (dq,) = torch.autograd.grad(out.sum(), q, create_graph=True)
    try:
        dq.sum().backward()
    except RuntimeError as err:
        return str(err)
    return ""


def ulysses_heads_error() -> str:
    """Ulysses over 3 heads on a sequence dim of 4 raises ValueError."""
    q = torch.zeros(1, 4, 3, 8)
    try:
        ulysses_attention(q, q, q, mesh(1, 4), causal=True)
    except ValueError as err:
        return str(err)
    return ""


# -- the BC slice -------------------------------------------------------------------


def bc_step(shape, model_kwargs: dict, state: dict, batch: dict):
    """One BC backward on this rank's shard of the batch over the mesh,
    the gradients averaged over the ranks by the trainer's bucket.
    Returns (loss, {name: gradient})."""
    from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    m = mesh(*shape)
    model = TransformerBCModel(mesh=m, device_type="cpu", **model_kwargs)
    trainer = Trainer(model, device="cpu", mesh=m)
    network = trainer.init_state(
        params={k: torch.from_numpy(v) for k, v in state.items()}).network
    local = to_device(mesh_lib.shard_batch(batch, m), "cpu")
    features, labels = trainer.preprocess_train(local)
    loss, metrics = trainer.backward(network, features, labels)
    loss, _ = trainer.average_over_ranks(network, loss, metrics)
    return float(loss), {n: p.grad.numpy() for n, p in network.named_parameters()}


def bc_train_eval(shape, model_kwargs: dict, model_dir: str, steps: int, every: int):
    """train_eval_model over the mesh on every rank; returns the final
    eval metrics and this rank's network's state-dict shapes."""
    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRandomInputGenerator,
    )
    from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
    from tensor2robot_tpu_torch.train.train_eval import train_eval_model

    m = mesh(*shape)
    model = TransformerBCModel(mesh=m, device_type="cpu", **model_kwargs)
    final = train_eval_model(
        model, DefaultRandomInputGenerator(batch_size=4, seed=0),
        DefaultRandomInputGenerator(batch_size=4, seed=1000), model_dir=model_dir,
        max_train_steps=steps, save_checkpoints_steps=every, eval_steps=1,
        log_every_steps=every, device="cpu", mesh=m,
    )
    shapes = {k: tuple(v.shape) for k, v in model.create_network().state_dict().items()}
    return final, shapes


def _noisy_mock_model():
    """The mock classifier without batch norm, whose preprocessing adds
    noise drawn from the step's generator."""
    from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
        NoOpPreprocessor,
    )
    from tensor2robot_tpu_torch.utils.mocks import MockT2RModel

    class NoisyPreprocessor(NoOpPreprocessor):
        def _preprocess_fn(self, features, labels, mode, generator):
            x = features["x"]
            features["x"] = x + torch.randn(x.shape, generator=generator)
            return features, labels

    return MockT2RModel(use_batch_norm=False, preprocessor_cls=NoisyPreprocessor)


def _noisy_step_over_data_shards():
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer
    from tensor2robot_tpu_torch.utils.mocks import MockInputGenerator

    data = mesh(4, 1)
    trainer = Trainer(_noisy_mock_model(), device="cpu", mesh=data)
    state = trainer.init_state()
    batch = next(iter(MockInputGenerator(batch_size=8).create_dataset("train")))
    trainer.train_step(state, to_device(mesh_lib.shard_batch(batch, data), "cpu"))


def unported_pins(model_dir: str) -> dict:
    """What a real mesh still refuses (ROADMAP.md A9, part 2): each case's
    NotImplementedError message ("" when nothing was raised)."""
    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRandomInputGenerator,
        DefaultRecordInputGenerator,
    )
    from tensor2robot_tpu_torch.layers.transformer import TransformerEncoder
    from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
    from tensor2robot_tpu_torch.train.continuous_eval import continuous_eval
    from tensor2robot_tpu_torch.train.train_eval import Trainer, train_eval_model
    from tensor2robot_tpu_torch.utils.mocks import MockT2RModel

    pipe = mesh_lib.make_mesh(sequence=2, pipe=2)
    expert = mesh_lib.make_mesh(sequence=2, expert=2)
    seq = mesh(1, 4)
    data = mesh(4, 1)
    small = dict(episode_length=16, image_size=(16, 16), d_model=32, num_layers=2,
                 num_heads=4, head_dim=8, device_type="cpu")
    cases = {
        "pipeline_stages": lambda: TransformerEncoder(32, 2, 4, 8, mesh=pipe,
                                                      pipeline_stages=2),
        "expert_axis": lambda: TransformerEncoder(32, 2, 4, 8, mesh=expert),
        "experts_over_a_mesh": lambda: TransformerEncoder(32, 2, 4, 8, mesh=seq,
                                                          num_experts=4),
        "decode_over_a_mesh": lambda: TransformerEncoder(32, 2, 4, 8, mesh=seq,
                                                         decode=True),
        "trainer_expert_axis": lambda: Trainer(
            TransformerBCModel(mesh=expert, **small), device="cpu", mesh=expert),
        "trainer_plan": lambda: Trainer(TransformerBCModel(mesh=seq, **small),
                                        device="cpu", mesh=seq, plan=object()),
        "exporters_over_a_mesh": lambda: train_eval_model(
            TransformerBCModel(mesh=seq, **small),
            DefaultRandomInputGenerator(batch_size=4), model_dir=model_dir,
            device="cpu", mesh=seq, create_exporters_fn=lambda m: []),
        "continuous_eval_over_a_mesh": lambda: continuous_eval(
            TransformerBCModel(mesh=seq, **small), model_dir,
            DefaultRandomInputGenerator(batch_size=4), mesh=seq, device="cpu"),
        "batch_norm_over_data_shards": lambda: Trainer(
            MockT2RModel(), device="cpu", mesh=data).init_state(),
        "random_preprocessing_over_data_shards": _noisy_step_over_data_shards,
        "shard_by_host_over_a_mesh": lambda: train_eval_model(
            TransformerBCModel(mesh=seq, **small),
            DefaultRecordInputGenerator(file_patterns=f"{model_dir}/none-*",
                                        batch_size=4, shard_by_host=True),
            model_dir=model_dir, device="cpu", mesh=seq),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = ""
        except NotImplementedError as err:
            out[name] = str(err)
    return out


def what_data_shards_train() -> dict:
    """The control of the data-shard refusals: on a data mesh of 4 the
    mock classifier without batch norm and with its NoOp preprocessor
    takes a step. Returns the step's loss and the trainer's shard count."""
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer
    from tensor2robot_tpu_torch.utils.mocks import MockInputGenerator, MockT2RModel

    data = mesh(4, 1)
    trainer = Trainer(MockT2RModel(use_batch_norm=False), device="cpu", mesh=data)
    state = trainer.init_state()
    batch = next(iter(MockInputGenerator(batch_size=8).create_dataset("train")))
    loss = trainer.train_step(state, to_device(mesh_lib.shard_batch(batch, data), "cpu"))["loss"]
    return dict(loss=float(loss), data_shards=trainer.data_shards)


def trainer_without_the_models_mesh() -> str:
    """A model built with a sequence mesh under a trainer without one
    raises ValueError (its gradients would go unreduced)."""
    from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    model = TransformerBCModel(mesh=mesh(1, 4), device_type="cpu")
    try:
        Trainer(model, device="cpu")
    except ValueError as err:
        return str(err)
    return ""
