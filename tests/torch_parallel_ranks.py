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
from tensor2robot_tpu_torch.parallel import sharded_params
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


def mesh(data: int = 1, sequence: int = 4, fsdp: int = 1, expert: int = 1):
    """This rank's mesh of the shape, made once per rank process."""
    key = (data, sequence, fsdp, expert)
    if key not in _MESHES:
        _MESHES[key] = mesh_lib.make_mesh(data=data, fsdp=fsdp, sequence=sequence,
                                          expert=expert)
    return _MESHES[key]


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


def unported_pins() -> dict:
    """What a real mesh refuses, each case's error as "<type>: <message>"
    ("" when nothing was raised): decoding over a sequence dim and MoE
    inside a pipeline (JAX's ValueErrors). The pipelined encoder builds
    ("pipeline_stages"), and so do a model dim composed with a pipe dim,
    shard_weight_update over data on a pipe mesh, decoding over a data
    mesh and a trainer on the sequence x pipe mesh with the plan of that
    mesh, once refused."""
    from tensor2robot_tpu_torch.layers.transformer import TransformerEncoder
    from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
    from tensor2robot_tpu_torch.parallel.planner import ShardingPlan
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    pipe = mesh_lib.make_mesh(sequence=2, pipe=2)
    model_dim = mesh_lib.make_mesh(model=2, pipe=2)
    data_pipe = mesh_lib.make_mesh(data=2, pipe=2)
    seq = mesh(1, 4)
    small = dict(episode_length=16, image_size=(16, 16), d_model=32, num_layers=2,
                 num_heads=4, head_dim=8, device_type="cpu")

    def piped(on=pipe):
        return TransformerBCModel(mesh=on, pipeline_stages=2, **small)

    cases = {
        "pipeline_stages": lambda: TransformerEncoder(32, 2, 4, 8, mesh=pipe,
                                                      pipeline_stages=2),
        "model_dim": lambda: TransformerEncoder(32, 2, 4, 8, mesh=model_dim,
                                                pipeline_stages=2),
        "decode_over_a_mesh": lambda: TransformerEncoder(32, 2, 4, 8, mesh=seq,
                                                         decode=True),
        "decode_over_a_data_mesh": lambda: TransformerEncoder(
            32, 2, 4, 8, mesh=mesh(4, 1), decode=True),
        "trainer_plan": lambda: Trainer(piped(), device="cpu", mesh=pipe, plan=ShardingPlan(
            name="sp2_pp2", sequence=2, pipe=2)),
        "trainer_shard_weight_update": lambda: Trainer(
            piped(data_pipe), device="cpu", mesh=data_pipe, shard_weight_update=True),
        "moe_in_a_pipeline": lambda: TransformerEncoder(32, 2, 4, 8, mesh=pipe,
                                                        pipeline_stages=2, num_experts=4),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = ""
        except (NotImplementedError, ValueError) as err:
            out[name] = f"{type(err).__name__}: {err}"
    return out


def what_data_shards_train() -> dict:
    """On a data mesh of 4 the mock classifier without batch norm and
    with its NoOp preprocessor takes a step. Returns the step's loss and
    the trainer's shard count."""
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


# -- global-batch training over data x fsdp shards, and experts ----------------------


def _critic(model_kwargs: dict):
    from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
        Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom as Critic,
    )

    return Critic(device_type="cpu", **model_kwargs)


def _struct(tree: dict):
    from tensor2robot_tpu_torch.specs import TensorSpecStruct

    return TensorSpecStruct({k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()})


CRITIC_REGIMES = {
    # regime: (Trainer kwargs, whether the norms are synchronized)
    "plain": (dict(), True),
    "remat": (dict(remat=True), True),
    "grad_accum2": (dict(grad_accum_steps=2), True),
    "unsynchronized": (dict(), False),
}


def critic_step(model_kwargs: dict, state: dict, features: dict, labels: dict,
                regime: str, shape=(2, 2)):
    """One critic backward on a data x fsdp mesh from preprocessed global
    features: this rank's shard (in the regime's microbatches), the
    trainer's regime, the gradients averaged by its bucket. Returns (loss,
    {name: gradient}, {name: buffer after the step}). The control regime
    "unsynchronized" points the norms at no mesh, so each shard
    normalizes by its own moments."""
    from tensor2robot_tpu_torch.layers import batch_norm
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    trainer_kwargs, synchronized = CRITIC_REGIMES[regime]
    m = mesh(data=shape[0], sequence=1, fsdp=shape[1])
    trainer = Trainer(_critic(model_kwargs), device="cpu", mesh=m, **trainer_kwargs)
    train_state = trainer.init_state(
        params={k: torch.from_numpy(v) for k, v in state.items()})
    network = train_state.network
    if not synchronized:
        batch_norm.synchronize(network, None)
    micro = trainer.grad_accum_steps
    f = _struct(mesh_lib.shard_batch(features, m, micro))
    l = _struct(mesh_lib.shard_batch(labels, m, micro))
    network.train()
    loss, metrics = trainer.backward(network, f, l)
    loss, _ = trainer.reduce_gradients(train_state, loss, metrics)
    return (float(loss), {n: g.numpy() for n, g in sharded_params.full_grads(
                network, trainer.param_layout, m).items()},
            {n: b.numpy() for n, b in network.named_buffers()})


def critic_draws(model_kwargs: dict, batch: dict, step: int):
    """This rank's train preprocessing of `batch` (the same on every
    rank) at `step` on a 2 x 2 data x fsdp mesh: (its data x fsdp index,
    the preprocessed image)."""
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    m = mesh(data=2, sequence=1, fsdp=2)
    trainer = Trainer(_critic(model_kwargs), device="cpu", mesh=m)
    features, _ = trainer.preprocess_train(to_device(batch, "cpu"),
                                           trainer.step_generator(step))
    return trainer.shard, features["state/image"].numpy()


def shard_by_host_reads(pattern: str, model_kwargs: dict, batch_size: int):
    """On a 2 data x 2 sequence mesh: the files this rank's shard_by_host
    stream reads and its first batch's rewards (sequence ranks of one data
    replica must read the same)."""
    from tensor2robot_tpu_torch.data.input_generators import DefaultRecordInputGenerator
    from tensor2robot_tpu_torch.train.train_eval import shard_inputs

    m = mesh(data=2, sequence=2)
    generator = DefaultRecordInputGenerator(file_patterns=pattern, batch_size=batch_size,
                                            shuffle_buffer_size=0, seed=3,
                                            num_parse_workers=0, shard_by_host=True)
    generator.set_specification_from_model(_critic(model_kwargs), "train")
    shard_inputs([generator], m)
    dataset = generator.create_record_dataset("train")
    batch = next(iter(dataset))
    return (mesh_lib.data_shard(m)[0], list(dataset._files[""]),
            np.asarray(batch["labels/reward"]))


def shard_by_host_too_few_files(pattern: str, model_kwargs: dict) -> str:
    """shard_by_host over 4 data shards of a single file: JAX's error."""
    from tensor2robot_tpu_torch.data.input_generators import DefaultRecordInputGenerator
    from tensor2robot_tpu_torch.train.train_eval import shard_inputs

    generator = DefaultRecordInputGenerator(file_patterns=pattern, batch_size=4,
                                            shard_by_host=True)
    generator.set_specification_from_model(_critic(model_kwargs), "train")
    shard_inputs([generator], mesh(data=4, sequence=1))
    try:
        generator.create_record_dataset("train")
    except ValueError as err:
        return str(err)
    return ""


def critic_train_eval(model_kwargs: dict, patterns: dict, model_dir: str, steps: int,
                      batch_size: int):
    """train_eval_model on a 2 x 2 data x fsdp mesh from shard_by_host
    train records (the eval records, one file, are read whole and
    sliced), with an exporter pair and StepTimingHook (rank 0 builds
    them), then continuous_eval over the same mesh with an exporter.
    Returns what this rank saw: its final evals and its timing rows."""
    import functools

    from tensor2robot_tpu_torch.data.input_generators import DefaultRecordInputGenerator
    from tensor2robot_tpu_torch.export.export_generators import DefaultExportGenerator
    from tensor2robot_tpu_torch.export.exporters import (
        LatestExporter,
        create_default_exporters,
    )
    from tensor2robot_tpu_torch.hooks.profiling_hook_builder import StepTimingHookBuilder
    from tensor2robot_tpu_torch.train.continuous_eval import continuous_eval
    from tensor2robot_tpu_torch.train.train_eval import train_eval_model

    m = mesh(data=2, sequence=1, fsdp=2)

    def records(split):
        return DefaultRecordInputGenerator(file_patterns=patterns[split],
                                           batch_size=batch_size, seed=5,
                                           num_parse_workers=0,
                                           shard_by_host=split == "train")

    timing = StepTimingHookBuilder(sync_every=1)
    final = train_eval_model(
        _critic(model_kwargs), records("train"), records("eval"), model_dir=model_dir,
        max_train_steps=steps, save_checkpoints_steps=steps, eval_steps=1,
        log_every_steps=1, device="cpu", mesh=m, hook_builders=[timing],
        create_exporters_fn=functools.partial(create_default_exporters,
                                              warmup_batch_sizes=(1, 2)),
    )
    timed = getattr(timing, "hook", None)
    evaluated = continuous_eval(
        _critic(model_kwargs), model_dir, records("eval"), eval_steps=1,
        max_train_steps=steps, timeout=5.0, poll_interval=0.1, mesh=m, device="cpu",
        create_exporters_fn=lambda model: [LatestExporter(
            name="continuous", export_generator=DefaultExportGenerator(),
            export_program=False)],
    )
    return dict(final=final, evaluated=evaluated, rank=torch.distributed.get_rank(),
                timed_rows=None if timed is None else len(timed.rows))


def moe_step(shape, model_kwargs: dict, state: dict, batch: dict):
    """One MoE BC backward on a data x expert mesh: this rank's data shard
    through its resident experts. Returns (loss, aux, this rank's own
    w_in/w_out gradients before the bucket, {name: averaged gradient},
    its resident experts)."""
    from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
    from tensor2robot_tpu_torch.ops import moe as moe_ops
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    m = mesh(data=shape[0], sequence=1, expert=shape[1])
    model = TransformerBCModel(mesh=m, device_type="cpu", **model_kwargs)
    trainer = Trainer(model, device="cpu", mesh=m)
    network = trainer.init_state(
        params={k: torch.from_numpy(v) for k, v in state.items()}).network
    local = to_device(mesh_lib.shard_batch(batch, m), "cpu")
    features, labels = trainer.preprocess_train(local)
    network.train()
    loss, metrics = trainer.backward(network, features, labels)
    own = {n: p.grad.clone().numpy() for n, p in network.named_parameters()
           if n.endswith(("moe.w_in", "moe.w_out"))}
    loss, metrics = trainer.average_over_ranks(network, loss, metrics)
    resident = moe_ops.resident_experts(model_kwargs["num_experts"], m)
    return (float(loss), float(metrics["loss/moe_aux"]), own,
            {n: p.grad.numpy() for n, p in network.named_parameters()},
            (resident.start, resident.stop))


def moe_forward_flops(model_kwargs: dict, batch: dict, expert: int) -> int:
    """FLOPs of one MoEBlock forward over the batch's tokens on this rank
    of a mesh with `expert` expert ranks (1: no mesh)."""
    from torch.utils.flop_counter import FlopCounterMode

    from tensor2robot_tpu_torch.layers.moe import MoEBlock

    m = None if expert == 1 else mesh(data=4 // expert, sequence=1, expert=expert)
    d = model_kwargs["d_model"]
    block = MoEBlock(d, model_kwargs["num_experts"], 4 * d, mesh=m)
    block.init_own_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(batch)
    with FlopCounterMode(display=False) as counter:
        block(x)
    return counter.get_total_flops()


def moe_unported(model_kwargs: dict) -> dict:
    """Experts over a mesh: under a sequence dim (expert x sequence, which
    builds) and on an expert dim that does not divide the experts
    (ValueError)."""
    from tensor2robot_tpu_torch.layers.transformer import TransformerEncoder

    cases = {
        "expert_x_sequence": lambda: TransformerEncoder(
            32, 2, 4, 8, mesh=mesh(data=1, sequence=2, expert=2), num_experts=4),
        "experts_not_dividing": lambda: TransformerEncoder(
            32, 2, 4, 8, mesh=mesh(data=1, sequence=1, expert=4), num_experts=2),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = ""
        except (NotImplementedError, ValueError) as err:
            out[name] = f"{type(err).__name__}: {err}"
    return out


def grasp2vec_step(model_kwargs: dict, state: dict, features: dict):
    """One float64 Grasp2Vec backward on a 2 data x 2 sequence mesh (the
    sequence ranks replicate): this rank's data shard through the towers,
    their batch norms over both data shards, the n-pairs loss over the
    gathered embeddings, the gradients averaged by the trainer's bucket.
    Returns (loss, {name: gradient}, {name: buffer})."""
    from tensor2robot_tpu_torch.research.grasp2vec import Grasp2VecModel
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    m = mesh(data=2, sequence=2)
    model = Grasp2VecModel(mesh=m, device_type="cpu", **model_kwargs)
    trainer = Trainer(model, device="cpu", mesh=m)
    network = trainer.init_state(
        params={k: torch.from_numpy(v) for k, v in state.items()}).network.double()
    local = {k: torch.from_numpy(v).double()
             for k, v in mesh_lib.shard_batch(features, m).items()}
    network.train()
    outputs, _ = model.inference_network_fn(network, local, "train")
    loss, metrics = model.model_train_fn(local, None, outputs, "train")
    loss.backward()
    loss, _ = trainer.average_over_ranks(
        network, loss.detach(), {k: v.detach() for k, v in metrics.items()})
    return (float(loss), {n: p.grad.numpy() for n, p in network.named_parameters()},
            {n: b.numpy() for n, b in network.named_buffers()})


# -- GPipe pipelining over the pipe dim ----------------------------------------------


def _dense_tanh(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def pipeline_case(data: int, pipe: int, micro: int, stacked: dict, x, g):
    """pipeline_apply of the dense + tanh stage on a data x pipe mesh:
    this rank's data shard of x through its stage of `stacked`, then the
    backward of <out, g's shard>. Returns (data shard, pipe index, out,
    dx, {name: this rank's stage gradient}, the point-to-point calls)."""
    from tensor2robot_tpu_torch.parallel import pipeline

    m = mesh_lib.make_mesh(data=data, pipe=pipe)
    calls = _count_pipeline_transfers()
    stages = [{k: torch.from_numpy(v[s]) for k, v in stacked.items()} for s in range(pipe)]
    local = pipeline.stage_sharding(m, pipeline.stack_stage_params(stages))
    for leaf in local.values():
        leaf.requires_grad_(True)
    shard = collectives.axis_index(m, mesh_lib.DATA_AXIS)
    xs = torch.tensor(_chunk(x, shard, data), requires_grad=True)
    out = pipeline.pipeline_apply(_dense_tanh, local, xs, mesh=m, num_microbatches=micro,
                                  batch_axis=mesh_lib.DATA_AXIS if data > 1 else None)
    out.backward(torch.from_numpy(_chunk(g, shard, data)))
    return (shard, collectives.axis_index(m, mesh_lib.PIPE_AXIS), out.detach().numpy(),
            xs.grad.numpy(), {k: v.grad.numpy() for k, v in local.items()}, calls[0])


def _count_pipeline_transfers():
    """Counts, in this rank, the ppermutes and broadcasts the pipeline
    issues from now on (a list of one count)."""
    from tensor2robot_tpu_torch.parallel import pipeline

    calls = [0]
    for name in ("ppermute", "broadcast"):
        fn = getattr(collectives, name)
        if hasattr(fn, "counted"):
            fn = fn.counted

        def counted(*args, _fn=fn, **kwargs):
            calls[0] += 1
            return _fn(*args, **kwargs)

        counted.counted = fn
        setattr(pipeline.collectives, name, counted)
    return calls


def pipeline_not_divisible() -> str:
    """A batch of 10 in 3 microbatches on a pipe dim of 4: the ValueError."""
    from tensor2robot_tpu_torch.parallel import pipeline

    m = mesh_lib.make_mesh(pipe=4)
    local = {"w": torch.zeros(4, 4), "b": torch.zeros(4)}
    try:
        pipeline.pipeline_apply(_dense_tanh, local, torch.ones(10, 4), mesh=m,
                                num_microbatches=3)
    except ValueError as err:
        return str(err)
    return ""


_PLAIN_COUNTED = []


def _count_plain_versions() -> None:
    """The kernels' plain versions count their launches as the kernels
    would on the card (chip_smoke.py's `_rank_setup` does the same), once
    a rank process."""
    from tensor2robot_tpu_torch.ops import flash_attention as fa

    if _PLAIN_COUNTED:
        return

    def counted(fn, *kernels):
        def run(*args, **kwargs):
            for kernel in kernels:
                fa.KERNELS[kernel].launches += 1
            return fn(*args, **kwargs)
        return run

    fa.flash_attention_plain = counted(fa.flash_attention_plain, "flash_fwd")
    fa.flash_attention_tile_plain = counted(fa.flash_attention_tile_plain, "flash_fwd_tile")
    fa.flash_attention_bwd_plain = counted(fa.flash_attention_bwd_plain,
                                           "flash_bwd_dq", "flash_bwd_dkv")
    _PLAIN_COUNTED.append(True)


def _launches() -> dict:
    from tensor2robot_tpu_torch.ops import flash_attention as fa

    return {name: kernel.launches for name, kernel in fa.KERNELS.items()}


def _reset_launches() -> None:
    from tensor2robot_tpu_torch.ops import flash_attention as fa

    for kernel in fa.KERNELS.values():
        kernel.launches = 0


def _pipe_mesh(shape):
    data, sequence, pipe = shape
    key = ("pipe",) + tuple(shape)
    if key not in _MESHES:
        _MESHES[key] = mesh_lib.make_mesh(data=data, sequence=sequence, pipe=pipe)
    return _MESHES[key]


def pipelined_bc_step(shape, model_kwargs: dict, state: dict, batch: dict,
                      trainer_kwargs: dict):
    """One pipelined BC backward on a data x sequence x pipe mesh: this
    rank's share of the batch (in the regime's global microbatches)
    through its stage, the gradients averaged by the trainer's bucket.
    Returns (loss, this rank's pipe index, {name: gradient}, the
    launches of the step)."""
    from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    _count_plain_versions()
    m = _pipe_mesh(shape)
    model = TransformerBCModel(mesh=m, pipeline_stages=shape[2], device_type="cpu",
                               **model_kwargs)
    trainer = Trainer(model, device="cpu", mesh=m, **trainer_kwargs)
    network = trainer.init_state(
        params={k: torch.from_numpy(v) for k, v in state.items()}).network
    local = to_device(mesh_lib.shard_batch(batch, m, trainer.grad_accum_steps), "cpu")
    features, labels = trainer.preprocess_train(local)
    network.train()
    _reset_launches()
    loss, metrics = trainer.backward(network, features, labels)
    loss, _ = trainer.average_over_ranks(network, loss, metrics)
    return (float(loss), collectives.axis_index(m, mesh_lib.PIPE_AXIS),
            {n: p.grad.numpy() for n, p in network.named_parameters()}, _launches())


def pipelined_bc_checkpoint(model_kwargs: dict, state: dict, batch: dict, model_dir: str):
    """One train step of pipelined BC on 2 data x 2 pipe from `state`,
    then the checkpoint as the trainer writes it (rank 0; stacked stages)
    with its durability manifest. Returns the step's loss and the names
    of this rank's network."""
    from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
    from tensor2robot_tpu_torch.train import durability
    from tensor2robot_tpu_torch.train import state as state_lib
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    m = _pipe_mesh((2, 1, 2))
    model = TransformerBCModel(mesh=m, pipeline_stages=2, device_type="cpu", **model_kwargs)
    trainer = Trainer(model, device="cpu", mesh=m)
    train_state = trainer.init_state(params={k: torch.from_numpy(v) for k, v in state.items()})
    metrics = trainer.train_step(train_state,
                                 to_device(mesh_lib.shard_batch(batch, m), "cpu"))
    saved = trainer.checkpoint_state(train_state)
    if torch.distributed.get_rank() == 0:
        state_lib.save_checkpoint(model_dir, saved["step"], saved["params"],
                                  saved["ema_params"], saved["optimizer"])
        durability.publish_durable(model_dir, saved["step"])
    torch.distributed.barrier()
    return float(metrics["loss"]), sorted(train_state.network.state_dict())


def pipeline_config_errors(features: int) -> dict:
    """JAX's ValueErrors of the pipelined encoder's composition rules, as
    each rank raises them: {case: message} ("" when nothing raised)."""
    from tensor2robot_tpu_torch.layers.transformer import TransformerEncoder

    pipe = _pipe_mesh((2, 1, 2))
    seq_pipe = _pipe_mesh((1, 2, 2))
    cases = {
        "layers_not_divisible": lambda: TransformerEncoder(
            features, 3, 2, 8, mesh=pipe, pipeline_stages=2),
        "moe": lambda: TransformerEncoder(features, 4, 2, 8, mesh=pipe, pipeline_stages=2,
                                          num_experts=4),
        "no_mesh": lambda: TransformerEncoder(features, 4, 2, 8, pipeline_stages=2),
        "pipe_size": lambda: TransformerEncoder(features, 4, 2, 8, mesh=pipe,
                                                pipeline_stages=4),
        "mode": lambda: TransformerEncoder(features, 4, 2, 8, mesh=seq_pipe,
                                           pipeline_stages=2,
                                           sequence_parallel_mode="bogus"),
        "ulysses_heads": lambda: TransformerEncoder(features, 4, 3, 8, mesh=seq_pipe,
                                                    pipeline_stages=2,
                                                    sequence_parallel_mode="ulysses"),
        "sequence": lambda: TransformerEncoder(features, 4, 2, 8, mesh=seq_pipe,
                                               pipeline_stages=2)(
            torch.zeros(2, 7, features)),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = ""
        except ValueError as err:
            out[name] = str(err)
    return out


def pipelined_bc_train_eval(model_kwargs: dict, model_dir: str, steps: int):
    """train_eval_model of pipelined BC on 2 data x 2 pipe with a
    LatestExporter (no program) and StepTimingHook on rank 0, then
    continuous_eval over the same mesh with an exporter. Returns this
    rank's final eval, continuous eval and the hook's timing rows."""
    from tensor2robot_tpu_torch.data.input_generators import DefaultRandomInputGenerator
    from tensor2robot_tpu_torch.export.export_generators import DefaultExportGenerator
    from tensor2robot_tpu_torch.export.exporters import LatestExporter
    from tensor2robot_tpu_torch.hooks.profiling_hook_builder import StepTimingHookBuilder
    from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
    from tensor2robot_tpu_torch.train.continuous_eval import continuous_eval
    from tensor2robot_tpu_torch.train.train_eval import train_eval_model

    m = _pipe_mesh((2, 1, 2))

    def model():
        return TransformerBCModel(mesh=m, pipeline_stages=2, device_type="cpu",
                                  use_avg_model_params=True, **model_kwargs)

    def exporters(name):
        return lambda exporting: [LatestExporter(
            name=name, export_generator=DefaultExportGenerator(), export_program=False)]

    timing = StepTimingHookBuilder(sync_every=1)
    final = train_eval_model(
        model(), DefaultRandomInputGenerator(batch_size=4, seed=0),
        DefaultRandomInputGenerator(batch_size=4, seed=1000), model_dir=model_dir,
        max_train_steps=steps, save_checkpoints_steps=steps, eval_steps=1,
        log_every_steps=1, device="cpu", mesh=m, hook_builders=[timing],
        create_exporters_fn=exporters("latest"))
    evaluated = continuous_eval(
        model(), model_dir, DefaultRandomInputGenerator(batch_size=4, seed=1000),
        eval_steps=1, max_train_steps=steps, timeout=5.0, poll_interval=0.1, mesh=m,
        device="cpu", create_exporters_fn=exporters("continuous"))
    timed = getattr(timing, "hook", None)
    return dict(final=final, evaluated=evaluated,
                timed_rows=None if timed is None else len(timed.rows))


def pipe_groups(shape) -> dict:
    """This rank's pipe chain (mesh.pipe_group) and stage replicas
    (mesh.stage_group) on a data x sequence x pipe mesh, as global ranks,
    with its coordinates."""
    import torch.distributed as dist

    m = _pipe_mesh(shape)
    group, size = mesh_lib.stage_group(m)
    return dict(rank=dist.get_rank(),
                pipe=collectives.axis_index(m, mesh_lib.PIPE_AXIS),
                chain=dist.get_process_group_ranks(mesh_lib.pipe_group(m)),
                replicas=dist.get_process_group_ranks(group), size=size)
