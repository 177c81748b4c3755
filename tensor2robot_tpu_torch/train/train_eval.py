"""The trainer: train, evaluate, checkpoint and predict a T2RModel.

Port of tensor2robot_tpu/train/train_eval.py on one device. `Trainer` is
the counterpart of the JAX package's CompiledModel: the model's hooks as
train, eval and predict steps over a TrainState, in the same order
(preprocess, packed inference, model_train_fn, backward, optimizer, EMA).
Each train step preprocesses with its own generator on the device,
seeded from (seed, step) as the JAX step folds the step into its key, so
random crops and distortions differ per step and repeat on a resume.
Batch-norm running statistics are buffers of the network: they change in
a train-mode forward, ride in the checkpoint's `params`, and are not
averaged (the EMA covers parameters only, as the JAX export_variables).
PyTorch runs eagerly, so nothing is compiled; on the card the transformer's
attention runs the flash kernels (B1 forward and B3+B4 backward under
autograd, B2 under inference_mode in eval and predict).

The memory regimes, as the JAX CompiledModel has them:
  * remat: the network's marked segments (layers/remat.py: the BC
    embed in slices of frames and each transformer block, the Grasping44
    tower's conv stages) run under torch.utils.checkpoint
    (non-reentrant), so the backward recomputes one segment's
    activations at a time (B1 runs again in each block's recompute). A
    network that marks none trains as without remat. Preprocessing stays
    outside, once per step: the checkpoint restores only the default
    generators, and the step's own generator would draw another crop in a
    recompute.
  * grad_accum_steps = K: the preprocessed batch is split into K
    microbatches, each backward adds 1/K of its gradient, and the metrics
    are recombined by key (`golden/` and `per_example/` concatenate, other
    floats average, integers sum). Every microbatch sees the step-start
    batch-norm statistics and the last one's update is kept, as in JAX.
    The buffers are restored around every extra forward (the next
    microbatch, the recompute), so they never move twice.
  * iterations_per_loop = K (train_eval_model): K train steps per loop
    with no host sync between them; loops end at checkpoint steps, and
    hooks see the loop's first step (before_step) and last (after_step).
    Batches stream from device_prefetch one by one, as at K = 1: PyTorch
    launches each step from the host anyway, so a stacked [K, B, ...]
    copy would only add host work.

`train_eval_model` is the entry point: it wraps a model whose device_type
is "tpu" in the bf16 policy (maybe_wrap_for_tpu), prints the specs,
writes `operative_config.gin` at start and at exit, quarantines torn
checkpoints (train/durability.py) and resumes from the newest durable one
under `<model_dir>/checkpoints/` (skipping the batches the restored steps
consumed), logs scalars to `<model_dir>/train/metrics.jsonl`, checkpoints
every `save_checkpoints_steps` with a durability manifest, and evaluates
each named eval set into `<model_dir>/eval[_<name>]/metrics.jsonl`. With
`create_exporters_fn`, each exporter it returns (export/exporters.py) is
asked to export after every eval, with that eval's metrics, under
`<model_dir>/export/<name>/`. Hooks (hooks/hook_builder.py) are called in
the JAX package's order.

mesh, plan, shard_weight_update and flatten_optimizer_update raise
NotImplementedError naming ROADMAP.md item A9.
"""

from __future__ import annotations

import hashlib
import itertools
import logging
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Union

import torch

from tensor2robot_tpu_torch import config as config_lib
from tensor2robot_tpu_torch.export.saved_model import TRACE_LOCK
from tensor2robot_tpu_torch.layers import remat as remat_lib
from tensor2robot_tpu_torch.hooks.hook_builder import Hook, HookContext
from tensor2robot_tpu_torch.models.abstract_model import (
    MODE_EVAL,
    MODE_PREDICT,
    MODE_TRAIN,
)
from tensor2robot_tpu_torch.models.tpu_model_wrapper import BFloat16ModelWrapper
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.train import durability, infeed
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train.metrics import (
    BATCH_CARRYING_METRIC_PREFIXES,
    MetricsWriter,
)
from tensor2robot_tpu_torch.train.state import TrainState, init_ema, update_ema
from tensor2robot_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

def _reject_unported(mesh=None, plan=None, shard_weight_update=False,
                     flatten_optimizer_update=False) -> None:
    if (mesh is not None or plan is not None or shard_weight_update
            or flatten_optimizer_update):
        raise NotImplementedError(
            "mesh, plan, shard_weight_update and flatten_optimizer_update "
            "are not ported yet (ROADMAP.md A9)"
        )


def maybe_wrap_for_tpu(model):
    """The bf16 policy for a model whose device_type is "tpu", as the JAX
    trainer wraps it in TPUT2RModelWrapper."""
    if model.is_device_tpu and not isinstance(model, BFloat16ModelWrapper):
        return BFloat16ModelWrapper(model)
    return model


def print_specification(model) -> None:
    """The startup spec dump."""
    for mode in (MODE_TRAIN, MODE_EVAL):
        print(f"*** Specifications for mode={mode} ***")
        for name, spec_fn in (
            ("features", model.get_feature_specification),
            ("labels", model.get_label_specification),
        ):
            for key, spec in spec_fn(mode).items():
                print(f"  {name}/{key}: {spec}")


def _batch_labels(batch):
    """The batch's labels subtree, or None for label-less models."""
    try:
        return batch["labels"]
    except KeyError:
        return None


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of train step `step`'s preprocessing (random crops,
    distortions), on `device`: seeded from (seed, step) alone, as the JAX
    trainer draws step `step`'s rng_pre from fold_in(rng, step). A resumed
    run draws what the uninterrupted run drew at the same step. (The JAX
    trainer also splits off an rng_net for the network; no network of the
    port draws random numbers, so none is made.)"""
    digest = hashlib.blake2b(f"{seed}:{step}:pre".encode(), digest_size=8)
    generator = torch.Generator(device=device)
    generator.manual_seed(int.from_bytes(digest.digest(), "little"))
    return generator


def microbatch(tree, index: int, count: int):
    """Microbatch `index` of `count` of every leaf of `tree` (None passes):
    leaves whose leading dim `count` divides are sliced; 0-d and
    unit-leading leaves go whole into every microbatch; any other leaf is
    a batch that cannot split, and raises."""
    if tree is None:
        return None
    out = TensorSpecStruct()
    for key, leaf in tree.items():
        if leaf.ndim == 0 or leaf.shape[0] == 1:
            out[key] = leaf
            continue
        if leaf.shape[0] % count:
            raise ValueError(
                f"Leaf {key!r} batch {leaf.shape[0]} not divisible by "
                f"grad_accum_steps={count}"
            )
        size = leaf.shape[0] // count
        out[key] = leaf.narrow(0, index * size, size)
    return out


def combine_microbatch_metrics(metrics: List[Dict[str, torch.Tensor]]):
    """Per-microbatch metrics recombined by KEY, not shape (a fixed-size
    vector metric could coincide with B/K): keys under the `golden/` or
    `per_example/` prefixes concatenate back to the full batch; other
    floats average (the mean of per-microbatch means is the full-batch
    mean), integer counts sum."""
    out = {}
    for key in metrics[0]:
        stacked = torch.stack([m[key] for m in metrics])
        if key.startswith(BATCH_CARRYING_METRIC_PREFIXES) and stacked.ndim >= 2:
            out[key] = stacked.reshape((-1,) + tuple(stacked.shape[2:]))
        elif stacked.is_floating_point():
            out[key] = stacked.mean(dim=0)
        else:
            out[key] = stacked.sum(dim=0)
    return out


def _restore_buffers(buffers, values) -> None:
    with torch.no_grad():
        for buffer, value in zip(buffers, values):
            buffer.copy_(value)


class Trainer:
    """The model's hooks as steps over a TrainState on one device. Train
    steps preprocess with `step_generator(seed, step)`; `remat` and
    `grad_accum_steps` are the memory regimes (module docstring)."""

    def __init__(
        self,
        model,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
        seed: int = 0,
        mesh=None,
        plan=None,
        remat: bool = False,
        grad_accum_steps: int = 1,
        shard_weight_update: bool = False,
        flatten_optimizer_update: bool = False,
    ):
        _reject_unported(
            mesh=mesh, plan=plan, shard_weight_update=shard_weight_update,
            flatten_optimizer_update=flatten_optimizer_update,
        )
        if int(grad_accum_steps) < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
        self.model = model
        self.device = resolve_device(device)
        self.seed = seed
        self.remat = bool(remat)
        self.grad_accum_steps = int(grad_accum_steps)
        self.preprocessor = model.preprocessor
        self.optimizer_factory = model.create_optimizer()
        self._ema_network: Optional[torch.nn.Module] = None

    def init_state(
        self,
        generator: Optional[torch.Generator] = None,
        params: Optional[Dict[str, torch.Tensor]] = None,
    ) -> TrainState:
        """A fresh TrainState: weights drawn from `generator` (seed 0 when
        None) and passed through the model's warm start
        (maybe_init_from_checkpoint), or the given state dict (e.g.
        converted flax params)."""
        if params is None:
            network = self.model.init_network(generator, self.device)
            fresh = dict(network.state_dict())
            warm = self.model.maybe_init_from_checkpoint(fresh)
            if warm is not fresh:
                network.load_state_dict(warm)
        else:
            network = self.model.create_network()
            network.load_state_dict(params)
            network = network.to(self.device)
        ema = init_ema(network) if self.model.use_avg_model_params else None
        optimizer = self.optimizer_factory(network.parameters())
        return TrainState(step=0, network=network, optimizer=optimizer,
                          ema_params=ema)

    def preprocess_train(self, batch, generator=None):
        """(features, labels) of a device batch in train mode; random crops
        and distortions draw from `generator` (None: none)."""
        return self.preprocessor.preprocess(
            batch["features"], _batch_labels(batch), mode=MODE_TRAIN,
            generator=generator,
        )

    def network_loss(self, network, features, labels):
        """(loss, train metrics) of preprocessed features: the network and
        the loss."""
        f, l, outputs, _ = self.model.packed_inference(
            network, features, MODE_TRAIN, labels=labels
        )
        return self.model.model_train_fn(f, l, outputs, MODE_TRAIN)

    def forward_loss(self, network, batch, generator=None):
        """(loss, train metrics) of a device batch in train mode;
        preprocessing draws from `generator` (None: no random crop or
        distortion)."""
        features, labels = self.preprocess_train(batch, generator)
        return self.network_loss(network, features, labels)

    def backward(self, network, features, labels):
        """Adds the gradient of the loss on preprocessed (features, labels)
        into the parameters' .grad under this trainer's regimes; returns
        the loss and the train metrics, detached."""
        count = self.grad_accum_steps
        # The state a train-mode forward changes (batch-norm statistics).
        buffers = list(network.buffers()) if count > 1 or self.remat else []
        step_start = [b.clone() for b in buffers] if count > 1 else None
        loss_total, per_micro = None, []
        for index in range(count):
            if count > 1:
                if index:
                    _restore_buffers(buffers, step_start)
                f, l = microbatch(features, index, count), microbatch(labels, index, count)
            else:
                f, l = features, labels
            with remat_lib.segments(self.remat):
                loss, metrics = self.network_loss(network, f, l)
            if self.remat:
                after_forward = [b.clone() for b in buffers]
            (loss / count if count > 1 else loss).backward()
            if self.remat:
                _restore_buffers(buffers, after_forward)
            loss = loss.detach()
            if count == 1:
                loss_total = loss
            else:  # JAX's order: acc + loss / K, from the first microbatch
                loss_total = loss / count if loss_total is None else loss_total + loss / count
            per_micro.append({k: v.detach() for k, v in metrics.items()})
        if count == 1:
            return loss_total, per_micro[0]
        return loss_total, combine_microbatch_metrics(per_micro)

    def train_step(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """One update of `state` in place from a device batch; returns the
        step's metrics as device tensors (no host sync)."""
        state.network.train()
        features, labels = self.preprocess_train(
            batch, step_generator(self.seed, state.step, self.device))
        state.optimizer.zero_grad(set_to_none=True)
        loss, train_metrics = self.backward(state.network, features, labels)
        state.optimizer.step()
        if state.ema_params is not None:
            state.ema_params = update_ema(
                state.ema_params, state.params(),
                self.model.avg_model_params_decay,
            )
        state.step += 1
        metrics = {"loss": loss}
        metrics.update(train_metrics)
        return metrics

    def _eval_network(self, state: TrainState, use_ema: bool):
        if not use_ema or state.ema_params is None:
            return state.network
        if self._ema_network is None:
            self._ema_network = self.model.create_network().to(self.device)
        self._ema_network.load_state_dict(state.export_state_dict(use_ema=True))
        return self._ema_network

    def eval_step(self, state: TrainState, batch, use_ema: bool = False):
        """model_eval_fn on a device batch, under inference_mode (so the
        attention takes the forward without residuals, as the JAX primal
        does)."""
        with torch.inference_mode():
            features, labels = self.preprocessor.preprocess(
                batch["features"], _batch_labels(batch), mode=MODE_EVAL
            )
            network = self._eval_network(state, use_ema)
            network.eval()
            f, l, outputs, _ = self.model.packed_inference(
                network, features, MODE_EVAL, labels=labels
            )
            return self.model.model_eval_fn(f, l, outputs)

    def predict_step(self, network, features):
        """Export outputs of preprocessed device features."""
        with torch.inference_mode():
            network.eval()
            f, _, outputs, _ = self.model.packed_inference(
                network, features, MODE_PREDICT
            )
            return self.model.create_export_outputs_fn(f, outputs)


def restore_or_init_state(
    model_dir: str, trainer: Trainer, generator: Optional[torch.Generator] = None
) -> TrainState:
    """The newest durable checkpoint under model_dir (torn ones skipped,
    train/durability.py), or a fresh state (warm-started where the model
    asks for it)."""
    state = trainer.init_state(generator)
    checkpoint = durability.load_newest_durable(model_dir, map_location=trainer.device)
    if checkpoint is not None:
        state.restore(checkpoint)
    return state


# -- evaluation -------------------------------------------------------------------


def normalize_eval_generators(input_generator_eval) -> Dict[str, Any]:
    """None -> {}; a bare generator -> {"": generator}; a mapping passes
    through (one named dataset per entry)."""
    if input_generator_eval is None:
        return {}
    if isinstance(input_generator_eval, dict):
        if "" in input_generator_eval and len(input_generator_eval) > 1:
            raise ValueError(
                "Multi-eval maps require every eval to be named (got an "
                "empty-string name alongside others)."
            )
        return dict(input_generator_eval)
    return {"": input_generator_eval}


def eval_dir_name(name: str) -> str:
    """'eval' for the unnamed eval, 'eval_<name>' per named dataset."""
    return "eval" if not name else f"eval_{name}"


def evaluate(
    trainer: Trainer,
    state: TrainState,
    eval_batches: Iterator,
    eval_steps: Optional[int] = None,
    use_ema: bool = False,
) -> Dict[str, float]:
    """Averages model_eval_fn metrics over up to eval_steps batches; the
    sums stay on the device (f32) and are read once at the end."""
    if eval_steps is not None:
        eval_batches = itertools.islice(eval_batches, eval_steps)
    totals: Dict[str, torch.Tensor] = {}
    count = 0
    for batch in infeed.device_prefetch(
        eval_batches, trainer.device, depth=infeed.resolve_depth()
    ):
        for key, value in trainer.eval_step(state, batch, use_ema).items():
            value = value.float()
            totals[key] = totals[key] + value if key in totals else value
        count += 1
    return {key: float(total) / count for key, total in totals.items()}


def run_named_evals(
    trainer: Trainer,
    state: TrainState,
    eval_generators: Dict[str, Any],
    eval_steps: Optional[int],
    use_ema: bool,
    step: Optional[int] = None,
    writers: Optional[Dict[str, MetricsWriter]] = None,
) -> Dict[str, float]:
    """Evaluates every named dataset; returns merged metrics. The first
    entry's metrics keep unprefixed keys; every named eval's are also
    recorded under '<name>/<key>'."""
    merged: Dict[str, float] = {}
    for i, (name, generator) in enumerate(eval_generators.items()):
        metrics = evaluate(
            trainer, state, iter(generator.create_dataset(MODE_EVAL)),
            eval_steps=eval_steps, use_ema=use_ema,
        )
        if not metrics:
            continue
        if writers is not None and step is not None and name in writers:
            writers[name].write(step, metrics)
        if i == 0:
            merged.update(metrics)
        if name:
            merged.update({f"{name}/{k}": v for k, v in metrics.items()})
    return merged


# -- the entry point ----------------------------------------------------------------


def train_eval_model(
    t2r_model,
    input_generator_train=None,
    input_generator_eval=None,
    model_dir: str = "/tmp/t2r_torch_model",
    max_train_steps: int = 1000,
    eval_steps: Optional[int] = 100,
    save_checkpoints_steps: int = 500,
    keep_checkpoint_max: int = 5,
    log_every_steps: int = 100,
    create_exporters_fn=None,
    hook_builders=None,
    mesh=None,
    seed: int = 0,
    use_ema_for_eval: Optional[bool] = None,
    iterations_per_loop: int = 1,
    infeed_depth: Optional[int] = None,
    remat: bool = False,
    grad_accum_steps: int = 1,
    shard_weight_update: bool = False,
    flatten_optimizer_update: bool = False,
    plan=None,
    device: Union[str, torch.device] = DEFAULT_DEVICE,
) -> Dict[str, float]:
    """Trains, periodically checkpoints and evaluates the model; returns
    the final eval metrics ({} without an eval generator). Resumes from
    the newest durable checkpoint in model_dir if there is one.

    iterations_per_loop > 1 runs K steps per loop, and hooks then observe
    loop granularity. remat and grad_accum_steps are the memory levers
    (Trainer)."""
    if input_generator_train is None:
        raise ValueError("train_eval_model requires input_generator_train.")
    model = maybe_wrap_for_tpu(t2r_model)
    trainer = Trainer(
        model, device=device, seed=seed, mesh=mesh, plan=plan,
        remat=remat, grad_accum_steps=grad_accum_steps,
        shard_weight_update=shard_weight_update,
        flatten_optimizer_update=flatten_optimizer_update,
    )
    print_specification(model)
    os.makedirs(model_dir, exist_ok=True)
    _save_operative_config(model_dir)
    infeed_depth = infeed.resolve_depth(infeed_depth)
    if use_ema_for_eval is None:
        use_ema_for_eval = model.use_avg_model_params

    input_generator_train.set_specification_from_model(model, MODE_TRAIN)
    host_batches = iter(input_generator_train.create_dataset(MODE_TRAIN))
    eval_generators = normalize_eval_generators(input_generator_eval)
    for generator in eval_generators.values():
        generator.set_specification_from_model(model, MODE_EVAL)

    # The writer's sweep, before anything reads the directory: torn files
    # move to quarantine/, so the replayed steps re-save cleanly.
    for torn_name, torn_reason in durability.sweep_torn_checkpoints(model_dir):
        print(f"Quarantined torn checkpoint {torn_name!r}: {torn_reason}", flush=True)
    state = restore_or_init_state(
        model_dir, trainer, torch.Generator().manual_seed(seed)
    )
    start_step = state.step
    if start_step > 0:
        # Step k of a resumed run sees the batch step k of an
        # uninterrupted run saw: deterministic generators restart their
        # stream from batch 0, so skip the batches already consumed.
        host_batches = itertools.islice(host_batches, start_step, None)

    writer = MetricsWriter(os.path.join(model_dir, "train"))
    eval_writers = {
        name: MetricsWriter(os.path.join(model_dir, eval_dir_name(name)))
        for name in eval_generators
    }
    hooks: List[Hook] = []
    for builder in hook_builders or []:
        hooks.extend(builder.create_hooks(model, trainer=trainer))
    ctx = HookContext(model=model, model_dir=model_dir, step=start_step, state=state)
    exporters = (
        create_exporters_fn(model) if create_exporters_fn is not None else []
    )
    final_eval: Dict[str, float] = {}
    step = last_saved_step = last_log_step = start_step
    t_last = time.time()

    def log_metrics(metrics) -> Dict[str, float]:
        nonlocal t_last, last_log_step
        host = {k: float(v) for k, v in metrics.items() if v.ndim == 0}
        now = time.time()
        host["steps_per_sec"] = (step - last_log_step) / max(now - t_last, 1e-9)
        t_last, last_log_step = now, step
        writer.write(step, host)
        return host

    def after_steps(metrics, logged: bool) -> None:
        ctx.step, ctx.state, ctx.device_metrics = step, state, metrics
        ctx.metrics = log_metrics(metrics) if logged else None
        for hook in hooks:
            hook.after_step(ctx)

    def checkpoint_and_eval() -> Dict[str, float]:
        nonlocal last_saved_step
        state_lib.save_checkpoint(
            model_dir, step, state.network.state_dict(), state.ema_params,
            state.optimizer.state_dict(), keep_checkpoint_max,
        )
        durability.publish_durable(model_dir, step)
        last_saved_step = step
        ctx.checkpoint_path = state_lib.checkpoint_path(model_dir, step)
        for hook in hooks:
            hook.after_checkpoint_saved(ctx)
        eval_metrics = run_named_evals(
            trainer, state, eval_generators, eval_steps=eval_steps,
            use_ema=use_ema_for_eval, step=step, writers=eval_writers,
        )
        for exporter in exporters:
            exporter.maybe_export(
                step=step, state=state, eval_metrics=eval_metrics,
                compiled=trainer, model_dir=model_dir,
            )
        ctx.eval_metrics = eval_metrics
        for hook in hooks:
            hook.after_eval(ctx)
        return eval_metrics

    try:
        for hook in hooks:
            hook.on_train_begin(ctx)
        loop_sizes = _loop_sizes(step, max_train_steps, iterations_per_loop,
                                 save_checkpoints_steps)
        size = left = 0
        for batch in infeed.device_prefetch(
            host_batches, trainer.device, depth=infeed_depth
        ):
            if step >= max_train_steps:
                break
            if not left:
                size = left = next(loop_sizes)
                ctx.step = step
                for hook in hooks:
                    hook.before_step(ctx)
            # Never beside an export's tracing on a hook's thread.
            with TRACE_LOCK:
                metrics = trainer.train_step(state, batch)
            step, left = state.step, left - 1
            if left:
                continue
            after_steps(metrics, step % log_every_steps < size
                        or step == max_train_steps)
            if step % save_checkpoints_steps == 0 or step == max_train_steps:
                with TRACE_LOCK:
                    final_eval = checkpoint_and_eval()
        if left:
            # Host data ran out mid-loop: the hooks see the loop's end.
            after_steps(metrics, True)
        if step > last_saved_step:
            # Host data ran out mid-interval: keep the trained steps.
            with TRACE_LOCK:
                final_eval = checkpoint_and_eval()
    finally:
        for hook in hooks:
            hook.on_train_end(ctx)
        writer.close()
        for eval_writer in eval_writers.values():
            eval_writer.close()
        _save_operative_config(model_dir)
    return final_eval


def _loop_sizes(step: int, max_train_steps: int, iterations_per_loop: int,
                save_checkpoints_steps: int) -> Iterator[int]:
    """The steps of each loop from `step` on: iterations_per_loop, cut
    short at checkpoint steps so every checkpoint lands on its step."""
    while step < max_train_steps:
        boundary = min(max_train_steps,
                       (step // save_checkpoints_steps + 1) * save_checkpoints_steps)
        size = min(max(iterations_per_loop, 1), boundary - step)
        yield size
        step += size


def _save_operative_config(model_dir: str) -> None:
    """Writes `operative_config.gin`: what every configurable ran with."""
    try:
        config_lib.save_operative_config(model_dir)
    except OSError as err:
        logging.warning("Could not write operative config to %s: %s", model_dir, err)


def predict_from_model(
    t2r_model,
    input_generator,
    model_dir: str,
    device: Union[str, torch.device] = DEFAULT_DEVICE,
) -> Iterator[TensorSpecStruct]:
    """Restores the newest durable checkpoint (EMA parameters when the
    model keeps them) and yields each batch's export outputs as numpy."""
    model = maybe_wrap_for_tpu(t2r_model)
    trainer = Trainer(model, device=device)
    checkpoint = durability.load_newest_durable(model_dir)
    if checkpoint is None:
        raise FileNotFoundError(
            f"No checkpoint under {state_lib.checkpoint_dir(model_dir)!r} "
            "verifies; refusing to serve randomly initialized (or torn) "
            "weights. Use init_randomly on a predictor if that is intended."
        )
    input_generator.set_specification_from_model(model, MODE_PREDICT)
    params = checkpoint["params"]
    if model.use_avg_model_params and checkpoint["ema_params"] is not None:
        params = {**params, **checkpoint["ema_params"]}
    network = model.create_network()
    network.load_state_dict(params)
    network = network.to(trainer.device)
    for batch in infeed.device_prefetch(
        input_generator.create_dataset(MODE_PREDICT), trainer.device
    ):
        with torch.inference_mode():
            features, _ = trainer.preprocessor.preprocess(
                batch["features"], _batch_labels(batch), mode=MODE_PREDICT
            )
        outputs = trainer.predict_step(network, features)
        result = TensorSpecStruct()
        for key, value in outputs.items():
            result[key] = value.cpu().numpy()
        yield result
