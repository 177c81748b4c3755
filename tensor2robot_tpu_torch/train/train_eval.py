"""The trainer: train, evaluate, checkpoint and predict a T2RModel.

Port of tensor2robot_tpu/train/train_eval.py on one device. `Trainer` is
the counterpart of the JAX package's CompiledModel: the model's hooks as
train, eval and predict steps over a TrainState, in the same order
(preprocess, packed inference, model_train_fn, backward, optimizer, EMA).
PyTorch runs eagerly, so nothing is compiled; on the card the transformer's
attention runs the flash kernels (B1 forward and B3+B4 backward under
autograd, B2 under inference_mode in eval and predict).

`train_eval_model` is the entry point: it resumes from the newest
checkpoint under `<model_dir>/checkpoints/` (skipping the batches the
restored steps consumed), logs scalars to `<model_dir>/train/
metrics.jsonl`, checkpoints every `save_checkpoints_steps` and evaluates
each named eval set into `<model_dir>/eval[_<name>]/metrics.jsonl`.

Regimes not ported raise NotImplementedError naming their ROADMAP.md item:
mesh / plan / weight-update sharding / flattened optimizer update (A14),
remat, gradient accumulation and multi-step loops (A9), hooks and
exporters (A12, A3).
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Any, Dict, Iterator, Optional, Union

import torch

from tensor2robot_tpu_torch.models.abstract_model import (
    MODE_EVAL,
    MODE_PREDICT,
    MODE_TRAIN,
)
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.train import infeed
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train.metrics import MetricsWriter
from tensor2robot_tpu_torch.train.state import TrainState, init_ema, update_ema
from tensor2robot_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def _reject_unported(
    mesh=None, plan=None, remat=False, grad_accum_steps=1,
    shard_weight_update=False, flatten_optimizer_update=False,
    iterations_per_loop=1, hook_builders=None, create_exporters_fn=None,
) -> None:
    if (mesh is not None or plan is not None or shard_weight_update
            or flatten_optimizer_update):
        raise NotImplementedError(
            "mesh, plan, shard_weight_update and flatten_optimizer_update "
            "are not ported yet (ROADMAP.md A14)"
        )
    if remat or grad_accum_steps > 1 or iterations_per_loop > 1:
        raise NotImplementedError(
            "remat, grad_accum_steps > 1 and iterations_per_loop > 1 are "
            "not ported yet (ROADMAP.md A9)"
        )
    if hook_builders:
        raise NotImplementedError("hook_builders are not ported yet (ROADMAP.md A12)")
    if create_exporters_fn is not None:
        raise NotImplementedError(
            "create_exporters_fn is not ported yet (ROADMAP.md A3)"
        )


def _batch_labels(batch):
    """The batch's labels subtree, or None for label-less models."""
    try:
        return batch["labels"]
    except KeyError:
        return None


class Trainer:
    """The model's hooks as steps over a TrainState on one device."""

    def __init__(
        self,
        model,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
        mesh=None,
        plan=None,
        remat: bool = False,
        grad_accum_steps: int = 1,
        shard_weight_update: bool = False,
        flatten_optimizer_update: bool = False,
    ):
        _reject_unported(
            mesh=mesh, plan=plan, remat=remat,
            grad_accum_steps=grad_accum_steps,
            shard_weight_update=shard_weight_update,
            flatten_optimizer_update=flatten_optimizer_update,
        )
        self.model = model
        self.device = resolve_device(device)
        self.preprocessor = model.preprocessor
        self.optimizer_factory = model.create_optimizer()
        self._ema_network: Optional[torch.nn.Module] = None

    def init_state(
        self,
        generator: Optional[torch.Generator] = None,
        params: Optional[Dict[str, torch.Tensor]] = None,
    ) -> TrainState:
        """A fresh TrainState: weights drawn from `generator` (seed 0 when
        None), or the given state dict (e.g. converted flax params)."""
        if params is None:
            network = self.model.init_network(generator, self.device)
        else:
            network = self.model.create_network()
            network.load_state_dict(params)
            network = network.to(self.device)
        ema = init_ema(network) if self.model.use_avg_model_params else None
        optimizer = self.optimizer_factory(network.parameters())
        return TrainState(step=0, network=network, optimizer=optimizer,
                          ema_params=ema)

    def forward_loss(self, network, batch):
        """(loss, train metrics) of a device batch in train mode."""
        features, labels = self.preprocessor.preprocess(
            batch["features"], _batch_labels(batch), mode=MODE_TRAIN
        )
        f, l, outputs, _ = self.model.packed_inference(
            network, features, MODE_TRAIN, labels=labels
        )
        return self.model.model_train_fn(f, l, outputs, MODE_TRAIN)

    def train_step(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """One update of `state` in place from a device batch; returns the
        step's metrics as device scalars (no host sync)."""
        state.network.train()
        loss, train_metrics = self.forward_loss(state.network, batch)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        if state.ema_params is not None:
            state.ema_params = update_ema(
                state.ema_params, state.params(),
                self.model.avg_model_params_decay,
            )
        state.step += 1
        metrics = {"loss": loss.detach()}
        metrics.update({k: v.detach() for k, v in train_metrics.items()})
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
    """The newest checkpoint under model_dir, or a fresh state."""
    state = trainer.init_state(generator)
    if state_lib.latest_checkpoint_step(model_dir) is not None:
        state.restore(state_lib.load_checkpoint(model_dir, map_location=trainer.device))
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
    the newest checkpoint in model_dir if there is one."""
    _reject_unported(
        iterations_per_loop=iterations_per_loop, hook_builders=hook_builders,
        create_exporters_fn=create_exporters_fn,
    )
    if input_generator_train is None:
        raise ValueError("train_eval_model requires input_generator_train.")
    trainer = Trainer(
        t2r_model, device=device, mesh=mesh, plan=plan,
        remat=remat, grad_accum_steps=grad_accum_steps,
        shard_weight_update=shard_weight_update,
        flatten_optimizer_update=flatten_optimizer_update,
    )
    os.makedirs(model_dir, exist_ok=True)
    infeed_depth = infeed.resolve_depth(infeed_depth)
    if use_ema_for_eval is None:
        use_ema_for_eval = t2r_model.use_avg_model_params

    input_generator_train.set_specification_from_model(t2r_model, MODE_TRAIN)
    host_batches = iter(input_generator_train.create_dataset(MODE_TRAIN))
    eval_generators = normalize_eval_generators(input_generator_eval)
    for generator in eval_generators.values():
        generator.set_specification_from_model(t2r_model, MODE_EVAL)

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
    final_eval: Dict[str, float] = {}
    step = last_saved_step = last_log_step = start_step
    t_last = time.time()

    def log_metrics(metrics) -> None:
        nonlocal t_last, last_log_step
        host = {k: float(v) for k, v in metrics.items() if v.ndim == 0}
        now = time.time()
        host["steps_per_sec"] = (step - last_log_step) / max(now - t_last, 1e-9)
        t_last, last_log_step = now, step
        writer.write(step, host)

    def checkpoint_and_eval() -> Dict[str, float]:
        nonlocal last_saved_step
        state_lib.save_checkpoint(
            model_dir, step, state.network.state_dict(), state.ema_params,
            state.optimizer.state_dict(), keep_checkpoint_max,
        )
        last_saved_step = step
        return run_named_evals(
            trainer, state, eval_generators, eval_steps=eval_steps,
            use_ema=use_ema_for_eval, step=step, writers=eval_writers,
        )

    try:
        for batch in infeed.device_prefetch(
            host_batches, trainer.device, depth=infeed_depth
        ):
            if step >= max_train_steps:
                break
            metrics = trainer.train_step(state, batch)
            step = state.step
            if step % log_every_steps == 0 or step == max_train_steps:
                log_metrics(metrics)
            if step % save_checkpoints_steps == 0 or step == max_train_steps:
                final_eval = checkpoint_and_eval()
        if step > last_saved_step:
            # Host data ran out mid-interval: keep the trained steps.
            final_eval = checkpoint_and_eval()
    finally:
        writer.close()
        for eval_writer in eval_writers.values():
            eval_writer.close()
    return final_eval


def predict_from_model(
    t2r_model,
    input_generator,
    model_dir: str,
    device: Union[str, torch.device] = DEFAULT_DEVICE,
) -> Iterator[TensorSpecStruct]:
    """Restores the newest checkpoint (EMA parameters when the model keeps
    them) and yields each batch's export outputs as numpy."""
    step = state_lib.latest_checkpoint_step(model_dir)
    if step is None:
        raise FileNotFoundError(
            f"No checkpoint under {state_lib.checkpoint_dir(model_dir)!r}; "
            "refusing to serve randomly initialized weights. Use "
            "init_randomly on a predictor if that is intended."
        )
    trainer = Trainer(t2r_model, device=device)
    input_generator.set_specification_from_model(t2r_model, MODE_PREDICT)
    checkpoint = state_lib.load_checkpoint(model_dir, step)
    params = checkpoint["params"]
    if t2r_model.use_avg_model_params and checkpoint["ema_params"] is not None:
        params = {**params, **checkpoint["ema_params"]}
    network = t2r_model.create_network()
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
