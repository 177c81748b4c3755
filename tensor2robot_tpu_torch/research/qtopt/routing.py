"""Recording and pinning the gradient routing of the Grasping44 tower.

A relu passes a unit's gradient or stops it by the sign of its input, and
a max pool sends a window's gradient to the elements equal to its maximum
(ops/pooling.py's equal split). Both choices jump: two float32 runs whose
activations differ in the last bits (two devices summing a conv in other
orders, or float32 against float64) take a few of them the other way, and
at full width the weight gradients then differ by percents of their max.
Neither run is wrong: each is the gradient of its own choices. To hold
one run's gradients against another's, record the choices of the first
and replay them in the second:

    with record_routing() as routing:
        loss_a = ...; loss_a.backward()
    with pinned_routing(routing.to("cpu")):
        loss_b = ...; loss_b.backward()   # every relu and pool as in run a

Pinning changes no forward value beyond the units whose sign differs (a
pinned relu is x * mask, a pinned pool returns the window maxima).

    python -m tensor2robot_tpu_torch.research.qtopt.routing \\
        --image-size 472 --num-convs 6,6,3 --batch 2 --device cpu

prints how far the critic's float32 gradients lie from float64's with
nothing pinned, with the relus pinned, with the pools pinned and with
both, each pinned to the float64 run's choices.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from tensor2robot_tpu_torch.ops import pooling
from tensor2robot_tpu_torch.research.qtopt import networks


@dataclasses.dataclass
class Routing:
    """Each relu's mask (input > 0) and each pool's (mask, count), in the
    order the forward called them."""

    relus: List[torch.Tensor] = dataclasses.field(default_factory=list)
    pools: List[Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default_factory=list)

    def to(self, device) -> "Routing":
        return Routing([m.to(device) for m in self.relus],
                       [(m.to(device), c.to(device)) for m, c in self.pools])

    def differences(self, other: "Routing") -> Tuple[int, int]:
        """(relu units, pool windows) whose choice differs from other's."""
        relus = sum(int((a.cpu() != b.cpu()).sum())
                    for a, b in zip(self.relus, other.relus))
        pools = sum(int((a.cpu() != b.cpu()).any(dim=(3, 5)).sum())
                    for (a, _), (b, _) in zip(self.pools, other.pools))
        return relus, pools


class _PinnedMaxPool(torch.autograd.Function):
    """The window maxima, with the gradient split over a recorded mask."""

    @staticmethod
    def forward(ctx, x, mask, count, window, padding):
        ctx.save_for_backward(mask, count)
        ctx.x_shape, ctx.window, ctx.padding = x.shape, window, padding
        return pooling.max_pool(x.detach(), window, padding)

    @staticmethod
    def backward(ctx, g):
        mask, count = ctx.saved_tensors
        gx = pooling.route_gradient(g, mask, count, ctx.x_shape, ctx.window,
                                    ctx.padding)
        return gx, None, None, None, None


class _Namespace:
    """`module` with some attributes replaced."""

    def __init__(self, module, **overrides):
        self._module = module
        self.__dict__.update(overrides)

    def __getattr__(self, name):
        return getattr(self._module, name)


@contextlib.contextmanager
def _tower_ops(relu, max_pool):
    saved = networks.F, networks.pooling
    networks.F = _Namespace(F, relu=relu)
    networks.pooling = _Namespace(pooling, max_pool=max_pool)
    try:
        yield
    finally:
        networks.F, networks.pooling = saved


def _norm_window(window, padding):
    return (int(window[0]), int(window[1])), padding.upper()


@contextlib.contextmanager
def record_routing():
    """Yields a Routing that every relu and pool of a Grasping44 forward
    inside fills; the ops themselves are the port's."""
    if pooling.resolve_backward_mode() == "native":
        raise ValueError("routing records the equal-split pool backward; "
                         "T2R_POOL_BACKWARD=native routes otherwise")
    routing = Routing()

    def relu(x, *args, **kwargs):
        routing.relus.append(x.detach() > 0)
        return F.relu(x, *args, **kwargs)

    def max_pool(x, window, padding="SAME"):
        window, padding = _norm_window(window, padding)
        routing.pools.append(pooling.tie_routing(x.detach(), window, padding))
        return pooling.max_pool(x, window, padding)

    with _tower_ops(relu, max_pool):
        yield routing


@contextlib.contextmanager
def pinned_routing(routing: Routing, relus: bool = True, pools: bool = True):
    """Inside, the relus (and/or pools) of a Grasping44 forward route
    their gradients as `routing` recorded, call by call."""
    relu_masks, pool_masks = iter(routing.relus), iter(routing.pools)

    def take(recorded, what):
        choice = next(recorded, None)
        if choice is None:
            raise ValueError(f"the forward made more {what} calls than were "
                             "recorded")
        return choice

    def relu(x, *args, **kwargs):
        mask = take(relu_masks, "relu")
        return x * mask.to(x.dtype) if relus else F.relu(x, *args, **kwargs)

    def max_pool(x, window, padding="SAME"):
        window, padding = _norm_window(window, padding)
        mask, count = take(pool_masks, "pool")
        if not pools:
            return pooling.max_pool(x, window, padding)
        return _PinnedMaxPool.apply(x, mask, count, window, padding)

    with _tower_ops(relu, max_pool):
        yield
    if next(relu_masks, None) is not None or next(pool_masks, None) is not None:
        raise ValueError("the forward made fewer relu or pool calls than "
                         "were recorded")


# -- the diagnostic ---------------------------------------------------------------


def critic_gradients(model, params, batch, dtype, device):
    """One train-mode forward and backward of the critic on `batch`
    (center crop, no distortion) in `dtype`: the loss, every parameter's
    gradient and every batch-norm statistic it leaves, as float64 tensors
    on the CPU."""
    from tensor2robot_tpu_torch.specs import TensorSpecStruct
    from tensor2robot_tpu_torch.train.infeed import to_device
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    trainer = Trainer(model, device=device)
    network = trainer.init_state(params=params).network.to(dtype)
    on_device = to_device(batch, device)
    features, labels = trainer.preprocessor.preprocess(
        on_device["features"], on_device["labels"], mode="train")
    features, labels = (TensorSpecStruct({k: v.to(dtype) for k, v in t.items()})
                        for t in (features, labels))
    loss, _ = model.model_train_fn(
        features, labels, network(features, "train"), "train")
    loss.backward()
    grads = {n: p.grad.double().cpu() for n, p in network.named_parameters()}
    stats = {k: v.double().cpu() for k, v in network.state_dict().items()
             if k.endswith((".mean", ".var"))}
    return loss.item(), grads, stats


def worst_gap(grads, reference) -> Tuple[float, str]:
    """The largest max|g - ref| / max|ref| over the parameters, leaving
    out those whose gradient is 0 in exact arithmetic (a bias before a
    batch norm: its reference is below 1e-6 of the largest one)."""
    scales = {n: r.abs().max().item() for n, r in reference.items()}
    floor = 1e-6 * max(scales.values())
    return max(((g - reference[n]).abs().max().item() / scales[n], n)
               for n, g in grads.items() if scales[n] > floor)


def main(argv=None) -> None:
    from tensor2robot_tpu_torch.data.input_generators import (
        DefaultRandomInputGenerator,
    )
    from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
        Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom as Critic,
    )
    from tensor2robot_tpu_torch.train.train_eval import Trainer

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--image-size", type=int, default=472)
    parser.add_argument("--num-convs", default="6,6,3")
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--no-cudnn", action="store_true",
                        help="convolve with PyTorch's own CUDA kernels")
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.enabled = not args.no_cudnn
    size = (args.image_size, args.image_size)
    model = Critic(batch_size=args.batch, image_size=size, width=64,
                   num_convs=tuple(int(n) for n in args.num_convs.split(",")))
    params = Trainer(model, device=args.device).init_state(
        torch.Generator().manual_seed(args.seed)).network.state_dict()
    generator = DefaultRandomInputGenerator(batch_size=args.batch, seed=args.seed)
    generator.set_specification_from_model(model, "train")
    batch = next(iter(generator.create_dataset("train")))

    def run(dtype, **pins):
        context = (record_routing() if not pins
                   else pinned_routing(exact_routing, **pins))
        with context as routing:
            loss, grads, _ = critic_gradients(model, params, batch, dtype,
                                              args.device)
        return loss, grads, routing

    exact_loss, exact, exact_routing = run(torch.float64)
    loss, grads, routing = run(torch.float32)
    relus, pools = routing.differences(exact_routing)
    convs = "PyTorch's" if args.no_cudnn else "cuDNN's"
    print(f"critic {size} {args.num_convs} batch {args.batch} on {args.device} "
          f"({convs} convs where CUDA): "
          f"float32 takes {relus} of {sum(m.numel() for m in routing.relus)} "
          f"relu units and {pools} of {sum(c.numel() for _, c in routing.pools)} "
          f"pool windows the other way from float64")
    for label, pins in (("nothing pinned", None),
                        ("relus pinned", dict(relus=True, pools=False)),
                        ("pools pinned", dict(relus=False, pools=True)),
                        ("relus and pools pinned", dict(relus=True, pools=True))):
        if pins is not None:
            loss, grads, _ = run(torch.float32, **pins)
        gap, name = worst_gap(grads, exact)
        print(f"  float32 vs float64, {label}: loss rel "
              f"{abs(loss - exact_loss) / abs(exact_loss):.3e}; worst gradient "
              f"{name} at {gap:.3e} of its max")


if __name__ == "__main__":
    main()
