"""Streaming (KV-cache) serving exports for the transformer BC family.

Port of tensor2robot_tpu/export/streaming.py. The standard export
(saved_model.py) holds the FULL-episode predict: right for offline
scoring, wasteful in a robot control loop that adds one observation per
tick. This module exports the incremental step itself:

    step(cache, image, pose) -> (action, new_cache)

as a torch.export program (the weights inside) beside the zeroed cache,
so a robot host streams actions from the export alone, with no model
code and O(attention_window) attention per tick
(models/transformer_models.StreamingBCPolicy is the in-process twin of the
loaded policy here). The cache is a flat dict of tensors keyed by the
flax "cache" collection's paths ('encoder/block_0/attention/cached_key',
..., 'encoder/position').

Layout of an export directory:

    streaming_metadata.json        shapes, capacity, window (the JAX
                                   keys), cache keys, torch version
    cache_template.pt              the zeroed cache (episode start)
    program/stream_fn.pt2          torch.export of the step

`StreamingStepRunner` drives either step over static device buffers: on
the card each tick is one CUDA graph replay.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch.export.aot import load_exported
from tensor2robot_tpu_torch.export.saved_model import TRACE_LOCK
from tensor2robot_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

STREAM_METADATA_FILENAME = "streaming_metadata.json"
STREAM_CACHE_FILENAME = "cache_template.pt"
STREAM_PROGRAM_DIR = "program"
STREAM_FN_FILENAME = "stream_fn.pt2"

StepFn = Callable[
    [Dict[str, torch.Tensor], torch.Tensor, torch.Tensor],
    Tuple[torch.Tensor, Dict[str, torch.Tensor]],
]


class StreamingStepRunner:
    """Runs `step(cache, image, pose) -> (action, new_cache)` over static
    device buffers for the image [B, 1, H, W, 3], the pose [B, 1, P] and
    the cache, writing the new cache back into its buffers.

    graph: None = a CUDA graph on the card and eager steps on the CPU;
    False = eager steps on the card too (a yardstick); True off the card
    raises. The graph is captured at the first step (warm-up on a side
    stream, then one capture; a capture that fails raises) and replayed
    once per step after that.

    Counters: graph_builds, graph_replays, eager_steps.
    """

    def __init__(
        self,
        step_fn: StepFn,
        cache_template: Mapping[str, torch.Tensor],
        batch_size: int,
        image_shape: Tuple[int, ...],
        pose_size: int,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
        graph: Optional[bool] = None,
    ):
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        if graph and not on_card:
            raise ValueError(f"a CUDA graph needs the card, not {self.device}")
        self._use_graph = on_card if graph is None else graph
        self._step_fn = step_fn
        self._cache = {
            key: value.to(self.device).clone()
            for key, value in cache_template.items()
        }
        self._image = torch.zeros(
            (batch_size, 1) + tuple(image_shape), dtype=torch.float32,
            device=self.device,
        )
        self._pose = torch.zeros(
            (batch_size, 1, pose_size), dtype=torch.float32, device=self.device
        )
        self._graph = None
        self._graph_action: Optional[torch.Tensor] = None
        self.graph_builds = 0
        self.graph_replays = 0
        self.eager_steps = 0

    def reset(self) -> None:
        """Starts a new episode: zeroes the cache buffers in place (the
        graph reads the same buffers)."""
        for value in self._cache.values():
            value.zero_()

    def _run(self) -> torch.Tensor:
        with torch.no_grad():
            action, new_cache = self._step_fn(self._cache, self._image, self._pose)
            for key, value in new_cache.items():
                self._cache[key].copy_(value)
        return action

    def _capture(self) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._run()
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            action = self._run()
        self._graph, self._graph_action = graph, action
        self.graph_builds += 1
        self.reset()  # the warm-up steps advanced the cache

    def step(self, image, gripper_pose) -> np.ndarray:
        """One control tick: [B?, H, W, 3] image + [B?, P] pose -> [B, A]
        action for THIS step (the batch dim optional at batch 1)."""
        image = np.asarray(image, np.float32)
        pose = np.asarray(gripper_pose, np.float32)
        self._image.copy_(
            torch.from_numpy(np.ascontiguousarray(image)).reshape(self._image.shape)
        )
        self._pose.copy_(
            torch.from_numpy(np.ascontiguousarray(pose)).reshape(self._pose.shape)
        )
        if self._use_graph:
            if self._graph is None:
                self._capture()
            self._graph.replay()
            self.graph_replays += 1
            action = self._graph_action
        else:
            action = self._run()
            self.eager_steps += 1
        return action.cpu().numpy()


class _StepModule(nn.Module):
    """The decode network's step as a module for torch.export."""

    def __init__(self, network: nn.Module):
        super().__init__()
        self.network = network

    def forward(self, cache, image, pose):
        return self.network.decode_step(cache, image, pose)


def save_streaming_export(
    export_dir: str,
    model,
    state_dict: Mapping[str, torch.Tensor],
    batch_size: int = 1,
) -> str:
    """Writes the model's incremental step into `export_dir`.

    The batch size is fixed at export time (a control loop serves a known
    batch, usually 1); episode capacity and window come from the model
    (`episode_length`, `attention_window`). The step is traced on the
    device the weights lie on, under torch.no_grad() and TRACE_LOCK
    (torch.export flips a process-wide flag while it traces); a loader
    on another device moves it.
    """
    os.makedirs(os.path.join(export_dir, STREAM_PROGRAM_DIR), exist_ok=True)
    device = next(iter(state_dict.values())).device
    network = model.create_network(decode=True).to(device)
    network.load_state_dict(state_dict)
    network.eval()
    cache = network.init_cache(batch_size)
    image_shape = tuple(model._image_size) + (3,)
    example = (
        cache,
        torch.zeros((batch_size, 1) + image_shape, device=device),
        torch.zeros((batch_size, 1, model._pose_size), device=device),
    )
    with TRACE_LOCK, torch.no_grad():
        program = torch.export.export(_StepModule(network), example)
    program.example_inputs = None
    torch.export.save(
        program, os.path.join(export_dir, STREAM_PROGRAM_DIR, STREAM_FN_FILENAME)
    )
    torch.save(
        {key: value.cpu() for key, value in cache.items()},
        os.path.join(export_dir, STREAM_CACHE_FILENAME),
    )
    with open(os.path.join(export_dir, STREAM_METADATA_FILENAME), "w") as f:
        json.dump(
            {
                "batch_size": batch_size,
                "image_shape": list(image_shape),
                "pose_size": model._pose_size,
                "episode_capacity": max(model._episode_length, 8),
                "attention_window": model._attention_window,
                "cache_keys": sorted(cache),
                "program_device": str(device),
                "torch_version": torch.__version__,
            },
            f, indent=2, sort_keys=True,
        )
    return export_dir


def is_streaming_export(path: str) -> bool:
    return os.path.isfile(os.path.join(path, STREAM_METADATA_FILENAME))


class StreamingExportedPolicy(StreamingStepRunner):
    """A robot-side control-loop policy loaded from a streaming export with
    no model code (torch.export.load, moved to `device`); on the card each
    tick is one CUDA graph replay of the loaded step. reset() starts an
    episode; step(image, pose) returns this tick's action."""

    def __init__(
        self,
        export_dir: str,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
        graph: Optional[bool] = None,
    ):
        import torch.export.passes

        device = resolve_device(device)
        with open(os.path.join(export_dir, STREAM_METADATA_FILENAME)) as f:
            self.metadata = json.load(f)
        cache = torch.load(
            os.path.join(export_dir, STREAM_CACHE_FILENAME),
            map_location="cpu", weights_only=True,
        )
        program = load_exported(
            os.path.join(export_dir, STREAM_PROGRAM_DIR, STREAM_FN_FILENAME)
        )
        if self.metadata["program_device"] != str(device):
            program = torch.export.passes.move_to_device_pass(program, device)
        super().__init__(
            program.module(), cache, self.metadata["batch_size"],
            tuple(self.metadata["image_shape"]), self.metadata["pose_size"],
            device=device, graph=graph,
        )
