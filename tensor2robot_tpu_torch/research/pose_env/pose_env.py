"""PoseToyEnv: the minimal end-to-end testbed environment.

Port of tensor2robot_tpu/research/pose_env/pose_env.py, host numpy with
its RandomState draws in the same order, so a seeded rollout replays the
JAX package's golden trace (tests/golden/pose_env_golden_trace.npz) bit
for bit. Task: an object sits at a random planar pose; the observation is
a rendered 64x64 image; the (single step) action is the predicted (x, y);
reward = -||action - target_xy||; with `hidden_drift` each task offsets
the rendered pose by a hidden amount, so only meta-adaptation can close
the gap. Rendering is a numpy rasterizer (an oriented ellipse with a nose
marker on a striped ground, camera yaw randomized per task).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from tensor2robot_tpu_torch.config import configurable


@configurable("PoseEnvRandomPolicy")
class PoseEnvRandomPolicy:
    """Uniform-random pose guesses, used for dataset generation."""

    def __init__(self, seed: Optional[int] = None):
        self._rng = np.random.RandomState(seed)

    def reset(self):
        pass

    def reset_task(self):
        pass

    def restore(self, is_async: bool = False) -> bool:
        """No weights to restore; always ready (collect_eval_loop
        polls this before each cycle)."""
        del is_async
        return True

    def init_randomly(self) -> None:
        pass

    def close(self) -> None:
        pass

    @property
    def global_step(self) -> int:
        return 0

    def sample_action(self, obs, explore_prob):
        del obs, explore_prob
        return self._rng.uniform(low=-1.0, high=1.0, size=2), None


@configurable("PoseToyEnv")
class PoseToyEnv:
    """Predict object pose from an image.

    Episodes are one step: reset() -> observation image; step(pose) ->
    (observation, reward, done=True, {'target_pose': xy}).
    """

    WIDTH, HEIGHT = 64, 64

    def __init__(
        self,
        render_mode: str = "DIRECT",
        hidden_drift: bool = False,
        seed: Optional[int] = None,
    ):
        del render_mode  # Headless always; kept for config parity.
        self._rng = np.random.RandomState(seed)
        self._hidden_drift = hidden_drift
        self._hidden_drift_xy = np.zeros(2, np.float32)
        self._camera_yaw = 0.0
        self._ground_phase = 0.0
        self.reset_task()

    # -- task structure ------------------------------------------------------

    def reset_task(self) -> None:
        """New camera + (optionally) new hidden drift."""
        self._camera_yaw = self._rng.uniform(-np.pi, np.pi)
        self._ground_phase = self._rng.uniform(0, 2 * np.pi)
        if self._hidden_drift:
            self._hidden_drift_xy = self._rng.uniform(
                low=-0.3, high=0.3, size=2
            ).astype(np.float32)
        self.set_new_pose()

    def set_new_pose(self) -> None:
        """Samples the rendered pose; with hidden_drift the *label* pose is
        offset from what is rendered (the drift is added to the target
        after the object is placed at the raw pose)."""
        self._rendered_pose = self._sample_pose()
        self._target_pose = self._rendered_pose.copy()
        if self._hidden_drift:
            self._target_pose[:2] += self._hidden_drift_xy

    def _sample_pose(self) -> np.ndarray:
        x = self._rng.uniform(low=-0.7, high=0.7)
        y = self._rng.uniform(low=-0.4, high=0.4)
        angle = self._rng.uniform(low=-np.pi, high=np.pi)
        return np.array([x, y, angle], np.float32)

    # -- rendering -----------------------------------------------------------

    def _render(self) -> np.ndarray:
        """64x64x3 uint8 image of the object at (possibly drifted) pose."""
        x, y, angle = self._rendered_pose
        # Rotate world by the per-task camera yaw.
        c, s = np.cos(self._camera_yaw), np.sin(self._camera_yaw)
        cam_x = c * x - s * y
        cam_y = s * x + c * y

        h, w = self.HEIGHT, self.WIDTH
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        # World [-1, 1] box -> pixels.
        px = (cam_x + 1.0) * (w - 1) / 2.0
        py = (cam_y + 1.0) * (h - 1) / 2.0

        # Ground: task-dependent striped texture (stands in for the table).
        ground = 96 + 32 * np.sin(
            0.25 * (xs * c + ys * s) + self._ground_phase
        )
        image = np.stack([ground * 0.9, ground, ground * 1.1], axis=-1)

        # Object: oriented ellipse with a nose marker encoding the angle.
        obj_angle = angle + self._camera_yaw
        ca, sa = np.cos(obj_angle), np.sin(obj_angle)
        dx, dy = xs - px, ys - py
        u = ca * dx + sa * dy
        v = -sa * dx + ca * dy
        body = (u / 7.0) ** 2 + (v / 4.5) ** 2 <= 1.0
        nose = ((u - 6.0) / 2.5) ** 2 + (v / 2.0) ** 2 <= 1.0
        image[body] = (230.0, 200.0, 40.0)
        image[nose] = (240.0, 120.0, 30.0)
        return np.clip(image, 0, 255).astype(np.uint8)

    def get_observation(self) -> np.ndarray:
        return self._render()

    # -- episode API ---------------------------------------------------------

    def reset(self) -> np.ndarray:
        return self.get_observation()

    def step(self, action) -> Tuple[np.ndarray, float, bool, dict]:
        reward = float(
            -np.linalg.norm(np.asarray(action) - self._target_pose[:2])
        )
        done = True
        debug = {"target_pose": self._target_pose[:2].astype(np.float32)}
        observation = self.get_observation()
        return observation, reward, done, debug
