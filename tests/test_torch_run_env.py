"""The port's episode runner and collect/eval loop against the JAX package's.

research/run_env.run_env and utils/continuous_collect_eval.collect_eval_loop
driven by both packages on the same seeded environments and policies give
the same per-episode rewards and the same replay layout (the shard names
and record counts under policy_collect/ and policy_eval/). Then the port's
whole PoseToyEnv loop on the CPU at a small size: random collect ->
train_eval_model from the records with the latest exporter ->
collect_eval_loop with a RegressionPolicy over the export.
"""

import functools
import glob
import os
import re

import numpy as np
import pytest
import torch

from tensor2robot_tpu.research import pose_env as jax_pose_env
from tensor2robot_tpu.research import run_env as jax_run_env
from tensor2robot_tpu.utils import continuous_collect_eval as jax_loop
from tensor2robot_tpu.utils import writer as jax_writer
from tensor2robot_tpu_torch.data.tfrecord import read_tfrecords
from tensor2robot_tpu_torch.policies import RegressionPolicy
from tensor2robot_tpu_torch.research import pose_env, run_env
from tensor2robot_tpu_torch.utils import continuous_collect_eval, writer

SHARD = re.compile(r"^gs(\d+)_\d{4}(-\d\d){5}-\d+\.tfrecord$")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _layout(root):
    """{relative dir: [(step, records) per shard]} under root."""
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "**", "*.tfrecord"), recursive=True)):
        match = SHARD.match(os.path.basename(path))
        assert match, path
        rel = os.path.relpath(os.path.dirname(path), root)
        out.setdefault(rel, []).append(
            (int(match.group(1)), len(list(read_tfrecords(path)))))
    return out


def _collect(pkg, run_env_module, writer_module, root, threshold=-1.5):
    return run_env_module.run_env(
        pkg.PoseToyEnv(seed=1), pkg.PoseEnvRandomPolicy(seed=2), num_episodes=6,
        episode_to_transitions_fn=functools.partial(
            pkg.episode_to_transitions_pose_toy, binary_success_threshold=threshold),
        replay_writer=writer_module.TFRecordReplayWriter(), output_dir=str(root),
        global_step=3)


def test_run_env_rewards_and_layout_match_jax(tmp_path):
    want = _collect(jax_pose_env, jax_run_env, jax_writer, tmp_path / "jax")
    got = _collect(pose_env, run_env, writer, tmp_path / "port")
    assert got == want and len(got) == 6
    assert _layout(tmp_path / "port") == _layout(tmp_path / "jax") == {".": [(3, 6)]}


class _ToyEnv:
    """1-D chase with the new-gym 5-tuple step: obs = [pos, target, 0]."""

    def __init__(self, horizon=5):
        self._horizon, self._t, self._pos = horizon, 0, 0.0

    def reset(self):
        self._t, self._pos = 0, 0.0
        return np.array([self._pos, 1.0, 0.0], np.float32), {}

    def step(self, action):
        self._pos += float(np.asarray(action).reshape(-1)[0]) * 0.1
        self._t += 1
        obs = np.array([self._pos, 1.0, 0.0], np.float32)
        return obs, -abs(self._pos - 1.0), self._t >= self._horizon, False, {}


class _Policy:
    """Action = 2 * obs[0] + 1, with an episode counter."""

    def __init__(self):
        self.resets = 0

    def reset(self):
        self.resets += 1

    def sample_action(self, obs, explore_prob):
        return np.array([2.0 * obs[0] + 1.0 + explore_prob], np.float32), {}


@pytest.mark.parametrize("max_steps", [None, 3])
def test_run_env_new_gym_and_explore_schedule_match_jax(max_steps):
    runs = []
    for module in (jax_run_env, run_env):
        policy = _Policy()
        episodes = []
        rewards = module.run_env(
            _ToyEnv(), policy, num_episodes=3, max_episode_steps=max_steps,
            explore_schedule=lambda step: 0.5 / (1 + step), global_step=1,
            on_episode_end=lambda i, t: episodes.append((i, len(t))))
        runs.append((rewards, episodes, policy.resets))
    assert runs[0] == runs[1]


def test_run_env_records_need_a_converter(tmp_path):
    with pytest.raises(ValueError, match="transition_to_record_fn"):
        run_env.run_env(_ToyEnv(), _Policy(), replay_writer=writer.TFRecordReplayWriter(),
                        output_dir=str(tmp_path))
    with pytest.raises(ValueError, match="replay_path or output_dir"):
        run_env.run_env(_ToyEnv(), _Policy(), replay_writer=writer.TFRecordReplayWriter(),
                        transition_to_record_fn=bytes)


def test_run_tfagents_env_matches_gym_path():
    import dataclasses

    @dataclasses.dataclass
    class _TimeStep:
        observation: np.ndarray
        reward: float
        last: bool

        def is_last(self):
            return self.last

    class _TfAgentsEnv:
        def __init__(self):
            self._env = _ToyEnv()

        def reset(self):
            return _TimeStep(self._env.reset()[0], None, False)

        def step(self, action):
            obs, reward, done, _, _ = self._env.step(action)
            return _TimeStep(obs, reward, done)

    assert (run_env.run_tfagents_env(_TfAgentsEnv(), _Policy(), num_episodes=2)
            == run_env.run_env(_ToyEnv(), _Policy(), num_episodes=2))


def _loop(pkg, run_env_module, writer_module, loop_module, root):
    rewards = []

    def run_agent_fn(env, policy, num_episodes, output_dir, global_step):
        rewards.append(_collect_into(pkg, run_env_module, writer_module, env, policy,
                                     num_episodes, output_dir, global_step))

    final = loop_module.collect_eval_loop(
        root_dir=str(root), policy=pkg.PoseEnvRandomPolicy(seed=4),
        run_agent_fn=run_agent_fn, collect_env=pkg.PoseToyEnv(seed=5),
        eval_env=pkg.PoseToyEnv(seed=6), num_collect=3, num_eval=2, max_steps=0,
        idle_sleep_secs=0.0)
    return final, rewards


def _collect_into(pkg, run_env_module, writer_module, env, policy, num_episodes,
                  output_dir, global_step):
    return run_env_module.run_env(
        env, policy, num_episodes=num_episodes,
        episode_to_transitions_fn=pkg.episode_to_transitions_pose_toy,
        replay_writer=writer_module.TFRecordReplayWriter(), output_dir=output_dir,
        global_step=global_step)


def test_collect_eval_loop_matches_jax(tmp_path):
    want = _loop(jax_pose_env, jax_run_env, jax_writer, jax_loop, tmp_path / "jax")
    got = _loop(pose_env, run_env, writer, continuous_collect_eval, tmp_path / "port")
    assert got == want and got[0] == 0 and [len(r) for r in got[1]] == [3, 2]
    layout = {"policy_collect": [(0, 3)], "policy_eval": [(0, 2)]}
    assert _layout(tmp_path / "port") == _layout(tmp_path / "jax") == layout


def test_collect_eval_loop_idles_until_the_learner_moves(tmp_path):
    class _Stuck:
        global_step = 7

        def restore(self, is_async=False):
            return True

    calls = []
    final = continuous_collect_eval.collect_eval_loop(
        root_dir=str(tmp_path), policy=_Stuck(),
        run_agent_fn=lambda env, **kwargs: calls.append(kwargs["global_step"]),
        collect_env=object(), num_collect=1, max_steps=100, idle_sleep_secs=0.0,
        max_cycles=3)
    assert final == 7 and calls == [7]


def test_pose_loop_on_the_cpu(tmp_path):
    """Random collect -> train (latest exports) -> one collect_eval_loop
    cycle through a RegressionPolicy over the export, whose global step
    is the export's."""
    from tensor2robot_tpu_torch.data.input_generators import DefaultRecordInputGenerator
    from tensor2robot_tpu_torch.export import LatestExporter
    from tensor2robot_tpu_torch.predictors import ExportedSavedModelPredictor
    from tensor2robot_tpu_torch.train.train_eval import train_eval_model

    collect = tmp_path / "collect"
    _collect(pose_env, run_env, writer, collect)
    records = glob.glob(str(collect / "*.tfrecord"))
    model_dir = tmp_path / "model"
    train_eval_model(
        pose_env.PoseEnvRegressionModel(device_type="cpu"),
        DefaultRecordInputGenerator(file_patterns=records, batch_size=2, seed=0,
                                    num_parse_workers=0),
        model_dir=str(model_dir), max_train_steps=2, save_checkpoints_steps=2,
        eval_steps=None, create_exporters_fn=lambda model: [LatestExporter("latest")],
        device="cpu")
    predictor = ExportedSavedModelPredictor(
        str(model_dir / "export" / "latest"), timeout=0, device="cpu")
    policy = RegressionPolicy(predictor)
    rewards = []
    final = continuous_collect_eval.collect_eval_loop(
        root_dir=str(tmp_path / "robot"), policy=policy,
        run_agent_fn=lambda env, policy, num_episodes, output_dir, global_step:
        rewards.extend(run_env.run_env(env, policy, num_episodes=num_episodes)),
        eval_env=pose_env.PoseToyEnv(seed=9), num_eval=3, max_steps=2,
        idle_sleep_secs=0.0)
    assert final == 2 == predictor.global_step
    assert predictor.loaded_model.has_program
    assert len(rewards) == 3 and np.all(np.isfinite(rewards))
