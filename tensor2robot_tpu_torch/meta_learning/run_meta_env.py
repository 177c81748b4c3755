"""Task-structured environment loop for meta-learning collect/eval.

Port of tensor2robot_tpu/meta_learning/run_meta_env.py, host Python. Per
task: gather conditioning demos (from a demo policy, or task data the env
provides), adapt the policy, run episodes, re-adapt on everything
collected so far, and track reward by adaptation step: the curve that
shows whether fast adaptation works. Episodes stream to a replay writer as
transition records; the per-step reward and improvement statistics land
in the metrics stream (train/metrics.MetricsWriter).
"""

from __future__ import annotations

import collections
import copy
import inspect
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from tensor2robot_tpu_torch.config import configurable
from tensor2robot_tpu_torch.train.metrics import MetricsWriter
from tensor2robot_tpu_torch.utils import writer as writer_lib


def _convert_episode(episode_to_transitions_fn, episode_data, is_demo=None):
    """Runs the converter, passing is_demo only to converters that take it
    (the VRGripper-style fns do; the meta converters read debug['is_demo']
    themselves), and serializes the outputs for the replay writer."""
    kwargs = {}
    if is_demo is not None:
        try:
            parameters = inspect.signature(
                episode_to_transitions_fn
            ).parameters
            if "is_demo" in parameters or any(
                p.kind == inspect.Parameter.VAR_KEYWORD
                for p in parameters.values()
            ):
                kwargs["is_demo"] = is_demo
        except (TypeError, ValueError):
            pass
    return writer_lib.serialize_transition_records(
        episode_to_transitions_fn(episode_data, **kwargs)
    )


def _run_demo_episode(env, demo_policy) -> List[tuple]:
    """Rolls out a demonstration; the demo policy signals the end by
    returning action None."""
    obs = env.reset()
    episode_data = []
    while True:
        action, debug = demo_policy.sample_action(obs, 0)
        if action is None:
            break
        next_obs, reward, done, env_debug = env.step(action)
        debug = dict(debug or {})
        debug.update(env_debug or {})
        debug["is_demo"] = True
        episode_data.append((obs, action, reward, next_obs, done, debug))
        obs = next_obs
        if done:
            break
    return episode_data


@configurable("run_meta_env")
def run_meta_env(
    env,
    policy=None,
    demo_policy_cls: Optional[Callable] = None,
    explore_schedule=None,
    episode_to_transitions_fn: Optional[Callable] = None,
    replay_writer=None,
    root_dir: Optional[str] = None,
    output_dir: Optional[str] = None,
    task: int = 0,
    global_step: int = 0,
    num_episodes: Optional[int] = None,
    num_tasks: int = 10,
    num_adaptations_per_task: int = 2,
    num_episodes_per_adaptation: int = 1,
    num_demos: int = 1,
    break_after_one_task: bool = False,
    tag: str = "collect",
    write_summaries: bool = False,
) -> Dict[str, float]:
    """Runs the meta agent/env loop; returns the summary statistics dict
    (summaries land in <root_dir>/live_eval_<task>/metrics.jsonl).
    `num_episodes` is accepted and ignored and `output_dir` aliases
    root_dir, for collect_eval_loop's run_agent_fn calling convention."""
    del num_episodes
    if root_dir is None:
        root_dir = output_dir
    task_step_rewards: Dict[int, Dict[int, List[float]]] = (
        collections.defaultdict(lambda: collections.defaultdict(list))
    )
    episode_q_values: Dict[int, List[float]] = collections.defaultdict(list)

    for task_idx in range(num_tasks):
        if hasattr(policy, "reset_task"):
            policy.reset_task()
        if hasattr(env, "reset_task"):
            env.reset_task()

        # Writing needs the writer, a converter, AND a destination; gate all
        # three together so write() is never reachable without open().
        writing = bool(replay_writer and episode_to_transitions_fn and root_dir)
        if writing:
            replay_writer.open(
                writer_lib.timestamped_record_path(
                    root_dir, global_step, suffix=f"t{task}_{task_idx}"
                )
            )

        # Conditioning data: demos from a demo policy, or task data the env
        # provides directly.
        condition_data: List[Any] = []
        if (
            demo_policy_cls is not None
            and hasattr(env, "get_demonstration")
            and hasattr(policy, "adapt")
        ):
            for _ in range(num_demos):
                episode_data = _run_demo_episode(env, demo_policy_cls(env))
                condition_data.append(episode_data)
                if writing:
                    replay_writer.write(
                        _convert_episode(
                            episode_to_transitions_fn,
                            episode_data,
                            is_demo=True,
                        )
                    )
            policy.adapt(copy.copy(condition_data))
        elif hasattr(env, "task_data") and hasattr(policy, "adapt"):
            for episode_name, episode_data in env.task_data.items():
                if str(episode_name).startswith("condition_ep"):
                    condition_data.append(episode_data)
            policy.adapt(copy.copy(condition_data))

        for step_num in range(num_adaptations_per_task):
            if step_num != 0 and hasattr(policy, "adapt"):
                policy.adapt(copy.copy(condition_data))
            for _ in range(num_episodes_per_adaptation):
                done, env_step, episode_reward = False, 0, 0.0
                episode_data = []
                policy.reset()
                obs = env.reset()
                # Schedules are plain callables framework-wide (run_env.py
                # convention); .value objects are accepted as the JAX
                # package accepts them.
                if explore_schedule is None:
                    explore_prob = 0
                elif hasattr(explore_schedule, "value"):
                    explore_prob = explore_schedule.value(global_step)
                else:
                    explore_prob = explore_schedule(global_step)
                while not done:
                    action, policy_debug = policy.sample_action(
                        obs, explore_prob
                    )
                    debug = dict(policy_debug or {})
                    if policy_debug and "q_predicted" in policy_debug:
                        episode_q_values[env_step].append(
                            float(np.mean(policy_debug["q_predicted"]))
                        )
                    new_obs, reward, done, env_debug = env.step(action)
                    debug.update(env_debug or {})
                    env_step += 1
                    episode_reward += reward
                    episode_data.append(
                        (obs, action, reward, new_obs, done, debug)
                    )
                    obs = new_obs
                task_step_rewards[task_idx][step_num].append(episode_reward)
                if writing:
                    replay_writer.write(
                        _convert_episode(
                            episode_to_transitions_fn, episode_data
                        )
                    )
                condition_data.append(episode_data)

        if writing:
            replay_writer.close()
        if break_after_one_task:
            break

    # Aggregate: per-adaptation-step mean reward + improvement deltas.
    stats: Dict[str, float] = {}
    ran_tasks = sorted(task_step_rewards.keys())
    for step_num in range(num_adaptations_per_task):
        step_rewards = [
            np.mean(task_step_rewards[t][step_num])
            for t in ran_tasks
            if task_step_rewards[t][step_num]
        ]
        if step_rewards:
            stats[f"{tag}/step_{step_num}_reward"] = float(
                np.mean(step_rewards)
            )
        if step_num > 0:
            deltas = [
                np.mean(task_step_rewards[t][step_num])
                - np.mean(task_step_rewards[t][step_num - 1])
                for t in ran_tasks
                if task_step_rewards[t][step_num]
                and task_step_rewards[t][step_num - 1]
            ]
            if deltas:
                stats[f"{tag}/step_{step_num}_improvement"] = float(
                    np.mean(deltas)
                )
    for step, q_values in episode_q_values.items():
        stats[f"{tag}/Q/{step}"] = float(np.mean(q_values))

    if write_summaries and root_dir:
        writer = MetricsWriter(os.path.join(root_dir, f"live_eval_{task}"))
        writer.write(global_step, stats)
        writer.close()
    return stats
