"""Policy zoo: the on-robot glue between predictors and environments.

Port of tensor2robot_tpu/policies/policies.py. A Policy wraps a predictor
(an export or a checkpoint) and turns observations into actions at
control rates:

  Policy                      restore/init delegation + sample_action
  CEMPolicy                   CEM argmax over a critic's q_predicted
                              (host numpy engine, float64)
  JitCEMPolicy                the whole CEM loop around the export's
                              program as one CUDA graph replay
  LSTMCEMPolicy               + recurrent hidden-state carry
  RegressionPolicy            regression model's inference_output as action
  SequentialRegressionPolicy  + observation-history stacking
  OUExploreRegressionPolicy   + Ornstein-Uhlenbeck exploration noise
  ScheduledExplorationRegressionPolicy  + linearly-decayed Gaussian noise
  PerEpisodeSwitchPolicy      explore-vs-greedy choice per episode
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.config import configurable
from tensor2robot_tpu_torch.ops import cem as cem_ops
from tensor2robot_tpu_torch.predictors.abstract_predictor import AbstractPredictor
from tensor2robot_tpu_torch.specs import (
    ExtendedTensorSpec,
    TensorSpecStruct,
    canonical_dtype,
    flatten_spec_structure,
)
from tensor2robot_tpu_torch.utils.cross_entropy import CrossEntropyMethod


def default_pack_fn(state, context, timestep) -> Dict[str, Any]:
    """Maps an observation onto predictor features: mappings pass through
    flattened; a bare array binds to the spec's single feature key."""
    del context, timestep
    if isinstance(state, (Mapping, TensorSpecStruct)):
        return {k: np.asarray(v) for k, v in flatten_spec_structure(state).items()}
    return {"__single__": np.asarray(state)}


class Policy(abc.ABC):
    """Base policy over a predictor."""

    def __init__(
        self,
        predictor: AbstractPredictor,
        pack_fn: Optional[Callable] = None,
    ):
        self._predictor = predictor
        self._pack_fn = pack_fn or default_pack_fn
        self._rng = np.random.RandomState()

    def seed(self, seed: int) -> None:
        self._rng = np.random.RandomState(seed)

    @property
    def predictor(self) -> AbstractPredictor:
        return self._predictor

    @property
    def global_step(self) -> int:
        return self._predictor.global_step

    def restore(self, is_async: bool = False) -> bool:
        return self._predictor.restore(is_async=is_async)

    def init_randomly(self) -> None:
        self._predictor.init_randomly()

    def close(self) -> None:
        self._predictor.close()

    def reset(self) -> None:
        """Per-episode reset hook (hidden state, noise processes, ...)."""

    def _pack(self, state, context, timestep) -> Dict[str, Any]:
        features = self._pack_fn(state, context, timestep)
        if "__single__" in features:
            spec = flatten_spec_structure(
                self._predictor.get_feature_specification()
            )
            keys = list(spec.keys())
            if len(keys) != 1:
                raise ValueError(
                    "A bare-array observation needs a single-feature spec or "
                    f"a custom pack_fn; spec has keys {keys}."
                )
            features = {keys[0]: features["__single__"]}
        return features

    @abc.abstractmethod
    def SelectAction(self, state, context=None, timestep: int = 0) -> np.ndarray:
        """Returns the action for one (unbatched) observation."""

    def sample_action(self, obs, explore_prob: float = 0.0):
        """dql-compat interface returning (action, debug_dict); the base
        policy ignores explore_prob, exploration variants override."""
        del explore_prob
        return self.SelectAction(obs), {}


def split_action(samples, leaves: List[Tuple[str, int]]) -> Dict[str, Any]:
    """Splits a flat [..., sum(sizes)] action (numpy or torch) along its
    last dim into {leaf_key: [..., size]} in spec order."""
    parts = {}
    offset = 0
    for key, size in leaves:
        parts[key] = samples[..., offset:offset + size]
        offset += size
    return parts


@configurable("CEMPolicy")
class CEMPolicy(Policy):
    """CEM argmax over a critic predictor's `q_predicted`, on the host in
    numpy (float64 refit), one predictor round trip per iteration.

    The predictor was exported with an action-population dim
    (`action_batch_size`), so each CEM iteration is ONE batched forward
    pass over the whole population (CriticModel's PREDICT tiling).
    """

    def __init__(
        self,
        predictor: AbstractPredictor,
        action_size: int,
        cem_iterations: int = 3,
        cem_samples: int = 64,
        elite_fraction: float = 0.1,
        action_low: float = -1.0,
        action_high: float = 1.0,
        action_key: str = "action",
        q_key: str = "q_predicted",
        pack_fn: Optional[Callable] = None,
        seed: Optional[int] = None,
    ):
        super().__init__(predictor, pack_fn)
        self._action_size = action_size
        self._low, self._high = action_low, action_high
        self._action_key = action_key
        self._resolved_action_leaves = None
        self._q_key = q_key

        def sample_clipped(mean, stddev, n, rng):
            samples = rng.normal(
                loc=mean[None, ...],
                scale=stddev[None, ...],
                size=(n,) + mean.shape,
            )
            # Clip BEFORE scoring so elites are refit on the same actions the
            # critic scored; otherwise the proposal mean can drift outside
            # [low, high] and never recover.
            return np.clip(samples, action_low, action_high)

        self._cem_samples = cem_samples
        self._cem_iterations = cem_iterations
        self._elite_fraction = elite_fraction
        self._seed = seed
        self._cem = CrossEntropyMethod(
            sample_fn=sample_clipped,
            num_samples=cem_samples,
            num_iterations=cem_iterations,
            elite_fraction=elite_fraction,
            seed=seed,
        )

    def _resolve_action_leaves(self) -> List[Tuple[str, int]]:
        """All action leaves under the action key, IN SPEC ORDER, with their
        trailing dims: [(leaf_key, size), ...]. A multi-part action spec
        (e.g. QT-Opt's 7 named components) is optimized as one flat
        [sum(sizes)] CEM vector that the objective splits back per leaf;
        SelectAction returns that flat vector in the same spec order.
        Cached — the spec is only available after the predictor restores."""
        if self._resolved_action_leaves is not None:
            return self._resolved_action_leaves
        spec = flatten_spec_structure(self._predictor.get_feature_specification())
        if self._action_key in list(spec.keys()):  # leaf keys only
            leaves = [self._action_key]
        else:
            prefix = self._action_key + "/"
            leaves = [k for k in spec.keys() if k.startswith(prefix)]
        if not leaves:
            raise ValueError(
                f"Cannot resolve action key {self._action_key!r} in spec "
                f"keys {sorted(spec.keys())}."
            )

        def leaf_size(key):
            # The trailing dim is the leaf's action size with and without
            # the CEM population dim (tiling prepends it). A SCALAR leaf
            # exported WITH a population cannot be told from a vector
            # leaf; it surfaces as the size-sum mismatch below.
            shape = tuple(spec[key].shape)
            return int(shape[-1]) if shape else 1

        resolved = [(key, leaf_size(key)) for key in leaves]
        total = sum(size for _, size in resolved)
        if total != self._action_size:
            raise ValueError(
                f"Action leaves {resolved} sum to {total} dims but "
                f"action_size={self._action_size}."
            )
        self._resolved_action_leaves = resolved
        return resolved

    def _objective_fn(self, features: Dict[str, Any]) -> Callable:
        leaves = self._resolve_action_leaves()

        def objective(samples: np.ndarray) -> np.ndarray:
            n = samples.shape[0]
            actions = np.clip(samples, self._low, self._high).astype(np.float32)
            batch = {
                key: np.asarray(value)[None, ...]
                for key, value in features.items()
            }
            for key, part in split_action(actions, leaves).items():
                batch[key] = part[None, ...]  # [1, n, leaf_size]
            out = self._predictor.predict(batch)
            q = np.asarray(out[self._q_key]).reshape(-1)
            if q.shape[0] != n:
                raise ValueError(
                    f"Critic returned {q.shape[0]} Q values for population {n}; "
                    "was the model exported with action_batch_size "
                    f"= {n}?"
                )
            return q

        return objective

    def get_cem_action(self, features: Dict[str, Any]) -> np.ndarray:
        # Seed the proposal at the center of the valid action box; mean=0 is
        # wrong for asymmetric [low, high] bounds.
        mean = np.full(
            (self._action_size,), (self._low + self._high) / 2.0, np.float64
        )
        stddev = np.full((self._action_size,), (self._high - self._low) / 2.0)
        _, _, best, _ = self._cem.run(self._objective_fn(features), mean, stddev)
        return np.clip(best, self._low, self._high).astype(np.float32)

    def SelectAction(self, state, context=None, timestep: int = 0) -> np.ndarray:
        features = self._pack(state, context, timestep)
        return self.get_cem_action(features)


@configurable("JitCEMPolicy")
class JitCEMPolicy(CEMPolicy):
    """CEM with the ENTIRE sample/score/refit loop (ops/cem.py) around the
    export's program (`ExportedModel.traced_predict`) recorded as one
    CUDA graph: a select copies the features into persistent device
    buffers, fills the noise buffer from the policy's torch.Generator,
    replays the graph and copies the best action and its Q out — one
    replay per select, where CEMPolicy makes one predictor round trip per
    iteration. The JAX package jits the same loop into one program.

    The graph is built (warm-up on a side stream, then capture) on the
    first select and again whenever the predictor's loaded model changes
    (a restore of a new version or a hot swap). A capture that fails
    raises: there is no fallback to the eager loop or the numpy engine.
    A predictor whose loaded model has no program (checkpoint predictors,
    random-init serving, program-less exports) uses the numpy engine, as
    in the JAX package. A program on the CPU runs the same loop eagerly
    (CUDA graphs need the card).

    Attributes:
      graph_replays: replays so far (one per select on the graph path).
      graph_builds: graphs captured so far.
      eager_selects: selects that ran the loop eagerly.
      last_q: the best Q of the last select on the program path.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._noise_seed = 0 if self._seed is None else self._seed
        self._generator: Optional[torch.Generator] = None
        self._source = None  # the ExportedModel the buffers were built for
        self._inputs: Dict[str, torch.Tensor] = {}
        self._noise: Optional[torch.Tensor] = None
        self._graph = None
        self._graph_out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.graph_replays = 0
        self.graph_builds = 0
        self.eager_selects = 0
        self.last_q: Optional[float] = None

    def seed(self, seed: int) -> None:
        super().seed(seed)
        self._noise_seed = seed
        self._generator = None  # re-seeded at the next select
        # Keep the numpy fallback engine in the same seeding contract.
        self._cem._rng = np.random.RandomState(seed)

    # -- build ------------------------------------------------------------------

    def _release(self) -> None:
        self._graph = None
        self._graph_out = None
        self._inputs = {}
        self._noise = None
        self._source = None

    def _prepare(self, loaded) -> None:
        """Static buffers for `loaded`, after JAX's population checks."""
        self._release()
        leaves = self._resolve_action_leaves()
        spec = flatten_spec_structure(self._predictor.get_feature_specification())
        # Fail fast with the deployment recipe: the loop scores the whole
        # population in ONE critic call, so the export's action leaves
        # must carry the population dim.
        for leaf_key, _ in leaves:
            shape = tuple(spec[leaf_key].shape)
            if not shape or int(shape[0]) != self._cem_samples:
                raise ValueError(
                    f"JitCEMPolicy needs the export's action leaf "
                    f"{leaf_key!r} to carry the CEM population as its "
                    f"leading dim: spec shape {shape}, expected "
                    f"({self._cem_samples}, ...). Re-export the serving "
                    f"model with action_batch_size={self._cem_samples}, or "
                    "use CEMPolicy (numpy engine)."
                )
        action_keys = {key for key, _ in leaves}
        device = loaded.device
        self._inputs = {
            key: torch.zeros(
                (1,) + tuple(leaf.shape),
                dtype=canonical_dtype(leaf.dtype),
                device=device,
            )
            for key, leaf in spec.items()
            if isinstance(leaf, ExtendedTensorSpec) and not leaf.is_optional
            and key not in action_keys
        }
        self._noise = torch.zeros(
            (self._cem_iterations, self._cem_samples, self._action_size),
            dtype=torch.float32, device=device,
        )
        self._source = loaded
        # Run the objective once: a population the export does not score
        # raises here, outside any capture.
        q = self._objective(loaded, leaves)(self._noise[0])
        if tuple(q.shape) != (self._cem_samples,):
            raise ValueError(
                f"Critic returned {tuple(q.shape)} Q values for population "
                f"{self._cem_samples}; was the model exported with "
                f"action_batch_size = {self._cem_samples}?"
            )

    def _capture(self, loaded) -> None:
        """Warm-up on a side stream (the program's lazy init, cuDNN's
        algorithm picks), then one capture of the whole loop."""
        device = loaded.device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._run_loop(loaded)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._run_loop(loaded)
        self._graph, self._graph_out = graph, out
        self.graph_builds += 1

    def _objective(self, loaded, leaves) -> Callable:
        q_key = self._q_key

        def objective(samples: torch.Tensor) -> torch.Tensor:
            batch = dict(self._inputs)
            for key, part in split_action(samples, leaves).items():
                batch[key] = part[None, ...]  # [1, n, leaf_size]
            return loaded.traced_predict(batch)[q_key].reshape(-1)

        return objective

    def _run_loop(self, loaded) -> Tuple[torch.Tensor, torch.Tensor]:
        """The select on the static buffers: no host sync, so the card
        can record it."""
        low, high = self._low, self._high
        device = self._noise.device
        mean = torch.full((self._action_size,), (low + high) / 2.0,
                          dtype=torch.float32, device=device)
        stddev = torch.full((self._action_size,), (high - low) / 2.0,
                            dtype=torch.float32, device=device)
        _, _, best, best_q = cem_ops.cem_iterations(
            self._objective(loaded, self._resolve_action_leaves()),
            mean, stddev, self._noise,
            elite_fraction=self._elite_fraction, low=low, high=high,
        )
        return torch.clamp(best, low, high), best_q

    # -- select -----------------------------------------------------------------

    def _load_features(self, features: Dict[str, Any]) -> None:
        for key, buffer in self._inputs.items():
            if key not in features:
                raise KeyError(
                    f"JitCEMPolicy: observation lacks {key!r} (has "
                    f"{sorted(features)})."
                )
            value = np.asarray(features[key]).reshape(buffer.shape[1:])
            host = torch.from_numpy(np.ascontiguousarray(value))
            buffer[0].copy_(host.to(buffer.dtype))

    def get_cem_action(self, features: Dict[str, Any]) -> np.ndarray:
        loaded = getattr(self._predictor, "loaded_model", None)
        if loaded is None or not getattr(loaded, "has_program", False):
            return super().get_cem_action(features)
        graph = loaded.device.type == "cuda"
        if self._source is not loaded:
            self._prepare(loaded)
        if graph and self._graph is None:
            self._capture(loaded)
        self._load_features(features)
        device = self._noise.device
        if self._generator is None or self._generator.device != device:
            self._generator = torch.Generator(device=device).manual_seed(
                self._noise_seed)
        cem_ops.draw_noise(
            self._generator, self._cem_iterations, self._cem_samples,
            (self._action_size,), out=self._noise,
        )
        if graph:
            self._graph.replay()
            self.graph_replays += 1
            best, best_q = self._graph_out
        else:
            best, best_q = self._run_loop(loaded)
            self.eager_selects += 1
        host = torch.cat([best.reshape(-1), best_q.reshape(1)]).cpu().numpy()
        self.last_q = float(host[-1])
        return host[:-1].astype(np.float32)


@configurable("LSTMCEMPolicy")
class LSTMCEMPolicy(CEMPolicy):
    """CEM over a recurrent critic: carries hidden state between steps via
    the predictor's `state_output` -> `state_input` keys."""

    def __init__(self, *args, state_input_key: str = "state_input",
                 state_output_key: str = "state_output", **kwargs):
        super().__init__(*args, **kwargs)
        self._state_input_key = state_input_key
        self._state_output_key = state_output_key
        self._hidden = None

    def reset(self) -> None:
        self._hidden = None

    def SelectAction(self, state, context=None, timestep: int = 0) -> np.ndarray:
        features = self._pack(state, context, timestep)
        if self._hidden is not None:
            features[self._state_input_key] = self._hidden
        action = self.get_cem_action(features)
        # One more pass to advance the recurrent state with the chosen action,
        # fed under the same per-leaf keys the CEM objective used.
        batch = {k: np.asarray(v)[None, ...] for k, v in features.items()}
        for key, part in split_action(
            action, self._resolve_action_leaves()
        ).items():
            batch[key] = part[None, None, ...]
        out = self._predictor.predict(batch)
        if self._state_output_key in out:
            self._hidden = np.asarray(out[self._state_output_key])[0]
        return action


@configurable("RegressionPolicy")
class RegressionPolicy(Policy):
    """Action = regression model's `inference_output`."""

    def __init__(
        self,
        predictor: AbstractPredictor,
        action_key: str = "inference_output",
        pack_fn: Optional[Callable] = None,
    ):
        super().__init__(predictor, pack_fn)
        self._action_key = action_key

    def _predict_action(self, features: Dict[str, Any]) -> np.ndarray:
        batch = {k: np.asarray(v)[None, ...] for k, v in features.items()}
        out = self._predictor.predict(batch)
        action = np.asarray(out[self._action_key])[0]
        return action

    def SelectAction(self, state, context=None, timestep: int = 0) -> np.ndarray:
        return self._predict_action(self._pack(state, context, timestep))


@configurable("SequentialRegressionPolicy")
class SequentialRegressionPolicy(RegressionPolicy):
    """Stacks the last `history_length` observations into a leading time dim
    before prediction."""

    def __init__(self, *args, history_length: int = 4, **kwargs):
        super().__init__(*args, **kwargs)
        self._history_length = history_length
        self._history: list = []

    def reset(self) -> None:
        self._history = []

    def SelectAction(self, state, context=None, timestep: int = 0) -> np.ndarray:
        features = self._pack(state, context, timestep)
        self._history.append(features)
        if len(self._history) > self._history_length:
            self._history.pop(0)
        padded = [self._history[0]] * (
            self._history_length - len(self._history)
        ) + self._history
        stacked = {
            key: np.stack([f[key] for f in padded], axis=0)
            for key in padded[0]
        }
        return self._predict_action(stacked)


@configurable("OUExploreRegressionPolicy")
class OUExploreRegressionPolicy(RegressionPolicy):
    """Adds Ornstein-Uhlenbeck temporally-correlated exploration noise."""

    def __init__(self, *args, theta: float = 0.15, sigma: float = 0.2,
                 action_low: float = -1.0, action_high: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self._theta, self._sigma = theta, sigma
        self._low, self._high = action_low, action_high
        self._noise: Optional[np.ndarray] = None

    def reset(self) -> None:
        self._noise = None

    def _ou_step(self, shape) -> np.ndarray:
        if self._noise is None:
            self._noise = np.zeros(shape)
        self._noise = (
            self._noise
            - self._theta * self._noise
            + self._sigma * self._rng.normal(size=shape)
        )
        return self._noise

    def sample_action(self, obs, explore_prob: float = 0.0):
        action = self.SelectAction(obs)
        if self._rng.uniform() < explore_prob:
            action = np.clip(
                action + self._ou_step(action.shape), self._low, self._high
            ).astype(action.dtype)
        return action, {"ou_noise": self._noise}


@configurable("ScheduledExplorationRegressionPolicy")
class ScheduledExplorationRegressionPolicy(RegressionPolicy):
    """Gaussian exploration with stddev decayed linearly over global_step."""

    def __init__(self, *args, initial_stddev: float = 0.2,
                 final_stddev: float = 0.0, decay_steps: int = 10000,
                 action_low: float = -1.0, action_high: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self._initial, self._final = initial_stddev, final_stddev
        self._decay_steps = decay_steps
        self._low, self._high = action_low, action_high

    def current_stddev(self) -> float:
        step = max(self.global_step, 0)
        frac = min(step / max(self._decay_steps, 1), 1.0)
        return self._initial + (self._final - self._initial) * frac

    def sample_action(self, obs, explore_prob: float = 0.0):
        del explore_prob  # The schedule, not the caller, owns exploration.
        action = self.SelectAction(obs)
        stddev = self.current_stddev()
        noisy = np.clip(
            action + self._rng.normal(scale=stddev, size=action.shape),
            self._low,
            self._high,
        ).astype(action.dtype)
        return noisy, {"stddev": stddev}


@configurable("PerEpisodeSwitchPolicy")
class PerEpisodeSwitchPolicy(Policy):
    """Chooses the explore or the greedy policy once per episode."""

    def __init__(
        self,
        explore_policy: Policy,
        greedy_policy: Policy,
        explore_prob: float = 0.0,
    ):
        # Delegates predictor ops to the greedy policy's predictor. The
        # explore probability is owned by the policy because run_env calls
        # reset() with no args.
        super().__init__(greedy_policy.predictor)
        self._explore_policy = explore_policy
        self._greedy_policy = greedy_policy
        self._explore_prob = explore_prob
        self._active = greedy_policy

    def restore(self, is_async: bool = False) -> bool:
        ok = self._explore_policy.restore(is_async=is_async)
        return self._greedy_policy.restore(is_async=is_async) and ok

    def init_randomly(self) -> None:
        self._explore_policy.init_randomly()
        self._greedy_policy.init_randomly()

    def reset(self, explore_prob: Optional[float] = None) -> None:
        if explore_prob is not None:
            self._explore_prob = explore_prob
        self._explore_policy.reset()
        self._greedy_policy.reset()
        self._active = (
            self._explore_policy
            if self._rng.uniform() < self._explore_prob
            else self._greedy_policy
        )

    @property
    def active_policy(self) -> Policy:
        return self._active

    def SelectAction(self, state, context=None, timestep: int = 0) -> np.ndarray:
        return self._active.SelectAction(state, context, timestep)

    def sample_action(self, obs, explore_prob: float = 0.0):
        return self._active.sample_action(obs, explore_prob)
