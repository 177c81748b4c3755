"""Port parity: tensor2robot_tpu_torch.models.optimizers vs the JAX
package's optax factories.

Each factory and its optax twin take five updates from the same start on
the same gradients (numpy seeds); parameters must agree at 1e-6. The
gradients do not depend on the parameters, so a difference can only come
from the update rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensor2robot_tpu.models import optimizers as jax_optimizers
from tensor2robot_tpu_torch.models import optimizers

# Five f32 updates computed in another order on each side.
TOL = 1e-6
STEPS = 5
SHAPES = {"w": (4, 3), "b": (3,), "s": ()}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _start_and_grads(scale=1.0):
    rng = np.random.RandomState(0)
    params = {k: np.asarray(rng.randn(*s), np.float32) for k, s in SHAPES.items()}
    grads = [
        {k: np.asarray(scale * rng.randn(*s), np.float32) for k, s in SHAPES.items()}
        for _ in range(STEPS)
    ]
    return params, grads


def _run_optax(transform, params, grads):
    params = {k: jnp.asarray(v) for k, v in params.items()}
    state = transform.init(params)
    for g in grads:
        updates, state = transform.update(
            {k: jnp.asarray(v) for k, v in g.items()}, state, params
        )
        params = optax.apply_updates(params, updates)
    return {k: np.asarray(v) for k, v in params.items()}


def _run_port(factory, params, grads):
    tensors = {
        k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()
    }
    optimizer = factory(list(tensors.values()))
    for g in grads:
        for k, p in tensors.items():
            p.grad = torch.from_numpy(g[k].copy())
        optimizer.step()
    return {k: p.detach().numpy() for k, p in tensors.items()}


def _decay(staircase):
    # Adam's default rate: optax takes Adam's bias correction 1 - b2**t in
    # f32 (1.3e-5 relative off the f64 value torch takes), which moves the
    # parameters by ~6e-6 * lr, under TOL at this rate.
    kw = dict(initial_learning_rate=1e-3, decay_steps=2, decay_rate=0.5,
              staircase=staircase)
    return (jax_optimizers.create_exponential_decay_learning_rate(**kw),
            optimizers.create_exponential_decay_learning_rate(**kw))


CASES = {
    "adam_default": lambda m: m.create_adam_optimizer(),
    "adam_custom": lambda m: m.create_adam_optimizer(0.01, 0.8, 0.99, 1e-6),
    "sgd": lambda m: m.create_sgd_optimizer(),
    "momentum": lambda m: m.create_momentum_optimizer(0.05, 0.9),
    "nesterov": lambda m: m.create_momentum_optimizer(0.05, 0.9, nesterov=True),
    "rmsprop_default": lambda m: m.create_rms_prop_optimizer(),
    "rmsprop_momentum": lambda m: m.create_rms_prop_optimizer(0.01, 0.8, 0.5, 1e-4),
    "constant_schedule": lambda m: m.create_sgd_optimizer(
        m.create_constant_learning_rate(0.03)
    ),
}


class TestFactoriesMatchOptax:
    @pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
    def test_five_updates(self, case):
        params, grads = _start_and_grads()
        expected = _run_optax(CASES[case](jax_optimizers), params, grads)
        got = _run_port(CASES[case](optimizers), params, grads)
        for key in SHAPES:
            np.testing.assert_allclose(got[key], expected[key], rtol=TOL, atol=TOL)

    @pytest.mark.parametrize("staircase", [True, False])
    def test_exponential_decay(self, staircase):
        jax_schedule, schedule = _decay(staircase)
        for count in range(8):
            np.testing.assert_allclose(
                schedule(count), float(jax_schedule(count)), rtol=TOL
            )
        params, grads = _start_and_grads()
        expected = _run_optax(
            jax_optimizers.create_adam_optimizer(jax_schedule), params, grads
        )
        got = _run_port(optimizers.create_adam_optimizer(schedule), params, grads)
        for key in SHAPES:
            np.testing.assert_allclose(got[key], expected[key], rtol=TOL, atol=TOL)

    @pytest.mark.parametrize(
        "clip", [dict(max_global_norm=1.0), dict(max_abs_value=0.5),
                 dict(max_global_norm=2.0, max_abs_value=0.7),
                 dict(max_global_norm=1e3)],
        ids=["global_norm", "abs_value", "both", "norm_not_reached"],
    )
    def test_gradient_clipping(self, clip):
        params, grads = _start_and_grads(scale=3.0)
        expected = _run_optax(
            jax_optimizers.with_gradient_clipping(
                jax_optimizers.create_sgd_optimizer(0.1), **clip
            ),
            params, grads,
        )
        got = _run_port(
            optimizers.with_gradient_clipping(
                optimizers.create_sgd_optimizer(0.1), **clip
            ),
            params, grads,
        )
        for key in SHAPES:
            np.testing.assert_allclose(got[key], expected[key], rtol=TOL, atol=TOL)


class TestOptimizerState:
    def test_update_count_checkpoints_with_the_optimizer(self):
        """The schedule's count lives in the param groups, so a restored
        optimizer continues the schedule where the saved one stopped."""
        params, grads = _start_and_grads()
        _, schedule = _decay(True)
        factory = optimizers.create_adam_optimizer(schedule)
        straight = _run_port(factory, params, grads)
        tensors = {
            k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in params.items()
        }
        first = factory(list(tensors.values()))
        for g in grads[:2]:
            for k, p in tensors.items():
                p.grad = torch.from_numpy(g[k].copy())
            first.step()
        saved = first.state_dict()
        assert saved["param_groups"][0]["count"] == 2
        resumed = factory(list(tensors.values()))
        resumed.load_state_dict(saved)
        for g in grads[2:]:
            for k, p in tensors.items():
                p.grad = torch.from_numpy(g[k].copy())
            resumed.step()
        for key in SHAPES:
            np.testing.assert_array_equal(tensors[key].detach().numpy(), straight[key])

    def test_clipping_needs_a_port_optimizer(self):
        factory = optimizers.with_gradient_clipping(
            lambda params: torch.optim.SGD(params, lr=0.1), max_global_norm=1.0
        )
        with pytest.raises(TypeError, match="not an optimizer of this module"):
            factory([torch.nn.Parameter(torch.zeros(2))])

    def test_jax_defaults_match(self):
        """The factories' defaults are the JAX package's."""
        import inspect

        for name in ("create_adam_optimizer", "create_sgd_optimizer",
                     "create_momentum_optimizer", "create_rms_prop_optimizer",
                     "create_constant_learning_rate",
                     "create_exponential_decay_learning_rate"):
            ours = inspect.signature(getattr(optimizers, name)).parameters
            theirs = inspect.signature(getattr(jax_optimizers, name)).parameters
            assert [(p.name, p.default) for p in ours.values()] == [
                (p.name, p.default) for p in theirs.values()
            ], name


def test_jax_side_runs_on_the_cpu():
    assert jax.default_backend() == "cpu"
