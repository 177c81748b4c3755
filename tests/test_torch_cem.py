"""The port's CEM engines against the JAX package's.

  * `ops/cem.cem_iterations`, fed the JAX loop's own noise (the draws of
    `jax.random.split`/`normal` as JAX ops/cem.py makes them), against JAX
    `cross_entropy_maximize` on a quadratic objective: mean, stddev, best
    action and best score within 1e-6 abs + rel. The scores of a
    continuous objective on Gaussian samples have no ties, so the elites
    of `torch.topk` and `lax.top_k` are the same samples.
  * `utils/cross_entropy.py` (the numpy engine) against the JAX package's
    copy, same seed: bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.ops import cem as jax_cem
from tensor2robot_tpu.utils import cross_entropy as jax_ce
from tensor2robot_tpu_torch.ops import cem
from tensor2robot_tpu_torch.utils import cross_entropy as port_ce

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def jax_noise(key, num_iterations, num_samples, shape):
    """The standard normals JAX ops/cem.py draws, iteration by iteration:
    rng, key = split(rng); normal(key, (num_samples,) + shape)."""
    rng = key
    draws = []
    for _ in range(num_iterations):
        rng, sub = jax.random.split(rng)
        draws.append(np.asarray(
            jax.random.normal(sub, (num_samples,) + tuple(shape), jnp.float32)))
    return np.stack(draws)


CASES = [
    # (seed, action dim, samples, iterations, elite fraction, low, high)
    (0, 2, 64, 3, 0.1, -1.0, 1.0),
    (1, 10, 64, 3, 0.1, -1.0, 1.0),
    (2, 3, 32, 8, 0.1, None, None),
    (3, 4, 16, 5, 0.25, 0.0, 1.0),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c[0]}-a{c[1]}-n{c[2]}")
def test_cem_iterations_match_jax_on_jax_noise(case):
    seed, dim, samples, iterations, fraction, low, high = case
    target = np.random.RandomState(seed).uniform(-0.8, 0.8, dim).astype(np.float32)

    def jax_objective(x):
        return -jnp.sum((x - target) ** 2, axis=-1)

    mean0 = np.full((dim,), 0.1, np.float32)
    std0 = np.full((dim,), 0.7, np.float32)
    key = jax.random.PRNGKey(seed)
    want = jax.jit(lambda k: jax_cem.cross_entropy_maximize(
        jax_objective, jnp.asarray(mean0), jnp.asarray(std0), k,
        num_samples=samples, num_iterations=iterations,
        elite_fraction=fraction, low=low, high=high))(key)
    noise = torch.from_numpy(jax_noise(key, iterations, samples, (dim,)))
    target_t = torch.from_numpy(target)
    got = cem.cem_iterations(
        lambda x: -torch.sum((x - target_t) ** 2, dim=-1),
        torch.from_numpy(mean0), torch.from_numpy(std0), noise,
        elite_fraction=fraction, low=low, high=high)
    for name, g, w in zip(("mean", "stddev", "best_action", "best_score"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL,
                                   err_msg=name)


def test_nan_scores_never_improve_the_best():
    """An all-NaN critic leaves the initial mean as the best, with -inf."""
    mean = torch.full((3,), 0.25)
    noise = torch.randn(3, 8, 3, generator=torch.Generator().manual_seed(0))
    _, _, best, score = cem.cem_iterations(
        lambda x: torch.full((x.shape[0],), float("nan")), mean,
        torch.ones(3), noise, low=-1.0, high=1.0)
    assert torch.equal(best, mean)
    assert score.item() == float("-inf")


def test_draw_noise_is_one_seeded_call():
    g = torch.Generator().manual_seed(5)
    noise = cem.draw_noise(g, 3, 64, (10,))
    assert noise.shape == (3, 64, 10) and noise.dtype == torch.float32
    expected = torch.randn(3, 64, 10, generator=torch.Generator().manual_seed(5))
    assert torch.equal(noise, expected)
    out = torch.empty(3, 64, 10)
    cem.draw_noise(torch.Generator().manual_seed(5), 3, 64, (10,), out=out)
    assert torch.equal(out, expected)


def test_converges_to_quadratic_max():
    """Twin of JAX TestJaxCEM.test_converges_to_quadratic_max_under_jit."""
    noise = cem.draw_noise(torch.Generator().manual_seed(0), 8, 64, (2,))
    mean, stddev, best, best_q = cem.cem_iterations(
        lambda x: -torch.sum((x - 0.3) ** 2, dim=-1),
        torch.zeros(2), torch.ones(2), noise, elite_fraction=0.1, low=-1.0, high=1.0)
    np.testing.assert_allclose(best.numpy(), [0.3, 0.3], atol=0.05)
    assert float(best_q) > -0.01
    assert bool(torch.all(stddev < 0.5))


def test_best_tracks_across_iterations():
    objective = lambda x: -torch.sum(x ** 2, dim=-1)  # noqa: E731
    noise = cem.draw_noise(torch.Generator().manual_seed(1), 4, 32, (3,))
    mean, _, _, best_q = cem.cem_iterations(
        objective, torch.full((3,), 0.9), torch.full((3,), 0.5), noise)
    assert float(best_q) >= float(objective(mean[None])[0]) - 1e-6


# -- the numpy engine -------------------------------------------------------------


def _quadratic(target):
    return lambda s: -np.sum((s - target) ** 2, axis=-1)


NUMPY_CASES = [
    dict(num_samples=64, num_iterations=3, seed=0),
    dict(num_samples=32, num_iterations=8, seed=3, elite_fraction=0.2),
    dict(num_samples=64, num_iterations=50, seed=1, early_termination_stddev=0.3),
    dict(num_samples=16, num_iterations=4, seed=2, smoothing=0.0),
]


@pytest.mark.parametrize("kwargs", NUMPY_CASES, ids=lambda k: f"seed{k['seed']}")
def test_numpy_engine_bit_equal_to_jax_package(kwargs):
    target = np.array([0.3, -0.6, 0.1])
    runs = []
    for module in (jax_ce, port_ce):
        calls = []

        def objective(samples, calls=calls):
            calls.append(samples.copy())
            return _quadratic(target)(samples)

        out = module.CrossEntropyMethod(**kwargs).run(
            objective, np.zeros(3), np.ones(3))
        runs.append((out, calls))
    (want, want_calls), (got, got_calls) = runs
    assert len(got_calls) == len(want_calls)
    for g, w in zip(got_calls, want_calls):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_cem_maximize_bit_equal_and_converges():
    target = np.array([0.3, -0.6])
    args = (_quadratic(target), np.zeros(2), np.ones(2))
    kwargs = dict(num_samples=256, num_iterations=10, seed=0)
    got = port_ce.cem_maximize(*args, **kwargs)
    want = jax_ce.cem_maximize(*args, **kwargs)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_allclose(got[0], target, atol=0.05)


def test_numpy_engine_rejects_bad_objective_shape():
    engine = port_ce.CrossEntropyMethod(num_samples=8, seed=0)
    with pytest.raises(ValueError, match="scores"):
        engine.run(lambda s: np.zeros((3,)), np.zeros(1), np.ones(1))


def test_numpy_engine_respects_asymmetric_bounds():
    def sample_clipped(mean, stddev, n, rng):
        return np.clip(rng.normal(mean[None], stddev[None], (n,) + mean.shape), 0.0, 1.0)

    engine = port_ce.CrossEntropyMethod(
        sample_fn=sample_clipped, num_samples=128, num_iterations=5, seed=0)
    mean, _, best, _ = engine.run(
        lambda a: -np.sum((a - 0.9) ** 2, axis=-1), np.full((3,), 0.5),
        np.full((3,), 0.5))
    np.testing.assert_allclose(best, 0.9, atol=0.1)
    assert np.all(mean >= 0.0) and np.all(mean <= 1.0)
