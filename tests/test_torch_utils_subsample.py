"""The port's utils/subsample.py against the JAX package's.

Draws cannot match jax.random's bits, so the port is held to:
  * the invariants, exactly: first and last valid frame kept, indices
    sorted and inside the sequence, middle frames distinct when the
    sequence is long enough, one frame for min_length 1, windows of at
    most max_delta_t frames;
  * the cases whose answer is fixed (length equal to the sample count,
    or 2 frames), equal to JAX's;
  * each frame's mean count per draw over DRAWS seeded draws (one batch of
    DRAWS equal lengths in each package), within FREQ_SIGMAS standard
    errors of the difference of the two means (each mean's variance
    estimated from its own draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.utils import subsample as jax_subsample
from tensor2robot_tpu_torch.utils import subsample

DRAWS = 4000
# With ~60 frames compared per case, 5 standard errors keeps a false
# alarm below 1e-4 per case.
FREQ_SIGMAS = 5.0


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _port(lengths, min_length, seed=0, **kwargs):
    return subsample.get_subsample_indices(
        torch.as_tensor(lengths), min_length, generator=_gen(seed), **kwargs).numpy()


def _jax(lengths, min_length, seed=0):
    return np.asarray(jax_subsample.get_subsample_indices(
        jax.random.PRNGKey(seed), jnp.asarray(lengths), min_length))


def _check_invariants(rows, lengths, min_length):
    assert rows.shape == (len(lengths), min_length)
    for row, length in zip(rows, lengths):
        assert row[0] == (0 if min_length > 1 else row[0])
        assert np.all(row >= 0) and np.all(row < length)
        if min_length > 1:
            assert row[-1] == length - 1
            assert np.all(np.diff(row) >= 0)
            if length >= min_length:
                assert len(set(row.tolist())) == min_length


@pytest.mark.parametrize("lengths,min_length", [
    ([10, 7, 20], 5), ([50], 10), ([3], 8), ([5, 9], 1), ([9, 12], 4),
    ([2, 3, 64], 2), ([1, 6], 3)])
def test_invariants_hold_in_both_packages(lengths, min_length):
    for seed in range(3):
        _check_invariants(_port(lengths, min_length, seed), lengths, min_length)
        _check_invariants(_jax(lengths, min_length, seed), lengths, min_length)


@pytest.mark.parametrize("lengths,min_length", [
    ([5], 5), ([12, 12], 12), ([2, 2, 2], 2), ([64], 64)])
def test_fixed_answers_equal_jax(lengths, min_length):
    port = _port(lengths, min_length)
    np.testing.assert_array_equal(port, _jax(lengths, min_length))
    np.testing.assert_array_equal(port, np.tile(np.arange(min_length), (len(lengths), 1)))


def _counts(rows, length):
    """[draws, length]: how often each frame appears in each draw."""
    out = np.zeros((rows.shape[0], length))
    for frame in range(length):
        out[:, frame] = (rows == frame).sum(axis=1)
    return out


def _assert_same_frequencies(port_rows, jax_rows, length):
    a, b = _counts(port_rows, length), _counts(jax_rows, length)
    se = np.sqrt(a.var(axis=0) / len(a) + b.var(axis=0) / len(b))
    gap = np.abs(a.mean(axis=0) - b.mean(axis=0))
    bound = FREQ_SIGMAS * se + 1e-12
    assert np.all(gap <= bound), (gap / np.maximum(se, 1e-12)).max()


@pytest.mark.parametrize("length,min_length", [
    (10, 5), (50, 10), (3, 8), (7, 1), (20, 2), (6, 6), (9, 4)])
def test_frame_frequencies_match_jax(length, min_length):
    lengths = [length] * DRAWS
    port = _port(lengths, min_length, seed=11)
    want = _jax(lengths, min_length, seed=11)
    _check_invariants(port[:50], lengths[:50], min_length)
    _assert_same_frequencies(port, want, length)


def test_a_frequency_gap_is_detected():
    """The frequency check fails for a sampler biased towards low frames."""
    lengths = [20] * DRAWS
    want = _jax(lengths, 5, seed=3)
    biased = _port(lengths, 5, seed=3).copy()
    biased[:, 1:-1] = np.sort(np.minimum(biased[:, 1:-1], 15), axis=1)
    with pytest.raises(AssertionError):
        _assert_same_frequencies(biased, want, 20)


@pytest.mark.parametrize("length,min_length,dt", [(30, 5, (8, 12)), (12, 3, (4, 20)),
                                                  (40, 1, (5, 5))])
def test_randomized_boundary_matches_jax(length, min_length, dt):
    lengths = [length] * DRAWS
    port = subsample.get_subsample_indices_randomized_boundary(
        torch.as_tensor(lengths), min_length, min_delta_t=dt[0], max_delta_t=dt[1],
        generator=_gen(5)).numpy()
    want = np.asarray(jax_subsample.get_subsample_indices_randomized_boundary(
        jax.random.PRNGKey(5), jnp.asarray(lengths), min_length, min_delta_t=dt[0],
        max_delta_t=dt[1]))
    for rows in (port, want):
        assert rows.shape == (DRAWS, min_length)
        assert np.all(np.diff(rows, axis=1) >= 0)
        assert np.all(rows[:, -1] - rows[:, 0] <= min(dt[1], length) - 1)
        assert np.all((rows >= 0) & (rows < length))
    _assert_same_frequencies(port, want, length)


def test_a_generator_makes_draws_repeatable():
    a = _port([30, 17], 6, seed=9)
    b = _port([30, 17], 6, seed=9)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, _port([30, 17], 6, seed=10))
