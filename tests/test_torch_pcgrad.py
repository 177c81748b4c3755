"""The port's PCGrad (research/qtopt/pcgrad.py) against the JAX package's.

  * The reference test's values (the JAX tests/test_qtopt.py cases, from
    pcgrad_test.py:91-100) for every allow/deny list, a single task, and
    non-conflicting gradients.
  * Random 3- and 4-task gradient dicts (seeded numpy, shapes of a small
    critic's leaves): the port's project_task_gradients equals JAX's,
    per-variable and flattened, masked and not, within RTOL relative to
    each leaf's largest magnitude.
  * pcgrad_gradients end to end over quadratic task losses: the loss and
    the combined gradient as JAX's, without and with the shuffle (JAX's
    projection run on the tasks in the port's drawn order, since the
    draws of the two packages differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.research.qtopt import pcgrad as jax_pcgrad
from tensor2robot_tpu_torch.research import qtopt
from tensor2robot_tpu_torch.research.qtopt import pcgrad

RTOL = 1e-6
SHAPES = {"conv1_1/kernel": (3, 4, 2, 5), "bn1/bias": (5,), "fc0/kernel": (6, 4),
          "fc0/bias": (4,), "logit/kernel": (4, 1)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _reference_tasks():
    params = {"first_var/var0": torch.tensor([1.0, 2.0]),
              "second_var/var1": torch.tensor([3.0, 4.0])}

    def loss0(p):
        return p["first_var/var0"] @ torch.tensor([1.0, 0.0]) + \
            p["second_var/var1"] @ torch.tensor([-1.0, 1.0])

    def loss1(p):
        return p["first_var/var0"] @ torch.tensor([-1.0, -1.0]) + \
            p["second_var/var1"] @ torch.tensor([1.0, 0.0])

    return params, [loss0, loss1]


PC0, PC1 = [0.5, -1.5], [0.5, 1.5]
SUM0, SUM1 = [0.0, -1.0], [0.0, 1.0]


@pytest.mark.parametrize("denylist,allowlist,expected0,expected1", [
    (None, None, PC0, PC1),
    (None, ["*var*"], PC0, PC1),
    (["second*"], None, PC0, SUM1),
    (None, ["first*"], PC0, SUM1),
    (None, ["*0"], PC0, SUM1),
    (["first*"], None, SUM0, PC1),
    (["*var*"], None, SUM0, SUM1),
])
@pytest.mark.parametrize("per_variable", [True, False])
def test_reference_values(denylist, allowlist, expected0, expected1, per_variable):
    params, losses = _reference_tasks()
    total, grads = pcgrad.pcgrad_gradients(losses, params, allowlist=allowlist,
                                           denylist=denylist, per_variable=per_variable)
    if per_variable:
        np.testing.assert_allclose(grads["first_var/var0"], expected0, atol=1e-5)
        np.testing.assert_allclose(grads["second_var/var1"], expected1, atol=1e-5)
    assert np.isfinite(float(total))
    jax_params = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    jax_losses = [lambda p, w=w: sum(p[k] @ jnp.asarray(v) for k, v in w.items())
                  for w in ({"first_var/var0": [1.0, 0.0], "second_var/var1": [-1.0, 1.0]},
                            {"first_var/var0": [-1.0, -1.0], "second_var/var1": [1.0, 0.0]})]
    want_total, want = jax_pcgrad.pcgrad_gradients(
        jax_losses, jax_params, allowlist=allowlist, denylist=denylist,
        per_variable=per_variable)
    np.testing.assert_allclose(float(total), float(want_total), rtol=RTOL)
    for key in want:
        np.testing.assert_allclose(grads[key].numpy(), np.asarray(want[key]), atol=1e-6)


def test_single_task_is_identity():
    params, losses = _reference_tasks()
    _, grads = pcgrad.pcgrad_gradients([losses[0]], params)
    np.testing.assert_allclose(grads["first_var/var0"], [1.0, 0.0])
    np.testing.assert_allclose(grads["second_var/var1"], [-1.0, 1.0])


def test_non_conflicting_grads_just_sum():
    out = pcgrad.project_task_gradients([{"w": torch.tensor([1.0, 0.0])},
                                         {"w": torch.tensor([1.0, 1.0])}])
    np.testing.assert_allclose(out["w"], [2.0, 1.0], atol=1e-5)


def _random_tasks(num_tasks, seed):
    rng = np.random.RandomState(seed)
    return [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
            for _ in range(num_tasks)]


def _assert_tree_close(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        value = np.asarray(value)
        scale = float(np.abs(value).max())
        np.testing.assert_allclose(got[key].numpy(), value, atol=RTOL * scale, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("num_tasks", [3, 4])
@pytest.mark.parametrize("per_variable", [True, False])
@pytest.mark.parametrize("lists", [(None, None), (["conv*", "fc0/*"], None),
                                   (None, ["*/bias"]), (["*"], ["*"])],
                         ids=["all", "allow", "deny", "none"])
def test_random_tasks_match_jax(num_tasks, per_variable, lists, seed=0):
    allowlist, denylist = lists
    tasks = _random_tasks(num_tasks, seed + num_tasks)
    masked = allowlist is not None or denylist is not None
    mask = pcgrad.make_surgery_mask(tasks[0], allowlist, denylist) if masked else None
    jax_mask = (jax_pcgrad.make_surgery_mask(tasks[0], allowlist, denylist)
                if masked else None)
    if masked:
        assert mask == jax.tree_util.tree_map(bool, jax_mask)
    got = pcgrad.project_task_gradients(
        [{k: torch.from_numpy(v) for k, v in t.items()} for t in tasks], mask,
        per_variable=per_variable)
    want = jax_pcgrad.project_task_gradients(
        [{k: jnp.asarray(v) for k, v in t.items()} for t in tasks], jax_mask,
        per_variable=per_variable)
    _assert_tree_close(got, want)
    if mask is not None and not any(mask.values()):
        _assert_tree_close(got, {k: sum(t[k] for t in tasks) for k in SHAPES})


def _quadratic_losses(num_tasks, seed, lib):
    rng = np.random.RandomState(seed)
    targets = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
               for _ in range(num_tasks)]
    weights = rng.uniform(0.5, 2.0, num_tasks).astype(np.float32)

    def make(target, weight):
        def loss(p):
            total = 0.0
            for key in sorted(target):
                diff = p[key] - lib(target[key])
                total = total + weight * (diff * diff).sum() + (diff * lib(target[key])).sum()
            return total
        return loss

    return [make(t, w) for t, w in zip(targets, weights)]


@pytest.mark.parametrize("num_tasks", [3, 4])
@pytest.mark.parametrize("per_variable", [True, False])
@pytest.mark.parametrize("shuffle", [False, True])
def test_pcgrad_gradients_match_jax(num_tasks, per_variable, shuffle):
    rng = np.random.RandomState(7)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    port_losses = _quadratic_losses(num_tasks, 3, torch.from_numpy)
    jax_losses = _quadratic_losses(num_tasks, 3, jnp.asarray)
    generator = torch.Generator().manual_seed(12) if shuffle else None
    total, got = pcgrad.pcgrad_gradients(
        port_losses, {k: torch.from_numpy(v) for k, v in params.items()},
        per_variable=per_variable, denylist=["logit/*"], generator=generator)
    jax_p = {k: jnp.asarray(v) for k, v in params.items()}
    order = (pcgrad.task_permutation(num_tasks, torch.Generator().manual_seed(12))
             if shuffle else list(range(num_tasks)))
    assert sorted(order) == list(range(num_tasks))
    task_grads = [jax.grad(jax_losses[i])(jax_p) for i in order]
    want = jax_pcgrad.project_task_gradients(
        task_grads, jax_pcgrad.make_surgery_mask(jax_p, None, ["logit/*"]),
        per_variable=per_variable)
    _assert_tree_close(got, want)
    want_total = sum(float(fn(jax_p)) for fn in jax_losses)
    np.testing.assert_allclose(float(total), want_total, rtol=1e-5)
    if not shuffle:
        want_total_jax, want_jax = jax_pcgrad.pcgrad_gradients(
            jax_losses, jax_p, denylist=["logit/*"], per_variable=per_variable)
        _assert_tree_close(got, want_jax)


def test_the_task_order_matters_for_three_tasks():
    """Beyond two tasks the projection depends on the task order (so the
    shuffle is a real choice): three 2-d gradients, each conflicting with
    another, give different sums in different orders, in both packages."""
    rows = ([1.0, 0.0], [-1.0, 0.5], [-0.2, -1.0])
    results = []
    for order in ([0, 1, 2], [2, 1, 0]):
        got = pcgrad.project_task_gradients([{"w": torch.tensor(rows[i])} for i in order])
        want = jax_pcgrad.project_task_gradients([{"w": jnp.asarray(rows[i])} for i in order])
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), rtol=RTOL,
                                   atol=1e-7)
        results.append(got["w"])
    assert not torch.allclose(results[0], results[1], atol=1e-2)


def test_qtopt_exports_pcgrad():
    assert qtopt.pcgrad is pcgrad
