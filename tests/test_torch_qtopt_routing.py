"""research/qtopt/routing.py: recording and pinning the critic's relu and
pool choices, on the CPU at 96x96 with num_convs (2, 2, 1).

Pinned to its own choices a run's gradients are its unpinned ones, bit
for bit, in float32 and float64; pinned to other choices they move; the
counts of differing choices, the call-count check, the native pool mode
and the gradient-gap summary behave as documented.
"""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from tensor2robot_tpu_torch.data.input_generators import DefaultRandomInputGenerator
from tensor2robot_tpu_torch.research.qtopt import networks, routing
from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
    Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom as Critic,
)
from tensor2robot_tpu_torch.train.infeed import to_device
from tensor2robot_tpu_torch.train.train_eval import Trainer

BATCH = 2
# Relus: the stem, 2 + 2 + 1 conv blocks, two grasp-param layers and two
# hidden layers; pools: three.
RELUS, POOLS = 10, 3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def critic():
    model = Critic(batch_size=BATCH, image_size=(96, 96), num_convs=(2, 2, 1),
                   width=8)
    params = Trainer(model, device="cpu").init_state(
        torch.Generator().manual_seed(0)).network.state_dict()
    generator = DefaultRandomInputGenerator(batch_size=BATCH, seed=0)
    generator.set_specification_from_model(model, "train")
    batch = to_device(next(iter(generator.create_dataset("train"))), "cpu")
    return model, params, batch


def _run(critic, dtype):
    model, params, batch = critic
    return routing.critic_gradients(model, params, batch, dtype, "cpu")


def _assert_same(a, b):
    assert a[0] == b[0]
    for index in (1, 2):
        assert a[index].keys() == b[index].keys()
        for name in a[index]:
            assert torch.equal(a[index][name], b[index][name]), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pinned_to_its_own_choices_is_the_unpinned_run(critic, dtype):
    plain = _run(critic, dtype)
    with routing.record_routing() as recorded:
        again = _run(critic, dtype)
    assert (len(recorded.relus), len(recorded.pools)) == (RELUS, POOLS)
    _assert_same(plain, again)
    with routing.pinned_routing(recorded):
        pinned = _run(critic, dtype)
    _assert_same(plain, pinned)


def test_the_tower_ops_are_restored(critic):
    with routing.record_routing() as recorded:
        _run(critic, torch.float32)
    with routing.pinned_routing(recorded):
        assert networks.F is not F
        _run(critic, torch.float32)
    assert networks.F is F
    assert networks.pooling is routing.pooling


def _flipped(recorded):
    """The recording with the stem pool's first untied window split over
    all its elements, and the first hidden relu's first unit flipped."""
    mask, count = recorded.pools[0]
    b, c, i, _, j, _ = (int(n[0]) for n in torch.nonzero(count == 1, as_tuple=True))
    mask = mask.clone()
    mask[b, c, i, :, j, :] = True
    count = mask.sum(dim=(3, 5), keepdim=True)
    relus = [m.clone() for m in recorded.relus]
    relus[-2][0, 0] = ~relus[-2][0, 0]
    return dataclasses.replace(
        recorded, relus=relus, pools=[(mask, count)] + recorded.pools[1:])


def test_other_choices_move_the_gradients(critic):
    with routing.record_routing() as recorded:
        plain = _run(critic, torch.float64)
    other = _flipped(recorded)
    assert other.differences(recorded) == (1, 1)
    with routing.pinned_routing(other):
        moved = _run(critic, torch.float64)
    assert moved[0] != plain[0]  # the flipped relu unit moves the loss
    gap, _ = routing.worst_gap(moved[1], plain[1])
    assert gap > 1e-6
    # The pools pinned alone leave the relus to the run.
    with routing.pinned_routing(other, relus=False):
        pools_only = _run(critic, torch.float64)
    assert pools_only[0] == plain[0]


def test_differences_counts_units_and_windows(critic):
    with routing.record_routing() as recorded:
        _run(critic, torch.float32)
    assert recorded.differences(recorded) == (0, 0)
    mask, count = recorded.pools[1]
    mask = mask.clone()
    mask[0, 0, 0, 0, 0, 0] = ~mask[0, 0, 0, 0, 0, 0]
    mask[1, 0, 0, 0, 0, 0] = ~mask[1, 0, 0, 0, 0, 0]
    relus = [m.clone() for m in recorded.relus]
    relus[0][0, 0, 0, :3] = ~relus[0][0, 0, 0, :3]
    other = routing.Routing(relus, [recorded.pools[0], (mask, count)]
                            + recorded.pools[2:])
    assert other.differences(recorded) == (3, 2)


def test_a_recording_must_match_the_calls(critic):
    with routing.record_routing() as recorded:
        _run(critic, torch.float32)
    short = routing.Routing(recorded.relus[:-1], recorded.pools)
    with pytest.raises(ValueError, match="more relu calls"), \
            routing.pinned_routing(short):
        _run(critic, torch.float32)
    longer = routing.Routing(recorded.relus + recorded.relus[:1], recorded.pools)
    with pytest.raises(ValueError, match="fewer relu or pool calls"):
        with routing.pinned_routing(longer):
            _run(critic, torch.float32)


def test_native_pool_backward_is_refused(monkeypatch):
    monkeypatch.setenv("T2R_POOL_BACKWARD", "native")
    with pytest.raises(ValueError, match="T2R_POOL_BACKWARD=native"):
        with routing.record_routing():
            pass


def test_worst_gap_leaves_out_exact_zeros():
    reference = {"w": torch.tensor([2.0, -4.0]), "b": torch.tensor([1e-12])}
    got = {"w": torch.tensor([2.0, -3.0]), "b": torch.tensor([1e-9])}
    assert routing.worst_gap(got, reference) == (0.25, "w")


def test_the_diagnostic_prints_each_pinning(capsys):
    routing.main(["--image-size", "96", "--num-convs", "2,2,1", "--batch", "2",
                  "--device", "cpu"])
    out = capsys.readouterr().out
    for label in ("nothing pinned", "relus pinned", "pools pinned",
                  "relus and pools pinned"):
        assert f"float32 vs float64, {label}: loss rel" in out
