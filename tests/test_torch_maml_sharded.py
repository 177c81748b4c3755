"""Port parity: MAML on sharded parameters. A MAML network trained in the
sharded_params regime on 1 data x 2 fsdp x 2 model ranks (each sharded
leaf of the base gathered whole once before the inner loop, the outer
gradient returned to the shards through the gather's backward:
parallel/sharded_params.gathered_parameters) against the JAX package's
CompiledModel: its step's loss and gradient, and its placement of the
state on the same CPU mesh.

The oracle for the step is JAX's one-device CompiledModel step, the
computation GSPMD partitions. JAX's own step with the task batch split
over data or fsdp is not an oracle on the CPU: there its adapted outputs
(after the inner step) leave its one-device step's for both families and
both orders, while its unadapted outputs agree bit for bit, and its
second-order step with conv kernels cut aborts in XLA's SPMD
partitioner (a failed check in convolution_handler.cc); ROADMAP.md
C-ref8.

No MAML family of either package has a leaf of mesh.MIN_WEIGHT_SIZE
(2^14) elements, so both sides shard leaves of 2^13 or more here (JAX's
CompiledModel's and the port's Trainer's param_min_shard_size): pose
MAML's conv3-6 kernels and pose_fc1, and VRGripper MAML's conv3-6
kernels, pose_fc0 and pose_fc1, each cut over model (its output dim) and
fsdp.

Cases: pose MAML (PoseEnvRegressionModelMAML, 4 tasks x (2 + 2) raw
64x64 uint8 samples; its reward-weighted loss's sums span the shards)
second order, and VRGripper MAML (VRGripperEnvRegressionModelMAML over
the regression base, 4 tasks x one 4-step episode of 40x40 images, both
sides' base preprocessor the no-op: the default one crops at random)
first order. Gates: the loss 1e-5 rel, every gradient (JAX's from its
Adam first moment, m / (1 - beta1)) within the meta gate, 1e-4 of its
leaf's max + 1e-7, and each rank's parameter and Adam-moment bytes equal
to JAX's device-0 shards of the state its CompiledModel places on the
mesh. The control (a leaf cut over fsdp keeps only this rank's tasks'
gradient) must miss the gate by 100x or more.

One LocalWorld of 4 for the module; about 30 s on the CPU, most of it
JAX's compiles.
"""

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.parallel import mesh as jax_mesh_lib
from tensor2robot_tpu.preprocessors import NoOpPreprocessor as JaxNoOp
from tensor2robot_tpu.research import pose_env as jax_pose_env
from tensor2robot_tpu.research import vrgripper as jax_vrg
from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct
from tensor2robot_tpu.train.train_eval import CompiledModel
from tensor2robot_tpu_torch.parallel import launch
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.preprocessors import NoOpPreprocessor
from tensor2robot_tpu_torch.utils.jax_params import flax_variables_to_state_dict
from tests import torch_moe_maml_ranks as ranks

SHAPE = (1, 2, 2, 1, 1, 1)
MIN_SHARD = 2 ** 13
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
CONTROL_MARGIN = 100
BETA1 = 0.9  # create_adam_optimizer's default in both packages
TASKS = 4
VRG = dict(episode_length=4, image_size=(40, 40))

# case -> (family, second order).
CASES = {"pose_second_order": ("pose", True), "vrgripper_first_order": ("vrgripper", False)}
# The leaves each family shards at MIN_SHARD.
SHARDED = {
    "pose": {f"base.state_features.conv{i}.weight" for i in range(3, 7)}
    | {"base.pose_net.pose_fc1.weight"},
    "vrgripper": {f"base.state_features.conv{i}.weight" for i in range(3, 7)}
    | {"base.pose_net.pose_fc0.weight", "base.pose_net.pose_fc1.weight"},
}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def world():
    with launch.LocalWorld(4, threads=1) as w:
        yield w


def _jax_model(family: str, second_order: bool):
    if family == "pose":
        return jax_pose_env.PoseEnvRegressionModelMAML(
            base_model=jax_pose_env.PoseEnvRegressionModel(device_type="cpu"),
            device_type="cpu", num_inner_loop_steps=1, use_second_order=second_order)
    base = jax_vrg.VRGripperRegressionModel(device_type="cpu", preprocessor_cls=JaxNoOp,
                                            **VRG)
    return jax_vrg.VRGripperEnvRegressionModelMAML(
        base_model=base, num_inner_loop_steps=1, inner_learning_rate=0.05,
        use_second_order=second_order)


def _batch(family: str, seed: int = 0):
    """A raw task batch of the family's MAML in-spec (pose: uint8 images,
    rewards in [0, 1] so every sample weighs in the loss)."""
    rng = np.random.RandomState(seed)
    features, labels = JaxStruct(), JaxStruct()
    if family == "pose":
        for group in ("condition", "inference"):
            features[f"{group}/features/state"] = rng.randint(
                0, 256, (TASKS, 2, 64, 64, 3)).astype(np.uint8)
        features["condition/labels/target_pose"] = rng.uniform(
            -1, 1, (TASKS, 2, 2)).astype(np.float32)
        features["condition/labels/reward"] = rng.rand(TASKS, 2, 1).astype(np.float32)
        labels["target_pose"] = rng.uniform(-1, 1, (TASKS, 2, 2)).astype(np.float32)
        labels["reward"] = rng.rand(TASKS, 2, 1).astype(np.float32)
        return features, labels
    steps = VRG["episode_length"]
    for group in ("condition", "inference"):
        features[f"{group}/features/image"] = rng.uniform(
            0, 1, (TASKS, 1, steps, *VRG["image_size"], 3)).astype(np.float32)
        features[f"{group}/features/gripper_pose"] = rng.uniform(
            -1, 1, (TASKS, 1, steps, 14)).astype(np.float32)
    features["condition/labels/action"] = rng.uniform(
        -1, 1, (TASKS, 1, steps, 7)).astype(np.float32)
    labels["action"] = rng.uniform(-1, 1, (TASKS, 1, steps, 7)).astype(np.float32)
    return features, labels


def _torch_layout(tree) -> dict:
    return {k: v.numpy() for k, v in flax_variables_to_state_dict({"params": tree}).items()}


def _device0_bytes(tree) -> int:
    return sum(leaf.addressable_shards[0].data.nbytes
               for leaf in jax.tree_util.tree_leaves(tree))


def _adam(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))


@pytest.fixture(scope="module")
def jax_steps(monkeypatch_module):
    """For each case: JAX's one-device CompiledModel step, its initial
    parameters, loss and gradient (torch layouts); device 0's bytes of the
    parameters and Adam moments its CompiledModel places on the 1 x 2 x 2
    mesh; the flat batch."""
    monkeypatch_module.setenv("T2R_POOL_BACKWARD", "native")
    mesh = jax_mesh_lib.make_mesh(**dict(zip(mesh_lib.AXES, SHAPE)),
                                  devices=jax.devices()[:4])
    runs = {}
    for case, (family, second) in CASES.items():
        features, labels = _batch(family)
        batch = {"features": features, "labels": labels}
        model = _jax_model(family, second)
        model.init_variables = jax.jit(model.init_variables)
        compiled = CompiledModel(model, donate_state=False)
        state0 = compiled.init_state(jax.random.PRNGKey(0), batch)
        state1, metrics = compiled.train_step(state0, batch, jax.random.PRNGKey(1))
        mu = jax.tree_util.tree_map(np.asarray, jax.device_get(_adam(state1.opt_state).mu))
        placed = CompiledModel(model, mesh=mesh, donate_state=False,
                               param_min_shard_size=MIN_SHARD).init_state(
            jax.random.PRNGKey(0), batch)
        moments = _adam(placed.opt_state)
        runs[case] = dict(
            weights=_torch_layout(jax.device_get(state0.params)),
            loss=float(metrics["loss"]),
            grads={k: v / (1 - BETA1) for k, v in _torch_layout(mu).items()},
            param_bytes=_device0_bytes(placed.params),
            opt_bytes=_device0_bytes((moments.mu, moments.nu)),
            batch={**{f"features/{k}": np.asarray(v) for k, v in features.items()},
                   **{f"labels/{k}": np.asarray(v) for k, v in labels.items()}})
    return runs


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as patch:
        yield patch


def _run(world, want, case, control=False):
    family, second = CASES[case]
    return world.run(ranks.maml_step, SHAPE, family, second,
                     {} if family == "pose" else dict(VRG, preprocessor_cls=NoOpPreprocessor),
                     want["weights"], want["batch"], MIN_SHARD, control)


def _worst(grads: dict, want: dict) -> float:
    """The worst gradient error over its gate."""
    return max(np.abs(grads[name] - value).max() / (GRAD_TOL * np.abs(value).max() + 1e-7)
               for name, value in want.items())


@pytest.mark.parametrize("case", list(CASES))
def test_maml_on_sharded_parameters_matches_jax(world, jax_steps, case):
    want = jax_steps[case]
    family = CASES[case][0]
    results = _run(world, want, case)
    for out in results:
        assert out["regime"] == "sharded_params"
        assert set(out["layout"]) == SHARDED[family]
        assert all(dims[0] is not None and dims[1] is not None
                   for dims in out["layout"].values())
        assert abs(out["loss"] - want["loss"]) <= LOSS_TOL * abs(want["loss"])
        assert set(out["grads"]) == set(want["grads"])
        assert _worst(out["grads"], want["grads"]) <= 1.0
        assert out["param_bytes"] == want["param_bytes"]
        assert out["opt_bytes"] == want["opt_bytes"]
        # The checkpoint gathers every shard whole, as for any network.
        assert out["saved_shapes"] == {k: v.shape for k, v in want["weights"].items()}
        assert all(out["recut"].values()) and set(out["recut"]) == SHARDED[family]
    for out in results[1:]:
        for name, g in out["grads"].items():
            np.testing.assert_array_equal(g, results[0]["grads"][name])


def test_an_unreduced_fsdp_gradient_fails_the_gate(world, jax_steps):
    """The control: a leaf cut over fsdp keeps only this rank's tasks'
    outer gradient (its gather's backward slices instead of summing over
    the fsdp ranks); the loss is unchanged."""
    want = jax_steps["pose_second_order"]
    for out in _run(world, want, "pose_second_order", control=True):
        assert abs(out["loss"] - want["loss"]) <= LOSS_TOL * abs(want["loss"])
        assert _worst(out["grads"], want["grads"]) >= CONTROL_MARGIN


def test_the_bf16_wrapper_sees_the_gathered_tensors(world, jax_steps):
    """Pose MAML under the bf16 wrapper (its conv and dense casts a torch
    function mode, which autocast cannot reach inside vmap) on the mesh
    against the same bf16 step on one device: the mode casts the whole
    gathered leaves as it casts the parameters on one device, so the
    losses agree within 1e-3 rel and each gradient within 2e-2 of its
    leaf's max (bf16 rounding of sums taken in another order)."""
    want = jax_steps["pose_second_order"]
    for out in world.run(ranks.maml_bf16_step, SHAPE, want["weights"], want["batch"],
                         MIN_SHARD):
        mesh, one = out["mesh"], out["one"]
        assert set(mesh["layout"]) == SHARDED["pose"] and not one["layout"]
        assert abs(mesh["loss"] - one["loss"]) <= 1e-3 * abs(one["loss"])
        for name, value in one["grads"].items():
            assert np.abs(mesh["grads"][name] - value).max() <= 2e-2 * np.abs(value).max(), name
