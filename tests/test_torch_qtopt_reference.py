"""A pin of a reference-side fault the critic's parity tests work around.

Under jit on the CPU, the JAX package's default max-pool backward (the
equal-split custom VJP of tensor2robot_tpu/ops/pooling.py, which `auto`
selects off the TPU) gives the QT-Opt Grasping44 critic conv gradients far
from its eager gradient; with T2R_POOL_BACKWARD=native the jitted gradient
is the eager one. A float64 central difference through the port's network
(an oracle neither JAX path shares) sides with the eager gradient. This is
why tests/test_torch_qtopt.py runs the JAX CompiledModel with the native
backward (ROADMAP.md C-ref5). The golden gate's shape and first batch:
96x96, num_convs (2, 2, 1), batch 4, preprocessed with the JAX step-0 key.
Run with -s to see the measured numbers.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
    Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom as Critic,
)
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.utils import jax_params

KERNEL = "grasping44.conv1_1.weight"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_jax_jit_pool_backward_pin(monkeypatch):
    from tensor2robot_tpu.data.dataset import RecordDataset
    from tools import make_qtopt_golden as golden

    model = golden.build_model()
    specs = {
        "features": model.preprocessor.get_in_feature_specification("train"),
        "labels": model.preprocessor.get_in_label_specification("train"),
    }
    raw = next(iter(RecordDataset(
        specs=specs, file_patterns=golden.RECORD_PATH, batch_size=golden.BATCH,
        mode="train", shuffle_buffer_size=0, seed=11, num_parse_workers=0,
        prefetch_depth=0,
    )))
    rng_pre, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(123), 0))
    features, labels = model.preprocessor.preprocess(
        {k: np.array(v) for k, v in raw["features"].items()},
        {k: np.array(v) for k, v in raw["labels"].items()},
        mode="train", rng=rng_pre,
    )
    variables = jax.tree_util.tree_map(
        np.asarray, model.init_variables(jax.random.PRNGKey(0), features))

    def loss(params):
        out, _ = model.inference_network_fn(
            {**variables, "params": params}, features, "train")
        return model.model_train_fn(features, labels, out, "train")[0]

    def kernel_grad(fn):
        grads = jax_params.flax_params_to_state_dict(
            jax.tree_util.tree_map(np.asarray, fn(variables["params"])))
        return grads[KERNEL].double().numpy()

    monkeypatch.delenv("T2R_POOL_BACKWARD", raising=False)
    eager = kernel_grad(jax.grad(loss))
    jitted = kernel_grad(jax.jit(jax.grad(loss)))
    monkeypatch.setenv("T2R_POOL_BACKWARD", "native")
    native = kernel_grad(jax.jit(jax.grad(loss)))
    monkeypatch.delenv("T2R_POOL_BACKWARD")

    # Along the unit difference of the two JAX gradients: a float64
    # central difference of the same loss through the port's network.
    port = Critic(image_size=golden.IMAGE_SIZE, num_convs=golden.NUM_CONVS)
    network = port.create_network().double()
    jax_params.load_flax_variables(network, variables)
    f64 = TensorSpecStruct({k: torch.from_numpy(np.array(v)).double()
                            for k, v in features.items()})
    l64 = TensorSpecStruct({"reward": torch.from_numpy(
        np.array(labels["reward"])).double()})
    stats = {k: v.clone() for k, v in network.state_dict().items()
             if k.endswith((".mean", ".var"))}

    def port_loss():
        value = port.model_train_fn(f64, l64, network(f64, "train"), "train")[0]
        network.load_state_dict(stats, strict=False)
        return value.item()

    direction = torch.from_numpy(eager - jitted)
    direction /= direction.norm()
    weight = dict(network.named_parameters())[KERNEL]
    eps = 1e-7
    with torch.no_grad():
        weight += eps * direction
        up = port_loss()
        weight -= 2 * eps * direction
        down = port_loss()
        weight += eps * direction
    fd = (up - down) / (2 * eps)
    d = direction.numpy()
    along = {"eager": float((eager * d).sum()), "jit": float((jitted * d).sum())}
    print(f"\n{KERNEL}: jit vs eager {_rel(jitted, eager):.3e} of max, native "
          f"jit vs eager {_rel(native, eager):.3e}; along their difference "
          f"float64 FD {fd:.6f}, eager {along['eager']:.6f}, jit "
          f"{along['jit']:.6f}")
    assert _rel(jitted, eager) > 0.1
    assert _rel(native, eager) < 1e-4
    assert abs(along["eager"] - fd) < 1e-3 * abs(fd)
    assert abs(along["jit"] - fd) > 0.5 * abs(fd)
