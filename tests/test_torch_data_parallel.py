"""Port parity: global-batch training over data x fsdp shards.

The QT-Opt critic (96x96, num_convs=(2, 2, 1), batch 8, its batch norms
over every shard) steps on a 2 data x 2 fsdp mesh of 4 gloo ranks (one
LocalWorld for the module) and is held against the JAX package's
global-batch step: the JAX train loss and its gradient under jit with the
batch placed on a 2 x 2 CPU mesh (`parallel.mesh.shard_batch` of the JAX
package, where the batch norms' mean over axis 0 spans the shards), on
the same weights (utils/jax_params.py) and the same preprocessed features.
The JAX side runs under T2R_POOL_BACKWARD=native (ROADMAP.md C-ref5).
Both sides start from zeroed running statistics, so after the step they
hold (1 - momentum) x the batch moments rather than ~1 + a 3e-4 nudge, and
the statistics gate can tell global moments from per-shard ones.

Gates: loss 1e-5 rel; each gradient 1e-4 of its leaf's max + 1e-7; each
running statistic 1e-4 of its max + 1e-12 (the statistics are ~3e-4 of
the features' scale). The same step under remat and under grad-accum 2
(JAX's microbatch i is rows [i B/2, (i+1) B/2) of the global batch, with
its own moments and the step-start statistics; the last microbatch's
update is kept) meets the same gates, and a control step whose norms
normalize by their own shard must fail the statistics gate.

Grasp2Vec (ResNet-18, 32x32 crops, batch 4) steps on 2 data shards in
float64 (train-mode norms over 2 images a shard: tests/test_torch_resnet.py
says why float32 parity means nothing there), its norms over both shards
and its n-pairs loss over the gathered embeddings, against JAX's step with
the batch on a 2-device data mesh: loss 1e-5 rel, each gradient 1e-4 of
its max, each running statistic 1e-4 of its max + 1e-12.

Then the rest of the data x fsdp path on the same ranks: the shards'
preprocessing draws, `shard_by_host` over a mesh, and train_eval_model
with an exporter and a hook followed by continuous_eval over the mesh.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.parallel import mesh as jax_mesh_lib
from tensor2robot_tpu.research.qtopt.t2r_models import (
    Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom as JaxCritic,
)
from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct
from tensor2robot_tpu_torch.export.saved_model import list_export_dirs
from tensor2robot_tpu_torch.parallel import launch
from tensor2robot_tpu_torch.predictors.exported_savedmodel_predictor import (
    ExportedSavedModelPredictor,
)
from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
    Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom as Critic,
)
from tensor2robot_tpu_torch.specs import make_random_numpy
from tensor2robot_tpu_torch.train import state as state_lib
from tensor2robot_tpu_torch.train import train_eval
from tensor2robot_tpu_torch.train.metrics import read_metrics
from tensor2robot_tpu_torch.utils.jax_params import (
    flax_params_to_state_dict,
    flax_variables_to_state_dict,
)
from tests import torch_parallel_ranks as ranks

MODEL = dict(image_size=(96, 96), num_convs=(2, 2, 1))
BATCH = 8
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STATS_TOL = 1e-4


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


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def critic():
    """Seeded preprocessed features and labels of a global batch of 8, the
    JAX critic's variables with zeroed running statistics, and the JAX
    global-batch step on a 2 x 2 data x fsdp mesh, whole and in two
    microbatches."""
    port = Critic(device_type="cpu", **MODEL)
    features = dict(make_random_numpy(port.get_feature_specification("train"),
                                      batch_size=BATCH, seed=1))
    labels = dict(make_random_numpy(port.get_label_specification("train"),
                                    batch_size=BATCH, seed=2))
    labels["reward"] = (labels["reward"] > 0.5).astype(np.float32)
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("T2R_POOL_BACKWARD", "native")  # C-ref5, read at trace time
        model = JaxCritic(device_type="cpu", **MODEL)
        variables = _host(jax.jit(model.init_variables)(
            jax.random.PRNGKey(0), JaxStruct(features)))
        variables["batch_stats"] = jax.tree_util.tree_map(
            np.zeros_like, variables["batch_stats"])
        mesh = jax_mesh_lib.make_mesh(data=2, fsdp=2, devices=jax.devices()[:4])

        def loss_fn(params, f, l):
            v = dict(variables, params=params)
            f, l, outputs, updates = model.packed_inference(v, f, "train", labels=l)
            return model.model_train_fn(f, l, outputs, "train")[0], updates["batch_stats"]

        step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

        def run(microbatches):
            size = BATCH // microbatches
            loss, grads, stats = 0.0, None, None
            for i in range(microbatches):
                part = [JaxStruct(jax_mesh_lib.shard_batch(
                    {k: v[i * size:(i + 1) * size] for k, v in tree.items()}, mesh))
                    for tree in (features, labels)]
                (l_i, stats), g_i = _host(step(variables["params"], *part))
                loss += float(l_i) / microbatches
                g_i = jax.tree_util.tree_map(lambda g: g / microbatches, g_i)
                grads = g_i if grads is None else jax.tree_util.tree_map(
                    np.add, grads, g_i)
            stats = flax_variables_to_state_dict({"batch_stats": stats})
            return loss, flax_params_to_state_dict(grads), stats

        steps = {1: run(1), 2: run(2)}
    state = {k: v.numpy() for k, v in flax_variables_to_state_dict(variables).items()}
    return dict(features=features, labels=labels, state=state, steps=steps)


def _within(got, want, tol, floor):
    want = np.asarray(want)
    return float(np.abs(got - want).max()) <= tol * float(np.abs(want).max()) + floor


@pytest.mark.parametrize("regime", ["plain", "remat", "grad_accum2"])
def test_critic_step_over_data_x_fsdp_matches_jax(world, critic, regime):
    want_loss, want_grads, want_stats = critic["steps"][2 if regime == "grad_accum2" else 1]
    results = world.run(ranks.critic_step, MODEL, critic["state"], critic["features"],
                        critic["labels"], regime)
    for loss, grads, buffers in results:
        assert abs(loss - want_loss) <= LOSS_TOL * abs(want_loss)
        assert set(grads) == set(want_grads)
        for name, want in want_grads.items():
            assert _within(grads[name], want.numpy(), GRAD_TOL, 1e-7), name
        assert set(buffers) == set(want_stats)
        for name, want in want_stats.items():
            assert _within(buffers[name], want.numpy(), STATS_TOL, 1e-12), name
    # Replicas stay equal: the same averaged gradient and the same
    # statistics on every rank.
    for _, grads, buffers in results[1:]:
        for name, g in grads.items():
            np.testing.assert_array_equal(g, results[0][1][name])
        for name, b in buffers.items():
            np.testing.assert_array_equal(b, results[0][2][name])


G2V = dict(scene_size=(32, 32), goal_size=(32, 32), resnet_size=18)


def test_grasp2vec_step_over_data_shards_matches_jax(world):
    from tensor2robot_tpu.research import grasp2vec as jax_g2v
    from tests.test_torch_resnet import float64, seeded_variables

    jax_model = jax_g2v.Grasp2VecModel(device_type="cpu", **G2V)
    rng = np.random.RandomState(3)
    features = {k: rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
                for k in ("pregrasp_image", "postgrasp_image", "goal_image")}
    shapes = jax.eval_shape(lambda: jax_model.init_variables(
        jax.random.PRNGKey(0), JaxStruct(features)))
    variables = seeded_variables(shapes, seed=1)
    variables["batch_stats"] = jax.tree_util.tree_map(np.zeros_like,
                                                      variables["batch_stats"])
    mesh = jax_mesh_lib.make_mesh(data=2, devices=jax.devices()[:2])

    def loss_fn(params, f):
        outputs, updates = jax_model.inference_network_fn(dict(variables, params=params),
                                                          f, "train")
        return jax_model.model_train_fn(f, {}, outputs, "train")[0], updates["batch_stats"]

    with jax.enable_x64(True):
        placed = JaxStruct(jax_mesh_lib.shard_batch(float64(features), mesh))
        (loss, stats), grads = _host(jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            float64(variables)["params"], placed))
    want_grads = flax_params_to_state_dict(grads)
    want_stats = flax_variables_to_state_dict({"batch_stats": stats})
    state = {k: v.numpy() for k, v in flax_variables_to_state_dict(variables).items()}
    results = world.run(ranks.grasp2vec_step, G2V, state, features)
    for got_loss, grads, buffers in results:
        assert abs(got_loss - float(loss)) <= LOSS_TOL * abs(float(loss))
        assert set(grads) == set(want_grads)
        for name, want in want_grads.items():
            assert _within(grads[name], want.numpy(), GRAD_TOL, 1e-7), name
        for name, want in want_stats.items():
            assert _within(buffers[name], want.numpy(), STATS_TOL, 1e-12), name


def test_per_shard_moments_fail_the_statistics_gate(world, critic):
    """The control: norms that normalize by their own shard drift from the
    global batch's statistics past the gate on every rank, and apart from
    one another."""
    _, _, want_stats = critic["steps"][1]
    results = world.run(ranks.critic_step, MODEL, critic["state"], critic["features"],
                        critic["labels"], "unsynchronized")
    for _, _, buffers in results:
        assert not all(_within(buffers[name], want.numpy(), STATS_TOL, 1e-12)
                       for name, want in want_stats.items())
    assert any(not np.array_equal(results[0][2][name], r[2][name])
               for r in results[1:] for name in want_stats)


def test_each_shard_draws_its_own_folded_stream(world):
    """Every rank preprocesses the same two episodes at step 3: each draws
    what the single-device preprocessor draws from step_generator with its
    data x fsdp index folded in, and no two shards' crops agree."""
    model = Critic(device_type="cpu", **MODEL)
    raw = make_random_numpy(model.preprocessor.get_in_feature_specification("train"),
                            batch_size=2, seed=4)
    batch = {f"features/{k}": v for k, v in raw.items()}
    results = world.run(ranks.critic_draws, MODEL, batch, 3)
    assert sorted(shard for shard, _ in results) == [0, 1, 2, 3]
    trainer = train_eval.Trainer(model, device="cpu")
    from tensor2robot_tpu_torch.train.infeed import to_device

    for shard, image in results:
        generator = train_eval.step_generator(0, 3, "cpu", "pre", shard, 4)
        want, _ = trainer.preprocess_train(to_device(batch, "cpu"), generator)
        np.testing.assert_array_equal(image, want["state/image"].numpy())
    images = [image for _, image in results]
    for i in range(4):
        for j in range(i + 1, 4):
            assert not np.array_equal(images[i], images[j])
    # One shard is the single-device stream.
    alone, _ = trainer.preprocess_train(to_device(batch, "cpu"),
                                        train_eval.step_generator(0, 3, "cpu"))
    one = train_eval.step_generator(0, 3, "cpu", "pre", 0, 1)
    np.testing.assert_array_equal(
        trainer.preprocess_train(to_device(batch, "cpu"), one)[0]["state/image"].numpy(),
        alone["state/image"].numpy())


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Critic JPEG records: 4 train files of 4 and one eval file of 4."""
    import chip_smoke

    model = Critic(device_type="cpu", **MODEL)
    source = model.preprocessor.get_in_feature_specification("train")["state/image"]
    patterns, _, _ = chip_smoke.write_records(
        model, str(tmp_path_factory.mktemp("records")), (16, 4, 4), source.shape[:2])
    return patterns


def test_shard_by_host_splits_files_by_the_data_shard(world, records):
    """On 2 data x 2 sequence ranks: the files go round-robin by the data
    index, so the two sequence ranks of a replica read the same files and
    the same records, in batches of 4 / 2; replicas read disjoint files."""
    results = world.run(ranks.shard_by_host_reads, records["train"], MODEL, 4)
    by_shard = {}
    for shard, files, rewards in results:
        assert rewards.shape == (2, 1)
        by_shard.setdefault(shard, []).append((files, rewards))
    assert sorted(by_shard) == [0, 1]
    for (files_a, rewards_a), (files_b, rewards_b) in by_shard.values():
        assert files_a == files_b and len(files_a) == 2
        np.testing.assert_array_equal(rewards_a, rewards_b)
    assert not set(by_shard[0][0][0]) & set(by_shard[1][0][0])
    errors = world.run(ranks.shard_by_host_too_few_files, records["eval"], MODEL)
    assert all("got no files" in e for e in errors[1:])


def test_train_eval_and_continuous_eval_over_a_mesh(world, records, tmp_path):
    """train_eval_model on 2 data x 2 fsdp ranks from shard_by_host
    records with an exporter pair and StepTimingHook, then continuous_eval
    over the same mesh: every rank returns the same metrics, rank 0 alone
    writes the single-device layout once (one checkpoint, one metrics
    stream per job, one export version per exporter) and times its steps,
    and the export serves on one device with no mesh."""
    model_dir = str(tmp_path)
    results = world.run(ranks.critic_train_eval, MODEL, records, model_dir, 2, 4)
    assert all(r["final"] == results[0]["final"] for r in results)
    assert all(r["evaluated"] == results[0]["evaluated"] for r in results)
    assert np.isfinite(results[0]["final"]["loss"])
    assert [r["timed_rows"] for r in results] == [1, None, None, None]
    assert state_lib.checkpoint_steps(model_dir) == [2]
    assert [r["step"] for r in read_metrics(os.path.join(model_dir, "train"))] == [1, 2]
    assert [r["step"] for r in read_metrics(os.path.join(model_dir, "eval"))] == [2, 2]
    with open(os.path.join(model_dir, "profiling", "step_timing.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [2]
    single = Critic(device_type="cpu", **MODEL)
    layout = {k: tuple(v.shape) for k, v in single.create_network().state_dict().items()}
    checkpoint = state_lib.load_checkpoint(model_dir, 2)
    assert {k: tuple(v.shape) for k, v in checkpoint["params"].items()} == layout
    for name in ("latest", "best", "continuous"):
        assert len(list_export_dirs(os.path.join(model_dir, "export", name))) == 1, name
    predictor = ExportedSavedModelPredictor(os.path.join(model_dir, "export", "latest"),
                                            device="cpu")
    assert predictor.restore()
    requests = make_random_numpy(predictor.get_feature_specification(), batch_size=2,
                                 seed=6)
    got = predictor.predict(requests)["q_predicted"]
    network = single.create_network()
    network.load_state_dict({**checkpoint["params"], **checkpoint["ema_params"]})
    trainer = train_eval.Trainer(single, device="cpu")
    from tensor2robot_tpu_torch.train.infeed import to_device

    with torch.inference_mode():
        features, _ = trainer.preprocessor.preprocess(
            to_device(requests, "cpu"), None, mode="predict")
    want = trainer.predict_step(network, features)["q_predicted"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
