"""The port's Grasp2Vec (research/grasp2vec/) against the JAX package's.

  * Every loss of losses.py on seeded embeddings (masks full, partial and
    empty; n-pairs with and without the non-negativity constraint),
    within 1e-5 abs + rel.
  * The preprocessor with no generator (center crops, no flips) equals
    JAX's with no rng bit for bit; with a generator the scene pair shares
    one crop offset and one flip decision per image, the goal has its
    own, every output is a flip of a window of its source, and the
    offsets spread over the crop window.
  * Embedding and the model's forward (ResNet-18, 32x32 crops of 512x640
    sources, batch 2) from the same seeded variables: every output in
    eval mode in float32 within 1e-5 relative and 1e-5 of max(1, the
    tensor's max) absolute (tests/test_torch_resnet.py says why); one
    train step's loss (n-pairs and triplet) and every gradient in float64
    (the goal tower's last block layer is 1x1 over 2 images, so float32
    train-mode batch norms differ by rounding; test_torch_resnet.py),
    the loss within 1e-5 rel and each gradient within 1e-4 of its leaf's
    max. Then the port's Trainer takes two float32 steps.
  * The visualizations: heatmaps, soft-argmax, rendered keypoints and the
    softmax grid equal JAX's.
"""

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.research import grasp2vec as jax_g2v
from tensor2robot_tpu.research.grasp2vec import visualization as jax_viz
from tensor2robot_tpu_torch.research import grasp2vec
from tensor2robot_tpu_torch.research.grasp2vec import visualization
from tensor2robot_tpu_torch.train import train_eval
from tensor2robot_tpu_torch.train.infeed import to_device
from tensor2robot_tpu_torch.utils import jax_params
from tests.test_torch_resnet import (
    GRAD_TOL,
    TOL,
    assert_close,
    assert_grads_close,
    float64,
    grads_as_state_dict,
    host,
    seeded_variables,
)

SIZE = (32, 32)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _embeddings(seed=0, n=6, d=8):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((n, d)).astype(np.float32) for _ in range(3)]


MASKS = {"full": np.ones(6, np.int32), "partial": np.array([1, 0, 1, 1, 0, 0], np.int32),
         "empty": np.zeros(6, np.int32)}


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("name", ["l2_arithmetic_loss", "cosine_arithmetic_loss"])
def test_arithmetic_losses_match_jax(name, mask):
    pre, goal, post = _embeddings()
    want = getattr(jax_g2v, name)(pre, goal, post, MASKS[mask])
    got = getattr(grasp2vec, name)(*map(torch.from_numpy, (pre, goal, post, MASKS[mask])))
    assert_close(got, want, TOL, name)


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_send_to_zero_loss_matches_jax(mask):
    x = _embeddings(1)[0]
    assert_close(grasp2vec.send_to_zero_loss(torch.from_numpy(x), torch.from_numpy(MASKS[mask])),
                 jax_g2v.send_to_zero_loss(x, MASKS[mask]), TOL)


def test_npairs_losses_match_jax():
    pre, goal, post = _embeddings(2)
    labels = np.array([0, 1, 1, 2, 3, 3], np.int32)  # repeated labels: soft targets
    assert_close(grasp2vec.npairs_loss(*map(torch.from_numpy, (labels, pre, goal))),
                 jax_g2v.npairs_loss(labels, pre, goal), TOL)
    for constrained in (False, True):
        want = jax_g2v.npairs_embedding_loss(pre, goal, post, constrained)
        got = grasp2vec.npairs_embedding_loss(*map(torch.from_numpy, (pre, goal, post)),
                                              non_negativity_constraint=constrained)
        assert_close(got, want, TOL, f"non-negativity {constrained}")


def test_triplet_embedding_loss_matches_jax():
    pre, goal, post = _embeddings(3)
    loss, pairs, labels = jax_g2v.triplet_embedding_loss(pre, goal, post)
    got = grasp2vec.triplet_embedding_loss(*map(torch.from_numpy, (pre, goal, post)))
    assert_close(got[0], loss, TOL)
    assert_close(got[1], pairs, TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(labels))


def test_keypoint_accuracy_matches_jax():
    rng = np.random.RandomState(4)
    keypoints = rng.uniform(-1, 1, (8, 2)).astype(np.float32)
    labels = rng.randint(0, 4, 8)
    accuracy, loss = jax_g2v.keypoint_accuracy(keypoints, labels)
    got = grasp2vec.keypoint_accuracy(torch.from_numpy(keypoints), torch.from_numpy(labels))
    assert_close(got[0], accuracy, TOL)
    assert_close(got[1], loss, TOL)


def _raw_features(batch=2, seed=0):
    rng = np.random.RandomState(seed)
    return {key: rng.randint(0, 256, (batch, 512, 640, 3)).astype(np.uint8)
            for key in ("pregrasp_image", "postgrasp_image", "goal_image")}


def _models(**kwargs):
    kwargs = dict(scene_size=SIZE, goal_size=SIZE, resnet_size=18, device_type="cpu",
                  **kwargs)
    port_kwargs = dict(kwargs)
    if "embedding_loss_fn" in kwargs:
        name = kwargs["embedding_loss_fn"]
        kwargs["embedding_loss_fn"] = getattr(jax_g2v, name)
        port_kwargs["embedding_loss_fn"] = getattr(grasp2vec, name)
    return jax_g2v.Grasp2VecModel(**kwargs), grasp2vec.Grasp2VecModel(**port_kwargs)


def test_specs_match_jax():
    jax_model, model = _models()
    for mode in ("train", "eval", "predict"):
        for get in ("get_feature_specification", "get_label_specification"):
            want, got = getattr(jax_model, get)(mode), getattr(model, get)(mode)
            assert sorted(want.keys()) == sorted(got.keys())
            for key in want.keys():
                assert (want[key].shape, want[key].name) == (got[key].shape, got[key].name)
        want = jax_model.preprocessor.get_in_feature_specification(mode)
        got = model.preprocessor.get_in_feature_specification(mode)
        for key in want.keys():
            assert (tuple(got[key].shape), str(got[key].dtype), got[key].data_format) == (
                (512, 640, 3), "torch.uint8", "jpeg")
    with pytest.raises(ValueError, match="exceeds"):
        grasp2vec.Grasp2VecModel(scene_size=(520, 32))


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_preprocessor_without_generator_matches_jax(mode):
    jax_model, model = _models()
    raw = _raw_features()
    want, _ = jax_model.preprocessor.preprocess(dict(raw), None, mode=mode, rng=None)
    got, _ = model.preprocessor.preprocess(
        {k: torch.from_numpy(v) for k, v in raw.items()}, None, mode=mode)
    for key in raw:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


def test_preprocessor_draws_shared_scene_crops_and_flips():
    """Train mode with a generator: each output is a (possibly flipped)
    window of its source; pre and post share the offset and the flips."""
    _, model = _models()
    raw = _raw_features(batch=4, seed=1)
    sources = {k: torch.from_numpy(v).float() / 255.0 for k, v in raw.items()}
    offsets, flip_counts = set(), 0
    for seed in range(6):
        out, _ = model.preprocessor.preprocess(
            {k: torch.from_numpy(v) for k, v in raw.items()}, None, mode="train",
            generator=torch.Generator().manual_seed(seed))
        found = {}
        for key in raw:
            found[key] = [_locate(out[key][i], sources[key][i]) for i in range(4)]
        assert [f[0] for f in found["pregrasp_image"]] == [
            f[0] for f in found["postgrasp_image"]]
        assert [f[1] for f in found["pregrasp_image"]] == [
            f[1] for f in found["postgrasp_image"]]
        assert len({f[0] for f in found["pregrasp_image"]}) == 1  # one offset a batch
        offsets.add(found["pregrasp_image"][0][0])
        offsets.add(found["goal_image"][0][0])
        flip_counts += sum(f[1] != (False, False) for f in found["goal_image"])
    assert len(offsets) > 6 and 0 < flip_counts < 24


def _locate(crop, source):
    """(offset, (lr, ud)) at which `crop` is a flipped window of `source`."""
    h, w = crop.shape[:2]
    for lr in (False, True):
        for ud in (False, True):
            c = crop.flip(1) if lr else crop
            c = c.flip(0) if ud else c
            corner = c[0, 0]
            hits = torch.nonzero((source[: 512 - h + 1, : 640 - w + 1] == corner).all(-1))
            for y, x in hits.tolist():
                if torch.equal(source[y:y + h, x:x + w], c):
                    return (y, x), (lr, ud)
    raise AssertionError("crop is not a flipped window of its source")


def _jax_variables(jax_model, features, seed=1):
    shapes = jax.eval_shape(lambda: jax_model.init_variables(jax.random.PRNGKey(0),
                                                             features))
    return seeded_variables(shapes, seed)


def _preprocessed(jax_model, raw):
    features, _ = jax_model.preprocessor.preprocess(dict(raw), None, mode="eval", rng=None)
    return {k: np.array(v) for k, v in features.items()}


def test_embedding_matches_jax():
    from tensor2robot_tpu.research.grasp2vec.networks import Embedding as JaxEmbedding

    images = np.random.RandomState(5).uniform(0, 1, (2, 37, 37, 3)).astype(np.float32)
    jax_net = JaxEmbedding(resnet_size=18)
    shapes = jax.eval_shape(lambda: jax_net.init(jax.random.PRNGKey(0), images))
    variables = seeded_variables(shapes, seed=2)
    port = grasp2vec.Embedding(resnet_size=18)
    jax_params.load_flax_variables(port, variables)
    want = jax_net.apply(variables, images)
    with torch.no_grad():
        got = port(torch.from_numpy(images))
    assert_close(got[0], want[0], TOL, "vector")
    assert_close(got[1], want[1], TOL, "spatial")


@pytest.mark.parametrize("loss_name", ["npairs_embedding_loss", "triplet_embedding_loss"])
def test_model_forward_and_train_step_match_jax(loss_name):
    jax_model, model = _models(embedding_loss_fn=loss_name)
    raw = _raw_features(seed=2)
    features = _preprocessed(jax_model, raw)
    variables = _jax_variables(jax_model, features)
    network = model.create_network()
    jax_params.load_flax_variables(network, variables)

    want, _ = jax_model.inference_network_fn(variables, features, "eval")
    torch_features = {k: torch.from_numpy(v) for k, v in features.items()}
    with torch.no_grad():
        got, _ = model.inference_network_fn(network, torch_features, "eval")
    assert set(got) == set(want)
    for key in want:
        assert_close(got[key], want[key], TOL, key)

    def loss_fn(params, f):
        outputs, _ = jax_model.inference_network_fn(dict(variables, params=params), f,
                                                    "train")
        return jax_model.model_train_fn(f, {}, outputs, "train")[0]

    with jax.enable_x64(True):
        variables = float64(variables)
        loss, grads = host(jax.value_and_grad(loss_fn)(variables["params"],
                                                         float64(features)))
    network = network.double()
    network.train()
    outputs, _ = model.inference_network_fn(
        network, {k: v.double() for k, v in torch_features.items()}, "train")
    got_loss, metrics = model.model_train_fn(None, None, outputs, "train")
    got_loss.backward()
    assert set(metrics) == {"embed_loss"}
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=TOL)
    assert_grads_close({k: p.grad for k, p in network.named_parameters()},
                       grads_as_state_dict(grads), GRAD_TOL)


def test_trainer_steps_on_raw_batches():
    """Two float32 Trainer steps from uint8 sources (random crops and
    flips from the step generators): finite, decreasing nothing in
    particular, but changing the weights and the batch-norm statistics."""
    _, model = _models()
    batch = to_device({f"features/{k}": v for k, v in _raw_features(seed=3).items()}, "cpu")
    trainer = train_eval.Trainer(model, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in state.network.state_dict().items()}
    for _ in range(2):
        metrics = trainer.train_step(state, batch)
        assert np.isfinite(metrics["loss"].item())
    after = state.network.state_dict()
    assert not torch.equal(before["scene.resnet.initial_conv.Conv_0.weight"],
                           after["scene.resnet.initial_conv.Conv_0.weight"])
    assert not torch.equal(before["goal.resnet.postact_bn.bn.mean"],
                           after["goal.resnet.postact_bn.bn.mean"])
    evals = trainer.eval_step(state, batch)
    assert set(evals) == {"loss", "embed_loss"}


def test_visualization_matches_jax():
    rng = np.random.RandomState(6)
    query = rng.standard_normal((2, 16)).astype(np.float32)
    fmap = rng.standard_normal((2, 5, 7, 16)).astype(np.float32)
    want = jax_viz.compute_heatmap(query, fmap)
    got = visualization.compute_heatmap(torch.from_numpy(query), torch.from_numpy(fmap))
    for g, w in zip(got, want):
        assert_close(g, w, TOL)
    assert_close(visualization.heatmap_soft_argmax(got[0]),
                 jax_viz.heatmap_soft_argmax(want[0]), TOL)
    image = rng.rand(2, 12, 10, 3)
    locations = rng.uniform(-1, 1, (2, 4, 2))
    np.testing.assert_array_equal(visualization.np_render_keypoints(image, locations, 2),
                                  jax_viz.np_render_keypoints(image, locations, 2))
    for shape, softmax_shape in (((1, 16, 16, 3), (1, 8, 8, 4)),
                                 ((2, 9, 11, 3), (2, 6, 5, 6))):
        image = rng.rand(*shape)
        softmax = rng.rand(*softmax_shape)
        np.testing.assert_allclose(visualization.get_softmax_viz(image, softmax),
                                   jax_viz.get_softmax_viz(image, softmax), atol=1e-6)
