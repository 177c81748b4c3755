"""The port's image transformations against the JAX package's.

tensor2robot_tpu_torch/preprocessors/image_transformations.py vs
tensor2robot_tpu/preprocessors/image_transformations.py on the same numpy
images. Random ops are compared with the JAX draws injected into the
port's apply (threefry keys cannot be reproduced with a torch generator):
the crop offsets and the per-image distortion parameters are drawn here
exactly as the JAX functions draw them. Float results within 1e-6 (abs +
rel); crops exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.preprocessors import image_transformations as jax_it
from tensor2robot_tpu_torch.preprocessors import distortion
from tensor2robot_tpu_torch.preprocessors import image_transformations as it

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _images(shape=(3, 20, 24, 3), seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def jax_crop_draws(key, batch, image_hw, target):
    """random_crop_image_batch's offsets, as it draws them."""
    key_y, key_x = jax.random.split(key)
    ys = jax.random.randint(key_y, (batch,), 0, image_hw[0] - target[0] + 1)
    xs = jax.random.randint(key_x, (batch,), 0, image_hw[1] - target[1] + 1)
    return torch.from_numpy(np.array(ys)), torch.from_numpy(np.array(xs))


def jax_photometric_draws(key, images_shape, max_delta_brightness=32.0 / 255.0,
                          lower_saturation=0.5, upper_saturation=1.5,
                          max_delta_hue=0.2, lower_contrast=0.5,
                          upper_contrast=1.5, noise_stddev=0.0,
                          random_order=False):
    """apply_photometric_image_distortions' per-image draws, as it draws
    them (split per image, then six keys each)."""
    values = {f: [] for f in ("brightness", "saturation", "hue", "contrast",
                              "order", "noise")}
    for image_key in jax.random.split(key, images_shape[0]):
        k_b, k_s, k_h, k_c, k_n, k_o = jax.random.split(image_key, 6)
        values["brightness"].append(jax.random.uniform(
            k_b, (), minval=-max_delta_brightness, maxval=max_delta_brightness))
        values["saturation"].append(jax.random.uniform(
            k_s, (), minval=lower_saturation, maxval=upper_saturation))
        values["hue"].append(jax.random.uniform(
            k_h, (), minval=-max_delta_hue, maxval=max_delta_hue))
        values["contrast"].append(jax.random.uniform(
            k_c, (), minval=lower_contrast, maxval=upper_contrast))
        values["order"].append(jax.random.randint(k_o, (), 0, 4))
        values["noise"].append(jax.random.normal(k_n, tuple(images_shape[1:])))
    tensors = {k: torch.from_numpy(np.stack([np.asarray(x) for x in v]))
               for k, v in values.items()}
    return it.PhotometricDraws(
        tensors["brightness"], tensors["saturation"], tensors["hue"],
        tensors["contrast"],
        order=tensors["order"] if random_order else None,
        noise=tensors["noise"] if noise_stddev > 0 else None,
    )


class TestCrops:
    def test_random_crop_with_the_jax_offsets(self):
        images = (_images((4, 30, 40, 3)) * 255).astype(np.uint8)
        key = jax.random.PRNGKey(3)
        want = jax_it.random_crop_image_batch(key, jnp.asarray(images), (20, 24))
        ys, xs = jax_crop_draws(key, 4, (30, 40), (20, 24))
        got = it.crop_image_batch_at(torch.from_numpy(images), ys, xs, (20, 24))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_random_crop_draws_in_range_and_from_the_generator(self):
        images = torch.from_numpy(_images((64, 30, 40, 3)))
        a = it.random_crop_image_batch(torch.Generator().manual_seed(1), images, (20, 24))
        b = it.random_crop_image_batch(torch.Generator().manual_seed(1), images, (20, 24))
        assert torch.equal(a, b) and a.shape == (64, 20, 24, 3)
        ys, xs = it.draw_random_crop_offsets(torch.Generator().manual_seed(2), 512,
                                             (30, 40), (20, 24))
        assert ys.min() == 0 and ys.max() == 10 and xs.min() == 0 and xs.max() == 16

    @pytest.mark.parametrize("target", [(20, 24), (19, 23), (30, 40)])
    def test_center_crop(self, target):
        images = _images((2, 30, 40, 3))
        np.testing.assert_array_equal(
            it.center_crop_image_batch(torch.from_numpy(images), target).numpy(),
            np.asarray(jax_it.center_crop_image_batch(jnp.asarray(images), target)))

    def test_custom_crop_and_bounds(self):
        images = _images((2, 30, 40, 3))
        np.testing.assert_array_equal(
            it.custom_crop_image_batch(torch.from_numpy(images), 3, 5, (20, 24)).numpy(),
            np.asarray(jax_it.custom_crop_image_batch(jnp.asarray(images), 3, 5, (20, 24))))
        with pytest.raises(ValueError, match="exceeds image"):
            it.custom_crop_image_batch(torch.from_numpy(images), 11, 0, (20, 24))
        with pytest.raises(ValueError, match="larger than image"):
            it.center_crop_image_batch(torch.from_numpy(images), (31, 10))


class TestPhotometric:
    def test_hsv_round_trip_matches(self):
        # Include grays (delta 0), blacks (max 0) and each channel as max.
        images = _images((2, 16, 16, 3), seed=1)
        images[0, 0, :4] = [[0, 0, 0], [0.5, 0.5, 0.5], [1, 0, 0], [0, 1, 0]]
        hsv = it._rgb_to_hsv(torch.from_numpy(images))
        _close(hsv, jax_it._rgb_to_hsv(jnp.asarray(images)))
        _close(it._hsv_to_rgb(hsv), jax_it._hsv_to_rgb(jnp.asarray(hsv.numpy())))

    @pytest.mark.parametrize("name,value", [
        ("adjust_brightness", 0.1), ("adjust_contrast", 1.3),
        ("adjust_saturation", 0.6), ("adjust_hue", -0.15), ("adjust_hue", 0.2),
    ])
    def test_adjust_with_a_scalar(self, name, value):
        images = _images(seed=2)
        got = getattr(it, name)(torch.from_numpy(images), value)
        want = jax.vmap(lambda im: getattr(jax_it, name)(im, value))(jnp.asarray(images))
        _close(got, want)

    @pytest.mark.parametrize("name", ["adjust_brightness", "adjust_contrast",
                                      "adjust_saturation", "adjust_hue"])
    def test_adjust_with_one_value_per_image(self, name):
        images = _images(seed=3)
        values = np.array([-0.1, 0.05, 0.17], np.float32) + (
            0.0 if name in ("adjust_brightness", "adjust_hue") else 1.0)
        got = getattr(it, name)(torch.from_numpy(images), torch.from_numpy(values))
        want = jax.vmap(getattr(jax_it, name))(jnp.asarray(images), jnp.asarray(values))
        _close(got, want)

    @pytest.mark.parametrize("kw", [
        dict(), dict(random_order=True), dict(noise_stddev=0.05),
        dict(max_delta_hue=0.4, lower_contrast=0.8, random_order=True,
             noise_stddev=0.1),
    ], ids=["default", "random_order", "noise", "all"])
    def test_distortion_with_the_jax_draws(self, kw):
        images = _images((8, 12, 14, 3), seed=4)
        key = jax.random.PRNGKey(7)
        want = jax_it.apply_photometric_image_distortions(key, jnp.asarray(images), **kw)
        draws = jax_photometric_draws(key, images.shape, **kw)
        got = it.apply_photometric_image_distortions(
            None, torch.from_numpy(images), draws=draws, **kw)
        _close(got, want)
        if kw.get("random_order"):
            assert len(set(draws.order.tolist())) > 1

    def test_distortion_from_a_generator_is_reproducible(self):
        images = torch.from_numpy(_images((4, 8, 8, 3), seed=5))
        runs = [it.apply_photometric_image_distortions(
            torch.Generator().manual_seed(9), images, random_order=True,
            noise_stddev=0.1) for _ in range(2)]
        assert torch.equal(*runs)
        assert 0.0 <= runs[0].min() and runs[0].max() <= 1.0

    def test_depth_distortion_with_the_jax_noise(self):
        depth = _images((2, 10, 10, 1), seed=6)
        key = jax.random.PRNGKey(2)
        want = jax_it.apply_depth_image_distortions(key, jnp.asarray(depth),
                                                    noise_stddev=0.3)
        noise = torch.from_numpy(np.array(jax.random.normal(key, depth.shape)))
        got = it.apply_depth_image_distortions(None, torch.from_numpy(depth),
                                               noise_stddev=0.3, noise=noise)
        _close(got, want)


class TestComposites:
    @pytest.mark.parametrize("target", [(10, 12), (40, 30), (20, 7)])
    def test_resize_matches_jax_image_resize(self, target):
        images = _images((2, 20, 24, 3), seed=7)
        _close(it.resize_image_batch(torch.from_numpy(images), target),
               jax_it.resize_image_batch(jnp.asarray(images), target))

    @pytest.mark.parametrize("shape", [(3, 30, 40, 3), (2, 2, 30, 40, 3)])
    def test_preprocess_image_eval_path(self, shape):
        images = (_images(shape, seed=8) * 255).astype(np.uint8)
        kw = dict(crop_size=(20, 24), target_size=(10, 12), distort=True)
        want = jax_it.preprocess_image(jnp.asarray(images), "eval", **kw)
        got = distortion.preprocess_image(torch.from_numpy(images), "eval", **kw)
        assert got.shape == want.shape
        _close(got, want)

    def test_train_helpers_need_train_mode_and_a_generator(self):
        images = torch.from_numpy(_images((2, 30, 40, 3), seed=9))
        assert distortion.maybe_distort_image_batch(None, images, "train") is images
        assert distortion.maybe_distort_image_batch(
            torch.Generator(), images, "eval") is images
        center = it.center_crop_image_batch(images, (20, 24))
        assert torch.equal(distortion.crop_image(None, images, (20, 24), "train"), center)
        assert torch.equal(distortion.crop_image(torch.Generator(), images, (20, 24),
                                                 "eval"), center)
        assert distortion.crop_image(torch.Generator().manual_seed(0), images,
                                     (20, 24), "train").shape == center.shape
