"""The port's PIL-free transforms (``data/transforms.py``) against the JAX
package's PIL transforms, from the same seed.

Tolerances: flips, autocontrast, jitter (Brightness then Contrast) and
brightness (Sharpness) exact — the same lookup tables and the same float32
blends as PIL's C code; rot90 the same expanded shape with at most 0.5% of
the pixels differing (PIL's 16.16 fixed-point map reproduced: here none);
resizes within 1 LSB at uint8 (the native plane's fixed-point bilinear
against Pillow's), so within 1 / (255 * 0.224) after the ImageNet
normalisation; ``train_transform`` within that on a frame at its size
(the port decodes at it), the resize after a rotation included. Every
augmentation also leaves both generators in the same state: the same
draws in the same order.
"""

import numpy as np
import pytest
from PIL import Image

from computervision_codes_tpu.data import transforms as jax_t
from computervision_codes_tpu_torch.data import transforms as T

LSB = 1.0 / (255.0 * float(T.IMAGENET_STD.min())) + 1e-6
EXACT_AUGS = ("vflip", "hflip", "contrast", "jitter", "brightness")


def _image(seed, shape=(48, 80, 3), low=0, high=256):
    rng = np.random.default_rng(seed)
    return rng.integers(low, high, shape).astype(np.uint8)


def _same_state(a: np.random.Generator, b: np.random.Generator) -> None:
    assert a.random() == b.random()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("aug", EXACT_AUGS)
def test_augmentation_exact(aug, seed):
    # a low-contrast image, so that autocontrast stretches it
    img = _image(seed, low=30, high=200)
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    want = np.asarray(jax_t.apply_augmentations(ra, Image.fromarray(img),
                                                [aug]))
    got = T.apply_augmentations(rb, img, [aug])
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    _same_state(ra, rb)


@pytest.mark.parametrize("seed", range(6))
def test_rot90_matches_pil_rotate(seed):
    img = _image(seed, shape=(37, 61, 3))
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    want = np.asarray(jax_t.apply_augmentations(ra, Image.fromarray(img),
                                                ["rot90"]))
    got = T.apply_augmentations(rb, img, ["rot90"])
    assert got.shape == want.shape
    assert np.mean(np.any(got != want, axis=-1)) <= 0.005
    _same_state(ra, rb)


@pytest.mark.parametrize("angle", [0.0, 90.0, -90.0, 180.0, 45.0, -0.3])
def test_rotate_special_angles(angle):
    img = _image(9, shape=(20, 31, 3))
    want = np.asarray(Image.fromarray(img).rotate(angle, expand=True))
    np.testing.assert_array_equal(T._rotate(img, angle), want)


def test_autocontrast_flat_channel():
    img = _image(3)
    img[..., 1] = 77  # hi <= lo: identity lookup table
    want = np.asarray(jax_t._autocontrast(Image.fromarray(img)))
    np.testing.assert_array_equal(T._autocontrast(img), want)


def test_unknown_augmentation_raises():
    with pytest.raises(ValueError, match="unknown"):
        T.apply_augmentations(np.random.default_rng(0), _image(0), ["blur"])


@pytest.mark.parametrize("seed", range(4))
def test_train_transform_matches_jax(seed):
    """The default list on a frame already at ``size``, as the port's
    ``load_frame`` decodes it: the first resize is the identity in both
    packages, the augmentations exact (rot90 as held above), so the only
    difference is the resize after a rotation, within 1 LSB."""
    size = (32, 56)
    img = _image(seed, shape=size + (3,), low=20, high=220)
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    want = jax_t.train_transform(ra, Image.fromarray(img), size)
    got = T.train_transform(rb, img, size)
    assert got.dtype == np.float32 and got.shape == size + (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=LSB)
    _same_state(ra, rb)


@pytest.mark.parametrize("seed", range(2))
def test_train_transform_resize_within_one_lsb(seed):
    """From another size: the first resize within 1 LSB, the flips exact.
    (Autocontrast after it stretches a 1-LSB difference by 255 / (hi -
    lo), so it is held on equal inputs above.)"""
    img = _image(seed, shape=(61, 97, 3))
    augs = ("original", "vflip", "hflip")
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    want = jax_t.train_transform(ra, Image.fromarray(img), (32, 56), augs)
    got = T.train_transform(rb, img, (32, 56), augs)
    np.testing.assert_allclose(got, want, rtol=0, atol=LSB)
    _same_state(ra, rb)


@pytest.mark.parametrize("size", [(32, 56), (61, 97), (80, 120)])
def test_eval_and_raw_resize_match_jax(size):
    img = _image(7, shape=(61, 97, 3))
    want = jax_t.eval_transform(Image.fromarray(img), size)
    got = T.eval_transform(img, size)
    np.testing.assert_allclose(got, want, rtol=0, atol=LSB)
    want = jax_t.raw_resize_u8(Image.fromarray(img), size)
    got = T.raw_resize_u8(img, size)
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= 1


def test_constants_match_jax():
    np.testing.assert_array_equal(T.IMAGENET_MEAN, jax_t.IMAGENET_MEAN)
    np.testing.assert_array_equal(T.IMAGENET_STD, jax_t.IMAGENET_STD)
    assert T.DEFAULT_SIZE == jax_t.DEFAULT_SIZE
    assert T.DEFAULT_AUGS == jax_t.DEFAULT_AUGS
