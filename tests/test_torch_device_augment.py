"""The port's augmentation on the device against the JAX package's
``data/device_augment.py``.

Each op takes the numbers JAX drew (its key split as ``make_device_augment``
splits it) on seeded uint8 batches, a random and a smooth one, on the CPU.
Bounds, against the JAX op run eagerly (jitted, XLA rewrites the float32
divisions as products and the normalisation moves by up to a few hundred
ulps):

* flips exact; autocontrast, sharpness and jitter equal;
* both rotations within one uint8 level on at most 0.1% of the pixels (the
  cosine and sine of the angle may differ in the last bit between the
  libraries, which moves a sample point);
* the normalisation within one float32 ulp; the whole default list plus
  "brightness" and "jitter", normalised, within one level (1 / 255 /
  min std) on at most 0.1% of the values.

The port's own draws by their statistics, over 20,000 samples: each
probability (0.4, 0.4, 0.5, 0.5) within 0.015 (four binomial standard
deviations), the angles in [-90, 90) with mean within 1 and standard
deviation within 0.5 of the uniform's 51.96, the jitter factors in [0.9,
1.1) and [0.8, 1.2); ``two_view``'s views drawn independently; the
host-only augmentations refused by both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.data import device_augment as jda
from computervision_codes_tpu_torch.data import device_augment as da
from computervision_codes_tpu_torch.data.transforms import IMAGENET_STD

B, H, W = 4, 32, 56
ROT_SHARE = 1e-3
AUGS = ("original", "vflip", "hflip", "contrast", "rot90", "brightness",
        "jitter")
LEVEL = 1 / 255 / float(IMAGENET_STD.min())


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    smooth = (128 + 100 * np.sin(yy / 5.0) * np.cos(xx / 7.0))[..., None]
    smooth = np.repeat(np.broadcast_to(smooth, (H, W, 3))[None], B, 0)
    return {"random": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
            "smooth": smooth.astype(np.uint8)}


BATCHES = _batches()


def jax_draws(key, augs, b):
    """The numbers ``make_device_augment``'s core draws from ``key``, in
    the form ``apply_augment`` takes."""
    draws = []
    for aug in augs:
        if aug == "original":
            draws.append(None)
            continue
        key, sub = jax.random.split(key)
        if aug in da.PROBS:
            u = jax.random.uniform(sub, (b, 1, 1, 1))
            draws.append(torch.from_numpy(np.asarray(
                u < da.PROBS[aug]).reshape(-1)))
        elif aug == "rot90":
            draws.append(torch.from_numpy(np.asarray(jax.random.uniform(
                sub, (b,), minval=-90.0, maxval=90.0))))
        else:
            kb, kc = jax.random.split(sub)
            draws.append(tuple(torch.from_numpy(np.asarray(
                jax.random.uniform(k, (b,), minval=lo, maxval=hi)))
                for k, (lo, hi) in zip((kb, kc), da.JITTER_RANGES)))
    return draws


def _levels(got: torch.Tensor, want) -> np.ndarray:
    return np.abs(got.numpy().astype(np.int32)
                  - np.asarray(want).astype(np.int32))


@pytest.mark.parametrize("kind", sorted(BATCHES))
def test_ops_match_jax(kind):
    x = BATCHES[kind]
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    key = jax.random.PRNGKey(1)
    angles = jax.random.uniform(key, (B,), minval=-90.0, maxval=90.0)
    bf, cf = (jax.random.uniform(k, (B,), minval=lo, maxval=hi)
              for k, (lo, hi) in zip(jax.random.split(key),
                                     da.JITTER_RANGES))
    exact = {"autocontrast": (da.autocontrast_u8(xt),
                              jda.autocontrast_u8(xj)),
             "sharpness": (da.sharpness_u8(xt), jda.sharpness_u8(xj)),
             "jitter": (da.jitter_u8(xt, torch.from_numpy(np.asarray(bf)),
                                     torch.from_numpy(np.asarray(cf))),
                        jda.jitter_u8(xj, bf, cf))}
    for name, (got, want) in exact.items():
        assert got.dtype == torch.uint8
        assert _levels(got, want).max() == 0, name
    at = torch.from_numpy(np.asarray(angles))
    for name, got, want in (
            ("gather", da.rotate_expand_resize_u8(xt, at),
             jda.rotate_expand_resize_u8(xj, angles)),
            ("two_pass", da.rotate_expand_resize_fast(xt, at),
             jda.rotate_expand_resize_fast(xj, angles))):
        d = _levels(got, want)
        assert d.max() <= 1 and (d > 0).mean() <= ROT_SHARE, (name, d.max(),
                                                              (d > 0).mean())
    got = da.normalize_u8(xt).numpy()
    want = np.asarray(jda.normalize_u8(xj))
    assert np.abs(got.view(np.int32) - want.view(np.int32)).max() <= 1


def test_flips_exact_with_jax_draws():
    augs = ("original", "vflip", "hflip")
    x = BATCHES["random"]
    key = jax.random.PRNGKey(2)
    with jax.disable_jit():
        want = np.asarray(jda.make_device_augment(augs)(key, jnp.asarray(x)))
    draws = jax_draws(key, augs, B)
    assert draws[1].any() and not draws[1].all()  # both branches taken
    got = da.apply_augment(augs, torch.from_numpy(x), draws).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rot_impl", ["two_pass", "gather"])
def test_whole_list_matches_jax(rot_impl):
    x = BATCHES["smooth"]
    key = jax.random.PRNGKey(3)
    with jax.disable_jit():
        want = np.asarray(jda.make_device_augment(AUGS, rot_impl=rot_impl)(
            key, jnp.asarray(x)))
    got = da.apply_augment(AUGS, torch.from_numpy(x),
                           jax_draws(key, AUGS, B), rot_impl=rot_impl)
    assert got.dtype == torch.float32 and got.shape == want.shape
    d = np.abs(got.numpy() - want)
    assert d.max() <= LEVEL * 1.0001 and (d > 0).mean() <= ROT_SHARE


def test_draw_statistics():
    n = 20000
    draws = da.draw_augment(AUGS, n, torch.Generator().manual_seed(4))
    assert draws[0] is None
    for aug, d in zip(AUGS, draws):
        if aug in da.PROBS:
            assert d.dtype == torch.bool and d.shape == (n,)
            assert abs(d.float().mean().item() - da.PROBS[aug]) <= 0.015, aug
    angles = draws[AUGS.index("rot90")]
    assert angles.dtype == torch.float32
    assert angles.min() >= -90.0 and angles.max() < 90.0
    assert abs(angles.mean().item()) <= 1.0
    assert abs(angles.std().item() - 180 / 12 ** 0.5) <= 0.5
    for f, (lo, hi) in zip(draws[AUGS.index("jitter")], da.JITTER_RANGES):
        assert f.min() >= lo and f.max() < hi
        assert abs(f.mean().item() - (lo + hi) / 2) <= 0.01 * (hi - lo)
    # a step's generator: the same seed and folds draw the same numbers
    a = da.draw_augment(AUGS, 8, da.step_generator("cpu", 7, 0, 1))
    b = da.draw_augment(AUGS, 8, da.step_generator("cpu", 7, 0, 1))
    c = da.draw_augment(AUGS, 8, da.step_generator("cpu", 7, 1, 0))
    assert torch.equal(a[4], b[4]) and not torch.equal(a[4], c[4])


def test_two_views_independent_and_host_only_refused():
    x = torch.from_numpy(np.repeat(BATCHES["smooth"], 64, 0))
    g = torch.Generator().manual_seed(5)
    v1, v2 = da.make_device_augment(two_view=True)(g, x)
    assert v1.shape == v2.shape == x.shape and v1.dtype == torch.float32
    assert not torch.equal(v1, v2)
    # the views' draws: one generator, the first view's numbers first
    g1, g2 = (torch.Generator().manual_seed(6) for _ in range(2))
    first = da.draw_augment(da.DEFAULT_AUGS, 4096, g1)
    second = da.draw_augment(da.DEFAULT_AUGS, 4096, g1)
    assert torch.equal(first[1], da.draw_augment(da.DEFAULT_AUGS, 4096,
                                                 g2)[1])
    for a, b in zip(first[1:4], second[1:4]):  # the masks
        r = np.corrcoef(a.float().numpy(), b.float().numpy())[0, 1]
        assert abs(r) < 0.06
    for bad in (("original", "blur"), ("crop",)):
        with pytest.raises(ValueError, match="host-only"):
            da.make_device_augment(bad)
        with pytest.raises(ValueError, match="host-only"):
            jda.make_device_augment(bad)
    with pytest.raises(ValueError, match="rot_impl"):
        da.make_device_augment(rot_impl="nearest")
