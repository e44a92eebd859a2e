"""The port's fused scale-bias-act (K9), space-to-depth and blur pool
against the JAX package's ``ops/fused_norm.py``.

K9's plain version is held to the JAX ``fused_scale_bias_act``, which runs
the Pallas kernel interpreted off the TPU (``interpret=True``): in float32
both round the product and the sum once each, so within 1e-6 of the
largest magnitude; in bf16 the plain version rounds in bf16 after the
product, the sum and the slope (as the JAX reference does) where the TPU
kernel rounds its float32 result once, so each element within 2^-6 of
|x * scale| + |bias|. It is also held to the JAX reference op for op
(float32, 1e-6). ``space_to_depth`` is a permutation and must be equal;
``blur_pool`` within 1e-6 in float32 and one bf16 ulp of the largest
magnitude in bf16 (sums of nine products in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.ops import fused_norm as jfn
from computervision_codes_tpu_torch.ops import fused_norm
from computervision_codes_tpu_torch.ops.attention import vector_bytes

F32_REL = 1e-6


def _operands(shape, rng):
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    scale = rng.uniform(0.2, 2.0, c).astype(np.float32)
    bias = rng.normal(0.0, 0.5, c).astype(np.float32)
    return x, scale, bias


# C = 76 (TResNet-L's width; its bf16 row is 152 bytes), a ragged row
# count (3 * 5 * 7 = 105), C = 3 and a 2-D input
@pytest.mark.parametrize("shape", [(3, 5, 7, 76), (2, 4, 4, 3), (9, 20)])
@pytest.mark.parametrize("slope", [1e-2, 1e-3])
def test_plain_matches_jax_kernel_float32(shape, slope):
    x, scale, bias = _operands(shape, np.random.default_rng(0))
    want = np.asarray(jfn.fused_scale_bias_act(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), slope))
    got = fused_norm.fused_scale_bias_act(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        slope).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F32_REL * np.abs(want).max())
    ref = np.asarray(jfn.fused_scale_bias_act_reference(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), slope))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=F32_REL * np.abs(ref).max())


@pytest.mark.parametrize("shape", [(3, 5, 7, 76), (2, 4, 4, 3)])
def test_plain_matches_jax_kernel_bf16(shape):
    x, scale, bias = _operands(shape, np.random.default_rng(1))
    xb = jnp.asarray(x, jnp.bfloat16)
    sb, bb = (jnp.asarray(a, jnp.bfloat16) for a in (scale, bias))
    want = np.asarray(jfn.fused_scale_bias_act(xb, sb, bb, 1e-3), np.float32)
    tx, ts, tb = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                  for a in (xb, sb, bb))
    got = fused_norm.fused_scale_bias_act(tx, ts, tb, 1e-3)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    xs = np.abs(np.asarray(xb, np.float32) * np.asarray(sb, np.float32))
    bound = 2.0 ** -6 * (xs + np.abs(np.asarray(bb, np.float32)))
    assert (np.abs(got.float().numpy() - want) <= bound).all()


def test_cuda_wrapper_refuses_cpu_and_dispatch_refuses_other_devices():
    x = torch.zeros(2, 76)
    with pytest.raises(ValueError, match="CUDA"):
        fused_norm.fused_scale_bias_act_cuda(x, x[0], x[0])
    m = torch.zeros(2, 76, device="meta")
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        fused_norm.fused_scale_bias_act(m, m[0], m[0])


def test_load_width_follows_alignment_and_channels():
    """K9's load width (``ops.attention.vector_bytes`` of x): 16 bytes
    where the base address and C allow, 8 at TResNet-L's 76 bf16 channels
    (152-byte rows), one element at C = 3 or an odd offset."""
    buf = torch.zeros(4096, dtype=torch.bfloat16)
    assert vector_bytes([buf[:152].view(2, 76)], 2) == 8
    assert vector_bytes([buf[:304].view(2, 152)], 2) == 16
    assert vector_bytes([buf[:6].view(2, 3)], 2) == 2
    assert vector_bytes([buf[1:153].view(2, 76)], 2) == 2
    f = torch.zeros(1024)
    assert vector_bytes([f[:152].view(2, 76)], 4) == 16
    assert vector_bytes([f[2:154].view(2, 76)], 4) == 8


def test_space_to_depth_matches_jax_channel_order():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 12, 3)).astype(np.float32)
    got = fused_norm.space_to_depth(torch.from_numpy(x), 4).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jfn.space_to_depth(jnp.asarray(x), 4)))
    # channel (dy * 4 + dx) * 3 + c of cell (i, j) is pixel (4i + dy,
    # 4j + dx), channel c: the order the stem conv's kernel is laid out in
    for dy, dx, c in ((0, 0, 0), (1, 2, 1), (3, 3, 2), (2, 0, 1)):
        np.testing.assert_array_equal(got[:, 1, 2, (dy * 4 + dx) * 3 + c],
                                      x[:, 4 + dy, 8 + dx, c])


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_blur_pool_matches_jax(hw):
    x = np.random.default_rng(3).standard_normal((2, *hw, 5)).astype(
        np.float32)
    want = np.asarray(jfn.blur_pool(jnp.asarray(x)))
    got = fused_norm.blur_pool(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    wb = np.asarray(jfn.blur_pool(jnp.asarray(x, jnp.bfloat16)), np.float32)
    gb = fused_norm.blur_pool(torch.from_numpy(x).bfloat16()).float().numpy()
    top = np.abs(wb).max()
    assert np.abs(gb - wb).max() <= 2.0 ** (np.floor(np.log2(top)) - 7)
