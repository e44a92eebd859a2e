"""The port's attention (K7's plain version and its dispatch) against the
JAX package's ``ops/attention.py``.

Inputs are made from a seed with numpy and go through both packages. On
the CPU ``multi_head_attention`` takes the plain version; the CUDA kernel
is held to that plain version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.ops.attention import (
    attention_pallas as jax_attention_pallas,
)
from computervision_codes_tpu.ops.attention import (
    attention_reference as jax_attention_reference,
)
from computervision_codes_tpu.ops.attention import (
    multi_head_attention as jax_mha,
)
from computervision_codes_tpu_torch.ops import attention
from computervision_codes_tpu_torch.ops.attention import (
    attention_cuda,
    attention_reference,
    multi_head_attention,
)

# float32: the same ops in the same order; sums of up to 300 products in
# another order (einsum on each side) stay far inside 2e-6 at |out| <= 3
F32_ATOL = 2e-6
# bf16: both sides round q * scale, the scores and the weights to bf16 and
# sum in float32, so an output can move by one bf16 ulp of |out| <= 4
# (2^-6) where a score lands on the other side of a rounding boundary
BF16_ATOL = 2.0 ** -6
# the interpreted TPU kernel keeps q * scale, the scores and the weights in
# float32 and pads D to 128 and T to a multiple of 128 (masked keys); it
# sums in another order than the plain version: the JAX kernel test's 2e-5
PALLAS_ATOL = 2e-5


def _qkv(rng, b, h, tq, tk, d):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d))]


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(2, 3, 50, 50, 24), (1, 2, 40, 17, 8),
                                   (1, 4, 33, 33, 27)])
def test_reference_matches_jax_f32(rng, shape):
    q, k, v = _qkv(rng, *shape)
    want = np.asarray(jax_attention_reference(*map(jnp.asarray, (q, k, v))))
    got = attention_reference(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(2, 3, 50, 50, 24), (1, 2, 40, 17, 12)])
def test_reference_matches_jax_bf16(rng, shape):
    q, k, v = _qkv(rng, *shape)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_attention_reference(jq, jk, jv).astype(jnp.float32))
    got = attention_reference(_bf16(q), _bf16(k), _bf16(v))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL,
                               rtol=0)


@pytest.mark.parametrize("tq,tk,d", [(300, 300, 12), (300, 300, 27),
                                     (300, 300, 32), (300, 141, 27)])
def test_reference_matches_interpreted_tpu_kernel(rng, tq, tk, d):
    """The TPU kernel in interpret mode, as tests/test_ops_attention.py runs
    it: T = 300 is ragged against its 128-row tiles and 256-row query
    blocks."""
    q, k, v = _qkv(rng, 1, 2, tq, tk, d)
    want = np.asarray(jax_attention_pallas(*map(jnp.asarray, (q, k, v))))
    got = attention_reference(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=PALLAS_ATOL, rtol=0)


def test_multi_head_attention_cpu_takes_plain_version(rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 2, 20, 20, 8))
    before = attention_cuda.launches
    got = multi_head_attention(q, k, v)
    assert attention_cuda.launches == before
    torch.testing.assert_close(got, attention_reference(q, k, v), rtol=0,
                               atol=0)


def test_multi_head_attention_grad_matches_jax(rng):
    """The backward differentiates the plain version, as JAX's _mha_bwd:
    d/d(q, k, v) of sum(sin(out)) equals jax.grad of the JAX function."""
    q, k, v = _qkv(rng, 1, 2, 16, 12, 8)

    def loss(q, k, v):
        return jnp.sum(jnp.sin(jax_mha(q, k, v)))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    torch.sin(multi_head_attention(tq, tk, tv)).sum().backward()
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-6,
                                   rtol=0)


def test_attention_cuda_rejects_what_it_does_not_take(rng):
    q = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CPU"):
        attention._forward(q.to("meta"), q.to("meta"), q.to("meta"))


def test_vector_bytes_follows_alignment():
    """The widest copy every row allows: the MS-TCT views of a (B, T, 3C)
    bf16 buffer at D = 108 (216-byte rows) take 8 bytes, D = 72 16."""
    for d, want in ((108, 8), (72, 16), (27, 2)):
        x = torch.zeros(1, 10, 3 * 8 * d, dtype=torch.bfloat16)
        views = [x[..., i * 8 * d:(i + 1) * 8 * d].reshape(1, 10, 8, d)
                 .transpose(1, 2) for i in range(3)]
        assert attention.vector_bytes(views, 2) == want, d
    f = torch.zeros(1, 8, 10, 27)
    assert attention.vector_bytes([f], 4) == 4
