"""The port's Swin kernels K3, K4 and K5 (plain versions) against the JAX
package's Pallas kernels.

The same seeded numpy inputs go through the JAX ``window_mhsa_fused`` /
``mlp_block_fused`` / ``swin_block_fused`` (interpreted on the CPU, as
tests/test_ops_kernels.py runs them) and the port's plain versions, at the
JAX tests' shapes, with and without the shift mask, window 4 and 7. float32
on both sides, atol 2e-5 as the JAX kernel tests use: sums of at most 128
products in another order. The CUDA kernels are held against these plain
versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.models.swin import _shift_attn_mask
from computervision_codes_tpu.ops.mlp_block import (
    mlp_block_fused as jax_mlp_block,
)
from computervision_codes_tpu.ops.swin_block import (
    swin_block_fused as jax_swin_block,
)
from computervision_codes_tpu.ops.window_mhsa import (
    window_mhsa_fused as jax_window_mhsa,
)
from computervision_codes_tpu_torch.ops import mlp_block, swin_block
from computervision_codes_tpu_torch.ops import window_mhsa

ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _attn_arrays(rng, c, heads, n, scale=0.1):
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return [f(c) + 1, f(c), f(c, 3 * c), f(3 * c), f(c, c), f(c),
            f(heads, n, n)]


def _mlp_arrays(rng, c, s1=0.1, s2=0.1):
    f = lambda s, *shape: (rng.standard_normal(shape) * s).astype(np.float32)
    return [f(0.1, c) + 1, f(0.1, c), f(s1, c, 4 * c), f(0.01, 4 * c),
            f(s2, 4 * c, c), f(0.01, c)]


def _mask(hw, w, shift):
    return _shift_attn_mask(hw, hw, w, shift) if shift else None


def _jax(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b, hw, c, heads, w, shift", [
    (2, 16, 64, 2, 4, 0), (2, 16, 64, 2, 4, 2),   # test_ops_kernels.py:201
    (1, 14, 64, 2, 7, 0), (1, 14, 64, 2, 7, 3),   # window 7, :544
])
def test_window_mhsa_matches_jax(rng, b, hw, c, heads, w, shift):
    x = rng.standard_normal((b, hw, hw, c)).astype(np.float32)
    params = _attn_arrays(rng, c, heads, w * w)
    mask = _mask(hw, w, shift)
    want = jax_window_mhsa(*_jax([x, *params, mask]), window=w,
                           num_heads=heads)
    got = window_mhsa.window_mhsa_fused(*_torch([x, *params, mask]),
                                        window=w, num_heads=heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("block_tokens, hidden_chunk",
                         [(1024, 1024), (16, 32), (32, 64)])
def test_mlp_block_matches_jax(rng, block_tokens, hidden_chunk):
    """Single-chunk and hidden-chunked JAX configurations
    (test_ops_kernels.py:251); the port has one numerics for all."""
    x = rng.standard_normal((2, 32, 32)).astype(np.float32)
    params = _mlp_arrays(rng, 32, s1=0.2)
    want = jax_mlp_block(*_jax([x, *params]), block_tokens=block_tokens,
                         hidden_chunk=hidden_chunk)
    got = mlp_block.mlp_block_fused(*_torch([x, *params]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("shift, hidden_chunk",
                         [(0, 0), (2, 0), (0, 64), (2, 64)])
def test_swin_block_matches_jax(rng, shift, hidden_chunk):
    """test_ops_kernels.py:223: (2, 8, 8, 32), 4 heads (head_dim 8: the
    plain versions take any head_dim), window 4."""
    b, hw, c, heads, w = 2, 8, 32, 4, 4
    x = (rng.standard_normal((b, hw, hw, c)) * 0.1).astype(np.float32)
    attn = _attn_arrays(rng, c, heads, w * w)
    mlp = _mlp_arrays(rng, c)
    mask = _mask(hw, w, shift)
    want = jax_swin_block(*_jax([x, *attn, mask, *mlp]), window=w,
                          num_heads=heads, hidden_chunk=hidden_chunk)
    got = swin_block.swin_block_fused(*_torch([x, *attn, mask, *mlp]),
                                      window=w, num_heads=heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _cases(rng):
    """(fused, cuda wrapper, args, kwargs) of each kernel at a small size."""
    x = rng.standard_normal((1, 8, 8, 64)).astype(np.float32)
    attn = _torch([*_attn_arrays(rng, 64, 2, 16), _mask(8, 4, 2)])
    mlp = _torch(_mlp_arrays(rng, 64))
    xt = torch.from_numpy(x)
    kw = dict(window=4, num_heads=2)
    return [(window_mhsa.window_mhsa_fused, window_mhsa.window_mhsa_cuda,
             [xt, *attn], kw),
            (mlp_block.mlp_block_fused, mlp_block.mlp_block_cuda,
             [xt, *mlp], {}),
            (swin_block.swin_block_fused, swin_block.swin_block_cuda,
             [xt, *attn, *mlp], kw)]


@pytest.mark.parametrize("kernel", [0, 1, 2], ids=["K3", "K4", "K5"])
def test_dispatch_cpu_plain_meta_raises(rng, kernel):
    """A CPU tensor takes the plain version and launches nothing; the CUDA
    wrapper refuses CPU tensors; any other device raises."""
    fused, cuda, args, kw = _cases(rng)[kernel]
    before = cuda.launches
    out = fused(*args, **kw)
    assert cuda.launches == before
    assert out.shape == args[0].shape and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="needs CUDA"):
        cuda(*args, **kw)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        fused(*meta, **kw)


def test_plain_bf16_rounds_where_the_kernel_does(rng):
    """In bf16 the plain K3 equals its float32 computation rounded at the
    kernel's points: within a few bf16 ulps of the float32 result, and the
    mixed-dtype call (float32 LayerNorm parameters, bf16 x) is accepted."""
    x = rng.standard_normal((1, 8, 8, 64)).astype(np.float32)
    attn = _attn_arrays(rng, 64, 2, 16)
    f32 = window_mhsa.window_mhsa_reference(*_torch([x, *attn, None]),
                                            window=4, num_heads=2)
    tb = [torch.from_numpy(a) if i < 2 else torch.from_numpy(a).bfloat16()
          for i, a in enumerate(attn)]
    bf = window_mhsa.window_mhsa_reference(torch.from_numpy(x).bfloat16(),
                                           *tb, None, window=4, num_heads=2)
    assert bf.dtype == torch.bfloat16
    err = (bf.float() - f32).abs().max().item()
    assert err <= 8 * 2.0 ** -8 * f32.abs().max().item(), err
