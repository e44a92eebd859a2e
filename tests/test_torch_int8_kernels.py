"""The int8 branches of the port's Swin kernels K3, K4 and K5 (plain
versions) against the JAX package's Pallas kernels with ``quant=True``.

The same seeded numpy inputs go through the JAX ``window_mhsa_fused`` /
``mlp_block_fused`` / ``swin_block_fused`` (interpreted on the CPU, as
tests/test_ops_kernels.py runs them) and the port's plain versions, with
the port's weights made by ``q8_weight``. Bounds:

* ``q8_weight`` codes and scales, and ``q8_dot`` outputs, are equal bit for
  bit (the same quantizer on the same float32 values, exact int sums);
* the kernels: float32 on both sides, atol 1e-4, the JAX emulation test's
  bound (tests/test_ops_kernels.py:313), at the JAX tests' shapes and
  scales. LayerNorm sums taken in another order can move an activation
  across an int8 rounding boundary, which this bound would not absorb; at
  these inputs no code differs (chip_smoke.py measures the share of such
  outputs at the stage shapes on the card);
* the merged block's bf16 float path: bit for bit against the JAX kernel,
  at the JAX tests' input scale (x 0.1).

The CUDA kernels are held against these plain versions on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.models.swin import _shift_attn_mask
from computervision_codes_tpu.ops import mlp_block as jax_mlp
from computervision_codes_tpu.ops.swin_block import (
    swin_block_fused as jax_swin_block,
)
from computervision_codes_tpu.ops.window_mhsa import (
    window_mhsa_fused as jax_window_mhsa,
)
from computervision_codes_tpu_torch.ops import mlp_block, swin_block
from computervision_codes_tpu_torch.ops import window_mhsa
from computervision_codes_tpu_torch.ops.mlp_block import q8_weight

ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f(rng, scale, *shape):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _attn(rng, c, heads, n):
    f = lambda *s: _f(rng, 0.1, *s)
    return [f(c) + 1, f(c), f(c, 3 * c), f(3 * c), f(c, c), f(c),
            f(heads, n, n)]


def _mlp(rng, c, s1=0.1, s2=0.1):
    return [_f(rng, 0.1, c) + 1, _f(rng, 0.1, c), _f(rng, s1, c, 4 * c),
            _f(rng, 0.01, 4 * c), _f(rng, s2, 4 * c, c), _f(rng, 0.01, c)]


def _jax(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _torch(arrays, q8_at=()):
    """Tensors, with the weights at ``q8_at`` made ``Q8Weight``s."""
    out = [None if a is None else torch.from_numpy(a) for a in arrays]
    for i in q8_at:
        out[i] = q8_weight(out[i])
    return out


def _mask(hw, w, shift):
    return _shift_attn_mask(hw, hw, w, shift) if shift else None


@pytest.mark.parametrize("shape, scale", [((64, 256), 0.1), ((96, 32), 3.0),
                                          ((768, 64), 0.02)])
def test_q8_weight_and_q8_dot_equal_jax(rng, shape, scale):
    w = _f(rng, scale, *shape)
    w[:, 0] = 0.0  # an all-zero channel takes the 1e-8 scale floor
    jq, js = jax_mlp.q8_weight(jnp.asarray(w))
    q = q8_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(q.codes.t().numpy(), np.asarray(jq))
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(js))
    assert q.codes.dtype == torch.int8 and q.scale.shape == (1, shape[1])
    # bf16-cast weights, as the Swin modules pass them to the kernels
    wb = torch.from_numpy(w).bfloat16()
    jq, js = jax_mlp.q8_weight(jnp.asarray(w, jnp.bfloat16))
    np.testing.assert_array_equal(q8_weight(wb).codes.t().numpy(),
                                  np.asarray(jq))
    x = _f(rng, 1.0, 50, shape[0])
    want = jax_mlp.q8_dot(jnp.asarray(x), *jax_mlp.q8_weight(jnp.asarray(w)))
    np.testing.assert_array_equal(
        mlp_block.q8_dot(torch.from_numpy(x), q).numpy(), np.asarray(want))


def test_gelu_as_matches_jax(rng):
    x = _f(rng, 3.0, 4096)
    x[:3] = [0.0, -0.0, 12.0]
    np.testing.assert_allclose(
        mlp_block.gelu_as(torch.from_numpy(x)).numpy(),
        np.asarray(jax_mlp._gelu_exact(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("t, blk", [(2 * 64, 128), (32, 16), (64, 16)],
                         ids=["one-block", "two-blocks", "four-blocks"])
def test_mlp_block_q8_matches_jax(rng, t, blk):
    """One token block (the module's call: blocks of up to 512 tokens), and
    several with distinct scales (x's second half scaled by 10, the pattern
    of test_ops_kernels.py:439; JAX ``block_tokens=16``, the port's
    per-block plain version at 16)."""
    c = 32
    x = _f(rng, 1.0, t, c)
    x[t // 2:] *= 10.0
    params = _mlp(rng, c, s1=0.2)
    args = _torch([x, *params], q8_at=(3, 5))
    if blk == t:
        want = jax_mlp.mlp_block_fused(*_jax([x, *params]), quant=True)
        got = mlp_block.mlp_block_fused(*args, quant=True)
        assert mlp_block.token_block(t) == t
    else:
        want = jax_mlp.mlp_block_fused(*_jax([x, *params]), quant=True,
                                       block_tokens=blk, hidden_chunk=4 * c)
        got = mlp_block.mlp_q8_reference(*args, blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    amax = mlp_block.block_absmax(args[0].reshape(-1, blk, c)).flatten()
    assert len(amax) == t // blk
    if len(amax) > 1:
        assert amax.max() > 5 * amax.min()  # the scales differ per block


@pytest.mark.parametrize("b, hw, c, heads, w, shift", [
    (2, 8, 32, 4, 4, 0), (2, 8, 32, 4, 4, 2),      # test_ops_kernels.py:331
    (1, 14, 64, 2, 7, 0), (1, 14, 64, 2, 7, 3),    # window 7: padded queries
])
def test_window_mhsa_q8_matches_jax(rng, b, hw, c, heads, w, shift):
    x = _f(rng, 0.1, b, hw, hw, c)
    params = _attn(rng, c, heads, w * w)
    mask = _mask(hw, w, shift)
    want = jax_window_mhsa(*_jax([x, *params, mask]), window=w,
                           num_heads=heads, quant=True)
    args = _torch([x, *params, mask], q8_at=(3, 5))
    got = window_mhsa.window_mhsa_fused(*args, window=w, num_heads=heads,
                                        quant=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_window7_padded_queries_set_the_proj_scale(rng, monkeypatch):
    """At window 7 the JAX kernel's padded queries (uniform attention over
    the 49 keys: each head's mean of v) enter the proj scale. Here every
    real query attends to key 0 alone (rel-pos bias +30), whose v is 0.05
    in every channel (a constant token, LN beta 0, v = LN(x) + 0.05), while
    the mean of v is larger: the padded row sets the scale. Without it the
    port's result moves away from the JAX kernel's."""
    b, hw, c, heads, w = 1, 14, 64, 2, 7
    n = w * w
    x = _f(rng, 1.0, b, hw, hw, c)
    x[:, ::w, ::w, :] = 0.5  # key 0 of every window
    params = _attn(rng, c, heads, n)
    params[1][:] = 0.0  # LN beta
    params[2][:, 2 * c:] = np.eye(c, dtype=np.float32)  # v = LN(x) + bv
    params[3][2 * c:] = 0.05
    params[6][:] = 0.0
    params[6][:, :, 0] = 30.0  # real queries attend to key 0
    want = jax_window_mhsa(*_jax([x, *params, None]), window=w,
                           num_heads=heads, quant=True)
    args = _torch([x, *params, None], q8_at=(3, 5))

    def run():
        return window_mhsa.window_mhsa_fused(*args, window=w,
                                            num_heads=heads,
                                            quant=True).numpy()

    np.testing.assert_allclose(run(), np.asarray(want), atol=ATOL)
    monkeypatch.setattr(window_mhsa, "padded_query_absmax",
                        lambda qkv, *_: torch.zeros(qkv.shape[:2] + (1, 1)))
    assert np.abs(run() - np.asarray(want)).max() > 10 * ATOL


@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block_q8_matches_jax(rng, shift):
    """test_ops_kernels.py:388's shapes: (2, 8, 8, 32), 4 heads, window
    4; LN rounded before quantizing and per-strip MLP scales."""
    b, hw, c, heads, w = 2, 8, 32, 4, 4
    x = _f(rng, 0.1, b, hw, hw, c)
    attn, mlp = _attn(rng, c, heads, w * w), _mlp(rng, c)
    mask = _mask(hw, w, shift)
    want = jax_swin_block(*_jax([x, *attn, mask, *mlp]), window=w,
                          num_heads=heads, quant=True)
    got = swin_block.swin_block_fused(
        *_torch([x, *attn, mask, *mlp], q8_at=(3, 5, 11, 13)), window=w,
        num_heads=heads, quant=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block_bf16_float_path_equals_jax(rng, shift):
    """The merged block's float path in bf16, bit for bit against the JAX
    kernel at one hidden chunk: ``y + bf16(o + b2)``, rounded twice. The
    attention half adds zero here (zero proj weight and bias), so y = x on
    both sides and the test reads the MLP half: the attention halves may
    differ by an ulp in a few elements, since the JAX kernel subtracts one
    softmax max per group of heads. K4's one rounding of the float32 sum
    differs from the JAX block in many elements."""
    b, hw, c, heads, w = 2, 8, 32, 4, 4
    x = _f(rng, 0.1, b, hw, hw, c)
    attn, mlp = _attn(rng, c, heads, w * w), _mlp(rng, c)
    attn[4][:] = 0.0
    attn[5][:] = 0.0
    mask = _mask(hw, w, shift)
    arrays = [x, *attn, mask, *mlp]
    f32 = {1, 2, 9, 10}  # LayerNorm parameters stay float32
    want = jax_swin_block(
        *[None if a is None else jnp.asarray(
            a, jnp.float32 if i in f32 else jnp.bfloat16)
          for i, a in enumerate(arrays)], window=w, num_heads=heads)
    want = np.asarray(want.astype(jnp.float32))
    tb = [None if a is None else (torch.from_numpy(a) if i in f32 else
                                  torch.from_numpy(a).bfloat16())
          for i, a in enumerate(arrays)]
    got = swin_block.swin_block_fused(*tb, window=w, num_heads=heads)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    once = mlp_block.mlp_block_reference(tb[0], *tb[9:])  # K4's rounding
    assert (once.float().numpy() != want).mean() > 0.05


def _cases(rng):
    """(fused, CUDA wrapper, args, kwargs) of each int8 branch."""
    x = _f(rng, 1.0, 1, 8, 8, 64)
    attn = _torch([*_attn(rng, 64, 2, 16), _mask(8, 4, 2)], q8_at=(2, 4))
    mlp = _torch(_mlp(rng, 64), q8_at=(2, 4))
    xt = torch.from_numpy(x)
    kw = dict(window=4, num_heads=2, quant=True)
    return [(window_mhsa.window_mhsa_fused, window_mhsa.window_mhsa_q8_cuda,
             [xt, *attn], kw),
            (mlp_block.mlp_block_fused, mlp_block.mlp_block_q8_cuda,
             [xt, *mlp], {"quant": True}),
            (swin_block.swin_block_fused, swin_block.swin_block_q8_cuda,
             [xt, *attn, *mlp], kw)]


@pytest.mark.parametrize("kernel", [0, 1, 2], ids=["K3", "K4", "K5"])
def test_q8_dispatch_cpu_plain_meta_raises(rng, kernel):
    """A CPU tensor takes the int8 plain version and launches nothing; the
    CUDA wrapper refuses CPU tensors; any other device raises; the int8
    branch refuses float weights."""
    fused, cuda, args, kw = _cases(rng)[kernel]
    before = cuda.launches
    out = fused(*args, **kw)
    assert cuda.launches == before
    assert out.shape == args[0].shape and torch.isfinite(out).all()
    ckw = {k: v for k, v in kw.items() if k != "quant"}
    with pytest.raises(ValueError, match="needs CUDA"):
        cuda(*args, **ckw)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        fused(*meta, **kw)
    with pytest.raises(TypeError, match="Q8Weight"):
        mlp_block.check_q8("k", args[0], {"w": (torch.zeros(64, 64),
                                                (64, 64))})
