"""The port's window attention (K10) against the JAX package's.

The plain version is held to the JAX ``window_attention_reference`` and to
the TPU kernels run interpreted off the TPU: ``window_attention_pallas``
and ``window_attention_pallas_multi`` at ``block_windows`` 1 and 8, with
no mask and with masks of nW in {1, 2, 4, 8, 16} windows (window w takes
mask[w mod nW]). float32: within 1e-5 of the largest magnitude (the TPU
kernel scales q and sums in another order). bf16: against the JAX
reference, which runs the same ops in the same dtype, within 2 bf16 ulps
of the largest magnitude (products summed in another order). The
``autograd.Function``'s gradient (the plain version's backward, as JAX's
``custom_vjp``) is held to ``jax.grad`` of ``window_attention_fused`` at
1e-5 of each gradient's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.ops import window_attention as jwa
from computervision_codes_tpu_torch.ops import window_attention as wa
from computervision_codes_tpu_torch.ops.attention import vector_bytes

F32_REL, BF16_ULPS = 1e-5, 2
BW, HEADS, N, D = 16, 2, 16, 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(nw, seed, masked=True):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((BW, HEADS, N, D)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((HEADS, N, N)).astype(np.float32)
    mask = (np.where(rng.random((nw, N, N)) < 0.3, -100.0, 0.0).astype(
        np.float32) if masked else None)
    return q, k, v, bias, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F32_REL * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("nw,masked", [(1, False), (1, True), (2, True),
                                       (4, True), (8, True), (16, True)])
def test_plain_matches_jax_reference_and_kernels(nw, masked):
    q, k, v, bias, mask = _inputs(nw, seed=nw, masked=masked)
    got = wa.window_attention_reference(*map(_t, (q, k, v, bias, mask)),
                                        nw=nw).numpy()
    _close(got, np.asarray(jwa.window_attention_reference(
        q, k, v, bias, mask, nw=nw)), "reference")
    _close(got, np.asarray(jwa.window_attention_pallas(
        q, k, v, bias, mask, nw=nw)), "pallas")
    for g in (1, 8):
        _close(got, np.asarray(jwa.window_attention_pallas_multi(
            q, k, v, bias, mask, nw=nw, block_windows=g)), f"multi {g}")
    # the fused op runs the plain version on CPU tensors
    fused = wa.window_attention_fused(*map(_t, (q, k, v, bias, mask)),
                                      nw=nw).numpy()
    np.testing.assert_array_equal(fused, got)


def test_plain_bf16_matches_jax_reference():
    q, k, v, bias, mask = _inputs(4, seed=7)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, bias)]
    want = np.asarray(jwa.window_attention_reference(*jb, mask, nw=4),
                      np.float32)
    tb = [torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
          for a in jb]
    got = wa.window_attention_reference(*tb, torch.from_numpy(mask), nw=4)
    assert got.dtype == torch.bfloat16
    top = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.abs(got.float().numpy() - want).max() <= BF16_ULPS * ulp


def test_gradient_matches_jax():
    q, k, v, bias, mask = _inputs(4, seed=11)
    g = np.random.default_rng(12).standard_normal(q.shape).astype(np.float32)

    def loss(q, k, v, bias):
        out = jwa.window_attention_fused(q, k, v, bias, mask, 4, 8)
        return jnp.sum(out * g)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(q, k, v, bias)
    inputs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    out = wa.window_attention_fused(*inputs, torch.from_numpy(mask), 4, 8)
    (out * torch.from_numpy(g)).sum().backward()
    for name, t, w in zip("q k v bias".split(), inputs, want):
        _close(t.grad.numpy(), np.asarray(w), name)


def test_kernel_entry_points_refuse_cpu_tensors():
    q, k, v, bias, mask = map(_t, _inputs(4, seed=0))
    for fn in (wa.window_attention_cuda, wa.window_attention_pallas,
               wa.window_attention_pallas_multi):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, v, bias, mask, 4)
    m = q.to("meta")
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        wa.window_attention_fused(m, m, m, bias.to("meta"), None)


def test_swin_qkv_views_load_whole_rows():
    """Swin's WindowAttention cuts q, k, v as views of one qkv tensor
    (bw, N, 3, H, 32); the kernel reads them through their strides in
    16-byte loads, with no copy."""
    bw, n, h = 8, 144, 6
    qkv = torch.zeros(bw, n, 3, h, D, dtype=torch.bfloat16).permute(
        2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    assert all(t.stride(-1) == 1 for t in (q, k, v))
    assert vector_bytes((q, k, v), 2) == 16
