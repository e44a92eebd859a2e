"""K8, the port's flash attention, against the JAX package's.

The plain versions (``flash_attention_reference_fwd`` and
``flash_attention_reference_bwd``) and the CPU paths of the entry points
(``flash_attention_pallas``, ``flash_attention``'s autograd) against the
interpreted TPU kernels, jitted: ``flash_attention_pallas``, ``_flash_fwd``
(output and row logsumexp) and ``jax.grad`` of ``flash_attention`` with
``sin`` of the output as the loss, as ``tests/test_ops_attention.py:55-71``
does. Shapes are the JAX tests' (1, 2, 300, 24) and (2, 1, 260, 16) (T not
a block multiple, D unaligned) and queries more than keys, (1, 2, 130, 24)
against (1, 2, 70, 24), at block sizes 128.

Bounds. float32: both compute in float32 in another order, atol 3e-5 (the
JAX tests' bound against their reference). bf16: both compute from the
same bf16 inputs in float32 and round once at the output; a value near a
rounding boundary can round to either neighbour, so one bf16 ulp of the
output's largest magnitude (2^-7 of max|want|) for the output, and for the
gradients, whose cotangent cos(out) is itself rounded in bf16 on each side,
two (2^-6 of max|want|); the lse is float32 on both sides from the same
inputs, atol 3e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.ops import attention as jax_attention
from computervision_codes_tpu_torch.ops import attention
from computervision_codes_tpu_torch.ops import (
    flash_attention,
    flash_attention_pallas,
)

SHAPES = {"T300_D24": ((1, 2, 300, 24), 300),
          "B2_T260_D16": ((2, 1, 260, 16), 260),
          "Tq130_Tk70": ((1, 2, 130, 24), 70)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BLOCK = 128
F32_ATOL, LSE_ATOL = 3e-5, 3e-5
BF16_OUT_REL, BF16_GRAD_REL = 2.0 ** -7, 2.0 ** -6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(shape, tk, dtype, seed=0):
    """q (B, H, Tq, D), k and v (B, H, Tk, D) from a numpy seed, as JAX and
    torch arrays of ``dtype`` holding the same values."""
    rng = np.random.default_rng(seed)
    b, h, tq, d = shape
    arrays = [rng.standard_normal((b, h, t, d)).astype(np.float32)
              for t in (tq, tk, tk)]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _assert_close(got, want, dtype, rel_bf16, what):
    got = got.float().detach().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = (F32_ATOL if dtype == "float32"
           else rel_bf16 * float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max_abs_err {err} > {tol}"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_lse_match_jax(shape, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(*SHAPES[shape], dtype)
    want = jax_attention.flash_attention_pallas(jq, jk, jv, block_q=BLOCK,
                                                block_k=BLOCK)
    want_fwd, res = jax.jit(jax_attention._flash_fwd, static_argnums=(3, 4))(
        jq, jk, jv, BLOCK, BLOCK)
    b, h, tq, _ = q.shape
    want_lse = np.asarray(res[4])[:, :tq].reshape(b, h, tq)

    out, lse = attention.flash_attention_reference_fwd(q, k, v)
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    _assert_close(out, want, dtype, BF16_OUT_REL, "reference_fwd out")
    _assert_close(out, want_fwd, dtype, BF16_OUT_REL, "against _flash_fwd")
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=LSE_ATOL)
    # the CPU entry points take the plain version
    torch.testing.assert_close(flash_attention_pallas(q, k, v), out,
                               rtol=0, atol=0)
    torch.testing.assert_close(flash_attention(q, k, v, 64, 64), out,
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_match_jax(shape, dtype):
    """``flash_attention``'s CPU autograd (``flash_attention_reference_bwd``)
    against ``jax.grad`` of the JAX op through its dQ and dK/dV kernels."""
    (jq, jk, jv), (q, k, v) = _inputs(*SHAPES[shape], dtype, seed=1)

    def loss(q, k, v):
        return jnp.sum(jnp.sin(jax_attention.flash_attention(
            q, k, v, BLOCK, BLOCK)))

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.sin(flash_attention(*leaves)).sum().backward()
    for name, leaf, w in zip("qkv", leaves, want):
        assert leaf.grad.dtype == q.dtype
        _assert_close(leaf.grad, w, dtype, BF16_GRAD_REL, f"d{name}")


def test_reference_bwd_is_the_gradient_of_attention():
    """The plain backward's formulas are the gradient of plain attention:
    autograd of ``attention_reference`` in float64 at a ragged Tq != Tk."""
    (_, _, _), (q, k, v) = _inputs((2, 3, 45, 20), 33, "float32", seed=2)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        q.shape).astype(np.float32))
    out, lse = attention.flash_attention_reference_fwd(q, k, v)
    got = attention.flash_attention_reference_bwd(q, k, v, out, lse, g)
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention.attention_reference(*leaves), leaves,
                               g.double())
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=F32_ATOL)


def test_dispatch_on_the_device():
    """A CPU tensor takes the plain version and launches nothing; the CUDA
    wrappers refuse CPU tensors; any other device raises."""
    (_, _, _), (q, k, v) = _inputs((1, 2, 9, 8), 9, "float32")
    wrappers = (attention.flash_attention_fwd_cuda,
                attention.flash_attention_dq_cuda,
                attention.flash_attention_dkv_cuda)
    before = [fn.launches for fn in wrappers]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*leaves).sum().backward()
    flash_attention_pallas(q, k, v)
    assert [fn.launches for fn in wrappers] == before
    with pytest.raises(ValueError, match="CUDA"):
        attention.flash_attention_fwd_cuda(q, k, v)
    lse = torch.zeros(q.shape[:3])
    for fn in wrappers[1:]:
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, v, q, lse, lse)
    meta = [t.to("meta") for t in (q, k, v)]
    for fn in (flash_attention, flash_attention_pallas):
        with pytest.raises(ValueError, match="CPU .* or CUDA"):
            fn(*meta)
    assert [fn.launches for fn in wrappers] == before
