"""The port's dilated residual layer against the JAX package's.

Same inputs (numpy, seeded) through JAX's reference, JAX's Pallas kernel in
interpret mode (as tests/test_ops_kernels.py runs it on the CPU) and the
port's plain version, in float32. The CUDA kernel itself is checked against
the plain version on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.ops.dilated_conv import (
    dilated_residual_fused as jax_fused,
    dilated_residual_pallas as jax_pallas,
    dilated_residual_reference as jax_reference,
)
from computervision_codes_tpu_torch.ops import dilated_conv as port

# float32 on both sides; the sums of 3 x C = 48 products differ only in
# order, so 1e-5 absolute covers rounding at these O(1) magnitudes
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _layer(rng, b=2, t=70, c=16):
    return (rng.standard_normal((b, t, c)).astype(np.float32),
            (rng.standard_normal((3, c, c)) * 0.1).astype(np.float32),
            (rng.standard_normal(c) * 0.1).astype(np.float32),
            (rng.standard_normal((c, c)) * 0.1).astype(np.float32),
            (rng.standard_normal(c) * 0.1).astype(np.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [20, 70])
@pytest.mark.parametrize("dilation", [1, 4, 16, 32])
def test_plain_matches_jax_reference_and_pallas(rng, dilation, t, causal):
    """Covers d >= T (d=32 at T=20; causal taps reach 2d back) and a T that
    is not a multiple of the Pallas block."""
    arrays = _layer(rng, t=t)
    got = port.dilated_residual_reference(
        *map(torch.from_numpy, arrays), dilation, causal).numpy()
    want = np.asarray(jax_reference(*map(jnp.asarray, arrays), dilation,
                                    causal=causal))
    np.testing.assert_allclose(got, want, atol=ATOL)
    pallas = np.asarray(jax_pallas(*map(jnp.asarray, arrays), dilation,
                                   block_t=32, causal=causal))
    np.testing.assert_allclose(got, pallas, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_fused_grad_matches_jax(rng, causal):
    """Gradients of the port's autograd.Function against jax.grad of the
    JAX custom_vjp, for every input."""
    arrays = _layer(rng, b=1, t=20, c=8)
    d = 2

    def jloss(*a):
        return jnp.sum(jax_fused(*a, d, causal) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays))
    tensors = [torch.from_numpy(a).requires_grad_() for a in arrays]
    loss = (port.dilated_residual_fused(*tensors, d, causal) ** 2).sum()
    got = torch.autograd.grad(loss, tensors)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_dispatch_cpu_plain_meta_raises(rng):
    """A CPU tensor takes the plain version and launches nothing; a tensor
    on any device other than CPU or CUDA raises."""
    arrays = [torch.from_numpy(a) for a in _layer(rng, t=20)]
    before = port.dilated_residual_cuda.launches
    out = port.dilated_residual_fused(*arrays, 4, False)
    assert port.dilated_residual_cuda.launches == before
    torch.testing.assert_close(
        out, port.dilated_residual_reference(*arrays, 4, False))
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        port.dilated_residual_fused(*(a.to("meta") for a in arrays), 4, False)


def test_cuda_wrapper_rejects_cpu_tensors(rng):
    """The kernel wrapper never runs the plain version in its place."""
    arrays = [torch.from_numpy(a) for a in _layer(rng, t=20)]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        port.dilated_residual_cuda(*arrays, 4)
