"""The port's fused stem (conv7x7/s2 + bias + ReLU + maxpool3x3/s2) against
the JAX package's.

Same inputs (numpy, seeded) through JAX's ``stem_pool_reference``, JAX's
Pallas kernel in interpret mode (as tests/test_ops_kernels.py runs it on
the CPU) and the port's plain version, at the shapes and tolerances of
that JAX test. The CUDA kernel itself is checked against the plain version
on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.ops.stem_pool import (
    stem_pool_fused as jax_fused,
    stem_pool_reference as jax_reference,
)
from computervision_codes_tpu_torch.ops import stem_pool as port

# float32: 147-term sums in another order (the JAX test's 2e-5); bf16: the
# JAX test's 0.05, and at most one bf16 ulp of the largest output, since
# both sides round the same float32 sums once
F32_ATOL = 2e-5
BF16_ATOL = 0.05


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(rng):
    w = (rng.standard_normal((7, 7, 3, 64)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(64) * 0.5).astype(np.float32)
    return w, bias


def _port(x, w, bias, dtype=torch.float32):
    return port.stem_pool_reference(torch.from_numpy(x).to(dtype),
                                    torch.from_numpy(w).to(dtype),
                                    torch.from_numpy(bias))


@pytest.mark.parametrize("h, wd, chunk", [(32, 56, 8), (32, 56, 3),
                                          (16, 16, 32), (24, 40, 2)])
def test_plain_matches_jax_reference_and_pallas(rng, h, wd, chunk):
    w, bias = _weights(rng)
    x = rng.standard_normal((2, h, wd, 3)).astype(np.float32)
    got = _port(x, w, bias).numpy()
    assert got.shape == (2, h // 4, wd // 4, 64)
    args = tuple(map(jnp.asarray, (x, w, bias)))
    np.testing.assert_allclose(got, np.asarray(jax_reference(*args)),
                               atol=F32_ATOL)
    np.testing.assert_allclose(got, np.asarray(jax_fused(*args, chunk=chunk)),
                               atol=F32_ATOL)


def test_plain_matches_jax_bf16(rng):
    w, bias = _weights(rng)
    x = rng.standard_normal((1, 32, 56, 3)).astype(np.float32)
    got = _port(x, w, bias, torch.bfloat16).float().numpy()
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(jax_reference(xb, wb, jnp.asarray(bias)), np.float32)
    pallas = np.asarray(jax_fused(xb, wb, jnp.asarray(bias), chunk=4),
                        np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    for ref in (want, pallas):
        err = np.abs(got - ref).max()
        assert err <= min(BF16_ATOL, ulp), (err, ulp)


@pytest.mark.parametrize("b", [9, 10, 11, 16, 22])
def test_plain_matches_jax_batch_sizes(rng, b):
    """The batch sizes that take the JAX kernel's split and pad branches;
    the port has no such branches and must give the same maps."""
    w, bias = _weights(rng)
    x = rng.standard_normal((b, 16, 16, 3)).astype(np.float32)
    got = _port(x, w, bias).numpy()
    args = tuple(map(jnp.asarray, (x, w, bias)))
    np.testing.assert_allclose(got, np.asarray(jax_fused(*args)),
                               atol=F32_ATOL)


def test_rejects_sizes_not_divisible_by_4(rng):
    w, bias = _weights(rng)
    x = torch.zeros(1, 30, 56, 3)
    for fn in (port.stem_pool_reference, port.stem_pool_fused):
        with pytest.raises(ValueError, match="divisible by 4"):
            fn(x, torch.from_numpy(w), torch.from_numpy(bias))
    with pytest.raises(ValueError):
        jax_fused(jnp.zeros((1, 30, 56, 3)), jnp.asarray(w),
                  jnp.asarray(bias))


def test_dispatch_cpu_plain_meta_raises(rng):
    """A CPU tensor takes the plain version and launches nothing; the CUDA
    wrapper never runs the plain version in its place; any other device
    raises."""
    w, bias = map(torch.from_numpy, _weights(rng))
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 3)).astype(
        np.float32))
    before = port.stem_pool_cuda.launches
    out = port.stem_pool_fused(x, w, bias)
    assert port.stem_pool_cuda.launches == before
    torch.testing.assert_close(out, port.stem_pool_reference(x, w, bias))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        port.stem_pool_cuda(x, w, bias)
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        port.stem_pool_fused(x.to("meta"), w.to("meta"), bias.to("meta"))
