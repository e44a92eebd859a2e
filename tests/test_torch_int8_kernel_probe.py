"""The port's P1 probe (``computervision_codes_tpu_torch/scripts/
int8_kernel_probe.py``) against the JAX probe's kernel bodies.

The JAX bodies (``_bf16_kernel``, ``_int8w_kernel``, ``_int8_kernel`` of
``scripts/int8_kernel_probe.py``) run through ``pl.pallas_call(...,
interpret=True)`` with the probe's BlockSpecs, at M = 64, K = 64, N = 48
and blk = 32: two row blocks, so that the per-block amax matters. Bounds:
the int8 output equals the plain version's bit for bit (exact int32 sums,
the same float32 operations in the same order); bf16 and int8w are within
one bf16 ulp of each element's magnitude (float32 sums in another order
can round the other way). The inputs are made from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from computervision_codes_tpu_torch.ops.mlp_block import Q8Weight
from computervision_codes_tpu_torch.scripts import int8_kernel_probe as probe
from scripts import int8_kernel_probe as jprobe

M, K, N, BLK = 64, 64, 48, 32


def _pallas(body, x, *weights, blk=BLK):
    """The JAX probe's pallas_call (its run(), :65-85), interpreted."""
    m, k = x.shape
    n = weights[0].shape[1]
    specs = [pl.BlockSpec((blk, k), lambda i: (i, 0),
                          memory_space=pltpu.VMEM),
             pl.BlockSpec((k, n), lambda i: (0, 0), memory_space=pltpu.VMEM),
             pl.BlockSpec((1, n), lambda i: (0, 0), memory_space=pltpu.VMEM)]
    out = pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((m, n), jnp.bfloat16),
        grid=(m // blk,), in_specs=specs[:1 + len(weights)],
        out_specs=pl.BlockSpec((blk, n), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        interpret=True)(x, *weights)
    return np.asarray(out.astype(jnp.float32))


def _inputs(seed, spread=False):
    """x (M, K) bf16 values; with ``spread`` the second row block is 1000x
    the first, so the two blocks' amax differ by that much. w's codes and
    scale as the JAX probe makes them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    if spread:
        x[BLK:] *= 1000.0
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    w = np.asarray(jnp.asarray(rng.standard_normal((K, N)), jnp.bfloat16)
                   .astype(jnp.float32))
    wq = np.clip(np.round(w * 16), -127, 127).astype(np.int8)
    s = np.full((1, N), 1 / 16.0, np.float32)
    return x, w, wq, s


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


def _within_one_ulp(got, want):
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()


@pytest.mark.parametrize("spread", [False, True])
def test_plain_versions_match_jax_bodies(spread):
    x, w, wq, s = _inputs(seed=3 + spread, spread=spread)
    xj = jnp.asarray(x, jnp.bfloat16)
    tx = _bf16(x)

    want = _pallas(jprobe._bf16_kernel, xj, jnp.asarray(w, jnp.bfloat16))
    got = probe.gemm_bf16_reference(tx, _bf16(w)).float().numpy()
    _within_one_ulp(got, want)

    want = _pallas(jprobe._int8w_kernel, xj, jnp.asarray(wq, jnp.bfloat16),
                   jnp.asarray(s))
    got = probe.gemm_int8w_reference(tx, torch.from_numpy(wq),
                                     torch.from_numpy(s)).float().numpy()
    _within_one_ulp(got, want)

    want = _pallas(jprobe._int8_kernel, xj, jnp.asarray(wq),
                   jnp.asarray(s))
    w8 = Q8Weight(torch.from_numpy(wq).t().contiguous(), torch.from_numpy(s))
    got = probe.gemm_int8_reference(tx, w8, BLK).float().numpy()
    np.testing.assert_array_equal(got, want)
    # the entry points take the plain versions on CPU tensors
    np.testing.assert_array_equal(probe.gemm_int8(tx, w8, BLK).float()
                                  .numpy(), want)
    if spread:  # one scale for the whole matrix is another function
        whole = probe.gemm_int8_reference(tx, w8, M).float().numpy()
        assert np.abs(whole[:BLK] - want[:BLK]).max() > 0


@pytest.mark.parametrize("seed", [11, 12])
def test_int8w_per_channel_scales_match_jax_body(seed):
    """int8w with a scale per output channel drawn from the seed (the
    probe's inputs use 1/16 everywhere, which cannot show a scale read from
    the wrong column): the plain version and the entry point on CPU tensors
    within one bf16 ulp of the JAX body, and a permuted scale is another
    function."""
    x, _, wq, _ = _inputs(seed=seed)
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.01, 1.0, (1, N)).astype(np.float32)
    want = _pallas(jprobe._int8w_kernel, jnp.asarray(x, jnp.bfloat16),
                   jnp.asarray(wq, jnp.bfloat16), jnp.asarray(s))
    tx, twq, ts = _bf16(x), torch.from_numpy(wq), torch.from_numpy(s)
    got = probe.gemm_int8w_reference(tx, twq, ts).float().numpy()
    _within_one_ulp(got, want)
    np.testing.assert_array_equal(
        probe.gemm_int8w(tx, twq, ts).float().numpy(), got)
    rolled = probe.gemm_int8w_reference(
        tx, twq, torch.from_numpy(np.roll(s, 1, axis=1))).float().numpy()
    assert np.abs(rolled - want).max() > 0.1 * np.abs(want).max()


def test_int8_block_must_divide_rows():
    x, _, wq, s = _inputs(seed=5)
    w8 = Q8Weight(torch.from_numpy(wq).t().contiguous(), torch.from_numpy(s))
    for blk in (24, 0, -32):
        with pytest.raises(ValueError, match="M % blk"):
            probe.gemm_int8(_bf16(x), w8, blk)
    with pytest.raises(ValueError, match="M % blk"):
        probe.gemm_int8_reference(_bf16(x), w8, 40)


def test_entry_points_refuse_other_devices():
    x = torch.zeros(M, K, dtype=torch.bfloat16, device="meta")
    w = torch.zeros(K, N, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        probe.gemm_bf16(x, w)
    with pytest.raises(ValueError, match="needs CUDA"):
        probe.gemm_bf16_cuda(_bf16(np.zeros((M, K), np.float32)),
                             _bf16(np.zeros((K, N), np.float32)))


def test_driver_rows_and_counters():
    """``run`` on the CPU: a row per variant with the driver's fields; the
    kernels' counters move only when a kernel launches, so on the CPU they
    stay where they were."""
    before = (probe.gemm_bf16_cuda.launches, probe.gemm_int8w_cuda.launches,
              probe.gemm_int8w_loop_cuda.launches,
              probe.gemm_int8_cuda.launches)
    rows = probe.run("tiny", M, K, N, BLK, device="cpu", iters=1,
                     plain_iters=1)
    assert [r["metric"] for r in rows] == ["tiny bf16", "tiny int8w",
                                           "tiny int8"]
    for r in rows:
        assert r["max_abs_err"] == 0.0  # the CPU runs the plain version
        assert r["ms"] > 0 and r["plain_ms"] > 0 and r["lib_ms"] > 0
        assert r["bound_by"] in ("bytes", "operations")
        assert r["bound_ms"] > 0
    assert (probe.gemm_bf16_cuda.launches, probe.gemm_int8w_cuda.launches,
            probe.gemm_int8w_loop_cuda.launches,
            probe.gemm_int8_cuda.launches) == before
    ops, nbytes, kind = probe.work(9216, 768, 3072, "bf16")
    assert kind == "bf16" and ops == 2 * 9216 * 768 * 3072
    assert probe.bound(ops, nbytes, kind)["bound_by"] == "operations"
