"""The port's P2 probe (``computervision_codes_tpu_torch/scripts/
swin_pack_probe.py``) against the JAX probe's kernels.

The plain version of both formulations is the port's
``window_mhsa_reference(..., mask=None)``. It is held to the JAX
``mhsa_pack`` (g = 2 and 4) and ``mhsa_batched`` of
``scripts/swin_pack_probe.py``, jitted and interpreted on the CPU, at
b = 1, an 8 x 8 map, C = 128, 4 heads, window 4, in bf16, on inputs made
from a numpy seed. Bound: 2 bf16 ulps of the largest output magnitude.
Both sides round q, k, v, the softmax weights, the attention output and the
projection to bf16, but sum their float32 products in other orders (the
TPU kernel's packed block-diagonal tiles, ones-matmul denominators and
packed bias among them), so a rounding can go the other way once or twice
along the path. At seed 11 the plain version equals the three JAX kernels'
outputs and is within 0.0156 of the JAX reference (one ulp of an output
between 2 and 4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu_torch.ops.window_mhsa import (
    window_mhsa_reference)
from computervision_codes_tpu_torch.scripts import swin_pack_probe as probe
from scripts import swin_pack_probe as jprobe

B, HW, C, HEADS, W = 1, 8, 128, 4, 4
BF16_ULPS = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed):
    """x and the attention operands in the JAX probe's dtypes: LayerNorm
    vectors float32, the rest bf16 (as numpy float32 of bf16 values)."""
    rng = np.random.default_rng(seed)
    n = W * W

    def bf16(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

    x = bf16(rng.standard_normal((B, HW, HW, C)))
    gamma = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    beta = (0.01 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    wqkv = bf16(rng.standard_normal((C, 3 * C)) * C ** -0.5)
    bqkv = bf16(rng.standard_normal(3 * C) * 0.01)
    wproj = bf16(rng.standard_normal((C, C)) * C ** -0.5)
    bproj = bf16(rng.standard_normal(C) * 0.01)
    bias = bf16(rng.standard_normal((HEADS, n, n)) * 0.5)
    return x, (gamma, beta, wqkv, bqkv, wproj, bproj, bias)


def _jax(args):
    x, (gamma, beta, *rest) = args
    return [jnp.asarray(x, jnp.bfloat16), jnp.asarray(gamma),
            jnp.asarray(beta)] + [jnp.asarray(a, jnp.bfloat16) for a in rest]


def _torch(args):
    x, (gamma, beta, *rest) = args
    return ([torch.from_numpy(x.copy()).bfloat16(), torch.from_numpy(gamma),
             torch.from_numpy(beta)]
            + [torch.from_numpy(a.copy()).bfloat16() for a in rest])


def test_plain_version_matches_jax_pack_and_batched():
    args = _inputs(seed=11)
    kw = dict(window=W, num_heads=HEADS)
    got = window_mhsa_reference(*_torch(args), None, **kw).float().numpy()
    top = np.abs(got).max()
    bound = BF16_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)
    jargs = _jax(args)
    kernels = {f"pack{g}": jax.jit(lambda *a, g=g: jprobe.mhsa_pack(
        *a, group=g, **kw)) for g in (2, 4)}
    kernels["batched"] = jax.jit(lambda *a: jprobe.mhsa_batched(*a, **kw))
    for tag, fn in kernels.items():
        want = np.asarray(fn(*jargs).astype(jnp.float32))
        err = np.abs(got - want).max()
        assert err <= bound, (tag, err, bound)
    # the entry points take the plain version on CPU tensors
    targs = _torch(args)
    for fn in (lambda: probe.mhsa_pack(*targs, group=2, **kw),
               lambda: probe.mhsa_batched(*targs, **kw)):
        np.testing.assert_array_equal(fn().float().numpy(), got)


def test_group_must_divide_heads():
    targs = _torch(_inputs(seed=1))
    for group in (3, 0, 8):
        with pytest.raises(ValueError, match="divide num_heads"):
            probe.mhsa_pack(*targs, window=W, num_heads=HEADS, group=group)


def test_stage_inputs_and_work():
    """``stage_inputs`` draws the relative-position table with the std it
    is given (the probe's 0.02 by default) and gathers it into a
    (heads, N, N) bias; ``work`` counts the JAX probe's stage operations."""
    _, args = probe.stage_inputs(2, 8, 128, 4, 4, "cpu", seed=3)
    bias = args[-1]
    assert bias.shape == (4, 16, 16) and bias.dtype == torch.bfloat16
    _, wide = probe.stage_inputs(2, 8, 128, 4, 4, "cpu", seed=3,
                                 table_std=0.5)
    ratio = wide[-1].float().std() / bias.float().std()
    assert abs(ratio.item() - 25.0) < 0.5  # the same draw, scaled
    for stage, gflop in zip(probe.STAGES, (59.8, 47.6)):
        _, b, hw, c, heads, _ = stage
        ops, _ = probe.work(b, hw, c, heads, probe.WINDOW)
        assert round(ops / 1e9, 1) == gflop


def test_driver_rows_and_counters():
    """``run_stage`` at the tiny stage on the CPU: the loop (K3), each
    pack<g> and batched, with the driver's fields; no kernel launches, so
    the counters stay where they were."""
    before = (probe.mhsa_pack_cuda.launches, probe.mhsa_batched_cuda.launches)
    name, b, hw, c, heads, groups = probe.TINY_STAGES[0]
    rows = probe.run_stage(name, b, hw, c, heads, groups, probe.TINY_WINDOW,
                           device="cpu", iters=1, plain_iters=1)
    assert [r["metric"].rsplit(" ", 1)[1] for r in rows] == [
        "loop", "pack1", "pack2", "pack4", "batched"]
    for r in rows:
        assert r["max_abs_err"] == 0.0  # the CPU runs the plain version
        assert r["ms"] > 0 and r["plain_ms"] > 0 and r["bound_ms"] > 0
    assert rows[-1]["blocks"] == b * (hw // probe.TINY_WINDOW) ** 2
    assert (probe.mhsa_pack_cuda.launches,
            probe.mhsa_batched_cuda.launches) == before
    assert all("staged_heads" not in r for r in rows)  # the card's choice
