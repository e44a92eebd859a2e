"""The port's int8 primitives (ops/quant.py) against the JAX package's.

The quantizers and the int8 convolution must agree bit for bit: the codes,
the scales and the int32 sums. ``quantized_conv_bn`` is held to one
rounding of its output dtype: in float32 a relative 1e-6 (the epilogue
and the float conv may round or contract differently), in bf16 one ulp of
the output's largest magnitude. The CUDA kernel itself is checked bit for
bit against the plain version on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.ops import quant as jq
from computervision_codes_tpu_torch.ops import quant as pq

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (1, 1, 64, 32),
                                   (7, 7, 3, 64)])
def test_quantize_weight_bitwise(rng, shape):
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero channel takes the 1e-8 floor
    q, s = jq.quantize_weight(jnp.asarray(w))
    pq_, ps = pq.quantize_weight(torch.from_numpy(w))
    assert pq_.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq_.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activation_bitwise(rng, dtype):
    jdt, tdt = DTYPES[dtype]
    x = (rng.standard_normal((4, 5, 6, 7)) * 3).astype(np.float32)
    q, s = jq.quantize_activation(jnp.asarray(x, jdt))
    pq_, ps = pq.quantize_activation(torch.from_numpy(x).to(tdt))
    np.testing.assert_array_equal(pq_.numpy(), np.asarray(q))
    assert ps.dtype == torch.float32 and float(ps) == float(s)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["SAME", "VALID", ((1, 1), (1, 1)),
                                     ((0, 1), (2, 0))])
def test_conv_i8_exact(rng, padding, stride):
    """The counterpart of tests/test_quantized.py:51: equal int32 sums."""
    xq = rng.integers(-127, 128, (2, 9, 8, 4)).astype(np.int8)
    wq = rng.integers(-127, 128, (3, 3, 4, 6)).astype(np.int8)
    want = np.asarray(jq.conv_i8(jnp.asarray(xq), jnp.asarray(wq),
                                 stride=stride, padding=padding))
    got = pq.conv_i8(torch.from_numpy(xq),
                     torch.from_numpy(wq).permute(3, 0, 1, 2),  # OHWI
                     stride=stride, padding=padding)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _qw(rng, mode, k, cin, cout):
    """A JAX-form dict for ``mode`` and the port's dict of the same
    values (w_q in the kernel's layout)."""
    if mode == "float":
        w = (rng.standard_normal((k, k, cin, cout)) * 0.2).astype(np.float32)
        bias = (rng.standard_normal(cout) * 0.5).astype(np.float32)
        jd = {"w": w, "bias": bias}
        return jd, {"w": torch.from_numpy(w), "bias": torch.from_numpy(bias)}
    w_q, s_w = jq.quantize_weight(jnp.asarray(
        rng.standard_normal((k, k, cin, cout)).astype(np.float32)))
    mult = np.asarray(s_w) * rng.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.5).astype(np.float32)
    jd = {"w_q": np.asarray(w_q), "mult": mult, "bias": bias}
    td = {"w_q": torch.from_numpy(np.array(w_q)).permute(3, 0, 1, 2),
          "mult": torch.from_numpy(mult), "bias": torch.from_numpy(bias)}
    return jd, td


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k, stride", [(1, 1), (1, 2), (3, 1), (3, 2),
                                       (7, 2)])
@pytest.mark.parametrize("mode", ["float", "static", "dynamic", "record"])
def test_quantized_conv_bn_matches_jax(rng, mode, k, stride, dtype):
    jdt, tdt = DTYPES[dtype]
    cin = 3 if k == 7 else 8
    x = rng.standard_normal((2, 11, 10, cin)).astype(np.float32)
    jd, td = _qw(rng, mode, k, cin, 12)
    if mode == "static":  # below the absmax, so some codes clip
        s = np.float32(0.8 * np.abs(x).max() / 127.0)
        jd["act_scale"], td["act_scale"] = jnp.float32(s), torch.tensor(s)
    pad = ((k // 2, k // 2), (k // 2, k // 2))
    xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    for kw in ({"relu": False}, {"relu": True}, {"leaky_slope": 0.01}):
        jrec = [] if mode == "record" else None
        trec = [] if mode == "record" else None
        want = jq.quantized_conv_bn(
            xj, {k_: jnp.asarray(v) for k_, v in jd.items()}, stride=stride,
            padding=pad, dtype=jdt, record=jrec, **kw)
        got = pq.quantized_conv_bn(xt, td, stride=stride, padding=pad,
                                   dtype=tdt, record=trec, **kw)
        want = np.asarray(want, np.float32)
        assert got.dtype == tdt and tuple(got.shape) == want.shape
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=str(kw))
        else:
            ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
            assert np.abs(got - want).max() <= ulp, kw
        assert jrec == trec


def test_int8_wrapper_rejects_cpu_and_meta(rng):
    """No kernel wrapper of Q1 (the dispatch, the quantize pass, the wgmma
    kernel with either producer, the loop) runs the plain version in its
    place, and the dispatch raises on a device that is neither CPU nor
    CUDA."""
    _, td = _qw(rng, "dynamic", 3, 16, 12)
    x = torch.from_numpy(rng.standard_normal((1, 6, 6, 16)).astype(
        np.float32))
    s = pq.activation_scale(x)
    codes = pq.quantize_with_scale(x, s)
    w1 = td["w_q"][:, :1, :1].contiguous()
    calls = {
        "qconv_bn_cuda": lambda: pq.qconv_bn_cuda(
            x, s, td["w_q"], td["mult"], td["bias"], 1, "SAME"),
        "quantize_codes_cuda": lambda: pq.quantize_codes_cuda(x, s),
        "qconv_gemm_cuda": lambda: pq.qconv_gemm_cuda(
            codes, s, w1, td["mult"], td["bias"], 1, "VALID"),
        "qconv_conv_cuda": lambda: pq.qconv_conv_cuda(
            codes, s, td["w_q"], td["mult"], td["bias"], 1, "SAME"),
        "qconv_loop_cuda": lambda: pq.qconv_loop_cuda(
            x, s, td["w_q"], td["mult"], td["bias"], 1, "SAME")}
    for name, call in calls.items():
        with pytest.raises(ValueError, match=f"{name} needs CUDA tensors"):
            call()
    meta = {k: v.to("meta") for k, v in td.items()}
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        pq.quantized_conv_bn(x.to("meta"), {**meta, "act_scale":
                                            torch.tensor(0.1, device="meta")})
    before = {name: getattr(pq, name).launches for name in calls}
    pq.quantized_conv_bn(x, td)
    assert {name: getattr(pq, name).launches for name in calls} == before
