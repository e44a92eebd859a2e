"""Q1's two plain versions and its path selection (ops/quant.py).

On the card Q1 runs either a quantize pass and then the wgmma int8 GEMM
over the codes, or the older loop that quantizes on load. Their plain
versions must compose to the one the CPU runs: ``qconv_codes_reference``
of ``quantize_with_scale``'s codes equals ``qconv_bn_reference`` and the
JAX package's ``quantized_conv_bn`` bit for bit. ``qconv_path`` picks the
path from the shapes alone: every main-path shape (ResNet18's 19
convolutions at 256x448, the int8 teacher's Dense layers) takes the wgmma
path, and Cin % 16 != 0 takes the loop. The dispatch is driven here with
the C entry points replaced by recorders, so it is seen to launch the
right kernels with the right geometry and never to run a plain version.
The kernels themselves are held to the plain versions on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.ops import quant as jq
from computervision_codes_tpu_torch.ops import quant as pq

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ACTS = ({"relu": False}, {"relu": True}, {"leaky_slope": 0.01})


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def resnet18_convs(h: int, w: int) -> list:
    """(Cin, Cout, k, stride, pad, H, W) of ResNet18's int8 convolutions on
    h x w frames (after the stem and pool: h / 4 x w / 4)."""
    out, cin, h, w = [], 64, h // 4, w // 4
    for cout, first_stride in ((64, 1), (128, 2), (256, 2), (512, 2)):
        for block in range(2):
            s = first_stride if block == 0 else 1
            ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
            out.append((cin, cout, 3, s, 1, h, w))
            out.append((cout, cout, 3, 1, 1, ho, wo))
            if s != 1 or cin != cout:
                out.append((cin, cout, 1, s, 0, h, w))
            h, w, cin = ho, wo, cout
    return out


RESNET18_CONVS = resnet18_convs(256, 448)
# the int8 teacher's Dense layers at batch 16: (M, K, N)
Q1_DENSE = [(16 * 144, 1536, 4608), (16 * 48 * 48, 768, 384),
            (16 * 144, 3072, 1536), (16 * 144, 1536, 8192),
            (16 * 144, 8192, 1536), (16 * 6, 1536, 1536)]


def _weights(rng, k, cin, cout):
    """JAX-form HWIO codes and the port's (Cout, kh, kw, Cin) copy, with a
    per-channel mult (weight scale x BN) and bias."""
    w_q, s_w = jq.quantize_weight(jnp.asarray(
        rng.standard_normal((k, k, cin, cout)).astype(np.float32)))
    mult = np.asarray(s_w) * rng.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.5).astype(np.float32)
    return (np.asarray(w_q), mult, bias,
            torch.from_numpy(np.array(w_q)).permute(3, 0, 1, 2).contiguous())


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k, stride", [(1, 1), (1, 2), (3, 1), (3, 2),
                                       (7, 2)])
@pytest.mark.parametrize("mode", ["static", "dynamic", "record"])
def test_codes_reference_composes(rng, mode, k, stride, in_dtype,
                                  out_dtype):
    """quantize_with_scale, then qconv_codes_reference, equals
    qconv_bn_reference and the JAX quantized_conv_bn bit for bit."""
    (jin, tin), (jout, tout) = DTYPES[in_dtype], DTYPES[out_dtype]
    cin, cout = 16, 24
    x = (rng.standard_normal((2, 11, 10, cin)) * 2).astype(np.float32)
    w_hwio, mult, bias, w_q = _weights(rng, k, cin, cout)
    xj, xt = jnp.asarray(x, jin), torch.from_numpy(x).to(tin)
    jd = {"w_q": jnp.asarray(w_hwio), "mult": jnp.asarray(mult),
          "bias": jnp.asarray(bias)}
    if mode == "static":  # below the absmax, so some codes clip
        s = np.float32(0.8 * np.abs(x).max() / 127.0)
        jd["act_scale"] = jnp.float32(s)
        s_act = torch.tensor(s)
    else:
        s_act = pq.activation_scale(xt)
    pad = ((k // 2, k // 2), (k // 2, k // 2))
    tm, tb = torch.from_numpy(mult), torch.from_numpy(bias)
    codes = pq.quantize_with_scale(xt, s_act)
    for act in ACTS:
        record = [] if mode == "record" else None
        want = np.asarray(jq.quantized_conv_bn(
            xj, jd, stride=stride, padding=pad, dtype=jout, record=record,
            **act), np.float32)
        if record is not None:
            assert record == [float(s_act)]
        got = pq.qconv_codes_reference(codes, s_act, w_q, tm, tb, stride,
                                       pad, dtype=tout, **act)
        composed = pq.qconv_bn_reference(xt, s_act, w_q, tm, tb, stride,
                                         pad, dtype=tout, **act)
        assert got.dtype == tout and tuple(got.shape) == want.shape
        assert torch.equal(got, composed), act
        np.testing.assert_array_equal(got.float().numpy(), want,
                                      err_msg=str(act))


@pytest.mark.parametrize("case", RESNET18_CONVS,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}x{c[2]}s{c[3]}-{c[5]}x"
                              f"{c[6]}" for c in RESNET18_CONVS])
def test_resnet18_convs_take_the_wgmma_conv_path(case):
    cin, cout, k, s, p, h, w = case
    pads = pq.conv_padding(((p, p), (p, p)), k, k, s, h, w)
    assert pq.qconv_path(cin, k, k, s, pads) == "conv"


@pytest.mark.parametrize("m, k, n", Q1_DENSE)
def test_dense_shapes_take_the_wgmma_gemm_path(m, k, n):
    """Int8Dense calls Q1 as a 1x1 VALID convolution over (M, 1, 1, K)."""
    pads = pq.conv_padding("VALID", 1, 1, 1, 1, 1)
    assert pq.qconv_path(k, 1, 1, 1, pads) == "gemm"


@pytest.mark.parametrize("cin, k, stride, pad", [
    (3, 7, 2, 3),    # the stem with float_stem=False
    (24, 3, 2, 1),   # an odd channel count
    (8, 1, 1, 0),    # a 1x1 that is no wgmma GEMM either
    (40, 3, 1, 1)])
def test_ragged_channels_take_the_loop(cin, k, stride, pad):
    pads = ((pad, pad), (pad, pad))
    assert pq.qconv_path(cin, k, k, stride, pads) == "loop"


def test_padded_or_strided_1x1_is_no_gemm():
    assert pq.qconv_path(64, 1, 1, 2, ((0, 0), (0, 0))) == "conv"
    assert pq.qconv_path(64, 1, 1, 1, ((0, 0), (0, 1))) == "conv"


class _Recorder:
    """Stands in for the C entry points: records each call's arguments and
    returns 0 (success)."""

    def __init__(self):
        self.calls = []

    def entry(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def recorded(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(pq, "_launch_fns", lambda: {
        name: rec.entry(name) for name in ("quantize", "wgmma", "loop")})
    # CPU tensors stand in for CUDA ones: the device check passes, the
    # launch goes to the recorder with stream 0
    monkeypatch.setattr(pq, "_on_card", lambda x, what: None)
    monkeypatch.setattr(pq, "_run", lambda fn, device, *args: fn(*args, 0))

    def no_plain(*args, **kwargs):
        raise AssertionError("a plain version ran in a kernel's place")
    for name in ("qconv_bn_reference", "qconv_codes_reference", "conv_i8",
                 "quantize_with_scale"):
        monkeypatch.setattr(pq, name, no_plain)
    for fn in (pq.quantize_codes_cuda, pq.qconv_gemm_cuda,
               pq.qconv_conv_cuda, pq.qconv_loop_cuda, pq.qconv_bn_cuda):
        monkeypatch.setattr(fn, "launches", 0)
    return rec


@pytest.mark.parametrize("cin, cout, k, stride, pad, h, w, dtype, path", [
    (64, 64, 3, 1, 1, 16, 28, torch.bfloat16, "conv"),
    (64, 128, 1, 2, 0, 16, 28, torch.float32, "conv"),
    (1536, 384, 1, 1, 0, 1, 1, torch.bfloat16, "gemm"),
    (3, 64, 7, 2, 3, 17, 29, torch.bfloat16, "loop"),
    (24, 40, 3, 2, 1, 9, 11, torch.float32, "loop")])
def test_dispatch_launches_the_selected_kernels(recorded, rng, cin, cout, k,
                                                stride, pad, h, w, dtype,
                                                path):
    """qconv_bn_cuda launches the quantize pass and the wgmma kernel with
    the selected producer, or the loop, with the convolution's geometry,
    and counts each launch on its own wrapper."""
    n = 96 if path == "gemm" else 2
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin)).astype(
        np.float32)).to(dtype)
    w_q = torch.zeros(cout, k, k, cin, dtype=torch.int8)
    mult, bias = torch.ones(cout), torch.zeros(cout)
    pads = ((pad, pad), (pad, pad))
    y = pq.qconv_bn_cuda(x, torch.tensor(0.1), w_q, mult, bias, stride, pads,
                         relu=True, dtype=torch.bfloat16)
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    assert tuple(y.shape) == (n, ho, wo, cout) and y.dtype == torch.bfloat16
    geometry = (n, h, w, cin, ho, wo, cout, k, k, stride, pad, pad)
    names = [name for name, _ in recorded.calls]
    if path == "loop":
        assert names == ["loop"]
        args = recorded.calls[0][1]
        assert args[6:18] == geometry
        assert args[18:22] == (1, 0.0, pq._DTYPE_CODES[dtype], 1)
    else:
        assert names == ["quantize", "wgmma"]
        q_args, w_args = recorded.calls[0][1], recorded.calls[1][1]
        assert q_args[3:5] == (x.numel(), pq._DTYPE_CODES[dtype])
        assert w_args[0] == q_args[2]  # the wgmma kernel reads the codes
        assert w_args[6:18] == geometry
        assert w_args[18:22] == (1, 0.0, 1, {"gemm": 0, "conv": 1}[path])
    assert len(recorded.calls[-1][1]) == 23  # 22 arguments and the stream
    launched = {"quantize": pq.quantize_codes_cuda.launches,
                "gemm": pq.qconv_gemm_cuda.launches,
                "conv": pq.qconv_conv_cuda.launches,
                "loop": pq.qconv_loop_cuda.launches}
    want = dict.fromkeys(launched, 0)
    want[path] = 1
    want["quantize"] = int(path != "loop")
    assert launched == want and pq.qconv_bn_cuda.launches == 1


def test_path_wrappers_refuse_other_shapes(recorded):
    """The wgmma wrappers take int8 codes of their own shapes only."""
    codes = torch.zeros(2, 8, 8, 64, dtype=torch.int8)
    w3 = torch.zeros(64, 3, 3, 64, dtype=torch.int8)
    w1 = torch.zeros(64, 1, 1, 64, dtype=torch.int8)
    ones, zeros = torch.ones(64), torch.zeros(64)
    with pytest.raises(ValueError, match="takes the conv path"):
        pq.qconv_gemm_cuda(codes, 0.1, w3, ones, zeros, 1, "SAME")
    with pytest.raises(ValueError, match="takes the gemm path"):
        pq.qconv_conv_cuda(codes, 0.1, w1, ones, zeros, 1, "VALID")
    with pytest.raises(TypeError, match="int8 codes"):
        pq.qconv_conv_cuda(codes.float(), 0.1, w3, ones, zeros, 1, "SAME")
    odd = torch.zeros(2, 8, 8, 24, dtype=torch.int8)
    with pytest.raises(ValueError, match="takes the loop path"):
        pq.qconv_conv_cuda(odd, 0.1, torch.zeros(64, 3, 3, 24,
                                                 dtype=torch.int8),
                           ones, zeros, 1, "SAME")
    assert recorded.calls == []
    y = pq.qconv_conv_cuda(codes, 0.1, w3, ones, zeros, 1, "SAME")
    assert tuple(y.shape) == (2, 8, 8, 64)
    assert [name for name, _ in recorded.calls] == ["wgmma"]
    assert pq.qconv_conv_cuda.launches == 1
