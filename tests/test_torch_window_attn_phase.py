"""The window-attention phase that K3 (and so K5 and K6) and K10 share on
the card (``csrc/window_attn.cuh``): one block per (window, head), each warp
holding its 16-query strips' scores in registers.

``window_attn_strips_reference`` emulates that algorithm in plain PyTorch:
the window padded to whole strips, -inf past the real keys, each row's sum
in the kernel's order, P rounded before P v. It is held to the JAX
``window_attention_reference``, to the port's, and to K3's attention (the
port's ``window_attention_core``, and ``window_attn_phase_reference`` on a
packed qkv) for N in {16, 49, 144}, with and without a mask. float32: within
1e-5 of the largest magnitude (sums in another order). bf16: within 2 bf16
ulps of it against the float32 reference rounded once (K10's bar on the
card) and against K3's bf16 attention (a denominator summed in another
order can move a rounded P by one ulp). ``attn_plan`` gives every window of
1-12 (each window the Swin variants use) at most 227 KB of shared memory a
block and at least 3 blocks an SM in both dtypes. The dispatch is driven
with the C entry points replaced by recorders: each wrapper calls its
entry point, never a plain version, and counts the launch per library. The kernels are held to the plain versions on the card
by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from computervision_codes_tpu.ops import window_attention as jwa
from computervision_codes_tpu_torch.models.swin import VARIANTS, shift_mask
from computervision_codes_tpu_torch.ops import mlp_block as k4
from computervision_codes_tpu_torch.ops import swin_block as k5
from computervision_codes_tpu_torch.ops import swin_gemm as sg
from computervision_codes_tpu_torch.ops import swin_train
from computervision_codes_tpu_torch.ops import window_attention as wa
from computervision_codes_tpu_torch.ops import window_mhsa as k3

F32_REL, BF16_ULPS = 1e-5, 2
HEADS, D, NW = 2, 32, 2
CASES = [(n, masked) for n in (16, 49, 144) for masked in (False, True)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(n, masked, seed):
    """q, k, v (2 * NW windows, HEADS, n, D), bias (HEADS, n, n) and a 0 /
    -100 mask of NW windows (or None), float32 numpy."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2 * NW, HEADS, n, D)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((HEADS, n, n)).astype(np.float32)
    mask = (np.where(rng.random((NW, n, n)) < 0.3, -100.0, 0.0).astype(
        np.float32) if masked else None)
    return q, k, v, bias, mask


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _packed(q, k, v):
    """(BW, H, N, D) q, k, v -> K3's (B, nW, N, 3C) qkv."""
    bw, h, n, d = q.shape
    return torch.cat([t.transpose(1, 2).reshape(bw // NW, NW, n, h * d)
                      for t in (q, k, v)], dim=-1)


def _k3_core(q, k, v, bias, mask, dtype):
    """K3's attention over the same windows, back in (BW, H, N, D)."""
    bw, h, n, d = q.shape
    o = k3.window_attention_core(_packed(q, k, v), bias, mask, h, dtype)
    return o.reshape(bw, n, h, d).transpose(1, 2)


def _ulp(top):
    return 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)


@pytest.mark.parametrize("n, masked", CASES)
def test_strips_float32_match_jax_and_k3(n, masked):
    q, k, v, bias, mask = _inputs(n, masked, seed=n + masked)
    got = wa.window_attn_strips_reference(*map(_t, (q, k, v, bias, mask)),
                                          nw=NW).numpy()
    want = np.asarray(jwa.window_attention_reference(q, k, v, bias, mask,
                                                     nw=NW))
    atol = F32_REL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg="jax")
    port = wa.window_attention_reference(*map(_t, (q, k, v, bias, mask)),
                                         nw=NW)
    np.testing.assert_allclose(got, port.numpy(), rtol=0, atol=atol,
                               err_msg="port reference")
    core = _k3_core(*map(_t, (q, k, v, bias, mask)), torch.float32)
    np.testing.assert_allclose(got, core.numpy(), rtol=0, atol=atol,
                               err_msg="K3's attention")


@pytest.mark.parametrize("n, masked", CASES)
def test_strips_bf16_match_rounded_reference_and_k3(n, masked):
    q, k, v, bias, mask = _inputs(n, masked, seed=10 + n + masked)
    bf = [_t(a, torch.bfloat16) for a in (q, k, v, bias, mask)]
    got = wa.window_attn_strips_reference(*bf, nw=NW)
    assert got.dtype == torch.bfloat16 and got.shape == (2 * NW, HEADS, n, D)
    exact = [None if a is None else a.float().numpy() for a in bf]
    want = np.asarray(jwa.window_attention_reference(*exact, nw=NW))
    want = torch.tensor(want).bfloat16().float().numpy()
    tol = BF16_ULPS * _ulp(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol,
                               err_msg="float32 reference rounded once")
    core = _k3_core(*bf, torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got.float().numpy(), core, rtol=0, atol=tol,
                               err_msg="K3's bf16 attention")


@pytest.mark.parametrize("w, shift", [(4, 0), (4, 2), (7, 3), (12, 6)])
def test_phase_reference_on_packed_qkv(w, shift):
    """The phase on K3's packed (B, Hp, Wp, 3C) qkv equals the strips over
    its windows; the window absmax is each window's max |out| (an odd
    window's padded query may raise it)."""
    rng = np.random.default_rng(w + shift)
    b, side, c = 2, 2 * w, HEADS * D
    n = w * w
    qkv = _t(rng.standard_normal((b, side, side, 3 * c)).astype(np.float32))
    bias = _t(rng.standard_normal((HEADS, n, n)).astype(np.float32))
    mask = (shift_mask(side, side, w, shift, "cpu", torch.float32)
            if shift else None)
    kw = dict(window=w, num_heads=HEADS)
    out, amax = k3.window_attn_phase_reference(qkv, bias, mask, absmax=True,
                                               **kw)
    assert torch.equal(out, k3.window_attn_phase_reference(qkv, bias, mask,
                                                           **kw))
    win = k3.window_partition(qkv, w)  # (B * nW, N, 3C)
    q, k, v = (win[..., i * c:(i + 1) * c].reshape(-1, n, HEADS, D)
               .transpose(1, 2) for i in range(3))
    nw = (side // w) ** 2
    strips = wa.window_attn_strips_reference(q, k, v, bias, mask, nw)
    want = k3.window_reverse(strips.transpose(1, 2).reshape(-1, n, c), w,
                             side, side)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0,
                               atol=F32_REL * want.abs().max().item())
    per_window = k3.window_partition(out, w).abs().amax(dim=(1, 2))
    assert amax.shape == (b * nw,)
    if w % 2:
        assert bool((amax >= per_window).all())
    else:
        assert torch.equal(amax, per_window)


# every window a Swin block can take: a variant's window_size, or the
# smaller map side a late stage clamps it to
WINDOWS = range(1, k3.MAX_WINDOW + 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("w", WINDOWS)
def test_attn_plan_fits_three_blocks(w, dtype):
    assert all(cfg["window_size"] in WINDOWS for cfg in VARIANTS.values())
    plan = wa.attn_plan(w * w, dtype)
    assert plan["np"] % 16 == 0 and plan["np"] - 16 < w * w <= plan["np"]
    assert plan["warps"] * plan["rounds"] >= plan["strips"]
    assert plan["warps"] <= 4 and plan["rounds"] == -(-plan["strips"] // 4)
    assert plan["smem"] <= wa.SMEM_PER_BLOCK
    assert plan["blocks_per_sm"] >= 3


def test_attn_plan_at_144_tokens():
    bf, f32 = wa.attn_plan(144, torch.bfloat16), wa.attn_plan(144,
                                                               torch.float32)
    assert (bf["warps"], bf["rounds"], bf["smem"]) == (3, 3, 34_560)
    assert (f32["smem"], f32["blocks_per_sm"]) == (62_208, 3)
    assert bf["blocks_per_sm"] == 6
    assert wa.attn_plan(49, torch.bfloat16)["warps"] == 4
    with pytest.raises(ValueError, match="tokens"):
        wa.attn_plan(145, torch.bfloat16)


class _Recorder:
    """Stands in for the C entry points: records each call's name and
    arguments and returns 0 (success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def recorded(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(k3, "_phase_fn", lambda: rec.window_attn_phase)
    monkeypatch.setattr(wa, "_launch_fn", lambda: rec.window_attention)
    for mod in (k3, k5):
        lib = mod.__name__.rsplit(".", 1)[1]
        monkeypatch.setattr(mod, "_launch_fn", lambda loop=False, lib=lib:
                            getattr(rec, lib + "_loop" * loop))
    # CPU tensors stand in for CUDA ones
    monkeypatch.setattr(k4, "on_card", lambda what, x: None)
    monkeypatch.setattr(k4, "run_entry", lambda fn, device, *args: fn(*args))

    def no_plain(*args, **kwargs):
        raise AssertionError("a plain version ran in a kernel's place")
    for mod, name in ((wa, "window_attention_reference"),
                      (wa, "window_attn_strips_reference"),
                      (k3, "window_attn_phase_reference"),
                      (k3, "window_mhsa_reference"),
                      (k5, "swin_block_reference")):
        monkeypatch.setattr(mod, name, no_plain)
    monkeypatch.setattr(wa, "phase_launches",
                        dict.fromkeys(wa.PHASE_LIBRARIES, 0))
    monkeypatch.setattr(sg, "launches", {
        lib: dict.fromkeys(sg.PATHS, 0) for lib in sg.LIBRARIES})
    for fn in (k3.window_attn_phase_cuda, wa.window_attention_cuda,
               k3.window_mhsa_cuda, swin_train.window_mhsa_branch_cuda,
               k5.swin_block_cuda):
        monkeypatch.setattr(fn, "launches", 0)
    return rec


def test_phase_dispatch_per_design(recorded):
    """Each phase entry point launches the phase and counts it per library;
    the int8 branch's absmax scratch is one int32 a window, read as float;
    without a mask or absmax the entry gets null pointers."""
    b, side, w, c = 2, 8, 4, HEADS * D
    n, nw = w * w, (side // w) ** 2
    qkv = torch.zeros(b, side, side, 3 * c, dtype=torch.bfloat16)
    bias = torch.zeros(HEADS, n, n)
    mask = torch.zeros(nw, n, n)
    kw = dict(window=w, num_heads=HEADS)
    out, amax = k3.window_attn_phase_cuda(qkv, bias, mask, absmax=True, **kw)
    k3.window_attn_phase_cuda(qkv, bias, None, **kw)
    q = torch.zeros(b * nw, HEADS, n, D, dtype=torch.bfloat16)
    wa.window_attention_cuda(q, q, q, bias, mask, nw)
    wa.window_attention_cuda(q, q, q, bias, None, 1)
    names = [name for name, _ in recorded.calls]
    assert names == ["window_attn_phase", "window_attn_phase",
                     "window_attention", "window_attention"]
    (_, new), (_, bare) = recorded.calls[:2]
    assert new[4].shape == (b * nw,) and new[4].dtype == torch.int32
    assert bare[2] is None and bare[4] is None  # no mask, no absmax
    assert new[5:] == (b, side, side, c, HEADS, w, D ** -0.5, 1)
    assert bare[-1] == 1  # bf16
    assert out.shape == (b, side, side, c) and amax.dtype == torch.float32
    assert wa.phase_launches == {
        "window_mhsa": 2, "swin_block": 0, "window_attention": 2}
    assert (k3.window_attn_phase_cuda.launches,
            wa.window_attention_cuda.launches) == (2, 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_model_paths_count_the_new_design(recorded, rng, dtype):
    """K3, K6's attention branch and K5 each count one launch of the
    attention phase in their library."""
    b, side, w, c, hidden = 2, 8, 4, 64, 256
    n = w * w

    def m(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    x = m(b, side, side, c)
    ln = [torch.ones(c), torch.zeros(c)]
    attn = [*ln, m(c, 3 * c), m(3 * c), m(c, c), m(c), m(HEADS, n, n)]
    mlp = [*ln, m(c, hidden), m(hidden), m(hidden, c), m(c)]
    kw = dict(window=w, num_heads=HEADS)
    k3.window_mhsa_cuda(x, *attn, None, **kw)
    swin_train.window_mhsa_branch_cuda(x, *attn, None, **kw)
    k5.swin_block_cuda(x, *attn, None, *mlp, **kw)
    assert [name for name, _ in recorded.calls] == [
        "window_mhsa", "window_mhsa", "swin_block"]
    assert wa.phase_launches == {
        "window_mhsa": 2, "swin_block": 1, "window_attention": 0}
