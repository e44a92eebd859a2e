"""K2's bf16 design on the CPU: its weight layout, its row walk, its plan and
its dispatch, against the JAX package's ``ops/stem_pool.py``.

- ``stem_pair_weight``: the (160, 64) weight of pairs of adjacent input
  elements. A conv row built from the staged input rows through it equals
  the 7x7/2 convolution, as ``models/resnet.py::_s2d_conv1`` (the JAX
  kernel's space-to-depth form) and ``F.conv2d`` compute it.
- ``stem_pool_walk_reference`` is the kernel's algorithm in plain PyTorch
  (work items of ``stem_pool_plan``, padded input rows staged from the
  chunk's first element, K = 160 pair products, conv row 2p + 1 carried as
  the next row's 2p - 1, the pool, one rounding after the max). It is held
  to the port's plain version and JAX's reference at the JAX tests' shapes
  and batch sizes with the bars ``chip_smoke.py`` holds the kernel to (one
  bf16 ulp of the largest output; 2e-5 in float32), and to the JAX Pallas
  kernel in interpret mode in float32.
- Rounding after the max gives the max of the rounded cells, bit for bit
  (the JAX kernel rounds before its pool).
- The plan: every (frame, pooled row, pooled column) in exactly one work
  item, and the bands the main path's frame counts take.
- The dispatch: each design's C entry point and count through stand-in C
  entry points; a fused-stem ResNet launches the current design only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from computervision_codes_tpu.ops.stem_pool import (
    stem_pool_fused as jax_fused,
    stem_pool_reference as jax_reference,
)
from computervision_codes_tpu_torch.models import resnet as port_resnet
from computervision_codes_tpu_torch.ops import stem_pool as port

F32_ATOL = 2e-5
SHAPES = [(2, 32, 56), (2, 16, 16), (2, 24, 40), (3, 20, 12), (1, 16, 1040)]


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


def test_pair_weight_gives_the_stem_convolution(rng):
    """Conv rows built as the kernel builds them (A[s, 2P + e] = element
    6 s - 10 + 2u + e of padded row 2r + dy, P = 11 dy + u, the element of
    no tap zeroed) times ``stem_pair_weight`` equal ``_s2d_conv1`` and
    ``F.conv2d`` (float64, so only the products' order differs)."""
    w, _ = _weights(rng)
    x = rng.standard_normal((1, 16, 24, 3))
    wt = torch.from_numpy(w).double()
    pw = port.stem_pair_weight(wt)
    assert pw.shape == (160, 64) and (pw[154:] == 0).all()
    assert (pw[0:154:22] == 0).all()  # the low element of each row's pair 0
    h, wd = 16, 24
    padded = torch.zeros(h + 6, 3 * wd + 32, dtype=torch.float64)
    padded[3:h + 3, 16:16 + 3 * wd] = torch.from_numpy(x[0].reshape(h, -1))
    s = torch.arange(wd // 2)
    pair = torch.arange(77)
    dy, u = pair // 11, pair % 11
    col = 6 * s[:, None] - 10 + 2 * u[None] + 16  # element 0 at column 16
    rows = torch.stack([padded[2 * r + dy] for r in range(h // 2)])
    a = torch.zeros(h // 2, wd // 2, 160, dtype=torch.float64)
    a[..., 0:154:2] = rows[:, pair, col]
    a[..., 1:154:2] = rows[:, pair, col + 1]
    a[..., 0:154:22] = 0.0
    got = (a @ pw).permute(2, 0, 1)[None]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    oihw = wt.permute(3, 2, 0, 1)
    for want in (port_resnet._s2d_conv1(xt, oihw),
                 F.conv2d(xt, oihw, None, stride=2, padding=3)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n, h, wd", SHAPES + [(b, 16, 16)
                                               for b in (9, 10, 11, 22)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_walk_emulation_matches_references(rng, n, h, wd, dtype):
    """The JAX tests' shapes and the batch sizes of the JAX kernel's split
    and pad branches, plus a frame wider than one column chunk (W = 1040:
    two chunks of 130 pooled columns) and W % 8 != 0; 7 SMs, so the small
    shapes split into bands."""
    w, bias = _weights(rng)
    x = rng.standard_normal((n, h, wd, 3)).astype(np.float32)
    xt, wt = (torch.from_numpy(a).to(dtype) for a in (x, w))
    bt = torch.from_numpy(bias)
    got = port.stem_pool_walk_reference(xt, wt, bt, sms=7).float().numpy()
    plain = port.stem_pool_reference(xt, wt, bt).float().numpy()
    jax_want = np.asarray(jax_reference(
        jnp.asarray(xt.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(wt.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(bias)), np.float32)
    if dtype == torch.float32:
        tol = F32_ATOL
    else:
        tol = 2.0 ** (np.floor(np.log2(np.abs(plain).max())) - 7)
    for ref in (plain, jax_want):
        assert np.abs(got - ref).max() <= tol
    if dtype == torch.float32 and wd % 8 == 0 and wd <= 56:
        pallas = np.asarray(jax_fused(*map(jnp.asarray, (x, w, bias))))
        assert np.abs(got - pallas).max() <= F32_ATOL


def test_rounding_after_the_max_is_bit_exact(rng):
    """round(max(cells)) == max(round(cells)) for bf16, on seeded maps of
    ReLU outputs (ties and both signs of rounding among them)."""
    v = torch.from_numpy(np.maximum(
        rng.standard_normal((4, 64, 32, 56)), 0).astype(np.float32))
    v[:, :, ::7] = v[:, :, 1::7]  # ties
    after = F.max_pool2d(v, 3, 2, 1).to(torch.bfloat16)
    before = F.max_pool2d(v.to(torch.bfloat16).float(), 3, 2, 1).to(
        torch.bfloat16)
    assert torch.equal(after.view(torch.int16), before.view(torch.int16))


@pytest.mark.parametrize("n, h, wd, sms", [(1024, 256, 448, 132),
                                           (64, 256, 448, 132),
                                           (1, 256, 448, 132),
                                           (4, 256, 448, 132),
                                           (3, 20, 12, 7), (2, 16, 1040, 5),
                                           (22, 16, 16, 132)])
def test_plan_covers_every_output_once(n, h, wd, sms):
    plan = port.stem_pool_plan(n, h, wd, sms)
    ph, qw_all = h // 4, wd // 4
    bands = -(-ph // plan["band"])
    assert plan["items"] == n * bands * plan["chunks"]
    assert plan["grid"] == min(plan["items"], sms)
    assert 2 * plan["qw"] + 1 <= 256  # a chunk's conv columns: 4 m64 tiles
    seen = np.zeros((n, ph, qw_all), np.int32)
    for item in range(plan["items"]):
        chunk = item % plan["chunks"]
        frame, band = divmod(item // plan["chunks"], bands)
        p0, q0 = band * plan["band"], chunk * plan["qw"]
        seen[frame, p0:p0 + plan["band"], q0:q0 + plan["qw"]] += 1
    assert (seen == 1).all()


def test_plan_at_the_main_path():
    """1,024 frames: a frame a work item (8 rounds over 132 SMs); 64
    frames: bands of 32 pooled rows (128 items, one round); the push (one
    frame): bands of one pooled row (64 items)."""
    bands = {n: port.stem_pool_plan(n, 256, 448, 132)["band"]
             for n in (1024, 64, 1)}
    assert bands == {1024: 64, 64: 32, 1: 1}
    plan = port.stem_pool_plan(1024, 256, 448, 132)
    assert (plan["chunks"], plan["qw"], plan["grid"]) == (1, 112, 132)
    assert plan["row_bytes"] % 16 == 0 and plan["row_bytes"] >= 2 * (
        12 * 112 + 36)


class _Recorder:
    def __init__(self):
        self.calls = []

    def entry(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def recorded(monkeypatch):
    """CPU tensors stand in for CUDA ones; the C entry points record."""
    rec = _Recorder()
    monkeypatch.setattr(port, "_launch_fn", lambda prev=False: rec.entry(
        "prev" if prev else "new"))
    monkeypatch.setattr(port, "on_card", lambda name, x: None)
    monkeypatch.setattr(port, "run_entry", lambda fn, device, *args: fn(
        *(a.data_ptr() if isinstance(a, torch.Tensor) else a
          for a in args), 0))
    monkeypatch.setattr(port, "design_launches",
                        dict.fromkeys(port.DESIGNS, 0))
    for fn in (port.stem_pool_cuda, port.stem_pool_prev_cuda):
        monkeypatch.setattr(fn, "launches", 0)

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran in a kernel's place")
    monkeypatch.setattr(port, "stem_pool_reference", no_plain)
    return rec


def test_dispatch_per_design(recorded, rng):
    w, bias = (torch.from_numpy(a) for a in _weights(rng))
    x = torch.zeros(2, 16, 24, 3, dtype=torch.bfloat16)
    port.stem_pool_cuda(x, w, bias)
    port.stem_pool_prev_cuda(x, w, bias)
    port.stem_pool_cuda(x.float(), w, bias)
    port.stem_pool_cuda(x[:0], w, bias)  # no frames: no launch
    assert [name for name, _ in recorded.calls] == ["new", "prev", "new"]
    # (x, w, bias, y, N, H, W, dtype code, stream)
    assert [args[4:] for _, args in recorded.calls] == [
        (2, 16, 24, 1, 0), (2, 16, 24, 1, 0), (2, 16, 24, 0, 0)]
    assert port.design_launches == {"new": 2, "prev": 1}
    assert port.stem_pool_cuda.launches == 2
    assert port.stem_pool_prev_cuda.launches == 1


def test_fused_stem_launches_the_new_design_only(recorded, monkeypatch):
    """A bf16 ResNet18 with the fused stem on a CUDA tensor (stood in for)
    launches the current design once per forward."""
    monkeypatch.setattr(port_resnet, "stem_pool_fused", port.stem_pool_cuda)
    model = port_resnet.build_resnet("resnet18", dtype=torch.bfloat16,
                                     fused_stem=True)
    with torch.no_grad():
        model(torch.zeros(1, 32, 32, 3, dtype=torch.bfloat16))
    assert port.design_launches == {"new": 1, "prev": 0}
    assert [args[4:7] for _, args in recorded.calls] == [(1, 32, 32)]
