"""K1's bf16 cluster design on the CPU: its plan, its algorithm and its
dispatch, against the JAX package's ``ops/dilated_conv.py``.

- ``dilated_residual_plan``: every (b, row, column) of the layer's output
  in exactly one CTA, the grid a whole number of clusters, at every C the
  kernel takes and the main path's and ragged shapes, with every cluster
  fitting on the card at once and with an H100's 15; the slices the main
  path's shapes take.
- ``dilated_residual_tiles_reference`` is the kernel's algorithm in plain
  PyTorch (64-row tiles whose taps read rows outside [0, T) as zero, each
  CTA's slice of H rounded on its own, the slices gathered, the residual
  from the centre tap). It is held to the port's plain version and JAX's
  ``dilated_residual_reference`` in float32 on the same inputs, with the
  bars ``chip_smoke.py`` holds the kernel to (8 bf16 ulps of max|ref| in
  bf16: H and the output are rounded once each; 1e-5 in float32, sums of
  3C products in another order).
- The dispatch: each design's C entry point and count, through stand-in C
  entry points; the TCN launches the current design only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.ops.dilated_conv import (
    dilated_residual_reference as jax_reference,
)
from computervision_codes_tpu_torch.models import tcn as port_tcn
from computervision_codes_tpu_torch.ops import dilated_conv as port

BF16_REL, F32_ATOL = 8 * 2.0 ** -8, 1e-5
CS = (128, 256, 512, 1024)
SHAPES = ((4, 256), (1, 256), (16, 256), (1, 1), (2, 37), (1, 300))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("resident", [None, 15])
@pytest.mark.parametrize("c", CS)
@pytest.mark.parametrize("b, t", SHAPES)
def test_plan_covers_every_row_and_column_once(b, t, c, resident):
    plan = port.dilated_residual_plan(b, t, c, torch.bfloat16, resident)
    s, width, rows = plan["cluster"], plan["slice"], plan["rows"]
    gx, gy = plan["grid"]
    assert s * width == c and s <= 8 and rows == 64
    assert gx % s == 0 and gy == b
    seen = np.zeros((b, t, c), np.int32)
    for x in range(gx):
        rank, tile = x % s, x // s
        t0 = tile * rows
        assert t0 < t  # no CTA without rows
        seen[:, t0:t0 + rows, rank * width:(rank + 1) * width] += 1
    assert (seen == 1).all()


def test_plan_at_the_main_path():
    """C = 512 on a card that holds 15 clusters of 8 at once (an H100):
    streams 1 takes clusters of 8 CTAs of 64 columns, 9 stages (32 CTAs);
    the offline shape's 16 clusters and streams 16's 64 would take two and
    five waves, so they take clusters of 4 CTAs of 128 columns, 6 stages
    (64 and 256 CTAs); where every cluster fits, 64 columns. C = 1024
    takes slices of 128 and 3 stages; float32 one block of 32 rows and
    every column."""
    for b, want, ctas in ((4, (128, 4, 6), 64), (1, (64, 8, 9), 32),
                          (16, (128, 4, 6), 256)):
        plan = port.dilated_residual_plan(b, 256, 512, torch.bfloat16, 15)
        assert (plan["slice"], plan["cluster"], plan["stages"]) == want
        assert plan["grid"][0] * plan["grid"][1] == ctas
        plan = port.dilated_residual_plan(b, 256, 512)
        assert (plan["slice"], plan["cluster"], plan["stages"]) == (64, 8, 9)
    plan = port.dilated_residual_plan(2, 300, 1024)
    assert (plan["slice"], plan["cluster"], plan["stages"]) == (128, 8, 3)
    plan = port.dilated_residual_plan(4, 256, 512, torch.float32)
    assert (plan["rows"], plan["cluster"], plan["grid"]) == (32, 1, (8, 4))


@pytest.mark.parametrize("c", [0, 64, 200, 1152])
def test_plan_rejects_widths_the_kernel_does_not_take(c):
    with pytest.raises(ValueError, match="C % 128"):
        port.dilated_residual_plan(1, 16, c)


def _layer(rng, b, t, c):
    return (rng.standard_normal((b, t, c)).astype(np.float32),
            (rng.standard_normal((3, c, c)) / np.sqrt(3 * c)).astype(
                np.float32),
            (rng.standard_normal(c) * 0.1).astype(np.float32),
            (rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32),
            (rng.standard_normal(c) * 0.1).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dil", ["1", "16", "T", "2T"])
def test_tiles_emulation_matches_references(rng, dil, causal, dtype):
    """Two 64-row tiles (T = 70, one ragged), clusters of 2 CTAs (C = 128);
    d = T and 2T leave whole taps in the zero fill."""
    b, t, c = 2, 70, 128
    d = {"1": 1, "16": 16, "T": t, "2T": 2 * t}[dil]
    arrays = [torch.from_numpy(a).to(dtype) for a in _layer(rng, b, t, c)]
    got = port.dilated_residual_tiles_reference(*arrays, d, causal).float()
    # more clusters than the card holds: one CTA of 128 columns a tile
    one = port.dilated_residual_tiles_reference(*arrays, d, causal,
                                                resident=1).float()
    f32 = [a.float() for a in arrays]
    want = port.dilated_residual_reference(*f32, d, causal)
    jax_want = np.asarray(jax_reference(*(jnp.asarray(a.numpy())
                                          for a in f32), d, causal))
    top = max(1.0, want.abs().max().item())
    tol = BF16_REL * top if dtype == torch.bfloat16 else F32_ATOL
    for ref in (want.numpy(), jax_want):
        assert np.abs(got.numpy() - ref).max() <= tol
        assert np.abs(one.numpy() - ref).max() <= tol
    if dtype == torch.bfloat16:  # and against the plain version in bf16
        plain = port.dilated_residual_reference(*arrays, d, causal).float()
        assert (got - plain).abs().max().item() <= tol


@pytest.mark.parametrize("c, resident", [(640, None), (512, 1)])
def test_tiles_emulation_at_wide_slices(rng, c, resident):
    """Slices of 128 columns: C = 640 (a cluster of 5), and C = 512 where
    the card holds fewer clusters than the layer has (a cluster of 4); one
    causal layer."""
    arrays = [torch.from_numpy(a).to(torch.bfloat16)
              for a in _layer(rng, 2, 66, c)]
    assert port.dilated_residual_plan(2, 66, c, torch.bfloat16,
                                      resident)["slice"] == 128
    got = port.dilated_residual_tiles_reference(*arrays, 5, True,
                                                resident).float()
    want = port.dilated_residual_reference(*(a.float() for a in arrays), 5,
                                           True)
    tol = BF16_REL * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


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
    for fn in (port.dilated_residual_cuda, port.dilated_residual_prev_cuda):
        monkeypatch.setattr(fn, "launches", 0)

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran in a kernel's place")
    monkeypatch.setattr(port, "dilated_residual_reference", no_plain)
    return rec


def test_dispatch_per_design(recorded, rng):
    arrays = [torch.from_numpy(a).to(torch.bfloat16)
              for a in _layer(rng, 2, 40, 128)]
    port.dilated_residual_cuda(*arrays, 16, True)
    port.dilated_residual_prev_cuda(*arrays, 16, False)
    port.dilated_residual_cuda(*(a.float() for a in arrays), 4)
    assert [name for name, _ in recorded.calls] == ["new", "prev", "new"]
    # (..., B, T, C, dilation, causal, dtype code, stream)
    assert recorded.calls[0][1][6:] == (2, 40, 128, 16, 1, 1, 0)
    assert recorded.calls[1][1][6:] == (2, 40, 128, 16, 0, 1, 0)
    assert recorded.calls[2][1][6:] == (2, 40, 128, 4, 0, 0, 0)
    assert port.design_launches == {"new": 2, "prev": 1}
    assert port.dilated_residual_cuda.launches == 2
    assert port.dilated_residual_prev_cuda.launches == 1
    with pytest.raises(ValueError, match="C % 128"):
        port.dilated_residual_cuda(*(a[..., :64] for a in arrays[:1]),
                                   arrays[1][:, :64, :64], arrays[2][:64],
                                   arrays[3][:64, :64], arrays[4][:64], 1)


def test_tcn_launches_the_new_design_only(recorded, monkeypatch):
    """A causal TCN stage of 3 layers in ``.eval()`` on a CUDA tensor
    (stood in for) launches the current design 3 times and the previous
    one never."""
    monkeypatch.setattr(port, "_forward", lambda x, *rest: (
        port.dilated_residual_cuda(x, *rest)))
    stage = port_tcn.TCNStage(3, 128, causal=True, dtype=torch.bfloat16,
                              generator=torch.Generator().manual_seed(0))
    stage.eval()  # the kernel is the eval path's; .train() runs the plain
    with torch.no_grad():
        stage(torch.zeros(1, 20, 128, dtype=torch.bfloat16))
    assert port.design_launches == {"new": 3, "prev": 0}
    assert [args[9] for _, args in recorded.calls] == [1, 2, 4]
