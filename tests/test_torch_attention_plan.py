"""K7 and K8's current design on the CPU: its algorithm, its plan and its
dispatch, against the JAX package's ``ops/attention.py``.

- ``attention_tiles_reference`` is the forward kernels' algorithm in plain
  PyTorch (key tiles of the kernel's size, the online softmax in float32,
  P rounded to bf16 at the running max in bf16, the split-key merge through
  the logsumexp). It is held to JAX's ``attention_reference`` in float32
  with the bars ``chip_smoke.py`` holds the kernel to (2 bf16 ulps of the
  output's largest magnitude: P rounded to bf16 moves an output by up to
  about 2^-9 of max|v|, plus the final rounding; 1e-5 of it in float32),
  and, float32, to the interpreted TPU kernel as
  ``tests/test_torch_attention.py`` runs it (2e-5, that file's bound).
- ``flash_attention_tiles_bwd_reference``, the backward kernels' rounding
  of P and dS to bf16 before their products, against ``jax.grad`` of the
  JAX op (jitted), as ``tests/test_torch_flash_attention.py`` does: 4 bf16
  ulps of max|want| (``chip_smoke.py``'s gradient bar; the cotangent is
  rounded to bf16 on each side too), 3e-5 in float32.
- ``attention_plan`` at every length and head dim MS-TCT runs, the
  training window and the ragged shapes: every (b, h, query row) in
  exactly one block, every key in exactly one split, a block on every SM
  (each kernel's shared memory is held within a block's 227 KB where it is
  defined, at compile time in ``csrc/attention_common.cuh``).
- The dispatch: per-design launch counts through stand-in C entry points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.ops import attention as jax_attention
from computervision_codes_tpu_torch.ops import attention as A

MSTCT_DIMS = (32, 48, 72, 108)
MSTCT_LENGTHS = tuple(int(t) for t in np.linspace(1000, 6000, 9)) + (
    2048, 5400, 8192)
F32_REL, PALLAS_ATOL, GRAD_F32_ATOL = 1e-5, 2e-5, 3e-5
OUT_BF16_ULPS, GRAD_BF16_ULPS = 2, 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16_ulp(top: float) -> float:
    return 2.0 ** (np.floor(np.log2(top)) - 7)


def _arrays(shape, tk, seed):
    rng = np.random.default_rng(seed)
    b, h, tq, d = shape
    return [rng.standard_normal((b, h, t, d)).astype(np.float32)
            for t in (tq, tk, tk)]


def _bf16_values(arrays):
    """The arrays rounded to bf16, as float32 numpy (the same values on
    both sides)."""
    return [torch.from_numpy(a).to(torch.bfloat16).float().numpy()
            for a in arrays]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,tk,chunk", [
    ((1, 2, 300, 24), 300, None),   # ragged against the 64-key tile
    ((2, 1, 130, 27), 70, None),    # odd D, Tq > Tk
    ((1, 2, 200, 108), 333, 128),   # two splits of 128 keys and a third
    ((1, 1, 96, 32), 96, 64),       # a split ending in a ragged tile
])
def test_forward_emulation_matches_jax(shape, tk, chunk, dtype):
    arrays = _arrays(shape, tk, 0)
    if dtype == torch.bfloat16:
        arrays = _bf16_values(arrays)
    want = np.asarray(jax_attention.attention_reference(
        *map(jnp.asarray, arrays)))
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    if chunk is not None and dtype == torch.float32:
        chunk //= 2  # the float32 kernel's 32-key tiles
    out, lse = A.attention_tiles_reference(q, k, v, chunk)
    assert out.dtype == dtype and out.shape == q.shape
    if dtype == torch.bfloat16:
        want = torch.tensor(want).to(dtype).float().numpy()
    top = float(np.abs(want).max())
    tol = (OUT_BF16_ULPS * _bf16_ulp(top) if dtype == torch.bfloat16
           else F32_REL * top)
    err = float(np.abs(out.float().numpy() - want).max())
    assert err <= tol, f"max_abs_err {err} > {tol}"
    want_lse = torch.logsumexp(torch.einsum(
        "bhqd,bhkd->bhqk", q.float(), k.float()) * shape[-1] ** -0.5, -1)
    torch.testing.assert_close(lse, want_lse, rtol=0,
                               atol=4e-3 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("tq,tk,d", [(300, 300, 27), (300, 141, 32)])
def test_forward_emulation_matches_interpreted_tpu_kernel(tq, tk, d):
    arrays = _arrays((1, 2, tq, d), tk, 1)
    want = np.asarray(jax_attention.attention_pallas(
        *map(jnp.asarray, arrays)))
    for chunk in (None, 64):
        got = A.attention_tiles_reference(
            *(torch.from_numpy(a) for a in arrays), chunk)[0].numpy()
        np.testing.assert_allclose(got, want, atol=PALLAS_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_merge_gives_the_single_pass(dtype):
    """Merged through the logsumexp, splits give the single pass's float32
    row within the kernel's bars (a split's P is rounded at its own running
    max): at T = 1000, the plan's split of one MS-TCT video, and at the
    ragged (Tq, Tk) = (100, 777)."""
    for seed, (shape, tk) in enumerate((((1, 1, 64, 48), 1000),
                                        ((1, 1, 100, 108), 777))):
        q, k, v = (torch.from_numpy(a).to(dtype)
                   for a in _arrays(shape, tk, 2 + seed))
        tile = A.KEY_TILE[dtype]
        one, lse1 = A.attention_tiles_reference(q, k, v)
        for chunk in (8 * tile, 3 * tile):
            got, lse = A.attention_tiles_reference(q, k, v, chunk)
            top = one.float().abs().max().item()
            tol = (OUT_BF16_ULPS * _bf16_ulp(top) if dtype == torch.bfloat16
                   else F32_REL * top)
            assert (got.float() - one.float()).abs().max().item() <= tol
            torch.testing.assert_close(
                lse, lse1, rtol=0,
                atol=4e-3 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,tk", [((1, 2, 300, 24), 300),
                                      ((1, 2, 130, 24), 70)])
def test_backward_emulation_matches_jax_gradients(shape, tk, dtype):
    """The gradients of sum(sin(out)) through the backward kernels'
    emulation against ``jax.grad`` of the JAX op through its dQ and dK/dV
    kernels (block size 128, jitted)."""
    arrays = _arrays(shape, tk, 3)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def loss(q, k, v):
        return jnp.sum(jnp.sin(jax_attention.flash_attention(q, k, v, 128,
                                                             128)))

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(a, jdt) for a in arrays))
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    out, lse = A.attention_tiles_reference(q, k, v)
    g = torch.cos(out.float()).to(dtype)
    got = A.flash_attention_tiles_bwd_reference(q, k, v, out, lse, g)
    for name, a, w in zip("qkv", got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        assert a.dtype == dtype
        top = float(np.abs(w).max())
        tol = (GRAD_BF16_ULPS * _bf16_ulp(top) if dtype == torch.bfloat16
               else GRAD_F32_ATOL)
        err = float(np.abs(a.float().numpy() - w).max())
        assert err <= tol, f"d{name}: max_abs_err {err} > {tol}"


PLAN_SHAPES = ([(1, 8, t, t, d) for t in MSTCT_LENGTHS for d in MSTCT_DIMS]
               + [(32, 8, 256, 256, d) for d in MSTCT_DIMS]
               + [(2, 8, 1000, 777, 27), (2, 8, 1000, 777, 108),
                  (2, 8, 777, 1000, 108)])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_covers_and_fills_the_card(dtype):
    for b, h, tq, tk, d in PLAN_SHAPES:
        plan = A.attention_plan(b, h, tq, tk, d, dtype)
        gx, gy, gz = plan["grid"]
        rows, chunk = plan["rows"], plan["chunk"]
        assert gx * gy * gz >= A.SMS, (b, h, tq, tk, d, plan)
        # every (b, h, query row) in exactly one block of each split
        assert gx == b * h and gy * rows >= tq > (gy - 1) * rows
        # every key in exactly one split, each split a whole number of
        # tiles and at least MIN_SPLIT_TILES of them (or the whole)
        starts = [z * chunk for z in range(gz)]
        ends = [min(tk, s + chunk) for s in starts]
        assert starts[0] == 0 and ends[-1] == tk
        assert all(e > s for s, e in zip(starts, ends))
        assert all(ends[i] == starts[i + 1] for i in range(gz - 1))
        tile = A.KEY_TILE[dtype]
        assert chunk % tile == 0
        assert gz == 1 or chunk >= A.MIN_SPLIT_TILES * tile


def test_plan_at_mstct_shapes():
    bf, f32 = torch.bfloat16, torch.float32
    long_ = A.attention_plan(1, 8, 8192, 8192, 108, bf)
    assert (long_["rows"], long_["splits"]) == (128, 1)
    assert long_["grid"] == (8, 64, 1) and long_["chunk"] == 8192
    video = A.attention_plan(1, 8, 1000, 1000, 108, bf)
    assert (video["rows"], video["splits"], video["chunk"]) == (64, 2, 512)
    assert A.attention_plan(1, 8, 1000, 1000, 108, f32)["splits"] == 2
    assert A.attention_plan(1, 8, 2048, 2048, 32, bf)["rows"] == 64
    assert A.attention_plan(32, 8, 256, 256, 72, bf)["rows"] == 128
    assert A.attention_plan(1, 8, 8192, 8192, 48, bf)["rows"] == 64
    # too little work to spread: one block, no split
    tiny = A.attention_plan(1, 1, 64, 64, 32, bf)
    assert tiny["grid"] == (1, 1, 1)
    with pytest.raises(ValueError, match="D <= 128"):
        A.attention_plan(1, 8, 64, 64, 129, bf)


class _Recorder:
    """Stands in for the C entry points: records each call's name and
    arguments and returns 0 (success)."""

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
    monkeypatch.setattr(A, "_launch_fn", lambda prev=False: rec.entry(
        "attention" + "_prev" * prev))
    monkeypatch.setattr(A, "_flash_fns", lambda: (
        rec.entry("flash_fwd"), rec.entry("flash_fwd_prev"),
        rec.entry("flash_bwd")))
    # CPU tensors stand in for CUDA ones, on a card of 132 SMs
    monkeypatch.setattr(A, "on_card", lambda what, x: None)
    monkeypatch.setattr(A, "run_entry", lambda fn, device, *args: fn(
        *(a.data_ptr() if isinstance(a, torch.Tensor) else a
          for a in args), 0))
    monkeypatch.setattr(A, "_sm_count", lambda index: A.SMS)

    def no_plain(*args, **kwargs):
        raise AssertionError("a plain version ran in a kernel's place")
    for name in ("attention_reference", "flash_attention_reference_fwd",
                 "flash_attention_reference_bwd"):
        monkeypatch.setattr(A, name, no_plain)
    monkeypatch.setattr(A, "design_launches", {
        lib: dict.fromkeys(counts, 0)
        for lib, counts in A.design_launches.items()})
    for fn in (A.attention_cuda, A.attention_prev_cuda,
               A.flash_attention_fwd_cuda, A.flash_attention_dq_cuda,
               A.flash_attention_dkv_cuda, A.flash_attention_fwd_prev_cuda,
               A.flash_attention_dq_prev_cuda,
               A.flash_attention_dkv_prev_cuda):
        monkeypatch.setattr(fn, "launches", 0)
    return rec


def test_dispatch_per_design(recorded):
    """Each entry point launches its own design and counts it per design;
    the new forward passes the plan, and a split its float32 scratch."""
    q = torch.zeros(1, 8, 1000, 108, dtype=torch.bfloat16)
    g = torch.zeros_like(q)
    lse = torch.zeros(1, 8, 1000)
    A.attention_cuda(q, q, q)                      # split in two
    A.attention_prev_cuda(q, q, q)
    A.flash_attention_fwd_cuda(q[:, :, :256], q[:, :, :256], q[:, :, :256])
    A.flash_attention_fwd_prev_cuda(q, q, q, with_lse=False)
    A.flash_attention_dq_cuda(q, q, q, g, lse, lse)
    A.flash_attention_dkv_cuda(q, q, q, g, lse, lse)
    A.flash_attention_dq_prev_cuda(q, q, q, g, lse, lse)
    A.flash_attention_dkv_prev_cuda(q, q, q, g, lse, lse)
    names = [name for name, _ in recorded.calls]
    assert names == ["attention", "attention_prev", "flash_fwd",
                     "flash_fwd_prev"] + ["flash_bwd"] * 4
    new, old = recorded.calls[0][1], recorded.calls[1][1]
    assert new[21:26] == (8, 1, 64, 512, 2)  # vb, bf16, rows, chunk, splits
    assert new[26] != 0 and new[27] != 0     # the split's scratch
    assert len(old) == 24 and old[21:23] == (8, 1)
    fwd = recorded.calls[2][1]  # a short video: 64 rows, the keys split
    plan = A.attention_plan(1, 8, 256, 256, 108, torch.bfloat16)
    assert (plan["rows"], plan["chunk"], plan["splits"]) == (64, 128, 2)
    assert fwd[4] != 0 and fwd[24:27] == (64, 128, 2) and fwd[27] != 0
    assert recorded.calls[3][1][4] is None  # no lse
    kinds = [(args[0], args[-2]) for _, args in recorded.calls[4:]]
    assert kinds == [(0, 0), (1, 0), (0, 1), (1, 1)]  # (kind, prev)
    want = {"attention": {"fwd new": 1, "merge new": 1, "dq new": 0,
                          "dkv new": 0, "fwd prev": 1, "merge prev": 0,
                          "dq prev": 0, "dkv prev": 0},
            "flash_attention": {"fwd new": 1, "merge new": 1, "dq new": 1,
                                "dkv new": 1, "fwd prev": 1,
                                "merge prev": 0, "dq prev": 1,
                                "dkv prev": 1}}
    assert A.design_launches == want
    assert [fn.launches for fn in (
        A.attention_cuda, A.attention_prev_cuda, A.flash_attention_fwd_cuda,
        A.flash_attention_dq_cuda, A.flash_attention_dkv_cuda,
        A.flash_attention_fwd_prev_cuda, A.flash_attention_dq_prev_cuda,
        A.flash_attention_dkv_prev_cuda)] == [1] * 8


def test_model_path_counts_the_new_design(recorded, monkeypatch):
    """``multi_head_attention`` (MS-TCT's) and ``flash_attention`` on a
    CUDA tensor launch the new design only."""
    q = torch.zeros(32, 8, 256, 48, dtype=torch.bfloat16)  # the window
    monkeypatch.setattr(A, "_forward", lambda q, k, v: A.attention_cuda(
        q, k, v))
    A.multi_head_attention(q, q, q)
    monkeypatch.setattr(A, "_flash_device", lambda q: "cuda")
    A.flash_attention_pallas(q, q, q)
    counts = A.design_launches
    assert counts["attention"]["fwd new"] == 1
    assert counts["flash_attention"]["fwd new"] == 1
    assert all(n == 0 for lib in counts.values()
               for key, n in lib.items() if key.endswith("prev"))
    # D = 48: 64-row blocks, no split (rows, chunk, splits)
    assert recorded.calls[0][1][23:26] == (64, 256, 1)
