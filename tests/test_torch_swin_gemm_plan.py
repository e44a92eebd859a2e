"""The Swin GEMM core's split phases, path rule and dispatch
(ops/swin_gemm.py).

On the card every bf16 and int8 product of K3, K4, K5 (and K6), P1 and P2
runs as a pass that writes the A operand (LayerNorm for bf16 QKV and fc1, a
quantize pass for int8) and then the TMA-fed wgmma GEMM; the older loops
applied LayerNorm and quantized on load. Their plain versions must compose
to what the CPU runs: the LayerNorm pass's bf16 / float32 output fed to
``gemm_reference`` gives ``window_mhsa_reference`` and
``mlp_block_reference`` exactly, and the JAX package's XLA references at
the float32 tolerance the kernel tests hold (2e-5: sums in another order);
the quantize pass's codes through the exact int32 product give ``q8_dot``
and the JAX ``q8_dot`` bit for bit, for each source of A and both forms of
the activation-scale map. ``gemm_path`` sends every product of the
Swin-L-384 teachers (bf16 and int8, batch 16), of the training step (K6,
batch 8) and of P1's twelve shapes to wgmma, float32 to the FMA loop, and
what wgmma cannot take to the loop. The dispatch is driven with the C entry
points replaced by recorders: the right scratch, counts per path, and no
plain version. The kernels are held to the plain versions and to the loops
on the card by chip_smoke.py.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.ops import mlp_block as jax_mlp
from computervision_codes_tpu.ops import window_mhsa as jax_mhsa
from computervision_codes_tpu_torch.models.swin import VARIANTS, SwinBlock
from computervision_codes_tpu_torch.ops import mlp_block as k4
from computervision_codes_tpu_torch.ops import swin_block as k5
from computervision_codes_tpu_torch.ops import swin_gemm as sg
from computervision_codes_tpu_torch.ops import window_mhsa as k3
from computervision_codes_tpu_torch.scripts import int8_kernel_probe as p1

ATOL = 2e-5  # float32, as tests/test_torch_swin_kernels.py


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ln_params(rng, c):
    return (torch.from_numpy(1 + 0.1 * rng.standard_normal(c).astype(
        np.float32)), torch.from_numpy(0.1 * rng.standard_normal(c).astype(
            np.float32)))


def _mat(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
        np.float32))


# ---- composition ----------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res_add", [True, False])
def test_layer_norm_pass_and_gemm_compose_to_mlp_block(rng, dtype, res_add):
    """LN pass, fc1 + GELU, fc2 + residual (or bias only: K6) equal the
    plain K4 bit for bit, and in float32 the JAX mlp_block_reference."""
    c, hidden = 32, 128
    x = _mat(rng, 2, 24, c)
    g, b = _ln_params(rng, c)
    w1, b1 = _mat(rng, c, hidden, scale=0.2), _mat(rng, hidden, scale=0.01)
    w2, b2 = _mat(rng, hidden, c, scale=0.1), _mat(rng, c, scale=0.01)
    xt, w1t, b1t, w2t, b2t = (a.to(dtype) for a in (x, w1, b1, w2, b2))
    normed = k4.layer_norm_f32(xt, g, b)
    h = sg.gemm_reference(normed, w1t, b1t, "bias_gelu")
    y = sg.gemm_reference(h, w2t, b2t, "res_f32" if res_add else "bias",
                          res=xt)
    want = k4.mlp_block_reference(xt, g, b, w1t, b1t, w2t, b2t,
                                  res_add=res_add)
    assert y.dtype == dtype and torch.equal(y, want)
    if dtype == torch.float32:
        jwant = jax_mlp.mlp_block_reference(
            *(jnp.asarray(a.numpy()) for a in (x, g, b, w1, b1, w2, b2)),
            res_add=res_add)
        np.testing.assert_allclose(y.numpy(), np.asarray(jwant), atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 2])
def test_layer_norm_pass_and_gemm_compose_to_window_mhsa(rng, dtype, shift):
    """LN pass, QKV + bias, the attention core, proj + rounded residual
    equal the plain K3 bit for bit, and in float32 the JAX
    window_mhsa_reference."""
    b, hw, c, heads, w = 2, 8, 64, 2, 4
    x = _mat(rng, b, hw, hw, c)
    g, be = _ln_params(rng, c)
    wqkv, bqkv = _mat(rng, c, 3 * c, scale=0.1), _mat(rng, 3 * c, scale=0.1)
    wproj, bproj = _mat(rng, c, c, scale=0.1), _mat(rng, c, scale=0.1)
    bias = _mat(rng, heads, w * w, scale=0.1).reshape(heads, w * w, 1)
    bias = bias.expand(heads, w * w, w * w).contiguous()
    mask = None
    if shift:
        from computervision_codes_tpu_torch.models.swin import shift_mask
        mask = shift_mask(hw, hw, w, shift, "cpu", torch.float32)
    xt, wqkvt, bqkvt, wprojt, bprojt = (a.to(dtype) for a in
                                        (x, wqkv, bqkv, wproj, bproj))
    m = b * hw * hw
    normed = k4.layer_norm_f32(xt, g, be).reshape(m, c)
    qkv = sg.gemm_reference(normed, wqkvt, bqkvt).reshape(b, hw, hw, 3 * c)
    qkv = k3.window_partition(qkv, w).reshape(b, -1, w * w, 3 * c)
    o = k3.window_attention_core(qkv, bias, mask, heads, dtype)
    o = k3.window_reverse(o.flatten(0, 1), w, hw, hw).reshape(m, c)
    y = sg.gemm_reference(o, wprojt, bprojt, "round_res",
                          res=xt.reshape(m, c)).reshape(xt.shape)
    kw = dict(window=w, num_heads=heads)
    want = k3.window_mhsa_reference(xt, g, be, wqkvt, bqkvt, wprojt, bprojt,
                                    bias, mask, **kw)
    assert y.dtype == dtype and torch.equal(y, want)
    if dtype == torch.float32:
        jwant = jax_mhsa.window_mhsa_reference(
            *(jnp.asarray(a.numpy()) for a in (x, g, be, wqkv, bqkv, wproj,
                                               bproj, bias)),
            None if mask is None else jnp.asarray(mask.numpy()), **kw)
        np.testing.assert_allclose(y.numpy(), np.asarray(jwant), atol=ATOL)


def _source(rng, kind, m, k):
    """A (M, K) float32 from each source of the quantize pass: LayerNorm
    of a token matrix (unrounded, or rounded to bf16 first as K5 does), a
    float32 matrix (K4's h) or a bf16 matrix (the attention output)."""
    if kind.startswith("ln"):
        x = _mat(rng, m, k, scale=2.0).to(torch.bfloat16)
        normed = k4.layer_norm_float32(x, *_ln_params(rng, k))
        return normed.to(torch.bfloat16).float() if kind == "ln_round" \
            else normed
    if kind == "f32":
        return k4.gelu_as(_mat(rng, m, k, scale=3.0))
    return _mat(rng, m, k).to(torch.bfloat16).float()


@pytest.mark.parametrize("source", ["ln", "ln_round", "f32", "t"])
@pytest.mark.parametrize("form", ["blocks", "windows"])
def test_quantize_pass_and_int8_gemm_equal_q8_dot(rng, source, form):
    """Codes from each row's block absmax (the ScaleMap's block), then the
    exact int32 product and the dequant, equal q8_dot over the blocks and
    the JAX q8_dot, bit for bit."""
    k, n = 64, 48
    w = k4.q8_weight(_mat(rng, k, n, scale=0.2))
    if form == "blocks":
        m, blk = 96, 32
        ids = sg.scale_blocks(m, blk=blk)
        a = _source(rng, source, m, k)
        blocks = a.reshape(-1, blk, k)
    else:
        b, hp, wp, win = 2, 8, 12, 4
        m = b * hp * wp
        ids = sg.scale_blocks(m, hp=hp, wp=wp, window=win)
        a = _source(rng, source, m, k)
        blocks = k3.window_partition(a.reshape(b, hp, wp, k), win)
    amax = torch.zeros(int(ids.max()) + 1).scatter_reduce(
        0, ids, a.abs().amax(-1), "amax")[ids][:, None]
    codes = sg.quantize_codes_reference(a, amax)
    got = sg.q8_gemm_reference(codes, amax, w)
    per_block = k4.q8_dot(blocks, w)
    want = per_block.reshape(m, n) if form == "blocks" else \
        k3.window_reverse(per_block, win, hp, wp).reshape(m, n)
    assert torch.equal(got, want)
    wq, ws = jnp.asarray(w.codes.t().numpy()), jnp.asarray(w.scale.numpy())
    jwant = np.stack([np.asarray(jax_mlp.q8_dot(jnp.asarray(one.numpy()),
                                                wq, ws)) for one in blocks])
    np.testing.assert_array_equal(per_block.numpy(), jwant)


def test_scale_blocks_number_windows_as_the_attention_phase():
    """Window ids row-major per image: the order of window_partition."""
    b, hp, wp, win = 2, 8, 12, 4
    ids = sg.scale_blocks(b * hp * wp, hp=hp, wp=wp, window=win)
    parts = k3.window_partition(ids.reshape(b, hp, wp, 1), win)
    assert torch.equal(parts[..., 0],
                       torch.arange(parts.shape[0])[:, None].expand(
                           -1, win * win))


# ---- the path rule -------------------------------------------------------


def _swin_products(name, img, batch, quant=False, train=False,
                   quant_min_dim=768):
    """(what, M, K, N, kind) of every kernel product of one Swin forward,
    each block's plan from ``SwinBlock.plan`` (the model's own gate)."""
    cfg, out = VARIANTS[name], []
    side = img // 4
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        dim, hw = cfg["embed_dim"] * 2 ** i, side // 2 ** i
        block = SimpleNamespace(window=cfg["window_size"], dim=dim,
                                training=train, fused_train=train,
                                fused_eval=None, use_fused_attn=False,
                                fused_split=False)
        plan = SwinBlock.plan(block, hw, hw)
        kind = "int8" if quant and dim >= quant_min_dim and not train \
            else "bfloat16"
        m = batch * hw * hw
        attn = [("qkv", dim, 3 * dim), ("proj", dim, dim)]
        mlp = [("fc1", dim, 4 * dim), ("fc2", 4 * dim, dim)]
        prods = {"merged": attn + mlp, "split": attn + mlp, "mlp": mlp,
                 "fused_train": attn + mlp, "plain": []}[plan]
        out += [(f"stage {i} {plan} {p}", m, kk, nn, kind)
                for p, kk, nn in prods for _ in range(depth)]
    return out


TEACHER = _swin_products("swin_L_384_22k", 384, 16)
TEACHER_Q8 = _swin_products("swin_L_384_22k", 384, 16, quant=True)
TRAIN = _swin_products("swin_L_384_22k", 384, 8, train=True)


def test_products_cover_the_kernels_of_each_path():
    """As chip_smoke.py counts launches: bf16 teacher K5 4, K3 18, K4 20;
    int8 teacher the same with stages 2-3 in int8; training K6 22 + 22
    (each with its products)."""
    assert len(TEACHER) == 4 * 4 + 18 * 4 + 2 * 2 == len(TEACHER_Q8)
    assert sum(p[-1] == "int8" for p in TEACHER_Q8) == 18 * 4 + 2 * 2
    assert len(TRAIN) == 22 * 4


@pytest.mark.parametrize("what, m, k, n, kind",
                         sorted(set(TEACHER + TEACHER_Q8 + TRAIN)))
def test_swin_l_products_take_wgmma(what, m, k, n, kind):
    assert sg.gemm_path(kind, k, n) == "wgmma"
    assert n % sg.tile_n(n) == 0 and sg.tile_n(n) in (128, 192)


@pytest.mark.parametrize("name, m, k, n, blk", p1.SHAPES)
def test_p1_shapes_take_wgmma(name, m, k, n, blk):
    assert sg.gemm_path("bfloat16", k, n) == "wgmma"
    assert sg.gemm_path("int8", k, n) == "wgmma"
    assert sg.gemm_path("int8w", k, n) == "wgmma"  # widened in the B stage


@pytest.mark.parametrize("k, n", [(192, 576), (64, 64), (40, 128)])
def test_float32_takes_the_fma_loop(k, n):
    assert sg.gemm_path("float32", k, n) == "fma"


@pytest.mark.parametrize("kind, k, n", [("bfloat16", 36, 128),
                                        ("bfloat16", 64, 48),
                                        ("int8", 24, 128),
                                        ("int8", 128, 48),
                                        ("int8w", 36, 128),
                                        ("int8w", 64, 96)])
def test_what_wgmma_cannot_take_goes_to_the_loop(kind, k, n):
    assert sg.gemm_path(kind, k, n) == "loop"


# ---- int8w: where the widening warps put the codes ----------------------


def _stage(bn):
    k = torch.arange(sg.STAGE_K).view(-1, 1).expand(-1, bn)
    n = torch.arange(bn).view(1, -1).expand(sg.STAGE_K, -1)
    return k, n


@pytest.mark.parametrize("bn", [64, 128, 192])
def test_widened_codes_fill_the_stage_once(bn):
    """Every code of a raw slot lands on its own bf16 of the B stage, and
    together they fill it: BN / 64 boxes of 64 rows of 128 bytes."""
    k, n = _stage(bn)
    dst = sg.widened_offset(sg.raw_offset(k, n)).flatten()
    assert bool((dst % 2 == 0).all())
    assert torch.equal(dst.sort().values,
                       torch.arange(0, bn // 64 * sg.B_BOX, 2))


@pytest.mark.parametrize("bn", [64, 128, 192])
def test_widened_codes_land_where_tma_puts_a_bf16_weight(bn):
    """The widened stage is the one Bf16Op's TMA box writes for a bf16 (K,
    N) weight, which smem_desc_sw128_mn reads: box n // 64 of 64 K rows of
    128 bytes, with the 128-byte swizzle applied to the address (bits 4-6
    XOR bits 7-9)."""
    k, n = _stage(bn)
    linear = (n // 64) * sg.B_BOX + k * sg.ROW_BYTES + 2 * (n % 64)
    swizzled = linear ^ (((linear >> 7) & 7) << 4)
    assert torch.equal(sg.widened_offset(sg.raw_offset(k, n)), swizzled)


@pytest.mark.parametrize("bn", [64, 128, 192])
def test_widening_covers_the_raw_slot_without_bank_conflicts(bn):
    """The 224 widening threads take each 16-byte chunk of the raw slot once;
    each quarter-warp (eight threads, one 16-byte access each) reads 128
    contiguous bytes and, in each of its two stores, writes eight chunks
    that fall on distinct banks (the chunk's place within its 128 bytes)."""
    chunks = [c for t in range(sg.WIDEN_THREADS)
              for c in sg.widen_chunks(bn, t)]
    assert sorted(chunks) == list(range(bn // 64 * sg.RAW_BOX // 16))
    for i in range(len(sg.widen_chunks(bn, 0))):
        for warp in range(sg.WIDEN_THREADS // 32):
            for quarter in range(4):
                threads = range(32 * warp + 8 * quarter,
                                32 * warp + 8 * quarter + 8)
                cs = [sg.widen_chunks(bn, t)[i] for t in threads
                      if i < len(sg.widen_chunks(bn, t))]
                if not cs:
                    continue
                assert cs == list(range(cs[0], cs[0] + len(cs)))
                assert cs[0] % 8 == 0  # 128 contiguous, aligned bytes
                for half in (0, 8):  # the codes of each store
                    dst = [int(sg.widened_offset(torch.tensor(16 * c + half)))
                           for c in cs]
                    assert len({d // 16 % 8 for d in dst}) == len(cs)


def test_tile_n_rule():
    assert [sg.tile_n(n) for n in (64, 128, 192, 576, 768, 1024, 320)] == [
        64, 128, 192, 192, 128, 128, 64]
    with pytest.raises(ValueError, match="unknown operand kind"):
        sg.gemm_path("fp8", 64, 64)


# ---- dispatch ------------------------------------------------------------


class _Recorder:
    """Stands in for a library's C entry points: records each call's
    arguments (tensors as they are) and returns 0 (success)."""

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
    for mod in (k3, k4, k5):
        lib = mod.__name__.rsplit(".", 1)[1]
        monkeypatch.setattr(mod, "_launch_fn", lambda loop=False, lib=lib:
                            getattr(rec, lib + "_loop" * loop))
        monkeypatch.setattr(mod, "_launch_q8_fn", lambda loop=False, lib=lib:
                            getattr(rec, lib + "_q8" + "_loop" * loop))
    monkeypatch.setattr(p1, "_lib", lambda: rec)
    # CPU tensors stand in for CUDA ones: the device checks pass and each
    # entry point gets the tensors themselves
    for mod in (k4, p1):
        monkeypatch.setattr(mod, "on_card", lambda what, x: None)
    monkeypatch.setattr(k4, "run_entry", lambda fn, device, *args: fn(*args))

    def no_plain(*args, **kwargs):
        raise AssertionError("a plain version ran in a kernel's place")
    for mod, names in ((k3, ("window_mhsa_reference",
                             "window_mhsa_q8_reference")),
                       (k4, ("mlp_block_reference", "mlp_q8_reference")),
                       (k5, ("swin_block_reference",)),
                       (p1, ("gemm_bf16_reference", "gemm_int8w_reference",
                             "gemm_int8_reference"))):
        for name in names:
            monkeypatch.setattr(mod, name, no_plain)
    monkeypatch.setattr(sg, "launches", {
        lib: dict.fromkeys(sg.PATHS, 0) for lib in sg.LIBRARIES})
    for fn in (k3.window_mhsa_cuda, k3.window_mhsa_loop_cuda,
               k3.window_mhsa_q8_cuda, k3.window_mhsa_q8_loop_cuda,
               k4.mlp_block_cuda, k4.mlp_block_loop_cuda,
               k4.mlp_block_q8_cuda, k4.mlp_block_q8_loop_cuda,
               k5.swin_block_cuda, k5.swin_block_loop_cuda,
               k5.swin_block_q8_cuda, k5.swin_block_q8_loop_cuda,
               p1.gemm_bf16_cuda, p1.gemm_bf16_loop_cuda,
               p1.gemm_int8w_cuda, p1.gemm_int8w_loop_cuda,
               p1.gemm_int8_cuda, p1.gemm_int8_loop_cuda):
        monkeypatch.setattr(fn, "launches", 0)
    return rec


def _shapes(args):
    return [(tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a
            for a in args]


def _swin_operands(rng, lead, c, hidden, heads, w, dtype):
    x = _mat(rng, *lead, c).to(dtype)
    n = w * w
    attn = [*_ln_params(rng, c), _mat(rng, c, 3 * c).to(dtype),
            _mat(rng, 3 * c).to(dtype), _mat(rng, c, c).to(dtype),
            _mat(rng, c).to(dtype), _mat(rng, heads, n, n).to(dtype)]
    mlp = [*_ln_params(rng, c), _mat(rng, c, hidden).to(dtype),
           _mat(rng, hidden).to(dtype), _mat(rng, hidden, c).to(dtype),
           _mat(rng, c).to(dtype)]
    return x, attn, mlp


def _q8(part):
    part = list(part)
    part[2], part[4] = k4.q8_weight(part[2]), k4.q8_weight(part[4])
    return part


@pytest.mark.parametrize("dtype, loop, path", [
    (torch.bfloat16, False, "wgmma"), (torch.bfloat16, True, "loop"),
    (torch.float32, False, "fma"), (torch.float32, True, "fma")])
def test_k3_k4_k5_dispatch(recorded, rng, dtype, loop, path):
    """The float entry points: K3 and K4 (and their _loop twins), K5; the
    scratch each gets and the products counted on their path."""
    b, hw, c, heads, w, hidden = 2, 8, 64, 2, 4, 256
    m = b * hw * hw
    x, attn, mlp = _swin_operands(rng, (b, hw, hw), c, hidden, heads, w,
                                  dtype)
    kw = dict(window=w, num_heads=heads)
    if loop:
        k3.window_mhsa_loop_cuda(x, *attn, None, **kw)
        k4.mlp_block_loop_cuda(x, *mlp, res_add=False)
        k5.swin_block_loop_cuda(x, *attn, None, *mlp, **kw)
    else:
        k3.window_mhsa_cuda(x, *attn, None, **kw)
        k4.mlp_block_cuda(x, *mlp, res_add=False)
        k5.swin_block_cuda(x, *attn, None, *mlp, **kw)
    tail = "_loop" if loop else ""
    assert [name for name, _ in recorded.calls] == [
        f"window_mhsa{tail}", f"mlp_block{tail}", f"swin_block{tail}"]
    a3, a4, a5 = (_shapes(args) for _, args in recorded.calls)
    f32 = torch.float32
    # K3: qkv, attn (LN(x) first in bf16), stats; res_add 1
    assert a3[9:12] == [((m, 3 * c), dtype), ((m, c), dtype), ((m, 2), f32)]
    assert a3[13:] == [b, hw, hw, c, heads, w, 32 ** -0.5, 1,
                       k4.DTYPE_CODES[dtype]]
    # K4: h, stats, normed (bf16 only), y; res_add 0
    normed = ((m, c), dtype) if dtype == torch.bfloat16 else None
    assert a4[7:11] == [((m, hidden), dtype), ((m, 2), f32), normed,
                        ((b, hw, hw, c), dtype)]
    assert a4[11:] == [m, c, hidden, 0, k4.DTYPE_CODES[dtype]]
    # K5: qkv, attn, ybuf, h, stats (attn holds both LayerNorms)
    assert a5[15:20] == [((m, 3 * c), dtype), ((m, c), dtype),
                         ((m, c), dtype), ((m, hidden), dtype),
                         ((m, 2), f32)]
    want = dict.fromkeys(sg.PATHS, 0)
    assert sg.launches["window_mhsa"] == dict(want, **{path: 2})
    assert sg.launches["mlp_block"] == dict(want, **{path: 2})
    assert sg.launches["swin_block"] == dict(want, **{path: 4})
    assert k3.window_mhsa_loop_cuda.launches == int(loop)
    assert k3.window_mhsa_cuda.launches == int(not loop)


@pytest.mark.parametrize("loop", [False, True])
def test_q8_dispatch(recorded, rng, loop):
    """The int8 entry points get an int8 codes scratch of (M, C) (K3) or
    (M, max(C, hidden)) (K4, K5) and count their products as int8."""
    b, hw, c, heads, w, hidden = 2, 8, 64, 2, 4, 256
    m = b * hw * hw
    x, attn, mlp = _swin_operands(rng, (b, hw, hw), c, hidden, heads, w,
                                  torch.bfloat16)
    qa, qm = _q8(attn), _q8(mlp)
    kw = dict(window=w, num_heads=heads)
    fns = ((k3.window_mhsa_q8_loop_cuda, k4.mlp_block_q8_loop_cuda,
            k5.swin_block_q8_loop_cuda) if loop else
           (k3.window_mhsa_q8_cuda, k4.mlp_block_q8_cuda,
            k5.swin_block_q8_cuda))
    fns[0](x, *qa, None, **kw)
    fns[1](x, *qm)
    fns[2](x, *qa, None, *qm, **kw)
    tail = "_loop" if loop else ""
    assert [name for name, _ in recorded.calls] == [
        f"window_mhsa_q8{tail}", f"mlp_block_q8{tail}",
        f"swin_block_q8{tail}"]
    a3, a4, a5 = (_shapes(args) for _, args in recorded.calls)
    i8 = torch.int8
    strips = b * (hw // w)
    assert a3[14:16] == [((strips * (1 + hw // w),), torch.int32),
                         ((m, c), i8)]
    blk = k4.token_block(m)
    assert a4[9:13] == [((m, hidden), torch.float32), ((m, 2), torch.float32),
                        ((2 * (m // blk),), torch.int32), ((m, hidden), i8)]
    assert a5[24:26] == [((strips * (3 + hw // w),), torch.int32),
                         ((m, hidden), i8)]
    path = "loop" if loop else "wgmma"
    assert sg.launches["window_mhsa"][path] == 2
    assert sg.launches["mlp_block"][path] == 2
    assert sg.launches["swin_block"][path] == 4
    assert sum(sum(v.values()) for v in sg.launches.values()) == 8


def test_p1_dispatch(recorded, rng):
    """P1: bf16, int8w and int8 on wgmma (int8 with an (M, K) codes
    scratch), and the _loop twins."""
    m, k, n, blk = 96, 64, 128, 32
    x = _mat(rng, m, k).to(torch.bfloat16)
    wgt = _mat(rng, k, n).to(torch.bfloat16)
    wq = torch.zeros(k, n, dtype=torch.int8)
    s = torch.ones(1, n)
    w8 = k4.Q8Weight(wq.t().contiguous(), s)
    for fn in (p1.gemm_bf16_cuda, p1.gemm_bf16_loop_cuda):
        assert tuple(fn(x, wgt).shape) == (m, n)
    for fn in (p1.gemm_int8w_cuda, p1.gemm_int8w_loop_cuda):
        assert tuple(fn(x, wq, s).shape) == (m, n)
    for fn in (p1.gemm_int8_cuda, p1.gemm_int8_loop_cuda):
        assert tuple(fn(x, w8, blk).shape) == (m, n)
    assert [name for name, _ in recorded.calls] == [
        "probe_gemm_bf16_launch", "probe_gemm_bf16_loop_launch",
        "probe_gemm_int8w_launch", "probe_gemm_int8w_loop_launch",
        "probe_gemm_int8_launch", "probe_gemm_int8_loop_launch"]
    for _, call in recorded.calls[2:4]:
        assert _shapes(call) == [((m, k), torch.bfloat16),
                                 ((k, n), torch.int8),
                                 ((1, n), torch.float32),
                                 ((m, n), torch.bfloat16), m, n, k]
    args = _shapes(recorded.calls[4][1])
    assert args[3:6] == [((m // blk,), torch.int32), ((m, k), torch.int8),
                         ((m, n), torch.bfloat16)]
    assert args[6:] == [m, n, k, blk]
    assert sg.launches["int8_kernel_probe"] == {"wgmma": 3, "loop": 3,
                                                "fma": 0}


def test_p1_int8w_launches_once_a_call(recorded, rng):
    """Each int8w call is one launch of the C entry point (no separate widen
    pass), counted once by its wrapper and once on the wgmma path."""
    m, k, n = 200, 160, 192
    x = _mat(rng, m, k).to(torch.bfloat16)
    wq = torch.ones(k, n, dtype=torch.int8)
    s = _mat(rng, 1, n)
    for _ in range(3):
        p1.gemm_int8w_cuda(x, wq, s)
    assert [name for name, _ in recorded.calls] == [
        "probe_gemm_int8w_launch"] * 3
    assert p1.gemm_int8w_cuda.launches == 3
    assert p1.gemm_int8w_loop_cuda.launches == 0
    assert sg.launches["int8_kernel_probe"] == {"wgmma": 3, "loop": 0,
                                                "fma": 0}


# ---- every Swin width: C % 32 == 0 on the float paths --------------------

SWIN_T = _swin_products("swin_T_224_1k", 224, 16)
SWIN_T_TRAIN = _swin_products("swin_T_224_1k", 224, 8, train=True)
NANO = _swin_products("swin_nano_64", 64, 2)


@pytest.mark.parametrize("what, m, k, n, kind",
                         sorted(set(SWIN_T + SWIN_T_TRAIN + NANO)))
def test_swin_t_and_nano_products_take_wgmma(what, m, k, n, kind):
    """Swin-T's stage 0 (QKV N 288, proj and fc2 N 96, K 96) and the nano's
    (N 96 and 32, K 32) take the wgmma core on the new N tiles."""
    assert sg.gemm_path(kind, k, n) == "wgmma"
    assert n % sg.tile_n(n) == 0


@pytest.mark.parametrize("n, tile", [(32, 32), (96, 96), (288, 96),
                                     (160, 32), (384, 128), (576, 192)])
def test_narrow_n_tiles(n, tile):
    assert sg.gemm_path("bfloat16", 96, n) == "wgmma"
    assert sg.tile_n(n) == tile


@pytest.mark.parametrize("kind, k, n", [("int8", 96, 96), ("int8w", 96, 96),
                                        ("int8", 96, 288)])
def test_int8_products_keep_n_multiple_of_64(kind, k, n):
    assert sg.gemm_path(kind, k, n) == "loop"


def test_tile_n_refuses_n_off_32():
    with pytest.raises(ValueError, match="N % 32"):
        sg.tile_n(48)


@pytest.mark.parametrize("c, heads, w, hw", [(96, 3, 7, 14), (32, 1, 4, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_k4_k5_k6_take_every_swin_width(recorded, rng, c, heads, w, hw,
                                           dtype):
    """Swin-T's stage 0 (C 96, window 7) and the nano's (C 32, window 4)
    reach the C entry points of K3, K4, K5 and K6's two branches, each
    product on its path: wgmma in bf16, the FMA loop in float32."""
    from computervision_codes_tpu_torch.ops import swin_train as k6

    hidden, b = 4 * c, 2
    x, attn, mlp = _swin_operands(rng, (b, hw, hw), c, hidden, heads, w,
                                  dtype)
    kw = dict(window=w, num_heads=heads)
    k3.window_mhsa_cuda(x, *attn, None, **kw)
    k4.mlp_block_cuda(x, *mlp)
    k5.swin_block_cuda(x, *attn, None, *mlp, **kw)
    k6.window_mhsa_branch_cuda(x, *attn, None, **kw)
    k6.mlp_block_branch_cuda(x, *mlp)
    assert [name for name, _ in recorded.calls] == [
        "window_mhsa", "mlp_block", "swin_block", "window_mhsa",
        "mlp_block"]
    path = "wgmma" if dtype == torch.bfloat16 else "fma"
    want = dict.fromkeys(sg.PATHS, 0)
    assert sg.launches["window_mhsa"] == dict(want, **{path: 4})
    assert sg.launches["mlp_block"] == dict(want, **{path: 4})
    assert sg.launches["swin_block"] == dict(want, **{path: 4})
    a3 = _shapes(recorded.calls[0][1])
    assert a3[13:19] == [b, hw, hw, c, heads, w]


def test_other_widths_and_the_int8_branch_still_raise(recorded, rng):
    """C or hidden off 32 raises ValueError naming the shape, before any
    C entry point; the int8 branch keeps C and hidden % 64."""
    x, attn, mlp = _swin_operands(rng, (2, 8, 8), 48, 192, 2, 4,
                                  torch.bfloat16)
    with pytest.raises(ValueError, match="C=48"):
        k4.mlp_block_cuda(x, *mlp)
    with pytest.raises(ValueError, match="head_dim 32"):
        k3.window_mhsa_cuda(x, *attn, None, window=4, num_heads=2)
    x, attn, mlp = _swin_operands(rng, (2, 8, 8), 64, 208, 2, 4,
                                  torch.bfloat16)
    with pytest.raises(ValueError, match="hidden"):
        k5.swin_block_cuda(x, *attn, None, *mlp, window=4, num_heads=2)
    x, attn, mlp = _swin_operands(rng, (2, 14, 14), 96, 384, 3, 7,
                                  torch.bfloat16)
    with pytest.raises(ValueError, match="C % 64"):
        k3.window_mhsa_q8_cuda(x, *_q8(attn), None, window=7, num_heads=3)
    with pytest.raises(ValueError, match="% 64"):
        k4.mlp_block_q8_cuda(x, *_q8(mlp))
    assert recorded.calls == []
