"""The port's Swin backbone against the JAX package's.

JAX variables are carried into the port with ``load_jax_variables``; the
same seeded numpy frames go through both. In float32 the port's kernel path
(``fused_eval=None``: K3/K4/K5's plain versions on the CPU) and its module
path (``fused_eval=False``) are held to the JAX XLA path, and the kernel
path also to the JAX fused path (Pallas interpreted), at atol 5e-5 as
tests/test_ops_kernels.py:385 holds the JAX fused path to its XLA path, and
``use_fused_attn`` (K10's plain version inside the plain attention half) to
JAX's ``use_fused_attn`` at the same bound. In bf16 the two packages round
at different points (the port where the TPU kernels round, the JAX XLA
path after every op): the bound is 4% of the largest magnitude, with
correlation > 0.999.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.models.swin import (
    SwinTransformer as JaxSwin,
    VARIANTS as JAX_VARIANTS,
)
from computervision_codes_tpu_torch.models.convert import load_jax_variables
from computervision_codes_tpu_torch.models.swin import (
    SwinTransformer,
    VARIANTS,
    build_swin,
    swin_feature_dim,
)
from computervision_codes_tpu_torch.train import make_spatial_train_step

ATOL = 5e-5
BF16_REL, BF16_CORR = 0.04, 0.999
# a window-7 Swin at nano scale (the 224-class geometry): odd windows take
# the split K3 + K4 path (test_ops_kernels.py:572)
WIN7 = dict(embed_dim=32, depths=(2, 2), num_heads=(2, 4), window_size=7)


_JAX = {}  # the module's JAX inits and forwards, each computed once


def _jax_forward(cfg, frames, dtype=jnp.float32, fused_eval=False):
    """The JAX variables (its init at ``frames``' shape) and the JAX
    forward of ``frames``; the tests that ask for the same ones share
    them."""
    arch = tuple(sorted(cfg.items()))
    init_key = (arch, frames.shape)
    if init_key not in _JAX:
        _JAX[init_key] = jax.jit(JaxSwin(fused_eval=False, **cfg).init)(
            jax.random.PRNGKey(1), jnp.asarray(frames))
    variables = _JAX[init_key]
    key = (arch, frames.tobytes(), str(dtype), fused_eval)
    if key not in _JAX:
        model = JaxSwin(fused_eval=fused_eval, dtype=dtype, **cfg)
        _JAX[key] = jax.jit(model.apply)(variables,
                                         jnp.asarray(frames, dtype))
    return variables, _JAX[key]


def _port(cfg, variables, dtype=torch.float32, fused_eval=None):
    model = SwinTransformer(fused_eval=fused_eval, dtype=dtype, **cfg)
    return load_jax_variables(model, variables).eval()


def test_variants_match_jax():
    assert VARIANTS == JAX_VARIANTS
    assert swin_feature_dim("swin_L_384_22k") == 1536
    assert build_swin("swin_nano_64").num_features == 256


@pytest.mark.parametrize("fused_eval", [None, False],
                         ids=["kernel-path", "module-path"])
def test_nano_float32_matches_jax(rng, fused_eval):
    frames = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    variables, want = _jax_forward(JAX_VARIANTS["swin_nano_64"], frames)
    model = _port(VARIANTS["swin_nano_64"], variables, fused_eval=fused_eval)
    # the kernel path runs K5 at stages 0-2 and K4 after the plain
    # attention half at stage 3 (its 2x2 map is padded to the window)
    plans = [model.stage0_block0.plan(16, 16), model.stage3_block0.plan(2, 2)]
    assert plans == (["merged", "mlp"] if fused_eval is None
                     else ["plain", "plain"])
    with torch.no_grad():
        got = model(torch.from_numpy(frames))
    for k in ("feature_map", "pooled"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, err_msg=k)


def test_nano_kernel_path_matches_jax_fused(rng):
    """Against the JAX fused eval path, the Pallas kernels interpreted."""
    frames = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    variables, _ = _jax_forward(JAX_VARIANTS["swin_nano_64"], frames)
    _, want = _jax_forward(JAX_VARIANTS["swin_nano_64"], frames,
                           fused_eval=True)
    with torch.no_grad():
        got = _port(VARIANTS["swin_nano_64"], variables)(
            torch.from_numpy(frames))
    np.testing.assert_allclose(got["pooled"].numpy(),
                               np.asarray(want["pooled"]), atol=ATOL)


def test_window7_split_path_matches_jax(rng):
    frames = rng.standard_normal((1, 56, 56, 3)).astype(np.float32)
    variables, want = _jax_forward(WIN7, frames)
    model = _port(WIN7, variables)
    assert model.stage0_block1.plan(14, 14) == "split"
    with torch.no_grad():
        got = model(torch.from_numpy(frames))
    np.testing.assert_allclose(got["pooled"].numpy(),
                               np.asarray(want["pooled"]), atol=ATOL)


def test_nano_bf16_matches_jax(rng):
    frames = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    variables, want = _jax_forward(JAX_VARIANTS["swin_nano_64"], frames,
                                   dtype=jnp.bfloat16)
    model = _port(VARIANTS["swin_nano_64"], variables, dtype=torch.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(frames).bfloat16())
    for k in ("feature_map", "pooled"):
        g = got[k].float().numpy().ravel()
        w = np.asarray(want[k], np.float32).ravel()
        assert got[k].dtype == torch.bfloat16
        assert np.abs(g - w).max() <= BF16_REL * np.abs(w).max(), k
        assert np.corrcoef(g, w)[0, 1] > BF16_CORR, k


def test_loader_rejects_missing_and_extra_keys(rng):
    frames = np.zeros((1, 64, 64, 3), np.float32)
    variables, _ = _jax_forward(JAX_VARIANTS["swin_nano_64"], frames)
    params = jax.tree.map(np.asarray, variables["params"])
    del params["stage0_block0"]["attn"]["relative_position_bias_table"]
    with pytest.raises(KeyError, match="relative_position_bias_table"):
        load_jax_variables(build_swin("swin_nano_64"), {"params": params})
    params = jax.tree.map(np.asarray, variables["params"])
    params["merge0"]["reduction"]["bias"] = np.zeros(64, np.float32)
    with pytest.raises(KeyError, match="merge0/reduction/bias"):
        load_jax_variables(build_swin("swin_nano_64"), {"params": params})
    params = jax.tree.map(np.asarray, variables["params"])
    params["patch_embed"]["bias"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="patch_embed"):
        load_jax_variables(build_swin("swin_nano_64"), {"params": params})


@pytest.mark.parametrize("cfg,hw", [(JAX_VARIANTS["swin_nano_64"], 64),
                                    (WIN7, 56)],
                         ids=["nano", "window7-shifted"])
def test_fused_attn_matches_jax(rng, cfg, hw):
    """``use_fused_attn`` against JAX's: every block takes the plain plan
    (K10 as its attention core on the card, no K3, K4 or K5), whatever
    ``fused_eval`` says; the window-7 model has a shifted block (a mask of
    4 windows) and 49-token windows."""
    frames = rng.standard_normal((2, hw, hw, 3)).astype(np.float32)
    variables, _ = _jax_forward(cfg, frames)
    want = jax.jit(JaxSwin(fused_eval=False, use_fused_attn=True,
                           **cfg).apply)(variables, jnp.asarray(frames))
    model = load_jax_variables(SwinTransformer(use_fused_attn=True, **cfg),
                               variables).eval()
    with torch.no_grad():
        x = model.embed(torch.from_numpy(frames))
        for si, depth in enumerate(model.depths):
            for d in range(depth):
                block = getattr(model, f"stage{si}_block{d}")
                assert block.plan(x.shape[1], x.shape[2]) == "plain", (si, d)
                assert block.attn.use_fused_kernel
            x = model.stage(si, x)
        got = model(torch.from_numpy(frames))
    for k in ("feature_map", "pooled"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("kwargs, metric", [
    (dict(loss_type="all", rates=(1.0, 0.0, 0.1)), "kd_loss"),
    (dict(loss_type="all", rates=(1.0, 0.5, 0.0)), "soft_loss"),
    (dict(loss_type="i", sam_rho=0.05), "hard_loss_i"),
    (dict(loss_type="i", qat=True), "hard_loss_i")],
    ids=["all-kd-rate", "all-soft-rate", "sam", "qat"])
def test_unported_options_raise(rng, kwargs, metric):
    """The options the teacher's training step refused before the
    student-training slice (the distillation rates, SAM, QAT) now make a
    step that runs on the Swin teacher with ``fused_train`` and ``remat``:
    one step on seeded frames and teacher arrays gives a finite loss with
    the option's metric (the parity with JAX is
    tests/test_torch_cli_spatial_transformer.py and
    tests/test_torch_spatial_train.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny ops: one thread under parallel workers
    try:
        _run_option(rng, kwargs, metric)
    finally:
        torch.set_num_threads(threads)


def _run_option(rng, kwargs, metric):
    from computervision_codes_tpu_torch.models.q2l import Q2L, TASK_SIZES
    from computervision_codes_tpu_torch.train import (build_sgd,
                                                      create_train_state)

    model = Q2L("swin_nano_64", loss_type=kwargs["loss_type"],
                teacher_dim=16, fused_train=True, remat=True,
                generator=torch.Generator().manual_seed(0))
    assert model.backbone.remat and model.backbone.stage0_block0.fused_train
    batch = {"image": rng.standard_normal((1, 64, 64, 3)).astype(np.float32)}
    for k, n in TASK_SIZES.items():
        batch[f"label_{k}"] = (rng.random((1, n)) < 0.3).astype(np.float32)
        if k != "ivt":
            batch[f"teacher_pred_{k}"] = rng.standard_normal(
                (1, n)).astype(np.float32)
            batch[f"teacher_feat_{k}"] = rng.standard_normal(
                (1, 16)).astype(np.float32)
    state = create_train_state(model, build_sgd(1e-2), device="cpu")
    step = make_spatial_train_step(model, device="cpu", **kwargs)
    state, metrics = step(state, batch)
    assert state.step == 1 and metric in metrics
    assert np.isfinite(metrics["loss"].item())
