"""The port's Swin training forward (K6, DropPath, remat) against the JAX
package's.

* K3's and K4's plain versions at ``res_add=False`` against the JAX
  references at ``res_add=False``: float32 at atol 2e-5 (the JAX kernel
  tests' bound: sums of at most 128 products in another order); bf16 within
  8 bf16 ulps of the largest magnitude (the JAX reference rounds after
  every op, the port where the kernels round).
* Each K6 ``Function``'s gradients, for every argument but the mask,
  against ``jax.vjp`` of the JAX reference, float32, atol 2e-5.
* ``SwinTransformer(fused_train=True, remat=True)`` in ``.train()`` at
  ``drop_path_rate=0`` against JAX ``jax.value_and_grad`` of
  ``SwinTransformer(fused_train=False)`` with ``train=True``: the loss and
  every gradient by its flax path at atol 5e-5, the bound with which JAX's
  own test holds its fused path to its XLA path
  (tests/test_ops_kernels.py:494).
* remat "dots", "" and off give the same gradients, and the replay runs
  each K6 branch's forward again.
* DropPath and Dropout: per-sample (per-element) masks, the 1 / keep scale,
  the generator makes them repeatable.
* The repair: in ``.train()`` no block takes the eval kernels' plans
  ("merged", "split"), and DropPath runs after both branches of every block.

The JAX side runs jitted; no Pallas kernel is interpreted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.models.swin import (
    SwinTransformer as JaxSwin,
    VARIANTS as JAX_VARIANTS,
    _shift_attn_mask,
)
from computervision_codes_tpu.ops.mlp_block import (
    mlp_block_reference as jax_mlp_reference,
)
from computervision_codes_tpu.ops.window_mhsa import (
    window_mhsa_reference as jax_attn_reference,
)
from computervision_codes_tpu_torch.models import common
from computervision_codes_tpu_torch.models.common import DropPath, Dropout
from computervision_codes_tpu_torch.models.convert import load_jax_variables
from computervision_codes_tpu_torch.models.swin import SwinTransformer
from computervision_codes_tpu_torch.ops import swin_train
from computervision_codes_tpu_torch.ops.mlp_block import mlp_block_fused
from computervision_codes_tpu_torch.ops.window_mhsa import window_mhsa_fused

ATOL = 2e-5
MODEL_ATOL = 5e-5
BF16_ULPS = 8
NANO = dict(JAX_VARIANTS["swin_nano_64"])
ATTN_NAMES = ("x", "gamma", "beta", "wqkv", "bqkv", "wproj", "bproj", "bias")
MLP_NAMES = ("x", "gamma", "beta", "w1", "b1", "w2", "b2")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _attn_arrays(rng, b=2, hw=8, c=64, heads=2, w=4):
    f = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    return [rng.standard_normal((b, hw, hw, c)).astype(np.float32),
            f(c) + 1, f(c), f(c, 3 * c), f(3 * c), f(c, c), f(c),
            f(heads, w * w, w * w)]


def _mlp_arrays(rng, m=32, c=64):
    f = lambda s, *shape: (rng.standard_normal(shape) * s).astype(np.float32)
    return [rng.standard_normal((m, c)).astype(np.float32), f(0.1, c) + 1,
            f(0.1, c), f(0.2, c, 4 * c), f(0.01, 4 * c), f(0.1, 4 * c, c),
            f(0.01, c)]


def _bf16_bound(want):
    top = float(np.abs(want).max())
    return BF16_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [0, 2])
def test_branches_res_add_false_match_jax(rng, dtype, shift):
    hw, w, heads = 8, 4, 2
    mask = _shift_attn_mask(hw, hw, w, shift) if shift else None
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    attn, mlp = _attn_arrays(rng), _mlp_arrays(rng)
    for fused, ref, arrays, kw in (
            (window_mhsa_fused, jax_attn_reference, attn + [mask],
             dict(window=w, num_heads=heads)),
            (mlp_block_fused, jax_mlp_reference, mlp, {})):
        # x, the weights and biases in the compute dtype; LayerNorm vectors
        # and the mask as the modules pass them (float32, cast inside)
        jargs = [None if a is None else jnp.asarray(a, jdt if i not in (
            1, 2) else jnp.float32) for i, a in enumerate(arrays)]
        want = np.asarray(jax.jit(lambda *a: ref(*a, **kw, res_add=False))(
            *jargs), np.float32)
        targs = [None if a is None else torch.from_numpy(a).to(
            tdt if i not in (1, 2) else torch.float32)
            for i, a in enumerate(arrays)]
        got = fused(*targs, **kw, res_add=False)
        assert got.dtype == tdt and got.shape == arrays[0].shape
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=ATOL)
        else:
            assert np.abs(got - want).max() <= _bf16_bound(want)
        # and the residual form is the branch plus x, rounded in float32
        if dtype == "float32":
            full = fused(*targs, **kw).numpy()
            np.testing.assert_allclose(full, arrays[0] + got, atol=1e-6)


def test_int8_branch_refuses_res_add_false(rng):
    x, *mlp = [torch.from_numpy(a) for a in _mlp_arrays(rng)]
    with pytest.raises(ValueError, match="res_add=True only"):
        mlp_block_fused(x, *mlp, quant=True, res_add=False)


@pytest.mark.parametrize("branch", ["attention", "attention-shifted", "mlp"])
def test_branch_gradients_match_jax_vjp(rng, branch):
    if branch == "mlp":
        arrays, extra, names = _mlp_arrays(rng), [], MLP_NAMES
        fn = swin_train.make_mlp_branch()

        def jref(*a):
            return jax_mlp_reference(*a, res_add=False)
    else:
        arrays, names = _attn_arrays(rng), ATTN_NAMES
        shifted = branch.endswith("shifted")
        extra = [_shift_attn_mask(8, 8, 4, 2)] if shifted else []
        fn = swin_train.make_attn_branch(4, 2, shifted)

        def jref(*a):
            return jax_attn_reference(*a[:8], a[8] if shifted else None,
                                      window=4, num_heads=2, res_add=False)
    up = rng.standard_normal(arrays[0].shape).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn.apply(*leaves, *[torch.from_numpy(m) for m in extra])
    got = torch.autograd.grad(out, leaves, torch.from_numpy(up))

    @jax.jit
    def jax_grads(*a):
        y, vjp = jax.vjp(lambda *p: jref(*p, *[jnp.asarray(m) for m in
                                                extra]), *a)
        return y, vjp(jnp.asarray(up))

    want_out, want = jax_grads(*[jnp.asarray(a) for a in arrays])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=ATOL)
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   err_msg=name)


def _loss(out):
    return (out["pooled"] ** 2).mean() + (out["feature_map"] ** 2).mean()


def _jax_loss_and_grads(frames):
    model = JaxSwin(fused_train=False, drop_path_rate=0.0,
                    dtype=jnp.float32, **NANO)
    variables = jax.jit(model.init)(jax.random.PRNGKey(1),
                                    jnp.asarray(frames))

    @jax.jit
    def loss_and_grads(params):
        def loss(p):
            out = model.apply({"params": p}, jnp.asarray(frames), train=True,
                              rngs={"dropout": jax.random.PRNGKey(3)})
            return _loss(out)

        return jax.value_and_grad(loss)(params)

    return variables, loss_and_grads(variables["params"])


def _flax_path(name: str):
    """The flax path of a port parameter, and the transpose that takes the
    port's layout to flax's (the patch embed's OIHW kernel)."""
    path = name.split(".")
    if path[-2:] == ["patch_embed", "weight"]:
        return tuple(path[:-1] + ["kernel"]), (2, 3, 1, 0)
    return tuple(path), None


def _port_grads(model, frames):
    model.zero_grad(set_to_none=True)
    loss = _loss(model(torch.from_numpy(frames),
                       generator=torch.Generator().manual_seed(0)))
    loss.backward()
    return loss.item(), {n: p.grad.clone()
                         for n, p in model.named_parameters()}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def test_fused_train_remat_matches_jax(rng):
    frames = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    variables, (want_loss, want) = _jax_loss_and_grads(frames)
    model = load_jax_variables(SwinTransformer(
        fused_train=True, remat=True, drop_path_rate=0.0, **NANO),
        variables).train()
    plans = [getattr(model, f"stage{s}_block0").plan(hw, hw)
             for s, hw in enumerate((16, 8, 4, 2))]
    assert plans == ["fused_train"] * 3 + ["plain"]
    loss, grads = _port_grads(model, frames)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    assert len(grads) == len(jax.tree_util.tree_leaves(want))
    for name, g in grads.items():
        path, perm = _flax_path(name)
        g = g.numpy() if perm is None else g.numpy().transpose(perm)
        np.testing.assert_allclose(g, _get(want, path), atol=MODEL_ATOL,
                                   err_msg=name)


def test_remat_policies_give_the_same_gradients(rng, monkeypatch):
    """remat "dots", "" and off: the same loss and gradients; with remat the
    backward replays each K6 branch's forward (one more call of its plain
    version per fused block)."""
    frames = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    variables = jax.jit(JaxSwin(**NANO).init)(jax.random.PRNGKey(2),
                                              jnp.asarray(frames))
    calls = []
    reference = swin_train.window_mhsa_reference

    def counting(*a, **kw):
        calls.append(1)
        return reference(*a, **kw)

    monkeypatch.setattr(swin_train, "window_mhsa_reference", counting)
    results, counts = {}, {}
    for label, kw in (("off", dict(remat=False)),
                      ("dots", dict(remat=True, remat_policy="dots")),
                      ("nothing", dict(remat=True, remat_policy=""))):
        model = load_jax_variables(SwinTransformer(
            fused_train=True, drop_path_rate=0.1, **kw, **NANO),
            variables).train()
        calls.clear()
        results[label] = _port_grads(model, frames)
        counts[label] = len(calls)
    fused_blocks = 4  # stages 0-2 of swin_nano_64 at 64x64
    # forward and backward; with remat also the replay
    assert counts == {"off": 2 * fused_blocks, "dots": 3 * fused_blocks,
                      "nothing": 3 * fused_blocks}
    loss0, grads0 = results["off"]
    for label in ("dots", "nothing"):
        loss, grads = results[label]
        assert loss == pytest.approx(loss0, rel=1e-6)
        for name, g in grads.items():
            torch.testing.assert_close(g, grads0[name], atol=1e-6, rtol=1e-5,
                                       msg=f"{label} {name}")
    with pytest.raises(ValueError, match="remat_policy"):
        SwinTransformer(remat=True, remat_policy="all", **NANO)


def test_drop_path_and_dropout_masks():
    x = torch.randn(64, 3, 5) + 3.0  # no element is 0
    dp, do = DropPath(0.25).train(), Dropout(0.4).train()
    mask = dp.draw(x, torch.Generator().manual_seed(7))
    assert mask.shape == (64, 1, 1) and mask.dtype == torch.bool
    y = dp(x, mask)
    kept = mask.flatten()
    # per sample: every element kept (scaled by 1 / keep) or every one 0
    torch.testing.assert_close(y[kept], x[kept] / 0.75)
    assert (y[~kept] == 0).all() and 0 < kept.sum() < 64
    # the generator makes the draw repeatable, another seed another draw
    assert torch.equal(dp.draw(x, torch.Generator().manual_seed(7)), mask)
    assert not torch.equal(dp.draw(x, torch.Generator().manual_seed(8)),
                           mask)
    z = do(x, torch.Generator().manual_seed(3))
    keep = z != 0
    torch.testing.assert_close(z[keep], x[keep] / 0.6)
    assert 0.4 < keep.float().mean() < 0.8  # elementwise, about 60% kept
    assert torch.equal(do(x, torch.Generator().manual_seed(3)), z)
    # eval, and rate 0, are the identity
    assert dp.eval().draw(x) is None and dp(x, None) is x
    assert do.eval()(x) is x and Dropout(0.0).train()(x) is x


@pytest.mark.parametrize("fused_train", [False, True])
def test_training_takes_no_eval_plan_and_drops_every_branch(rng, monkeypatch,
                                                            fused_train):
    """The eval kernels (K5; K3 + K4 with the residual) never run in
    training, and DropPath follows both branches of every block, on every
    plan (the JAX gate: ``deterministic``, ``models/swin.py:291-303``)."""
    frames = torch.from_numpy(
        rng.standard_normal((2, 64, 64, 3)).astype(np.float32))
    model = SwinTransformer(fused_train=fused_train, drop_path_rate=0.3,
                            **NANO).train()
    seen = []
    apply = common.DropPath.forward

    def counting(self, x, mask=None):
        seen.append(mask is not None)
        return apply(self, x, mask)

    monkeypatch.setattr(common.DropPath, "forward", counting)
    x = model.embed(frames)
    for si, depth in enumerate(model.depths):
        for d in range(depth):
            block = getattr(model, f"stage{si}_block{d}")
            plan = block.plan(x.shape[1], x.shape[2])
            assert plan == ("fused_train" if fused_train and si < 3
                            else "plain"), (si, d, plan)
        x = model.stage(si, x, torch.Generator().manual_seed(si))
    blocks = sum(model.depths)
    # the first block's rate is 0 (linspace from 0), so its DropPath is the
    # identity; every other block draws and applies a mask after each branch
    assert len(seen) == 2 * blocks and seen == [False, False] + [True] * (
        2 * blocks - 2)
    # in eval the same blocks take the eval kernels' plans
    model.eval()
    assert model.stage0_block0.plan(16, 16) == "merged"
