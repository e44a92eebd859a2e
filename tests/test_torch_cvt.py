"""The port's CvT, Q2L(CvT) and CvT teacher session against the JAX
package's.

Weights come from the port's seeded modules, exported to the JAX layout by
``jax_variables`` (an eager flax init of these models takes tens of
seconds), every ConvProjection's BatchNorm drawn at random; the same seeded
numpy frames go through both.

* ``cvt_nano`` at 64x64, float32, eval and train mode (BatchNorm on the
  batch statistics, the new running statistics too): every output within
  1e-4 of its largest magnitude (max abs error over max |ref|).
* ``Q2L(backbone="cvt_nano")`` and ``TeacherSession`` with it, bf16 and
  ``quantize=True``: the bound tests/test_torch_q2l.py holds the Swin
  teacher to (4% of the largest magnitude, correlation > 0.999) and, for
  the sessions' probabilities, tests/test_torch_teacher.py's (max 0.1,
  correlation > 0.999). Both packages name CvT's Dense layers alike, so
  the int8 rule (``min_features=512``) picks the same ones.
* ``convert_cvt``: equal to JAX's, leaf for leaf, on a HF transformers
  ``CvtModel`` state dict and on its official (microsoft) layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.models import convert as jax_convert
from computervision_codes_tpu.models import cvt as jax_cvt
from computervision_codes_tpu.models.q2l import Q2L as JaxQ2L
from computervision_codes_tpu.serving import TeacherSession as JaxTeacher
from computervision_codes_tpu_torch.models import convert, cvt
from computervision_codes_tpu_torch.models import quant_dense as pqd
from computervision_codes_tpu_torch.models.convert import (jax_variables,
                                                          load_jax_variables)
from computervision_codes_tpu_torch.models.q2l import Q2L
from computervision_codes_tpu_torch.ops.attention import (
    attention_reference, multi_head_attention)
from computervision_codes_tpu_torch.serving import TeacherSession

REL = 1e-4
BF16_REL, BF16_CORR = 0.04, 0.999


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def randomized(model: torch.nn.Module, seed: int) -> dict:
    """The JAX variables of ``model`` with every BatchNorm's statistics and
    affine drawn from ``seed``, loaded back into ``model``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, cvt.BatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
    return jax_variables(model)


def frames(seed, n=2):
    return np.random.default_rng(seed).standard_normal(
        (n, 64, 64, 3)).astype(np.float32)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_variants_and_attention_backend(rng):
    assert cvt.VARIANTS == jax_cvt.VARIANTS
    assert cvt.feature_dim("cvt_w24") == 1024
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 9, 8)).astype(
        np.float32)) for _ in range(3))
    for backend in ("xla", "pallas", "auto"):
        torch.testing.assert_close(multi_head_attention(q, k, v, backend),
                                   attention_reference(q, k, v))
    with pytest.raises(ValueError, match="backend"):
        multi_head_attention(q, k, v, backend="flash")
    # the plain version's autograd, as the JAX op differentiates XLA's
    qg = q.clone().requires_grad_()
    multi_head_attention(qg, k, v, "xla").sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad).all()


@pytest.mark.parametrize("train", [False, True])
def test_cvt_nano_float32_matches_jax(train):
    model = cvt.build_cvt("cvt_nano", generator=torch.Generator()
                          .manual_seed(0))
    variables = randomized(model, 1)
    x = frames(0)
    jmodel = jax_cvt.build_cvt("cvt_nano")
    if train:
        want, upd = jax.jit(lambda v, a: jmodel.apply(
            v, a, train=True, mutable=["batch_stats"]))(variables, x)
        model.train()
    else:
        want = jax.jit(jmodel.apply)(variables, x)
        model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        assert tuple(got[key].shape) == w.shape, key
        assert _rel(got[key].numpy(), w) <= REL, key
    if train:
        stats = jax_variables(model)["batch_stats"]
        flat = jax.tree_util.tree_leaves_with_path(upd["batch_stats"])
        assert len(flat) == 2 * 3 * sum(jax_cvt.VARIANTS["cvt_nano"][
            "depths"])
        for path, leaf in flat:
            node = stats
            for p in path:
                node = node[p.key]
            assert _rel(node, np.asarray(leaf)) <= REL, path


def test_drop_path_pair_shares_one_mask():
    """Stochastic depth drops a sample's spatial and cls tokens together,
    scaling the kept ones by 1 / keep."""
    dp = cvt.DropPathPair(0.5).train()
    x, cls = torch.ones(64, 2, 2, 3), torch.ones(64, 1, 3)
    gx, gc = dp(x, cls, torch.Generator().manual_seed(0))
    kept_x = gx.flatten(1).amax(1) > 0
    assert torch.equal(kept_x, gc.flatten(1).amax(1) > 0)
    assert 0 < int(kept_x.sum()) < 64
    assert set(gx.unique().tolist()) == {0.0, 2.0}
    assert dp.eval()(x, cls)[0] is x


def _q2l_pair(loss_type="i"):
    model = Q2L(backbone="cvt_nano", loss_type=loss_type,
                generator=torch.Generator().manual_seed(2))
    assert model.dim == 64
    return model, randomized(model, 3)


def test_q2l_cvt_nano_bf16_matches_jax():
    _, variables = _q2l_pair()
    x = frames(1)
    want = jax.jit(JaxQ2L(backbone="cvt_nano", loss_type="i",
                          dtype=jnp.bfloat16).apply)(
        variables, jnp.asarray(x, jnp.bfloat16))
    model = load_jax_variables(Q2L(backbone="cvt_nano", loss_type="i",
                                   dtype=torch.bfloat16), variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).bfloat16())
    for g, w in ((got["logits"]["i"], want["logits"]["i"]),
                 (got["feature"], want["feature"])):
        assert g.dtype == torch.bfloat16
        g = g.float().numpy().ravel()
        w = np.asarray(w, np.float32).ravel()
        assert np.abs(g - w).max() <= BF16_REL * np.abs(w).max()
        assert np.corrcoef(g, w)[0, 1] > BF16_CORR


def test_int8_dense_reaches_cvt_layers_by_jax_names():
    """Every Dense of Q2L(cvt_nano) is called in a forward and has the flax
    path of a JAX ``nn.Dense`` (a 2-D ``kernel`` in the variables the JAX
    model applies), the key of the JAX int8 interception, so
    ``min_features`` picks the same layers; at CvT-w24's widths the
    backbone's q/k/v/proj from stage 1 on and every MLP's second Dense
    (768 inputs and more) reach 512."""
    model, variables = _q2l_pair()
    got = pqd.collect_dense_scales(model.eval(),
                                   torch.from_numpy(frames(2)))
    want = {"/".join(p.key for p in path[:-1])
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                variables["params"])
            if path[-1].key == "kernel" and np.ndim(leaf) == 2}
    assert set(got) == set(pqd.dense_layers(model)) == want
    assert "backbone/stage2_block1/attn/q" in got
    with torch.device("meta"):  # shapes only
        w24 = cvt.build_cvt("cvt_w24")
    wide = {p for p, m in pqd.dense_layers(w24).items()
            if m.kernel.shape[0] >= 512}
    blocks = [f"stage{s}_block{b}" for s, d in enumerate((2, 2, 20))
              for b in range(d)]
    assert wide == {f"{b}/{n}" for b in blocks for n in (
        ("attn/q", "attn/k", "attn/v", "attn/proj", "mlp/Dense_0",
         "mlp/Dense_1") if not b.startswith("stage0") else ("mlp/Dense_1",))}


@pytest.mark.parametrize("quantize", [False, True])
def test_cvt_teacher_session_matches_jax(quantize):
    _, variables = _q2l_pair()
    cal = frames(3)
    kw = dict(batch=2, img_size=64, backbone="cvt_nano", loss_type="i",
              quantize=quantize)
    extra = {"calibrate_frames": cal} if quantize else {}
    jsess = JaxTeacher.create(variables=variables, **kw, **{
        k: jnp.asarray(v) for k, v in extra.items()})
    sess = TeacherSession.create(variables=variables, device="cpu", **kw,
                                 **extra)
    swapped = {k for k, m in sess.model.named_modules()
               if isinstance(m, pqd.Int8Dense)}
    assert swapped == ({"transformer.encoder0.linear2",
                        "transformer.decoder0.linear2",
                        "transformer.decoder1.linear2"} if quantize
                       else set())
    x = np.random.default_rng(4).integers(0, 256, (2, 64, 64, 3),
                                          dtype=np.uint8)
    got, want = sess.predict(x), jsess.predict(x.copy())
    assert set(got) == set(want) == {"i", "feature"}
    for k in want:
        g, w = got[k], want[k]
        assert g.shape == w.shape and g.dtype == np.float32, k
        assert np.corrcoef(g.ravel(), w.ravel())[0, 1] > BF16_CORR, k
        bound = BF16_REL * np.abs(w).max() if k == "feature" else 0.1
        assert np.abs(g - w).max() < bound, k


def _official_state_dict(seed: int) -> dict:
    """A random cvt_nano state dict in the official (microsoft) layout."""
    rng = np.random.default_rng(seed)
    spec = jax_cvt.VARIANTS["cvt_nano"]
    sd, cin = {}, 3

    def put(key, *shape):
        sd[key] = rng.standard_normal(shape).astype(np.float32)

    for si, (dim, depth) in enumerate(zip(spec["dims"], spec["depths"])):
        st, k = f"stage{si}", 7 if si == 0 else 3
        put(f"{st}.patch_embed.proj.weight", dim, cin, k, k)
        for name in ("proj.bias", "norm.weight", "norm.bias"):
            put(f"{st}.patch_embed.{name}", dim)
        for bi in range(depth):
            t = f"{st}.blocks.{bi}"
            for tk in "qkv":
                put(f"{t}.attn.conv_proj_{tk}.conv.weight", dim, 1, 3, 3)
                for name in ("weight", "bias", "running_mean"):
                    put(f"{t}.attn.conv_proj_{tk}.bn.{name}", dim)
                sd[f"{t}.attn.conv_proj_{tk}.bn.running_var"] = rng.uniform(
                    0.5, 1.5, dim).astype(np.float32)
                put(f"{t}.attn.proj_{tk}.weight", dim, dim)
                put(f"{t}.attn.proj_{tk}.bias", dim)
            put(f"{t}.attn.proj.weight", dim, dim)
            for name in ("attn.proj.bias", "norm1.weight", "norm1.bias",
                         "norm2.weight", "norm2.bias", "mlp.fc2.bias"):
                put(f"{t}.{name}", dim)
            put(f"{t}.mlp.fc1.weight", 4 * dim, dim)
            put(f"{t}.mlp.fc1.bias", 4 * dim)
            put(f"{t}.mlp.fc2.weight", dim, 4 * dim)
        cin = dim
    put("stage2.cls_token", 1, 1, cin)
    put("norm.weight", cin)
    put("norm.bias", cin)
    return sd


def _hf_layout(sd: dict) -> dict:
    """The same tensors under HF transformers' ``CvtModel`` names (which
    carry no final LayerNorm), prefixed ``cvt.``."""
    out = {}
    for k, v in sd.items():
        if k.startswith("norm."):
            continue
        for old, new in jax_convert._HF_CVT_RENAMES:
            k = k.replace(new, old)
        k = k.replace(".blocks.", ".layers.")
        out["cvt.encoder.stages." + k.removeprefix("stage")] = v
    return out


@pytest.mark.parametrize("layout", ["hf", "official"])
def test_convert_cvt_matches_jax(layout):
    sd = _official_state_dict(5)
    if layout == "hf":
        sd = _hf_layout(sd)
        assert set(jax_convert._cvt_canonical(sd)) == set(
            _official_state_dict(5)) - {"norm.weight", "norm.bias"}
    depths = cvt.VARIANTS["cvt_nano"]["depths"]
    got = convert.convert_cvt(sd, depths)
    want = jax_convert.convert_cvt(sd, depths)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert flat_g.keys() == flat_w.keys()
    for path, leaf in flat_w.items():
        np.testing.assert_array_equal(flat_g[path], leaf, err_msg=str(path))
    model = load_jax_variables(cvt.build_cvt("cvt_nano"), got)
    np.testing.assert_array_equal(
        jax_variables(model)["params"]["norm"]["scale"],
        got["params"]["norm"]["scale"])
