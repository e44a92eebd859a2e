"""The port's MS-TCT modules against the JAX package's ``models/mstct.py``.

Each JAX module is initialised, its variables are carried into the port by
``load_jax_variables``, and both run the same seeded numpy input, in
float32 and bf16, at small widths (dims (16, 24, 32, 48), 4 heads, so head
dims 4, 6, 8 and 12). The JAX side runs jitted; on the CPU both take their
plain attention path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.models import mstct as jax_mstct
from computervision_codes_tpu_torch.models import mstct
from computervision_codes_tpu_torch.models.convert import load_jax_variables
from computervision_codes_tpu_torch.parallel.mesh import launch, make_mesh

DIMS = (16, 24, 32, 48)
HEADS = 4
IN_DIM = 20
T = 37
# Bounds on max|got - want| / max(1, max|want|).
# float32: the same ops in the same order, sums of a few hundred products
# in another order: 1e-5 (measured up to 6e-7), blocks and whole model.
# bf16: both round after every op, but at different points inside fused
# ones (GELU, the convolution + bias, the LayerNorm statistics), so an
# output can move by an ulp (2^-8): 2^-8 for one block (measured up to
# 1.3e-4); through the 4 stages, the mixer and the classifier those ulps
# compound: 2^-5 for the whole model (measured up to 1e-2) and for the
# mixer, whose outputs sum four rounded terms of 13 Dense layers (measured
# 2.9e-3)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -8, 2.0 ** -5)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rel, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max_abs_err {err} > {tol}"


def _run(jmod, tmod, inputs, **apply_kw):
    """init + jitted apply of the JAX module; the port module loaded from
    its variables and run on the same inputs."""
    jin = [jnp.asarray(x) for x in inputs]
    variables = jax.jit(lambda k, *a: jmod.init(k, *a, **apply_kw))(
        jax.random.PRNGKey(3), *jin)
    want = jax.jit(lambda v, *a: jmod.apply(v, *a, **apply_kw))(
        variables, *jin)
    load_jax_variables(tmod, variables)
    with torch.no_grad():
        got = tmod.eval()(*[torch.from_numpy(x) for x in inputs])
    return got, want


@pytest.mark.parametrize("dtype", DTYPES)
def test_blocks_match_jax(rng, dtype):
    jdt, tdt, rel, _ = DTYPES[dtype]
    x = rng.standard_normal((2, T, 24)).astype(np.float32)
    x_in = rng.standard_normal((2, T, IN_DIM)).astype(np.float32)
    cases = [
        ("merge", jax_mstct.TemporalMergingBlock(24, dtype=jdt),
         mstct.TemporalMergingBlock(IN_DIM, 24, dtype=tdt), x_in, {}),
        ("grb", jax_mstct.GlobalRelationalBlock(24, HEADS, jdt),
         mstct.GlobalRelationalBlock(24, HEADS, tdt), x, {}),
        ("lrb", jax_mstct.LocalRelationalBlock(48, dtype=jdt),
         mstct.LocalRelationalBlock(24, 48, tdt), x, {}),
        ("glr", jax_mstct.GLRBlock(24, HEADS, 2.0, jdt),
         mstct.GLRBlock(24, HEADS, 2.0, tdt), x, {}),
        ("classifier", jax_mstct.MSTCTClassifier(16, 7, jdt),
         mstct.MSTCTClassifier(24, 16, 7, tdt), x, {}),
    ]
    for what, jmod, tmod, inp, kw in cases:
        got, want = _run(jmod, tmod, [inp.astype(np.float32)], **kw)
        if what == "classifier":
            for g, w in zip(got, want):
                _close(g, w, rel, what)
        else:
            if what in ("grb", "merge"):  # they cast their input
                assert got.dtype == tdt
            _close(got, want, rel, what)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mixer_matches_jax_with_resize(rng, dtype):
    """Stages of different lengths take the mixer's linear resize."""
    jdt, tdt, _, rel = DTYPES[dtype]
    feats = [rng.standard_normal((2, t, d)).astype(np.float32)
             for t, d in zip((20, 10, 7, 5), DIMS)]
    jmod = jax_mstct.TemporalMixer(16, jdt)
    tmod = mstct.TemporalMixer(DIMS, 16, tdt)
    jin = [jnp.asarray(f) for f in feats]
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(0), jin)
    want = jax.jit(jmod.apply)(variables, jin)
    load_jax_variables(tmod, variables)
    with torch.no_grad():
        got = tmod([torch.from_numpy(f) for f in feats])
    assert got.shape == (2, 20, 64)
    _close(got, want, rel, "mixer")


@pytest.mark.parametrize("dtype", DTYPES)
def test_mstct_matches_jax(rng, dtype):
    """The whole model, and inside it the encoder's four stages and the
    mixer's output (JAX's captured intermediates, the port's hooks)."""
    jdt, tdt, _, rel = DTYPES[dtype]
    x = rng.standard_normal((1, 53, IN_DIM)).astype(np.float32)
    kw = dict(embed_dims=DIMS, num_blocks=1, num_heads=HEADS, mlp_ratio=2.0,
              final_embedding_dim=16, num_classes=100)
    jmod = jax_mstct.MSTCT(dtype=jdt, **kw)
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(3), jnp.asarray(x))
    want, state = jax.jit(lambda v, a: jmod.apply(
        v, a, capture_intermediates=True))(variables, jnp.asarray(x))
    inner = state["intermediates"]
    tmod = load_jax_variables(mstct.MSTCT(IN_DIM, dtype=tdt, **kw),
                              variables).eval()
    seen = {}
    for name in ("encoder", "mixer"):
        getattr(tmod, name).register_forward_hook(
            lambda m, a, out, name=name: seen.__setitem__(name, out))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == tdt
        _close(got[key], want[key], rel, key)
    stages = inner["encoder"]["__call__"][0]
    assert len(seen["encoder"]) == len(stages) == 4
    for si, (g, w) in enumerate(zip(seen["encoder"], stages)):
        _close(g, w, rel, f"encoder stage {si}")
    _close(seen["mixer"], inner["mixer"]["__call__"][0], rel, "mixer")
    # every leaf used, every parameter filled (load_jax_variables raises
    # otherwise), the 1-D conv kernels in flax's (k, Cin/g, Cout) layout
    assert len(jax.tree.leaves(variables)) == len(list(tmod.parameters()))
    tc = np.asarray(variables["params"]["encoder"]["stage1_block0"]["lrb"]
                    ["tc"]["kernel"])
    assert tc.shape == (3, 1, 32)  # depthwise over 2 x 16 hidden channels
    np.testing.assert_array_equal(
        tmod.encoder.stage1_block0.lrb.tc.kernel.detach().numpy(), tc)
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(mstct.MSTCT(IN_DIM + 1, dtype=tdt, **kw),
                           variables)


def test_mstct_refuses_what_is_not_ported():
    """``ring_mesh`` and the training forward, refused until their slices,
    now run: ``MSTCT(ring_mesh=...)`` gives every attention block the mesh
    and, over a one-rank mesh (a group in this process for the call), is
    the model without it (one ring block is the whole sequence; the ring
    over several ranks is tests/test_torch_parallel_context.py); a new
    module is in training mode and draws its dropout masks from the
    generator it is given."""
    with_ring, without = launch(_ring_over_one_rank, 1, (),
                                device_type="cpu")
    torch.testing.assert_close(with_ring, without, atol=2e-5, rtol=0)
    model = mstct.MSTCT(12, embed_dims=(8, 8, 8, 8), num_blocks=1,
                        num_heads=2, final_embedding_dim=8)
    x = torch.ones(1, 4, 12)
    out = model(x, torch.Generator().manual_seed(0))
    assert out["logits"].shape == (1, 4, 100)
    torch.testing.assert_close(
        model(x, torch.Generator().manual_seed(0))["logits"], out["logits"])


def _ring_over_one_rank():
    mesh = make_mesh(n_data=1, device_type="cpu")
    kw = dict(embed_dims=(8, 8, 8, 8), num_blocks=1, num_heads=2,
              final_embedding_dim=8)
    ring = mstct.MSTCT(12, ring_mesh=mesh,
                       generator=torch.Generator().manual_seed(0), **kw)
    assert all(m.ring_mesh is mesh for m in ring.modules()
               if isinstance(m, mstct.GlobalRelationalBlock))
    plain = mstct.MSTCT(12, generator=torch.Generator().manual_seed(0), **kw)
    x = torch.randn(1, 16, 12, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        return (ring.eval()(x)["logits"], plain.eval()(x)["logits"])
