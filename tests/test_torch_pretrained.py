"""The port's torch-layout converters and ImageNet warm start against the
JAX package's (``models/convert.py``, ``models/pretrained.py``).

The converters run on the torch-layout inputs the JAX tests build: the
torchvision-layout ResNet18 twin (``tests/test_convert.py::
TorchResNet18``, plain and frozen BN), a microsoft-layout Swin state dict
(the one of ``tests/test_convert.py::test_swin_converter_shapes``, here at
``swin_nano_64``'s shapes) and the TResNet twin of
``tests/test_tresnet_parity.py``: their trees equal JAX's bit for bit, and
``load_jax_variables`` takes them. ``load_torch_state_dict`` reads a saved
``.pth`` as JAX's does. The warm start fills a ``SpatialCNN`` state's
backbone (parameters and running statistics), a ``Q2L(resnet18)`` state's
frozen BatchNorm and a ``Q2L(swin_nano_64)`` state's Swin, bit for bit
against the converted trees, and leaves the rest alone; ``_merge`` refuses
a shape mismatch and skips unknown keys; a directory without the file is
skipped by ``cli.common.maybe_warm_start``, a missing path raises.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch
import torch.nn as nn

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_convert import TorchResNet18  # noqa: E402
from test_tresnet_parity import LAYERS, WIDTH, _torch_tresnet  # noqa: E402

from computervision_codes_tpu.models import convert as jax_convert
from computervision_codes_tpu.models.swin import VARIANTS as JAX_SWIN
from computervision_codes_tpu_torch.cli.common import maybe_warm_start
from computervision_codes_tpu_torch.models import convert
from computervision_codes_tpu_torch.models.convert import (
    jax_variables,
    load_jax_variables,
)
from computervision_codes_tpu_torch.models.pretrained import (
    PTDICT,
    _merge,
    load_backbone_variables,
    resolve_checkpoint,
    warm_start_backbone,
)
from computervision_codes_tpu_torch.models.q2l import Q2L
from computervision_codes_tpu_torch.models.resnet import build_resnet
from computervision_codes_tpu_torch.models.spatial_cnn import SpatialCNN
from computervision_codes_tpu_torch.models.swin import build_swin
from computervision_codes_tpu_torch.models.tresnet import TResNet
from computervision_codes_tpu_torch.train import build_sgd, create_train_state


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _resnet_sd():
    tm = TorchResNet18()
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
                m.running_mean.uniform_(-0.5, 0.5, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return tm


def _swin_sd(rng, embed, depths, heads, window):
    """The microsoft-layout state dict of tests/test_convert.py:101-134."""
    sd = {}

    def r(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    sd["patch_embed.proj.weight"] = r(embed, 3, 4, 4)
    sd["patch_embed.proj.bias"] = r(embed)
    sd["patch_embed.norm.weight"] = 1 + r(embed)
    sd["patch_embed.norm.bias"] = r(embed)
    for si, d in enumerate(depths):
        dim = embed * (2 ** si)
        for bi in range(d):
            t = f"layers.{si}.blocks.{bi}"
            for n in ("norm1", "norm2"):
                sd[f"{t}.{n}.weight"] = 1 + r(dim)
                sd[f"{t}.{n}.bias"] = r(dim)
            sd[f"{t}.attn.qkv.weight"] = r(3 * dim, dim)
            sd[f"{t}.attn.qkv.bias"] = r(3 * dim)
            sd[f"{t}.attn.proj.weight"] = r(dim, dim)
            sd[f"{t}.attn.proj.bias"] = r(dim)
            sd[f"{t}.attn.relative_position_bias_table"] = r(
                (2 * window - 1) ** 2, heads[si])
            sd[f"{t}.attn.relative_position_index"] = np.zeros(
                (window ** 2, window ** 2), np.int64)
            sd[f"{t}.mlp.fc1.weight"] = r(4 * dim, dim)
            sd[f"{t}.mlp.fc1.bias"] = r(4 * dim)
            sd[f"{t}.mlp.fc2.weight"] = r(dim, 4 * dim)
            sd[f"{t}.mlp.fc2.bias"] = r(dim)
        if si < len(depths) - 1:
            d = f"layers.{si}.downsample"
            sd[f"{d}.norm.weight"] = 1 + r(4 * dim)
            sd[f"{d}.norm.bias"] = r(4 * dim)
            sd[f"{d}.reduction.weight"] = r(2 * dim, 4 * dim)
    final = embed * (2 ** (len(depths) - 1))
    sd["norm.weight"] = 1 + r(final)
    sd["norm.bias"] = r(final)
    sd["head.weight"] = r(1000, final)
    sd["head.bias"] = r(1000)
    return sd


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_trees_equal(got[k], w, f"{path}/{k}")
        else:
            np.testing.assert_array_equal(got[k], np.asarray(w),
                                          err_msg=f"{path}/{k}")


@pytest.fixture(scope="module")
def pretrain_dir(tmp_path_factory):
    """A Pretrain-style directory holding the ResNet18 twin and a
    nano-Swin state dict under the reference's file names."""
    root = tmp_path_factory.mktemp("pretrain")
    torch.save({"state_dict": {f"module.{k}": v for k, v in
                               _resnet_sd().state_dict().items()}},
               str(root / PTDICT["resnet18"]))
    nano = JAX_SWIN["swin_nano_64"]
    sd = _swin_sd(np.random.default_rng(1), nano["embed_dim"],
                  nano["depths"], nano["num_heads"], nano["window_size"])
    path = str(root / "swin_nano.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    return str(root), path


def test_load_torch_state_dict_matches_jax(pretrain_dir):
    root, swin_path = pretrain_dir
    for path in (os.path.join(root, PTDICT["resnet18"]), swin_path):
        got = convert.load_torch_state_dict(path)
        want = jax_convert.load_torch_state_dict(path)
        assert set(got) == set(want) and not any(
            k.startswith("module.") for k in got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("frozen_bn", [False, True])
def test_resnet_converter_matches_jax(frozen_bn):
    sd = {k: v.numpy() for k, v in _resnet_sd().state_dict().items()}
    want = jax_convert.convert_torchvision_resnet(sd, (2, 2, 2, 2),
                                                  frozen_bn=frozen_bn)
    got = convert.convert_torchvision_resnet(sd, (2, 2, 2, 2),
                                             frozen_bn=frozen_bn)
    _assert_trees_equal(got, want)
    model = load_jax_variables(build_resnet("resnet18", frozen_bn=frozen_bn),
                               got)
    _assert_trees_equal(jax_variables(model), got)


def test_swin_converter_matches_jax(rng):
    nano = JAX_SWIN["swin_nano_64"]
    sd = _swin_sd(rng, nano["embed_dim"], nano["depths"], nano["num_heads"],
                  nano["window_size"])
    got = convert.convert_swin(sd, nano["depths"])
    _assert_trees_equal(got, jax_convert.convert_swin(sd, nano["depths"]))
    model = load_jax_variables(build_swin("swin_nano_64"), got)
    _assert_trees_equal(jax_variables(model), got)


def test_tresnet_converter_matches_jax(pretrain_dir):
    sd = {k: v.numpy() for k, v in
          _torch_tresnet(WIDTH, LAYERS).state_dict().items()}
    want = jax_convert.convert_tresnet(sd, LAYERS)
    got = convert.convert_tresnet(sd, LAYERS)
    _assert_trees_equal(got, want)
    load_jax_variables(TResNet(width=WIDTH, layers=LAYERS), got)
    # a TResNet state dict is no CvT checkpoint: both converters reject it
    # (convert_cvt's parity: tests/test_torch_cvt.py), and the CvT warm
    # start finds no checkpoint where the directory holds none
    for fn in (convert.convert_cvt, jax_convert.convert_cvt):
        with pytest.raises(KeyError):
            fn(sd, (1, 2, 10))
    with pytest.raises(FileNotFoundError):
        load_backbone_variables("cvt_w24", pretrain_dir[0])


def test_resolve_checkpoint(pretrain_dir):
    root, _ = pretrain_dir
    path = os.path.join(root, PTDICT["resnet18"])
    assert resolve_checkpoint("resnet18", root) == path
    assert resolve_checkpoint("resnet18", path) == path
    with pytest.raises(FileNotFoundError, match="download.pytorch.org"):
        resolve_checkpoint("resnet18", path + ".missing")
    with pytest.raises(ValueError, match="no known checkpoint"):
        resolve_checkpoint("vgg16", root)


def _state(model):
    return create_train_state(model, build_sgd(1e-2), device="cpu")


def test_warm_start_spatial_cnn(pretrain_dir):
    root, _ = pretrain_dir
    state = _state(SpatialCNN("resnet18", loss_type="all", teacher_dim=24,
                              generator=torch.Generator().manual_seed(0)))
    head = {k: v.clone() for k, v in state.model.state_dict().items()
            if not k.startswith("backbone.")}
    logs = []
    flags = types.SimpleNamespace(imagenet_pretrain=root)
    logger = types.SimpleNamespace(log=logs.append)
    assert maybe_warm_start(flags, state, "resnet18", logger) is state
    want = load_backbone_variables("resnet18", root)
    got = jax_variables(state.model.backbone)
    _assert_trees_equal(got, want)  # parameters and running statistics
    for k, v in state.model.state_dict().items():
        if k in head:
            assert torch.equal(v, head[k]), k
    assert "tensors loaded" in logs[0]
    # a directory without the backbone's file: trained from scratch
    before = state.model.backbone.conv1.weight.clone()
    maybe_warm_start(flags, state, "resnet34", logger)
    assert "from scratch" in logs[-1]
    assert torch.equal(state.model.backbone.conv1.weight, before)


def test_warm_start_frozen_bn_q2l_and_swin(pretrain_dir, tmp_path):
    root, swin_path = pretrain_dir
    state = _state(Q2L(backbone="resnet18", loss_type="i",
                       generator=torch.Generator().manual_seed(0)))
    transformer = jax_variables(state.model.transformer)
    warm_start_backbone(state, "resnet18", root, log=lambda m: None)
    want = load_backbone_variables("resnet18", root, frozen_bn=True)
    _assert_trees_equal(jax_variables(state.model.backbone), want)
    _assert_trees_equal(jax_variables(state.model.transformer), transformer)

    state = _state(Q2L(backbone="swin_nano_64", loss_type="i",
                       generator=torch.Generator().manual_seed(0)))
    logs = []
    warm_start_backbone(state, "swin_nano_64", swin_path, log=logs.append)
    want = load_backbone_variables("swin_nano_64", swin_path)
    _assert_trees_equal(jax_variables(state.model.backbone), want)
    assert "checkpoint keys skipped" not in logs[0]  # headless: no head
    nano = JAX_SWIN["swin_nano_64"]
    other = str(tmp_path / "swin_wider.pth")  # another embed width
    torch.save({k: torch.from_numpy(v) for k, v in _swin_sd(
        np.random.default_rng(2), 48, nano["depths"], nano["num_heads"],
        nano["window_size"]).items()}, other)
    with pytest.raises(ValueError, match="shape mismatch"):
        warm_start_backbone(state, "swin_nano_64", other, log=lambda m: None)
    with pytest.raises(ValueError, match="loaded nothing"):
        warm_start_backbone(state, "resnet18", root, log=lambda m: None)


def test_merge_rejects_shape_mismatch_and_skips_unknown_keys():
    with pytest.raises(ValueError, match="shape mismatch"):
        _merge({"a": {"w": np.zeros((2, 3))}}, {"a": {"w": np.zeros((3, 2))}})
    merged, loaded, skipped = _merge(
        {"a": {"w": np.zeros(2, np.float32)}},
        {"a": {"w": np.ones(2)}, "head": {"k": np.ones(1)}})
    assert loaded == ["/a/w"] and skipped == ["/head"]
    assert merged["a"]["w"].dtype == np.float32
    np.testing.assert_array_equal(merged["a"]["w"], 1.0)
