"""Serving: pixels -> probabilities sessions on an explicit device.

Counterpart of ``serving.py`` in the JAX package (``InferenceSession`` and
``StreamingSession``). Semantics kept from it:

* the input dtype decides normalisation: uint8 frames are normalised on the
  device (ImageNet mean/std, in float32), any float input is taken as
  already normalised; the result is cast to bf16 (the sessions' default
  compute dtype) before the model;
* probabilities are the sigmoid, in float32, of the float32-cast logits;
* a session serves one fixed input shape and raises ``ValueError`` on any
  other;
* ``quantize=True`` serves the int8-PTQ backbone (``models.quantized``)
  under the bf16 TCN, with static activation scales calibrated once at
  creation, from the given normalised frames or from uniform [0, 255]
  pixels through the ImageNet normalisation (``_default_calibration``);
  ``fused_stem`` runs the stem as one kernel (``ops.stem_pool``);
* ``from_checkpoint`` serves a checkpoint that the JAX package's
  ``CheckpointManager`` wrote (``train.checkpoint``; no msgpack needed);
* ``TeacherSession`` serves the bf16 Q2L teacher (Swin-L-384 by default,
  or a ResNet, CvT or TResNet backbone, e.g. CvT-w24 at 384x384 or
  TResNet-L at 448x448): frames ->
  task probabilities and the per-frame feature vector that the cached
  feature bus carries. ``quantize=True`` serves the int8 teacher
  of the JAX session: ``Q2L(quant_eval=True, s2d_embed=True)`` (the Swin
  kernels' int8 branches at dims >= 768, the patch embed as a GEMM), with
  every ``Dense`` of at least 512 inputs swapped for an ``Int8Dense`` with
  static activation scales calibrated once at creation
  (``models.quant_dense``).

``InferenceSession.create(mesh=...)`` serves the batch in parallel over the
mesh's ``data`` axis: each rank runs its batch / n clips through the
ordinary model (K1, with Q1 and K2 in the int8 configuration, on the card)
and the probabilities are all-gathered, so that ``predict`` returns the
whole batch on every rank, as JAX's global output does.

``export`` writes a servable directory in the JAX package's layout as far
as it carries data: ``variables.msgpack`` (flax msgpack, written by
``train.checkpoint.pack_msgpack``: the JAX ``EndToEndRecognizer``
variables, or for an int8 session ``{"q_backbone", "tcn"}`` with the
calibrated int8 codes and scales) and ``meta.json`` with JAX's keys plus
what rebuilding needs (``network``, ``quantize``, ``s2d_stem``,
``fused_stem``; a streaming session's TCN geometry and ``causal``). JAX
also writes its programs as StableHLO (``*.jaxexport``), which only JAX
runs, and the port's kernels are ctypes calls that ``torch.export``
cannot trace: the port writes no program file, and ``load_exported``
rebuilds the session from the port's modules and the stored variables (an
int8 servable takes its codes and scales as stored, through
``models.convert.load_jax_quantized``, and is not calibrated again). It
reads a servable that JAX wrote too, ignoring its ``.jaxexport`` files and
inferring what its ``meta.json`` lacks from the variables' tree (the
backbone's blocks, the TCN's layers; the stem options, which the tree
cannot tell, are ``load_exported``'s arguments). A mesh session, or one
restored from an export, raises on ``export``, as in JAX.

Usage::

    sess = InferenceSession.create(batch=4, clip_len=256, device="cuda")
    sess = InferenceSession.create(quantize=True, fused_stem=True)
    sess = InferenceSession.from_checkpoint(directory, "student")
    probs = sess.predict(clips_uint8)       # {task: (B, T, C) numpy}
    sess.export("servable"); sess = InferenceSession.load_exported("servable")
    teacher = TeacherSession.create(batch=16, img_size=384, device="cuda")
    teacher = TeacherSession.create(quantize=True)   # the int8 teacher
    teacher = TeacherSession.create(backbone="tresnet_l", img_size=448)
    teacher = TeacherSession.create(backbone="cvt_w24", quantize=True)
    out = teacher.predict(frames_uint8)     # {task: (B, C), "feature": (B, D)}
"""

from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .data.transforms import IMAGENET_MEAN, IMAGENET_STD
from .models.convert import (jax_quantized, jax_variables,
                             load_jax_quantized, load_jax_variables)
from .models.pipeline import EndToEndRecognizer
from .models.q2l import Q2L
from .models.quant_dense import (apply_int8_dense, collect_dense_scales,
                                 quantize_dense_params)
from .models.quantized import (Int8Recognizer, make_int8_e2e,
                               quantize_resnet)
from .models.resnet import VARIANTS as RESNET_VARIANTS, Bottleneck
from .train.checkpoint import (checkpoint_path, pack_msgpack, read_msgpack,
                               restore_variables)

TASKS = ("ivt", "i", "v", "t")
INT8_DENSE_MIN_FEATURES = 512  # the JAX TeacherSession's min_features
Device = Union[str, torch.device]


def tcn_receptive_field(num_layers_pg: int, num_layers_r: int,
                        num_refinements: int) -> int:
    """Causal receptive field (frames) of TemporalTCN: each dilated layer
    reaches 2d back, dilations 2^i per stage, so a stage of L layers adds
    2 * (2^L - 1); the FPN laterals are 1x1 and add nothing. Default
    config (11 + 3x10): 1 + 4094 + 3 * 2046 = 10233."""
    return (1 + 2 * (2 ** num_layers_pg - 1)
            + num_refinements * 2 * (2 ** num_layers_r - 1))


def _default_calibration(shape: Tuple[int, ...], dtype: torch.dtype,
                         device: Device) -> torch.Tensor:
    """Int8 calibration batch: uniform [0, 255] pixels (a ``torch.Generator``
    seeded with 7) through the ImageNet normalisation, in ``dtype``. A
    standard-normal stand-in would have about twice the absmax of real
    normalised frames and halve the first layers' resolution."""
    gen = torch.Generator().manual_seed(7)
    pix = torch.rand(shape, generator=gen) * 255.0
    mean = torch.as_tensor(IMAGENET_MEAN)
    std = torch.as_tensor(IMAGENET_STD)
    return ((pix / 255.0 - mean) / std).to(device, dtype)


def _build_model(variables, device: Device, **model_kw
                 ) -> EndToEndRecognizer:
    """The recognizer on ``device`` in eval mode: weights from ``variables``
    (the JAX package's tree, see ``models.convert``) or drawn from a
    ``torch.Generator`` seeded with 0."""
    model = EndToEndRecognizer(generator=torch.Generator().manual_seed(0),
                               **model_kw)
    if variables is not None:
        load_jax_variables(model, variables)
    return model.to(device).eval()


def _to_model_input(arr, device: torch.device, dtype: torch.dtype
                    ) -> torch.Tensor:
    """uint8 -> ImageNet-normalised on the device; float -> as given. Both
    computed in float32, then cast to the compute dtype."""
    x = torch.as_tensor(arr)
    normalize = x.dtype == torch.uint8
    x = x.to(device, non_blocking=True).float()
    if normalize:
        mean = torch.as_tensor(IMAGENET_MEAN, device=device)
        std = torch.as_tensor(IMAGENET_STD, device=device)
        x = (x / 255.0 - mean) / std
    return x.to(dtype)


@dataclass
class InferenceSession:
    """A fixed-shape session: (B, T, H, W, 3) clips -> task probabilities."""

    model: Union[EndToEndRecognizer, Int8Recognizer]
    batch: int
    clip_len: int
    height: int
    width: int
    device: torch.device
    mesh: object = None
    # what export() writes beside JAX's meta keys; None for sessions built
    # over a mesh or restored from an export
    exportable: Optional[dict] = None

    @classmethod
    def create(cls, batch: int = 4, clip_len: int = 256, height: int = 256,
               width: int = 448, network: str = "resnet18",
               variables=None, quantize: bool = False,
               calibrate_clips=None, mesh=None, s2d_stem: bool = False,
               fused_stem: bool = False, device: Device = "cuda"
               ) -> "InferenceSession":
        """``variables``: the JAX ``EndToEndRecognizer`` variables to serve;
        without them, weights are drawn from a seeded generator. ``device``
        is used as given: a session never moves itself to another device.

        ``quantize=True`` serves the int8 backbone. ``calibrate_clips``,
        normalised (B, T, H, W, 3), bake its static activation scales;
        without them ``_default_calibration`` at (1, 8, H, W, 3) stands in.
        As in the JAX session, ``fused_stem`` applies to the int8 backbone
        only and ``s2d_stem`` to both.

        ``mesh`` (``parallel.mesh.make_mesh``): batch parallelism over its
        ``data`` axis, on this rank's device (``device`` is not used); the
        batch must divide by the axis size."""
        if mesh is not None:
            from .parallel.mesh import DATA_AXIS, axis_size, mesh_device

            n_data = axis_size(mesh, DATA_AXIS)
            if batch % n_data:
                raise ValueError(f"batch {batch} must divide the mesh data "
                                 f"axis ({n_data})")
            device = mesh_device(mesh)
        device = torch.device(device)
        model = _build_model(variables, device, network=network,
                             s2d_stem=s2d_stem, dtype=torch.bfloat16)
        if quantize:
            if calibrate_clips is None:
                calibrate_clips = _default_calibration(
                    (1, 8, height, width, 3), torch.bfloat16, device)
            model = make_int8_e2e(
                model, torch.as_tensor(calibrate_clips).to(device),
                s2d_stem=s2d_stem, fused_stem=fused_stem)
        exportable = None if mesh is not None else dict(
            network=network, quantize=quantize, s2d_stem=s2d_stem,
            fused_stem=fused_stem)
        return cls(model, batch, clip_len, height, width, device, mesh,
                   exportable)

    @classmethod
    def from_checkpoint(cls, directory: str, modelname: str, **kwargs
                        ) -> "InferenceSession":
        """Serve the EndToEndRecognizer state that a ``CheckpointManager``
        (of either package) saved as ``<modelname>.msgpack`` in
        ``directory``; ``kwargs`` go to ``create``."""
        variables = restore_variables(checkpoint_path(directory, modelname))
        return cls.create(variables=variables, **kwargs)

    @property
    def shape(self):
        return (self.batch, self.clip_len, self.height, self.width, 3)

    def predict(self, clips) -> Dict[str, np.ndarray]:
        """uint8 (normalised here) or normalised float clips -> {task:
        (B, T, C) float32 probabilities}; over a mesh, each rank runs its
        slice and every rank returns the whole batch."""
        if tuple(clips.shape) != self.shape:
            raise ValueError(f"session serves shape {self.shape}, got "
                             f"{tuple(clips.shape)}")
        with torch.inference_mode():
            if self.mesh is not None:
                from .parallel.context import all_gather_cat
                from .parallel.mesh import (DATA_AXIS, axis_group,
                                            batch_sharding, local_slice)

                x = _to_model_input(
                    local_slice(clips, batch_sharding(self.mesh)),
                    self.device, torch.bfloat16)
                out = self.model(x)
                group = axis_group(self.mesh, DATA_AXIS)
                return {k: all_gather_cat(torch.sigmoid(out[k].float()),
                                          group, 0).cpu().numpy()
                        for k in TASKS}
            x = _to_model_input(clips, self.device, torch.bfloat16)
            out = self.model(x)
            return {k: torch.sigmoid(out[k].float()).cpu().numpy()
                    for k in TASKS}

    def export(self, path: str) -> str:
        """Write the servable (``variables.msgpack``, ``meta.json``) to
        ``path``; restore with ``InferenceSession.load_exported(path)``."""
        if self.exportable is None:
            raise ValueError("session is not exportable (mesh-sharded or "
                             "itself restored from an export)")
        _write_servable(path, _session_variables(self.model), dict(
            batch=self.batch, clip_len=self.clip_len, height=self.height,
            width=self.width, **self.exportable))
        return path

    @classmethod
    def load_exported(cls, path: str, device: Device = "cuda",
                      s2d_stem: bool = False, fused_stem: bool = False
                      ) -> "InferenceSession":
        """Rebuild an exported session on ``device`` (the port's or the JAX
        package's servable). The stem options stored in ``meta.json`` win
        over the arguments, which stand in for a JAX servable's."""
        meta, tree = _read_servable(path)
        s2d = meta.get("s2d_stem", s2d_stem)
        fused = meta.get("fused_stem", fused_stem)
        model = _rebuild(tree, meta, torch.device(device), torch.bfloat16,
                         dict(s2d_stem=s2d), (s2d, fused))
        return cls(model, meta["batch"], meta["clip_len"], meta["height"],
                   meta["width"], torch.device(device))


def _session_variables(model) -> dict:
    """The JAX variables of a session's model: the recognizer's, or for the
    int8 model ``{"q_backbone", "tcn"}`` (JAX's ``make_int8_e2e`` tree)."""
    if isinstance(model, Int8Recognizer):
        return {"q_backbone": jax_quantized(model.backbone),
                "tcn": jax_variables(model.tcn)["params"]}
    return jax_variables(model)


def _write_servable(path: str, variables: dict, meta: dict) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "variables.msgpack"), "wb") as fh:
        fh.write(pack_msgpack(variables))
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(meta, fh)


def _read_servable(path: str):
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    return meta, read_msgpack(os.path.join(path, "variables.msgpack"))


def infer_network(backbone: dict) -> str:
    """The ResNet variant whose blocks a backbone tree holds (float params
    or the quantized tree: ``layer{s}_{b}`` blocks, ``conv3`` in a
    bottleneck)."""
    sizes = []
    for s in range(1, 5):
        n = sum(1 for k in backbone if k.startswith(f"layer{s}_"))
        sizes.append(n)
    bottleneck = "conv3" in backbone.get("layer1_0", {})
    for name, (want, block) in RESNET_VARIANTS.items():
        if tuple(want) == tuple(sizes) and \
                (block is Bottleneck) == bottleneck:
            return name
    raise ValueError(f"cannot tell the network of the servable: blocks "
                     f"{sizes} ({'bottleneck' if bottleneck else 'basic'}) "
                     f"match no ResNet of {sorted(RESNET_VARIANTS)}")


def infer_tcn(tcn: dict) -> dict:
    """The TCN geometry of a TCN params tree."""
    if "pg" not in tcn or "pg_conv_in" not in tcn:
        raise ValueError("cannot tell the TCN of the servable: no pg / "
                         "pg_conv_in in its tree")
    refines = sorted(k for k in tcn if k.startswith("refine"))
    lengths = {len(tcn[k]) for k in refines}
    if len(lengths) > 1:
        raise ValueError(f"cannot tell the TCN of the servable: its "
                         f"refinement stages have {sorted(lengths)} layers")
    return dict(num_layers_pg=len(tcn["pg"]),
                num_layers_r=lengths.pop() if lengths else 10,
                num_refinements=len(refines),
                num_f_maps=int(np.shape(tcn["pg_conv_in"]["kernel"])[-1]))


def _rebuild(tree: dict, meta: dict, device: torch.device,
             dtype: torch.dtype, model_kw: dict, q_stem: Tuple[bool, bool]):
    """The session's model from a servable's variables: the float
    recognizer (``model_kw`` to ``EndToEndRecognizer``), or the int8
    backbone (its stored codes and scales; ``q_stem`` its ``s2d_stem``
    and ``fused_stem``) under the float TCN."""
    quantize = meta.get("quantize", "q_backbone" in tree)
    params = tree.get("params", {})
    tcn = params["tcn"] if "tcn" in params else tree.get("tcn")
    if tcn is None:
        raise ValueError("cannot tell the TCN of the servable: no tcn in its "
                         "variables")
    backbone = tree["q_backbone"] if quantize else params.get("backbone")
    if backbone is None:
        raise ValueError("cannot tell the backbone of the servable: no "
                         "backbone or q_backbone in its variables")
    network = meta.get("network") or infer_network(backbone)
    model = _build_model(None, device, network=network, dtype=dtype,
                         **model_kw, **infer_tcn(tcn))
    load_jax_variables(model.tcn, {"params": tcn})
    if not quantize:
        load_jax_variables(model.backbone, {
            "params": backbone,
            "batch_stats": tree.get("batch_stats", {}).get("backbone", {})})
        return model
    qp = load_jax_quantized(quantize_resnet(model.backbone),
                            tree["q_backbone"])
    qp.s2d_stem, qp.fused_stem = q_stem
    return Int8Recognizer(qp, model.tcn)


@dataclass
class StreamingSession:
    """Online per-frame inference over a device-resident feature ring buffer.

    Each ``push`` takes one frame per stream, runs the backbone on it,
    shifts its feature into the (streams, context, D) buffer and runs the
    causal TCN over the buffer; the probabilities are those of the last
    position. Once a stream has seen at least the TCN's receptive field,
    and ``context`` covers that field, the output equals the offline causal
    model's; with a shorter ``context`` (``create`` warns) it is a
    sliding-window approximation. ``streams`` > 1 batches independent
    videos; streams never mix.
    """

    model: Union[EndToEndRecognizer, Int8Recognizer]
    buffer: torch.Tensor  # (streams, context, D); oldest feature first
    context: int
    height: int
    width: int
    streams: int = 1
    receptive_field: int = 0
    frames_seen_per_stream: np.ndarray = field(default=None)
    # what export() writes beside JAX's meta keys; None once restored
    exportable: Optional[dict] = None

    def __post_init__(self):
        if self.frames_seen_per_stream is None:
            self.frames_seen_per_stream = np.zeros(self.streams, np.int64)

    @property
    def frames_seen(self) -> int:
        """Fewest frames seen by any stream."""
        return int(self.frames_seen_per_stream.min())

    @classmethod
    def create(cls, context: int = 256, height: int = 256, width: int = 448,
               network: str = "resnet18", variables=None,
               num_layers_pg: int = 11, num_layers_r: int = 10,
               num_refinements: int = 3, num_f_maps: int = 512,
               dtype: torch.dtype = torch.bfloat16, quantize: bool = False,
               calibrate_frames=None, streams: int = 1,
               fused_stem: bool = False,
               device: Device = "cuda") -> "StreamingSession":
        """``quantize=True`` runs the backbone int8 per frame, with static
        scales calibrated on ``calibrate_frames`` (normalised (N, H, W, 3))
        or, without them, on ``_default_calibration`` at (4, H, W, 3).
        ``fused_stem`` applies to the float and the int8 backbone, as in
        the JAX session (which has no ``s2d_stem``)."""
        rf = tcn_receptive_field(num_layers_pg, num_layers_r,
                                 num_refinements)
        if context < rf:
            warnings.warn(
                f"StreamingSession context={context} < TCN receptive field "
                f"{rf}: outputs are a sliding-window approximation of the "
                f"offline model, not exact (pass context>={rf} for "
                f"exactness)", stacklevel=2)
        device = torch.device(device)
        model = _build_model(
            variables, device, network=network, causal=True,
            num_layers_pg=num_layers_pg, num_layers_r=num_layers_r,
            num_refinements=num_refinements, num_f_maps=num_f_maps,
            fused_stem=fused_stem, dtype=dtype)
        if quantize:
            if calibrate_frames is None:
                calibrate_frames = _default_calibration(
                    (4, height, width, 3), dtype, device)
            frames = torch.as_tensor(calibrate_frames).to(device, dtype)
            model = make_int8_e2e(model, frames[None], fused_stem=fused_stem)
        buffer = torch.zeros(streams, context, model.backbone.num_channels,
                             dtype=dtype, device=device)
        exportable = dict(
            network=network, quantize=quantize, fused_stem=fused_stem,
            causal=True, num_layers_pg=num_layers_pg,
            num_layers_r=num_layers_r, num_refinements=num_refinements,
            num_f_maps=num_f_maps)
        return cls(model, buffer, context, height, width, streams, rf,
                   exportable=exportable)

    @classmethod
    def from_checkpoint(cls, directory: str, modelname: str, **kwargs
                        ) -> "StreamingSession":
        """Serve the EndToEndRecognizer state that the JAX package's
        ``CheckpointManager`` saved as ``<modelname>.msgpack`` in
        ``directory``; ``kwargs`` go to ``create``."""
        variables = restore_variables(checkpoint_path(directory, modelname))
        return cls.create(variables=variables, **kwargs)

    def push(self, frame) -> Dict[str, np.ndarray]:
        """One frame per stream, (H, W, 3) or (S, H, W, 3), uint8 or
        normalised float -> probabilities for the current frame, (S, C)
        (the stream axis is dropped when S == 1)."""
        if frame.ndim == 3:
            frame = frame[None]
        want = (self.streams, self.height, self.width, 3)
        if tuple(frame.shape) != want:
            raise ValueError(f"session serves frames of shape {want}, got "
                             f"{tuple(frame.shape)}")
        with torch.inference_mode():
            x = _to_model_input(frame, self.buffer.device, self.buffer.dtype)
            feat = self.model.backbone(x)["pooled"]
            self.buffer = torch.cat([self.buffer[:, 1:], feat[:, None]], 1)
            out = self.model.tcn(self.buffer)
            probs = {k: torch.sigmoid(out[k][0][:, -1].float()).cpu().numpy()
                     for k in TASKS}
        self.frames_seen_per_stream += 1
        if self.streams == 1:
            return {k: v[0] for k, v in probs.items()}
        return probs

    def export(self, path: str) -> str:
        """Write the streaming servable (``variables.msgpack``,
        ``meta.json`` with the ring's geometry); restore with
        ``StreamingSession.load_exported(path)``, which starts from a zero
        buffer."""
        if self.exportable is None:
            raise ValueError("session restored from an export is not "
                             "re-exportable")
        if isinstance(self.model, Int8Recognizer):
            variables = {"params": {"tcn": jax_variables(
                             self.model.tcn)["params"]},
                         "q_backbone": jax_quantized(self.model.backbone)}
        else:
            variables = jax_variables(self.model)
        _write_servable(path, variables, dict(
            context=self.context, height=self.height, width=self.width,
            streams=self.streams, receptive_field=self.receptive_field,
            feature_dim=int(self.buffer.shape[-1]),
            dtype=str(self.buffer.dtype).replace("torch.", ""),
            **self.exportable))
        return path

    @classmethod
    def load_exported(cls, path: str, device: Device = "cuda",
                      fused_stem: bool = False) -> "StreamingSession":
        """Rebuild an exported streaming session on ``device`` with a zero
        buffer (the port's or the JAX package's servable; ``fused_stem``
        stands in where ``meta.json`` lacks it)."""
        meta, tree = _read_servable(path)
        if not meta.get("causal", True):
            raise ValueError("a streaming servable runs the causal TCN")
        fused = meta.get("fused_stem", fused_stem)
        dtype = getattr(torch, meta["dtype"])
        device = torch.device(device)
        model = _rebuild(tree, meta, device, dtype,
                         dict(causal=True, fused_stem=fused), (False, fused))
        buffer = torch.zeros(meta["streams"], meta["context"],
                             meta["feature_dim"], dtype=dtype, device=device)
        return cls(model, buffer, meta["context"], meta["height"],
                   meta["width"], meta["streams"], meta["receptive_field"])

    def reset(self, stream: Optional[int] = None) -> None:
        """Start a new video: zero the buffer and frame count of one stream,
        or of all when ``stream`` is None."""
        # the buffer is an inference tensor (written by push), so it is
        # updated in place only inside inference mode
        with torch.inference_mode():
            if stream is None:
                self.buffer.zero_()
                self.frames_seen_per_stream[:] = 0
            else:
                self.buffer[stream].zero_()
                self.frames_seen_per_stream[stream] = 0


@dataclass
class TeacherSession:
    """A fixed-shape Q2L teacher session: (B, H, W, 3) frames -> task
    probabilities and the per-frame feature (the mean of the encoder memory
    of "ivt" when served, else of the first task), in bf16 on ``device``."""

    model: Q2L
    batch: int
    height: int
    width: int
    tasks: Tuple[str, ...]
    device: torch.device

    @classmethod
    def create(cls, batch: int = 16, img_size: int = 384,
               backbone: str = "swin_L_384_22k", loss_type: str = "i",
               variables=None, quantize: bool = False,
               calibrate_frames=None,
               device: Device = "cuda") -> "TeacherSession":
        """``variables``: the JAX ``Q2L`` variables to serve; without them,
        weights are drawn from a ``torch.Generator`` seeded with 0.

        ``backbone`` is a Swin, ResNet, CvT or TResNet variant of ``Q2L``
        (``"tresnet_l"`` at ``img_size=448`` is the published TResNet-L
        teacher, K9 running every activated ABN on the card;
        ``"cvt_w24"`` at ``img_size=384`` the published CvT teacher).

        ``quantize=True`` serves the int8 teacher, as the JAX session does:
        ``Q2L(quant_eval=True, s2d_embed=True)``, whose two flags act on a
        Swin backbone only, then every ``Dense`` of at least 512 inputs
        int8 on Q1. A TResNet or CvT backbone's convolutions stay float
        (the int8 TResNet backbone is ``models.quant_tresnet``, which the
        JAX session does not use). ``calibrate_frames``, normalised
        (N, H, W, 3) frames, bake the ``Int8Dense`` scales; without them
        ``_default_calibration`` at (2, img, img, 3) stands in."""
        device = torch.device(device)
        model = Q2L(backbone=backbone, loss_type=loss_type,
                    dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(0),
                    quant_eval=quantize, s2d_embed=quantize)
        if variables is not None:
            load_jax_variables(model, variables)
        model = model.to(device).eval()
        if quantize:
            if calibrate_frames is None:
                calibrate_frames = _default_calibration(
                    (2, img_size, img_size, 3), torch.bfloat16, device)
            frames = torch.as_tensor(calibrate_frames).to(device,
                                                          torch.bfloat16)
            # the kernels' int8 branches run here, the Dense layers in float
            scales = collect_dense_scales(model, frames)
            apply_int8_dense(model, quantize_dense_params(model), scales,
                             min_features=INT8_DENSE_MIN_FEATURES)
        return cls(model, batch, img_size, img_size, tuple(model.tasks),
                   device)

    @property
    def shape(self):
        return (self.batch, self.height, self.width, 3)

    def predict(self, frames) -> Dict[str, np.ndarray]:
        """uint8 (normalised here) or normalised float frames -> {task:
        (B, C) float32 probabilities, "feature": (B, D) float32}."""
        if tuple(frames.shape) != self.shape:
            raise ValueError(f"session serves shape {self.shape}, got "
                             f"{tuple(frames.shape)}")
        with torch.inference_mode():
            x = _to_model_input(frames, self.device, torch.bfloat16)
            out = self.model(x)
            probs = {k: torch.sigmoid(out["logits"][k].float()).cpu().numpy()
                     for k in self.tasks}
            probs["feature"] = out["feature"].float().cpu().numpy()
        return probs
