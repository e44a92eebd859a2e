"""Serving: pixels -> probabilities sessions on an explicit device.

Counterpart of ``serving.py`` in the JAX package (``InferenceSession`` and
``StreamingSession``). Semantics kept from it:

* the input dtype decides normalisation: uint8 frames are normalised on the
  device (ImageNet mean/std, in float32), any float input is taken as
  already normalised; the result is cast to bf16 (the sessions' default
  compute dtype) before the model;
* probabilities are the sigmoid, in float32, of the float32-cast logits;
* a session serves one fixed input shape and raises ``ValueError`` on any
  other.

Not ported yet: ``quantize``, ``mesh``, ``export``/``load_exported`` and
``from_checkpoint`` (msgpack is absent on the GPU machine).

Usage::

    sess = InferenceSession.create(batch=4, clip_len=256, device="cuda")
    probs = sess.predict(clips_uint8)       # {task: (B, T, C) numpy}
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, Optional, Union

import numpy as np
import torch

from .data.transforms import IMAGENET_MEAN, IMAGENET_STD
from .models.convert import load_jax_variables
from .models.pipeline import EndToEndRecognizer

TASKS = ("ivt", "i", "v", "t")
Device = Union[str, torch.device]


def tcn_receptive_field(num_layers_pg: int, num_layers_r: int,
                        num_refinements: int) -> int:
    """Causal receptive field (frames) of TemporalTCN: each dilated layer
    reaches 2d back, dilations 2^i per stage, so a stage of L layers adds
    2 * (2^L - 1); the FPN laterals are 1x1 and add nothing. Default
    config (11 + 3x10): 1 + 4094 + 3 * 2046 = 10233."""
    return (1 + 2 * (2 ** num_layers_pg - 1)
            + num_refinements * 2 * (2 ** num_layers_r - 1))


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

    model: EndToEndRecognizer
    batch: int
    clip_len: int
    height: int
    width: int
    device: torch.device

    @classmethod
    def create(cls, batch: int = 4, clip_len: int = 256, height: int = 256,
               width: int = 448, network: str = "resnet18",
               variables=None, device: Device = "cuda"
               ) -> "InferenceSession":
        """``variables``: the JAX ``EndToEndRecognizer`` variables to serve;
        without them, weights are drawn from a seeded generator. ``device``
        is used as given: a session never moves itself to another device."""
        device = torch.device(device)
        model = _build_model(variables, device, network=network,
                             dtype=torch.bfloat16)
        return cls(model, batch, clip_len, height, width, device)

    @property
    def shape(self):
        return (self.batch, self.clip_len, self.height, self.width, 3)

    def predict(self, clips) -> Dict[str, np.ndarray]:
        """uint8 (normalised here) or normalised float clips -> {task:
        (B, T, C) float32 probabilities}."""
        if tuple(clips.shape) != self.shape:
            raise ValueError(f"session serves shape {self.shape}, got "
                             f"{tuple(clips.shape)}")
        with torch.inference_mode():
            x = _to_model_input(clips, self.device, torch.bfloat16)
            out = self.model(x)
            return {k: torch.sigmoid(out[k].float()).cpu().numpy()
                    for k in TASKS}


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

    model: EndToEndRecognizer
    buffer: torch.Tensor  # (streams, context, D); oldest feature first
    context: int
    height: int
    width: int
    streams: int = 1
    receptive_field: int = 0
    frames_seen_per_stream: np.ndarray = field(default=None)

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
               dtype: torch.dtype = torch.bfloat16, streams: int = 1,
               device: Device = "cuda") -> "StreamingSession":
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
            dtype=dtype)
        buffer = torch.zeros(streams, context, model.backbone.num_channels,
                             dtype=dtype, device=device)
        return cls(model, buffer, context, height, width, streams, rf)

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
