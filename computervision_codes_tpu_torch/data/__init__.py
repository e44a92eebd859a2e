"""Host-side data of the port: the frame source (``native``, the data
plane over ``csrc/dataplane.cpp``; ``transforms``; ``pipeline``;
``prefetch``), the triplet bank, splits, labels, the cached-feature bus,
temporal sequences and synthetic trees. Each module is a copy of its
namesake in the JAX package, without PIL and without JAX."""

from .native import VideoReader, video_supported

__all__ = ["VideoReader", "video_supported"]
