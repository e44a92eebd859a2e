"""Recognition metrics of the port (copy of the JAX package's metrics)."""

from .recognition import Recognition, average_precision, classwise_ap

__all__ = ["Recognition", "average_precision", "classwise_ap"]
