"""Kernels of the port and their plain PyTorch versions."""

from .attention import flash_attention, flash_attention_pallas

__all__ = ["flash_attention", "flash_attention_pallas"]
