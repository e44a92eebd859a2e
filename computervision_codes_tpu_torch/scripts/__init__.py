"""The port's probe drivers: the JAX package's tuning probes
(``scripts/int8_kernel_probe.py``, ``scripts/swin_pack_probe.py`` at the
repository root), each with its kernels' entry points and plain versions.
Run one as ``python -m computervision_codes_tpu_torch.scripts.<probe>``."""


def on_device(what: str, x, plain, kernel):
    """``plain()`` for a CPU tensor x, ``kernel()`` for a CUDA one; any
    other device raises."""
    if x.device.type == "cpu":
        return plain()
    if x.device.type == "cuda":
        return kernel()
    raise ValueError(f"{what} runs on CPU (plain version) or CUDA (kernel) "
                     f"tensors, got {x.device}")
