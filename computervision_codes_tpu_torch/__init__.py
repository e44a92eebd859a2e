"""PyTorch port of computervision_codes_tpu for NVIDIA Hopper (H100).

The JAX package ``computervision_codes_tpu`` is the reference; this package
mirrors its module paths (``models/resnet.py`` <-> ``models/resnet.py``,
and so on) and is checked against it by the ``tests/test_torch_*.py``
parity tests. It imports torch and numpy only, never JAX: the GPU machine
has no JAX, flax or msgpack. It uses no PIL either: its frames come from
its own data plane (``data/native.py``).

Every Pallas kernel on a ported path becomes a hand-written Hopper kernel
under ``csrc/``, built at first use by ``ops/_build.py``. A wrapper runs its
plain PyTorch version for CPU tensors and launches the kernel for CUDA
tensors; nothing falls back from the kernel to the plain version.
"""
