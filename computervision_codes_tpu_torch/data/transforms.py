"""ImageNet normalisation constants, copied from the JAX package's
``data/transforms.py:26-27``.

A copy and not an import: importing any module of
``computervision_codes_tpu.data`` runs its ``__init__``, which imports
JAX, and the GPU machine has no JAX (nor PIL, which that module needs).
"""

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
