"""blazr_tpu_torch — the PyTorch/CUDA port of blazr_tpu for NVIDIA Hopper.

A package beside ``blazr_tpu`` (the JAX reference, which it never imports).
Plain tensor code is PyTorch; every Pallas kernel on the served path has a
hand-written CUDA counterpart under ``csrc/``, built with nvcc on first use.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``, where
the kernels' plain versions run instead.
"""

__version__ = "0.1.0"
