"""PyTorch + CUDA port of HOISDF for NVIDIA Hopper.

A second package beside ``hoisdf_tpu`` (the JAX reference), with the same
module layout.  It imports only ``torch`` and ``numpy``; its hot kernels
(the fused SDF MLP, the multi-level bilinear gather and the gather's
backward) are CUDA C++ under ``csrc/``, built with ``nvcc`` at first use.
"""

__version__ = "0.1.0"
