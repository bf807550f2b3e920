"""PyTorch/CUDA port of m2mixer_tpu for NVIDIA Hopper (H100).

A second package beside the JAX one: it reads the same YAML configs and
resolves the same registry strings, imports nothing from ``m2mixer_tpu`` and
no JAX, and runs its mixer stacks on hand-written CUDA kernels
(``ops/csrc``). It serves and trains ``AVMnistMixerMultiLoss``
(``serving.py``, ``run.py``).
"""

__version__ = "0.1.0"
