"""marian_tpu_torch: the PyTorch/CUDA port of marian_tpu for NVIDIA Hopper.

A package of its own beside ``marian_tpu`` (the JAX reference, which it
never imports). Module names mirror the reference so each counterpart is
easy to find; host code the port needs is copied, trimmed to the slice.

This slice covers ``marian-decoder`` beam search of the default
``--type transformer``. Its two attention kernels are hand-written CUDA
C++ for ``sm_90a`` (``csrc/``), built with ``nvcc`` on first use.
Entry points run on ``cuda`` unless the caller asks for the CPU
(``--cpu-threads N`` or ``device="cpu"``); see ``device.py``.
"""

__version__ = "0.1.0"
