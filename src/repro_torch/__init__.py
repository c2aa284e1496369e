"""PyTorch/CUDA port of :mod:`repro` for one NVIDIA Hopper card.

Mirrors ``repro``'s module paths.  Every TPU kernel that a ported path
runs has a hand-written CUDA kernel under ``csrc/`` and a plain PyTorch
version in its ``kernels/<name>/ref.py``; the wrappers in
``kernels/<name>/ops.py`` launch the kernel for CUDA tensors and take the
plain version only for CPU tensors.

This package imports ``torch`` and never ``jax`` or ``repro``.
"""
