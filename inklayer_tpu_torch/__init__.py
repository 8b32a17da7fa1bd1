"""inklayer-tpu on PyTorch and CUDA: the detect+segment slice for an NVIDIA
Hopper card (H100).

A port of :mod:`inklayer_tpu` (JAX on a TPU), module for module.  Plain
tensor code is PyTorch; every Pallas kernel the JAX package runs on this
slice is a hand-written CUDA kernel under ``csrc/`` (see ``_kernels.py``).
The JAX package is the reference the port is tested against.

The package imports ``torch`` and never ``jax``, ``flax`` or
:mod:`inklayer_tpu`.
"""
