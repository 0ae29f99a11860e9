"""PyTorch / CUDA port of the ``repro`` package for NVIDIA Hopper.

The layout mirrors ``repro``: ``configs/``, ``models/``, ``kernels/``,
``serve.py`` and ``launch/``.  The JAX package is the reference the port is
tested against; this package imports ``torch`` and neither ``jax`` nor
anything of ``repro``.
"""
