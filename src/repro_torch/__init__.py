"""PyTorch / CUDA port of the ``repro`` package for NVIDIA Hopper.

The layout mirrors ``repro``: ``configs/``, ``models/``, ``kernels/``,
``serve.py``, ``train.py``, ``parallel/``, ``collectives/``, the
checkpoint formats (``checkpoint.py``, ``ckpt/``), ``faults/``,
``elastic.py``, ``elastic_driver.py`` and ``launch/``.  The JAX package is the reference the port is
tested against; this package imports ``torch`` and neither ``jax`` nor
anything of ``repro``.
"""
