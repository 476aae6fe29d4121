"""PyTorch/CUDA port of lightdock_tpu.

The JAX package ``lightdock_tpu`` stays the reference.  This package
imports its pure-NumPy host layer (model building, ``BatchScoringParams``,
the rand-0.7 stream, the snapshot writer) and re-implements the device
path in PyTorch, with the pair kernels hand-written in CUDA C++ for
Hopper (``csrc/``).  Nothing here imports ``jax``.

Layout mirrors the reference: ``ops/`` holds the kernels and their
array-level helpers, ``engine/`` the energy functions, the GSO step and
the runner.
"""
