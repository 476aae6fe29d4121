"""PyTorch/CUDA port of lightdock_tpu.

The JAX package ``lightdock_tpu`` stays the reference.  This package
imports nothing of it (nor ``jax``): it keeps its own copies of the host
layer it needs (``constants``, ``scoring``, ``engine.params``, ``utils``),
each held equal to its original by the tests, and re-implements the device
path in PyTorch, with the pair kernels hand-written in CUDA C++ for Hopper
(``csrc/``).  It reads the scoring tables' JSON data where the JAX package
keeps them.

Layout mirrors the reference: ``ops/`` holds the kernels and their
array-level helpers, ``engine/`` the parameters, the energy functions, the
GSO step and the runner; ``standin`` builds the seeded stand-in complexes.
"""
