"""PyTorch/CUDA port of the hierarchical federated learning system.

Mirrors ``repro``'s layout module for module. The port imports nothing of
``repro`` (and never ``jax``): where it needs a jax-free piece of the
reference it keeps its own copy. The Pallas kernels on the ported paths
(the training driver's sync, the paper-exact engine's Ω hops) are
hand-written CUDA kernels for Hopper (``repro_torch/csrc``), each beside
a plain PyTorch version that the CPU path and the tests use.
"""
