"""PyTorch + CUDA port of the data-diffusion serving system.

A second package beside ``repro`` (the JAX reference, which it never
imports).  The jax-free control plane — configs, the dispatch core, the
index, tiers/transfer/prefetch, the obs plane, and the router, admission
and chaos planes — is kept as byte-identical copies under the same relative
paths (a test compares each copy with its source).  What touched JAX is
ported: the dense decoder (``models``), the serving loop
(``runtime.serve_loop``), the device score mirror and the kernels, which
are hand-written CUDA for Hopper (``csrc/``) behind wrappers that run the
plain PyTorch version only for CPU tensors.

Entry points run on the card by default (``device="cuda"``); pass
``device="cpu"`` for the plain path.
"""
