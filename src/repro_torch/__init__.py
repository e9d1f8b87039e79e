"""PyTorch/CUDA port of the tLoRA system (the JAX package ``repro`` is
the reference).  Imports ``torch`` only: never ``jax``, never ``repro``.

Subpackages mirror the reference: ``configs``, ``core``, ``kernels``
(hand-written Hopper kernels under ``kernels/csrc``, each beside its
plain PyTorch version), ``models``, ``optim``, ``data``, ``checkpoint``,
``elastic``, ``train``, ``serve``, ``launch``.
"""
