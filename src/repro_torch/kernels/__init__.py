"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Sources live in ``csrc/`` and are built on first use into ``build/torch_ext/``
at the repository root; nothing is compiled when a module is imported.
"""
