"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version. Sources live in ``csrc/`` and are built by ``build``
at first use."""
