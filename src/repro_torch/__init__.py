"""PyTorch/CUDA port of the ReducedLUT serving stack.

A second package beside the JAX reference ``repro``: it imports ``torch``
and ``numpy`` only, keeps its own copies of the numpy modules it needs
(compression engine, configs, site registry), and runs the LUT hot path
through hand-written CUDA kernels for Hopper (``repro_torch.kernels``).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
