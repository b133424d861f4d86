"""PyTorch / CUDA port of the ShuffleSoftSort system (``repro``).

``repro_torch.core`` mirrors ``repro.core`` and ``repro_torch.kernels``
mirrors ``repro.kernels``, with the Pallas TPU kernels rewritten as CUDA
kernels for Hopper.  The port imports neither JAX nor ``repro``.
"""
