"""``repro_torch`` — Outback's decoupled DMPH index ported to PyTorch and CUDA.

The port of the JAX package ``repro``, module for module (``core/``,
``kernels/``, ``api/``, ``cache/``, ``configs/``, ``models/``,
``serve/``).  It imports ``torch`` and ``numpy`` and nothing of ``repro``
or JAX.  Its entry points run on CUDA unless the caller passes
``device="cpu"``; there, every kernel wrapper uses its plain PyTorch
version.  See ``repro_torch.api.open_store``, ``repro_torch.cache`` and
``repro_torch.serve.Engine``.
"""
