"""PyTorch/CUDA port of the SPA reproduction (``repro`` is the JAX
reference).  Imports ``torch`` and ``numpy`` only — never ``jax`` and
nothing from ``repro``.  Entry points run on the CUDA device unless the
caller asks for ``device="cpu"``."""
