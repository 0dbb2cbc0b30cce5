"""
iscc-search-tpu-torch — the exact NPHD search engine of ``iscc_search_tpu``
ported to PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``iscc_search_tpu`` is the reference: every ported module is
held against its JAX counterpart by ``tests/test_torch_*.py``. This package
imports ``torch`` and ``numpy`` only — never jax, and nothing of
``iscc_search_tpu`` — so it runs on a host whose Python has neither.

Layout (names follow the JAX package):

- ``ops.packing``: bit packing of code bodies into uint32 lanes (host, numpy)
- ``ops.pm1_scan``: the ±1 identity, query prep, hierarchical block top-k and
  the plain whole-scan reference
- ``ops.nphd``: dense brute-force NPHD scores (the exactness oracle)
- ``ops.hopper_scan``: the phase-1 block-max and phase-3 gather-rescore CUDA
  kernels, their plain PyTorch versions and the exact two-phase top-k
- ``engine.device_index``: ``DeviceNphdIndex``, the in-memory NPHD engine
"""

__version__ = "0.5.0"
