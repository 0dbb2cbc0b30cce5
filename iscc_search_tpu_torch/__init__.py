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
- ``ops.nphd``, ``ops.topk``: dense brute-force NPHD and Hamming scores and
  the chunked exact top-k scan over them (the exactness oracle)
- ``ops.hopper_scan``: the phase-1 block-max and phase-3 gather-rescore CUDA
  kernels, their plain PyTorch versions and the exact two-phase top-k
- ``ops.bitplane``: the bit-plane, sub-word and int4 twin layouts of the
  phase-1 experiments
- ``engine.device_index``: ``DeviceNphdIndex`` and ``DeviceHammingIndex``,
  the device-resident engines with the JAX engine's segment persistence
- ``engine.simprint``, ``engine.simprint_ops``, ``engine.batcher``: the
  simprint engine (chunk search, IDF-weighted asset scores) and the
  cross-request search batcher
- ``indexes.tpu``: ``TpuIndex`` and ``TpuIndexManager``, the asset-level
  entry point (``add_assets``, ``search_assets``, ``get_asset``, ``flush``)
  over a ``store.HostStore`` (the C++ store of ``native/store.cpp``, built
  with g++ at first use) and the engines
- ``indexes.memory``, ``indexes.kv``, ``protocols.index``: the memory and
  host-store backends and the protocol they share with ``indexes.tpu``
- ``server``: the REST app (``server.app``, ``server.wsgi``,
  ``server.auth``, ``server.openapi``), the pooled keep-alive HTTP transport
  (``server.pooled``) and ``server.httpd.serve``; ``remote.RemoteIndex``,
  the client on ``http.client``
- ``schema``, ``options``, ``codec``, ``models``, ``utils``,
  ``server.metrics``, ``aggregator``: the wire types (dataclasses, no
  pydantic), the options and the backend factory by URI (``get_index``),
  and copies of the JAX package's host modules
- ``experiments``: the phase-1 A/B entry points of ``benchmarks/exp_*.py``
  over their own CUDA kernels
"""

__version__ = "0.7.0"
