"""HTTP worker process entry point: ``python -m iscc_search_tpu_torch.server.worker``
(copy of ``iscc_search_tpu/server/worker.py``).

Spawned by server/scaleout.py with ISCC_SCALEOUT_CONFIG in the environment
(and the card hidden by ``CUDA_VISIBLE_DEVICES=""``); binds the public port
with SO_REUSEPORT and serves the full WSGI app with every index call routed
to the engine process over its unix socket.
"""

from iscc_search_tpu_torch.server.scaleout import worker_main

if __name__ == "__main__":  # pragma: no cover - exercised as a subprocess
    worker_main()
